"""The models' repeated-row embeddings (``models/_attention.py``
``position_rows`` and ``few_rows_lookup``) on the CPU, against the
gluon ``Embedding`` lookup they stand for: the same values bitwise, the
same gradient within f32 summation order (the lookup's backward adds the
repeats one by one, these sum them by a reduction), and the lookup
itself past the position table's length. On the card the lookup's
backward adds repeats with atomics; ``chip_smoke.py``'s ``pipelined``
phase holds bert_base's step bitwise to a second run of itself."""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, nd
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.models._attention import (few_rows_lookup,
                                                         position_rows)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


def _table(rows, units, seed):
    mx.random.seed(seed)
    t = nn.Embedding(rows, units)
    t.initialize(ctx=mx.cpu())
    return t


def _value_and_grad(fn, table, dout):
    w = table.weight.data()._data
    with torch.enable_grad(), autograd.record():
        out = fn()._data
        (g,) = torch.autograd.grad(out, [w], dout)
    return out.detach(), g


@pytest.mark.parametrize("B,T,rows", [(4, 16, 16), (3, 7, 32), (2, 9, 8)])
def test_position_rows_is_the_lookup(B, T, rows):
    table = _table(rows, 12, 0)
    dout = torch.from_numpy(np.random.RandomState(1).randn(B, T, 12)
                            .astype(np.float32))
    pos = nd.arange(0, T, dtype="int32").reshape((1, T)) \
        .broadcast_to((B, T))
    got, g = _value_and_grad(lambda: position_rows(table, B, T), table,
                             dout)
    want, gw = _value_and_grad(lambda: table(pos), table, dout)
    assert got.shape == want.shape == (B, T, 12)
    assert torch.equal(got, want)
    np.testing.assert_allclose(g.numpy(), gw.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rows", [2, 3])
def test_few_rows_lookup_is_the_lookup(rows):
    table = _table(rows, 10, 2)
    rng = np.random.RandomState(3)
    ids = nd.array(rng.randint(0, rows, (5, 11)), dtype="int32")
    dout = torch.from_numpy(rng.randn(5, 11, 10).astype(np.float32))
    got, g = _value_and_grad(lambda: few_rows_lookup(table, ids), table,
                             dout)
    want, gw = _value_and_grad(lambda: table(ids), table, dout)
    assert torch.equal(got, want)
    np.testing.assert_allclose(g.numpy(), gw.numpy(), rtol=1e-6, atol=1e-6)
