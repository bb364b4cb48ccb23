"""The parity harness between the JAX package and the PyTorch port, and
its own cases.

One model is built in both packages (after ``__graft_entry__.py``'s
drive: ``mx.random.seed``, construct, ``initialize()``), the JAX block's
parameters are copied into the port's by structural name
(``_collect_params_with_prefix``), and the outputs are compared on the
same numpy inputs, dropout off, on the CPU. Other test files import the
helpers:

  - ``jax_arrays`` / ``port_arrays``: numpy -> each package's NDArrays
    (float32 stays float32, integers become int32);
  - ``fresh_names``: reset both packages' block-name counters, so the
    next blocks get the same prefixes in both;
  - ``copy_params``: the JAX block's parameter values into the port's;
  - ``build_pair``: construct, initialize, run the port once on
    ``inputs`` (deferred shapes) and copy;
  - ``assert_close``: outputs (nested tuples) against each other;
  - ``cpu_gpt`` / ``port_gpt``: the port's ``gpt_mini`` initialized on
    the CPU, the latter holding a JAX GPT's weights (by structural name,
    ``convert.block_params_from_jax``).

Its cases: a Dense and a HybridSequential MLP equal the JAX block's
forward and input / parameter gradients (f32 rtol 1e-5: one matmul's
summation order); ``bert_tiny``'s forward, pretraining loss and every
parameter's gradient equal the JAX model's through the harness
(rtol 1e-4, as ``tests/test_torch_bert.py`` holds them).
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.gluon import block as jblock
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.models import bert as jb

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, nd
from incubator_mxnet_tpu_torch.gluon import block as tblock
from incubator_mxnet_tpu_torch.gluon import nn as tnn
from incubator_mxnet_tpu_torch.models import bert as tb
from incubator_mxnet_tpu_torch.models import convert, gpt as tg


def _dtype(a):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return "float32"
    if a.dtype.kind == "b":
        return "bool"
    return "int32"


def jax_arrays(arrays):
    return [jnd.array(a, dtype=_dtype(a)) for a in arrays]


def port_arrays(arrays):
    return [nd.array(a, ctx=mx.cpu(), dtype=_dtype(a)) for a in arrays]


def fresh_names():
    """Both packages' top-level block counters back to zero."""
    jblock._naming.counter = {}
    tblock._naming.counter = {}


def host(x):
    """A port or JAX NDArray (or tensor) as a float64 numpy array."""
    if torch.is_tensor(x):
        x = x.detach().float().cpu().numpy()
    elif hasattr(x, "asnumpy"):
        x = x.asnumpy()
    return np.asarray(x).astype(np.float64)


def copy_params(jax_block, port_block):
    """The JAX block's parameter values into the port block's, by
    structural name; both sides must hold the same names."""
    src = jax_block._collect_params_with_prefix()
    dst = port_block._collect_params_with_prefix()
    assert sorted(src) == sorted(dst)
    for name, p in dst.items():
        p.set_data(src[name].data().asnumpy())


def build_pair(jax_ctor, port_ctor, inputs=None, seed=0):
    """Both packages' blocks from the same constructor arguments,
    initialized (the port on the CPU); with ``inputs`` (numpy) a first
    forward completes deferred shapes before the copy."""
    jmx.random.seed(seed)
    fresh_names()
    jblk = jax_ctor()
    jblk.initialize()
    mx.random.seed(seed)
    fresh_names()
    tblk = port_ctor()
    tblk.initialize(ctx=mx.cpu())
    if inputs is not None:
        jblk(*jax_arrays(inputs))
        tblk(*port_arrays(inputs))
    copy_params(jblk, tblk)
    return jblk, tblk


def jax_params(jax_block):
    """A JAX block's parameters as numpy arrays by structural name."""
    return {k: p.data().asnumpy()
            for k, p in jax_block._collect_params_with_prefix().items()}


def cpu_gpt(**kw):
    """The port's ``gpt_mini(**kw)``, initialized on the CPU."""
    tm = tg.gpt_mini(**kw)
    tm.initialize(ctx=mx.cpu())
    return tm


def port_gpt(jax_model, **kw):
    """``cpu_gpt(**kw)`` holding ``jax_model``'s weights."""
    tm = cpu_gpt(**kw)
    tm.load_state_dict(convert.block_params_from_jax(tm,
                                                     jax_params(jax_model)))
    return tm


def assert_close(got, want, rtol=1e-5, atol=0.0, scale_atol=0.0):
    """Nested outputs; ``scale_atol`` adds that fraction of each output's
    largest |entry| to ``atol`` (for entries near zero)."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_close(g, w, rtol, atol, scale_atol)
        return
    g, w = host(got), host(want)
    assert g.shape == w.shape
    tol = atol + scale_atol * float(np.abs(w).max(initial=0.0))
    np.testing.assert_allclose(g, w, rtol=rtol, atol=tol)


# --------------------------------------------------------------------- #
# the harness's own cases
# --------------------------------------------------------------------- #

def _mlp(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(3))
    return net


@pytest.mark.parametrize("kind", ["dense", "mlp"])
def test_forward_and_gradients_match_jax(kind):
    rng = np.random.RandomState(0)
    x = rng.randn(5, 7).astype(np.float32)
    if kind == "dense":
        jblk, tblk = build_pair(lambda: jnn.Dense(4, in_units=7),
                                lambda: tnn.Dense(4, in_units=7))
    else:
        jblk, tblk = build_pair(lambda: _mlp(jnn), lambda: _mlp(tnn),
                                inputs=[x])
    jx, tx = jax_arrays([x])[0], port_arrays([x])[0]
    jx.attach_grad()
    tx.attach_grad()
    with jautograd.record():
        jy = jblk(jx)
        jl = (jy * jy).sum()
    jl.backward()
    with autograd.record():
        ty = tblk(tx)
        tl = (ty * ty).sum()
    tl.backward()
    assert_close(ty, jy, rtol=1e-5, scale_atol=1e-6)
    assert_close(tx.grad, jx.grad, rtol=1e-5, scale_atol=1e-6)
    jp, tp = jblk._collect_params_with_prefix(), \
        tblk._collect_params_with_prefix()
    for name in jp:
        assert_close(tp[name].grad(), jp[name].grad(), rtol=1e-5,
                     scale_atol=1e-6)


def test_copy_params_is_by_structural_name():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7).astype(np.float32)
    jblk, tblk = build_pair(lambda: _mlp(jnn), lambda: _mlp(tnn),
                            inputs=[x])
    names = sorted(tblk._collect_params_with_prefix())
    assert names == ["0.bias", "0.weight", "1.bias", "1.weight"]
    assert names == sorted(tblk.state_dict())
    for name, p in tblk._collect_params_with_prefix().items():
        np.testing.assert_array_equal(
            p.data().asnumpy(),
            jblk._collect_params_with_prefix()[name].data().asnumpy())


V, T, M, B = 64, 16, 3, 2


def _bert_batch():
    rng = np.random.RandomState(5)
    return (rng.randint(0, V, (B, T)), rng.randint(0, 2, (B, T)),
            np.asarray([16, 7]), rng.randint(0, 7, (B, M)),
            rng.randint(0, V, (B, M)), np.ones((B, M), np.float32),
            rng.randint(0, 2, (B,)))


@pytest.fixture(scope="module")
def bert_pair():
    def ctor(mod):
        def make():
            m = mod.bert_tiny(vocab_size=V, max_length=T, dropout=0.0)
            m.initialize() if mod is jb else m.initialize(ctx=mx.cpu())
            return mod.BERTForPretraining(m)
        return make
    return build_pair(ctor(jb), ctor(tb))


def test_bert_tiny_through_the_harness(bert_pair):
    jp, tp = bert_pair
    arrays = _bert_batch()
    with jautograd.record():
        jl = jb.pretraining_loss(jp, *jax_arrays(arrays))
    jl.backward()
    with autograd.record():
        tl = tb.pretraining_loss(tp, *port_arrays(arrays))
    tl.backward()
    assert_close(tl, jl, rtol=1e-4)
    assert_close(tp(*port_arrays(arrays[:4])), jp(*jax_arrays(arrays[:4])),
                 rtol=1e-4, scale_atol=1e-4)
    jparams = jp._collect_params_with_prefix()
    for name, p in tp._collect_params_with_prefix().items():
        assert_close(p.grad(), jparams[name].grad(), rtol=1e-4,
                     scale_atol=1e-4)
