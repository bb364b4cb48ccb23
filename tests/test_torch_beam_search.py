"""The port's beam searches (``models/transformer.py``) against the JAX
package's: the ports of the beam-search cases of
``tests/test_transformer.py``.

The same tiny Transformer in both packages (the JAX weights carried by
structural name). Held: ``beam_search_translate`` and
``beam_search_translate_cached`` give the JAX tokens exactly and scores
within 1e-4 relative, without and with ``src_valid_length``, and equal
each other; scores come best-first; beam 1 equals a hand-rolled greedy
decode; and where the beams outnumber the finite candidates (4 and 5
tokens, 6, 8 and 20 beams, one or two steps) the order among tied
candidates decides the output: beams
whose score is -1e9 plus a log-probability (equal in f32) are taken
lower index first, as ``lax.top_k`` takes them, and re-ranked stably.
"""

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.models import transformer as jt

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, nd
from incubator_mxnet_tpu_torch.models import transformer as tt

from test_torch_parity import build_pair

SEARCHES = [(jt.beam_search_translate, tt.beam_search_translate),
            (jt.beam_search_translate_cached,
             tt.beam_search_translate_cached)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU runs here are tiny: on one intra-op thread they do
    not contend with the other test processes for the cores (restored
    after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(vocab, max_length, seed=0):
    cfg = dict(src_vocab=vocab, tgt_vocab=vocab, units=32, hidden_size=64,
               num_heads=4, num_layers=2, max_length=max_length)
    return build_pair(lambda: jt.TransformerModel(**cfg),
                      lambda: tt.TransformerModel(**cfg), seed=seed)


@pytest.fixture(scope="module")
def pair():
    return _pair(32, 20)


def _run(search, model, src, vl, arr, **kw):
    v = None if vl is None else arr(vl)
    tokens, scores = search(model, arr(src), src_valid_length=v, **kw)
    return tokens.asnumpy(), scores.asnumpy()


def _jarr(a):
    return jnd.array(a, dtype="int32")


def _tarr(a):
    return nd.array(a, ctx=mx.cpu(), dtype="int32")


@pytest.mark.parametrize("vl", [None, np.array([6, 4], np.int32)])
def test_cached_beam_search_matches(pair, vl):
    jm, tm = pair
    src = np.random.RandomState(0).randint(3, 32, (2, 6))
    kw = dict(beam_size=3, max_length=10)
    got = [_run(t, tm, src, vl, _tarr, **kw) for _, t in SEARCHES]
    want = [_run(j, jm, src, vl, _jarr, **kw) for j, _ in SEARCHES]
    for (gt, gs), (wt, ws) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_allclose(gs, ws, rtol=1e-4)
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_allclose(got[0][1], got[1][1], rtol=1e-4)


def test_beam_search_shapes_and_order(pair):
    _, tm = pair
    src = np.random.RandomState(2).randint(1, 32, (2, 6))
    tokens, scores = tt.beam_search_translate(tm, src, beam_size=3,
                                              max_length=8)
    assert tokens.shape == (2, 3, 8)
    assert (np.diff(scores.asnumpy(), axis=1) <= 1e-5).all()


def test_beam_search_greedy_consistency(pair):
    """With beam_size=1 the top beam equals greedy argmax decoding."""
    _, tm = pair
    src = _tarr(np.random.RandomState(3).randint(1, 32, (1, 5)))
    T = 6
    tokens, _ = tt.beam_search_translate(tm, src, beam_size=1,
                                         max_length=T, bos_id=1, eos_id=2)
    got = tokens.asnumpy()[0, 0]
    with autograd.predict_mode():
        memory, _ = tm.encode(src)
        cur = np.full((1, T + 1), 2, np.int32)
        cur[0, 0] = 1
        for t in range(T):
            logits = tm.decoder(_tarr(cur), memory).asnumpy()[0, t]
            nxt = int(np.argmax(logits))
            cur[0, t + 1] = nxt
            if nxt == 2:
                break
    np.testing.assert_array_equal(got[:t + 1], cur[0, 1:t + 2])


@pytest.mark.parametrize("vocab,beams,steps", [(4, 6, 1), (5, 8, 1),
                                                (4, 20, 2)])
def test_ties_take_the_jax_order(vocab, beams, steps):
    """Fewer finite candidates than beams (V at the first step, V^2 at
    the second): the rest are tied at -1e9 and stay in the output."""
    jm, tm = _pair(vocab, 12, seed=2)
    src = np.random.RandomState(4).randint(0, vocab, (2, 5))
    kw = dict(beam_size=beams, max_length=steps, eos_id=2, bos_id=1)
    for j, t in SEARCHES:
        gt, gs = _run(t, tm, src, None, _tarr, **kw)
        wt, ws = _run(j, jm, src, None, _jarr, **kw)
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_allclose(gs, ws, rtol=1e-4)
        # the tail beams come from tied -1e9 candidates: their choice
        # and order is what the tie rule decides
        assert (gs[:, -1] < -1e8).all(), gs
