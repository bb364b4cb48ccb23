"""The port's compiled-once decode / verify step programs, on the CPU.

``gpt_mini(vocab_size=64, max_length=64)`` is initialized in the JAX
package and its weights go across into the port. Held against the JAX
engine: ``decode_trace_count`` / ``verify_trace_count`` (the port counts
program builds — CUDA-graph captures on the card — where the JAX engine
counts traces) in the reference tests' count-asserting scenarios, with
equal greedy streams where the scenario is greedy. Held inside the port:
the step body reads nothing on the host (``Tensor.item`` / ``tolist`` /
``cpu`` / ``numpy`` / ``__bool__`` and ``torch.Generator`` patched to
raise), and the device draw (``sampling.draw_uniform``) equals a plain
Python version of its hash bit for bit and, through
``sample_inverse_cdf``, draws the softmax's distribution (chi-square)."""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.models import gpt as jg
from incubator_mxnet_tpu.serve import InferenceEngine as JaxEngine
from incubator_mxnet_tpu.serve import Request as JaxRequest
from incubator_mxnet_tpu.serve import SamplingParams as JaxSampling
from incubator_mxnet_tpu.serve import Tier as JaxTier
from incubator_mxnet_tpu.serve import choice_grammar as jax_choice

from incubator_mxnet_tpu_torch.models import convert, gpt as tg
from incubator_mxnet_tpu_torch.serve import (InferenceEngine, Request,
                                             SamplingParams, Tier,
                                             choice_grammar)
from incubator_mxnet_tpu_torch.serve.sampling import (ACCEPT_STREAM,
                                                      DRAW_STREAM,
                                                      draw_uniform,
                                                      sample_inverse_cdf)

V = 64


@pytest.fixture(scope="module")
def models():
    jmx.random.seed(0)
    jm = jg.gpt_mini(vocab_size=V, max_length=64)
    jm.initialize()
    tm = tg.gpt_mini(vocab_size=V, max_length=64, device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        [p.data().asnumpy() for p in jm.collect_params().values()]))
    return jm, tm


def _prompts(seed, sizes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, size=n).astype(np.int32) for n in sizes]


def _both(models, **kw):
    jm, tm = models
    kw = dict(dict(num_slots=3, page_size=8, max_len=64), **kw)
    return JaxEngine(jm, **kw), InferenceEngine(tm, **kw)


def _counts(e):
    return e.decode_trace_count, e.verify_trace_count


def _serve(pair, specs, **run_kw):
    """The same request specs (``sampling`` as a keyword dict, a
    ``grammar`` key as choice_grammar's sequences) through both
    engines; returns both engines' requests."""
    out = []
    for eng, req_cls, params, choice in (
            (pair[0], JaxRequest, JaxSampling, jax_choice),
            (pair[1], Request, SamplingParams, choice_grammar)):
        reqs = []
        for s in specs:
            s = dict(s)
            if "sampling" in s:
                sp = dict(s["sampling"])
                if "grammar" in sp:
                    sp["grammar"] = choice(sp["grammar"], V)
                s["sampling"] = params(**sp)
            reqs.append(req_cls(**s))
        eng.run(reqs, **run_kw)
        eng.audit_pages()
        out.append(reqs)
    return out


def _greedy(prompts, n=8):
    return [dict(prompt_ids=p, max_new_tokens=n) for p in prompts]


def _assert_parity(pair, greedy_streams=None):
    je, te = pair
    assert _counts(te) == _counts(je)
    assert max(_counts(te)) == 1
    if greedy_streams is not None:
        jr, tr = greedy_streams
        assert [r.token_ids for r in tr] == [r.token_ids for r in jr]


def test_trace_counts_zero_before_any_step(models):
    pair = _both(models, spec_k=4)
    assert _counts(pair[1]) == _counts(pair[0]) == (0, 0)
    pair[1].submit(Request(_prompts(0, (5,))[0], max_new_tokens=2))
    assert _counts(pair[1]) == (0, 0)        # queued, no step yet
    assert not pair[1]._programs


def test_trace_counts_across_occupancy_changes(models):
    pair = _both(models)
    streams = _serve(pair, _greedy(_prompts(1, (6,))))
    _assert_parity(pair, streams)
    streams = _serve(pair, _greedy(_prompts(2, (5, 9, 7, 11)), n=6))
    _assert_parity(pair, streams)


def test_trace_counts_menu_on_and_off(models):
    """Plain, neutral SamplingParams, a real menu, then plain again: one
    program, as test_sampling's neutral-params-no-retrace case asserts
    of the JAX engine."""
    pair = _both(models)
    prompts = _prompts(3, (6, 11, 9))
    for menu in (None, {}, dict(top_k=5, repetition_penalty=1.3),
                 dict(presence_penalty=0.7, logit_bias={3: 2.0}), None):
        specs = _greedy(prompts, n=6)
        if menu is not None:
            specs = [dict(s, sampling=menu) for s in specs]
        _assert_parity(pair, _serve(pair, specs))


def test_trace_counts_with_a_grammar(models):
    pair = _both(models)
    gram = dict(grammar=[[1, 2, 3, 1], [5, 6]])
    specs = [dict(prompt_ids=p, max_new_tokens=8, eos_id=9,
                  sampling=gram if i == 0 else {})
             for i, p in enumerate(_prompts(4, (5, 7)))]
    jr, tr = _serve(pair, specs)
    _assert_parity(pair, (jr, tr))
    assert tr[0].token_ids in ([1, 2, 3, 1, 9], [5, 6, 9])
    assert pair[1].constrained_requests == 1


def test_trace_counts_with_temperature(models):
    pair = _both(models)
    specs = [dict(prompt_ids=p, max_new_tokens=8, temperature=t, seed=i)
             for i, (p, t) in enumerate(zip(_prompts(5, (6, 8, 10)),
                                            (0.8, 0.0, 1.2)))]
    _serve(pair, specs)
    _assert_parity(pair)


@pytest.mark.parametrize("drafts", ["always", "never"])
def test_trace_counts_spec_k4(models, drafts):
    """spec_k=4 with a drafter that always proposes (the verify width,
    and the decode width where a slot has one token left) and one that
    never does (the decode width alone)."""
    def draft(history, k):
        n = k if drafts == "always" else 0
        return np.full((n,), int(history[-1]) % V, np.int32)

    pair = _both(models, spec_k=4, draft_fn=draft)
    streams = _serve(pair, _greedy(_prompts(6, (6, 9, 12)), n=10))
    _assert_parity(pair, streams)
    assert (pair[1].verify_trace_count == 1) == (drafts == "always")


@pytest.mark.parametrize("spec_k", [0, 4])
def test_trace_counts_int8_pools(models, spec_k):
    pair = _both(models, kv_quant="int8", spec_k=spec_k)
    streams = _serve(pair, _greedy(_prompts(7, (6, 9, 13)), n=10))
    _assert_parity(pair, streams)
    for ja, ta in zip(pair[0]._kamax + pair[0]._vamax,
                      pair[1]._kamax + pair[1]._vamax):
        np.testing.assert_allclose(np.asarray(ja), ta, rtol=1e-5,
                                   atol=1e-6)


def test_trace_counts_across_preemption_and_resume(models):
    pair = _both(models, num_slots=1)
    batch = _prompts(8, (7,))[0]
    lat = _prompts(9, (5,))[0]
    reqs = []
    for eng, req_cls, tier in ((pair[0], JaxRequest, JaxTier),
                               (pair[1], Request, Tier)):
        b = req_cls(batch, max_new_tokens=10, tier=tier.BATCH)
        eng.submit(b)
        for _ in range(4):
            eng.step()
        eng.run([req_cls(lat, max_new_tokens=3, tier=tier.LATENCY)])
        eng.run([])
        assert eng.preemptions == 1
        reqs.append([b])
    _assert_parity(pair, reqs)


def test_trace_counts_with_a_stalled_slot(models):
    """Every free page held for six steps: a slot whose tail page falls
    due stalls (dead for the step), then resumes."""
    pair = _both(models, num_slots=2, page_size=4, prefix_cache=False)
    stalls = []

    def before(eng, i):
        if i == 3:
            eng._alloc.hold(eng._alloc.free_count)
        if i == 9:
            eng._alloc.release_held()

    def after(eng, i):
        stalls.append(max((s.stall_count for s in eng._slots
                           if s is not None), default=0))

    streams = _serve(pair, _greedy(_prompts(10, (7, 6)), n=14),
                     before_step=before, after_step=after)
    _assert_parity(pair, streams)
    assert max(stalls) > 0


def test_a_dropped_engine_is_freed_without_the_cycle_collector(models):
    """The step programs hold their engine weakly, so dropping the last
    reference frees the engine (on the card: its pools and graphs) at
    once."""
    import gc
    import weakref
    _, tm = models
    eng = InferenceEngine(tm, num_slots=2, page_size=8, max_len=64, spec_k=2)
    eng.run([Request(p, max_new_tokens=6) for p in _prompts(13, (6, 9))])
    assert eng._programs
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


# --------------------------------------------------------------------- #
# the body reads nothing on the host
# --------------------------------------------------------------------- #

def _raise(*_a, **_k):
    raise AssertionError("host sync inside the step body")


class _NoGenerator:
    def __init__(self, *_a, **_k):
        _raise()


@pytest.mark.parametrize("kw", [dict(), dict(spec_k=3),
                                dict(spec_k=3, kv_quant="int8")],
                         ids=["decode", "verify", "verify-int8"])
def test_step_body_makes_no_host_sync(models, kw, monkeypatch):
    _, tm = models
    eng = InferenceEngine(tm, num_slots=2, page_size=8, max_len=64, **kw)
    p = _prompts(11, (8,))[0]
    gram = choice_grammar([[1, 2, 3, 1], [5, 6]], V)
    reqs = [Request(np.concatenate([p, p]), max_new_tokens=12,
                    temperature=0.9, seed=3),
            Request(p, max_new_tokens=12, eos_id=9,
                    sampling=SamplingParams(grammar=gram, top_k=4))]
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert eng._programs
    for W, prog in eng._programs.items():
        toks = np.zeros((eng.num_slots, W), np.int64)
        toks[:, 0] = [r.token_ids[-1] if r.token_ids else 0 for r in reqs]
        eng._stage_step(prog, toks, np.full((2,), W - 1, np.int32), [])
        prog.inp.dev_bytes.copy_(prog.inp.host_bytes)
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "cpu", "numpy", "__bool__"):
                m.setattr(torch.Tensor, name, _raise)
            m.setattr(torch, "Generator", _NoGenerator)
            prog.run_body()
        assert prog.out.dev["n_emit"].min() >= 1


# --------------------------------------------------------------------- #
# the device draw
# --------------------------------------------------------------------- #

def _fmix32_ref(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) % 2 ** 32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) % 2 ** 32
    return h ^ (h >> 16)


def _uniform_ref(key, position, stream):
    """The hash in plain Python integers (full products mod 2**32)."""
    k = key % 2 ** 64
    salt = (0x243F6A88, 0x85A308D3)[stream]
    h = _fmix32_ref((k % 2 ** 32) ^ salt)
    h = _fmix32_ref(h ^ (k >> 32))
    h = _fmix32_ref(h ^ (position % 2 ** 32))
    return np.float32(((h >> 9) + 0.5) * 2.0 ** -23)


def test_draw_uniform_bits_equal_the_python_hash():
    rng = np.random.RandomState(12)
    keys = [0, 1, -1, 2 ** 62 - 1, -2 ** 63, 2 ** 63 - 1] + \
        [int(k) for k in rng.randint(-2 ** 63, 2 ** 63 - 1, size=26,
                                     dtype=np.int64)]
    pos = [0, 1, 7, 1023, 2 ** 31 - 1] + \
        [int(p) for p in rng.randint(0, 2 ** 20, size=11)]
    kt = torch.tensor(keys)[:, None]
    pt = torch.tensor(pos)[None, :]
    for stream in (DRAW_STREAM, ACCEPT_STREAM):
        got = draw_uniform(kt, pt, stream).numpy()
        want = np.array([[_uniform_ref(k, p, stream) for p in pos]
                         for k in keys], np.float32)
        assert got.dtype == np.float32
        assert (got.view(np.uint32) == want.view(np.uint32)).all()
        assert (got > 0).all() and (got < 1).all()


def test_draw_uniform_is_uniform_and_streams_differ():
    keys = torch.arange(20000)[:, None] * 7919 + 12345
    pos = torch.tensor([[5, 6]])
    u = draw_uniform(keys, pos, DRAW_STREAM)
    a = draw_uniform(keys, pos, ACCEPT_STREAM)
    for x in (u[:, 0], u[:, 1], a[:, 0]):
        counts = np.bincount((x.numpy() * 20).astype(int), minlength=20)
        exp = x.numel() / 20
        # 19 degrees of freedom, p = 0.001
        assert (((counts - exp) ** 2) / exp).sum() < 43.82
    for x, y in ((u[:, 0], u[:, 1]), (u[:, 0], a[:, 0])):
        r = np.corrcoef(x.numpy(), y.numpy())[0, 1]
        assert abs(r) < 4 / np.sqrt(x.numel())


def test_inverse_cdf_draw_keeps_the_distribution():
    """12000 keyed draws from one 8-token distribution with a masked
    token: the histogram passes a chi-square test at p = 0.001 (6
    degrees of freedom: 22.46) and never draws the masked token."""
    logits = torch.tensor([1.0, 0.2, -0.5, 0.7, 0.0, -1.2, -1e30, 2.0])
    p = torch.softmax(logits, dim=-1).numpy()
    N = 12000
    u = draw_uniform(torch.arange(N) + 77, torch.full((N,), 9), DRAW_STREAM)
    got = sample_inverse_cdf(logits.expand(N, 8), u).numpy()
    counts = np.bincount(got, minlength=8)
    assert counts[6] == 0
    live = p > 0
    chi2 = (((counts[live] - N * p[live]) ** 2) / (N * p[live])).sum()
    assert chi2 < 22.46, (counts, N * p)
    # the rounding edge: u at 1 takes the last token of nonzero mass
    one = sample_inverse_cdf(logits[None, :7], torch.ones(1))
    assert int(one[0]) == 5
