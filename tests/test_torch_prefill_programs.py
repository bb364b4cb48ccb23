"""The port's compiled-once prefill, chunk and COW-copy programs, on the CPU.

``gpt_mini(vocab_size=64, max_length=64)`` is initialized in the JAX
package and its weights go across into the port (the fixture of
``test_torch_serve_programs.py``). Held against the JAX engine:
``prefill_trace_count``, ``prefill_trace_counts[("dense"|"chunk",
Tpad)]`` and ``copy_trace_count`` (the port counts program builds —
CUDA-graph captures on the card — where the JAX engine counts traces),
dict for dict with every value 1, in the scenarios of the reference
tests that assert them (``tests/test_serve.py`` and
``tests/test_kv_quant.py``): monolithic and chunked modes, a prefix hit
with a COW boundary page, a repeat that adds no build, int8 pools,
preemption and resume; greedy streams equal. Held inside the port: the
dense, chunk and copy bodies read nothing on the host
(``Tensor.item`` / ``tolist`` / ``cpu`` / ``numpy`` / ``__bool__``
patched to raise); ``ragged_prefill_attention`` with the chunk as a
device span equals the host-int form and the JAX function under
interpret mode (f32 tolerance 1e-5: both accumulate in f32, in different
orders); the kernel wrapper's plan and launch arguments are the same
wherever the chunk starts."""

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops import ragged_attention as J
from incubator_mxnet_tpu.serve import Request as JaxRequest
from incubator_mxnet_tpu.serve import Tier as JaxTier

from incubator_mxnet_tpu_torch.ops import ragged_attention as T
from incubator_mxnet_tpu_torch.serve import (Request, SamplingParams, Tier,
                                             choice_grammar)
from incubator_mxnet_tpu_torch.serve.sampling import grammar_mask
from test_torch_serve_programs import (V, _both, _greedy, _prompts,  # noqa
                                       _serve, models)

ATOL = RTOL = 1e-5


def _counts(e):
    return (e.prefill_trace_count, dict(e.prefill_trace_counts),
            e.copy_trace_count, e.decode_trace_count, e.verify_trace_count)


def _assert_parity(pair, streams=None):
    je, te = pair
    assert _counts(te) == _counts(je)
    assert set(te.prefill_trace_counts.values()) <= {1}
    assert te.prefill_trace_count == len(te.prefill_trace_counts)
    assert te.copy_trace_count <= 1
    if streams is not None:
        jr, tr = streams
        assert [r.token_ids for r in tr] == [r.token_ids for r in jr]


def test_prefill_counts_zero_before_any_step(models):
    pair = _both(models, chunk_pages=1)
    assert _counts(pair[1]) == _counts(pair[0]) == (0, {}, 0, 0, 0)
    pair[1].submit(Request(_prompts(0, (5,))[0], max_new_tokens=2))
    assert _counts(pair[1]) == (0, {}, 0, 0, 0)
    assert not pair[1]._prefill_programs and pair[1]._copy_prog is None


def test_prefill_counts_monolithic_buckets(models):
    """test_serve.py's occupancy scenario: prompts of 1-11 tokens, one
    dense program per power-of-two page bucket (1 and 2 pages)."""
    pair = _both(models, num_slots=4)
    rng = np.random.RandomState(6)
    specs = [dict(prompt_ids=rng.randint(0, V, size=1 + 2 * i),
                  max_new_tokens=3 + i) for i in range(6)]
    streams = _serve(pair, specs)
    _assert_parity(pair, streams)
    assert set(pair[1].prefill_trace_counts) == {("dense", 8),
                                                 ("dense", 16)}


@pytest.mark.parametrize("chunk_pages", [1, 2])
def test_prefill_counts_chunked(models, chunk_pages):
    """test_serve.py's chunked-parity scenario: sub-page, exact-page and
    odd-tail prompts; only chunk programs, one per bucket."""
    pair = _both(models, prefix_cache=False, chunk_pages=chunk_pages)
    rng = np.random.RandomState(25)
    specs = [dict(prompt_ids=rng.randint(0, V, size=n), max_new_tokens=k)
             for n, k in zip((3, 16, 17, 9, 26), (10, 6, 12, 8, 9))]
    streams = _serve(pair, specs)
    _assert_parity(pair, streams)
    assert {k for k, _ in pair[1].prefill_trace_counts} == {"chunk"}


def test_prefill_counts_prefix_hit_with_a_cow_page(models):
    """test_serve.py's persona scenario: a 20-token prefix shared by
    three prompts; the later admissions map two pages read-only, copy
    the boundary page (the COW program, built once) and run the suffix
    through a chunk program."""
    pair = _both(models, num_slots=2)
    rng = np.random.RandomState(21)
    persona = rng.randint(0, V, size=20)
    specs = [dict(prompt_ids=np.concatenate(
        [persona, rng.randint(0, V, size=5)]), max_new_tokens=8)
        for _ in range(3)]
    streams = _serve(pair, specs)
    _assert_parity(pair, streams)
    assert pair[1].prefix_hits >= 1 and pair[1].copy_trace_count == 1
    assert {k for k, _ in pair[1].prefill_trace_counts} == {"dense",
                                                            "chunk"}


@pytest.mark.parametrize("kw", [dict(), dict(kv_quant="int8",
                                             chunk_pages=1)],
                         ids=["monolithic", "chunked-int8"])
def test_prefill_repeat_adds_no_build(models, kw):
    """The same prompt twice (test_serve.py's warm-restart request and
    test_kv_quant.py's cache-hit scenario): the second admission hits
    the prefix index and builds nothing new."""
    pair = _both(models, **kw)
    prompt = _prompts(11 if not kw else 2, (7 if not kw else 19,))[0]
    first = _serve(pair, _greedy([prompt]))
    _assert_parity(pair, first)
    counts = _counts(pair[1])
    again = _serve(pair, _greedy([prompt.copy()]))
    _assert_parity(pair, again)
    assert _counts(pair[1]) == counts
    assert again[1][0].token_ids == first[1][0].token_ids
    if kw:
        assert pair[1].prefix_hits == 1
        # page 0 is the null page: padded chunk rows write garbage there
        # (the port's attention rows past n_real are zeros, JAX's are
        # computed), and nothing reads it unmasked
        for ja, ta in zip(pair[0]._kamax + pair[0]._vamax,
                          pair[1]._kamax + pair[1]._vamax):
            np.testing.assert_allclose(np.asarray(ja)[1:], ta[1:],
                                       rtol=1e-5, atol=1e-6)


def test_prefill_counts_int8_cow_boundary_page(models):
    """test_kv_quant.py's COW scenario: a prompt sharing a partial
    boundary page with a cached one copies it (codes and scale) once."""
    pair = _both(models, kv_quant="int8", chunk_pages=1)
    rng = np.random.RandomState(5)
    head = rng.randint(0, V, size=12)
    p1 = np.concatenate([head, rng.randint(0, V, size=4)])
    p2 = np.concatenate([head, rng.randint(0, V, size=6)])
    first = _serve(pair, _greedy([p1], n=6))
    second = _serve(pair, _greedy([p2], n=6))
    _assert_parity(pair, (first[0] + second[0], first[1] + second[1]))
    assert pair[1].copy_trace_count == 1 and pair[1].prefix_hits >= 1


def test_prefill_counts_across_preemption_and_resume(models):
    """A BATCH request preempted mid-decode by a LATENCY one resumes by
    prefilling prompt + emitted tokens: a new bucket, built once."""
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


# --------------------------------------------------------------------- #
# the bodies read nothing on the host
# --------------------------------------------------------------------- #

def _raise(*_a, **_k):
    raise AssertionError("host sync inside a prefill or copy body")


def _run_body_without_host_reads(prog, monkeypatch):
    prog.inp.dev_bytes.copy_(prog.inp.host_bytes)
    with monkeypatch.context() as m:
        for name in ("item", "tolist", "cpu", "numpy", "__bool__"):
            m.setattr(torch.Tensor, name, _raise)
        prog.run_body()


@pytest.mark.parametrize("kind", ["chunk", "dense"])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_prefill_body_makes_no_host_sync(models, kind, quant,
                                         monkeypatch):
    from incubator_mxnet_tpu_torch.serve import InferenceEngine
    _, tm = models
    eng = InferenceEngine(tm, num_slots=2, page_size=8, max_len=64,
                          kv_quant=quant,
                          chunk_pages=1 if kind == "chunk" else None)
    gram = choice_grammar([[1, 2, 3, 1], [5, 6]], V)
    p = _prompts(12, (20,))[0]
    req = Request(p, max_new_tokens=12, eos_id=9, temperature=0.9, seed=4,
                  sampling=SamplingParams(grammar=gram, top_k=4,
                                          repetition_penalty=1.2))
    eng.submit(req)
    eng.step()
    s = next(i for i, sl in enumerate(eng._slots) if sl is not None)
    slot = eng._slots[s]
    if kind == "chunk":
        assert slot.prefill_pos == 8
        prog = eng._stage_chunk(s, 8, 12)     # the final chunk: 12 of 16
    else:
        prog = eng._stage_dense(s)            # the 20 tokens again
    assert eng.prefill_trace_counts[(kind, 8 if kind == "chunk" else 32)]
    _run_body_without_host_reads(prog, monkeypatch)
    tok = int(prog.out.dev["tok"][0])
    # drawn under the grammar's mask at the slot's current state
    assert grammar_mask(gram, slot.grammar_state, 9)[tok]


def test_copy_body_makes_no_host_sync(models, monkeypatch):
    from incubator_mxnet_tpu_torch.serve import InferenceEngine
    _, tm = models
    eng = InferenceEngine(tm, num_slots=2, page_size=8, max_len=64,
                          kv_quant="int8")
    for p in eng._kpools + eng._vpools:
        p.copy_(torch.randint(-127, 128, p.shape).to(p.dtype))
    prog = eng._copy_program()
    assert eng.copy_trace_count == 1
    prog.inp.host["pair"][...] = (3, 5)
    _run_body_without_host_reads(prog, monkeypatch)
    for p in eng._kpools + eng._vpools:
        assert torch.equal(p[5], p[3])


# --------------------------------------------------------------------- #
# the chunk as a device span
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("start,n_real,C,ps", [
    (5, 10, 16, 8),            # n_real < C
    (0, 16, 16, 8),            # start 0
    (12, 9, 16, 8),            # the chunk crosses a page
])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_span_form_equals_host_form_and_jax(start, n_real, C, ps, quant):
    import jax.numpy as jnp
    rng = np.random.RandomState(start + C)
    H, D = 2, 16
    n_live = -(-(start + C) // ps)
    P = n_live + 3
    kp = rng.randn(P, H, ps, D).astype(np.float32)
    vp = rng.randn(P, H, ps, D).astype(np.float32)
    row = np.zeros((n_live + 1,), np.int32)
    row[:n_live] = rng.permutation(np.arange(1, P))[:n_live]
    q = rng.randn(C, H, D).astype(np.float32)
    kw, jkw = {}, {}
    if quant is not None:
        kp = rng.randint(-127, 128, size=kp.shape).astype(np.float32)
        vp = rng.randint(-127, 128, size=vp.shape).astype(np.float32)
        ks = (rng.rand(P) * 0.02 + 0.005).astype(np.float32)
        vs = (rng.rand(P) * 0.02 + 0.005).astype(np.float32)
        kw = dict(k_scale=torch.tensor(ks), v_scale=torch.tensor(vs))
        jkw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tk, tv = (torch.tensor(a).to(torch.int8) for a in (kp, vp))
        jk, jv = (jnp.asarray(a).astype(jnp.int8) for a in (kp, vp))
    else:
        tk, tv = torch.tensor(kp), torch.tensor(vp)
        jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    args = (torch.tensor(q), tk, tv, torch.tensor(row))
    span = torch.tensor([start, n_real], dtype=torch.int32)
    got = T.ragged_prefill_attention(*args, span, **kw).numpy()
    host = T.ragged_prefill_attention(*args, start, n_real=n_real,
                                      **kw).numpy()
    assert (got.view(np.uint32) == host.view(np.uint32)).all()
    assert (got[n_real:] == 0).all()
    want = J.ragged_prefill_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(row), np.int32(start),
        n_real=np.int32(n_real), interpret=True, **jkw)
    np.testing.assert_allclose(got[:n_real], np.asarray(want)[:n_real],
                               atol=ATOL, rtol=RTOL)
    with pytest.raises(T.MXNetError, match="not both"):
        T.ragged_prefill_attention(*args, span, n_real=n_real)


# --------------------------------------------------------------------- #
# the plan: the same launch wherever the chunk starts
# --------------------------------------------------------------------- #

class _FakeLib:
    """Records ``mx_ragged_prefill``'s arguments instead of launching."""

    def __init__(self):
        self.calls = []

    def mx_ragged_prefill(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("tc", [True, False], ids=["tensor-cores",
                                                   "cuda-cores"])
def test_plan_is_the_same_at_every_start_and_covers_the_capacity(
        tc, monkeypatch):
    """The wrapper's launch, with the device check and the library
    stubbed: for chunks at starts 0 to the capacity's end, every
    argument but the span's address is identical, the span's address is
    the one passed, and the plan covers the page row's capacity."""
    lib = _FakeLib()
    monkeypatch.setattr(T, "_check_operands", lambda *a, **k: 1)
    monkeypatch.setattr(T, "_bind", lambda name: lib)
    monkeypatch.setattr(T, "_stream_ptr", lambda dev: None)
    monkeypatch.setattr(T, "_sm_count", lambda dev: T.H100_SMS)
    monkeypatch.setattr(T, "_count", lambda *a: None)
    C, H, ps, maxp = 64, 12, 16, 64
    D = 64 if tc else 128
    dt = torch.bfloat16 if tc else torch.float32
    q = torch.zeros(C, H, D, dtype=dt)
    kp = torch.zeros(maxp + 1, H, ps, D, dtype=dt)
    row = torch.arange(1, maxp + 1, dtype=torch.int32)
    spans = [torch.tensor([s, n], dtype=torch.int32)
             for s, n in ((0, 64), (64, 64), (200, 37), (960, 64),
                          (1000, 0))]
    for span in spans:
        T._ragged_prefill_cuda(q, kp, kp, row, span, D ** -0.5)
    fixed = [c[:4] + c[5:7] + c[9:] for c in lib.calls]   # not out, part
    assert all(f == fixed[0] for f in fixed)
    assert [c[4] for c in lib.calls] == [s.data_ptr() for s in spans]
    C_, H_, D_, ps_, maxp_, split_keys, nsplit, q_tiles = lib.calls[0][9:17]
    assert (C_, H_, D_, ps_, maxp_) == (C, H, D, ps, maxp)
    assert nsplit * split_keys >= maxp * ps > (nsplit - 1) * split_keys
    assert nsplit <= 16 if tc else split_keys == 64
