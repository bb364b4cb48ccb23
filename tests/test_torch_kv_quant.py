"""The quantized KV cache of the PyTorch port against the JAX package.

On identical inputs the port's quantized page writers (token, block and
prompt; int8 and float8_e4m3) give bit-equal codes and per-page amax to
the JAX package's, duplicate pages in one call included, and its
quantization ops the same scales and codes. ``gpt_mini(vocab_size=64,
max_length=64)`` weights go across from the JAX package: the int8
engine's greedy streams and outcomes equal the JAX int8 engine's
(monolithic and chunked, with prefix hits, and together with
``spec_k=4``). Its final pool codes and amax agree to the last bits of
the K/V they quantize: the two frameworks' K/V projections differ in
the last bits, so amax agrees to rtol 1e-6 and a code on a rounding
boundary may differ by one (at most 1 element in 1000). Inside the
port: a shared page stays read-only under concurrency, a copy-on-write
boundary page requantizes within its quanta, a NaN page scale
quarantines exactly the slot that reads it and a reused page starts
clean, and ``kv_quant`` validation and the health fields."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.models import gpt as jg
from incubator_mxnet_tpu.ops import quantization as JQ
from incubator_mxnet_tpu.serve import InferenceEngine as JaxEngine
from incubator_mxnet_tpu.serve import Request as JaxRequest
from incubator_mxnet_tpu.serve import paged_kv as JP

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import quantization as TQ
from incubator_mxnet_tpu_torch.serve import (NULL_PAGE, InferenceEngine,
                                             Outcome, Request)
from incubator_mxnet_tpu_torch.serve import paged_kv as TP

from test_torch_parity import port_gpt

V = 64


@pytest.fixture(scope="module")
def models():
    jmx.random.seed(0)
    jm = jg.gpt_mini(vocab_size=V, max_length=64)
    jm.initialize()
    tm = port_gpt(jm, vocab_size=V, max_length=64)
    return jm, tm


def _codes(pool):
    """A code pool's values as f32 numpy (exact for int8 and float8)."""
    if isinstance(pool, torch.Tensor):
        return pool.float().numpy()
    return np.asarray(pool.astype(jnp.float32))


def test_quantization_ops_match_jax():
    """Scales (zero and NaN amax), round-half-even quantization and the
    requantize rescale, int8 and float8 targets, on the same inputs."""
    amax = np.asarray([0.0, 1.0, 3.7, np.nan, 448.0, 1e-8], np.float32)
    for qmax in (127.0, 448.0):
        np.testing.assert_array_equal(
            TQ.symmetric_scale(torch.tensor(amax), qmax).numpy(),
            np.asarray(JQ.symmetric_scale(jnp.asarray(amax), qmax)))
    x = np.asarray([0.5, 1.5, 2.5, -0.5, -2.5, 3.49, 1e3, -1e3, 300.2,
                    0.0], np.float32)
    for tdt, jdt, qmax in ((torch.int8, jnp.int8, 127.0),
                           (torch.float8_e4m3fn, jnp.float8_e4m3fn, 448.0)):
        for scale in (1.0, 0.37):
            got = TQ.quantize_symmetric(torch.tensor(x), scale, tdt, qmax)
            want = JQ.quantize_symmetric(jnp.asarray(x), scale, jdt, qmax)
            np.testing.assert_array_equal(_codes(got), _codes(want))
            np.testing.assert_array_equal(
                _codes(TQ.requantize_symmetric(got, 0.61, tdt, qmax)),
                _codes(JQ.requantize_symmetric(want, 0.61, jdt, qmax)))
            np.testing.assert_array_equal(
                TQ.dequantize_symmetric(got, scale).numpy(),
                np.asarray(JQ.dequantize_symmetric(want, scale)))


@pytest.mark.parametrize("quant", ["int8", "fp8_e4m3"])
def test_quantized_writers_bit_equal_jax(quant):
    """Token, block (verify window: several rows per page) and prompt
    writes on a pool with existing codes and amax, duplicate pages and
    null-page entries in each call: codes and amax of every real page
    bit-equal (the null page is garbage by contract)."""
    js, ts = JP.kv_quant_spec(quant), TP.kv_quant_spec(quant)
    rng = np.random.RandomState(3)
    P, H, ps, D = 7, 2, 8, 4
    init = np.clip(rng.randn(P, H, ps, D) * 40, -100, 100).round()
    init = init.astype(np.float32)
    amax = (np.abs(rng.randn(P)) * 2).astype(np.float32)
    amax[2] = 0.0                              # a freshly reset page
    jpool = jnp.asarray(init).astype(js.dtype)
    tpool = torch.tensor(init).to(ts.dtype)
    ja, ta = jnp.asarray(amax), torch.tensor(amax)

    def check(jpool, tpool, ja, ta):
        np.testing.assert_array_equal(_codes(tpool)[1:], _codes(jpool)[1:])
        np.testing.assert_array_equal(ta.numpy()[1:], np.asarray(ja)[1:])

    new = (rng.randn(6, H, D) * 4).astype(np.float32)
    pages = np.asarray([1, 1, 2, 3, 1, NULL_PAGE], np.int32)
    offs = np.asarray([0, 3, 5, 1, 7, 2], np.int32)
    jpool, ja = JP.write_token_kv_q(jpool, ja, jnp.asarray(new),
                                    jnp.asarray(pages), jnp.asarray(offs),
                                    js)
    tpool, ta = TP.write_token_kv_q(tpool, ta, torch.tensor(new),
                                    torch.tensor(pages).long(),
                                    torch.tensor(offs).long(), ts)
    check(jpool, tpool, ja, ta)
    blk = (rng.randn(2, 3, H, D) * 6).astype(np.float32)
    bpages = np.asarray([[4, 4, 5], [NULL_PAGE, 2, 2]], np.int32)
    boffs = np.asarray([[6, 7, 0], [0, 6, 7]], np.int32)
    jpool, ja = JP.write_block_kv_q(jpool, ja, jnp.asarray(blk),
                                    jnp.asarray(bpages), jnp.asarray(boffs),
                                    js)
    tpool, ta = TP.write_block_kv_q(tpool, ta, torch.tensor(blk),
                                    torch.tensor(bpages).long(),
                                    torch.tensor(boffs).long(), ts)
    check(jpool, tpool, ja, ta)
    kv = (rng.randn(4 * ps, H, D) * 3).astype(np.float32)
    ppages = np.asarray([6, 3, NULL_PAGE, NULL_PAGE], np.int32)
    jpool, ja = JP.write_prompt_kv_q(jpool, ja, jnp.asarray(kv),
                                     jnp.asarray(ppages), js)
    tpool, ta = TP.write_prompt_kv_q(tpool, ta, torch.tensor(kv),
                                     torch.tensor(ppages).long(), ts)
    check(jpool, tpool, ja, ta)
    np.testing.assert_array_equal(
        TP.page_scales(ta, ts).numpy()[1:],
        np.asarray(JP.page_scales(ja, js))[1:])


def _workload():
    """Six prompts for three slots, two sharing a 20-token prefix with the
    first (two full pages and a copy-on-write boundary page at page
    size 8)."""
    rng = np.random.RandomState(2)
    prefix = rng.randint(0, V, size=20)
    prompts = [np.concatenate([prefix, rng.randint(0, V, size=3)])]
    prompts += [rng.randint(0, V, size=n) for n in (3, 9, 17, 5)]
    prompts += [np.concatenate([prefix, rng.randint(0, V, size=6)])]
    news = (10, 6, 14, 8, 12, 9)
    eos = (-1, 7, -1, 3, -1, 11)
    return [dict(prompt_ids=p.astype(np.int32), max_new_tokens=n,
                 eos_id=e) for p, n, e in zip(prompts, news, eos)]


def _run_both(models, **engine_kw):
    jm, tm = models
    kw = dict(num_slots=3, page_size=8, max_len=64, num_pages=24,
              kv_quant="int8", **engine_kw)
    je, te = JaxEngine(jm, **kw), InferenceEngine(tm, **kw)
    jr = [JaxRequest(**s) for s in _workload()]
    tr = [Request(**s) for s in _workload()]
    je.run(jr)
    te.run(tr)
    je.audit_pages()
    te.audit_pages()
    for a, b in zip(jr, tr):
        assert b.token_ids == a.token_ids
        assert b.outcome.value == a.outcome.value
        assert (b.drafted_tokens, b.accepted_tokens) == \
            (a.drafted_tokens, a.accepted_tokens)
    assert te.prefix_hits == je.prefix_hits > 0
    assert te.decode_steps == je.decode_steps
    for l in range(tm.num_layers):
        for jp, tp in ((je._kpools[l], te._kpools[l]),
                       (je._vpools[l], te._vpools[l])):
            d = np.abs(_codes(tp)[1:] - _codes(jp)[1:])
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3
        for ja, ta in ((je._kamax[l], te._kamax[l]),
                       (je._vamax[l], te._vamax[l])):
            np.testing.assert_allclose(ta[1:], np.asarray(ja)[1:],
                                       rtol=1e-6, atol=0)
    return je, te


@pytest.mark.parametrize("mode", [dict(), dict(chunk_pages=1)],
                         ids=["monolithic", "chunk1"])
def test_int8_engine_greedy_codes_and_amax_match_jax(models, mode):
    _run_both(models, **mode)


def test_spec_k4_with_int8_matches_jax(models):
    je, te = _run_both(models, spec_k=4, chunk_pages=2)
    assert te.spec_steps == je.spec_steps > 0
    assert te.accepted_tokens == je.accepted_tokens > 0
    assert all(o in (Outcome.EOS.value, Outcome.MAX_TOKENS.value)
               or n == 0 for o, n in te.health.items())


def _eng(tm, **kw):
    cfg = dict(num_slots=3, page_size=8, max_len=64, kv_quant="int8")
    cfg.update(kw)
    return InferenceEngine(tm, **cfg)


def test_quantized_shared_page_read_only_under_concurrency(models):
    """Two live slots sharing prefix pages (refcount >= 2 mid-flight, one
    scale serving both): the first requester's tokens equal its solo
    quantized run — a sharer's copy-on-write never touches the cached
    original."""
    _, tm = models
    rng = np.random.RandomState(3)
    head = rng.randint(0, V, size=(16,)).astype(np.int32)
    p1 = np.concatenate([head, rng.randint(0, V, size=(5,))])
    p2 = np.concatenate([head, rng.randint(0, V, size=(6,))])
    solo = Request(p1, max_new_tokens=8)
    _eng(tm).run([solo])
    eng = _eng(tm)
    r1, r2 = Request(p1, max_new_tokens=8), Request(p2, max_new_tokens=8)
    seen = []

    def before(e, i):
        live = [s for s in e._slots if s is not None]
        if len(live) == 2:
            seen.append(max(e._alloc.refcount(int(p)) for s in live
                            for p in s.row if int(p) != NULL_PAGE))

    eng.run([r1, r2], arrival_times=[0.0, 0.0], before_step=before)
    assert seen and max(seen) >= 2 and eng.prefix_hits >= 1
    assert r1.token_ids == solo.token_ids
    eng.audit_pages()


def test_cow_boundary_copy_requantizes_correctly(models):
    """Copying a page's codes with its amax preserves it exactly; hotter
    suffix rows grow the private copy's scale and requantize its prefix
    rows within the old and new half-quanta; the original is untouched.
    End to end, a prompt sharing a partial boundary page completes."""
    spec = TP.kv_quant_spec("int8")
    rng = np.random.RandomState(4)
    H, ps, D, P = 2, 8, 4, 6
    pool = torch.zeros(P, H, ps, D, dtype=torch.int8)
    rows = rng.randn(ps, H, D).astype(np.float32)
    pool, amax = TP.write_prompt_kv_q(pool, torch.zeros(P),
                                      torch.tensor(rows),
                                      torch.tensor([1]), spec)
    pool[2] = pool[1]                           # engine._copy_page
    amax[2] = amax[1]
    original = pool[1].clone()
    s_before = float(TP.page_scales(amax, spec)[2])
    suffix = (4.0 * rng.randn(3, H, D)).astype(np.float32)
    pool, amax2 = TP.write_token_kv_q(pool, amax, torch.tensor(suffix),
                                      torch.tensor([2, 2, 2]),
                                      torch.tensor([5, 6, 7]), spec)
    s_after = float(TP.page_scales(amax2, spec)[2])
    assert s_after >= s_before
    deq = pool[2].float().numpy() * s_after
    assert np.abs(deq[:, :5] - np.moveaxis(rows[:5], 0, 1)).max() <= \
        s_before / 2 + s_after / 2 + 1e-6
    assert np.abs(deq[:, 5:] - np.moveaxis(suffix, 0, 1)).max() <= \
        s_after / 2 + 1e-6
    assert torch.equal(pool[1], original)

    _, tm = models
    head = rng.randint(0, V, size=(12,)).astype(np.int32)   # 1.5 pages
    eng = _eng(tm, chunk_pages=1)
    reqs = [Request(np.concatenate([head, rng.randint(0, V, size=(n,))]),
                    max_new_tokens=6) for n in (4, 6)]
    for r in reqs:
        eng.run([r])
        assert r.outcome.ok and len(r.token_ids) == 6
    assert eng.prefix_hits >= 1
    eng.audit_pages()


def test_corrupt_scale_quarantines_and_page_reuse_is_clean(models):
    """A NaN amax on a live page (the code pool's corruption channel)
    quarantines exactly the slot that reads it, recording nothing of the
    poisoned step; the page's amax is reset when it is handed out again,
    so a request sweeping the whole pool completes cleanly."""
    _, tm = models
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, V, size=(n,)).astype(np.int32)
               for n in (9, 13)]
    kw = dict(num_slots=2, prefix_cache=False, num_pages=9)
    base = [Request(p, max_new_tokens=10) for p in prompts]
    _eng(tm, **kw).run(base)
    eng = _eng(tm, **kw)
    reqs = [Request(p, max_new_tokens=10) for p in prompts]
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    victim = next(s for s in range(2) if eng._slots[s] is not None)
    page = int(eng._slots[victim].row[0])
    before = list(eng._slots[victim].request.token_ids)
    eng._kamax[0][page] = np.nan
    eng.run([])
    bad = reqs[victim]
    assert bad.outcome is Outcome.FAILED_NONFINITE
    assert bad.token_ids == before == base[victim].token_ids[:len(before)]
    good = reqs[1 - victim]
    assert good.outcome.ok and good.token_ids == base[1 - victim].token_ids
    assert eng.quarantined == 1
    assert not np.isfinite(eng._kamax[0][page])   # free, still poisoned
    r3 = Request(rng.randint(0, V, size=(32,)).astype(np.int32),
                 max_new_tokens=32)               # needs all 8 pages
    eng.run([r3])
    assert r3.outcome.ok
    assert np.isfinite(np.concatenate(eng._kamax + eng._vamax)).all()
    eng.audit_pages()


def test_kv_quant_spec_validation_and_health_fields(models):
    assert TP.kv_quant_spec(None) is None
    assert TP.kv_quant_spec("none") is None
    assert TP.kv_quant_spec("int8").qmax == 127.0
    assert TP.kv_quant_spec("fp8_e4m3").dtype is torch.float8_e4m3fn
    with pytest.raises(MXNetError, match="kv_quant"):
        TP.kv_quant_spec("int4")
    _, tm = models
    with pytest.raises(MXNetError, match="kv_quant"):
        InferenceEngine(tm, num_slots=1, max_len=64, kv_quant="int4")
    sizes = {}
    for quant in (None, "int8", "fp8_e4m3"):
        eng = _eng(tm, kv_quant=quant)
        req = Request(np.arange(7, dtype=np.int32), max_new_tokens=12)
        eng.run([req])
        assert req.outcome.ok and len(req.token_ids) == 12
        snap = eng.health_snapshot()
        assert snap["kv_quant"] == (quant or "off")
        assert snap["kv_dtype"] == {None: "float32", "int8": "int8",
                                    "fp8_e4m3": "float8_e4m3fn"}[quant]
        assert snap["kv_quantized_pages"] == (
            eng.num_pages - 1 - snap["free_pages"] if quant else 0)
        sizes[quant] = snap["kv_pool_bytes"]
    # one byte per element plus two f32 scales per page per layer
    L, P = tm.num_layers, eng.num_pages
    assert sizes["int8"] == sizes["fp8_e4m3"] == \
        sizes[None] // 4 + 2 * L * P * 4
