"""The port's page transport and warm restart against the JAX package's.

``gpt_mini`` (f32) is initialized in the JAX package and its weights go
across into the port. Held here:

  - a slot captured mid-stream off one engine (``PageTransport.capture``:
    the gather program, then custody) and installed on another
    (``install``: the promotion program; the destination's next decode
    step takes the slot on, with no prefill, where the JAX engine runs
    the boundary token through its chunk program): the combined greedy
    stream equals the unmigrated one and the JAX pair's, with the
    migration counters, the custody and the builds as the JAX engines'; seedless and seeded
    temperature streams continue unchanged (the key travels in the
    capsule; held inside the port, whose draws differ from JAX's);
  - every failure refuses with both engines' ``audit_pages()`` clean: an
    abort before the detach (the slot keeps decoding), an abort
    mid-install (the destination rolled back), a corrupt capsule, a
    wire-signature mismatch, an unknown request; custody accounting;
  - ``warm_start(params=...)``: the port's ``state_dict()`` names or the
    JAX package's positional ``param/<i>`` tree (a training capsule's
    other entries ignored); the engine then serves as a fresh engine on
    the new weights and as the JAX engine on them, with no new build,
    the parameters at their addresses, the prefix index and the tiers
    flushed; a shape mismatch is refused with the weights unchanged.
"""

import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.models import gpt as jg
from incubator_mxnet_tpu.serve import InferenceEngine as JaxEngine
from incubator_mxnet_tpu.serve import PageTransport as JaxTransport
from incubator_mxnet_tpu.serve import Request as JaxRequest

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models import convert, gpt as tg
from incubator_mxnet_tpu_torch.serve import (InferenceEngine, PageTransport,
                                             Request)

V = 64
PS = 8
ENG_KW = dict(num_slots=2, page_size=PS, max_len=64, chunk_pages=1,
              prefix_cache=True)
MIGRATION = ("migrated_out_pages", "migrated_in_pages",
             "migrated_out_bytes", "migrated_in_bytes", "capsule_pages")


def _jax_model(seed):
    jmx.random.seed(seed)
    jm = jg.gpt_mini(vocab_size=V, max_length=64)
    jm.initialize()
    return jm


def _port_model(jm):
    tm = tg.gpt_mini(vocab_size=V, max_length=64, device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        [p.data().asnumpy() for p in jm.collect_params().values()]))
    return tm


@pytest.fixture(scope="module")
def models():
    jm = _jax_model(0)
    return jm, _port_model(jm)


def _prompt(seed=5, n=18):
    return np.random.RandomState(seed).randint(0, V, size=(n,)) \
        .astype(np.int32)


def _step_until(eng, pred, guard=400):
    for _ in range(guard):
        if pred():
            return True
        eng.step()
        eng.audit_pages()
    return pred()


def _reference(Engine, Req, model, req_kw, **kw):
    eng = Engine(model, **dict(ENG_KW, **kw))
    req = Req(**req_kw)
    eng.run([req], poll_sleep=1e-4)
    assert req.outcome is not None and req.outcome.ok
    return list(req.token_ids)


def _migrate(Engine, Req, Transport, model, req_kw, k=3, **kw):
    """Step a request to ``k`` tokens on a source engine, capture it,
    install it on a destination, release the custody, finish it there;
    returns the combined stream, both engines' migration counters and
    builds, and the destination's prefill tokens for the installed
    attempt."""
    src = Engine(model, **dict(ENG_KW, **kw))
    dst = Engine(model, **dict(ENG_KW, **kw))
    req = Req(**req_kw)
    assert src.submit(req)
    assert _step_until(src, lambda: len(req.token_ids) >= k)
    head = list(req.token_ids)
    tr = Transport()
    cap = tr.capture(src, req.request_id)
    assert cap is not None and tr.captures == 1
    src.audit_pages()                        # pages in custody
    custody = src.health_snapshot()["capsule_pages"]
    att = cap.make_resume_request()
    assert att is not None
    assert tr.install(dst, cap, att) and tr.installs == 1
    assert src.release_capsule(req.request_id) == cap.num_pages
    src.audit_pages()
    dst.audit_pages()
    assert _step_until(dst, lambda: att.outcome is not None)
    assert att.outcome.ok
    snaps = [e.health_snapshot() for e in (src, dst)]
    chunks = [e.data["n"] for e in dst.flight.events()
              if e.etype.value == "PREFILL_CHUNK" and
              e.request_id == att.request_id]
    return dict(
        tokens=head + list(att.token_ids), n_pos=cap.n_pos,
        pages=cap.num_pages, custody=custody, chunks=chunks,
        counters=[{k: s[k] for k in MIGRATION} for s in snaps],
        builds=[(e.demote_trace_count, e.promote_trace_count,
                 e.decode_trace_count) for e in (src, dst)])


@pytest.fixture(scope="module")
def jax_runs(models):
    jm, _ = models
    out = {}
    for q in (None, "int8"):
        kw = {} if q is None else {"kv_quant": q}
        req_kw = dict(prompt_ids=_prompt(), max_new_tokens=8)
        out[q] = dict(
            want=_reference(JaxEngine, JaxRequest, jm, req_kw, **kw),
            migrated=_migrate(JaxEngine, JaxRequest, JaxTransport, jm,
                              req_kw, **kw))
    return out


# --------------------------------------------------------------------- #
# capture / install
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32", "int8"])
def test_capture_install_parity(models, jax_runs, kv_quant):
    """A slot migrated after 3 tokens: the combined greedy stream equals
    the unmigrated one and the JAX pair's; pages, bytes, custody and
    builds as the JAX engines'. The port's destination prefills nothing
    (its decode step takes the boundary token); the JAX engine's runs
    one chunk of one token."""
    _, tm = models
    kw = {} if kv_quant is None else {"kv_quant": kv_quant}
    req_kw = dict(prompt_ids=_prompt(), max_new_tokens=8)
    want = _reference(InferenceEngine, Request, tm, req_kw, **kw)
    got = _migrate(InferenceEngine, Request, PageTransport, tm, req_kw,
                   **kw)
    jax = dict(jax_runs[kv_quant]["migrated"])
    assert got["tokens"] == want == jax_runs[kv_quant]["want"]
    assert got["chunks"] == [] and jax.pop("chunks") == [1]
    assert {k: v for k, v in got.items() if k != "chunks"} == jax
    assert got["n_pos"] == 20
    assert got["counters"][0]["migrated_out_pages"] == got["pages"] == 3
    assert got["custody"] == 3
    # one gather build on the source, one promotion build on the
    # destination, one decode program each
    assert got["builds"] == [(1, 0, 1), (0, 1, 1)]


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32", "int8"])
def test_seedless_temperature_continues(models, kv_quant):
    """Seedless T=0.8: engines built alike draw the same keys, and the
    key travels in the capsule, so the migrated stream is the
    unmigrated one."""
    _, tm = models
    kw = {} if kv_quant is None else {"kv_quant": kv_quant}
    req_kw = dict(prompt_ids=_prompt(), max_new_tokens=8, temperature=0.8)
    want = _reference(InferenceEngine, Request, tm, req_kw, **kw)
    assert _reference(InferenceEngine, Request, tm, req_kw, **kw) == want
    got = _migrate(InferenceEngine, Request, PageTransport, tm, req_kw,
                   **kw)
    assert got["tokens"] == want


def test_seeded_temperature_replica_independent(models):
    """A seeded stream is a function of (seed, position): an engine with
    another history replays it, and so does a migration."""
    _, tm = models
    req_kw = dict(prompt_ids=_prompt(11), max_new_tokens=8,
                  temperature=0.8, seed=1234)
    want = _reference(InferenceEngine, Request, tm, req_kw)
    other = InferenceEngine(tm, **ENG_KW)
    other.run([Request(_prompt(12), max_new_tokens=2)], poll_sleep=1e-4)
    again = Request(**req_kw)
    other.run([again], poll_sleep=1e-4)
    assert list(again.token_ids) == want
    got = _migrate(InferenceEngine, Request, PageTransport, tm, req_kw)
    assert got["tokens"] == want


def _src_at(tm, seed, k=3, **kw):
    src = InferenceEngine(tm, **dict(ENG_KW, **kw))
    req = Request(_prompt(seed), max_new_tokens=8)
    assert src.submit(req)
    assert _step_until(src, lambda: len(req.token_ids) >= k)
    return src, req


def test_capture_abort_pre_detach_leaves_slot_decoding(models):
    _, tm = models
    want = _reference(InferenceEngine, Request, tm,
                      dict(prompt_ids=_prompt(21), max_new_tokens=8))
    src, req = _src_at(tm, 21)
    tr = PageTransport()
    tr._capture_abort = lambda: True
    assert tr.capture(src, req.request_id) is None
    assert tr.capture_failures == 1
    src.audit_pages()
    assert _step_until(src, lambda: req.outcome is not None)
    assert req.outcome.ok and list(req.token_ids) == want


def test_install_abort_rolls_destination_back(models):
    _, tm = models
    src, req = _src_at(tm, 22)
    dst = InferenceEngine(tm, **ENG_KW)
    tr = PageTransport()
    cap = tr.capture(src, req.request_id)
    assert cap is not None
    free0 = dst._alloc.free_count
    tr._install_abort = lambda: True
    assert tr.install(dst, cap, cap.make_resume_request()) is False
    assert tr.install_failures == 1
    assert dst._alloc.free_count == free0 and dst.active_count == 0
    dst.audit_pages()
    assert src.release_capsule(req.request_id) == cap.num_pages
    src.audit_pages()


def test_corrupt_capsule_refused(models):
    _, tm = models
    src, req = _src_at(tm, 23)
    dst = InferenceEngine(tm, **ENG_KW)
    tr = PageTransport()
    cap = tr.capture(src, req.request_id)
    assert cap is not None and cap.verify()
    cap.corrupt(page_idx=0, byte=5)
    assert not cap.verify()
    free0 = dst._alloc.free_count
    assert tr.install(dst, cap, cap.make_resume_request()) is False
    assert tr.install_failures == 1
    assert dst._alloc.free_count == free0
    with pytest.raises(MXNetError, match="crc chain"):
        cap.payloads()
    src.release_capsule(req.request_id)
    src.audit_pages()
    dst.audit_pages()


def test_wire_sig_mismatch_refused(models):
    """int8 pages never install into a raw pool: refused by the wire
    signature before any page lands."""
    _, tm = models
    src, req = _src_at(tm, 24, kv_quant="int8")
    dst = InferenceEngine(tm, **ENG_KW)
    assert src.kv_wire_sig() != dst.kv_wire_sig()
    tr = PageTransport()
    cap = tr.capture(src, req.request_id)
    assert cap is not None
    assert tr.install(dst, cap, cap.make_resume_request()) is False
    assert tr.install_failures == 1 and dst.promote_trace_count == 0
    src.release_capsule(req.request_id)
    src.audit_pages()
    dst.audit_pages()


def test_custody_accounting(models):
    """Between detach and release the pages are in custody: not free,
    not a slot's, refcounted; the audit accepts them; a second release
    returns 0."""
    _, tm = models
    src, req = _src_at(tm, 25)
    free_live = src._alloc.free_count
    tr = PageTransport()
    cap = tr.capture(src, req.request_id)
    assert cap is not None
    assert src._alloc.free_count == free_live
    assert not src.decode_ready(req.request_id)
    src.audit_pages()
    assert src.migrated_out_pages == cap.num_pages
    assert src.migrated_out_bytes == cap.nbytes
    assert src.release_capsule(req.request_id) == cap.num_pages
    assert src._alloc.free_count > free_live
    assert src.release_capsule(req.request_id) == 0
    src.audit_pages()


def test_capture_refuses_unknown_request(models):
    _, tm = models
    src = InferenceEngine(tm, **ENG_KW)
    tr = PageTransport()
    assert tr.capture(src, 10 ** 9) is None
    assert tr.capture_failures == 1
    assert src.capture_slot(10 ** 9) is None
    src.audit_pages()


def test_gathered_pages_are_copies_of_their_own(models):
    """Two gathers in a row: the first payload is not overwritten by the
    second (it is no view of the program's readback buffer)."""
    _, tm = models
    src, req = _src_at(tm, 26)
    row = src.capture_slot(req.request_id)["pages"]
    first = src.gather_page(row[0])
    kept = [a.copy() for a in first[0]]
    second = src.gather_page(row[1])
    assert not np.array_equal(first[0][0], second[0][0])
    for a, b in zip(first[0], kept):
        np.testing.assert_array_equal(a, b)
    assert src.demote_trace_count == 1


# --------------------------------------------------------------------- #
# warm restart
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def model_b():
    """A second model (JAX seed 1234) and what the JAX engine serves on
    it for the warm-start prompt."""
    jb = _jax_model(1234)
    prompt = _prompt(23, 20)
    eng = JaxEngine(jb, num_slots=2, page_size=8, max_len=64)
    r = JaxRequest(prompt.copy(), max_new_tokens=8)
    eng.run([r])
    return jb, _port_model(jb), prompt, list(r.token_ids)


def _serve(eng, prompt):
    r = Request(prompt.copy(), max_new_tokens=8)
    eng.run([r])
    eng.audit_pages()
    return list(r.token_ids)


@pytest.mark.parametrize("form", ["state_dict", "jax_capsule"])
def test_warm_start_swaps_weights_in_place(models, model_b, form):
    """Serve, warm start the other model's weights, serve again: the
    tokens equal a fresh engine's on those weights and the JAX engine's;
    no new build; the parameters keep their addresses (the graphs hold
    them); the cached prefix was flushed."""
    _, tm = models
    jb, tb, prompt, want = model_b
    live = tg.gpt_mini(vocab_size=V, max_length=64, device="cpu")
    live.load_state_dict(tm.state_dict())
    eng = InferenceEngine(live, num_slots=2, page_size=8, max_len=64)
    old = _serve(eng, prompt)
    assert _serve(eng, prompt) == old and eng.prefix_hits == 1
    builds = (eng.decode_trace_count, dict(eng.prefill_trace_counts),
              eng.copy_trace_count)
    ptrs = [p.data_ptr() for p in live.parameters()]
    if form == "state_dict":
        params = tb.state_dict()
    else:
        params = {f"param/{i}": p.data().asnumpy()
                  for i, p in enumerate(jb.collect_params().values())}
        params["opt/0/0"] = np.zeros((1,), np.float32)
        params["rng/key"] = np.zeros((2,), np.uint32)
    flushes = eng.prefix_flushes
    eng.warm_start(params=params)
    assert eng.warm_restarts == 1 and eng.prefix_flushes == flushes + 1
    assert [p.data_ptr() for p in live.parameters()] == ptrs
    hits = eng.prefix_hits
    got = _serve(eng, prompt)
    assert got == want != old
    assert eng.prefix_hits == hits           # nothing served from old K/V
    assert got == _serve(InferenceEngine(tb, num_slots=2, page_size=8,
                                         max_len=64), prompt)
    assert (eng.decode_trace_count, dict(eng.prefill_trace_counts),
            eng.copy_trace_count) == builds


def test_warm_start_refuses_a_shape_mismatch(models):
    _, tm = models
    live = tg.gpt_mini(vocab_size=V, max_length=64, device="cpu")
    live.load_state_dict(tm.state_dict())
    eng = InferenceEngine(live, num_slots=2, page_size=8, max_len=64)
    before = [p.clone() for p in live.parameters()]
    n = len(before)
    bad = {str(i): np.zeros((1, 1), np.float32) for i in range(n)}
    with pytest.raises(MXNetError, match="shape/dtype"):
        eng.warm_start(params=bad)
    # a right tree but for its last entry: nothing written either
    sd = tm.state_dict()
    good = {f"param/{i}": sd[k] for i, k in
            enumerate(convert.gpt_param_names(tm.num_layers))}
    good[f"param/{n - 1}"] = torch.zeros(3)
    with pytest.raises(MXNetError, match="shape/dtype"):
        eng.warm_start(params=good)
    with pytest.raises(MXNetError, match="no value"):
        eng.warm_start(params={"0": before[0]})
    for a, b in zip(live.parameters(), before):
        assert torch.equal(a, b)
    assert eng.warm_restarts == 0


def test_warm_start_flushes_tiers(models, tmp_path):
    """Demoted K/V was computed under the old weights: a warm start
    flushes every tier."""
    _, tm = models
    eng = InferenceEngine(tm, num_slots=1, page_size=PS, num_pages=7,
                          max_len=64, prefix_cache=True,
                          kv_tiers={"dram_bytes": 128 << 10,
                                    "disk_dir": os.path.join(
                                        str(tmp_path), "t")})
    rng = np.random.RandomState(7)
    heads = [rng.randint(0, V, size=(3 * PS,)) for _ in range(6)]
    for p in (0, 1, 2, 3, 4, 5):
        r = Request(np.concatenate([heads[p], rng.randint(0, V, size=5)]),
                    max_new_tokens=4)
        eng.run([r], poll_sleep=1e-4)
    assert len(eng._tiers) > 0
    flushes0 = eng._tiers.flushes
    eng.warm_start(params=tm.state_dict())
    assert len(eng._tiers) == 0 and eng._tiers.flushes == flushes0 + 1
    assert eng._tiers.tier_bytes() == {"dram": 0, "disk": 0}
    eng.audit_pages()
