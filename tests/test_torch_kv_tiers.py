"""The port's KV cache tiers against the JAX package's.

``gpt_mini`` (f32) is initialized in the JAX package and its weights go
across into the port. Held here:

  - ``KVTierStore`` (``serve/paged_kv.py``) beside the JAX store on the
    same put / load / spill sequence: equal counters, bytes and payloads;
    its byte audit; ``payload_crc`` equal across the packages on f32 and
    int8 payloads (the bytes are the same);
  - ``checkpoint.manifest``: bf16 and float8 arrays written as their bits
    with the dtype's name read back bitwise, in the port and by the JAX
    package's manifest (and the reverse), with no ``ml_dtypes`` in the
    port;
  - the engines on an LRU-hostile workload (one slot, a 7-page pool, six
    3-page personas revisited): equal greedy streams, equal tier
    counters and events, ``promote_trace_count`` / ``demote_trace_count``
    equal to the JAX engine's (1 each), ``audit_pages()`` clean before
    every step, for ``kv_quant`` None and int8; the same streams as an
    always-resident engine and a recomputing one; the cascade drop that
    demotes a family's descendants; a rotted DRAM payload convicted by
    its crc and recomputed; a disk tier whose every write fails; the
    probe half of the router-affinity test; the config refusals.
"""

import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.base import MXNetError as JMXNetError
from incubator_mxnet_tpu.checkpoint import manifest as jmanifest
from incubator_mxnet_tpu.events import EventType as JEventType
from incubator_mxnet_tpu.models import gpt as jg
from incubator_mxnet_tpu.serve import InferenceEngine as JaxEngine
from incubator_mxnet_tpu.serve import Request as JaxRequest
from incubator_mxnet_tpu.serve import paged_kv as jpk

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.checkpoint import manifest
from incubator_mxnet_tpu_torch.models import convert, gpt as tg
from incubator_mxnet_tpu_torch.serve import (EventType, InferenceEngine,
                                             KVTierStore, Request,
                                             payload_crc)

V = 64
PS = 8
# LRU-hostile revisit order over a pool that holds ~one persona: every
# revisit finds its prefix evicted from HBM
ORDER = [0, 1, 2, 0, 1, 2, 3, 4, 5, 0, 1, 2]
COUNTERS = ("tier_demotions", "tier_disk_demotions", "tier_promotions",
            "tier_hits", "tier_hit_tokens", "tier_misses",
            "tier_crc_fallbacks", "tier_disk_errors", "tier_dropped",
            "kv_tier_bytes", "prefix_hits", "prefix_hit_tokens")


@pytest.fixture(scope="module")
def models():
    jmx.random.seed(0)
    jm = jg.gpt_mini(vocab_size=V, max_length=64)
    jm.initialize()
    tm = tg.gpt_mini(vocab_size=V, max_length=64, device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        [p.data().asnumpy() for p in jm.collect_params().values()]))
    return jm, tm


def _personas(n, pages=3, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, size=(pages * PS,)).astype(np.int32)
            for _ in range(n)]


def _tiered(Engine, model, d, dram_bytes=1 << 20, disk=True, **kw):
    tiers = {"dram_bytes": dram_bytes}
    if disk:
        tiers["disk_dir"] = os.path.join(str(d), "tiers")
        tiers["disk_bytes"] = 1 << 30
    return Engine(model, num_slots=1, page_size=PS,
                  num_pages=kw.pop("num_pages", 7), max_len=64,
                  prefix_cache=True, kv_tiers=tiers, **kw)


def _flat(Engine, model, num_pages=7, **kw):
    return Engine(model, num_slots=1, page_size=PS, num_pages=num_pages,
                  max_len=64, prefix_cache=True, **kw)


def _drive(eng, Req, heads, order=ORDER, temperature=0.0, tail_seed=11,
           seed_base=None):
    """One run() per visit (one slot): deterministic admission order, so
    eviction and tier traffic replay identically on every engine;
    ``audit_pages()`` before every step and after every visit."""
    srng = np.random.RandomState(tail_seed)
    toks = []
    for i, p in enumerate(order):
        tail = srng.randint(0, V, size=(5,)).astype(np.int32)
        req = Req(np.concatenate([heads[p], tail]), max_new_tokens=4,
                  temperature=temperature,
                  seed=None if seed_base is None else seed_base + i)
        eng.run([req], poll_sleep=1e-4,
                before_step=lambda e, _i: e.audit_pages())
        assert req.outcome is not None and req.outcome.ok
        eng.audit_pages()
        toks.append(list(req.token_ids))
    return toks


def _summary(eng, toks, etypes):
    snap = eng.health_snapshot()
    return dict(
        tokens=toks, counters={k: snap[k] for k in COUNTERS},
        traces=(eng.promote_trace_count, eng.demote_trace_count,
                eng.decode_trace_count, dict(eng.prefill_trace_counts)),
        events=[len(eng.flight.events(etype=t)) for t in etypes])


def _corrupt_first_dram_entry(eng):
    """Flip one byte of the layer-0 K payload of the first DRAM entry (a
    copy swapped in; the stored crc now convicts it)."""
    key, ent = next((k, e) for k, e in eng._tiers.entries()
                    if e.tier == "dram")
    arr = np.array(ent.k_payload[0])
    arr.view(np.uint8).reshape(-1)[0] ^= 0xFF
    ent.k_payload = (arr,) + tuple(ent.k_payload[1:])


def _enospc(*_a, **_k):
    raise OSError(28, "No space left on device")


def _cascade(eng, Req):
    """A 3-page family, evicted by two churning personas (the cascade
    demotes all three pages), then revisited."""
    rng = np.random.RandomState(21)
    family = rng.randint(0, V, size=(3 * PS,)).astype(np.int32)
    prompt = np.concatenate([family,
                             rng.randint(0, V, size=(5,)).astype(np.int32)])
    eng.run([Req(prompt.copy(), max_new_tokens=4)], poll_sleep=1e-4)
    probes = [eng.prefix_probe(prompt)]
    _drive(eng, Req, _personas(2, seed=23), order=[0, 1, 0, 1])
    probes += [eng.prefix_probe(prompt), eng.tier_probe(prompt)]
    prom0 = eng.tier_promotions
    req = Req(prompt.copy(), max_new_tokens=4)
    eng.run([req], poll_sleep=1e-4)
    eng.audit_pages()
    return dict(tokens=list(req.token_ids), probes=probes,
                promoted=eng.tier_promotions - prom0)


def _scenario(name, Engine, Req, model, d, ev):
    """One scenario on one package's engines; returns what the tests
    compare across the packages."""
    heads = _personas(6)
    if name in ("f32", "int8"):
        kw = {} if name == "f32" else {"kv_quant": "int8"}
        eng = _tiered(Engine, model, d, **kw)
        return _summary(eng, _drive(eng, Req, heads), ev)
    if name == "crc":
        eng = _tiered(Engine, model, d)
        _drive(eng, Req, heads)
        _corrupt_first_dram_entry(eng)
        return _summary(eng, _drive(eng, Req, heads, tail_seed=77), ev)
    if name == "disk_full":
        eng = _tiered(Engine, model, d, dram_bytes=0)
        eng._tiers._write_step = _enospc
        out = _summary(eng, _drive(eng, Req, heads), ev)
        out["stored"] = len(eng._tiers)
        return out
    if name == "cascade":
        return _cascade(_tiered(Engine, model, d), Req)
    if name == "probe":
        cold, warm = _flat(Engine, model), _tiered(Engine, model, d)
        rng = np.random.RandomState(31)
        prompt = np.concatenate([
            rng.randint(0, V, size=(3 * PS,)).astype(np.int32),
            rng.randint(0, V, size=(5,)).astype(np.int32)])
        warm.run([Req(prompt.copy(), max_new_tokens=4)], poll_sleep=1e-4)
        warm._reclaim_prefix(3)
        warm.audit_pages()
        return [warm.prefix_probe(prompt), warm.tier_probe(prompt),
                cold.tier_probe(prompt), warm.tier_demotions]
    raise KeyError(name)


SCENARIOS = ("f32", "int8", "crc", "disk_full", "cascade", "probe")
JEV = (JEventType.CACHE_DEMOTE, JEventType.CACHE_PROMOTE,
       JEventType.CACHE_TIER_MISS)
TEV = (EventType.CACHE_DEMOTE, EventType.CACHE_PROMOTE,
       EventType.CACHE_TIER_MISS)


@pytest.fixture(scope="module")
def jax_runs(models, tmp_path_factory):
    jm, _ = models
    return {n: _scenario(n, JaxEngine, JaxRequest, jm,
                         tmp_path_factory.mktemp(f"jax_{n}"), JEV)
            for n in SCENARIOS}


# --------------------------------------------------------------------- #
# the store, the crc and the manifest against the JAX package's
# --------------------------------------------------------------------- #

def _store_sequence(Store, d):
    """DRAM overflow spills the LRU entry to disk; a reload round-trips;
    a fresh store wipes the stale directory."""
    store = Store(PS, dram_bytes=600, disk_dir=d, disk_bytes=1 << 20)
    rng = np.random.RandomState(3)
    prompt = np.arange(4 * PS, dtype=np.int32)
    pays = []
    for i in range(3):
        pay = (rng.randn(2, PS, 4).astype(np.float32),)
        pays.append(pay)
        assert store.put(prompt[:i * PS].tobytes(),
                         prompt[i * PS:(i + 1) * PS], i, pay, pay)
    assert not store.put(prompt[:0].tobytes(), prompt[:PS], 0, pays[0],
                         pays[0])                     # first writer wins
    tiers = sorted(e.tier for _k, e in store.entries())
    assert "disk" in tiers and "dram" in tiers
    store.audit()
    loaded = []
    for key, ent in list(store.entries()):
        k_pay, v_pay, _ka, _va = store.load(key, ent)
        np.testing.assert_array_equal(k_pay[0], pays[ent.depth][0])
        np.testing.assert_array_equal(v_pay[0], pays[ent.depth][0])
        loaded.append((ent.tier, ent.depth))
    assert len(os.listdir(d)) > 0
    counters = (store.demotions, store.disk_demotions, store.dropped,
                store.crc_failures, store.disk_errors, store.tier_bytes(),
                len(store), loaded)
    store.flush()
    counters += (store.flushes, store.tier_bytes(), len(store))
    fresh = Store(PS, dram_bytes=600, disk_dir=d)
    assert len(fresh) == 0
    assert [f for f in os.listdir(d) if not f.startswith(".")] == []
    return counters


def test_store_disk_spill_and_reload_as_jax(tmp_path):
    got = _store_sequence(KVTierStore, str(tmp_path / "t"))
    want = _store_sequence(jpk.KVTierStore, str(tmp_path / "j"))
    assert got == want
    assert got[1] > 0 and got[5]["disk"] > 0


@pytest.mark.parametrize("Store,Err", [(KVTierStore, MXNetError),
                                       (jpk.KVTierStore, JMXNetError)],
                         ids=["port", "jax"])
def test_store_audit_catches_byte_drift(Store, Err):
    store = Store(PS, dram_bytes=1 << 20)
    prompt = np.arange(2 * PS, dtype=np.int32)
    pay = (np.ones((2, PS, 4), np.float32),)
    assert store.put(prompt[:PS].tobytes(), prompt[PS:2 * PS], 1, pay,
                     pay)
    store.audit()
    for _k, ent in store.entries():
        ent.nbytes += 64                 # corrupt the accounting
    with pytest.raises(Err):
        store.audit()


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_payload_crc_equals_jax(dtype):
    rng = np.random.RandomState(5)
    k = tuple((rng.randn(4, PS, 16) * 40).astype(dtype) for _ in range(2))
    v = tuple((rng.randn(4, PS, 16) * 40).astype(dtype) for _ in range(2))
    amax = (None, None) if dtype == np.float32 else \
        (rng.rand(2).astype(np.float32), rng.rand(2).astype(np.float32))
    for seed in (0, 12345):
        assert payload_crc(k, v, *amax, seed=seed) == \
            jpk.payload_crc(k, v, *amax, seed=seed)


def _entry(arr, dtype):
    return {"shape": tuple(arr.shape), "dtype": dtype, "spec": None,
            "shards": [([[0, s] for s in arr.shape], arr)]}


@pytest.mark.parametrize("tdt,name", [(torch.bfloat16, "bfloat16"),
                                      (torch.float8_e4m3fn,
                                       "float8_e4m3fn")])
def test_manifest_carries_bf16_and_fp8_bits(tmp_path, tdt, name):
    """The port writes a bf16 / float8 tensor's bits under the dtype's
    name and reads them back bitwise; the JAX manifest reads the same
    step as its ml_dtypes array with the same bits, and the port reads
    the JAX package's step of that array bitwise."""
    x = (torch.randn(3, 4, 8, generator=torch.Generator().manual_seed(0))
         * 5).to(tdt)
    bits = x.view(torch.int16 if tdt.itemsize == 2 else torch.uint8) \
        .numpy().view(manifest.bits_dtype(name))
    root = str(tmp_path)
    manifest.write_step(root, 1, {"x": _entry(bits, name)},
                        meta={"what": "bits"})
    got, meta = manifest.load_step(root, 1)
    assert got["x"].dtype == bits.dtype and meta == {"what": "bits"}
    np.testing.assert_array_equal(got["x"], bits)
    assert torch.equal(torch.from_numpy(got["x"]).view(tdt), x)
    jgot, _ = jmanifest.load_step(root, 1)
    assert str(jgot["x"].dtype) == name
    np.testing.assert_array_equal(jgot["x"].view(bits.dtype), bits)
    # the reverse: the JAX package writes its array (its writer takes
    # ml_dtypes bf16 itself, float8 as the bits)
    jarr = jgot["x"] if name == "bfloat16" else jgot["x"].view(np.uint8)
    jmanifest.write_step(root, 2, {"x": _entry(jarr, name)})
    back, _ = manifest.load_step(root, 2)
    np.testing.assert_array_equal(back["x"], bits)
    with pytest.raises(MXNetError, match="cannot hold"):
        manifest.write_step(root, 3, {"x": _entry(bits, "float32")})
    assert manifest.list_steps(root) == [1, 2]


@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float8_e4m3fn])
def test_store_disk_tier_keeps_bit_payloads(tmp_path, tdt):
    """A bf16 / float8 page payload (the bits) spilled to disk under its
    dtype's name reloads bitwise with its crc intact."""
    name = str(tdt).replace("torch.", "")
    store = KVTierStore(PS, dram_bytes=0, disk_dir=str(tmp_path),
                        kv_dtype=name)
    x = (torch.randn(2, 4, PS, 8) * 3).to(tdt)
    bits = x.view(torch.int16 if tdt.itemsize == 2 else torch.uint8) \
        .numpy().view(manifest.bits_dtype(name))
    prompt = np.arange(2 * PS, dtype=np.int32)
    assert store.put(prompt[:PS].tobytes(), prompt[PS:], 1,
                     tuple(bits), tuple(bits[::-1]))
    (key, ent), = store.entries()
    assert ent.tier == "disk" and store.disk_demotions == 1
    _m, meta = manifest.load_step(str(tmp_path), ent.step)
    k, v, _ka, _va = store.load(key, ent)
    np.testing.assert_array_equal(np.stack(k), bits)
    np.testing.assert_array_equal(np.stack(v), bits[::-1])
    assert store.crc_failures == 0 and meta["crc"] == ent.crc


# --------------------------------------------------------------------- #
# the engines
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["f32", "int8"])
def test_promotion_parity(models, jax_runs, tmp_path, name):
    """Tiered serving on the LRU-hostile workload: the port's greedy
    streams, tier counters, tier events and builds equal the JAX
    engine's, and equal an always-resident and a recomputing port
    engine's streams (a promoted page is the page)."""
    _, tm = models
    got = _scenario(name, InferenceEngine, Request, tm, tmp_path, TEV)
    want = jax_runs[name]
    assert got == want
    c = got["counters"]
    assert c["tier_demotions"] > 0 and c["tier_promotions"] > 0
    assert c["tier_hit_tokens"] >= c["tier_promotions"] * PS
    assert c["tier_misses"] > 0 and c["tier_crc_fallbacks"] == 0
    assert got["traces"][:3] == (1, 1, 1)
    assert set(got["traces"][3].values()) == {1}
    kw = {} if name == "f32" else {"kv_quant": "int8"}
    heads = _personas(6)
    resident = _flat(InferenceEngine, tm, num_pages=32, **kw)
    assert _drive(resident, Request, heads) == got["tokens"]
    assert resident.prefix_reclaimed_pages == 0
    recompute = _flat(InferenceEngine, tm, **kw)
    assert _drive(recompute, Request, heads) == got["tokens"]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_promotion_parity_seeded_temperature(models, tmp_path, kv_quant):
    """Seeded temperature streams through the tiers equal the resident
    and the recomputing engines' (held inside the port: the two
    packages draw from different generators)."""
    _, tm = models
    kw = {} if kv_quant is None else {"kv_quant": kv_quant}
    heads = _personas(6)
    tiered = _tiered(InferenceEngine, tm, tmp_path, **kw)
    got = _drive(tiered, Request, heads, temperature=0.8, seed_base=1000)
    assert tiered.tier_promotions > 0
    for eng in (_flat(InferenceEngine, tm, num_pages=32, **kw),
                _flat(InferenceEngine, tm, **kw)):
        assert _drive(eng, Request, heads, temperature=0.8,
                      seed_base=1000) == got


def test_cascade_drop_demotes_descendants(models, jax_runs, tmp_path):
    """Reclaiming a family's root cascades through its published
    descendants: all three pages land in the tiers, and the revisit
    promotes the whole chain, as in the JAX engine."""
    _, tm = models
    got = _cascade(_tiered(InferenceEngine, tm, tmp_path), Request)
    assert got == jax_runs["cascade"]
    assert got["probes"] == [3 * PS, 0, 3 * PS] and got["promoted"] == 3
    fresh = _flat(InferenceEngine, tm, num_pages=32)
    rng = np.random.RandomState(21)
    prompt = np.concatenate([rng.randint(0, V, size=(3 * PS,)),
                             rng.randint(0, V, size=(5,))]).astype(np.int32)
    ref = Request(prompt, max_new_tokens=4)
    fresh.run([ref], poll_sleep=1e-4)
    assert list(ref.token_ids) == got["tokens"]


def test_crc_fallback_no_garbage(models, jax_runs, tmp_path):
    """A rotted DRAM payload is convicted by its crc at promotion,
    counted and evented; the admission recomputes; the streams equal the
    JAX engine's and an untiered engine's."""
    _, tm = models
    got = _scenario("crc", InferenceEngine, Request, tm, tmp_path, TEV)
    assert got == jax_runs["crc"]
    assert got["counters"]["tier_crc_fallbacks"] > 0
    flat = _flat(InferenceEngine, tm)
    heads = _personas(6)
    _drive(flat, Request, heads)
    assert _drive(flat, Request, heads, tail_seed=77) == got["tokens"]


def test_disk_full_degrades_loudly(models, jax_runs, tmp_path):
    """Every spill fails with ENOSPC (dram_bytes 0: every demotion goes
    to disk): errors counted, pages dropped, nothing stored, no
    promotion, streams as the JAX engine's and an untiered engine's."""
    _, tm = models
    got = _scenario("disk_full", InferenceEngine, Request, tm, tmp_path,
                    TEV)
    assert got == jax_runs["disk_full"]
    c = got["counters"]
    assert c["tier_disk_errors"] > 0 and c["tier_dropped"] > 0
    assert got["stored"] == 0 and c["tier_promotions"] == 0
    assert _drive(_flat(InferenceEngine, tm), Request,
                  _personas(6)) == got["tokens"]


def test_tier_events_emitted(models, jax_runs, tmp_path):
    """One CACHE_DEMOTE per DRAM and per disk demotion, one
    CACHE_PROMOTE per promotion, one CACHE_TIER_MISS per miss: as many
    as the JAX engine emits."""
    _, tm = models
    eng = _tiered(InferenceEngine, tm, tmp_path)
    _drive(eng, Request, _personas(6))
    snap = eng.health_snapshot()
    dem, prom, miss = [eng.flight.events(etype=t) for t in TEV]
    assert len(dem) == snap["tier_demotions"] + \
        snap["tier_disk_demotions"]
    assert len(prom) == snap["tier_promotions"]
    assert len(miss) == snap["tier_misses"] > 0
    assert all(e.data["tier"] in ("dram", "disk") for e in dem)
    assert [len(dem), len(prom), len(miss)] == jax_runs["f32"]["events"]


def test_tier_probe(models, jax_runs, tmp_path):
    """The probe half of ``test_tier_probe_and_router_affinity``: a
    prefix evicted from HBM into the tiers is 0 to ``prefix_probe`` and
    all three pages to ``tier_probe``; a cold engine probes 0."""
    _, tm = models
    got = _scenario("probe", InferenceEngine, Request, tm, tmp_path, TEV)
    assert got == jax_runs["probe"] == [0, 3 * PS, 0, 3]


def test_kv_tiers_config_validation(models, tmp_path):
    jm, tm = models
    for Engine, model, Err in ((InferenceEngine, tm, MXNetError),
                               (JaxEngine, jm, JMXNetError)):
        with pytest.raises(Err, match="prefix_cache"):
            Engine(model, num_slots=1, page_size=PS, max_len=64,
                   prefix_cache=False, kv_tiers={"dram_bytes": 1 << 20})
        with pytest.raises(Err, match="unknown kv_tiers keys"):
            Engine(model, num_slots=1, page_size=PS, max_len=64,
                   prefix_cache=True,
                   kv_tiers={"dram_bytes": 1 << 20, "flux_capacitor": 1})
