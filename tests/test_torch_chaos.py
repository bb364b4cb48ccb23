"""The port's engine chaos injectors against the JAX package's harness.

``gpt_mini`` (f32, V = 64) is initialized in the JAX package and its
weights go across into the port. Every injector runs in both packages
under the same seed, on the same workload, through ``run_chaos`` /
``run_fleet_chaos`` (``audit_pages()`` after every step): it must fire,
and the outcomes, the affected requests, the greedy streams of the
requests it may not touch and the builds (``decode_trace_count``,
``verify_trace_count``, ``prefill_trace_count``, ``copy_trace_count``:
no injection may build a program again) must equal the JAX run's.

  - one engine: ``NaNWeights`` (through ``warm_start``: every live slot
    quarantined), ``CorruptPageWrite`` nan (exactly its slot quarantined)
    and zero (finite garbage, everyone else bitwise), ``CorruptPageScale``
    on int8 pools (a shared page's scale torn: its readers quarantined,
    the prefix index flushed), ``CorruptDemotedPage`` (crc convicts,
    recompute), ``DiskFullDemotion`` (a torn disk write degrades to
    eviction), ``CancelStorm``, ``PagePressure`` and ``DelayedSteps``;
  - the fleet injectors are in ``tests/test_torch_chaos_fleet.py``,
    which shares this file's packages and fixtures.

And, the port's own hazard: ``CorruptPageWrite`` writes the very pool
tensors the engine's programs read (same ``data_ptr``), in place — a
rebound pool would leave the captured graphs reading clean pages.
"""

import copy
import os
import types

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import serve as jserve
from incubator_mxnet_tpu.models import gpt as jg
from incubator_mxnet_tpu.serve import chaos as jchaos

from incubator_mxnet_tpu_torch import serve as tserve
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.serve import InferenceEngine, Request
from incubator_mxnet_tpu_torch.serve import chaos as tchaos

from test_torch_parity import port_gpt

V = 64
ENG = dict(num_slots=2, page_size=8, max_len=64)
FLEET_KW = dict(num_slots=2, page_size=8, max_len=64, chunk_pages=1,
                prefix_cache=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU runs here are tiny (gpt_mini): on one intra-op
    thread they do not contend with the other test processes for the
    cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(seed=0):
    jmx.random.seed(seed)
    jm = jg.gpt_mini(vocab_size=V, max_length=64)
    jm.initialize()
    return jm


@pytest.fixture(scope="module")
def pkgs(tmp_path_factory):
    jm = _jax_model(0)
    tm = port_gpt(jm, vocab_size=V, max_length=64)
    root = tmp_path_factory.mktemp("chaos")
    # the JAX package's warm_start writes into its model's Parameters:
    # the poisoning scenario takes a model of its own
    jax = types.SimpleNamespace(serve=jserve, chaos=jchaos,
                                model=lambda: jm, fresh=_jax_model,
                                clone=lambda m: m, dir=str(root / "jax"))
    port = types.SimpleNamespace(serve=tserve, chaos=tchaos,
                                 model=lambda: copy.deepcopy(tm),
                                 fresh=lambda: copy.deepcopy(tm),
                                 clone=copy.deepcopy,
                                 dir=str(root / "port"))
    return {"jax": jax, "port": port}


def _prompts(seed, n=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, size=(4 + 3 * i,)).astype(np.int32)
            for i in range(n)]


def _reqs(ns, prompts, **kw):
    return [ns.serve.Request(p.copy(), max_new_tokens=6 + 2 * i, **kw)
            for i, p in enumerate(prompts)]


def _persona_reqs(ns, n=5, seed=23):
    rng = np.random.RandomState(seed)
    persona = rng.randint(0, V, size=(17,)).astype(np.int32)
    return [ns.serve.Request(np.concatenate(
        [persona, rng.randint(0, V, size=(3 + i,)).astype(np.int32)]),
        max_new_tokens=8 + i) for i in range(n)]


def _builds(eng):
    return (eng.decode_trace_count, eng.verify_trace_count,
            eng.prefill_trace_count, eng.copy_trace_count)


def _engine_summary(eng, reqs, inj):
    idx = {id(r): i for i, r in enumerate(reqs)}
    return dict(
        fired=inj.fired,
        outcomes=[r.outcome.value for r in reqs],
        affected=sorted(idx[id(r)] for r in inj.affected),
        tokens=[list(r.token_ids) if not any(r is a for a in inj.affected)
                else None for r in reqs],
        n_tokens=[len(r.token_ids) for r in reqs],
        builds=_builds(eng), health=dict(eng.health))


# --------------------------------------------------------------------- #
# one engine
# --------------------------------------------------------------------- #

def _run_engine(ns, make_inj, reqs, model=None, **eng_kw):
    kw = dict(ENG, **eng_kw)
    eng = ns.serve.InferenceEngine(model or ns.model(), **kw)
    inj = make_inj(ns)
    ns.chaos.run_chaos(eng, reqs, [inj])
    ns.chaos.assert_health_consistent(eng, reqs)
    eng.audit_pages()
    return eng, inj


def en_nan_weights(ns):
    reqs = _reqs(ns, _prompts(20))
    eng, inj = _run_engine(ns, lambda n: n.chaos.NaNWeights(at_step=3,
                                                            seed=1),
                           reqs, model=ns.fresh(), prefix_cache=False)
    return _engine_summary(eng, reqs, inj)


def _corrupt(mode):
    def sc(ns):
        reqs = _reqs(ns, _prompts(20))
        eng, inj = _run_engine(
            ns, lambda n: n.chaos.CorruptPageWrite(at_step=3, mode=mode,
                                                   seed=1),
            reqs, prefix_cache=False)
        return _engine_summary(eng, reqs, inj)
    return sc


def en_scale_int8(ns):
    reqs = _persona_reqs(ns)
    eng, inj = _run_engine(
        ns, lambda n: n.chaos.CorruptPageScale(at_step=3, mode="nan",
                                               seed=2),
        reqs, kv_quant="int8", prefix_cache=True, chunk_pages=1)
    s = _engine_summary(eng, reqs, inj)
    s["prefix_flushes"] = eng.prefix_flushes
    return s


def _tier_reqs(ns):
    rng = np.random.RandomState(7)
    heads = [rng.randint(0, V, size=(24,)).astype(np.int32)
             for _ in range(4)]
    srng = np.random.RandomState(11)
    return [ns.serve.Request(np.concatenate(
        [heads[p], srng.randint(0, V, size=(5,)).astype(np.int32)]),
        max_new_tokens=4) for p in (0, 1, 2, 0, 1, 3, 2, 0)]


def _tiered(ns, make_inj, name, dram_bytes):
    reqs = _tier_reqs(ns)
    d = os.path.join(ns.dir, name)
    eng, inj = _run_engine(
        ns, make_inj, reqs, num_slots=1, num_pages=7, prefix_cache=True,
        kv_tiers={"dram_bytes": dram_bytes, "disk_dir": d,
                  "disk_bytes": 1 << 30})
    s = _engine_summary(eng, reqs, inj)
    snap = eng.health_snapshot()
    s["tiers"] = {k: snap[k] for k in (
        "tier_demotions", "tier_disk_demotions", "tier_promotions",
        "tier_crc_fallbacks", "tier_disk_errors", "tier_dropped")}
    return s


def en_disk_full(ns):
    return _tiered(ns, lambda n: n.chaos.DiskFullDemotion(at_step=1,
                                                          mode="torn"),
                   "disk_full", dram_bytes=600)


def en_demoted_page(ns):
    return _tiered(ns, lambda n: n.chaos.CorruptDemotedPage(
        at_step=0, tier="dram", seed=3), "demoted", dram_bytes=1 << 20)


def en_cancel_storm(ns):
    reqs = _reqs(ns, _prompts(21, 6))
    eng, inj = _run_engine(ns, lambda n: n.chaos.CancelStorm(
        start=1, every=2, n_per=1, max_cancels=3, seed=5), reqs,
        chunk_pages=1)
    return _engine_summary(eng, reqs, inj)


def en_page_pressure(ns):
    reqs = _reqs(ns, _prompts(21))
    eng, inj = _run_engine(ns, lambda n: n.chaos.PagePressure(
        hold_at=2, release_after=12), reqs, prefix_cache=False,
        watchdog_steps=200)
    assert eng._alloc.held == ()
    return _engine_summary(eng, reqs, inj)


def en_delayed_steps(ns):
    """Host stalls past the deadlines: every request ends
    DEADLINE_EXPIRED, its tokens a prefix of its unstalled stream (how
    many tokens it got before the deadline is a matter of wall time)."""
    eng = ns.serve.InferenceEngine(ns.model(), **ENG)
    rng = np.random.RandomState(22)
    eng.run([ns.serve.Request(rng.randint(0, V, size=(5,)),
                              max_new_tokens=2)])      # builds first
    prompts = [rng.randint(0, V, size=(5,)) for _ in range(3)]
    reqs = [ns.serve.Request(p, max_new_tokens=30, deadline_s=0.5)
            for p in prompts]
    inj = ns.chaos.DelayedSteps(start=2, end=10 ** 9, sleep_s=0.2)
    ns.chaos.run_chaos(eng, reqs, [inj])
    eng.audit_pages()
    full = [ns.serve.Request(p, max_new_tokens=30) for p in prompts]
    eng.run(full)
    return dict(fired=inj.fired, outcomes=[r.outcome.value for r in reqs],
                builds=_builds(eng),
                prefixes=[f.token_ids[:len(r.token_ids)] == r.token_ids
                          for r, f in zip(reqs, full)])


ENGINE = {
    "nan_weights": en_nan_weights,
    "corrupt_nan": _corrupt("nan"),
    "corrupt_zero": _corrupt("zero"),
    "scale_int8": en_scale_int8,
    "disk_full": en_disk_full,
    "demoted_page": en_demoted_page,
    "cancel_storm": en_cancel_storm,
    "page_pressure": en_page_pressure,
    "delayed_steps": en_delayed_steps,
}


_JAX = {}


def _jax(pkgs, name):
    if not _JAX:
        for k, fn in ENGINE.items():
            _JAX[k] = fn(pkgs["jax"])
    return _JAX[name]


@pytest.mark.parametrize("name", list(ENGINE))
def test_injector_equals_jax(pkgs, name):
    want = _jax(pkgs, name)
    got = ENGINE[name](pkgs["port"])
    assert got == want
    assert got["fired"]


def test_injectors_do_what_they_claim(pkgs):
    """What each scenario must show (in the JAX harness's run, which the
    port's equals)."""
    s = {k: _jax(pkgs, k) for k in ENGINE}
    assert all(o == "FAILED_NONFINITE" for o in s["nan_weights"]["outcomes"]
               [:len(s["nan_weights"]["affected"])])
    assert s["nan_weights"]["affected"]
    for mode in ("corrupt_nan", "scale_int8"):
        hit = s[mode]["affected"]
        assert hit and all(s[mode]["outcomes"][i] == "FAILED_NONFINITE"
                           for i in hit)
    assert len(s["corrupt_nan"]["affected"]) == 1
    assert s["scale_int8"]["prefix_flushes"] >= 1
    assert all(o in ("MAX_TOKENS", "EOS")
               for o in s["corrupt_zero"]["outcomes"])
    assert s["disk_full"]["tiers"]["tier_disk_errors"] > 0
    assert s["demoted_page"]["tiers"]["tier_crc_fallbacks"] > 0
    assert s["cancel_storm"]["outcomes"].count("CANCELLED") == 3
    assert all(o == "MAX_TOKENS" for o in s["page_pressure"]["outcomes"])
    assert set(s["delayed_steps"]["outcomes"]) == {"DEADLINE_EXPIRED"}
    assert all(s["delayed_steps"]["prefixes"])


def test_corrupt_page_write_edits_the_pools_the_programs_read(pkgs):
    ns = pkgs["port"]
    eng = InferenceEngine(ns.model(), prefix_cache=False, **ENG)
    reqs = _reqs(ns, _prompts(20))
    ptrs = [p.data_ptr() for p in eng._kpools + eng._vpools]
    pools = list(eng._kpools + eng._vpools)
    inj = tchaos.CorruptPageWrite(at_step=3, mode="nan", seed=1)
    seen = []

    def before(e, i):
        inj.on_step(e, i)
        if inj.fired and not seen:
            seen.append([bool(p[inj.page].isnan().all())
                         for p in e._kpools + e._vpools])

    eng.run(reqs, before_step=before)
    assert seen and all(seen[0])
    assert [p.data_ptr() for p in eng._kpools + eng._vpools] == ptrs
    assert all(a is b for a, b in zip(eng._kpools + eng._vpools, pools))
    hit = inj.affected[0]
    assert hit.outcome.value == "FAILED_NONFINITE"
    assert eng.decode_trace_count == 1


def test_refusals(pkgs):
    ns = pkgs["port"]
    with pytest.raises(MXNetError, match="nan\\|zero"):
        tchaos.CorruptPageWrite(at_step=0, mode="bad")
    eng = InferenceEngine(ns.model(), **ENG)
    with pytest.raises(MXNetError, match="quantized"):
        tchaos.CorruptPageScale(at_step=0).on_step(eng, 0)
    with pytest.raises(MXNetError, match="tiered"):
        tchaos.CorruptDemotedPage(at_step=0).on_step(eng, 0)
    with pytest.raises(MXNetError, match="disk_dir"):
        tchaos.DiskFullDemotion(at_step=0).on_step(eng, 0)
    q = InferenceEngine(ns.model(), kv_quant="int8", **ENG)
    q.submit(Request(np.arange(9), max_new_tokens=4))
    with pytest.raises(MXNetError, match="CorruptPageScale"):
        tchaos.CorruptPageWrite(at_step=0, mode="nan").on_step(q, 0)
    with pytest.raises(MXNetError, match="slow_for"):
        tchaos.FlappingReplica(0, 0, period=2, slow_for=2, sleep_s=0.1)
    with pytest.raises(MXNetError, match="kill phase"):
        tchaos.KillReplica(0, 0, phase="nope")
    with pytest.raises(MXNetError, match="migrate-fault mode"):
        tchaos.MigrateFault(0, mode="nope")
