"""The port's fleet router against the JAX package's.

``gpt_mini`` (f32, V = 64, ``max_len`` 64) is initialized in the JAX
package and its weights go across into the port; both packages build
the same fleets (2 replicas, ``ENG_KW``, router seed 3) and run the same
scenarios, whose greedy streams, outcomes, replica assignments (the
router's DISPATCH events), per-request re-queue counts and
``health_snapshot`` counters must be equal:

  - fault-free; ``KillReplica`` mid-decode; ``max_requeues`` exhausted
    (FAILED_REPLICA with the partial stream kept); ``remove_replica``
    with its decode-ready slots moved by page capsule; fleet-aware
    preemption (a LATENCY admission on a full replica hands its BATCH
    victim to the sibling through ``preempt_handoff``); a stop sequence
    whose match spans a re-queue (the router trims ``_stop_trim``
    tokens an earlier attempt emitted); the rolling upgrade of one
    replica to seed-1 weights, after which replica 0 serves seed-1
    streams and replica 1 still seed 0's (the port's ``build_fleet``
    gives each replica its own weights: ``warm_start`` writes in place);
  - seeded temperature streams held inside the port (JAX draws
    threefry): a killed fleet's survivors equal its fault-free run;
  - host-only units: the breaker loop (SERVING -> DEGRADED -> half-open
    probes -> SERVING) under a fake engine, state for state and backoff
    for backoff the JAX router's; routing (affinity, spill, round-robin,
    servability, the pass's capacity allowance); the refusals.

The rest of the JAX kill matrix (prefill / verify kills, other
occupancies) is ``slow``, as in the JAX suite.
"""

import time
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
from incubator_mxnet_tpu_torch.serve import (InferenceEngine, Outcome,
                                             ReplicaState, Request, Router,
                                             build_fleet)
from incubator_mxnet_tpu_torch.serve import chaos as tchaos
from incubator_mxnet_tpu_torch.serve.router import _Tracked

from test_torch_parity import port_gpt

V = 64
ENG_KW = dict(num_slots=2, page_size=8, max_len=64, chunk_pages=1,
              prefix_cache=True)
COUNTERS = ("outcomes", "requeues", "replica_deaths", "breaker_opens",
            "affinity_routed", "tier_affinity_routed", "spill_routed",
            "migrations", "migrations_failed", "migrated_pages",
            "fleet_size", "scale_ups", "scale_downs", "upgrades")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU runs here are tiny (gpt_mini): on one intra-op
    thread they do not contend with the other test processes for the
    cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(seed):
    jmx.random.seed(seed)
    jm = jg.gpt_mini(vocab_size=V, max_length=64)
    jm.initialize()
    return jm


def _arrays(jm):
    return [p.data().asnumpy() for p in jm.collect_params().values()]


def _port_model(jm):
    return port_gpt(jm, vocab_size=V, max_length=64)


@pytest.fixture(scope="module")
def pkgs():
    """Each package's names, its seed-0 model and the seed-1 weights (the
    JAX package's positional ``"<i>"`` tree, which both ``warm_start``s
    take)."""
    jm, jm1 = _jax_model(0), _jax_model(1)
    params1 = {str(i): a for i, a in enumerate(_arrays(jm1))}
    # the upgrade's own seed-0 model: a JAX ``warm_start`` writes the new
    # arrays into the model's Parameters, which later fleets would read
    jax = types.SimpleNamespace(
        model=jm, model1=jm1, model_up=_jax_model(0), serve=jserve,
        chaos=jchaos, params1=params1)
    port = types.SimpleNamespace(
        model=_port_model(jm), model1=_port_model(jm1),
        model_up=_port_model(jm), serve=tserve, chaos=tchaos,
        params1=params1)
    return {"jax": jax, "port": port}


def _fleet(ns, n=2, model=None, **router_kw):
    """``build_fleet`` in ``ns``'s package. The heartbeat is set far above
    any step (the breaker is held by its own tests): on a loaded CPU a
    plain step can outlast the default 0.75 s, and a breaker opened by
    load alone would change the routing."""
    router_kw.setdefault("seed", 3)
    router_kw.setdefault("heartbeat_timeout_s", 30.0)
    kw = dict(ENG_KW, **router_kw.pop("engine_kw", {}))
    return ns.serve.build_fleet(model or ns.model, n, engine_kw=kw,
                                **router_kw)


def _workload(ns, n, seed=42, **req_kw):
    """Greedy: persona-shared and unique ragged prompts (the JAX router
    tests' ``mixed`` workload)."""
    rng = np.random.RandomState(seed)
    persona = rng.randint(0, V, size=(14,)).astype(np.int32)
    reqs = []
    for i in range(n):
        if i % 2 == 0:
            prompt = np.concatenate(
                [persona, rng.randint(0, V, size=(3 + i % 4,))
                 .astype(np.int32)])
        else:
            prompt = rng.randint(0, V, size=(5 + 3 * (i % 3),)) \
                .astype(np.int32)
        reqs.append(ns.serve.Request(prompt, max_new_tokens=8 + 2 * (i % 3),
                                     **req_kw))
    return reqs


def _templated(ns, n, seed=42):
    """Repetitive prompts the n-gram drafter predicts, so a speculative
    fleet runs verify steps."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        unit = rng.randint(0, V, size=(4 + i % 3,)).astype(np.int32)
        reqs.append(ns.serve.Request(np.tile(unit, 1 + 17 // unit.size)[:18],
                                     max_new_tokens=8 + 2 * (i % 3)))
    return reqs


def _summary(rt, reqs):
    """What must be equal across the packages: streams, outcomes, the
    replica each (re)dispatch chose, re-queues per request, the router's
    counters and the replicas' states."""
    idx = {r.request_id: i for i, r in enumerate(reqs)}
    evs = rt.flight.events("router")
    snap = rt.health_snapshot()
    return dict(
        tokens=[list(r.token_ids) for r in reqs],
        outcomes=[r.outcome.value if r.outcome else None for r in reqs],
        dispatch=[(idx.get(e.request_id), e.data["replica"]) for e in evs
                  if e.etype.value == "DISPATCH"],
        requeues=[sum(1 for e in evs if e.etype.value == "REQUEUE" and
                      e.request_id == r.request_id) for r in reqs],
        counters={k: snap[k] for k in COUNTERS},
        states=[e["state"] for e in snap["replicas"]])


def _drive(rt, reqs, guard=3000, before=None, extra=0):
    """Step the fleet until every request is terminal (then ``extra``
    more passes), auditing every live replica after each."""
    i = 0
    while any(r.outcome is None for r in reqs) or extra > 0:
        if all(r.outcome is not None for r in reqs):
            extra -= 1
        if before is not None:
            before(rt, i)
        rt.step()
        for rep in rt.replicas:
            if rep.state.value != "DEAD" and rep.killed is None:
                rep.engine.audit_pages()
        i += 1
        assert i < guard, "fleet wedged"


def _audit_survivors(rt):
    for rep in rt.replicas:
        if rep.state.value != "DEAD" and rep.killed is None:
            rep.engine.audit_pages()


# --------------------------------------------------------------------- #
# scenarios: the same code drives either package
# --------------------------------------------------------------------- #

def sc_fault_free(ns):
    rt = _fleet(ns)
    reqs = _workload(ns, 6)
    ns.chaos.run_fleet_chaos(rt, reqs, [])
    return rt, reqs


def _kill(ns, phase, n, **router_kw):
    spec = phase == "verify"
    rt = _fleet(ns, engine_kw=dict(spec_k=2 if spec else 0), **router_kw)
    reqs = (_templated if spec else _workload)(ns, n)
    inj = ns.chaos.KillReplica(replica=0, at_step=1 if phase == "prefill"
                               else 3, phase=phase)
    ns.chaos.run_fleet_chaos(rt, reqs, [inj])
    assert inj.fired and rt.replica_deaths == 1
    for client, pre in inj.inflight_at_kill:
        assert list(client.token_ids[:len(pre)]) == pre
    return rt, reqs


def sc_kill_decode(ns):
    return _kill(ns, "decode", 6)


def sc_requeue_exhausted(ns):
    return _kill(ns, "decode", 2, max_requeues=0)


def sc_remove_migrates(ns):
    """``remove_replica(0)`` once replica 0 (two of the three requests)
    holds a decode-ready slot that has emitted: slots move by capsule to
    replica 1's free slot as it has one, the drain finishes the rest."""
    rt = _fleet(ns)
    reqs = _workload(ns, 3)
    for r in reqs:
        rt.submit(r)

    def before(router, _i):
        rep = router.replicas[0]
        if rep.state.value != "SERVING":
            return
        for t in router._inflight:
            if t.replica == 0 and t.attempt.token_ids and \
                    rep.engine.decode_ready(t.attempt.request_id):
                router.remove_replica(0)
                return

    _drive(rt, reqs, before=before, extra=4)
    assert rt.replicas[0].state.value == "RETIRED"
    return rt, reqs


def sc_preempt_handoff(ns):
    """Replica 0 holds the persona's pages and two BATCH requests on its
    two slots; a LATENCY request with the same prefix lands there by
    affinity and the engine preempts a BATCH slot — offered first to the
    router, which moves it to replica 1 by capsule."""
    S = ns.serve
    rt = _fleet(ns, fleet_preempt=True)
    rng = np.random.RandomState(51)
    persona = rng.randint(0, V, size=(17,)).astype(np.int32)
    warm = S.Request(persona.copy(), max_new_tokens=4)
    rt.replicas[0].engine.run([warm])
    tail = lambda n: rng.randint(0, V, size=(n,)).astype(np.int32)
    batch = [S.Request(np.concatenate([persona, tail(3 + i)]),
                       max_new_tokens=12, tier=S.Tier.BATCH)
             for i in range(2)]
    for r in batch:
        assert rt.submit(r)
    for _ in range(4):
        rt.step()
    lat = S.Request(np.concatenate([persona, tail(2)]), max_new_tokens=6,
                    tier=S.Tier.LATENCY)
    assert rt.submit(lat)
    reqs = batch + [lat]
    _drive(rt, reqs)
    return rt, reqs


def sc_stop_trim(ns, stop, at_tokens):
    """Request 1 of the workload carries ``stop``; its replica is killed
    once it has streamed ``at_tokens`` tokens, so the match's first token
    came from the killed attempt and its last from the replay."""
    S = ns.serve
    rt = _fleet(ns)
    reqs = _workload(ns, 2)
    r = reqs[1]
    reqs[1] = S.Request(r.prompt_ids, max_new_tokens=r.max_new_tokens,
                        sampling=S.SamplingParams(stop_sequences=[stop]))
    fired = []

    def before(router, _i):
        if fired:
            return
        for t in router._inflight:
            if t.client is reqs[1] and \
                    len(router.live_tokens(reqs[1])) >= at_tokens:
                router.replicas[t.replica].kill("stop-trim kill")
                fired.append(t.replica)
                return

    for q in reqs:
        rt.submit(q)
    _drive(rt, reqs, before=before)
    assert fired and rt.replica_deaths == 1
    return rt, reqs


def sc_upgrade(ns):
    """Replica 0 rolls to the seed-1 weights while replica 1 serves; then
    the same prompt on each replica."""
    rt = _fleet(ns, model=ns.model_up)
    reqs = _workload(ns, 4)
    for r in reqs:
        rt.submit(r)
    rt.step()
    rt.upgrade_replica(0, params=ns.params1)
    _drive(rt, reqs, extra=6)
    assert [rep.state.value for rep in rt.replicas] == ["SERVING"] * 2
    probes = [ns.serve.Request(np.arange(3, 14, dtype=np.int32) % V,
                               max_new_tokens=10) for _ in range(2)]
    for rep, p in zip(rt.replicas, probes):
        rep.engine.run([p])
    _audit_survivors(rt)
    return rt, reqs + probes


def _stop_case(pkgs):
    """A bigram of request 1's fault-free greedy stream at its first
    change of token, and the stream length at which to kill: the bigram's
    first token is then the killed attempt's last."""
    toks = _jax_summaries(pkgs)["fault_free"]["tokens"][1]
    k = next(i for i in range(1, len(toks)) if toks[i] != toks[i - 1])
    stop = toks[k - 1:k + 1]
    assert all(toks[i:i + 2] != stop for i in range(k - 1))
    return stop, k


SCENARIOS = {
    "fault_free": sc_fault_free,
    "kill_decode": sc_kill_decode,
    "requeue_exhausted": sc_requeue_exhausted,
    "remove_migrates": sc_remove_migrates,
    "preempt_handoff": sc_preempt_handoff,
    "upgrade": sc_upgrade,
}
_JAX = {}


def _jax_summaries(pkgs):
    """The JAX fleets' summaries, each scenario run once per module."""
    if not _JAX:
        ns = pkgs["jax"]
        for name, fn in SCENARIOS.items():
            _JAX[name] = _summary(*fn(ns))
        stop, k = _stop_case(pkgs)
        _JAX["stop_trim"] = _summary(*sc_stop_trim(ns, stop, k))
    return _JAX


@pytest.mark.parametrize("name", list(SCENARIOS) + ["stop_trim"])
def test_fleet_equals_jax(pkgs, name):
    want = _jax_summaries(pkgs)[name]
    ns = pkgs["port"]
    if name == "stop_trim":
        rt, reqs = sc_stop_trim(ns, *_stop_case(pkgs))
    else:
        rt, reqs = SCENARIOS[name](ns)
    got = _summary(rt, reqs)
    for key in want:
        assert got[key] == want[key], key
    submitted = {e.request_id for e in rt.flight.events("router")
                 if e.etype.value == "SUBMIT"}
    tchaos.assert_fleet_health_consistent(
        rt, [r for r in reqs if r.request_id in submitted])
    _audit_survivors(rt)
    for rep in rt.replicas:              # one capture per program met
        e = rep.engine
        assert e.decode_trace_count <= 1 and e.verify_trace_count <= 1
        assert set(e.prefill_trace_counts.values()) <= {1}


def test_scenarios_show_what_they_claim(pkgs):
    """Each scenario exercised its mechanism (in the JAX run, which the
    port's equals)."""
    s = _jax_summaries(pkgs)
    assert all(o in ("MAX_TOKENS", "EOS") for o in s["fault_free"]["outcomes"])
    assert s["kill_decode"]["counters"]["requeues"] >= 1
    assert all(o == "MAX_TOKENS" for o in s["kill_decode"]["outcomes"])
    assert s["kill_decode"]["tokens"] == s["fault_free"]["tokens"]
    assert "FAILED_REPLICA" in s["requeue_exhausted"]["outcomes"]
    assert s["remove_migrates"]["counters"]["migrations"] >= 1
    assert s["remove_migrates"]["counters"]["migrations_failed"] == 0
    assert s["preempt_handoff"]["counters"]["migrations"] == 1
    assert sorted({r for _, r in s["preempt_handoff"]["dispatch"]}) == [0]
    assert s["stop_trim"]["outcomes"][1] == "STOP"
    stop, k = _stop_case(pkgs)
    assert s["stop_trim"]["tokens"][1] == \
        s["fault_free"]["tokens"][1][:k - 1]
    assert s["upgrade"]["counters"]["upgrades"] == 1


def test_upgrade_swaps_one_replica_only(pkgs):
    """After the roll replica 0 serves the seed-1 stream and replica 1
    still the seed-0 one, each a fresh engine's on those weights."""
    ns = pkgs["port"]
    rt, reqs = sc_upgrade(ns)
    got = [list(r.token_ids) for r in reqs[-2:]]
    fresh = []
    for m in (ns.model1, ns.model):
        p = Request(np.arange(3, 14, dtype=np.int32) % V, max_new_tokens=10)
        InferenceEngine(m, **ENG_KW).run([p])
        fresh.append(list(p.token_ids))
    assert got == fresh and fresh[0] != fresh[1]
    for a, b in zip(rt.replicas[0].engine.model.parameters(),
                    rt.replicas[1].engine.model.parameters()):
        assert a.data_ptr() != b.data_ptr()


def test_upgrade_refuses_shared_weights(pkgs):
    """Two engines over one model: warm_start on one would swap the
    other's weights too — refused, loudly, nothing drained."""
    ns = pkgs["port"]
    rt = Router([InferenceEngine(ns.model, **ENG_KW),
                 InferenceEngine(ns.model, **ENG_KW)], seed=3)
    with pytest.raises(MXNetError, match="share storage"):
        rt.upgrade_replica(0, params=ns.params1)
    assert rt.replicas[0].state is ReplicaState.SERVING
    with pytest.raises(MXNetError, match="not ported"):
        _fleet(ns).upgrade_replica(0, manager=object())


def test_build_fleet_copies_weights_and_keeps_the_model_unbound(pkgs):
    ns = pkgs["port"]
    rt = _fleet(ns, n=3)
    ptrs = [{p.data_ptr() for p in rep.engine.model.parameters()}
            for rep in rt.replicas]
    ptrs.append({p.data_ptr() for p in ns.model.parameters()})
    for i in range(len(ptrs)):
        for j in range(i):
            assert not ptrs[i] & ptrs[j]
    for rep in rt.replicas:
        for a, b in zip(rep.engine.model.parameters(),
                        ns.model.parameters()):
            assert a.device == b.device and bool((a == b).all())


def test_temperature_survivors_equal_the_fault_free_run(pkgs):
    """Seeded and router-pinned temperature streams, held inside the
    port: a fleet that loses replica 0 mid-decode replays its requests
    on replica 1 to the same tokens as the fault-free fleet."""
    ns = pkgs["port"]

    def run(kill):
        rt = _fleet(ns)
        reqs = _workload(ns, 6, temperature=0.9)
        for i, r in enumerate(reqs):
            if i % 2:
                r.seed = 100 + i         # the rest pinned by the router
        injs = [tchaos.KillReplica(replica=0, at_step=3, phase="decode")] \
            if kill else []
        tchaos.run_fleet_chaos(rt, reqs, injs)
        tchaos.assert_fleet_health_consistent(rt, reqs)
        assert all(r.outcome.ok for r in reqs)
        return rt, [list(r.token_ids) for r in reqs]

    _, base = run(False)
    rt, got = run(True)
    assert rt.replica_deaths == 1 and rt.requeues >= 1
    assert got == base


@pytest.mark.slow
@pytest.mark.parametrize("phase,n", [
    ("decode", 1), ("decode", 2), ("prefill", 1), ("prefill", 2),
    ("prefill", 6), ("verify", 1), ("verify", 2), ("verify", 6)])
def test_kill_matrix_equals_jax(pkgs, phase, n):
    """The rest of the JAX kill matrix: prefill / verify kills and the
    other occupancies."""
    want = _summary(*_kill(pkgs["jax"], phase, n))
    rt, reqs = _kill(pkgs["port"], phase, n)
    got = _summary(rt, reqs)
    assert got == want
    assert all(o == "MAX_TOKENS" for o in got["outcomes"])
    _audit_survivors(rt)


# --------------------------------------------------------------------- #
# host-only: the breaker loop under a fake engine, against the JAX router
# --------------------------------------------------------------------- #

class _FakeEngine:
    """The surface the router's step and breaker read: capture counts and
    an idle ``step``."""

    def __init__(self):
        self._component = "engine"
        self.decode_trace_count = self.verify_trace_count = 0
        self.prefill_trace_count = self.copy_trace_count = 0
        self.steps = 0

    def step(self):
        self.steps += 1
        return 0

    def health_snapshot(self):
        return {"free_slots": 2, "num_slots": 2, "queue_depth": 0,
                "active_slots": 0, "ewma_service_s": None,
                "estimated_queue_delay_s": None, "brownout_level": 0}


def _breaker_trace(RouterCls):
    rt = RouterCls([_FakeEngine(), _FakeEngine()], seed=3,
                   heartbeat_timeout_s=0.05, breaker_failures=2,
                   probe_backoff_s=0.05, probe_backoff_max_s=0.4,
                   probe_recovery=2, recorder=False)
    rep = rt.replicas[0]
    trace = []

    def step():
        rt.step()
        trace.append((rep.state.value, rep.backoff_s, rep.probes,
                      rep.consecutive_misses))

    rep.delay_s = 0.15                   # slower than the heartbeat
    step()
    step()                               # breaker opens
    for _ in range(2):                   # failed probes: backoff doubles
        time.sleep(max(0.0, rep.next_probe_t - time.perf_counter()) + 1e-3)
        step()
    rep.delay_s = 0.0
    for _ in range(2):                   # healthy probes close it
        time.sleep(max(0.0, rep.next_probe_t - time.perf_counter()) + 1e-3)
        step()
    rep.engine.decode_trace_count += 1   # a capture step: exempt
    rep.delay_s = 0.15
    step()
    return trace, (rt.breaker_opens, rt.recoveries, rt.probes,
                   rt.replicas[1].engine.steps)


def test_breaker_loop_equals_jax():
    trace, tally = _breaker_trace(Router)
    assert (trace, tally) == _breaker_trace(jserve.Router)
    assert [s for s, *_ in trace] == ["SERVING", "DEGRADED", "DEGRADED",
                                      "DEGRADED", "DEGRADED", "SERVING",
                                      "SERVING"]
    assert trace[3][1] == pytest.approx(4 * trace[1][1])
    assert tally[:2] == (1, 1)


def test_compile_steps_are_neither_misses_nor_warmup():
    eng = _FakeEngine()
    rt = Router([_FakeEngine()], seed=3, heartbeat_timeout_s=0.1,
                breaker_failures=1, warmup_steps=1, recorder=False)
    idx = rt.add_replica(eng)
    rep = rt.replicas[idx]
    rep.delay_s = 0.2
    eng.decode_trace_count += 1          # the capture happens in this step

    def capture_step():
        eng.decode_trace_count += 1
        return 0

    eng.step = capture_step
    rt.step()
    assert rep.state is ReplicaState.WARMING and rep.consecutive_misses == 0
    eng.step = lambda: 0
    rep.delay_s = 0.0
    rt.step()
    assert rep.state is ReplicaState.SERVING


# --------------------------------------------------------------------- #
# routing units (the port's engines, no step run unless stated)
# --------------------------------------------------------------------- #

def test_affinity_routes_to_warm_replica(pkgs):
    rt = _fleet(pkgs["port"])
    rng = np.random.RandomState(11)
    persona = rng.randint(0, V, size=(17,)).astype(np.int32)
    rt.replicas[1].engine.run([Request(persona.copy(), max_new_tokens=4)])
    assert rt.replicas[1].engine.prefix_probe(persona) > 0
    tail = rng.randint(0, V, size=(6,)).astype(np.int32)
    assert rt.submit(Request(np.concatenate([persona, tail]),
                             max_new_tokens=4))
    rt._dispatch()
    assert [t.replica for t in rt._inflight] == [1]
    assert rt.affinity_routed == 1 and rt.spill_routed == 0


def test_spill_balances_and_round_robin(pkgs):
    ns = pkgs["port"]
    for affinity, want in ((True, [0, 1, 0, 1]), (False, [0, 1, 0, 1])):
        rt = _fleet(ns, affinity=affinity)
        rng = np.random.RandomState(13)
        for _ in range(4):
            assert rt.submit(Request(rng.randint(0, V, size=(6,)),
                                     max_new_tokens=4))
        rt._dispatch()
        got = [t.replica for t in rt._inflight]
        assert sorted(got) == sorted(want)
        if not affinity:
            assert got == want
        assert rt.spill_routed == 4 and rt.affinity_routed == 0


def test_dispatch_pass_respects_capacity_allowance(pkgs):
    rt = _fleet(pkgs["port"], replica_queue_depth=1)
    rng = np.random.RandomState(41)
    persona = rng.randint(0, V, size=(17,)).astype(np.int32)
    rt.replicas[0].engine.run([Request(persona.copy(), max_new_tokens=4)])
    for _ in range(8):
        assert rt.submit(Request(np.concatenate(
            [persona, rng.randint(0, V, size=(4,)).astype(np.int32)]),
            max_new_tokens=4))
    rt._dispatch()
    assert sum(1 for t in rt._inflight if t.replica == 0) <= 3
    assert len(rt._inflight) == 6 and len(rt._queue) == 2


def test_heterogeneous_fleet_routes_by_servability(pkgs):
    m = pkgs["port"].model
    rt = Router([InferenceEngine(m, num_slots=2, page_size=8, max_len=32),
                 InferenceEngine(m, num_slots=2, page_size=8, max_len=64)],
                seed=3)
    assert rt.submit(Request(np.arange(20), max_new_tokens=20))
    rt._dispatch()
    assert [t.replica for t in rt._inflight] == [1]


def test_degraded_replica_gets_no_new_admissions(pkgs):
    rt = _fleet(pkgs["port"], heartbeat_timeout_s=0.005,
                breaker_failures=1)
    rt.replicas[0].delay_s = 0.02
    rt.step()
    assert rt.replicas[0].state is ReplicaState.DEGRADED
    rng = np.random.RandomState(31)
    for _ in range(3):
        assert rt.submit(Request(rng.randint(0, V, size=(6,)),
                                 max_new_tokens=4))
    rt._dispatch()
    assert {t.replica for t in rt._inflight} == {1}


def test_torn_death_after_final_token_completes(pkgs):
    ns = pkgs["port"]
    rt = _fleet(ns)
    full = Request(np.arange(5), max_new_tokens=3)
    full.token_ids = [7, 8, 9]
    assert rt._make_attempt(_Tracked(client=full)) is None
    assert full.outcome is Outcome.MAX_TOKENS
    eos = Request(np.arange(5), max_new_tokens=8, eos_id=2)
    eos.token_ids, eos.token_times, eos.token_stamps = [7, 2], [.1, .1], \
        [1., 2.]
    assert rt._make_attempt(_Tracked(client=eos)) is None
    assert eos.outcome is Outcome.EOS and eos.token_ids == [7, 2]
    rt0 = _fleet(ns, max_requeues=0)
    done = Request(np.arange(5), max_new_tokens=2)
    done.token_ids = [4, 5]
    rt0._requeue(_Tracked(client=done), "replica died")
    assert done.outcome is Outcome.MAX_TOKENS


def test_hints_round_trip_through_router(pkgs):
    ns = pkgs["port"]
    rng = np.random.RandomState(23)
    rt = _fleet(ns, max_queue=0)
    r1 = Request(rng.randint(0, V, size=(6,)), max_new_tokens=4)
    assert not rt.submit(r1)
    assert r1.outcome is Outcome.SHED and r1.retry_after_s > 0
    rt2 = _fleet(ns)
    for rep in rt2.replicas:
        rep.kill("unit kill")
    rt2.step()
    assert all(rep.state is ReplicaState.DEAD for rep in rt2.replicas)
    r2 = Request(rng.randint(0, V, size=(6,)), max_new_tokens=4)
    assert not rt2.submit(r2)
    assert r2.outcome is Outcome.FAILED_REPLICA and r2.retry_after_s > 0
    # the deadline passes in the ROUTER queue: the request waits past it
    # before the next dispatch pass
    rt3 = _fleet(ns, replica_queue_depth=0)
    reqs = _workload(ns, 4, seed=29)
    for r in reqs:
        assert rt3.submit(r)
    rt3.step()
    late = Request(rng.randint(0, V, size=(6,)), max_new_tokens=4,
                   deadline_s=0.01)
    assert rt3.submit(late)
    time.sleep(0.02)
    _drive(rt3, reqs + [late])
    assert late.outcome is Outcome.DEADLINE_EXPIRED
    assert late.retry_after_s > 0
    tchaos.assert_fleet_health_consistent(rt3, reqs + [late])


def test_router_withdraws_engine_queue_starved_attempt(pkgs):
    rt = build_fleet(pkgs["port"].model, 1, engine_kw=dict(ENG_KW),
                     stall_steps=10, seed=3)
    eng = rt.replicas[0].engine
    held = eng._alloc.hold(eng._alloc.free_count)
    req = Request(np.arange(6), max_new_tokens=4)
    rt.run([req], poll_sleep=1e-4)
    assert req.outcome is Outcome.FAILED_UNSERVABLE
    assert "starved" in req.detail
    eng._alloc.release_held(held)
    eng.audit_pages()


def test_snapshot_detached_and_refusals(pkgs):
    rt = _fleet(pkgs["port"])
    snap = rt.health_snapshot()
    assert [e["state"] for e in snap["replicas"]] == ["SERVING"] * 2
    snap["outcomes"]["SHED"] = 999
    assert rt.health["SHED"] == 0
    req = Request(np.arange(5), max_new_tokens=2)
    rt._record_terminal(req, Outcome.SHED, "once")
    with pytest.raises(MXNetError, match="double-finish"):
        rt._record_terminal(req, Outcome.SHED, "twice")
    big = Request(np.zeros((40,), np.int32), max_new_tokens=60)
    assert not rt.submit(big)
    assert big.outcome is Outcome.FAILED_UNSERVABLE
    with pytest.raises(MXNetError, match="at least one replica"):
        Router([])
    _fleet(pkgs["port"], seed=1_700_000_000)


def test_tier_probe_routes_to_the_replica_holding_the_prefix_in_tiers(
        pkgs, tmp_path):
    """The router half of the tier-probe test: a replica that holds a
    prefix only in its cache tiers (evicted from HBM) still wins the
    placement over a cold replica, counted as ``tier_affinity_routed``."""
    m = pkgs["port"].model
    kw = dict(num_slots=1, page_size=8, num_pages=7, max_len=64,
              prefix_cache=True)
    cold = InferenceEngine(m, **kw)
    warm = InferenceEngine(m, kv_tiers={"dram_bytes": 1 << 20,
                                        "disk_dir": str(tmp_path / "t")},
                           **kw)
    rng = np.random.RandomState(31)
    persona = rng.randint(0, V, size=(24,)).astype(np.int32)
    prompt = np.concatenate([persona, rng.randint(0, V, size=(5,))
                             .astype(np.int32)])
    warm.run([Request(prompt.copy(), max_new_tokens=4)], poll_sleep=1e-4)
    warm._reclaim_prefix(3)
    assert warm.prefix_probe(prompt) == 0
    assert warm.tier_probe(prompt) == 24 and cold.tier_probe(prompt) == 0
    rt = Router([cold, warm], seed=3)
    assert rt.submit(Request(prompt.copy(), max_new_tokens=4))
    rt._dispatch()
    assert [t.replica for t in rt._inflight] == [1]
    assert rt.tier_affinity_routed == 1 and rt.affinity_routed == 0
    assert rt.health_snapshot()["tier_affinity_routed"] == 1


def test_a_raising_preempt_handoff_is_a_failed_handoff(pkgs):
    """The engine offers its preemption victim to the fleet first; a
    handoff that raises counts as a failed one, and the engine-internal
    preemption proceeds (victim re-queued, PREEMPT without ``handoff``)."""
    from incubator_mxnet_tpu_torch.serve import EventType, Tier
    eng = InferenceEngine(pkgs["port"].model, num_slots=1, page_size=8,
                          max_len=64)
    calls = []

    def handoff(rid):
        calls.append(rid)
        raise RuntimeError("sibling unreachable")

    eng.preempt_handoff = handoff
    low = Request(np.arange(1, 7), max_new_tokens=12, tier=Tier.BATCH)
    assert eng.submit(low)
    for _ in range(3):
        eng.step()
    assert low.token_ids and low.outcome is None
    high = Request(np.arange(9, 14), max_new_tokens=4, tier=Tier.LATENCY)
    eng.run([high])
    assert calls == [low.request_id]
    assert low.preemptions == 1 and eng.preemptions == 1
    ev = [e for e in eng.flight.events(etype=EventType.PREEMPT)]
    assert len(ev) == 1 and "handoff" not in ev[0].data
    while low.outcome is None:
        eng.step()
    assert low.outcome is Outcome.MAX_TOKENS and high.outcome.ok
    eng.audit_pages()
