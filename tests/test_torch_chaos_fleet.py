"""The port's fleet chaos injectors against the JAX package's harness.

The fleet half of ``tests/test_torch_chaos.py`` (its models, packages
and one-thread fixture): each injector runs in both packages under the
same seed on the same 2-replica fleet (``gpt_mini`` f32, router seed 3)
through ``run_fleet_chaos`` (every surviving replica audited after every
step): it must fire, and the outcomes, the affected requests, the
streams of the requests it may not touch, the router's counters and the
builds must equal the JAX run's.

  - ``KillReplica``; ``SlowReplica`` and ``FlappingReplica`` (the breaker
    opens and closes, nothing lost: their probe schedule runs on the wall
    clock, so only streams and outcomes compare); ``MigrateFault`` in
    each mode; ``FleetCancelStorm``;
  - ``NaNWeights`` in a ``build_fleet`` fleet poisons its own replica
    only (each replica has its own weights);
  - ``ScaleDownRace``, ``DrainKill`` and ``SupervisorChaos`` on the port
    alone (their JAX comparisons are the race matrix and the supervisor
    integration runs: ``slow``, as in the JAX suite).
"""

import numpy as np
import pytest

from incubator_mxnet_tpu_torch import serve as tserve
from incubator_mxnet_tpu_torch.serve import InferenceEngine, Request
from incubator_mxnet_tpu_torch.serve import chaos as tchaos

from test_torch_chaos import (FLEET_KW, V, _builds,  # noqa: F401
                              _one_torch_thread, pkgs)


def _workload(ns, n, seed=42):
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
        reqs.append(ns.serve.Request(prompt,
                                     max_new_tokens=8 + 2 * (i % 3)))
    return reqs


def _fleet_summary(rt, reqs, injs, timing=False):
    """``timing``: breaker injectors, whose probe schedule runs on the
    wall clock — the dispatch order, the breaker tallies and the states
    at the end then depend on how fast a step is, so only streams and
    outcomes are compared."""
    idx = {id(r): i for i, r in enumerate(reqs)}
    snap = rt.health_snapshot()
    s = dict(fired=[i.fired for i in injs],
             outcomes=[r.outcome.value for r in reqs],
             affected=[sorted(idx[id(r)] for r in i.affected)
                       for i in injs],
             tokens=[list(r.token_ids) if not any(
                 r is a for i in injs for a in i.affected) else None
                 for r in reqs])
    builds = [_builds(rep.engine) for rep in rt.replicas
              if rep.state.value != "DEAD"]
    # one build per program at most (which replica met which program is
    # a routing matter: compared below when routing is deterministic)
    s["one_build_each"] = all(
        max(_builds(rep.engine)[:2] + (rep.engine.copy_trace_count,)) <= 1
        and set(rep.engine.prefill_trace_counts.values()) <= {1}
        for rep in rt.replicas if rep.state.value != "DEAD")
    if not timing:
        s["builds"] = builds
        s["states"] = [e["state"] for e in snap["replicas"]]
        s["counters"] = {k: snap[k] for k in (
            "outcomes", "requeues", "replica_deaths", "migrations",
            "migrations_failed", "migrated_pages")}
    return s


def _run_fleet(ns, injs, n=6, timing=False, arrival=None, **router_kw):
    router_kw.setdefault("seed", 3)
    # far above any step unless the scenario is the breaker's: on a
    # loaded CPU a plain step can outlast the default 0.75 s
    router_kw.setdefault("heartbeat_timeout_s", 30.0)
    rt = ns.serve.build_fleet(ns.model(), 2, engine_kw=dict(FLEET_KW),
                              **router_kw)
    reqs = _workload(ns, n)
    injs = [f(ns) for f in injs]
    ns.chaos.run_fleet_chaos(rt, reqs, injs, arrival_times=arrival)
    ns.chaos.assert_fleet_health_consistent(rt, reqs)
    return rt, reqs, injs, _fleet_summary(rt, reqs, injs, timing)


def fl_kill(ns):
    return _run_fleet(ns, [lambda n: n.chaos.KillReplica(
        replica=0, at_step=3, phase="decode")])[3]


def fl_slow(ns):
    rt, _, _, s = _run_fleet(
        ns, [lambda n: n.chaos.SlowReplica(replica=0, start=3, end=9,
                                           sleep_s=0.3)],
        n=4, timing=True, arrival=[0.01 * i for i in range(4)],
        heartbeat_timeout_s=0.15, breaker_failures=2,
        probe_backoff_s=0.02, probe_recovery=1)
    s["opened"] = rt.replicas[0].breaker_opens >= 1
    return s


def fl_flapping(ns):
    rt, _, _, s = _run_fleet(
        ns, [lambda n: n.chaos.FlappingReplica(
            replica=0, start=2, period=6, slow_for=3, sleep_s=0.3,
            cycles=2)],
        n=6, timing=True, heartbeat_timeout_s=0.15, breaker_failures=2,
        probe_backoff_s=0.01, probe_recovery=1)
    s["opened"] = rt.replicas[0].breaker_opens >= 1
    s["deaths"] = rt.replica_deaths
    return s


def _migrate(mode, order="before"):
    def sc(ns):
        holder = []

        def make(n):
            holder.append(n.chaos.MigrateFault(at_step=3, mode=mode,
                                               order=order, seed=4))
            return holder[0]

        _, _, _, s = _run_fleet(ns, [make], n=3)
        s["migrate_returned"] = holder[0].migrate_returned
        s["src_dst"] = (holder[0].src, holder[0].dst)
        return s
    return sc


def fl_cancel_storm(ns):
    return _run_fleet(ns, [lambda n: n.chaos.FleetCancelStorm(
        start=1, every=2, n_per=1, max_cancels=3, seed=5)])[3]


FLEET = {
    "kill_replica": fl_kill,
    "slow_replica": fl_slow,
    "flapping_replica": fl_flapping,
    "migrate_none": _migrate("none"),
    "migrate_kill_source": _migrate("kill_source"),
    "migrate_kill_dst": _migrate("kill_dst"),
    "migrate_corrupt": _migrate("corrupt"),
    "migrate_cancel_before": _migrate("cancel_race", "before"),
    "migrate_cancel_after": _migrate("cancel_race", "after"),
    "fleet_cancel_storm": fl_cancel_storm,
}


_JAX = {}


def _jax(pkgs, name):
    if not _JAX:
        for k, fn in FLEET.items():
            _JAX[k] = fn(pkgs["jax"])
    return _JAX[name]


@pytest.mark.parametrize("name", list(FLEET))
def test_injector_equals_jax(pkgs, name):
    want = _jax(pkgs, name)
    got = FLEET[name](pkgs["port"])
    assert got == want
    assert all(got["fired"])


def test_injectors_do_what_they_claim(pkgs):
    """What each scenario must show (in the JAX harness's run, which the
    port's equals)."""
    s = {k: _jax(pkgs, k) for k in FLEET}
    assert s["kill_replica"]["counters"]["replica_deaths"] == 1
    assert s["slow_replica"]["opened"] and s["flapping_replica"]["opened"]
    assert s["flapping_replica"]["deaths"] == 0
    assert s["migrate_none"]["migrate_returned"] is True
    assert s["migrate_none"]["counters"]["migrations"] == 1
    for mode in ("kill_source", "kill_dst", "corrupt"):
        assert s[f"migrate_{mode}"]["migrate_returned"] is False
        assert all(o == "MAX_TOKENS"
                   for o in s[f"migrate_{mode}"]["outcomes"])
    assert s["migrate_cancel_before"]["outcomes"].count("CANCELLED") == 1
    assert s["fleet_cancel_storm"]["outcomes"].count("CANCELLED") == 3


def test_nan_weights_poisons_its_own_replica_only(pkgs):
    """In a ``build_fleet`` fleet each replica has its own weights:
    poisoning replica 0 through ``warm_start`` leaves replica 1 serving
    the clean stream."""
    ns = pkgs["port"]
    rt = tserve.build_fleet(ns.model(), 2, engine_kw=dict(FLEET_KW),
                            seed=3)
    tchaos.NaNWeights(at_step=0, seed=1).on_step(rt.replicas[0].engine, 0)
    probe = lambda: Request(np.arange(3, 12) % V, max_new_tokens=6)
    a, b, ref = probe(), probe(), probe()
    rt.replicas[0].engine.run([a])
    rt.replicas[1].engine.run([b])
    InferenceEngine(ns.model(), **FLEET_KW).run([ref])
    assert a.outcome.value == "FAILED_NONFINITE"
    assert b.outcome.ok and b.token_ids == ref.token_ids


# --------------------------------------------------------------------- #
# membership races and the supervisor (port; JAX comparison slow)
# --------------------------------------------------------------------- #

def _race(ns, make, n_rep=3, n=10, **router_kw):
    router_kw.setdefault("seed", 3)
    router_kw.setdefault("heartbeat_timeout_s", 30.0)
    model = ns.model()
    rt = ns.serve.build_fleet(model, n_rep, engine_kw=dict(FLEET_KW),
                              **router_kw)
    spawn = lambda: ns.serve.InferenceEngine(  # noqa: E731
        ns.clone(model), **FLEET_KW)
    injs = make(ns, rt, spawn)
    reqs = _workload(ns, n)
    ns.chaos.run_fleet_chaos(rt, reqs, injs)
    ns.chaos.assert_fleet_health_consistent(rt, reqs)
    for _ in range(6):
        rt.step()
    for rep in rt.replicas:
        if rep.state.value != "DEAD" and rep.killed is None:
            rep.engine.audit_pages()
    s = _fleet_summary(rt, reqs, injs)
    return s


def rc_scale_down_race(ns):
    return _race(ns, lambda n, rt, spawn: [n.chaos.ScaleDownRace(
        victim=2, spawn=spawn, at_step=2)])


def rc_drain_kill(ns):
    return _race(ns, lambda n, rt, spawn: [n.chaos.DrainKill(
        victim=2, at_step=2, kill_after=1)], max_requeues=3)


def _same_params(rt):
    eng = rt.replicas[0].engine
    if hasattr(eng, "_eng_params"):
        return {str(i): p.data().asnumpy()
                for i, p in enumerate(eng._eng_params)}
    return {k: v.clone() for k, v in eng.model.state_dict().items()}


def rc_supervisor(ns):
    def make(n, rt, spawn):
        sup = n.serve.FleetSupervisor(rt, spawn=spawn, min_replicas=1,
                                      max_replicas=3, up_steps=10 ** 6,
                                      down_steps=10 ** 6)
        return [n.chaos.SupervisorChaos(
            sup, upgrade_at=2, kill_at=4,
            upgrade_src={"params": _same_params(rt)})]
    return _race(ns, make, n_rep=2)


RACES = {"scale_down_race": rc_scale_down_race,
         "drain_kill": rc_drain_kill, "supervisor_kill": rc_supervisor}


@pytest.mark.parametrize("name", list(RACES))
def test_race_injectors_fire_and_lose_nothing(pkgs, name):
    ns = pkgs["port"]
    s = RACES[name](ns)
    base = _run_fleet(ns, [], n=10)[3]["tokens"]
    assert all(s["fired"])
    assert all(o is not None for o in s["outcomes"])
    for got, want, o in zip(s["tokens"], base, s["outcomes"]):
        if o in ("MAX_TOKENS", "EOS"):
            assert got == want
    assert "DRAINING" not in s["states"]
    assert s["one_build_each"]


@pytest.mark.slow
@pytest.mark.parametrize("name", list(RACES))
def test_race_injectors_equal_jax(pkgs, name):
    assert RACES[name](pkgs["port"]) == RACES[name](pkgs["jax"])
