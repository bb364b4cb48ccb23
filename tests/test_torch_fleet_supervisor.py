"""The port's FleetSupervisor against the JAX package's.

Host-only policy units: both supervisors tick over the same fake router
(just the snapshot and membership surface) through the same pressure /
idle / death / degraded sequences and must make the same membership
calls at the same ticks: scale-up after ``up_steps`` pressured ticks
(one WARMING spawn at a time, never past ``max_replicas``), scale-down
of the newest SERVING replica after ``down_steps`` idle ticks (never
below ``min_replicas``), one replacement per death, and a rolling
upgrade one replica at a time that halts while the fleet is degraded.
``manager=`` (the checkpoint manager, not ported) is refused.

Live, on the port's engines (``gpt_mini`` f32 on the CPU, weights from
the JAX model): a supervisor grows the fleet under a burst and rolls a
same-weights upgrade over it with no request lost, the streams equal an
un-upgraded control fleet's; a supervisor killed mid-roll leaves no
replica DRAINING (the router finalises the swap). The same live runs on
the JAX fleet are ``slow``, as in the JAX suite.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.models import gpt as jg
from incubator_mxnet_tpu.serve import FleetSupervisor as JaxSupervisor
from incubator_mxnet_tpu.serve import ReplicaState as JaxState
from incubator_mxnet_tpu.serve import Request as JaxRequest
from incubator_mxnet_tpu.serve import build_fleet as jax_build_fleet

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.serve import (FleetSupervisor,
                                             InferenceEngine, ReplicaState,
                                             Request, build_fleet)
from incubator_mxnet_tpu_torch.serve.chaos import (
    SupervisorChaos, assert_fleet_health_consistent, run_fleet_chaos)

from test_torch_parity import port_gpt

V = 64
ENG_KW = dict(num_slots=2, page_size=8, max_len=64, chunk_pages=1,
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


# --------------------------------------------------------------------- #
# the fake router (the JAX elastic tests' policy harness)
# --------------------------------------------------------------------- #

class _FakeRep:
    def __init__(self, idx, state):
        self.idx = idx
        self.state = state
        self.role = "mixed"


class _FakeRouter:
    """Just enough Router surface for the supervisor's policy loop, in
    either package's ``ReplicaState``."""

    def __init__(self, states, n=2):
        self.S = states
        self.replicas = [_FakeRep(i, states.SERVING) for i in range(n)]
        self.replica_deaths = 0
        self.log = []
        self.flight = False
        self.calls = []
        self.queue_depth = 0
        self.busy = False
        self.brownout = 0

    def add_replica(self, engine, role="mixed"):
        idx = len(self.replicas)
        self.replicas.append(_FakeRep(idx, self.S.WARMING))
        self.calls.append(("add", idx))
        return idx

    def remove_replica(self, idx):
        self.replicas[idx].state = self.S.DRAINING
        self.calls.append(("remove", idx))
        return {"migrated": 0, "requeued": 0, "remaining": 0}

    def upgrade_replica(self, idx, params=None, manager=None, step=None):
        self.replicas[idx].state = self.S.DRAINING
        self.calls.append(("upgrade", idx))
        return {"migrated": 0, "requeued": 0, "remaining": 0}

    def set(self, idx, state):
        self.replicas[idx].state = getattr(self.S, state)

    def health_snapshot(self):
        live = [r for r in self.replicas
                if r.state not in (self.S.DEAD, self.S.RETIRED)]
        return {
            "queue_depth": self.queue_depth, "inflight": int(self.busy),
            "fleet_size": len(live),
            "replicas": [
                {"idx": r.idx, "state": r.state.value,
                 "engine": {"brownout_level": self.brownout,
                            "free_slots": 0 if self.busy else 2,
                            "queue_depth": 0,
                            "active_slots": 2 if self.busy else 0}}
                for r in live]}


def _sup(Sup, rt, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("up_steps", 3)
    kw.setdefault("down_steps", 5)
    return Sup(rt, spawn=lambda: object(), recorder=False, **kw)


def _script(Sup, States, script, n=2, **kw):
    """Run one policy script — a list of per-tick edits of the fake
    router, each then ticked — and return every tick's decision record,
    the calls, and the snapshot."""
    rt = _FakeRouter(States, n)
    sup = _sup(Sup, rt, **kw)
    records = []
    for edit in script:
        edit(rt, sup)
        rec = sup.tick()
        records.append((rec, list(rt.calls)))
    return records, sup.snapshot()


def _pressure(rt, _sup):
    rt.queue_depth, rt.busy = 3, True


def _calm(rt, _sup):
    rt.queue_depth, rt.busy = 0, False


def _noop(rt, _sup):
    pass


def _graduate(idx):
    def edit(rt, _sup):
        if idx < len(rt.replicas):
            rt.set(idx, "SERVING")
    return edit


def _retire(idx):
    def edit(rt, _sup):
        rt.set(idx, "RETIRED")
    return edit


def _chain(*edits):
    def edit(rt, sup):
        for e in edits:
            e(rt, sup)
    return edit


def _die(idx):
    def edit(rt, _sup):
        rt.set(idx, "DEAD")
        rt.replica_deaths += 1
    return edit


def _roll(rt, sup):
    sup.start_upgrade(params={"0": np.zeros((1,), np.float32)})


SCRIPTS = {
    "scale_up_dwell": ([_pressure] * 4 + [_chain(_graduate(2), _calm)] +
                       [_pressure] * 2, {}),
    "scale_up_max": ([_pressure] * 10, dict(max_replicas=2)),
    "scale_down_to_min": ([_noop] * 5 + [_retire(2)] + [_noop] * 9 +
                          [_retire(1)] + [_noop] * 10, dict(down_steps=5)),
    "deaths_replaced": ([_die(0), _chain(_die(1), _graduate(2)), _noop],
                        dict(max_replicas=2)),
    "roll_halts_when_degraded": (
        [_roll, _noop, _chain(_graduate(0), lambda rt, s: rt.set(
            1, "DEGRADED")), _graduate(1), _graduate(1), _graduate(2),
         _noop], {}),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_policy_equals_jax(name):
    script, kw = SCRIPTS[name]
    n = 3 if name in ("scale_down_to_min", "roll_halts_when_degraded") \
        else 2
    got = _script(FleetSupervisor, ReplicaState, script, n=n, **kw)
    want = _script(JaxSupervisor, JaxState, script, n=n, **kw)
    assert got == want


def test_policy_scripts_show_what_they_claim():
    calls = lambda name, n=2: _script(  # noqa: E731
        FleetSupervisor, ReplicaState, SCRIPTS[name][0], n=n,
        **SCRIPTS[name][1])[0][-1][1]
    assert calls("scale_up_dwell") == [("add", 2)]
    assert calls("scale_up_max") == []
    assert calls("scale_down_to_min", 3) == [("remove", 2), ("remove", 1)]
    assert calls("deaths_replaced") == [("add", 2), ("add", 3)]
    records, snap = _script(FleetSupervisor, ReplicaState,
                            *SCRIPTS["roll_halts_when_degraded"][:1], n=3)
    assert [c for c in records[-1][1] if c[0] == "upgrade"] == \
        [("upgrade", 0), ("upgrade", 1), ("upgrade", 2)]
    assert records[2][0]["roll"]["halted"]
    assert snap["roll"] is None and snap["upgrades_completed"] == 1


def test_refusals():
    rt = _FakeRouter(ReplicaState, 3)
    with pytest.raises(MXNetError, match="min_replicas"):
        _sup(FleetSupervisor, rt, min_replicas=0)
    with pytest.raises(MXNetError, match="max_replicas"):
        _sup(FleetSupervisor, rt, min_replicas=3, max_replicas=2)
    with pytest.raises(MXNetError, match="not ported"):
        _sup(FleetSupervisor, rt, manager=object())
    sup = _sup(FleetSupervisor, rt)
    with pytest.raises(MXNetError, match="not ported"):
        sup.start_upgrade(manager=object())
    with pytest.raises(MXNetError, match="params= or manager="):
        sup.start_upgrade()
    sup.start_upgrade(params={})
    with pytest.raises(MXNetError, match="one roll"):
        sup.start_upgrade(params={})


# --------------------------------------------------------------------- #
# live fleets
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def models():
    jmx.random.seed(0)
    jm = jg.gpt_mini(vocab_size=V, max_length=64)
    jm.initialize()
    tm = port_gpt(jm, vocab_size=V, max_length=64)
    return jm, tm


def _workload(Req, n, seed=42):
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
        reqs.append(Req(prompt, max_new_tokens=8 + 2 * (i % 3)))
    return reqs


def _grow_and_roll(build, Sup, Req, model, engine, same_params):
    """A burst grows the fleet; a same-weights roll under fresh load loses
    nothing. Returns the roll-time streams and the tallies."""
    rt = build(model, 2, engine_kw=dict(ENG_KW), seed=3,
               heartbeat_timeout_s=30.0)
    sup = Sup(rt, spawn=lambda: engine(model), min_replicas=1,
              max_replicas=3, up_steps=2, down_steps=10 ** 6)
    reqs = _workload(Req, 16)
    for r in reqs:
        rt.submit(r)
    guard = 0
    while any(r.outcome is None for r in reqs):
        rt.step()
        sup.tick()
        guard += 1
        assert guard < 5000
    assert all(r.outcome.ok for r in reqs)
    sup.start_upgrade(params=same_params(rt))
    reqs2 = _workload(Req, 10, seed=5)
    for r in reqs2:
        rt.submit(r)
    guard = 0
    while any(r.outcome is None for r in reqs2) or \
            sup.snapshot()["roll"] is not None:
        rt.step()
        sup.tick()
        guard += 1
        assert guard < 8000
    assert all(r.outcome is not None and r.outcome.ok for r in reqs2)
    for rep in rt.replicas:
        if rep.state.value not in ("DEAD", "RETIRED"):
            rep.engine.audit_pages()
    return ([list(r.token_ids) for r in reqs + reqs2],
            (sup.scale_ups, rt.scale_ups, sup.upgrades_completed,
             rt.upgrades))


def _port_same_params(rt):
    live = next(r for r in rt.replicas
                if r.state not in (ReplicaState.DEAD, ReplicaState.RETIRED))
    return {k: v.clone() for k, v in live.engine.model.state_dict().items()}


def _jax_same_params(rt):
    live = next(r for r in rt.replicas
                if r.state not in (JaxState.DEAD, JaxState.RETIRED))
    return {str(i): p.data().asnumpy()
            for i, p in enumerate(live.engine._eng_params)}


def _port_engine(model):
    return InferenceEngine(model, **ENG_KW)


def test_grows_under_load_and_roll_is_lossless(models):
    _, tm = models
    toks, (ups, rt_ups, done, upgrades) = _grow_and_roll(
        build_fleet, FleetSupervisor, Request, tm, _port_engine,
        _port_same_params)
    assert ups >= 1 and rt_ups == ups and done == 1
    assert upgrades >= 2                 # every live replica swapped
    control = build_fleet(tm, 2, engine_kw=dict(ENG_KW), seed=3,
                          heartbeat_timeout_s=30.0)
    creqs = _workload(Request, 10, seed=5)
    control.run(creqs)
    assert toks[16:] == [list(r.token_ids) for r in creqs]


def test_supervisor_killed_mid_upgrade_cannot_wedge(models):
    _, tm = models
    base = build_fleet(tm, 2, engine_kw=dict(ENG_KW), seed=3,
                       heartbeat_timeout_s=30.0)
    breqs = _workload(Request, 10)
    base.run(breqs)
    rt = build_fleet(tm, 2, engine_kw=dict(ENG_KW), seed=3,
                     heartbeat_timeout_s=30.0)
    sup = FleetSupervisor(rt, spawn=lambda: _port_engine(tm),
                          min_replicas=1, max_replicas=3,
                          up_steps=10 ** 6, down_steps=10 ** 6)
    inj = SupervisorChaos(sup, upgrade_at=2, kill_at=4,
                          upgrade_src={"params": _port_same_params(rt)})
    reqs = _workload(Request, 10)
    run_fleet_chaos(rt, reqs, [inj])
    assert inj.upgrade_started and inj.killed_at_step == 4
    assert [r.token_ids for r in reqs] == [r.token_ids for r in breqs]
    assert_fleet_health_consistent(rt, reqs)
    for _ in range(6):
        rt.step()
    assert not any(r.state is ReplicaState.DRAINING for r in rt.replicas)
    assert rt.upgrades >= 1


def test_scale_down_after_burst_reaches_the_floor(models):
    _, tm = models
    rt = build_fleet(tm, 1, engine_kw=dict(ENG_KW), seed=3,
                     heartbeat_timeout_s=30.0)
    sup = FleetSupervisor(rt, spawn=lambda: _port_engine(tm),
                          min_replicas=1, max_replicas=3, up_steps=2,
                          down_steps=8)
    reqs = _workload(Request, 12)
    rt.run(reqs, after_step=lambda r, _i: sup.tick())
    assert all(r.outcome.ok for r in reqs)
    assert sup.scale_ups >= 1
    for _ in range(400):
        if len(rt._alive()) == 1:
            break
        rt.step()
        sup.tick()
    assert len(rt._alive()) == 1 and sup.scale_downs >= 1
    assert rt.replicas[0].state is ReplicaState.SERVING


@pytest.mark.slow
def test_grow_and_roll_equals_jax(models):
    """The live supervisor run on both packages: equal streams and
    tallies."""
    jm, tm = models
    want = _grow_and_roll(jax_build_fleet, JaxSupervisor, JaxRequest, jm,
                          lambda m: __import__(
                              "incubator_mxnet_tpu.serve",
                              fromlist=["InferenceEngine"]).InferenceEngine(
                                  m, **ENG_KW), _jax_same_params)
    got = _grow_and_roll(build_fleet, FleetSupervisor, Request, tm,
                         _port_engine, _port_same_params)
    assert got == want
