"""FleetSupervisor: the control loop over elastic Router membership.

The port of ``incubator_mxnet_tpu/serve/fleet_supervisor.py``, the same
policy over the port's ``Router``. ``manager=`` (a
``checkpoint.CheckpointManager``) re-warms a replacement from the latest
committed step, and ``start_upgrade(manager=)`` rolls a checkpoint out;
both reach the engines through ``warm_start(manager=)``.

The Router (serve/router.py) owns the MECHANISM of elasticity —
``add_replica`` (WARMING admission), ``remove_replica`` /
``upgrade_replica`` (DRAINING exits, finalised by the router's own
step loop) — and this module owns the POLICY: when to grow, when to
shrink, when a dead replica gets a replacement, and how a rolling
weight upgrade walks the fleet. It is the serve-side sibling of the
training Supervisor (train/supervisor.py): where that one watches a
subprocess's progress file and restarts it on a backoff budget, this
one watches ``Router.health_snapshot`` and turns sustained signals
into membership operations.

Policy, all driven from ``tick()`` (call once per fleet step — e.g.
as a ``run(after_step=...)`` hook):

  - **Scale up** after ``up_steps`` CONSECUTIVE pressured ticks
    (any live replica browned out to ``scale_up_level``, or router
    backlog with zero free slots fleet-wide), while the live fleet is
    below ``max_replicas`` and nothing is still WARMING (one cold
    engine compiling at a time — a thundering herd of spawns is how
    autoscalers oscillate).
  - **Scale down** after ``down_steps`` consecutive fully-idle ticks
    (no queue, no in-flight, every live slot empty), while the fleet
    is above ``min_replicas`` and no transition is in progress. The
    newest SERVING replica retires (LIFO: the oldest replicas hold
    the warmest prefix indexes). ``down_steps`` should be much larger
    than ``up_steps`` — the hysteresis asymmetry (grow eagerly,
    shrink reluctantly) is the same dwell discipline as the brownout
    controller's (serve/slo.py).
  - **Dead-replica replacement**: every death the router records gets
    ONE replacement via ``spawn()``, re-warmed from the latest
    checkpoint when a ``CheckpointManager`` was given (``warm_start
    (manager=...)``), admitted through the same WARMING gate.
    Replacement respects ``max_replicas`` against the live count.
  - **Rolling upgrade** (``start_upgrade``): one replica at a time —
    drain, warm_start, re-warm (the per-replica prefix flush inside
    warm_start is thereby staggered across the fleet) — advancing
    only when the previous target is SERVING again, and HALTED (not
    aborted) while the fleet is degraded: any DEGRADED breaker or
    un-replaced death pauses the roll until health returns. The
    supervisor dying mid-roll strands at most the not-yet-started
    targets: the in-flight replica's swap is finalised by the
    ROUTER'S step loop, never by this object.

Everything here is host-side bookkeeping over snapshot dicts — no
engine internals are touched, no locks are taken, and every decision
lands on the flight recorder (SCALE_UP/SCALE_DOWN rode the router's
emit; the roll's phase events carry ``component="supervisor"``).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..base import MXNetError
from .events import EventType, resolve_recorder
from .router import ReplicaState, Router

__all__ = ["FleetSupervisor"]

_LIVE = (ReplicaState.SERVING, ReplicaState.WARMING,
         ReplicaState.DEGRADED, ReplicaState.DRAINING)


class FleetSupervisor:
    """Autoscaling + rolling-upgrade policy over one ``Router``.

    ``spawn`` is a zero-argument callable returning a FRESH cold
    ``InferenceEngine`` bound to the serving weights — the supervisor
    never builds engines itself (the caller knows the engine_kw /
    model wiring; the supervisor knows when one is needed)."""

    def __init__(self, router: Router, spawn: Callable[[], object], *,
                 min_replicas: int = 1, max_replicas: int = 4,
                 scale_up_level: int = 1, up_steps: int = 3,
                 down_steps: int = 50, manager=None, recorder=None):
        if min_replicas < 1:
            raise MXNetError("min_replicas must be >= 1 — a fleet of "
                             "zero serves nobody")
        if max_replicas < min_replicas:
            raise MXNetError(f"max_replicas ({max_replicas}) < "
                             f"min_replicas ({min_replicas})")
        self.router = router
        self.spawn = spawn
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_level = int(scale_up_level)
        self.up_steps = int(up_steps)
        self.down_steps = int(down_steps)
        self.manager = manager           # CheckpointManager or None
        self.flight = resolve_recorder(
            recorder if recorder is not None else router.flight)
        self._component = "supervisor"
        self.ticks = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.replacements = 0
        self.upgrades_started = 0
        self.upgrades_completed = 0
        self._pressure_ticks = 0
        self._idle_ticks = 0
        self._deaths_seen = router.replica_deaths
        self._roll: Optional[dict] = None

    # ------------------------------------------------------------- #
    # signal extraction (snapshot-only reads)
    # ------------------------------------------------------------- #

    def _live_replicas(self) -> List:
        return [r for r in self.router.replicas if r.state in _LIVE]

    def _in_transition(self) -> bool:
        return any(r.state in (ReplicaState.WARMING,
                               ReplicaState.DRAINING)
                   for r in self.router.replicas)

    @staticmethod
    def _engine_entries(snap: dict) -> List[dict]:
        return [e["engine"] for e in snap["replicas"]
                if e["state"] in ("SERVING", "WARMING", "DEGRADED")
                and "engine" in e]

    def _pressured(self, snap: dict) -> bool:
        engines = self._engine_entries(snap)
        if any(e.get("brownout_level", 0) >= self.scale_up_level
               for e in engines):
            return True
        free = sum(e.get("free_slots", 0) for e in engines)
        backlog = snap["queue_depth"] + \
            sum(e.get("queue_depth", 0) for e in engines)
        return backlog > 0 and free == 0

    def _idle(self, snap: dict) -> bool:
        if snap["queue_depth"] or snap["inflight"]:
            return False
        engines = self._engine_entries(snap)
        return all(e.get("active_slots", 0) == 0 and
                   e.get("queue_depth", 0) == 0 for e in engines)

    def _degraded(self, snap: dict) -> bool:
        """Fleet-health gate for the rolling upgrade: any open
        breaker, or a death the replacement machinery has not yet
        re-covered, pauses the roll — upgrading INTO an incident
        turns a brownout into an outage."""
        states = [e["state"] for e in snap["replicas"]]
        if "DEGRADED" in states:
            return True
        return snap["fleet_size"] < self.min_replicas

    # ------------------------------------------------------------- #
    # membership actions
    # ------------------------------------------------------------- #

    def _spawn_replica(self, why: str, rewarm: bool) -> Optional[int]:
        engine = self.spawn()
        if rewarm and self.manager is not None and \
                self.manager.latest_step() is not None:
            # a replacement must not serve the weights it was born
            # with if the fleet has moved on — latest checkpoint wins
            engine.warm_start(manager=self.manager)
        idx = self.router.add_replica(engine)
        self.log(f"spawned replica {idx} ({why})")
        return idx

    def _replace_dead(self):
        deaths = self.router.replica_deaths
        while self._deaths_seen < deaths:
            self._deaths_seen += 1
            if len(self._live_replicas()) >= self.max_replicas:
                self.log("death not replaced: fleet at max_replicas")
                continue
            self.replacements += 1
            self._spawn_replica("replacing a dead replica",
                                rewarm=True)

    def _scale_up(self):
        self.scale_ups += 1
        self._pressure_ticks = 0
        self._spawn_replica(
            f"sustained pressure for {self.up_steps} ticks",
            rewarm=self.manager is not None)

    def _scale_down(self):
        # retire the newest SERVING replica: oldest replicas hold the
        # warmest prefix indexes, and LIFO keeps index churn minimal
        serving = [r for r in self.router.replicas
                   if r.state is ReplicaState.SERVING]
        if len(serving) <= 1:
            return                       # never drain the last server
        victim = serving[-1]
        if self._roll is not None and \
                victim.idx in self._roll["pending"]:
            self._roll["pending"].remove(victim.idx)
        self.scale_downs += 1
        self._idle_ticks = 0
        self.router.remove_replica(victim.idx)
        self.log(f"retiring replica {victim.idx} after "
                 f"{self.down_steps} idle ticks")

    # ------------------------------------------------------------- #
    # rolling upgrade
    # ------------------------------------------------------------- #

    def start_upgrade(self, params=None, manager=None, step=None):
        """Arm a one-replica-at-a-time weight roll over every replica
        currently live. The weight source is captured once and reused
        per replica (``Router.upgrade_replica`` stashes it per-target,
        so each swap survives this object's death)."""
        if self._roll is not None:
            raise MXNetError("an upgrade roll is already in progress "
                             "— one fleet, one roll at a time")
        if params is None and manager is None:
            raise MXNetError("start_upgrade needs params= or manager=")
        src = ({"params": params} if params is not None
               else {"manager": manager, "step": step})
        targets = [r.idx for r in self.router.replicas
                   if r.state in (ReplicaState.SERVING,
                                  ReplicaState.DEGRADED,
                                  ReplicaState.WARMING)]
        self._roll = {"pending": targets, "current": None,
                      "src": src, "halted": False}
        self.upgrades_started += 1
        self.flight.emit(self._component, EventType.UPGRADE,
                         phase="roll-start", targets=len(targets))
        self.log(f"upgrade roll started over {len(targets)} replicas")

    def _advance_roll(self, snap: dict):
        roll = self._roll
        cur = roll["current"]
        if cur is not None:
            state = self.router.replicas[cur].state
            if state in (ReplicaState.DRAINING, ReplicaState.WARMING):
                return                   # swap in progress: wait
            # SERVING = re-warmed; DEAD = warm_start failed and the
            # death/replacement machinery owns it — either way this
            # target is done
            roll["current"] = None
        degraded = self._degraded(snap)
        if degraded != roll["halted"]:
            roll["halted"] = degraded
            phase = "roll-halted" if degraded else "roll-resumed"
            self.flight.emit(self._component, EventType.UPGRADE,
                             phase=phase,
                             remaining=len(roll["pending"]))
            self.log(f"upgrade {phase} "
                     f"({len(roll['pending'])} pending)")
        if roll["halted"]:
            return
        while roll["pending"]:
            idx = roll["pending"].pop(0)
            if self.router.replicas[idx].state not in \
                    (ReplicaState.SERVING, ReplicaState.DEGRADED):
                continue                 # died/retired since arming
            self.router.upgrade_replica(idx, **roll["src"])
            roll["current"] = idx
            return
        self._roll = None
        self.upgrades_completed += 1
        self.flight.emit(self._component, EventType.UPGRADE,
                         phase="roll-complete")
        self.log("upgrade roll complete")

    # ------------------------------------------------------------- #
    # the tick
    # ------------------------------------------------------------- #

    def tick(self) -> dict:
        """One policy pass. Call after each fleet ``step()``; returns
        a small decision record (for benches and tests — the flight
        recorder carries the durable trail)."""
        self.ticks += 1
        self._replace_dead()
        snap = self.router.health_snapshot()
        if self._roll is not None:
            self._advance_roll(snap)
        pressured = self._pressured(snap)
        idle = self._idle(snap)
        self._pressure_ticks = self._pressure_ticks + 1 if pressured \
            else 0
        self._idle_ticks = self._idle_ticks + 1 if idle else 0
        can_scale = not self._in_transition() and self._roll is None
        if pressured and can_scale and \
                self._pressure_ticks >= self.up_steps and \
                len(self._live_replicas()) < self.max_replicas:
            self._scale_up()
        elif idle and can_scale and \
                self._idle_ticks >= self.down_steps and \
                len(self._live_replicas()) > self.min_replicas:
            self._scale_down()
        return {"tick": self.ticks, "pressured": pressured,
                "idle": idle, "fleet_size": snap["fleet_size"],
                "roll": None if self._roll is None else
                {"pending": list(self._roll["pending"]),
                 "current": self._roll["current"],
                 "halted": self._roll["halted"]}}

    def log(self, msg: str):
        self.router.log.append(f"supervisor: {msg}")

    def snapshot(self) -> dict:
        return {"ticks": self.ticks, "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "replacements": self.replacements,
                "upgrades_started": self.upgrades_started,
                "upgrades_completed": self.upgrades_completed,
                "pressure_ticks": self._pressure_ticks,
                "idle_ticks": self._idle_ticks,
                "roll": None if self._roll is None else
                {"pending": list(self._roll["pending"]),
                 "current": self._roll["current"],
                 "halted": self._roll["halted"]}}
