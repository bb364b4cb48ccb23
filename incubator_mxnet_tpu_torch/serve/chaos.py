"""Deterministic fault injection (chaos) for the serving engine and the
fleet.

The port of ``incubator_mxnet_tpu/serve/chaos.py``. Serving dies from
the faults nobody unit-tested: a checkpoint with a NaN in it
warm-started into a live fleet, a DMA that corrupted one KV page, an
allocator squeezed to starvation by a noisy neighbour, a host stall
that blows every deadline, a replica that stops answering. This module
makes those faults INJECTABLE, SEEDED and REPRODUCIBLE, so a harness
can assert the resilience contract instead of hoping:

  - every request ends in a structured terminal ``Outcome``;
  - unfaulted requests emit BIT-IDENTICAL tokens to a fault-free run
    (no cross-slot contamination — slots are isolated by construction);
  - ``audit_pages()`` passes after EVERY scheduler step, faults
    included (pages reclaimed exactly, never leaked or double-granted);
  - no program is built again (the guard flag and all fault handling
    are pure data / host-side bookkeeping).

Injectors hook the scheduler through ``InferenceEngine.run``'s (or
``Router.run``'s) ``before_step`` callback — they fire at a given
scheduler ITERATION (not wall time), so a batch-submitted workload
replays the same fault at the same point every run. All randomness
comes from the injector's own seeded ``RandomState``.

The engine's programs (CUDA graphs on the card) hold the KV pools and
the parameters by address, so every injector that corrupts device
state writes it IN PLACE: a rebound pool would corrupt nothing the next
replay reads, and the fault would silently not happen.
``CorruptPageWrite`` fills the page of every pool in place,
``NaNWeights`` goes through ``warm_start`` (which ``copy_``-es into the
engine's own model; a ``build_fleet`` replica's copy is its own), and
the per-page scales ``CorruptPageScale`` tears are host-owned arrays
staged into every program run.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..base import MXNetError
from .engine import InferenceEngine, Request
from .events import EventType
from .outcomes import Outcome
from .router import ReplicaState, Router

__all__ = ["ChaosInjector", "NaNWeights", "CorruptPageWrite",
           "CorruptPageScale", "CorruptDemotedPage", "DiskFullDemotion",
           "PagePressure", "DelayedSteps", "CancelStorm", "run_chaos",
           "assert_all_terminal", "assert_health_consistent",
           "FleetInjector", "KillReplica", "SlowReplica",
           "FlappingReplica", "FleetCancelStorm", "MigrateFault",
           "ScaleDownRace", "DrainKill", "SupervisorChaos",
           "run_fleet_chaos", "assert_fleet_health_consistent"]


class ChaosInjector:
    """Base: a seeded fault with an injection log and an ``affected``
    set — the requests whose OUTPUT the fault may legitimately change.
    Everything outside ``affected`` must stay bit-identical to a
    fault-free run (the cross-contamination invariant)."""

    name = "chaos"

    def __init__(self, seed: int = 0):
        self.rng = np.random.RandomState(seed)
        self.log: List[str] = []
        self.affected: List[Request] = []
        self.fired = False

    def _mark(self, *requests: Request):
        for r in requests:
            # identity, not ==: Request is a dataclass whose generated
            # __eq__ compares ndarray fields elementwise
            if not any(r is a for a in self.affected):
                self.affected.append(r)

    def on_step(self, engine: InferenceEngine, step_idx: int) -> None:
        raise NotImplementedError


class NaNWeights(ChaosInjector):
    """Poison the serving weights at step ``at_step`` — the
    'warm-started a bad checkpoint' fault. ``n_entries`` random entries
    of the EMBEDDING table get NaN: the tied LM head multiplies every
    slot's hidden state by that table, so any poisoned entry makes some
    logit non-finite for EVERY live slot — the guard must quarantine
    them all (FAILED_NONFINITE), and every request admitted while the
    poison stands must fail at its prefill guard. The swap goes through
    ``warm_start`` — pure data, no capture count may move. It reaches
    the engine's own model only: in a ``build_fleet`` fleet, one
    replica."""

    name = "nan_weights"

    def __init__(self, at_step: int, n_entries: int = 4, seed: int = 0):
        super().__init__(seed)
        self.at_step = at_step
        self.n_entries = n_entries

    def on_step(self, engine, step_idx):
        if self.fired or step_idx < self.at_step:
            return
        self.fired = True
        params = {k: v.detach().clone()
                  for k, v in engine.model.state_dict().items()}
        # the embedding / tied-head table
        emb_key = "word_embed.weight"
        tab = params[emb_key]
        flat = tab.view(-1)
        idx = self.rng.choice(flat.numel(), size=min(self.n_entries,
                                                     flat.numel()),
                              replace=False)
        flat[torch.as_tensor(idx, device=flat.device)] = float("nan")
        engine.warm_start(params=params)
        # every request not already terminal is poisoned from here on
        for slot in engine._slots:
            if slot is not None:
                self._mark(slot.request)
        self._mark(*engine._queue)
        self.log.append(f"step {step_idx}: NaN-poisoned {len(idx)} "
                        f"entries of param[{emb_key}] via warm_start")

    def mark_submitted_after(self, request: Request):
        """Requests submitted after the poison fired are affected too —
        the harness calls this from its submit wrapper."""
        if self.fired:
            self._mark(request)


class CorruptPageWrite(ChaosInjector):
    """Corrupt one LIVE, PRIVATE (refcount-1) mapped KV page of a
    decoding slot at step ``at_step`` — the 'DMA wrote garbage /
    dropped the write' fault, at page granularity across every layer's
    K and V pool.

    ``mode='nan'``: the slot's attention output goes non-finite the
    next decode step — the guard must quarantine exactly that slot.
    ``mode='zero'``: a dropped write — finite garbage the guard CANNOT
    see; the slot's request is marked affected (its tokens may
    legitimately change) and the invariant asserted is that NO OTHER
    request changes (cross-slot isolation) and all accounting stays
    exact. Defers to the next step when no candidate slot is live."""

    name = "corrupt_page"

    def __init__(self, at_step: int, mode: str = "nan", seed: int = 0):
        super().__init__(seed)
        if mode not in ("nan", "zero"):
            raise MXNetError(f"corrupt mode {mode!r} not in nan|zero")
        self.at_step = at_step
        self.mode = mode
        self.page: Optional[int] = None

    def on_step(self, engine, step_idx):
        if self.fired or step_idx < self.at_step:
            return
        if getattr(engine, "_kv_spec", None) is not None and \
                self.mode == "nan":
            raise MXNetError(
                "CorruptPageWrite(mode='nan') cannot express NaN in an "
                "int8/fp8 page payload — on a quantized engine the "
                "non-finite channel is the per-page SCALE: use "
                "CorruptPageScale")
        ps = engine.page_size
        cands = []
        for s in range(engine.num_slots):
            slot = engine._slots[s]
            if slot is None or slot.prefilling:
                continue
            n_read = -(-int(engine._lengths[s]) // ps)
            for p in slot.row[:n_read]:
                p = int(p)
                if p and engine._alloc.refcount(p) == 1:
                    cands.append((s, p))
        if not cands:
            return                       # defer until a slot is live
        self.fired = True
        s, page = cands[self.rng.randint(len(cands))]
        val = float("nan") if self.mode == "nan" else 0.0
        with torch.no_grad():
            # in place: the programs read these very pools by address
            for kp, vp in zip(engine._kpools, engine._vpools):
                kp[page].fill_(val)
                vp[page].fill_(val)
        self.page = page
        self._mark(engine._slots[s].request)
        self.log.append(f"step {step_idx}: {self.mode}-corrupted page "
                        f"{page} (slot {s}, refcount 1) in all layers")


class CorruptPageScale(ChaosInjector):
    """Corrupt the per-page SCALE metadata of a live quantized KV page
    — the quantized pool's own corruption channel: int8/fp8 payloads
    cannot carry NaN, so a torn scale (bit-flipped SMEM word, stale
    metadata after a botched migration) is how a quantized cache
    poisons reads. Requires a quantized engine (``kv_quant`` set);
    refuses otherwise.

    By default the target is a live SHARED page (refcount >= 2 — a
    prefix page mapped by a slot AND retained by the index or a
    sibling slot): the sharpest case, because the scale is shared
    exactly like the page, so one torn word poisons every reader, and
    quarantine must both fail the readers AND flush the index so no
    FUTURE admission maps the poisoned page (the freed page's scale is
    reset on reallocation). ``shared=False`` targets a private
    (refcount-1) page — the blast radius is provably one slot.

    ``mode='nan'`` / ``'inf'``: the dequantized K/V go non-finite and
    the next decode step's sign-encoded guard must quarantine exactly
    the slots mapping the page (FAILED_NONFINITE, nothing from the
    poisoned step recorded). ``mode='zero'`` zeroes the page's amax —
    the scale collapses to the zero-range convention (1.0) and the
    page dequantizes its raw codes at the wrong magnitude: finite
    garbage the guard CANNOT see, the metadata twin of a dropped
    write; affected slots may emit anything, everyone else must stay
    bit-identical. Defers to a later step when no candidate page is
    live."""

    name = "corrupt_page_scale"

    _VALS = {"nan": np.nan, "inf": np.inf, "zero": 0.0}

    def __init__(self, at_step: int, mode: str = "nan",
                 shared: bool = True, seed: int = 0):
        super().__init__(seed)
        if mode not in self._VALS:
            raise MXNetError(f"scale-corrupt mode {mode!r} not in "
                             f"nan|inf|zero")
        self.at_step = at_step
        self.mode = mode
        self.shared = shared
        self.page: Optional[int] = None

    def on_step(self, engine, step_idx):
        if self.fired or step_idx < self.at_step:
            return
        if engine._kv_spec is None:
            raise MXNetError("CorruptPageScale needs a quantized "
                             "engine (kv_quant='int8'/'fp8_e4m3') — "
                             "unquantized pools have no scale metadata")
        ps = engine.page_size
        want_shared = self.shared
        cands = []
        for s in range(engine.num_slots):
            slot = engine._slots[s]
            if slot is None or slot.prefilling:
                continue
            n_read = -(-int(engine._lengths[s]) // ps)
            for p in slot.row[:n_read]:
                p = int(p)
                if not p:
                    continue
                rc = engine._alloc.refcount(p)
                if (rc >= 2) == want_shared:
                    cands.append(p)
        if not cands:
            return                       # defer until a candidate lives
        self.fired = True
        page = cands[self.rng.randint(len(cands))]
        val = self._VALS[self.mode]
        for a in engine._kamax:          # host-owned page metadata —
            a[page] = val                # every layer's K and V scale
        for a in engine._vamax:
            a[page] = val
        self.page = page
        hit = []
        for s in range(engine.num_slots):
            slot = engine._slots[s]
            if slot is not None and any(int(p) == page
                                        for p in slot.row):
                hit.append(s)
                self._mark(slot.request)
        if self.mode == "zero":
            # finite corruption survives quarantine-free: a poisoned
            # SHARED page stays in the prefix index, so any later
            # admission may map it — every not-yet-finished request is
            # in the blast radius (the nan/inf modes need no such
            # blanket: quarantine flushes the index the same step)
            for slot in engine._slots:
                if slot is not None:
                    self._mark(slot.request)
            self._mark(*engine._queue)
        self.log.append(
            f"step {step_idx}: {self.mode}-corrupted the scale of "
            f"page {page} (refcount "
            f"{engine._alloc.refcount(page)}, slots {hit}) in all "
            f"layers, K and V")

    def mark_submitted_after(self, request: Request):
        """Zero-mode only: requests submitted after the fault may map
        the still-cached poisoned page (no quarantine ever flushes
        it). ``run_chaos`` submits everything up front — the fire-time
        blanket mark covers batch scenarios — so only a harness that
        feeds ``arrival_times`` (late submissions) needs to route its
        submits through this (same contract as
        ``NaNWeights.mark_submitted_after``)."""
        if self.fired and self.mode == "zero":
            self._mark(request)


class CorruptDemotedPage(ChaosInjector):
    """Corrupt one DEMOTED prefix page's at-rest payload — the 'bit rot
    below HBM' fault for the hierarchical cache (docs/SERVING.md
    "Hierarchical prefix cache"): a flipped byte in the host-DRAM pool,
    or in a disk-tier shard file, of a page the engine believes it can
    re-admit by copy.

    The integrity contract makes ``affected`` EMPTY: every DRAM entry
    carries a crc32 verified at promotion (the disk tier rides the
    checkpoint manifest's per-shard crc plus the same payload crc), so
    the corrupted page must be caught, dropped, and counted
    (``tier_crc_fallbacks``), and the admission must fall back to
    recomputing prefill — producing BIT-IDENTICAL tokens to a
    fault-free run. A fallback that records even one garbage token is
    the invariant breach this injector exists to catch.

    ``tier`` targets "dram", "disk", or None (whichever has an entry
    first, DRAM preferred). Defers until the engine's tier store holds
    a candidate. Requires a tiered engine (``kv_tiers`` set)."""

    name = "corrupt_demoted_page"

    def __init__(self, at_step: int, tier: Optional[str] = None,
                 seed: int = 0):
        super().__init__(seed)
        if tier not in (None, "dram", "disk"):
            raise MXNetError(f"demoted-corrupt tier {tier!r} not in "
                             f"dram|disk|None")
        self.at_step = at_step
        self.tier = tier

    def on_step(self, engine, step_idx):
        if self.fired or step_idx < self.at_step:
            return
        if engine._tiers is None:
            raise MXNetError("CorruptDemotedPage needs a tiered engine "
                             "(kv_tiers set) — there is nothing "
                             "demoted to corrupt otherwise")
        cands = [(k, e) for k, e in engine._tiers.entries()
                 if self.tier is None or e.tier == self.tier]
        if not cands:
            return                       # defer until something demoted
        if self.tier is None:
            dram = [c for c in cands if c[1].tier == "dram"]
            cands = dram or cands
        key, ent = cands[self.rng.randint(len(cands))]
        if ent.tier == "dram":
            # flip one byte of the layer-0 K payload (payloads may be
            # read-only views of device buffers — corrupt a copy and
            # swap it in; the stored crc now convicts it)
            arr = np.array(ent.k_payload[0])
            buf = arr.view(np.uint8).reshape(-1)
            buf[self.rng.randint(buf.size)] ^= 0xFF
            ent.k_payload = (arr,) + tuple(ent.k_payload[1:])
            where = "dram payload"
        else:
            from ..checkpoint.manifest import step_dir
            d = step_dir(engine._tiers.disk_dir, ent.step)
            shards = sorted(f for f in os.listdir(d)
                            if f.endswith(".bin"))
            path = os.path.join(d, shards[0])
            size = os.path.getsize(path)
            off = int(self.rng.randint(size))
            with open(path, "r+b") as f:
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ 0xFF]))
            where = f"disk shard {shards[0]}"
        self.fired = True
        self.log.append(f"step {step_idx}: flipped a byte in the "
                        f"{where} of demoted page depth {ent.depth} "
                        f"(key {key.hex()[:16]})")


class DiskFullDemotion(ChaosInjector):
    """Fail the disk tier's writes from step ``at_step`` on — the
    'disk filled up mid-demotion' fault. Wraps the tier store's
    ``_write_step`` seam with an ENOSPC raiser (``mode="torn"`` first
    leaves a partial ``.tmp`` step directory behind, the torn-write
    flavour — a later successful write must clear it, and the startup
    wipe must survive it).

    ``affected`` is EMPTY: a failed demotion degrades to plain
    eviction, loudly (``tier_disk_errors`` counts, the entry is
    dropped, the event lane records the failure) — every request must
    still end in a terminal outcome with tokens bit-identical to a
    fault-free run, because eviction-instead-of-demotion only costs
    recompute, never correctness."""

    name = "disk_full_demotion"

    def __init__(self, at_step: int, mode: str = "enospc",
                 seed: int = 0):
        super().__init__(seed)
        if mode not in ("enospc", "torn"):
            raise MXNetError(f"disk-full mode {mode!r} not in "
                             f"enospc|torn")
        self.at_step = at_step
        self.mode = mode
        self.failed_writes = 0

    def on_step(self, engine, step_idx):
        if self.fired or step_idx < self.at_step:
            return
        if engine._tiers is None or engine._tiers.disk_dir is None:
            raise MXNetError("DiskFullDemotion needs a tiered engine "
                             "with a disk_dir")
        self.fired = True
        store = engine._tiers
        inj = self

        def _enospc(root, step, entries, **kw):
            if inj.mode == "torn":
                from ..checkpoint.manifest import step_dir
                tmp = step_dir(root, step) + ".tmp"
                os.makedirs(tmp, exist_ok=True)
                with open(os.path.join(tmp, "shards_p0.bin"),
                          "wb") as f:
                    f.write(b"torn")
            inj.failed_writes += 1
            raise OSError(28, "No space left on device (chaos)")

        store._write_step = _enospc
        self.log.append(f"step {step_idx}: disk tier writes now fail "
                        f"ENOSPC ({self.mode})")


class PagePressure(ChaosInjector):
    """Squeeze the allocator: at ``hold_at`` take ``n`` pages (default
    ALL free pages — full starvation) out of circulation through the
    allocator's own ``hold`` bookkeeping, and release them after
    ``release_after`` scheduler steps (None = never). Pure scheduling
    pressure — no request's DATA is touched, so every request that
    completes must still be bit-identical to the fault-free run; the
    rest must end DEADLINE_EXPIRED / FAILED_UNSERVABLE (watchdog or
    stall), never wedge."""

    name = "page_pressure"

    def __init__(self, hold_at: int, release_after: Optional[int] = None,
                 n: Optional[int] = None, seed: int = 0):
        super().__init__(seed)
        self.hold_at = hold_at
        self.release_after = release_after
        self.n = n
        self.held: List[int] = []

    def on_step(self, engine, step_idx):
        if not self.fired and step_idx >= self.hold_at:
            self.fired = True
            self.held = engine._alloc.hold(
                self.n if self.n is not None else engine._alloc.free_count)
            self.log.append(f"step {step_idx}: held {len(self.held)} "
                            f"pages (free now {engine._alloc.free_count})")
        elif (self.held and self.release_after is not None
              and step_idx >= self.hold_at + self.release_after):
            engine._alloc.release_held(self.held)
            self.log.append(f"step {step_idx}: released "
                            f"{len(self.held)} held pages")
            self.held = []


class DelayedSteps(ChaosInjector):
    """Host stall: sleep ``sleep_s`` before every scheduler step in
    [``start``, ``end``) — models a preempted host / GC storm / slow
    interconnect. Drives deadline expiry deterministically when
    ``sleep_s`` dwarfs the requests' ``deadline_s``."""

    name = "delayed_steps"

    def __init__(self, start: int, end: int, sleep_s: float,
                 seed: int = 0):
        super().__init__(seed)
        self.start = start
        self.end = end
        self.sleep_s = sleep_s
        self.stalled_steps = 0

    def on_step(self, engine, step_idx):
        if self.start <= step_idx < self.end:
            self.fired = True
            self.stalled_steps += 1
            time.sleep(self.sleep_s)


class CancelStorm(ChaosInjector):
    """The disconnect fault: clients walk away mid-stream. Every
    ``every`` scheduler steps from ``start``, cancel up to ``n_per``
    seeded-random LIVE requests (queued or slotted — so cancels land
    while queued, mid-prefill, mid-decode and mid-spec-verify as the
    workload moves through those states), up to ``max_cancels`` total
    so part of the workload survives to assert isolation against.
    Cancelled requests are ``affected`` (their streams truncate);
    everything else must stay bit-identical, pages audited after every
    step, and every cancel must land as EXACTLY ONE ``CANCELLED``
    terminal — never a double-finish against a racing completion
    (``engine.cancel`` refuses already-terminal targets)."""

    name = "cancel_storm"

    def __init__(self, start: int, every: int = 2, n_per: int = 1,
                 max_cancels: int = 4, seed: int = 0):
        super().__init__(seed)
        self.start = start
        self.every = max(1, int(every))
        self.n_per = int(n_per)
        self.max_cancels = int(max_cancels)
        self.cancelled: List[Request] = []

    def _live(self, engine) -> List[Request]:
        live = [s.request for s in engine._slots if s is not None]
        live.extend(engine._queue)
        return [r for r in live if r.outcome is None]

    def on_step(self, engine, step_idx):
        if step_idx < self.start or \
                (step_idx - self.start) % self.every or \
                len(self.cancelled) >= self.max_cancels:
            return
        live = self._live(engine)
        if not live:
            return
        n = min(self.n_per, self.max_cancels - len(self.cancelled),
                len(live))
        for i in self.rng.choice(len(live), size=n, replace=False):
            req = live[int(i)]
            if engine.cancel(req, detail=f"{self.name} at step "
                                         f"{step_idx}"):
                self.fired = True
                self.cancelled.append(req)
                self._mark(req)
                self.log.append(f"step {step_idx}: cancelled request "
                                f"{req.request_id} "
                                f"({len(req.token_ids)} tokens in)")


# --------------------------------------------------------------------- #
# fleet-scope injectors (serve/router.py)
# --------------------------------------------------------------------- #

class FleetInjector(ChaosInjector):
    """Base for ROUTER-level injectors: ``on_step(router, step_idx)``
    fires through ``Router.run``'s ``before_step`` hook. Same seeding
    and logging contract as the engine-level injectors."""

    name = "fleet_chaos"

    def on_step(self, router: Router, step_idx: int) -> None:
        raise NotImplementedError


class KillReplica(FleetInjector):
    """Kill one replica — the 'host disappeared' fault. From the fire
    point on, every step of that replica raises ``ReplicaKilled``; the
    router must mark it DEAD and RE-QUEUE its in-flight requests with
    their emitted tokens preserved (resume-from-suffix replay), so
    with requeue budget left NO request is lost and — greedy decode
    being deterministic under position-keyed sampling — every replayed
    request still ends bit-identical to a fault-free run.

    ``phase`` targets the kill: ``"decode"`` defers until the replica
    has a decoding slot with at least one emitted token (a mid-stream
    kill — the replay must preserve a non-empty prefix), ``"prefill"``
    until it has a slot mid-prompt (chunked prefill spreads prompts
    over steps), ``"verify"`` until a speculative verify step has run
    with a decoding slot live (the kill lands inside the
    draft-then-verify window), None fires at ``at_step``
    unconditionally. ``inflight_at_kill`` snapshots (client request,
    copy of its tokens so far) at the fire point — the
    emitted-prefix-preservation oracle for tests."""

    name = "kill_replica"

    def __init__(self, replica: int, at_step: int, phase=None, seed=0):
        super().__init__(seed)
        if phase not in (None, "decode", "prefill", "verify"):
            raise MXNetError(f"kill phase {phase!r} not in "
                             f"decode|prefill|verify|None")
        self.replica = replica
        self.at_step = at_step
        self.phase = phase
        self.inflight_at_kill: List = []

    def _phase_ready(self, router: Router) -> bool:
        eng = router.replicas[self.replica].engine
        if self.phase is None:
            return True
        slots = [s for s in eng._slots if s is not None]
        if self.phase == "prefill":
            return any(s.prefilling for s in slots)
        decoding = [s for s in slots if not s.prefilling
                    and s.request.token_ids]
        if self.phase == "decode":
            return bool(decoding)
        return bool(decoding) and eng.spec_steps > 0   # "verify"

    def on_step(self, router, step_idx):
        if self.fired or step_idx < self.at_step:
            return
        rep = router.replicas[self.replica]
        if rep.state is ReplicaState.DEAD or rep.killed is not None:
            self.fired = True
            return
        if not self._phase_ready(router):
            return                           # defer to a later step
        self.fired = True
        for t in router._inflight:
            if t.replica == self.replica:
                self.inflight_at_kill.append(
                    (t.client, list(t.client.token_ids) +
                     list(t.attempt.token_ids)))
        rep.kill(f"chaos kill ({self.phase or 'any'} phase) at router "
                 f"step {step_idx}")
        self.log.append(
            f"step {step_idx}: killed replica {self.replica} with "
            f"{len(self.inflight_at_kill)} requests in flight")


class SlowReplica(FleetInjector):
    """Stall one replica's steps by ``sleep_s`` for router steps in
    [``start``, ``end``) — the 'neighbour is thrashing / link is slow'
    fault. With ``sleep_s`` over the router's ``heartbeat_timeout_s``,
    ``breaker_failures`` stalled steps must OPEN the breaker
    (DEGRADED: no new admissions, half-open probes on seeded-jitter
    backoff); once the window passes, probes must close it back to
    SERVING and its in-flight requests finish on-replica — slowness
    alone must never lose, re-route, or corrupt a request."""

    name = "slow_replica"

    def __init__(self, replica: int, start: int, end: int,
                 sleep_s: float, seed=0):
        super().__init__(seed)
        self.replica = replica
        self.start = start
        self.end = end
        self.sleep_s = sleep_s

    def on_step(self, router, step_idx):
        rep = router.replicas[self.replica]
        if self.start <= step_idx < self.end:
            self.fired = True
            rep.delay_s = self.sleep_s
        else:
            rep.delay_s = 0.0


class FlappingReplica(FleetInjector):
    """A replica that is alternately slow and healthy: ``cycles``
    windows of ``slow_for`` stalled router steps every ``period``
    steps, starting at ``start``. Exercises the full breaker loop
    repeatedly — OPEN on misses, half-open probes, CLOSE on recovery,
    OPEN again — asserting the backoff machinery is re-entrant and
    that flapping, like slowness, never loses a request."""

    name = "flapping_replica"

    def __init__(self, replica: int, start: int, period: int,
                 slow_for: int, sleep_s: float, cycles: int = 2,
                 seed=0):
        super().__init__(seed)
        if slow_for >= period:
            raise MXNetError("slow_for must be < period (the replica "
                             "needs healthy steps to flap back up)")
        self.replica = replica
        self.start = start
        self.period = period
        self.slow_for = slow_for
        self.sleep_s = sleep_s
        self.cycles = cycles

    def on_step(self, router, step_idx):
        rep = router.replicas[self.replica]
        rel = step_idx - self.start
        slow = False
        if rel >= 0 and rel // self.period < self.cycles:
            slow = (rel % self.period) < self.slow_for
        if slow:
            self.fired = True
        rep.delay_s = self.sleep_s if slow else 0.0


class FleetCancelStorm(FleetInjector):
    """Router-level cancel storm: same cadence as ``CancelStorm`` but
    through ``Router.cancel`` — cancels land on CLIENT requests
    whether they sit in the router queue or are in flight on a
    replica (where the router must also reclaim the engine-side
    attempt)."""

    name = "fleet_cancel_storm"

    def __init__(self, start: int, every: int = 2, n_per: int = 1,
                 max_cancels: int = 4, seed: int = 0):
        super().__init__(seed)
        self.start = start
        self.every = max(1, int(every))
        self.n_per = int(n_per)
        self.max_cancels = int(max_cancels)
        self.cancelled: List[Request] = []

    def on_step(self, router, step_idx):
        if step_idx < self.start or \
                (step_idx - self.start) % self.every or \
                len(self.cancelled) >= self.max_cancels:
            return
        live = [t.client for t in router._queue] + \
               [t.client for t in router._inflight]
        live = [r for r in live if r.outcome is None]
        if not live:
            return
        n = min(self.n_per, self.max_cancels - len(self.cancelled),
                len(live))
        for i in self.rng.choice(len(live), size=n, replace=False):
            req = live[int(i)]
            if router.cancel(req, detail=f"{self.name} at step "
                                         f"{step_idx}"):
                self.fired = True
                self.cancelled.append(req)
                self._mark(req)
                self.log.append(f"step {step_idx}: cancelled client "
                                f"request {req.request_id} "
                                f"({len(req.token_ids)} tokens in)")


class MigrateFault(FleetInjector):
    """Force ONE live-slot migration (serve/transport.py) with a fault
    injected at a chosen point of the transfer — the
    migration-failure taxonomy of docs/RESILIENCE.md, made runnable.

    At ``at_step`` (deferring until a decode-ready, mid-stream victim
    and a viable destination both exist) the injector arms the
    transport's chaos seam for its ``mode`` and calls
    ``router.migrate``:

      ``none``         no fault — the forced-migration control arm;
                       the transfer must SUCCEED and the continuation
                       stay bit-identical.
      ``kill_source``  the source replica dies mid-capture, BEFORE the
                       slot detaches: capture aborts read-only
                       (MIGRATE_FAIL fallback="none"), and the death
                       path replays everything the source held.
      ``kill_dst``     the destination dies mid-install, AFTER the
                       source detached: the install rolls back its
                       pages, the source custody is released, and the
                       replay fallback re-queues from the delivered
                       suffix (MIGRATE_FAIL fallback="replay").
      ``corrupt``      wire bit rot: one payload byte flips after
                       capture; the destination's crc-chain check
                       refuses the install — replay fallback, loudly.
      ``cancel_race``  the client cancels in the same step the
                       migration is requested. ``order="before"``:
                       migrate must REFUSE the cancelled request and
                       the cancel stands as exactly one CANCELLED
                       terminal; ``order="after"``: the cancel lands
                       on whichever side of the transfer now owns the
                       slot — still exactly one terminal.

    ``affected`` is EMPTY for everything but ``cancel_race`` (its
    victim's stream truncates): every fallback replays bit-identical
    to the fault-free run — migration is an optimisation over replay
    and a failed one may cost only recompute, never correctness."""

    name = "migrate_fault"

    _MODES = ("none", "kill_source", "kill_dst", "corrupt",
              "cancel_race")

    def __init__(self, at_step: int, mode: str = "none",
                 order: str = "before", seed: int = 0):
        super().__init__(seed)
        if mode not in self._MODES:
            raise MXNetError(f"migrate-fault mode {mode!r} not in "
                             f"{'|'.join(self._MODES)}")
        if order not in ("before", "after"):
            raise MXNetError(f"cancel order {order!r} not in "
                             f"before|after")
        self.at_step = at_step
        self.mode = mode
        self.order = order
        self.victim: Optional[Request] = None
        self.src: Optional[int] = None
        self.dst: Optional[int] = None
        self.migrate_returned: Optional[bool] = None

    def _candidate(self, router: Router):
        """A mid-stream victim (decode-ready WITH emitted tokens — the
        fallback must have a non-empty prefix to preserve) plus a
        viable destination, or (None, None) to defer."""
        for t in router._inflight:
            if t.attempt is None or t.attempt.outcome is not None:
                continue
            rep = router.replicas[t.replica]
            if rep.state is not ReplicaState.SERVING or \
                    rep.killed is not None:
                continue
            if not rep.engine.decode_ready(t.attempt.request_id):
                continue
            if not t.attempt.token_ids and not t.client.token_ids:
                continue
            dst = router._migration_dst(t, exclude=t.replica)
            if dst is not None:
                return t, dst
        return None, None

    def on_step(self, router, step_idx):
        if self.fired or step_idx < self.at_step:
            return
        t, dst = self._candidate(router)
        if t is None:
            return                       # defer until one exists
        self.fired = True
        self.victim, self.src, self.dst = t.client, t.replica, dst
        cid = t.client.request_id
        tr = router._transport
        if self.mode == "none":
            self.migrate_returned = router.migrate(cid, dst)
        elif self.mode == "kill_source":
            src_rep = router.replicas[t.replica]

            def die_mid_capture():
                src_rep.kill(f"chaos: source died mid-capture at "
                             f"router step {step_idx}")
                return True

            tr._capture_abort = die_mid_capture
            try:
                self.migrate_returned = router.migrate(cid, dst)
            finally:
                tr._capture_abort = None
        elif self.mode == "kill_dst":
            dst_rep = router.replicas[dst]

            def die_mid_install():
                dst_rep.kill(f"chaos: destination died mid-install "
                             f"at router step {step_idx}")
                return True

            tr._install_abort = die_mid_install
            try:
                self.migrate_returned = router.migrate(cid, dst)
            finally:
                tr._install_abort = None
        elif self.mode == "corrupt":
            byte = int(self.rng.randint(256))
            tr._capsule_hook = \
                lambda c: c.corrupt(page_idx=0, byte=byte)
            try:
                self.migrate_returned = router.migrate(cid, dst)
            finally:
                tr._capsule_hook = None
        else:                            # cancel_race
            self._mark(t.client)
            if self.order == "before":
                router.cancel(t.client,
                              detail=f"{self.name}: cancel-then-"
                                     f"migrate at step {step_idx}")
                self.migrate_returned = router.migrate(cid, dst)
                if self.migrate_returned:
                    raise MXNetError(
                        "migrate accepted a cancelled request — the "
                        "race the refusal ladder exists to lose")
            else:
                self.migrate_returned = router.migrate(cid, dst)
                router.cancel(t.client,
                              detail=f"{self.name}: migrate-then-"
                                     f"cancel at step {step_idx}")
        self.log.append(
            f"step {step_idx}: {self.mode} migration of request "
            f"{cid} replica{self.src}->replica{dst} returned "
            f"{self.migrate_returned}")


class ScaleDownRace(FleetInjector):
    """The membership race: remove one replica and admit a fresh one
    in the SAME fleet pass — scale-down racing scale-up. The drain
    must route its migrations around the newcomer's WARMING state (or
    into it: spill-class work may land there), every request must
    still reach exactly one terminal, and the retiring replica's
    tombstone must keep every older index stable. ``spawn`` is a
    zero-arg engine factory (the supervisor's contract)."""

    name = "scale_down_race"

    def __init__(self, victim: int, spawn, at_step: int, seed=0):
        super().__init__(seed)
        self.victim = victim
        self.spawn = spawn
        self.at_step = at_step
        self.added: Optional[int] = None

    def on_step(self, router, step_idx):
        if self.fired or step_idx < self.at_step:
            return
        rep = router.replicas[self.victim]
        if rep.state is not ReplicaState.SERVING:
            return                           # defer to a clean fire
        self.fired = True
        stats = router.remove_replica(self.victim)
        self.added = router.add_replica(self.spawn())
        self.log.append(
            f"step {step_idx}: remove_replica({self.victim}) "
            f"(migrated={stats['migrated']} requeued="
            f"{stats['requeued']} remaining={stats['remaining']}) "
            f"racing add_replica -> {self.added}")


class DrainKill(FleetInjector):
    """Replica death MID-DRAIN: ``remove_replica`` at ``at_step``,
    then — ``kill_after`` router steps later, while the victim is
    still DRAINING — the host disappears. Whatever the drain had not
    yet migrated must come back through the death path's replay
    re-queue: zero lost requests either way, and the drain's
    finalisation must simply never happen (DEAD wins over RETIRED)."""

    name = "drain_kill"

    def __init__(self, victim: int, at_step: int, kill_after: int = 2,
                 seed=0):
        super().__init__(seed)
        self.victim = victim
        self.at_step = at_step
        self.kill_after = kill_after
        self.removed_at: Optional[int] = None
        self.killed_mid_drain = False

    def on_step(self, router, step_idx):
        if self.fired:
            return
        rep = router.replicas[self.victim]
        if self.removed_at is None:
            if step_idx < self.at_step:
                return
            if rep.state is not ReplicaState.SERVING:
                return
            stats = router.remove_replica(self.victim)
            self.removed_at = step_idx
            self.log.append(
                f"step {step_idx}: draining replica {self.victim} "
                f"(remaining={stats['remaining']})")
            return
        if step_idx < self.removed_at + self.kill_after:
            return
        self.fired = True
        if rep.state is ReplicaState.DRAINING and rep.killed is None:
            rep.kill(f"chaos kill mid-drain at router step {step_idx}")
            self.killed_mid_drain = True
            self.log.append(
                f"step {step_idx}: killed replica {self.victim} "
                f"mid-drain")
        else:
            self.log.append(
                f"step {step_idx}: drain already finalised "
                f"({rep.state}) — kill skipped")


class SupervisorChaos(FleetInjector):
    """Drives a ``FleetSupervisor`` from the chaos hook — one
    ``tick()`` per router step — optionally arming a rolling upgrade
    at ``upgrade_at``, and modelling the supervisor PROCESS dying at
    ``kill_at``: from that step on it never ticks again. The contract
    under test is the router-owned finalisation: the replica the roll
    had mid-drain still finishes its warm_start on the router's own
    step loop, the fleet serves on, and only the not-yet-started
    targets stay on old weights."""

    name = "supervisor_kill"

    def __init__(self, supervisor, kill_at: Optional[int] = None,
                 upgrade_at: Optional[int] = None,
                 upgrade_src: Optional[dict] = None, seed=0):
        super().__init__(seed)
        self.supervisor = supervisor
        self.kill_at = kill_at
        self.upgrade_at = upgrade_at
        self.upgrade_src = upgrade_src or {}
        self.killed_at_step: Optional[int] = None
        self.upgrade_started = False

    def on_step(self, router, step_idx):
        if self.killed_at_step is not None:
            return                           # the supervisor is gone
        if self.kill_at is not None and step_idx >= self.kill_at:
            self.killed_at_step = step_idx
            self.fired = True
            roll = self.supervisor.snapshot()["roll"]
            self.log.append(
                f"step {step_idx}: supervisor killed (roll state at "
                f"death: {roll})")
            return
        if self.upgrade_at is not None and not self.upgrade_started \
                and step_idx >= self.upgrade_at:
            self.supervisor.start_upgrade(**self.upgrade_src)
            self.upgrade_started = True
            self.log.append(
                f"step {step_idx}: rolling upgrade armed")
        self.supervisor.tick()


def _mirror_injector_events(flight, component, injectors, seen):
    """Land every injector firing on the flight-recorder timeline —
    one CHAOS event per new injector-log line, so a postmortem dump
    always NAMES the injected fault next to its consequences (the
    event-mirroring contract). ``seen`` maps injector → log length already
    mirrored; injectors stay recorder-agnostic."""
    for inj in injectors:
        n = seen.get(id(inj), 0)
        for line in inj.log[n:]:
            flight.emit(component, EventType.CHAOS, entity=inj.name,
                        detail=line[:300])
        seen[id(inj)] = len(inj.log)


def run_fleet_chaos(router: Router, requests, injectors,
                    arrival_times=None, audit_every_step: bool = True,
                    poll_sleep: float = 1e-3):
    """Drive ``requests`` through the fleet with ``injectors`` firing
    via the router's ``before_step`` hook, auditing EVERY surviving
    replica's page invariant after every router step (a dead replica's
    memory is off-limits by definition). Raises if any request fails
    to reach a terminal outcome — after dumping a postmortem of the
    fleet timeline (the chaos-invariant-breach black box,
    docs/OBSERVABILITY.md)."""
    seen: dict = {}

    def before(rt, i):
        for inj in injectors:
            inj.on_step(rt, i)
        _mirror_injector_events(rt.flight, "router", injectors, seen)

    def after(rt, i):
        if audit_every_step:
            for rep in rt.replicas:
                if rep.state is not ReplicaState.DEAD and \
                        rep.killed is None:
                    rep.engine.audit_pages()

    try:
        router.run(requests, arrival_times=arrival_times,
                   poll_sleep=poll_sleep, before_step=before,
                   after_step=after)
        assert_all_terminal(requests)
    except MXNetError as e:
        router.flight.postmortem(
            "chaos invariant breach", f"{type(e).__name__}",
            context={"error": str(e)[:400]})
        raise
    return requests


def assert_fleet_health_consistent(router: Router, requests):
    """The router's outcome tally must equal the per-request outcomes
    — the fleet twin of ``assert_health_consistent`` (the engines'
    own counters count ATTEMPTS, which legitimately exceed client
    requests under requeue; the router's count client terminals)."""
    tally = {o.value: 0 for o in Outcome}
    for r in requests:
        tally[r.outcome.value] += 1
    if tally != router.health:
        raise MXNetError(f"router health {router.health} != outcome "
                         f"tally {tally}")
    by_tier = _tier_tally(requests)
    if by_tier != router.health_by_tier:
        raise MXNetError(f"router per-tier health "
                         f"{router.health_by_tier} != per-tier tally "
                         f"{by_tier}")


def run_chaos(engine: InferenceEngine, requests, injectors,
              arrival_times=None, audit_every_step: bool = True,
              poll_sleep: float = 1e-3):
    """Drive ``requests`` through ``engine`` with ``injectors`` firing
    via the scheduler's ``before_step`` hook, auditing the page
    invariant after EVERY step (faults included). Returns the requests;
    raises if any request failed to reach a terminal outcome — after
    dumping a postmortem of the engine timeline (the
    chaos-invariant-breach black box, docs/OBSERVABILITY.md)."""
    seen: dict = {}

    def before(eng, i):
        for inj in injectors:
            inj.on_step(eng, i)
        _mirror_injector_events(eng.flight, eng._component, injectors,
                                seen)

    def after(eng, i):
        if audit_every_step:
            eng.audit_pages()

    try:
        engine.run(requests, arrival_times=arrival_times,
                   poll_sleep=poll_sleep, before_step=before,
                   after_step=after)
        assert_all_terminal(requests)
    except MXNetError as e:
        engine.flight.postmortem(
            "chaos invariant breach", f"{type(e).__name__}",
            context={"error": str(e)[:400]})
        raise
    return requests


def assert_all_terminal(requests):
    missing = [i for i, r in enumerate(requests) if r.outcome is None]
    if missing:
        raise MXNetError(f"requests {missing} did not reach a terminal "
                         f"outcome — the engine failed quiescence")


def _tier_tally(requests):
    from .slo import Tier
    by_tier = {t.value: {o.value: 0 for o in Outcome} for t in Tier}
    for r in requests:
        by_tier[r.tier.value][r.outcome.value] += 1
    return by_tier


def assert_health_consistent(engine: InferenceEngine, requests):
    """The engine's health counters must equal the per-request outcome
    tally — a counter drifting from the outcomes it summarizes would
    lie to the operator exactly when it matters. The per-tier split
    (the /metrics surface) must agree too."""
    tally = {o.value: 0 for o in Outcome}
    for r in requests:
        tally[r.outcome.value] += 1
    if tally != engine.health:
        raise MXNetError(f"health counters {engine.health} != outcome "
                         f"tally {tally}")
    by_tier = _tier_tally(requests)
    if by_tier != engine.health_by_tier:
        raise MXNetError(f"per-tier health {engine.health_by_tier} != "
                         f"per-tier tally {by_tier}")
