"""Page transport: KV pages and live slots as network-mobile resources
(the port of ``incubator_mxnet_tpu/serve/transport.py``).

The paged KV layout makes a page the natural unit of transfer between
replicas — the same per-page payload the cache tiers demote to host
DRAM/disk (``engine.gather_page``: int8/fp8 codes + one f32 scale per
layer on quantized pools, the 4x-denser wire form; raw dtype otherwise,
bf16 and float8 as their bits)
is also a wire format. This module builds two things on that
observation:

**PageCapsule** — a slot's pages plus everything else the slot IS
(emitted tokens, pinned sampling key, sampling/grammar/stop state — all
resumable as data), checksummed page-by-page
with a CHAINED crc32: each page's crc seeds the next
(``paged_kv.payload_crc``), so a dropped, reordered, or substituted
page breaks every later link, not just its own. ``verify()`` re-walks
the chain; ``corrupt()`` is the public fault-injection seam a fault harness
uses to model wire bit rot.

**PageTransport** — the capture/install protocol between two engines:

- ``capture(engine, request_id)``: gather the decode-ready slot's
  pages through the engine's ONE gather program (shared with tier
  demotion — a capture never builds another), then DETACH the slot
  into the source engine's in-capsule custody. Capture is read-only
  until every page is on the host: an abort mid-capture (source death)
  leaves the source slot exactly as it was — the replay fallback
  re-queues nothing here, the death path owns that.
- ``install(engine, capsule, request)``: verify the chain, then write
  every payload through the engine's ONE promotion program (shared
  with tier re-admission) into fresh private pages on the destination.
  The installed slot is decode-ready at once: the destination's next
  decode step feeds the last token, writes its K/V and samples after it
  (the wire carries no logits), the same program on the same row as the
  source's next step, so a migration redoes no prefill and the
  continuation is bitwise the never-migrated stream.

Every failure mode — crc mismatch, wire-signature mismatch, abort
mid-install, no capacity — refuses loudly and leaves both engines'
page accounting clean, so the caller can fall back to replaying the
request: migration is an optimisation over replay, and the correctness
story never depends on it succeeding.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..base import MXNetError
from .engine import InferenceEngine, Request
from .paged_kv import payload_crc, payload_nbytes

__all__ = ["PageCapsule", "PageTransport"]


class PageCapsule:
    """One slot's wire image: page payloads under a chained crc32 plus
    the slot identity (request state, pinned sampling key, position). Built
    page-by-page by ``PageTransport.capture``; consumed whole by
    ``install``. The payload records are private — everything a
    consumer needs goes through ``verify``/``payloads``/``nbytes``."""

    def __init__(self, request_id: int, wire_sig: tuple, n_pos: int,
                 key: int):
        self.request_id = int(request_id)
        self.wire_sig = tuple(wire_sig)
        self.n_pos = int(n_pos)          # captured KV positions [0, n_pos)
        self.key = int(key)              # the slot's PINNED
        # sampling key: an engine-drawn key exists nowhere else, so it
        # MUST travel or the destination would re-draw from its own
        # stream and the continuation would silently diverge
        self.request: Optional[Request] = None  # the detached attempt,
        # set when capture completes (tokens + sampling + budget ride
        # on it — resumable-as-data)
        self._records: List[Tuple] = []  # (k, v, kamax, vamax, chain)
        self._chain_crc = 0

    @property
    def num_pages(self) -> int:
        return len(self._records)

    @property
    def nbytes(self) -> int:
        """Wire bytes: what ``kv_migrated_bytes_total`` counts —
        quantized pools ship ~1/4 the raw-dtype bytes."""
        return sum(payload_nbytes(k, v, ka, va)
                   for k, v, ka, va, _ in self._records)

    @property
    def crc(self) -> int:
        return self._chain_crc

    def add_page(self, k_payload, v_payload, kamax, vamax) -> None:
        """Append one page payload, extending the crc chain: this
        page's crc is seeded by every page before it."""
        self._chain_crc = payload_crc(k_payload, v_payload, kamax,
                                      vamax, seed=self._chain_crc)
        self._records.append((k_payload, v_payload, kamax, vamax,
                              self._chain_crc))

    def verify(self) -> bool:
        """Re-walk the chain from zero: every page's recomputed chain
        value must equal the one recorded at capture. A single flipped
        bit fails its own page AND every page after it."""
        c = 0
        for k, v, ka, va, chain in self._records:
            c = payload_crc(k, v, ka, va, seed=c)
            if c != chain:
                return False
        return True

    def payloads(self) -> List[Tuple]:
        """The page payloads in chain order, verified — raises on a
        broken chain so no caller can install bytes the chain does not
        vouch for."""
        if not self.verify():
            raise MXNetError(
                f"capsule for request {self.request_id}: crc chain "
                f"broken — refusing to expose payloads")
        return [(k, v, ka, va) for k, v, ka, va, _ in self._records]

    def corrupt(self, page_idx: int = 0, byte: int = 0) -> None:
        """Fault-injection seam: flip one payload byte WITHOUT
        updating the recorded chain — the capsule now models a capsule
        that took wire bit rot. Production code never uses it."""
        k, v, ka, va, chain = self._records[page_idx]
        k0 = np.array(k[0])              # writable copy
        flat = k0.view(np.uint8).reshape(-1)
        flat[byte % flat.size] ^= 0xFF
        self._records[page_idx] = ((k0,) + tuple(k[1:]), v, ka, va,
                                   chain)

    def make_resume_request(self) -> Optional[Request]:
        """Build the destination attempt from the capsule's carried
        state — prompt = everything the source knew (original prompt +
        every emitted token), budget = what remains, ``prompt_len``
        marking the true-prompt split so grammar/stop state re-derive
        from the generated suffix only. The capsule's pinned key rides
        as ``_assigned_key`` so a seedless stream continues
        bit-identically. None when the deadline already passed (the
        caller owns that terminal)."""
        r = self.request
        if r is None:
            raise MXNetError("capsule was never detached from its "
                             "source — no request state to resume")
        if r.token_ids:
            prompt = np.concatenate(
                [r.prompt_ids, np.asarray(r.token_ids, np.int32)])
        else:
            prompt = r.prompt_ids.copy()
        deadline = None
        if r._deadline_abs is not None:
            deadline = r._deadline_abs - time.perf_counter()
            if deadline <= 0:
                return None
        att = Request(prompt,
                      max_new_tokens=(r.max_new_tokens -
                                      len(r.token_ids)),
                      temperature=r.temperature, eos_id=r.eos_id,
                      deadline_s=deadline, seed=r.seed, tier=r.tier,
                      sampling=r.sampling,
                      prompt_len=(r.prompt_len if r.prompt_len
                                  is not None
                                  else int(r.prompt_ids.size)))
        att._assigned_key = self.key
        return att


class PageTransport:
    """The capture/install protocol (module docstring). Holds the
    fault-injection seams — per-page hooks and abort predicates on both sides,
    plus the capsule (wire) hook — and the protocol counters. One
    transport instance serves a whole fleet; it keeps no per-transfer
    state between calls."""

    def __init__(self):
        self.captures = 0
        self.installs = 0
        self.capture_failures = 0
        self.install_failures = 0
        # fault-injection seams: called per page during
        # capture/install; the abort predicates model a replica dying
        # mid-transfer, the capsule hook models the wire itself
        self._capture_hook: Optional[Callable[[int, int], None]] = None
        self._install_hook: Optional[Callable[[int, int], None]] = None
        self._capture_abort: Optional[Callable[[], bool]] = None
        self._install_abort: Optional[Callable[[], bool]] = None
        self._capsule_hook: Optional[Callable[[PageCapsule], None]] = \
            None

    def capture(self, engine: InferenceEngine,
                request_id: int) -> Optional[PageCapsule]:
        """Capture ``request_id``'s decode-ready slot off ``engine``
        into a capsule. Read-only until the last page is on the host;
        only then is the slot detached into in-capsule custody — an
        abort anywhere before that returns None with the source slot
        UNTOUCHED (still decoding; the replay fallback owes nothing).
        On success the source engine's slot is gone, its pages held in
        custody until ``engine.release_capsule(request_id)``."""
        probe = engine.capture_slot(request_id)
        if probe is None:
            self.capture_failures += 1
            return None
        capsule = PageCapsule(request_id=request_id,
                              wire_sig=engine.kv_wire_sig(),
                              n_pos=probe["n_pos"], key=probe["key"])
        pages = probe["pages"]
        for j, page in enumerate(pages):
            if self._capture_hook is not None:
                self._capture_hook(j, len(pages))
            if self._capture_abort is not None and \
                    self._capture_abort():
                self.capture_failures += 1
                return None              # pre-detach: slot intact
            capsule.add_page(*engine.gather_page(page))
        req = engine.detach_slot(request_id)
        if req is None:                  # raced a terminal/evict
            self.capture_failures += 1
            return None
        capsule.request = req
        engine.migrated_out_pages += capsule.num_pages
        engine.migrated_out_bytes += capsule.nbytes
        self.captures += 1
        if self._capsule_hook is not None:
            self._capsule_hook(capsule)  # the wire (bit rot)
        return capsule

    def install(self, engine: InferenceEngine, capsule: PageCapsule,
                request: Request) -> bool:
        """Install ``capsule`` into ``engine`` as ``request``'s slot.
        Refuses — False, destination untouched or fully rolled back —
        on a wire-signature mismatch, a broken crc chain, no capacity,
        or a mid-install abort. The caller owns the fallback (replay)
        and the source-side custody release either way."""
        if tuple(capsule.wire_sig) != tuple(engine.kv_wire_sig()):
            self.install_failures += 1
            return False
        if not capsule.verify():
            self.install_failures += 1
            return False
        ok = engine.install_slot(
            request, capsule.payloads(), capsule.n_pos, capsule.key,
            wire_bytes=capsule.nbytes, page_hook=self._install_hook,
            abort=self._install_abort)
        if ok:
            self.installs += 1
        else:
            self.install_failures += 1
        return ok
