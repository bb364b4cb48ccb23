"""Paged KV cache: a shared page pool + host-side page allocator.

The port of ``incubator_mxnet_tpu/serve/paged_kv.py``. Layout, one
pool pair per transformer layer:

    k_pool / v_pool : (num_pages, H, page_size, D)

so each (page, head) slice is a contiguous (page_size, D) tile — the
ragged kernels' per-head operand (ops/ragged_attention.py).

Invariants (enforced by the engine, asserted in tests):
  - **Page 0 is the NULL page.** The allocator never hands it out; every
    dead page-table entry points at it; inactive slots' decode writes
    land in it. Its contents are garbage BY DESIGN — correctness relies
    on every read of it being masked by the slot's length.
  - A slot at length L references exactly ceil(L / page_size) live
    pages, contiguous in its page-table row; entries past that are 0.
  - Pages are identity-free: eviction returns them to the free list and
    any slot may reuse them without clearing.
  - **Pages are reference-counted.** A page may be mapped read-only into
    several slots' page tables at once (prefix sharing) and retained by
    the host-side prefix index; it returns to the free list only when
    the last reference drops. A shared page is NEVER written: decode
    writes land past every shared prefix page, and the first partial
    page after a matched prefix is COPIED into a private page before the
    slot writes it (copy-on-write at page granularity).

``PageAllocator`` and ``PrefixIndex`` are host-side Python (the port's
own copy of the JAX package's); the pool writers are in-place PyTorch
index writes — the pools are updated where they lie, never copied.
Quantized pools (``kv_quant_spec``) hold int8 / float8 codes with one
scale per page; their writers (``write_*_kv_q``) also return the
updated per-page amax.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..ops.quantization import (quantize_symmetric, requantize_symmetric,
                                symmetric_scale)

NULL_PAGE = 0

__all__ = ["NULL_PAGE", "PageAllocator", "PrefixIndex", "init_kv_pools",
           "write_token_kv", "write_prompt_kv", "write_block_kv",
           "KVQuantSpec", "kv_quant_spec", "page_scales",
           "write_token_kv_q", "write_prompt_kv_q", "write_block_kv_q",
           "KVTierStore", "payload_crc", "payload_nbytes", "payload_dtype"]


class PageAllocator:
    """Reference-counted free-list allocator over pages 1..num_pages-1
    (page 0 = null). ``alloc`` hands out a page at refcount 1;
    ``incref`` adds a sharer; ``free``/``decref`` drops one reference
    and returns the page to the free list when the last one goes.

    Corruption is refused loudly instead of silently poisoning the free
    list: freeing the null page, double-freeing a page already back on
    the free list, or dropping a refcount below zero all raise."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise MXNetError("need >= 2 pages (page 0 is the null page)")
        self.num_pages = num_pages
        # LIFO reuse keeps the working set of hot pages small
        self._free = list(range(num_pages - 1, 0, -1))
        self._rc = [0] * num_pages
        self._held: List[int] = []

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def held(self) -> Tuple[int, ...]:
        """Pages taken out of circulation by ``hold`` (chaos-harness
        allocator pressure) — accounted for by the engine's page audit."""
        return tuple(self._held)

    def hold(self, n: int) -> List[int]:
        """Take up to ``n`` pages out of circulation (refcount 1, owned
        by the holder): the deterministic allocator-pressure fault of
        serve/chaos.py — admission and tail allocation see a genuinely
        smaller pool, through the allocator's own bookkeeping so the
        page audit stays exact. Returns the pages actually held."""
        pages = [self.alloc() for _ in range(min(max(n, 0),
                                                 self.free_count))]
        self._held.extend(pages)
        return pages

    def release_held(self, pages=None) -> int:
        """Return held pages (default: all of them) to the free list."""
        if pages is None:
            pages = list(self._held)
        for p in pages:
            self._held.remove(p)
            self.decref(p)
        return len(pages)

    def _check(self, page) -> int:
        p = int(page)
        if p == NULL_PAGE:
            raise MXNetError("the null page (page 0) is never allocated, "
                             "shared, or freed")
        if not 0 < p < self.num_pages:
            raise MXNetError(f"page {p} outside pool [1, "
                             f"{self.num_pages})")
        return p

    def refcount(self, page) -> int:
        return self._rc[self._check(page)]

    def alloc(self) -> int:
        if not self._free:
            raise MXNetError("KV page pool exhausted — admission control "
                             "should have prevented this (engine bug)")
        p = self._free.pop()
        self._rc[p] = 1
        return p

    def incref(self, page) -> None:
        """Add a reference to a LIVE page (prefix sharing / index
        retention). Sharing a page that is on the free list would hand
        the same page to two owners — refused."""
        p = self._check(page)
        if self._rc[p] <= 0:
            raise MXNetError(f"incref on free page {p} — a page must be "
                             f"live to be shared")
        self._rc[p] += 1

    def decref(self, page) -> bool:
        """Drop one reference; returns True when the page went back to
        the free list. A decref on a page whose refcount is already zero
        is a double free (or a below-zero drop) and raises."""
        p = self._check(page)
        if self._rc[p] <= 0:
            raise MXNetError(
                f"double free: page {p} already has refcount 0 (it is "
                f"on the free list) — refusing to corrupt the free list")
        self._rc[p] -= 1
        if self._rc[p] == 0:
            self._free.append(p)
            return True
        return False

    def free(self, pages) -> None:
        for p in pages:
            self.decref(p)


@dataclasses.dataclass(eq=False)        # identity semantics: entries are
class _PrefixEntry:                     # tracked by object, and ndarray
    page: int                           # fields break generated __eq__
    tokens: np.ndarray          # the page's token ids (full page)
    depth: int                  # page index within its prompt chain
    last_use: int


class PrefixIndex:
    """Host-side hash-radix index over page-aligned prompt prefixes.

    A radix node is keyed by the BYTES OF THE WHOLE TOKEN PREFIX that
    precedes its pages (int32, fixed width — byte-prefix equality is
    token-prefix equality) and holds the SIBLING entries extending that
    prefix (several prompt families may diverge at the same depth), so
    lookups walk page by page exactly like a radix tree without storing
    child pointers. Each entry holds its page's own tokens for
    verification and the shared page id; the index owns one allocator
    reference per entry.

    Matching returns the longest cached page-aligned prefix as
    read-only shared pages plus (when the boundary page's leading
    tokens match) a partial page to copy — capped at ``t0 - 1`` tokens
    so the LAST prompt token is always recomputed: its logits seed
    first-token sampling, which cached K/V alone cannot provide.

    ``flush`` drops every entry (cached K/V is weight-dependent — the
    engine flushes on ``warm_start``); ``reclaim`` evicts
    least-recently-used entries whose pages nobody else references,
    which is how admission turns cache retention back into free pages
    under pressure."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        # radix node: preceding-prefix bytes -> sibling entries
        self._nodes: Dict[bytes, List[_PrefixEntry]] = {}
        self._clock = 0
        self.flushes = 0

    def __len__(self) -> int:
        return sum(len(b) for b in self._nodes.values())

    def held_pages(self) -> List[int]:
        return [e.page for b in self._nodes.values() for e in b]

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, prompt_ids, mutate: bool = True) \
            -> Tuple[List[int], Optional[Tuple[int, int]], int]:
        """Longest cached page-aligned prefix of ``prompt_ids``.

        Returns ``(shared, partial, cached_len)``: ``shared`` is the
        list of full pages to map read-only (the caller must incref
        them), ``partial`` is ``(src_page, n_tokens)`` for a boundary
        page whose first ``n_tokens`` match (to copy into a private
        page), or None, and ``cached_len == page_size * len(shared) +
        n_tokens`` is the number of prompt tokens whose K/V is already
        cached (always <= t0 - 1).

        ``mutate=False`` skips the LRU ``last_use`` ticks — the
        ``probe`` read, identical traversal, zero side effects."""
        ps = self.page_size
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        t0 = prompt.size
        shared: List[int] = []
        m = 0
        while True:
            siblings = self._nodes.get(prompt[:m * ps].tobytes())
            if not siblings:
                break
            rest = prompt[m * ps:]
            full = None
            if rest.size > ps:
                for ent in siblings:
                    if np.array_equal(ent.tokens, rest[:ps]):
                        full = ent
                        break
            if full is not None:
                # whole page matches and the prompt continues past it
                if mutate:
                    full.last_use = self._tick()
                shared.append(full.page)
                m += 1
                continue
            # boundary page: the sibling with the longest common
            # leading run, capped so at least one prompt token is left
            # to recompute (its logits seed first-token sampling)
            lim = min(ps, rest.size, t0 - 1 - m * ps)
            best, best_n = None, 0
            for ent in siblings:
                n = 0
                while n < lim and ent.tokens[n] == rest[n]:
                    n += 1
                if n > best_n:
                    best, best_n = ent, n
            if best is not None:
                if mutate:
                    best.last_use = self._tick()
                return shared, (best.page, best_n), m * ps + best_n
            break
        return shared, None, m * ps

    def probe(self, prompt_ids) -> int:
        """READ-ONLY twin of ``match``: how many leading tokens of
        ``prompt_ids`` are cached right now. Touches NOTHING — no
        refcounts (it returns no pages to pin), no LRU clock ticks —
        so a fleet router may probe every replica per admission
        without perturbing any replica's eviction order
        (serve/router.py's cache-affinity read; asserted
        side-effect-free in tests/test_router.py). One traversal
        serves both callers (``match(..., mutate=False)``), so the
        affinity estimate can never drift from what admission will
        actually reuse."""
        return self.match(prompt_ids, mutate=False)[2]

    def insert(self, prompt_ids, pages, allocator: PageAllocator) -> int:
        """Publish the prompt's FULL pages (``pages[j]`` holds tokens
        ``[j*ps, (j+1)*ps)``); the index increfs each newly-published
        page. An existing sibling with the same content is kept (first
        writer wins — duplicate K/V pages earn no second entry).
        Returns the number of new entries."""
        ps = self.page_size
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        added = 0
        for j in range(prompt.size // ps):
            key = prompt[:j * ps].tobytes()
            toks = prompt[j * ps:(j + 1) * ps]
            siblings = self._nodes.setdefault(key, [])
            dup = next((e for e in siblings
                        if np.array_equal(e.tokens, toks)), None)
            if dup is not None:
                dup.last_use = self._tick()
                continue
            allocator.incref(pages[j])
            siblings.append(_PrefixEntry(
                page=int(pages[j]), tokens=toks.copy(), depth=j,
                last_use=self._tick()))
            added += 1
        return added

    def reclaimable(self, allocator: PageAllocator) -> int:
        """Pages that ``reclaim`` could return to the free list right
        now: entries whose page nobody but the index references."""
        return sum(1 for b in self._nodes.values() for e in b
                   if allocator.refcount(e.page) == 1)

    def _drop(self, key: bytes, ent: _PrefixEntry,
              allocator: PageAllocator, demote=None) -> int:
        """Remove one entry and its now-unreachable descendants (every
        entry under nodes whose key extends this entry's prefix).
        Returns pages actually returned to the free list — descendant
        pages still referenced by live slots merely lose the index's
        ref.

        ``demote(key, ent)`` (when given) is called for every entry
        whose page is ABOUT to go back to the free list — the victim
        AND each cascaded descendant — while the page is still live,
        so the caller can capture its payload into a lower cache tier
        before the KV is lost. Entries whose page survives through a
        live slot's reference are NOT demoted: their KV is still
        resident in HBM."""
        freed = 0
        child_prefix = key + ent.tokens.tobytes()
        for k in [k for k in self._nodes if k.startswith(child_prefix)]:
            for e in self._nodes.pop(k):
                if demote is not None and allocator.refcount(e.page) == 1:
                    demote(k, e)
                if allocator.decref(e.page):
                    freed += 1
        bucket = self._nodes[key]
        bucket.remove(ent)
        if not bucket:
            del self._nodes[key]
        if demote is not None and allocator.refcount(ent.page) == 1:
            demote(key, ent)
        if allocator.decref(ent.page):
            freed += 1
        return freed

    def reclaim(self, n: int, allocator: PageAllocator,
                demote=None) -> int:
        """Evict least-recently-used index-only entries until ``n``
        pages returned to the free list (or candidates run out).
        ``demote`` is threaded to ``_drop`` so an engine with cache
        tiers can capture every evicted page's payload."""
        freed = 0
        order = sorted(
            [(k, e) for k, b in self._nodes.items() for e in b],
            key=lambda kv: (kv[1].last_use, -kv[1].depth))
        for key, ent in order:
            if freed >= n:
                break
            bucket = self._nodes.get(key)
            if bucket is None or ent not in bucket:
                continue                      # cascaded away already
            if allocator.refcount(ent.page) != 1:
                continue                      # a live slot still maps it
            freed += self._drop(key, ent, allocator, demote)
        return freed

    def flush(self, allocator: PageAllocator) -> None:
        """Drop every entry (cached K/V is weight-dependent): pages held
        only by the index go back to the free list; pages still mapped
        by live slots survive through the slots' own references."""
        for bucket in self._nodes.values():
            for e in bucket:
                allocator.decref(e.page)
        self._nodes.clear()
        self.flushes += 1


# --------------------------------------------------------------------- #
# hierarchical cache tiers (host DRAM → disk) beneath the prefix index,
# as the JAX package's (host-side numpy; payload arrays are the pool's
# raw dtype or, for bf16 / float8 pools, their bits: uint16 / uint8)
#
# When LRU reclaim would DELETE an evicted-but-published page, the
# engine demotes its payload here instead: int8/fp8 codes plus the
# per-page amax for quantized pools, the raw-dtype page for unquantized
# ones. A later prefix probe that misses HBM but hits a tier re-admits
# the page by COPY into a freshly allocated page — host-side data
# movement through the engine's one promotion program, never a prefill
# recompute.
#
# A demoted page has NO page id and NO refcount: _TierEntry carries the
# payload itself, deliberately without a ``page`` field, so "free XOR
# live XOR demoted" is structural — the only way back into the page
# pool is ``KVTierStore.load`` + the engine's promote copy into a page
# the allocator just handed out. The store never touches a
# PageAllocator.
# --------------------------------------------------------------------- #

@dataclasses.dataclass(eq=False)        # identity semantics, like
class _TierEntry:                       # _PrefixEntry (ndarray fields)
    tokens: np.ndarray          # the page's token ids (full page)
    depth: int                  # page index within its prompt chain
    last_use: int
    nbytes: int                 # payload bytes (accounting unit)
    tier: str                   # "dram" | "disk"
    # DRAM payload (None once spilled to disk):
    k_payload: Optional[Tuple[np.ndarray, ...]]   # per-layer (H, ps, D)
    v_payload: Optional[Tuple[np.ndarray, ...]]
    kamax: Optional[np.ndarray]  # (L,) f32 page amax, quantized pools
    vamax: Optional[np.ndarray]
    crc: int                    # crc32 over the DRAM payload bytes
    step: Optional[int] = None  # manifest step id (disk tier only)
    pinned: bool = False        # admission in flight — not evictable


def payload_crc(k_payload, v_payload, kamax, vamax, seed: int = 0) -> int:
    """crc32 over one page payload's bytes, chained from ``seed`` —
    the ONE integrity primitive for KV bytes at rest and on the wire:
    tier entries checksum each page independently (seed 0), the page
    transport (serve/transport.py) chains page crcs through the whole
    capsule so a reordered, dropped, or substituted page breaks every
    later link, not just its own."""
    c = seed & 0xFFFFFFFF
    for arr in (*k_payload, *v_payload):
        c = zlib.crc32(np.ascontiguousarray(arr).tobytes(), c)
    for arr in (kamax, vamax):
        if arr is not None:
            c = zlib.crc32(np.ascontiguousarray(arr).tobytes(), c)
    return c


def payload_nbytes(k_payload, v_payload, kamax, vamax) -> int:
    """Wire/at-rest size of one page payload — the accounting unit
    behind tier byte budgets and capsule ``kv_migrated_bytes_total``
    (int8 codes + f32 scales ≈ 1/4 the raw-dtype bytes)."""
    n = sum(a.nbytes for a in (*k_payload, *v_payload))
    for arr in (kamax, vamax):
        if arr is not None:
            n += arr.nbytes
    return n


class KVTierStore:
    """Bounded host-DRAM pool of demoted prefix pages, spilling its own
    LRU overflow to a disk tier built on the checkpoint manifest's
    audited write path (crc32 per shard, write-to-tmp + atomic rename).

    Keys mirror ``PrefixIndex``: preceding-token-prefix bytes → sibling
    entries, so a tier lookup continues exactly where the HBM radix
    walk stopped. Only FULL pages are tiered (a boundary partial page
    is cheap to recompute and its COW copy needs the source resident).

    Integrity: every DRAM entry carries a crc32 of its payload,
    verified at promotion; the disk tier inherits the manifest's
    per-shard crc32. A failed check drops the entry and returns None —
    the engine falls back to recomputing prefill, loudly, never
    admitting bytes it cannot verify.

    Crash safety: tier contents are weight-dependent and process-
    lifetime. Construction wipes any step directories left under
    ``disk_dir`` by an earlier process (a kill mid-promotion or
    mid-demotion leaves either a committed-but-orphaned step or a
    ``.tmp`` — both stale by definition).

    ``kv_dtype`` names the payload's logical dtype for the disk tier's
    manifest (``"bfloat16"``, ``"float8_e4m3fn"``: the arrays are their
    bits), so a spilled page reloads bitwise without ``ml_dtypes``."""

    def __init__(self, page_size: int, dram_bytes: int,
                 disk_dir: Optional[str] = None,
                 disk_bytes: Optional[int] = None,
                 recorder=None, component: str = "engine",
                 kv_dtype: Optional[str] = None):
        from ..events import EventType, resolve_recorder
        self._EventType = EventType
        self.page_size = int(page_size)
        # the payload's logical dtype in the disk tier's manifest (bf16 /
        # float8 payloads are their bits); None: the arrays' own dtype
        self.kv_dtype = kv_dtype
        self.dram_bytes = int(dram_bytes)
        if self.dram_bytes < 0:
            raise MXNetError("kv tier dram_bytes must be >= 0")
        self.disk_dir = disk_dir
        self.disk_bytes = None if disk_bytes is None else int(disk_bytes)
        self.flight = resolve_recorder(recorder)
        self._component = component
        self._entries: Dict[bytes, List[_TierEntry]] = {}
        self._clock = 0
        self._dram_used = 0
        self._disk_used = 0
        self._disk_seq = 0
        # counters (mirrored into engine health_snapshot / metrics)
        self.demotions = 0          # HBM → DRAM admissions
        self.disk_demotions = 0     # DRAM → disk spills
        self.promotions = 0         # entries handed back for re-admission
        self.dropped = 0            # evicted off the bottom tier
        self.crc_failures = 0       # payload failed its integrity check
        self.disk_errors = 0        # disk tier write/read failed (OSError)
        self.flushes = 0
        # seam for fault injection (serve/chaos.py DiskFullDemotion)
        from ..checkpoint import manifest as _manifest
        self._manifest = _manifest
        self._write_step = _manifest.write_step
        if self.disk_dir is not None:
            self._wipe_disk_dir()

    # -- basics -------------------------------------------------------- #

    def __len__(self) -> int:
        return sum(len(b) for b in self._entries.values())

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def entries(self):
        """Read-only iteration seam: yields ``(key, entry)`` pairs.
        Used by the chaos harness (to pick a victim payload to corrupt)
        and by tests — NOT a license to mutate the store's accounting;
        structural changes go through ``put``/``remove``/``flush``."""
        for key, bucket in self._entries.items():
            for ent in bucket:
                yield key, ent

    def tier_bytes(self) -> Dict[str, int]:
        """Payload bytes resident per tier (the ``kv_tier_bytes``
        gauge's data source)."""
        return {"dram": self._dram_used, "disk": self._disk_used}

    # -- disk tier plumbing -------------------------------------------- #

    def _wipe_disk_dir(self):
        import shutil
        os.makedirs(self.disk_dir, exist_ok=True)
        for name in os.listdir(self.disk_dir):
            path = os.path.join(self.disk_dir, name)
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)

    def _spill_to_disk(self, key: bytes, ent: _TierEntry) -> bool:
        """DRAM → disk via the manifest's audited write path. Returns
        False (and drops the entry — plain eviction, loudly counted)
        when the disk tier is unconfigured or the write fails."""
        if self.disk_dir is None:
            return False
        k = np.stack([np.asarray(a) for a in ent.k_payload])
        v = np.stack([np.asarray(a) for a in ent.v_payload])
        step = self._disk_seq
        self._disk_seq += 1
        arrays = {"k": k, "v": v}
        if ent.kamax is not None:
            arrays["kamax"] = ent.kamax
            arrays["vamax"] = ent.vamax
        entries = {
            name: {"shape": tuple(arr.shape),
                   "dtype": (self.kv_dtype if name in ("k", "v") and
                             self.kv_dtype else str(arr.dtype)),
                   "spec": None,
                   "shards": [([[0, s] for s in arr.shape], arr)]}
            for name, arr in arrays.items()}
        meta = {"key_hex": key.hex(), "tokens": ent.tokens.tolist(),
                "depth": ent.depth, "crc": ent.crc}
        try:
            self._write_step(self.disk_dir, step, entries, meta=meta)
        except (OSError, MXNetError) as e:
            self.disk_errors += 1
            self.flight.emit(self._component,
                             self._EventType.CACHE_DEMOTE,
                             entity=f"tier:{key.hex()[:16]}",
                             tier="disk", ok=False, error=str(e)[:200])
            return False
        ent.tier = "disk"
        ent.step = step
        ent.k_payload = ent.v_payload = None
        ent.kamax = ent.vamax = None
        self._dram_used -= ent.nbytes
        self._disk_used += ent.nbytes
        self.disk_demotions += 1
        self.flight.emit(self._component, self._EventType.CACHE_DEMOTE,
                         entity=f"tier:{key.hex()[:16]}",
                         tier="disk", ok=True, nbytes=ent.nbytes,
                         depth=ent.depth)
        return True

    def _load_disk(self, key: bytes, ent: _TierEntry):
        try:
            arrays, meta = self._manifest.load_step(self.disk_dir,
                                                    ent.step)
        except MXNetError:
            self.crc_failures += 1
            return None
        except OSError:
            self.disk_errors += 1
            return None
        k = tuple(arrays["k"][i] for i in range(arrays["k"].shape[0]))
        v = tuple(arrays["v"][i] for i in range(arrays["v"].shape[0]))
        kamax = arrays.get("kamax")
        vamax = arrays.get("vamax")
        if payload_crc(k, v, kamax, vamax) != meta.get("crc"):
            self.crc_failures += 1
            return None
        return k, v, kamax, vamax

    def _delete_disk_step(self, ent: _TierEntry):
        import shutil
        if ent.step is None or self.disk_dir is None:
            return
        shutil.rmtree(self._manifest.step_dir(self.disk_dir, ent.step),
                      ignore_errors=True)

    # -- bounded eviction ---------------------------------------------- #

    def _lru(self, tier: str):
        cands = [(k, e) for k, b in self._entries.items() for e in b
                 if e.tier == tier and not e.pinned]
        if not cands:
            return None
        return min(cands, key=lambda kv: (kv[1].last_use, -kv[1].depth))

    def _enforce_bounds(self):
        """Spill DRAM overflow to disk, drop disk overflow entirely.
        Pinned entries (an admission is mid-promotion) never move —
        bounds may transiently overshoot while a chain is pinned."""
        while self._dram_used > self.dram_bytes:
            victim = self._lru("dram")
            if victim is None:
                break
            key, ent = victim
            if not self._spill_to_disk(key, ent):
                self._discard(key, ent)
                self.dropped += 1
        while (self.disk_bytes is not None
               and self._disk_used > self.disk_bytes):
            victim = self._lru("disk")
            if victim is None:
                break
            self._discard(*victim)
            self.dropped += 1

    def _discard(self, key: bytes, ent: _TierEntry):
        bucket = self._entries[key]
        bucket.remove(ent)
        if not bucket:
            del self._entries[key]
        if ent.tier == "dram":
            self._dram_used -= ent.nbytes
        else:
            self._disk_used -= ent.nbytes
            self._delete_disk_step(ent)

    # -- the tier API the engine drives -------------------------------- #

    def put(self, key: bytes, tokens, depth: int,
            k_payload, v_payload, kamax=None, vamax=None) -> bool:
        """Admit one demoted page's payload into the DRAM tier.
        Duplicate content under the same key refreshes the existing
        entry instead (first writer wins, like ``PrefixIndex.insert``).
        Returns True when a NEW entry was stored."""
        toks = np.asarray(tokens, np.int32).reshape(-1).copy()
        bucket = self._entries.setdefault(key, [])
        dup = next((e for e in bucket
                    if np.array_equal(e.tokens, toks)), None)
        if dup is not None:
            dup.last_use = self._tick()
            return False
        k_payload = tuple(np.asarray(a) for a in k_payload)
        v_payload = tuple(np.asarray(a) for a in v_payload)
        kamax = None if kamax is None else np.asarray(kamax, np.float32)
        vamax = None if vamax is None else np.asarray(vamax, np.float32)
        nbytes = sum(a.nbytes for a in (*k_payload, *v_payload))
        nbytes += sum(a.nbytes for a in (kamax, vamax) if a is not None)
        ent = _TierEntry(
            tokens=toks, depth=int(depth), last_use=self._tick(),
            nbytes=nbytes, tier="dram", k_payload=k_payload,
            v_payload=v_payload, kamax=kamax, vamax=vamax,
            crc=payload_crc(k_payload, v_payload, kamax, vamax))
        bucket.append(ent)
        self._dram_used += nbytes
        self.demotions += 1
        self._enforce_bounds()
        return True

    def match_chain(self, prompt_ids, start_page: int,
                    mutate: bool = True) -> List[Tuple[bytes,
                                                       _TierEntry]]:
        """Continue a prefix walk from page ``start_page`` (where the
        HBM index stopped) through the tiers: consecutive FULL-page
        matches only, each requiring the prompt to continue past the
        page (the last prompt token is always recomputed — its logits
        seed first-token sampling, exactly ``PrefixIndex.match``'s
        cap). Returns the ``(key, entry)`` chain, possibly empty."""
        ps = self.page_size
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        chain: List[Tuple[bytes, _TierEntry]] = []
        m = int(start_page)
        while True:
            siblings = self._entries.get(prompt[:m * ps].tobytes())
            if not siblings:
                break
            rest = prompt[m * ps:]
            if rest.size <= ps:
                break
            hit = next((e for e in siblings
                        if np.array_equal(e.tokens, rest[:ps])), None)
            if hit is None:
                break
            if mutate:
                hit.last_use = self._tick()
            chain.append((prompt[:m * ps].tobytes(), hit))
            m += 1
        return chain

    def probe(self, prompt_ids, start_page: int) -> int:
        """READ-ONLY twin of ``match_chain``: pages the tiers could
        re-admit, with zero side effects (no LRU ticks) — the router's
        second affinity axis."""
        return len(self.match_chain(prompt_ids, start_page,
                                    mutate=False))

    def pin(self, chain) -> None:
        """Protect a matched chain from eviction while its admission
        is in flight (demotions triggered by the SAME admission's
        reclaim must not spill or drop the pages it is promoting)."""
        for _, ent in chain:
            ent.pinned = True

    def unpin(self, chain) -> None:
        for _, ent in chain:
            ent.pinned = False
        self._enforce_bounds()

    def load(self, key: bytes, ent: _TierEntry):
        """Fetch one entry's payload for promotion, verifying its
        integrity: the DRAM crc32, or the manifest's per-shard crc plus
        the stored payload crc for a disk entry. Returns ``(k_payload,
        v_payload, kamax, vamax)`` or None — on ANY failure the entry
        is removed (its bytes are untrustworthy) and the caller must
        fall back to recomputing prefill."""
        if ent.tier == "dram":
            if payload_crc(ent.k_payload, ent.v_payload,
                            ent.kamax, ent.vamax) != ent.crc:
                self.crc_failures += 1
                self._discard(key, ent)
                return None
            return ent.k_payload, ent.v_payload, ent.kamax, ent.vamax
        out = self._load_disk(key, ent)
        if out is None:
            self._discard(key, ent)
        return out

    def remove(self, key: bytes, ent: _TierEntry) -> None:
        """Retire an entry whose page was just promoted back into the
        pool (it is live again — keeping the tier copy would violate
        free XOR live XOR demoted)."""
        self._discard(key, ent)

    def flush(self) -> None:
        """Drop every entry in every tier (cached K/V is weight-
        dependent: the engine flushes tiers on ``warm_start`` and
        quarantine, alongside the HBM prefix index)."""
        for key, bucket in list(self._entries.items()):
            for ent in list(bucket):
                self._discard(key, ent)
        self._entries.clear()
        self._dram_used = self._disk_used = 0
        self.flushes += 1

    def audit(self) -> Dict[str, int]:
        """Structural self-check, called from the engine's
        ``audit_pages``: byte accounting matches the entries, DRAM
        entries hold payloads and no step, disk entries the reverse,
        and the DRAM bound holds whenever nothing is pinned. Raises
        MXNetError on any violation; returns ``tier_bytes()``."""
        dram = disk = 0
        pinned = False
        for key, bucket in self._entries.items():
            for ent in bucket:
                pinned = pinned or ent.pinned
                if ent.tier == "dram":
                    if ent.k_payload is None or ent.step is not None:
                        raise MXNetError(
                            f"tier audit: dram entry {key.hex()[:16]} "
                            f"missing payload or carrying a disk step")
                    dram += ent.nbytes
                elif ent.tier == "disk":
                    if ent.k_payload is not None or ent.step is None:
                        raise MXNetError(
                            f"tier audit: disk entry {key.hex()[:16]} "
                            f"holding a payload or missing its step")
                    disk += ent.nbytes
                else:
                    raise MXNetError(f"tier audit: unknown tier "
                                     f"{ent.tier!r}")
        if dram != self._dram_used or disk != self._disk_used:
            raise MXNetError(
                f"tier audit: byte accounting drift (dram {dram} vs "
                f"{self._dram_used}, disk {disk} vs {self._disk_used})")
        if not pinned and self._dram_used > self.dram_bytes:
            raise MXNetError(
                f"tier audit: dram tier over budget with nothing "
                f"pinned ({self._dram_used} > {self.dram_bytes})")
        return self.tier_bytes()


def init_kv_pools(num_layers, num_pages, num_heads, page_size, head_dim,
                  dtype=torch.float32, device=None, quant=None):
    """Fresh zeroed (k_pool, v_pool) pairs, one per layer; ``quant`` (a
    ``KVQuantSpec``) makes them code pools of its payload dtype."""
    dt = dtype if quant is None else quant.dtype
    mk = lambda: torch.zeros(num_pages, num_heads, page_size, head_dim,
                             dtype=dt, device=device)
    return [(mk(), mk()) for _ in range(num_layers)]


# --------------------------------------------------------------------- #
# quantized pools: int8 / float8 codes in the same (P, H, ps, D) layout,
# plus ONE f32 absolute-max statistic per page per pool (``amax``, (P,)),
# from which the page's symmetric scale derives (``page_scales``). A
# page's scale only grows: a write that raises its amax requantizes the
# page's existing codes by old_scale / new_scale, then quantizes the new
# rows at the new scale. The engine owns the amax arrays on the host,
# resets a page's amax when the allocator hands the page out, and copies
# it with a copy-on-write page.
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class KVQuantSpec:
    """One quantized-KV flavour: the pool payload dtype and its
    saturation bound (int8: +-127; fp8_e4m3: +-448)."""
    name: str
    dtype: torch.dtype
    qmax: float


def kv_quant_spec(kv_quant) -> Optional[KVQuantSpec]:
    """Resolve an engine's ``kv_quant`` knob: None/'none' -> None
    (unquantized pools), 'int8' -> int8 codes, 'fp8_e4m3' ->
    ``torch.float8_e4m3fn`` codes."""
    if kv_quant is None or kv_quant == "none":
        return None
    if isinstance(kv_quant, KVQuantSpec):
        return kv_quant
    if kv_quant == "int8":
        return KVQuantSpec("int8", torch.int8, 127.0)
    if kv_quant == "fp8_e4m3":
        return KVQuantSpec("fp8_e4m3", torch.float8_e4m3fn, 448.0)
    raise MXNetError(f"kv_quant must be None|'int8'|'fp8_e4m3', got "
                     f"{kv_quant!r}")


def page_scales(amax, spec: KVQuantSpec):
    """(P,) per-page dequantization scales from the amax metadata."""
    return symmetric_scale(amax, spec.qmax)


def _raw(pool):
    """The pool's bytes for index reads and writes (float8 indexing is
    not implemented on every device; a byte view moves the same bits)."""
    return pool.view(torch.uint8) if pool.dtype.is_floating_point else pool


def payload_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a page payload from a pool of ``dtype``: the
    dtype itself (float32, float16, int8), or for bf16 and float8 the
    unsigned integer of their width holding their bits, so a payload
    moves bitwise through numpy and the disk tier."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    if dtype.is_floating_point and dtype.itemsize == 1:
        return np.dtype(np.uint8)
    return torch.empty((), dtype=dtype).numpy().dtype


def write_token_kv_q(pool, amax, new, pages, offsets, spec: KVQuantSpec):
    """Quantized twin of ``write_token_kv``: scatter one K (or V) row per
    entry into a code pool (in place) and grow the per-page scales.

    pool: (P, H, ps, D) codes; amax: (P,) f32 tensor; new: (N, H, D)
    float; pages/offsets: (N,) int64. Returns ``(pool, new_amax)``.

    Three phases, safe under duplicate page indices (the verify window's
    block write lands several rows in one page):
      1. scatter-max the rows' |max| into the amax (duplicates combine,
         and a NaN on either side propagates);
      2. requantize every TOUCHED page's codes by old / new scale —
         duplicate entries gather the same codes and scale, so they
         write identical pages whatever the scatter order;
      3. quantize the new rows at the final scale and scatter them to
         their (page, offset) cells."""
    a_n = new.float().abs().amax(dim=(1, 2))                     # (N,)
    new_amax = amax.scatter_reduce(0, pages, a_n, "amax")
    old_s = symmetric_scale(amax, spec.qmax)
    new_s = symmetric_scale(new_amax, spec.qmax)
    ratio = (old_s / new_s)[pages]                               # (N,)
    raw = _raw(pool)
    codes = raw[pages].view(pool.dtype)
    raw[pages] = _raw(requantize_symmetric(
        codes, ratio[:, None, None, None], spec.dtype, spec.qmax))
    q = quantize_symmetric(new, new_s[pages][:, None, None], spec.dtype,
                           spec.qmax)                            # (N, H, D)
    raw[pages, :, offsets] = _raw(q)
    return pool, new_amax


def write_block_kv_q(pool, amax, new, pages, offsets, spec: KVQuantSpec):
    """Quantized twin of ``write_block_kv``: a (S, W) block of rows
    flattened into ``write_token_kv_q``."""
    S, W, H, D = new.shape
    return write_token_kv_q(pool, amax, new.reshape(S * W, H, D),
                            pages.reshape(S * W), offsets.reshape(S * W),
                            spec)


def write_prompt_kv_q(pool, amax, kv, pages, spec: KVQuantSpec):
    """Quantized twin of ``write_prompt_kv``: a whole prompt's K (or V)
    into its pages with a FRESH per-page scale (prefill is a page's
    first write, so its amax is set, not grown). Dead entries index the
    null page, garbage by design. Returns ``(pool, new_amax)``."""
    n_pages = pages.shape[0]
    ps = pool.shape[2]
    paged = kv.float().reshape(n_pages, ps, kv.shape[1], kv.shape[2])
    a_p = paged.abs().amax(dim=(1, 2, 3))                        # (n_pages,)
    new_amax = amax.clone()
    new_amax[pages] = a_p
    s = symmetric_scale(a_p, spec.qmax)
    q = quantize_symmetric(paged, s[:, None, None, None], spec.dtype,
                           spec.qmax)
    _raw(pool)[pages] = _raw(q.permute(0, 2, 1, 3))   # (n_pages, H, ps, D)
    return pool, new_amax


def write_token_kv(pool, new, pages, offsets):
    """Scatter one K (or V) row per entry into the pool, IN PLACE.

    pool: (P, H, ps, D); new: (N, H, D); pages/offsets: (N,) int64
    tensors — entry n writes ``new[n]`` to ``pool[pages[n], :,
    offsets[n], :]``. Serves the decode step (one token per slot;
    inactive slots carry ``NULL_PAGE``) and chunked prefill (one row
    per chunk token; padded tokens carry ``NULL_PAGE``) — dead writes
    land in the null page, never read unmasked."""
    pool[pages, :, offsets] = new.to(pool.dtype)
    return pool


def write_block_kv(pool, new, pages, offsets):
    """Scatter a (S, W) block of rows into the pool, in place: entry
    (s, w) writes ``new[s, w]`` to ``pool[pages[s, w], :, offsets[s, w],
    :]`` (flattens into ``write_token_kv``)."""
    S, W, H, D = new.shape
    return write_token_kv(pool, new.reshape(S * W, H, D),
                          pages.reshape(S * W), offsets.reshape(S * W))


def write_prompt_kv(pool, kv, pages):
    """Scatter a whole prompt's K (or V) into its pages, in place.

    pool: (P, H, ps, D); kv: (Tpad, H, D) with Tpad == len(pages) * ps;
    pages: (n_pages,) int64 with dead entries NULL_PAGE — those
    whole-page writes land in the null page."""
    n_pages = pages.shape[0]
    ps = pool.shape[2]
    paged = kv.reshape(n_pages, ps, kv.shape[1], kv.shape[2]) \
        .permute(0, 2, 1, 3)                     # (n_pages, H, ps, D)
    pool[pages] = paged.to(pool.dtype)
    return pool
