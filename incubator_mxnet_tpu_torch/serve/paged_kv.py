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
           "write_token_kv_q", "write_prompt_kv_q", "write_block_kv_q"]


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
