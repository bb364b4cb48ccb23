"""Continuous-batching inference engine over the paged KV cache.

The port of ``incubator_mxnet_tpu/serve/engine.py``. Design:

  - The engine owns ``num_slots`` decode SLOTS. Occupancy (which slots
    are live, at what lengths, with what sampling params) is host data —
    numpy arrays shipped to the device each step. Prefill-insert and
    EOS-eviction are host-side edits of those arrays plus page-allocator
    bookkeeping.
  - The decode step, per layer: project the one new token per slot,
    write its K/V into each slot's tail page, then ragged paged
    attention (ops/ragged_attention.py — the CUDA decode kernel on the
    GPU) over exactly the live pages. Inactive slots ride along at
    length 0: they write to the null page, attend nothing (zero output
    by the masked-row contract), and their sampled token is discarded.
  - PREFIX CACHING (copy-on-write page sharing): a host-side radix index
    (``paged_kv.PrefixIndex``) remembers which pages hold which
    page-aligned prompt prefixes. Admission maps the longest cached
    prefix READ-ONLY into the slot's page table (refcounted), COPIES the
    boundary partial page into a private page, and only the suffix pays
    prefill compute.
  - CHUNKED PREFILL (``chunk_pages``): the prompt is processed in
    page-aligned chunks interleaved with decode under a per-step TOKEN
    BUDGET. Chunk queries attend the slot's populated pages plus the
    causal intra-chunk part (``ragged_prefill_attention`` — the CUDA
    chunked-prefill kernel on the GPU). The cache-hit suffix path uses
    the same chunk program even in monolithic mode.
  - Per-slot sampling: greedy or temperature, plus the sampling menu
    (serve/sampling.py). Every temperature draw comes from a
    ``torch.Generator`` seeded from the request's key and the SEQUENCE
    POSITION of the sampled token, so draws are reproducible per request
    and independent of occupancy and chunking.

The JAX engine's jit-once programs and buffer donation become eager
PyTorch here: the K/V pools are updated IN PLACE by every program
(decode, prefill, the COW page copy). Speculative decoding, quantized
KV pools, cache tiers, tp meshes, brownout, page transport and warm
restart are not ported yet; asking for them raises ``MXNetError``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import List, Optional, Union

import numpy as np
import torch

from ..base import MXNetError
from ..models.gpt import _lm_head, _mlp, _qkv_heads
from ..ops.attention import scaled_dot_product_attention as _sdpa
from ..ops.ragged_attention import (ragged_paged_attention,
                                    ragged_prefill_attention)
from .events import EventType, resolve_recorder, terminal_fields
from .outcomes import Outcome
from .paged_kv import (NULL_PAGE, PageAllocator, PrefixIndex,
                       init_kv_pools, write_prompt_kv, write_token_kv)
from .sampling import (SamplingParams, constrain_logits, grammar_mask,
                       match_stop)
from .slo import Tier, TierPolicy, resolve_tier_policies

__all__ = ["Request", "InferenceEngine", "Outcome", "Tier",
           "TierPolicy", "SamplingParams"]

_REQUEST_IDS = itertools.count(1)    # process-wide: ids never collide
                                     # across engines

_MASK64 = (1 << 64) - 1


def _draw_seed(key: int, position: int) -> int:
    """The generator seed for the draw at ``position`` of the stream
    keyed by ``key`` (splitmix64 of the pair)."""
    z = (int(key) * 0x9E3779B97F4A7C15 + int(position) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


@dataclasses.dataclass
class Request:
    """One generation request. ``temperature`` 0 = greedy; ``eos_id``
    < 0 disables EOS stopping (generation runs to max_new_tokens).
    ``deadline_s`` (seconds, relative to submit) bounds the request's
    total queue + serve time: past it the request is dropped from the
    queue or evicted mid-decode with outcome DEADLINE_EXPIRED (partial
    tokens are kept). ``seed`` pins the request's own sampling stream
    (temperature draws are then reproducible across engines, occupancy
    mixes and chunking); None lets the engine assign one. Every request
    submitted to the engine ends with ``outcome`` set to exactly one
    terminal Outcome; ``detail`` carries the cause for the failure
    outcomes and ``retry_after_s`` the backpressure hint on SHED.

    ``tier`` is the request's SLO priority class (serve/slo.py):
    LATENCY outranks STANDARD outranks BATCH in admission order, shed
    order and slot preemption (a LATENCY admission may reclaim a BATCH
    slot mid-decode — the preempted request re-queues and resumes from
    its emitted suffix under the same sampling key). ``request_id`` is a
    process-unique handle for ``engine.cancel``. ``sampling`` carries
    the sampling menu (serve/sampling.py)."""

    prompt_ids: np.ndarray
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: int = -1
    deadline_s: Optional[float] = None
    seed: Optional[int] = None
    tier: Tier = Tier.STANDARD
    request_id: Optional[int] = None
    sampling: Optional[SamplingParams] = None

    # filled in by the engine
    preemptions: int = 0
    token_ids: List[int] = dataclasses.field(default_factory=list)
    token_times: List[float] = dataclasses.field(default_factory=list)
    token_stamps: List[float] = dataclasses.field(default_factory=list)
    submit_time: Optional[float] = None
    finish_time: Optional[float] = None
    outcome: Optional[Outcome] = None
    detail: str = ""
    retry_after_s: Optional[float] = None
    _deadline_abs: Optional[float] = None
    _assigned_key: Optional[int] = None   # engine-drawn key, pinned at
                                          # first admission so a
                                          # preemption resume replays
                                          # the SAME sampling stream

    def __post_init__(self):
        self.prompt_ids = np.asarray(self.prompt_ids, np.int32).reshape(-1)
        if self.prompt_ids.size == 0:
            raise MXNetError("empty prompt")
        if self.max_new_tokens < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise MXNetError("deadline_s must be > 0 (or None)")
        if isinstance(self.tier, str):
            self.tier = Tier(self.tier)
        if not isinstance(self.tier, Tier):
            raise MXNetError(f"tier must be a serve.Tier, got "
                             f"{self.tier!r}")
        if self.sampling is not None:
            if not isinstance(self.sampling, SamplingParams):
                raise MXNetError(f"sampling must be a SamplingParams, "
                                 f"got {type(self.sampling).__name__}")
            if self.sampling.grammar is not None and self.eos_id < 0:
                raise MXNetError(
                    "grammar-constrained decoding requires eos_id >= 0 "
                    "(grammar completion is expressed through EOS)")
        if self.request_id is None:
            self.request_id = next(_REQUEST_IDS)


@dataclasses.dataclass
class _Slot:
    request: Request
    reserved_pages: int          # worst-case pages (admission guarantee)
    refs: List[int]              # pages this slot holds a refcount on
    row: np.ndarray              # (max_pages,) page row; installed into
                                 # the decode page table when prefill ends
    t0: int                      # attempt prompt length (prompt + tokens
                                 # emitted before a preemption resume)
    attempt_ids: np.ndarray      # the attempt prompt itself
    prefill_pos: int             # prompt tokens whose K/V is populated
    t_admit: float
    key: int = 0                 # the request's sampling-stream key
    stall_count: int = 0         # consecutive zero-progress steps
    grammar_state: object = None  # current DFA state (host data)
    menu_active: bool = False    # request carries LOGIT-touching params
    stop_tail: list = dataclasses.field(default_factory=list)

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < self.t0


class InferenceEngine:
    """Fixed-slot continuous-batching decode over a GPT-style model
    (models/gpt.py: word_embed / position_embed / blocks[i](ln1,
    attn.{qkv,proj}, ln2, ffn_*) / ln_f and a tied LM head).

    Runs on the model's device. ``num_pages``
    defaults to the worst case (every slot at max_len) so admission
    never stalls; a smaller pool trades admission concurrency for cache
    memory — admission control keeps it correct (a request is admitted
    only when its worst-case page count fits, counting pages reclaimable
    from the prefix index).

    ``prefix_cache`` (default on) enables copy-on-write prefix page
    sharing; ``chunk_pages`` (a power of two, default None = monolithic
    prefill) enables chunked prefill with at most ``token_budget``
    prompt tokens per engine step (default ``chunk_pages * page_size``).

    Resilience knobs — every request ends in one structured terminal
    ``Outcome``:

    - ``max_queue``: bounded admission queue; a submit beyond it is SHED
      with a ``retry_after_s`` hint;
    - ``max_queue_delay_s``: estimated-queue-delay admission limit (an
      EWMA of slot-residence times scales the backlog beyond today's
      free slots);
    - ``guard_nonfinite`` (default on): a slot whose logits go
      non-finite is quarantined and failed FAILED_NONFINITE;
    - ``watchdog_steps``: a slot making no progress (page-starved for
      its tail page) this many steps is evicted FAILED_UNSERVABLE;
    - ``max_slot_wall_s``: per-slot wall-clock cap (DEADLINE_EXPIRED);
    - ``stall_steps``: idle scheduler polls before an unadmittable queue
      head is failed FAILED_UNSERVABLE;
    - ``tier_policies``: {Tier: TierPolicy} overrides (serve/slo.py);
      ``max_preemptions`` bounds how often one request is preempted
      before a PREEMPTED terminal;
    - ``recorder``: the flight recorder (on by default; False disables,
      an existing FlightRecorder shares a timeline)."""

    def __init__(self, model, num_slots=8, page_size=16, max_len=None,
                 num_pages=None, dtype=None, prefix_cache=True, chunk_pages=None, token_budget=None,
                 max_queue=None, max_queue_delay_s=None,
                 guard_nonfinite=True, watchdog_steps=1024,
                 max_slot_wall_s=None, stall_steps=500,
                 tier_policies=None, max_preemptions=4,
                 recorder=None, component="engine", spec_k=0,
                 kv_quant=None, kv_tiers=None, mesh=None, brownout=None):
        for name, val, off in (("spec_k", spec_k, 0),
                               ("kv_quant", kv_quant, None),
                               ("kv_tiers", kv_tiers, None),
                               ("mesh", mesh, None),
                               ("brownout", brownout, None)):
            if val != off:
                raise MXNetError(f"{name}={val!r}: not ported to the "
                                 f"PyTorch engine yet")
        self.model = model
        self.device = model.device
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.max_len = int(max_len or model.max_length)
        if self.max_len > model.max_length:
            raise MXNetError(f"max_len {self.max_len} exceeds model "
                             f"max_length {model.max_length}")
        self.max_pages = -(-self.max_len // self.page_size)
        if num_pages is None:
            num_pages = 1 + self.num_slots * self.max_pages
        self.num_pages = int(num_pages)
        self._dtype = model.dtype if dtype is None else dtype

        self.chunk_pages = None
        if chunk_pages is not None:
            cp = int(chunk_pages)
            if cp < 1 or (cp & (cp - 1)):
                raise MXNetError(f"chunk_pages must be a power of two, "
                                 f"got {cp}")
            self.chunk_pages = cp
        self.token_budget = int(token_budget) if token_budget is not None \
            else (self.chunk_pages or self.max_pages) * self.page_size
        if self.chunk_pages is not None and \
                self.token_budget < self.chunk_pages * self.page_size:
            raise MXNetError(
                f"token_budget {self.token_budget} below one chunk "
                f"({self.chunk_pages * self.page_size} tokens) — a long "
                f"prompt could never make progress")

        H = model.num_heads
        D = model.units // H
        self._H, self._D = H, D
        pools = init_kv_pools(model.num_layers, self.num_pages, H,
                              self.page_size, D, self._dtype, self.device)
        self._kpools = [k for k, _ in pools]
        self._vpools = [v for _, v in pools]

        # host-side occupancy state — data shipped to the device
        S = self.num_slots
        V = model.vocab_size
        self._vocab = V
        self._page_table = np.zeros((S, self.max_pages), np.int32)
        self._lengths = np.zeros((S,), np.int32)
        self._temps = np.zeros((S,), np.float32)
        # the sampling menu's per-slot state (serve/sampling.py), reset
        # to exact-identity neutrals on slot free
        self._top_k = np.zeros((S,), np.int32)
        self._top_p = np.ones((S,), np.float32)
        self._rep_pen = np.ones((S,), np.float32)
        self._pres_pen = np.zeros((S,), np.float32)
        self._logit_bias = np.zeros((S, V), np.float32)
        self._tok_counts = np.zeros((S, V), np.int32)
        self._alloc = PageAllocator(self.num_pages)
        self._prefix = PrefixIndex(self.page_size) if prefix_cache \
            else None
        self._slots: List[Optional[_Slot]] = [None] * S
        self._queue: deque = deque()
        self._key_rng = np.random.default_rng(0)
        self._prefill_rr = 0

        # resilience state
        self.max_queue = None if max_queue is None else int(max_queue)
        self.max_queue_delay_s = max_queue_delay_s
        self.guard_nonfinite = bool(guard_nonfinite)
        self.watchdog_steps = int(watchdog_steps)
        self.max_slot_wall_s = max_slot_wall_s
        self.stall_steps = int(stall_steps)
        self.health: dict = {o.value: 0 for o in Outcome}
        self.health_by_tier: dict = {
            t.value: {o.value: 0 for o in Outcome} for t in Tier}
        self._ewma_service_s: Optional[float] = None

        self._tier_policies = resolve_tier_policies(tier_policies)
        self.max_preemptions = int(max_preemptions)
        self.preemptions = 0

        self.flight = resolve_recorder(recorder)
        self._component = str(component)

        self.stop_hits = 0
        self.constrained_requests = 0
        self.decode_steps = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_flushes = 0
        self.prefix_reclaimed_pages = 0
        self.max_step_prefill_tokens = 0

    # ------------------------------------------------------------- #
    # device programs (eager; pools updated in place)
    # ------------------------------------------------------------- #

    def _tensor(self, a, dtype=torch.long):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, dtype, non_blocking=True)

    def _menu_ops(self, rows):
        """Sampling-menu operands for the slots ``rows`` (device
        tensors), or None when none of them carries logit-touching
        params — the plain path, value-identical by construction."""
        if not any(self._slots[s] is not None and
                   self._slots[s].menu_active for s in rows):
            return None
        mask = np.ones((len(rows), self._vocab), bool)
        for i, s in enumerate(rows):
            slot = self._slots[s]
            sp = slot.request.sampling if slot is not None else None
            if sp is not None and sp.grammar is not None:
                mask[i] = grammar_mask(sp.grammar, slot.grammar_state,
                                       slot.request.eos_id)
        idx = np.asarray(rows)
        f32 = torch.float32
        return (self._tensor(self._tok_counts[idx], torch.int32),
                self._tensor(self._logit_bias[idx], f32),
                self._tensor(mask, torch.bool),
                self._tensor(self._top_k[idx], torch.int32),
                self._tensor(self._top_p[idx], f32),
                self._tensor(self._rep_pen[idx], f32),
                self._tensor(self._pres_pen[idx], f32))

    def _sample(self, logits, temps, keys, positions, menu):
        """One token per row of ``logits`` (N, V) f32: argmax at
        temperature 0, else a Gumbel-max draw over logits / T from a
        generator seeded by (request key, position of the sampled
        token). With the non-finite guard on, a row with any non-finite
        logit comes back sign-encoded (-t - 1). Returns host ints."""
        bad = ~torch.isfinite(logits).all(dim=-1)
        if menu is not None:
            counts, bias, mask, top_k, top_p, rep_pen, pres_pen = menu
            logits = constrain_logits(
                logits, self._tensor(temps, torch.float32), counts, bias,
                mask, top_k, top_p, rep_pen, pres_pen)
        tok = torch.argmax(logits, dim=-1)
        V = logits.shape[-1]
        for i, t in enumerate(temps):
            if t > 0:
                gen = torch.Generator(device=logits.device)
                gen.manual_seed(_draw_seed(keys[i], positions[i]))
                u = torch.rand(V, generator=gen, device=logits.device)
                noise = -torch.log(-torch.log(u))
                tok[i] = torch.argmax(
                    logits[i].float() / max(float(t), 1e-6) + noise)
        if self.guard_nonfinite:
            tok = torch.where(bad, -tok - 1, tok)
        return tok.tolist()

    @torch.no_grad()
    def _decode_program(self, tokens, table, lengths, live):
        """ONE decode step for every slot: embed the last token of each
        live slot, write its K/V at position ``lengths[s]``, run ragged
        paged attention, sample position ``lengths[s] + 1``. Dead slots
        (length 0) write to the null page and attend nothing. Returns
        the sign-encoded tokens (host list, one per slot)."""
        model = self.model
        S, ps = self.num_slots, self.page_size
        act = lengths > 0
        pos = lengths.astype(np.int64)
        page_idx = np.clip(pos // ps, 0, self.max_pages - 1)
        write_page = np.where(act, table[np.arange(S), page_idx], NULL_PAGE)
        host = np.stack([tokens.astype(np.int64),
                         np.minimum(pos, model.max_length - 1),
                         write_page, pos % ps])
        dev = self._tensor(host)
        tok_d, emb_pos, wpage, woff = dev[0], dev[1], dev[2], dev[3]
        table_d = self._tensor(table, torch.int32)
        eff_len = self._tensor(np.where(act, lengths + 1, 0), torch.int32)

        x = model.embed(tok_d[:, None], emb_pos[:, None])   # (S, 1, U)
        for i, blk in enumerate(model.blocks):
            q, k, v = _qkv_heads(blk.attn, blk.ln1(x))       # (S,1,H,D)
            kp = write_token_kv(self._kpools[i], k[:, 0], wpage, woff)
            vp = write_token_kv(self._vpools[i], v[:, 0], wpage, woff)
            out = ragged_paged_attention(
                q[:, 0].to(kp.dtype).contiguous(), kp, vp, table_d,
                eff_len)
            x = x + blk.attn.proj(out.to(x.dtype).reshape(S, 1,
                                                          model.units))
            x = x + _mlp(blk, x)
        logits = _lm_head(model, x)[:, 0]                    # (S, V)
        keys = [self._slots[s].key if s in live else 0 for s in range(S)]
        temps = [float(self._temps[s]) if s in live else 0.0
                 for s in range(S)]
        return self._sample(logits, temps, keys, (pos + 1).tolist(),
                            self._menu_ops(list(range(S))))

    @torch.no_grad()
    def _prefill_program(self, slot_idx: int) -> int:
        """Monolithic prompt forward for ONE slot: dense causal attention
        inside the prompt, K/V written into the slot's pages, the first
        generated token sampled at position t0."""
        slot = self._slots[slot_idx]
        model = self.model
        t0, ps = slot.t0, self.page_size
        n_pages = -(-t0 // ps)
        ids = self._tensor(slot.attempt_ids)[None]
        pos = torch.arange(t0, device=self.device)[None]
        pages = self._tensor(slot.row[:n_pages])
        pad = n_pages * ps - t0
        x = model.embed(ids, pos)
        for i, blk in enumerate(model.blocks):
            q, k, v = _qkv_heads(blk.attn, blk.ln1(x))       # (1,t0,H,D)
            write_prompt_kv(self._kpools[i],
                            torch.nn.functional.pad(k[0], (0, 0, 0, 0,
                                                           0, pad)), pages)
            write_prompt_kv(self._vpools[i],
                            torch.nn.functional.pad(v[0], (0, 0, 0, 0,
                                                           0, pad)), pages)
            out = _sdpa(q, k, v, causal=True)
            x = x + blk.attn.proj(out.reshape(1, t0, model.units))
            x = x + _mlp(blk, x)
        logits = _lm_head(model, x[:, t0 - 1:t0])[:, 0]      # (1, V)
        return self._sample(logits, [slot.request.temperature], [slot.key],
                            [t0], self._menu_ops([slot_idx]))[0]

    @torch.no_grad()
    def _chunk_program(self, slot_idx: int, start: int, n: int) -> int:
        """ONE prefill chunk of ONE slot: ``n`` prompt tokens at
        positions ``start + i``. Their K/V is written into the slot's
        pages, then each query attends the slot's populated paged prefix
        plus the causal intra-chunk part (``ragged_prefill_attention``).
        The last row's logits are sampled at position ``start + n`` — the
        host keeps the token only when this is the final chunk."""
        slot = self._slots[slot_idx]
        model = self.model
        ps = self.page_size
        pos = np.arange(start, start + n, dtype=np.int64)
        host = np.stack([slot.attempt_ids[start:start + n].astype(np.int64),
                         pos, slot.row[pos // ps].astype(np.int64),
                         pos % ps])
        dev = self._tensor(host)
        ids, pos_d, tpage, toff = dev[0], dev[1], dev[2], dev[3]
        row = self._tensor(slot.row, torch.int32)
        x = model.embed(ids[None], pos_d[None])
        for i, blk in enumerate(model.blocks):
            q, k, v = _qkv_heads(blk.attn, blk.ln1(x))       # (1,n,H,D)
            kp = write_token_kv(self._kpools[i], k[0], tpage, toff)
            vp = write_token_kv(self._vpools[i], v[0], tpage, toff)
            out = ragged_prefill_attention(q[0].to(kp.dtype).contiguous(),
                                           kp, vp, row, start, n)
            x = x + blk.attn.proj(out.to(x.dtype).reshape(1, n,
                                                          model.units))
            x = x + _mlp(blk, x)
        logits = _lm_head(model, x[:, n - 1:n])[:, 0]        # (1, V)
        return self._sample(logits, [slot.request.temperature], [slot.key],
                            [start + n], self._menu_ops([slot_idx]))[0]

    @torch.no_grad()
    def _copy_page(self, src: int, dst: int):
        """COW boundary copy: duplicate one page's K/V across every
        layer, so the cached partial page becomes this slot's private
        page (the cached original stays read-only for its sharers)."""
        for p in self._kpools + self._vpools:
            p[dst] = p[src]

    # ------------------------------------------------------------- #
    # host-side scheduler
    # ------------------------------------------------------------- #

    @property
    def active_count(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def _lazy_debt(self) -> int:
        """Pages promised at admission but not yet physically held."""
        return sum(s.reserved_pages - len(s.refs)
                   for s in self._slots if s is not None)

    @property
    def completed(self) -> int:
        return self.health[Outcome.EOS.value] + \
            self.health[Outcome.MAX_TOKENS.value] + \
            self.health[Outcome.STOP.value]

    @property
    def shed(self) -> int:
        return self.health[Outcome.SHED.value]

    @property
    def expired(self) -> int:
        return self.health[Outcome.DEADLINE_EXPIRED.value]

    @property
    def quarantined(self) -> int:
        return self.health[Outcome.FAILED_NONFINITE.value]

    @property
    def unservable(self) -> int:
        return self.health[Outcome.FAILED_UNSERVABLE.value]

    def _retry_hint(self) -> float:
        """Backoff hint for retryable terminals: the EWMA of observed
        slot-residence times, or a small default before calibration."""
        return self._ewma_service_s if self._ewma_service_s else 0.05

    def _record_terminal(self, request: Request, outcome: Outcome,
                         detail: str = "",
                         retry_after: Optional[float] = None):
        """The single point where a request becomes terminal — exactly
        once, with the health counters kept consistent; every retryable
        outcome carries a ``retry_after_s`` hint."""
        if request.outcome is not None:
            raise MXNetError(
                f"request already terminal ({request.outcome}) — "
                f"double-finish is an engine bug")
        if retry_after is None and outcome.retryable:
            retry_after = self._retry_hint()
        request.outcome = outcome
        request.detail = detail
        request.retry_after_s = retry_after
        request.finish_time = time.perf_counter()
        self.health[outcome.value] += 1
        self.health_by_tier[request.tier.value][outcome.value] += 1
        if self.flight.enabled:
            self.flight.emit(self._component, EventType.TERMINAL,
                             request_id=request.request_id,
                             **terminal_fields(request))

    def _tier_policy(self, tier: Tier) -> TierPolicy:
        return self._tier_policies[tier]

    def _observe_service(self, t_admit: float):
        """EWMA of slot-residence time (admit -> finish) of completed
        requests — the unit the queue-delay estimate multiplies."""
        served = time.perf_counter() - t_admit
        self._ewma_service_s = served if self._ewma_service_s is None \
            else 0.2 * served + 0.8 * self._ewma_service_s

    def _estimated_queue_delay(self, tier: Optional[Tier] = None) \
            -> Optional[float]:
        """Admission-delay estimate for a newly submitted request: the
        service generations ahead of it (requests of ``tier`` or higher
        priority; all when None) beyond today's free slots, times the
        residence EWMA. Zero when the queue fits the free slots; None
        until a first completion calibrates the EWMA."""
        if self._ewma_service_s is None:
            return None
        if tier is None:
            ahead = len(self._queue)
        else:
            ahead = sum(1 for q in self._queue
                        if q.tier.order <= tier.order)
        free = self.num_slots - self.active_count
        if ahead < free:
            return 0.0
        waves = (ahead - free) // self.num_slots + 1
        return waves * self._ewma_service_s

    def health_snapshot(self) -> dict:
        """A consistent, detached copy of the engine's health state."""
        return {
            "outcomes": dict(self.health),
            "outcomes_by_tier": {t: dict(d) for t, d in
                                 self.health_by_tier.items()},
            "queue_depth": len(self._queue),
            "queue_depth_by_tier": {
                t.value: sum(1 for q in self._queue if q.tier is t)
                for t in Tier},
            "active_slots": self.active_count,
            "free_slots": self.num_slots - self.active_count,
            "num_slots": self.num_slots,
            "ewma_service_s": self._ewma_service_s,
            "estimated_queue_delay_s": self._estimated_queue_delay(),
            "estimated_queue_delay_priority_s":
                self._estimated_queue_delay(Tier.STANDARD),
            "free_pages": self._alloc.free_count,
            "kv_dtype": str(self._kpools[0].dtype),
            "kv_pool_bytes": int(sum(
                k.nelement() * k.element_size() * 2
                for k in self._kpools)),
            "decode_steps": self.decode_steps,
            "prefix_hits": self.prefix_hits,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "stop_hits": self.stop_hits,
            "constrained_requests": self.constrained_requests,
            "preemptions": self.preemptions,
            "latency_hists": self.flight.hist_snapshot(),
        }

    def prefix_probe(self, prompt_ids) -> int:
        """READ-ONLY: how many leading tokens of ``prompt_ids`` the
        prefix index has cached right now (0 with the cache off)."""
        if self._prefix is None:
            return 0
        return int(self._prefix.probe(prompt_ids))

    def can_serve(self, total_positions: int) -> bool:
        """Could a request spanning ``total_positions`` (prompt +
        max_new_tokens) EVER be served by this engine?"""
        need = -(-total_positions // self.page_size)
        return total_positions <= self.max_len and \
            need <= self.num_pages - 1

    def withdraw(self, request: Request) -> bool:
        """Remove a still-QUEUED request without recording a terminal
        (the caller owns the outcome). Removal is by identity."""
        for i, q in enumerate(self._queue):
            if q is request:
                del self._queue[i]
                return True
        return False

    def _shed_one_below(self, tier: Tier) -> bool:
        """Overload drains the LOWEST tier first: shed the most recently
        queued request of the lowest-priority tier strictly below
        ``tier``. Returns True when one was shed."""
        victim = None
        for q in self._queue:
            if q.tier.order <= tier.order:
                continue
            if victim is None or q.tier.order >= victim.tier.order:
                victim = q
        if victim is None:
            return False
        self.withdraw(victim)
        self._record_terminal(
            victim, Outcome.SHED,
            f"displaced from the admission queue by a {tier.value} "
            f"submission under overload")
        return True

    def cancel(self, request: Union[Request, int],
               detail: str = "cancelled by client") -> bool:
        """Client cancellation from ANY live state to CANCELLED: a queued
        request leaves the queue, a slotted one is evicted with its
        pages reclaimed; partial tokens are kept. Accepts the Request or
        its ``request_id``. Returns False when the request is already
        terminal or unknown here."""
        if isinstance(request, Request) and request.outcome is not None:
            return False
        for i, q in enumerate(self._queue):
            if q is request or q.request_id == request:
                del self._queue[i]
                self._record_terminal(q, Outcome.CANCELLED, detail)
                return True
        for s in range(self.num_slots):
            slot = self._slots[s]
            if slot is not None and (slot.request is request or
                                     slot.request.request_id == request):
                self._evict(s, Outcome.CANCELLED, detail)
                return True
        return False

    def submit(self, request: Request) -> bool:
        """Admission-queue entry with load shedding. Returns True when
        the request was queued; False when it was refused — already
        terminal with SHED (queue bounds, ``retry_after_s`` set) or
        FAILED_UNSERVABLE (it could never be served). The request's
        ``TierPolicy`` may supply a default deadline, a per-tier queue
        bound and a per-tier delay limit; when the global bound is hit
        by a higher-tier submission the lowest queued tier is shed
        first."""
        request.submit_time = time.perf_counter()
        self.flight.emit(self._component, EventType.SUBMIT,
                         request_id=request.request_id,
                         tier=request.tier.value,
                         queue_depth=len(self._queue))
        pol = self._tier_policy(request.tier)
        if request.deadline_s is None and \
                pol.default_deadline_s is not None:
            request.deadline_s = float(pol.default_deadline_s)
        if request.deadline_s is not None:
            request._deadline_abs = request.submit_time + request.deadline_s
        total = int(request.prompt_ids.size) + request.max_new_tokens
        need = -(-total // self.page_size)
        if not self.can_serve(total):
            self._record_terminal(
                request, Outcome.FAILED_UNSERVABLE,
                f"request needs {total} positions / {need} pages but the "
                f"engine caps at max_len {self.max_len} / "
                f"{self.num_pages - 1} usable pages")
            return False
        if request.sampling is not None:
            err = request.sampling.validate_for(self.model.vocab_size,
                                                request.eos_id)
            if err is not None:
                self._record_terminal(request,
                                      Outcome.FAILED_UNSERVABLE, err)
                return False
        est = self._estimated_queue_delay(request.tier)
        if pol.max_queue is not None and \
                sum(1 for q in self._queue
                    if q.tier is request.tier) >= pol.max_queue:
            self._record_terminal(
                request, Outcome.SHED,
                f"{request.tier.value} queue at its tier depth limit "
                f"{pol.max_queue}",
                retry_after=est if est else 0.05)
            return False
        delay_limit = pol.max_queue_delay_s \
            if pol.max_queue_delay_s is not None else self.max_queue_delay_s
        if delay_limit is not None and est is not None \
                and est > delay_limit:
            self._record_terminal(
                request, Outcome.SHED,
                f"estimated queue delay {est:.3f}s exceeds "
                f"{delay_limit}s for tier {request.tier.value}",
                retry_after=est)
            return False
        if self.max_queue is not None and \
                len(self._queue) >= self.max_queue and \
                not self._shed_one_below(request.tier):
            self._record_terminal(
                request, Outcome.SHED,
                f"admission queue at depth limit {self.max_queue}",
                retry_after=est if est else 0.05)
            return False
        self._queue.append(request)
        return True

    def _finish_token(self, slot_idx: int, token: int,
                      dt: float) -> Optional[Outcome]:
        """Record one generated token; returns the success outcome when
        the request's own stopping condition hit, else None."""
        slot = self._slots[slot_idx]
        req = slot.request
        tok = int(token)
        req.token_ids.append(tok)
        req.token_times.append(dt)
        req.token_stamps.append(time.perf_counter())
        self._tok_counts[slot_idx, tok] += 1     # penalty history
        if req.eos_id >= 0 and tok == req.eos_id:
            return Outcome.EOS
        sp = req.sampling
        if sp is not None:
            if sp.grammar is not None:
                nxt = sp.grammar.advance(slot.grammar_state, tok)
                if nxt is not None:
                    slot.grammar_state = nxt
            if sp.stop_sequences:
                slot.stop_tail.append(tok)
                if len(slot.stop_tail) > sp.max_stop_len:
                    del slot.stop_tail[:-sp.max_stop_len]
                hit = match_stop(slot.stop_tail, sp.stop_sequences)
                if hit:
                    # the matched sequence is NOT part of the output
                    trim = min(hit, len(req.token_ids))
                    if trim:
                        del req.token_ids[-trim:]
                        del req.token_times[-trim:]
                        del req.token_stamps[-trim:]
                    self.stop_hits += 1
                    return Outcome.STOP
        if len(req.token_ids) >= req.max_new_tokens:
            return Outcome.MAX_TOKENS
        return None

    def _evict(self, slot_idx: int, outcome: Outcome, detail: str = ""):
        slot = self._slots[slot_idx]
        self._free_slot_state(slot_idx)
        if outcome.ok:
            self._observe_service(slot.t_admit)
        self._record_terminal(slot.request, outcome, detail)

    def _quarantine(self, slot_idx: int, detail: str):
        """Fail a poisoned slot (non-finite logits): evict it, never
        record its token, and flush the prefix index — a corrupt SHARED
        page would otherwise keep poisoning future cache hits."""
        self._evict(slot_idx, Outcome.FAILED_NONFINITE, detail)
        if self._prefix is not None and len(self._prefix):
            self._prefix.flush(self._alloc)
            self.prefix_flushes += 1

    def _expire_queue(self):
        """Drop QUEUED requests whose deadline passed before admission."""
        if not any(r._deadline_abs is not None for r in self._queue):
            return
        now = time.perf_counter()
        keep = deque()
        for req in self._queue:
            if req._deadline_abs is not None and now > req._deadline_abs:
                self._record_terminal(
                    req, Outcome.DEADLINE_EXPIRED,
                    f"deadline ({req.deadline_s}s) passed while queued")
            else:
                keep.append(req)
        self._queue = keep

    def _expire_slots(self):
        """Evict slots past their request deadline or the per-slot wall
        cap before spending another step on them (partial tokens
        kept)."""
        now = time.perf_counter()
        for s in range(self.num_slots):
            slot = self._slots[s]
            if slot is None:
                continue
            dl = slot.request._deadline_abs
            if dl is not None and now > dl:
                phase = "prefill" if slot.prefilling else "decode"
                self._evict(s, Outcome.DEADLINE_EXPIRED,
                            f"deadline ({slot.request.deadline_s}s) "
                            f"passed mid-{phase}")
                continue
            if self.max_slot_wall_s is not None and \
                    now - slot.t_admit > self.max_slot_wall_s:
                self._evict(s, Outcome.DEADLINE_EXPIRED,
                            f"per-slot wall cap {self.max_slot_wall_s}s "
                            f"exceeded")

    def _attempt_ids(self, req: Request) -> np.ndarray:
        """What a (re)admission prefills: the prompt plus every token
        already emitted (a preemption resume)."""
        if not req.token_ids:
            return req.prompt_ids
        return np.concatenate([req.prompt_ids,
                               np.asarray(req.token_ids, np.int32)])

    def _queue_head(self) -> Optional[Request]:
        """The earliest-submitted request of the highest-priority tier
        queued."""
        best = None
        for q in self._queue:
            if best is None or q.tier.order < best.tier.order:
                best = q
        return best

    def _preempt_candidate(self, tier: Tier) -> Optional[int]:
        """The slot a ``tier`` admission may reclaim: a live slot of a
        preemptible, strictly lower-priority tier — lowest tier first,
        fewest emitted tokens, smallest index."""
        if not self._tier_policy(tier).can_preempt:
            return None
        best, best_key = None, None
        for s, slot in enumerate(self._slots):
            if slot is None:
                continue
            vt = slot.request.tier
            if vt.order <= tier.order or \
                    not self._tier_policy(vt).preemptible:
                continue
            key = (-vt.order, len(slot.request.token_ids), s)
            if best_key is None or key < best_key:
                best, best_key = s, key
        return best

    def _free_slot_state(self, slot_idx: int):
        """Release a slot's pages and scrub its per-slot arrays."""
        slot = self._slots[slot_idx]
        self._alloc.free(slot.refs)          # refcounted: shared pages
        self._page_table[slot_idx, :] = NULL_PAGE  # survive via sharers
        self._lengths[slot_idx] = 0
        self._temps[slot_idx] = 0.0
        self._top_k[slot_idx] = 0
        self._top_p[slot_idx] = 1.0
        self._rep_pen[slot_idx] = 1.0
        self._pres_pen[slot_idx] = 0.0
        self._logit_bias[slot_idx, :] = 0.0
        self._tok_counts[slot_idx, :] = 0
        self._slots[slot_idx] = None

    def _preempt(self, slot_idx: int, detail: str = ""):
        """Reclaim a slot for a higher-tier admission: pages released,
        partial tokens kept, and — within ``max_preemptions`` — the
        request re-queued (deadlines stay anchored to the original
        submission); it resumes by prefilling prompt + emitted under the
        same sampling key. Past the budget it terminates PREEMPTED."""
        req = self._slots[slot_idx].request
        req.preemptions += 1
        self.preemptions += 1
        self._free_slot_state(slot_idx)
        self.flight.emit(self._component, EventType.PREEMPT,
                         request_id=req.request_id,
                         tier=req.tier.value, slot=slot_idx,
                         preemptions=req.preemptions, detail=detail)
        if req.preemptions > self.max_preemptions:
            self._record_terminal(
                req, Outcome.PREEMPTED,
                f"preempted {req.preemptions} times "
                f"(max_preemptions={self.max_preemptions}): {detail}")
        else:
            self.flight.emit(self._component, EventType.REQUEUE,
                             request_id=req.request_id,
                             cause="preemption",
                             preemptions=req.preemptions)
            self._queue.append(req)

    def _admit(self):
        """Priority admission into free slots, gated on worst-case
        pages; a tier that ``can_preempt`` may reclaim a preemptible
        lower-tier slot when no slot is free. The blocked priority head
        blocks the tiers at and below it."""
        while self._queue:
            req = self._queue_head()
            slot_idx = next((i for i in range(self.num_slots)
                             if self._slots[i] is None), None)
            if slot_idx is None:
                slot_idx = self._preempt_candidate(req.tier)
                if slot_idx is None:
                    return
                self._preempt(slot_idx,
                              f"slot reclaimed for a {req.tier.value} "
                              f"admission")
            if not self._try_admit(slot_idx, req):
                return

    def _try_admit(self, slot_idx: int, req: Request) -> bool:
        """Admit ``req`` into the free ``slot_idx`` if its worst-case
        pages fit (preempting lower-tier slots for pages when its tier
        may); False — request left queued, nothing pinned — otherwise.

        With the prefix cache on, the attempt prompt's longest cached
        page-aligned prefix is mapped copy-on-write (incref'd,
        read-only), the boundary partial page is copied, and only the
        suffix pays prefill. Pages held only by the index count as
        reclaimable budget (evicted LRU when the free list is short)."""
        ids = self._attempt_ids(req)
        t0 = int(ids.size)
        total = t0 + (req.max_new_tokens - len(req.token_ids))
        need = -(-total // self.page_size)
        prompt_pages = -(-t0 // self.page_size)

        shared: List[int] = []
        partial = None
        cached_len = 0
        if self._prefix is not None:
            self.prefix_lookups += 1
            shared, partial, cached_len = self._prefix.match(ids)
            for p in shared:                 # pin before any reclaim
                self._alloc.incref(p)
            if partial is not None:
                self._alloc.incref(partial[0])

        def _budget():
            n_new = need - len(shared)   # pages the free list owes
            avail = self._alloc.free_count - self._lazy_debt
            recl = self._prefix.reclaimable(self._alloc) \
                if self._prefix is not None else 0
            return n_new, avail, recl

        n_new, avail, recl = _budget()
        if avail + recl < n_new:
            # preempt for pages only when the optimistic bound (every
            # preemptible victim's refs freed) covers the deficit
            victim_pages = sum(
                len(s.refs) for s in self._slots
                if s is not None
                and s.request.tier.order > req.tier.order
                and self._tier_policy(s.request.tier).preemptible)
            if self._tier_policy(req.tier).can_preempt and \
                    avail + recl + victim_pages >= n_new:
                while avail + recl < n_new:
                    victim = self._preempt_candidate(req.tier)
                    if victim is None:
                        break
                    self._preempt(victim, f"pages reclaimed for a "
                                          f"{req.tier.value} admission")
                    n_new, avail, recl = _budget()
        if avail + recl < n_new:
            for p in shared:                 # unpin and wait
                self._alloc.decref(p)
            if partial is not None:
                self._alloc.decref(partial[0])
            return False
        if avail < n_new:
            self.prefix_reclaimed_pages += \
                self._prefix.reclaim(n_new - avail, self._alloc)
        if cached_len:
            self.prefix_hits += 1
            self.prefix_hit_tokens += cached_len

        self.withdraw(req)
        priv = [self._alloc.alloc()
                for _ in range(prompt_pages - len(shared))]
        row = np.zeros((self.max_pages,), np.int32)
        row[:len(shared)] = shared
        row[len(shared):prompt_pages] = priv
        # per-request sampling key: pinned by Request.seed, else drawn
        # once and REMEMBERED so a preemption resume keeps the stream
        if req.seed is not None:
            skey = int(req.seed)
        elif req._assigned_key is not None:
            skey = req._assigned_key
        else:
            skey = int(self._key_rng.integers(0, 1 << 62))
            req._assigned_key = skey
        slot = _Slot(req, reserved_pages=need,
                     refs=list(shared) + priv, row=row, t0=t0,
                     attempt_ids=ids, prefill_pos=cached_len,
                     t_admit=time.perf_counter(), key=skey)
        self._slots[slot_idx] = slot
        # decode-invisible until prefill completes
        self._page_table[slot_idx, :] = NULL_PAGE
        self._lengths[slot_idx] = 0
        self._temps[slot_idx] = 0.0
        self._restore_stream_state(slot_idx, slot)
        if partial is not None:
            # COW: the boundary page becomes a private copy
            self._copy_page(partial[0], int(row[len(shared)]))
            self._alloc.decref(partial[0])
        self.flight.emit(
            self._component, EventType.ADMIT,
            request_id=req.request_id, tier=req.tier.value,
            slot=slot_idx, t0=t0, cached_len=cached_len,
            queue_delay_s=(slot.t_admit - req.submit_time
                           if req.submit_time is not None else None))

        if self.chunk_pages is None:
            # monolithic mode: prefill to completion here; a cache hit
            # runs the chunk program over the suffix
            if cached_len == 0:
                self._dense_prefill(slot_idx)
            else:
                while (self._slots[slot_idx] is slot and
                       slot.prefilling):
                    self._run_chunk(slot_idx)
        return True

    def _restore_stream_state(self, slot_idx: int, slot: _Slot):
        """Derive a slot's sampling-menu state from its attempt ids: knob
        vectors, bias row, the token-count table over the full attempt
        history, and (from the GENERATED part only) the grammar state
        and stop-sequence window, so a resume samples as the unbroken
        run would."""
        req = slot.request
        ids = slot.attempt_ids
        self._tok_counts[slot_idx] = np.bincount(
            ids, minlength=self._vocab)[:self._vocab]
        sp = req.sampling
        slot.menu_active = sp is not None and not sp.logits_neutral
        if sp is not None:
            self._top_k[slot_idx] = sp.top_k
            self._top_p[slot_idx] = sp.top_p
            self._rep_pen[slot_idx] = sp.repetition_penalty
            self._pres_pen[slot_idx] = sp.presence_penalty
            if sp.logit_bias:
                for t, b in sp.logit_bias.items():
                    self._logit_bias[slot_idx, t] = b
            gen = [int(t) for t in ids[req.prompt_ids.size:]]
            if sp.grammar is not None:
                self.constrained_requests += 1
                st = sp.grammar.start()
                for t in gen:
                    nxt = sp.grammar.advance(st, t)
                    if nxt is None:
                        break
                    st = nxt
                slot.grammar_state = st
            if sp.stop_sequences and sp.max_stop_len > 1:
                slot.stop_tail = gen[-(sp.max_stop_len - 1):]

    def _dense_prefill(self, slot_idx: int):
        """Monolithic prompt prefill."""
        slot = self._slots[slot_idx]
        req = slot.request
        t_start = time.perf_counter()
        tok = self._prefill_program(slot_idx)
        slot.prefill_pos = slot.t0
        self.flight.emit(self._component, EventType.PREFILL_CHUNK,
                         request_id=req.request_id, ts=t_start,
                         slot=slot_idx, start=0, n=slot.t0,
                         dur_s=time.perf_counter() - t_start)
        if tok < 0:                          # sign-encoded guard flag
            self._quarantine(slot_idx, "non-finite logits in prefill")
            return
        self._finish_prefill(slot_idx, tok)

    def _run_chunk(self, slot_idx: int) -> int:
        """Process ONE prefill chunk (``chunk_pages * page_size`` tokens,
        or the whole suffix in monolithic mode); returns the number of
        prompt tokens processed."""
        slot = self._slots[slot_idx]
        req = slot.request
        t_start = time.perf_counter()
        start = slot.prefill_pos
        remaining = slot.t0 - start
        n = remaining if self.chunk_pages is None else \
            min(remaining, self.chunk_pages * self.page_size)
        tok = self._chunk_program(slot_idx, start, n)
        slot.prefill_pos = start + n
        self.flight.emit(self._component, EventType.PREFILL_CHUNK,
                         request_id=req.request_id, ts=t_start,
                         slot=slot_idx, start=start, n=n,
                         dur_s=time.perf_counter() - t_start)
        if tok < 0:                          # sign-encoded guard flag
            # poisoned mid-prompt: fail now (the prompt's pages must
            # never reach the prefix index)
            self._quarantine(slot_idx, "non-finite logits in prefill "
                                       f"chunk at {start}")
            return n
        if not slot.prefilling:
            self._finish_prefill(slot_idx, tok)
        return n

    def _finish_prefill(self, slot_idx: int, tok: int):
        """Prompt fully populated: make the slot decode-visible, publish
        its full prompt pages into the prefix index, and record the
        first generated token."""
        slot = self._slots[slot_idx]
        self._page_table[slot_idx, :] = slot.row
        self._lengths[slot_idx] = slot.t0
        self._temps[slot_idx] = slot.request.temperature
        if self._prefix is not None:
            self._prefix.insert(slot.attempt_ids, slot.row, self._alloc)
        done = self._finish_token(slot_idx, tok,
                                  time.perf_counter() - slot.t_admit)
        if done is not None:
            self._evict(slot_idx, done)

    def _advance_prefill(self) -> int:
        """Chunked-prefill scheduler: round-robin one chunk at a time
        over prefilling slots, never exceeding ``token_budget`` prompt
        tokens per engine step. Returns tokens processed."""
        budget = self.token_budget
        spent = 0
        progressed = True
        while budget > 0 and progressed:
            progressed = False
            pf = [s for s in range(self.num_slots)
                  if self._slots[s] is not None
                  and self._slots[s].prefilling]
            if not pf:
                break
            for k in range(len(pf)):
                s = pf[(self._prefill_rr + k) % len(pf)]
                slot = self._slots[s]
                if slot is None or not slot.prefilling:
                    continue
                nxt = min(slot.t0 - slot.prefill_pos,
                          self.chunk_pages * self.page_size)
                if nxt > budget:
                    continue
                n = self._run_chunk(s)
                budget -= n
                spent += n
                progressed = True
            self._prefill_rr += 1
        self.max_step_prefill_tokens = max(self.max_step_prefill_tokens,
                                           spent)
        return spent

    def _ensure_tail_pages(self) -> List[int]:
        """Lazily allocate the page each decode-ready slot's next write
        position needs — where cache memory tracks live tokens. A slot
        whose tail page cannot be allocated (pool starved even after
        reclaiming prefix retention) is STALLED: it sits this step out
        (masked to length 0 with a NULL page row) and the watchdog
        evicts it FAILED_UNSERVABLE after ``watchdog_steps``."""
        ps = self.page_size
        stalled: List[int] = []
        for s in range(self.num_slots):
            slot = self._slots[s]
            if slot is None or slot.prefilling:
                continue
            pi = int(self._lengths[s]) // ps
            if self._page_table[s, pi] == NULL_PAGE:
                if self._alloc.free_count == 0 and \
                        self._prefix is not None:
                    self.prefix_reclaimed_pages += \
                        self._prefix.reclaim(1, self._alloc)
                if self._alloc.free_count == 0:
                    slot.stall_count += 1
                    if slot.stall_count > self.watchdog_steps:
                        self._evict(s, Outcome.FAILED_UNSERVABLE,
                                    f"watchdog: tail page starved for "
                                    f"{slot.stall_count} steps")
                    else:
                        stalled.append(s)
                    continue
                page = self._alloc.alloc()
                self._page_table[s, pi] = page
                slot.row[pi] = page
                slot.refs.append(page)
            slot.stall_count = 0
        return stalled

    def step(self) -> int:
        """Enforce deadlines, admit, advance chunked prefill under the
        token budget, then run ONE decode step for all decode-ready
        slots (each advances one token). Returns the number of slots
        that advanced."""
        self._expire_queue()
        self._expire_slots()
        self._admit()
        if self.chunk_pages is not None:
            self._advance_prefill()
        stalled = self._ensure_tail_pages()
        live = [s for s in range(self.num_slots)
                if self._slots[s] is not None
                and not self._slots[s].prefilling and s not in stalled]
        if not live:
            return 0
        tokens = np.zeros((self.num_slots,), np.int32)
        for s in live:
            tokens[s] = self._slots[s].request.token_ids[-1]
        lengths = self._lengths.copy()
        table = self._page_table.copy()
        for s in stalled:                    # decode-invisible this step
            lengths[s] = 0
            table[s, :] = NULL_PAGE
        t_start = time.perf_counter()
        # the one designed host readback per step: the sampled tokens
        emitted = self._decode_program(tokens, table, lengths, live)
        for s in live:
            self._lengths[s] += 1
        dt = time.perf_counter() - t_start
        self.decode_steps += 1
        self.flight.emit(self._component, EventType.DECODE_STEP,
                         ts=t_start, step=self.decode_steps, width=1,
                         live=len(live), dur_s=dt)
        for s in live:
            if emitted[s] < 0:               # sign-encoded guard flag
                self._quarantine(s, "non-finite logits in decode")
                continue
            done = self._finish_token(s, emitted[s], dt)
            if done is not None:
                self._evict(s, done)
        return len(live)

    # ------------------------------------------------------------- #
    # page accounting audit (tests / debugging)
    # ------------------------------------------------------------- #

    def audit_pages(self):
        """Assert the page invariant: every page 1..P-1 is EITHER on the
        free list (refcount 0) OR live, and a live page's refcount
        equals the slot mappings plus index entries (plus allocator
        holds) that reference it. Raises MXNetError on a leak or a
        double grant."""
        expect = [0] * self.num_pages
        for slot in self._slots:
            if slot is None:
                continue
            for p in slot.refs:
                expect[p] += 1
        if self._prefix is not None:
            for p in self._prefix.held_pages():
                expect[p] += 1
        for p in self._alloc.held:
            expect[p] += 1
        free = self._alloc._free
        free_set = set(free)
        if len(free_set) != len(free):
            raise MXNetError("page audit: duplicate pages on the free "
                             "list (double grant)")
        if NULL_PAGE in free_set:
            raise MXNetError("page audit: the null page is on the free "
                             "list")
        for p in range(1, self.num_pages):
            rc = self._alloc.refcount(p)
            if rc != expect[p]:
                raise MXNetError(
                    f"page audit: page {p} refcount {rc} != "
                    f"{expect[p]} references held (slots + index)")
            if (p in free_set) == (rc > 0):
                state = "free AND referenced (double grant)" if rc > 0 \
                    else "neither free nor referenced (leak)"
                raise MXNetError(f"page audit: page {p} is {state}")

    # ------------------------------------------------------------- #
    # not ported yet
    # ------------------------------------------------------------- #

    def _not_ported(self, what):
        raise MXNetError(f"{what} is not ported to the PyTorch engine yet")

    def capture_slot(self, request_id):
        self._not_ported("page transport (capture_slot)")

    def install_slot(self, *args, **kwargs):
        self._not_ported("page transport (install_slot)")

    def warm_start(self, *args, **kwargs):
        self._not_ported("warm_start")

    def save_checkpoint(self, *args, **kwargs):
        self._not_ported("save_checkpoint")

    # ------------------------------------------------------------- #
    # driving
    # ------------------------------------------------------------- #

    def shutdown(self, detail: str = "engine shutdown"):
        """Graceful stop: every in-flight and queued request becomes
        terminal SHED (pages reclaimed, partial tokens kept); the engine
        stays valid and idle."""
        for s in range(self.num_slots):
            if self._slots[s] is not None:
                self._evict(s, Outcome.SHED, detail)
        while self._queue:
            self._record_terminal(self._queue.popleft(), Outcome.SHED,
                                  detail)

    def _fail_starved_head(self, polls: int):
        """Bounded give-up on an unadmittable queue head while the
        engine is otherwise idle."""
        head = self._queue_head()
        self.withdraw(head)
        self._record_terminal(
            head, Outcome.FAILED_UNSERVABLE,
            f"page-starved: head of an idle engine for {polls} polls "
            f"(free={self._alloc.free_count})")

    def run(self, requests, arrival_times=None, poll_sleep=1e-3,
            before_step=None, after_step=None):
        """Drive ``requests`` until EVERY one is terminal. ``arrival_times``
        (seconds, relative to the call) gates submission; None submits
        everything up front. ``before_step(engine, i)`` /
        ``after_step(engine, i)`` bracket every scheduler iteration. A
        queue head that cannot be admitted while the engine is otherwise
        idle is failed FAILED_UNSERVABLE after ``stall_steps`` idle
        polls."""
        if arrival_times is None:
            for r in requests:
                self.submit(r)
            pending = []
        else:
            pending = sorted(zip(arrival_times, requests),
                             key=lambda p: p[0])
        t0 = time.perf_counter()
        stall = 0
        it = 0
        while pending or self._queue or self.active_count:
            now = time.perf_counter() - t0
            while pending and pending[0][0] <= now:
                self.submit(pending.pop(0)[1])
            if before_step is not None:
                before_step(self, it)
            n = self.step()
            if after_step is not None:
                after_step(self, it)
            it += 1
            if n > 0 or self.active_count:
                stall = 0
                continue
            if self._queue:
                stall += 1
                if stall > self.stall_steps:
                    self._fail_starved_head(stall)
                    stall = 0
                else:
                    time.sleep(poll_sleep)
            elif pending:
                stall = 0
                time.sleep(min(poll_sleep,
                               max(0.0, pending[0][0] - now)))
        return requests
