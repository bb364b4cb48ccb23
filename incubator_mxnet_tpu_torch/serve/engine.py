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
    (serve/sampling.py). Every temperature draw takes its uniform from a
    counter-based hash of the request's key and the SEQUENCE POSITION of
    the sampled token (``sampling.draw_uniform``), computed on the
    device over rows padded to one alignment (``sampling.row_aligned``),
    so draws are reproducible per request and independent of occupancy,
    chunking and the slot a request holds.
  - SPECULATIVE DECODING (``spec_k``): the host drafts up to K tokens
    per slot (n-gram prompt lookup, serve/draft.py, or ``draft_fn``);
    one (S, W = K + 1) verify step writes the window's K/V, scores it
    (``ragged_verify_attention`` — the CUDA verify kernel on the GPU)
    and accepts on the device: greedy slots the longest prefix matching
    the argmax chain, temperature slots by rejection sampling against
    the constrained distribution. A step where no slot drafted runs the
    W = 1 decode step itself.
  - QUANTIZED KV CACHE (``kv_quant='int8'|'fp8_e4m3'``): pages hold
    codes with one scale per page per pool; the host owns the per-page
    amax (reset when a page is allocated, copied with a COW page), the
    programs quantize at write time, and every ragged kernel
    dequantizes as it reads.

The JAX engine's jit-once programs become ``serve.program.StepProgram``
objects, each on the card one CUDA graph captured at its first use:
the decode / verify step per width (``decode_trace_count`` /
``verify_trace_count`` count the builds), the dense prompt prefill per
power-of-two page bucket and the prefill chunk per chunk bucket
(``prefill_trace_count``, ``prefill_trace_counts[("dense"|"chunk",
Tpad)]``), and the COW page copy (``copy_trace_count``). Sampling,
acceptance and the non-finite guard run inside them; per run the host
stages the inputs into one pinned buffer, copies it in, replays, and
reads back the tokens (and their counts) and the grown amax in one copy.
Positions, write pages and the chunk's span are data, read on the
device. The sampling menu's per-vocabulary rows stay resident on the
device, at neutral values except where a slot's menu is active. The K/V
pools are updated IN PLACE by every program.

Around the programs, the engine's remaining surface:

  - CACHE TIERS (``kv_tiers``): a prefix page the index evicts is demoted
    into host DRAM (``paged_kv.KVTierStore``, spilling to disk through
    ``checkpoint.manifest``) and re-admitted BY COPY when a prompt's walk
    continues into the tiers. ``gather_page`` (one page of every pool
    out, one replay and one readback) and the promotion (one page of
    every pool in, written in place) are one program each
    (``demote_trace_count`` / ``promote_trace_count``), shared with page
    transport;
  - PAGE TRANSPORT (``capture_slot`` / ``detach_slot`` /
    ``install_slot`` / ``release_capsule``; ``serve/transport.py`` owns
    the capsule): a decode-ready slot's pages move to another engine,
    whose next decode step takes the slot on from its last token;
  - ``warm_start(params=...)``: new weights ``copy_``-ed into the
    model's parameters, which the captured graphs hold by address, so no
    capture count moves; the prefix index and the tiers are flushed;
  - BROWNOUT (``brownout``): ``serve.slo.BrownoutController`` levels —
    speculation off, the prefill budget clamped to one chunk, BATCH
    admissions held — all host policy.

Anything that writes the pools or the parameters from outside a program
does so in place (``copy_``, index writes), never by rebinding: the
graphs hold them by address. The tp ``mesh`` and the checkpoint
manager's ``warm_start(manager=)`` / ``save_checkpoint`` /
``install_preemption`` are not ported yet; asking for them raises
``MXNetError``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..base import MXNetError
from ..models.convert import _to_tensor, gpt_param_names
from ..models.gpt import _lm_head, _mlp, _qkv_heads
from ..ops.attention import scaled_dot_product_attention as _sdpa
from ..ops.ragged_attention import (ragged_paged_attention,
                                    ragged_prefill_attention,
                                    ragged_verify_attention)
from .draft import make_ngram_drafter
from .events import EventType, resolve_recorder, terminal_fields
from .outcomes import Outcome
from .paged_kv import (NULL_PAGE, KVTierStore, PageAllocator, PrefixIndex,
                       _raw, init_kv_pools, kv_quant_spec, page_scales,
                       payload_dtype, write_block_kv, write_block_kv_q,
                       write_prompt_kv, write_prompt_kv_q, write_token_kv,
                       write_token_kv_q)
from .program import StepProgram
from .sampling import (_NEG_BIG, ACCEPT_STREAM, DRAW_STREAM,
                       SamplingParams, constrain_logits, draw_uniform,
                       grammar_mask, match_stop, row_aligned,
                       sample_inverse_cdf)
from .slo import (BrownoutController, Tier, TierPolicy,
                  resolve_tier_policies)

__all__ = ["Request", "InferenceEngine", "Outcome", "Tier",
           "TierPolicy", "SamplingParams"]

_REQUEST_IDS = itertools.count(1)    # process-wide: ids never collide
                                     # across engines

_MASK64 = (1 << 64) - 1


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _key64(key: int) -> int:
    """A sampling key's 64 low bits as a signed int64 value (the bits
    ``sampling.draw_uniform`` hashes)."""
    k = int(key) & _MASK64
    return k - (1 << 64) if k >> 63 else k


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
    the sampling menu (serve/sampling.py). ``drafted_tokens`` /
    ``accepted_tokens`` count this request's speculative drafts and the
    ones recorded. ``prompt_len`` marks a resume attempt's split: its
    first ``prompt_len`` ids are the true prompt, the rest tokens an
    earlier attempt emitted (a transported slot's continuation), so the
    grammar state and stop window derive from the generated part only."""

    prompt_ids: np.ndarray
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: int = -1
    deadline_s: Optional[float] = None
    seed: Optional[int] = None
    tier: Tier = Tier.STANDARD
    request_id: Optional[int] = None
    sampling: Optional[SamplingParams] = None
    prompt_len: Optional[int] = None

    # filled in by the engine
    preemptions: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0
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
        if self.prompt_len is not None:
            self.prompt_len = int(self.prompt_len)
            if not 0 < self.prompt_len <= self.prompt_ids.size:
                raise MXNetError(f"prompt_len {self.prompt_len} outside "
                                 f"(0, {self.prompt_ids.size}]")
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
    spec_streak: int = 0         # consecutive fully-rejected draft
                                 # windows (adaptive gating)

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < self.t0

    @property
    def attempt_last(self) -> int:
        """The token the next decode step feeds: the last one emitted, or
        for an installed slot that has emitted none here yet, the last of
        its attempt."""
        toks = self.request.token_ids
        return int(toks[-1]) if toks else int(self.attempt_ids[-1])


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
    - ``brownout``: True (the default controller, its delay reference
      ``max_queue_delay_s`` or 1 s) or a ``BrownoutController``: level 1
      turns speculation off, level 2 clamps the chunked-prefill budget
      to one chunk, level 3 holds BATCH admissions, each level left as
      pressure clears;
    - ``recorder``: the flight recorder (on by default; False disables,
      an existing FlightRecorder shares a timeline).

    Speculative decoding:

    - ``spec_k`` (default 0 = off): draft up to K tokens per slot per
      step and verify all K + 1 positions in one step; greedy output is
      the non-speculative output, temperature output keeps its
      distribution (rejection sampling). A step accepts 1..K+1 tokens
      per slot;
    - ``draft_fn``: ``(history, k) -> int32[0..k]`` proposer; default
      n-gram prompt lookup over the slot's own prompt + emitted tokens
      (``serve.draft.ngram_propose``) of max order ``draft_ngram``;
    - ``spec_patience`` / ``spec_probe_every``: a slot whose last
      ``spec_patience`` windows were ALL rejected stops drafting (0
      disables gating) and probes again every ``spec_probe_every``-th
      decode step; a step where no slot drafted runs the W = 1 decode
      step.

    ``kv_quant`` (None, 'int8' or 'fp8_e4m3') stores every KV page as
    codes with one symmetric scale per page per pool. A NaN scale makes
    the attention output non-finite, so the guard quarantines the
    slot.

    ``kv_tiers`` ({"dram_bytes": int, "disk_dir": str?, "disk_bytes":
    int?}; needs ``prefix_cache``) demotes the pages the prefix index
    evicts into host DRAM, spilling DRAM's overflow to disk, and
    re-admits them by copy: a payload is the page of every pool (the
    codes and their amax on a code pool), crc-checked at promotion, a
    failed check falling back to recompute."""

    def __init__(self, model, num_slots=8, page_size=16, max_len=None,
                 num_pages=None, dtype=None, prefix_cache=True,
                 chunk_pages=None, token_budget=None,
                 max_queue=None, max_queue_delay_s=None,
                 guard_nonfinite=True, watchdog_steps=1024,
                 max_slot_wall_s=None, stall_steps=500,
                 spec_k=0, draft_fn=None, draft_ngram=3,
                 spec_patience=2, spec_probe_every=64,
                 tier_policies=None, max_preemptions=4,
                 recorder=None, component="engine",
                 kv_quant=None, kv_tiers=None, mesh=None, brownout=None):
        if mesh is not None:
            raise MXNetError(f"mesh={mesh!r}: not ported to the PyTorch "
                             f"engine yet")
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
        # quantized pools: the per-page amax is HOST-owned metadata (one
        # (P,) f32 array per layer per pool), shipped to each program
        # that writes pages and pulled back after it
        self._kv_spec = kv_quant_spec(kv_quant)
        self.kv_quant = self._kv_spec.name if self._kv_spec else None
        pools = init_kv_pools(model.num_layers, self.num_pages, H,
                              self.page_size, D, self._dtype, self.device,
                              quant=self._kv_spec)
        self._kpools = [k for k, _ in pools]
        self._vpools = [v for _, v in pools]
        n_amax = model.num_layers if self._kv_spec is not None else 0
        self._kamax = [np.zeros((self.num_pages,), np.float32)
                       for _ in range(n_amax)]
        self._vamax = [np.zeros((self.num_pages,), np.float32)
                       for _ in range(n_amax)]

        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise MXNetError(f"spec_k must be >= 0, got {self.spec_k}")
        if self.spec_k >= self.max_len:
            raise MXNetError(f"spec_k {self.spec_k} >= max_len "
                             f"{self.max_len}")
        self._spec_w = self.spec_k + 1       # verify window (queries/slot)
        self._draft_fn = draft_fn if draft_fn is not None \
            else make_ngram_drafter(max_order=int(draft_ngram))
        self.spec_patience = int(spec_patience)
        self.spec_probe_every = max(1, int(spec_probe_every))

        # host-side occupancy state — data shipped to the device
        S = self.num_slots
        V = model.vocab_size
        self._vocab = V
        self._page_table = np.zeros((S, self.max_pages), np.int32)
        self._lengths = np.zeros((S,), np.int32)
        self._temps = np.zeros((S,), np.float32)
        self._keys = np.zeros((S,), np.int64)   # sampling keys (_key64)
        # the sampling menu's per-slot state (serve/sampling.py), reset
        # to exact-identity neutrals on slot free
        self._top_k = np.zeros((S,), np.int32)
        self._top_p = np.ones((S,), np.float32)
        self._rep_pen = np.ones((S,), np.float32)
        self._pres_pen = np.zeros((S,), np.float32)
        self._logit_bias = np.zeros((S, V), np.float32)
        self._tok_counts = np.zeros((S, V), np.int32)
        # ... and its device-resident twins the step programs read: the
        # (S, V) counts and bias rows, and per width the (S, W, V)
        # grammar mask, neutral except in the rows listed as dirty
        # (rewritten each step while a slot's menu / grammar is active,
        # and once more, to neutral, after it ends)
        self._menu_counts = torch.zeros((S, V), dtype=torch.int32,
                                        device=self.device)
        self._menu_bias = torch.zeros((S, V), dtype=torch.float32,
                                      device=self.device)
        self._menu_dirty: set = set()
        self._menu_mask: dict = {}           # W -> (S, W, V) bool
        self._mask_dirty: dict = {}          # W -> set of rows
        # the prefill programs' first-token grammar row: all True unless
        # the prefilling slot carries a grammar
        self._first_mask = torch.ones((1, 1, V), dtype=torch.bool,
                                      device=self.device)
        self._first_mask_dirty = False
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
        if brownout is True:
            brownout = BrownoutController(
                delay_ref=max_queue_delay_s or 1.0)
        self._brownout = brownout            # None | BrownoutController

        self.flight = resolve_recorder(recorder)
        self._component = str(component)
        if self._brownout is not None:
            # transitions land on this engine's event lane
            self._brownout.flight = self.flight

        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.spec_steps = 0                  # steps run K + 1 wide
        self.spec_gated_steps = 0            # steps gating kept narrow
        self.stop_hits = 0
        self.constrained_requests = 0
        self.decode_steps = 0
        self.decode_trace_count = 0          # W = 1 program builds
        self.verify_trace_count = 0          # W = spec_k + 1 builds
        self.prefill_trace_count = 0         # dense + chunk builds, total
        self.prefill_trace_counts: dict = {}  # ("dense"|"chunk", Tpad) -> n
        self.copy_trace_count = 0            # COW page copy builds
        self.promote_trace_count = 0         # page promotion builds
        self.demote_trace_count = 0          # page gather builds
        self._programs: dict = {}            # W -> StepProgram
        self._prefill_programs: dict = {}    # (kind, Tpad) -> StepProgram
        self._copy_prog: Optional[StepProgram] = None
        self._gather_prog: Optional[StepProgram] = None
        self._promote_prog: Optional[StepProgram] = None
        self._graph_pool = None              # shared by every program
        self.warm_restarts = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_flushes = 0
        self.prefix_reclaimed_pages = 0
        self.max_step_prefill_tokens = 0

        # cache tiers beneath the prefix index
        self._tiers = None
        if kv_tiers is not None:
            if self._prefix is None:
                raise MXNetError("kv_tiers requires prefix_cache=True "
                                 "(tiers hold evicted PREFIX pages)")
            cfg = dict(kv_tiers)
            if "dram_bytes" not in cfg:
                raise MXNetError("kv_tiers needs dram_bytes")
            self._tiers = KVTierStore(
                self.page_size, cfg.pop("dram_bytes"),
                disk_dir=cfg.pop("disk_dir", None),
                disk_bytes=cfg.pop("disk_bytes", None),
                recorder=self.flight, component=self._component,
                kv_dtype=str(self._kpools[0].dtype).replace("torch.", ""))
            if cfg:
                raise MXNetError(f"unknown kv_tiers keys: {sorted(cfg)}")
        self.tier_demotions = 0          # pages captured HBM -> DRAM
        self.tier_promotions = 0         # pages re-admitted by copy
        self.tier_hits = 0               # admissions a tier extended
        self.tier_hit_tokens = 0         # prompt tokens served by tiers
        self.tier_misses = 0             # tier consulted, nothing usable
        self.tier_crc_fallbacks = 0      # integrity check -> recompute

        # page transport (serve/transport.py): capsule traffic through
        # this engine, and the pages of detached slots held in custody
        # (keyed by request_id) until their transfer lands or falls back
        self.migrated_out_pages = 0
        self.migrated_in_pages = 0
        self.migrated_out_bytes = 0
        self.migrated_in_bytes = 0
        self._capsule_pages: Dict[int, List[int]] = {}

    # ------------------------------------------------------------- #
    # device programs (pools updated in place)
    # ------------------------------------------------------------- #

    def _tensor(self, a, dtype=torch.long):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, dtype, non_blocking=True)

    def _accept_emit(self, logits, tokens, draft_len, temps, keys,
                     positions, menu=None, act=None):
        """Sampling and draft acceptance for (S, W) columns, on the
        logits' device with no host loop and no host read: every input
        is a tensor there, and so are the outputs.

        ``logits`` (S, W, V) f32 scores the tokens at ``positions``
        (S, W) int64; ``tokens`` (S, W) int64: ``tokens[:, 0]`` is each
        slot's last token and ``tokens[:, 1:1 + draft_len]`` its drafts
        (column j + 1 proposed for ``positions[:, j]``); ``draft_len``
        (S,) int; ``temps`` (S,) f32; ``keys`` (S,) int64 sampling keys
        (``_key64``); ``menu`` the sampling menu's operands (counts,
        bias, mask, top_k, top_p, rep_pen, pres_pen), None for none;
        ``act`` (S,) bool. Greedy slots accept the longest draft prefix
        equal to the argmax chain — exactly what that many sequential
        decode steps emit. Temperature slots accept draft d with
        probability p(d) under the constrained, temperature-scaled
        distribution (the uniform of ``ACCEPT_STREAM``) and on rejection
        draw from the residual, p with d's mass removed
        (``sample_inverse_cdf`` with the uniform of ``DRAW_STREAM``);
        the column with no draft draws from p itself, so a 1-wide step
        samples exactly as plain decode. Both uniforms are pure
        functions of (key, position). An empty residual (one legal
        token) force-accepts. Penalty counts of column j include the
        drafts at columns <= j.

        With the guard on, a slot with a non-finite logit in a USED
        column (j <= draft_len) comes back sign-encoded: column 0 reads
        -t - 1. Returns ``(emitted (S, W), n_emit (S,))`` int64: columns
        [0, n_emit) are the slot's tokens, later ones dead."""
        S, W, V = logits.shape
        dev = logits.device
        vocab = torch.arange(V, device=dev)
        jj = torch.arange(W, device=dev)[None, :]
        dl = draft_len[:, None]
        used = jj <= dl
        bad = ((~torch.isfinite(logits).all(dim=-1)) & used).any(dim=-1)
        if menu is not None:
            counts, bias, mask, top_k, top_p, rep_pen, pres_pen = menu
            oh = (tokens[..., None] == vocab).to(torch.int32)
            win_counts = counts[:, None, :] + \
                oh.cumsum(dim=1, dtype=torch.int32) - oh[:, :1]
            logits = constrain_logits(
                logits, temps[:, None], win_counts, bias[:, None, :], mask,
                top_k[:, None], top_p[:, None], rep_pen[:, None],
                pres_pen[:, None])
        greedy = torch.argmax(logits, dim=-1)                 # (S, W)
        # column j tests the draft at tokens[:, j + 1] (the wrapped last
        # column is never valid: draft_len <= W - 1)
        d_next = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        valid = jj < dl
        hot = (temps > 0)[:, None]
        scaled = logits.float() / torch.clamp(temps, min=1e-6)[:, None,
                                                               None]
        logp = torch.log_softmax(row_aligned(scaled), dim=-1)[..., :V]
        p_next = logp.gather(-1, d_next[..., None])[..., 0]
        d_hot = d_next[..., None] == vocab                    # (S, W, V)
        res_empty = ~torch.where(d_hot, _NEG_BIG, logits).gt(
            _NEG_BIG / 2).any(dim=-1)
        k = keys[:, None]
        u_acc = draw_uniform(k, positions, ACCEPT_STREAM)
        accept = torch.where(hot, (torch.log(u_acc) < p_next) | res_empty,
                             d_next == greedy)
        res = torch.where(d_hot & valid[..., None], scaled + _NEG_BIG,
                          scaled)
        drawn = sample_inverse_cdf(res, draw_uniform(k, positions,
                                                     DRAW_STREAM))
        final = torch.where(hot, drawn, greedy)
        chain = torch.cumprod((accept & valid).to(torch.int32), dim=1)
        n_acc = chain.sum(dim=1)
        emitted = torch.where(jj < n_acc[:, None], d_next, final)
        n_emit = n_acc + 1
        if act is not None:
            n_emit = torch.where(act, n_emit, 0)
        if self.guard_nonfinite:
            emitted = torch.where(bad[:, None], -emitted - 1, emitted)
        return emitted, n_emit

    def _write_kv(self, i, k, v, pages, offs, amax, new_amax):
        """Write layer ``i``'s K/V: whole prompt pages when ``offs`` is
        None, else one row per (page, offset) entry — (N, H, D) rows, or
        a (S, W, H, D) block. A code pool grows its amax rows ``amax[i]``
        (K) and ``amax[L + i]`` (V) into ``new_amax``. Returns the pools
        and the per-page scales the attention reads (None for raw
        pools)."""
        spec = self._kv_spec
        L = len(self._kpools)
        if offs is None:
            write, write_q, where = write_prompt_kv, write_prompt_kv_q, ()
        elif k.dim() == 4:
            write, write_q, where = write_block_kv, write_block_kv_q, (offs,)
        else:
            write, write_q, where = write_token_kv, write_token_kv_q, (offs,)
        out, scales = [], []
        for row, pool, x in ((i, self._kpools[i], k),
                             (L + i, self._vpools[i], v)):
            if spec is None:
                out.append(write(pool, x, pages, *where))
                scales.append(None)
                continue
            pool, new_amax[row] = write_q(pool, amax[row], x, pages, *where,
                                          spec)
            out.append(pool)
            scales.append(page_scales(new_amax[row], spec))
        return out[0], out[1], scales[0], scales[1]

    def _attn_dtype(self, pool):
        """q's dtype for the ragged kernels: the pool's for a raw pool,
        the engine's for a code pool."""
        return self._dtype if self._kv_spec is not None else pool.dtype

    # ------------------------------------------------------------- #
    # the compiled-once programs (serve/program.py)
    # ------------------------------------------------------------- #

    def _new_program(self, body, ins, outs) -> StepProgram:
        """A program running ``body(engine, inputs, outputs)``, in the
        graph memory pool every program of the engine shares. It holds
        the engine weakly: a dropped engine (its pools, graphs and graph
        pool) is freed at once, not when the cycle collector next
        runs."""
        if self.device.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        eng = weakref.ref(self)
        return StepProgram(lambda i, o: body(eng(), i, o), ins, outs,
                           self.device, self._graph_pool)

    def _amax_fields(self):
        """The host amax metadata as a program field, K layers then V
        layers ((2 * num_layers, P) f32; none on raw pools): in and out
        of every program that writes pages."""
        L = len(self._kamax)
        return [("amax", (2 * L, self.num_pages), torch.float32)] if L \
            else []

    def _stage_amax(self, h):
        if self._kamax:
            L = len(self._kamax)
            h["amax"][:L] = self._kamax
            h["amax"][L:] = self._vamax

    def _take_amax(self, out):
        """Take host ownership back of the amax a program grew (part of
        its one readback)."""
        if self._kamax:
            L = len(self._kamax)
            self._kamax = list(out["amax"][:L].copy())
            self._vamax = list(out["amax"][L:].copy())

    # -- the decode / verify step, one program per width -------------- #

    def _step_fields(self, W: int):
        """The step's static (inputs, outputs) fields at width W."""
        S = self.num_slots
        i64, i32, f32 = torch.int64, torch.int32, torch.float32
        ins = [("tokens", (S, W), i64), ("lengths", (S,), i32),
               ("draft_len", (S,), i32), ("table", (S, self.max_pages), i32),
               ("keys", (S,), i64), ("temps", (S,), f32),
               ("top_k", (S,), i32), ("top_p", (S,), f32),
               ("rep_pen", (S,), f32), ("pres_pen", (S,), f32)]
        outs = [("emitted", (S, W), i64), ("n_emit", (S,), i64)]
        return ins + self._amax_fields(), outs + self._amax_fields()

    def _program(self, W: int) -> StepProgram:
        """The width-W step program, built at its first use (a CUDA
        graph capture on the card; counted in ``decode_trace_count`` /
        ``verify_trace_count``)."""
        prog = self._programs.get(W)
        if prog is None:
            ins, outs = self._step_fields(W)
            prog = self._new_program(
                lambda e, i, o: e._step_body(W, i, o), ins, outs)
            self._menu_mask[W] = torch.ones(
                (self.num_slots, W, self._vocab), dtype=torch.bool,
                device=self.device)
            self._mask_dirty[W] = set()
            self._programs[W] = prog
        if not prog.built:
            prog.build()
            if W == 1:
                self.decode_trace_count += 1
            else:
                self.verify_trace_count += 1
        return prog

    @torch.no_grad()
    def _step_body(self, W: int, i: dict, o: dict):
        """ONE decode/verify step for every slot, over the program's
        static device fields ``i`` and writing ``o``: W = tokens.shape[1]
        token positions per slot — the last token plus up to W - 1
        drafts — embedded, their K/V written at ``lengths[s] + j`` (the
        used columns; padded columns and dead slots, length 0, write to
        the null page), attended, accepted and guarded
        (``_accept_emit``). W = 1 is the plain decode step: the decode
        kernel; W > 1 the verify kernel. Reads nothing on the host."""
        model = self.model
        S, ps = self.num_slots, self.page_size
        lengths = i["lengths"].long()
        dl = i["draft_len"]
        act = lengths > 0
        jj = torch.arange(W, device=lengths.device)[None, :]
        pos = lengths[:, None] + jj                           # (S, W)
        page_idx = torch.clamp(pos // ps, 0, self.max_pages - 1)
        wpage = torch.where(act[:, None] & (jj <= dl[:, None]),
                            i["table"].long().gather(1, page_idx),
                            NULL_PAGE)
        woff = pos % ps
        emb_pos = torch.clamp(pos, max=model.max_length - 1)
        eff_len = torch.where(act, lengths + 1, 0).to(torch.int32)
        amax = i.get("amax")
        new_amax = [None] * (2 * len(self._kamax))

        x = model.embed(i["tokens"], emb_pos)                 # (S, W, U)
        for li, blk in enumerate(model.blocks):
            q, k, v = _qkv_heads(blk.attn, blk.ln1(x))        # (S,W,H,D)
            kp, vp, ks, vs = self._write_kv(li, k, v, wpage, woff, amax,
                                            new_amax)
            q = q.to(self._attn_dtype(kp))
            if W == 1:
                out = ragged_paged_attention(
                    q[:, 0].contiguous(), kp, vp, i["table"], eff_len,
                    k_scale=ks, v_scale=vs)[:, None]
            else:
                out = ragged_verify_attention(
                    q.contiguous(), kp, vp, i["table"], eff_len, dl,
                    k_scale=ks, v_scale=vs)
            x = x + blk.attn.proj(out.to(x.dtype).reshape(S, W,
                                                          model.units))
            x = x + _mlp(blk, x)
        if amax is not None:
            o["amax"].copy_(torch.stack(new_amax))
        logits = _lm_head(model, x)                           # (S, W, V)
        menu = (self._menu_counts, self._menu_bias, self._menu_mask[W],
                i["top_k"], i["top_p"], i["rep_pen"], i["pres_pen"])
        emitted, n_emit = self._accept_emit(
            logits, i["tokens"], dl, i["temps"], i["keys"], pos + 1, menu,
            act)
        o["emitted"].copy_(emitted)
        o["n_emit"].copy_(n_emit)

    def _stage_step(self, prog: StepProgram, tokens, draft_len, stalled):
        """Host staging of one step into the program's pinned inputs:
        stalled slots go dead (length 0, a null page row)."""
        h = prog.inp.host
        h["tokens"][...] = tokens
        h["draft_len"][...] = draft_len
        h["lengths"][...] = self._lengths
        h["table"][...] = self._page_table
        if stalled:
            h["lengths"][stalled] = 0
            h["table"][stalled] = NULL_PAGE
        h["keys"][...] = self._keys
        h["temps"][...] = self._temps
        h["top_k"][...] = self._top_k
        h["top_p"][...] = self._top_p
        h["rep_pen"][...] = self._rep_pen
        h["pres_pen"][...] = self._pres_pen
        self._stage_amax(h)

    def _sync_menu(self, W: int, drafts: dict, live):
        """Bring the device-resident menu rows up to date for this step:
        the counts and bias rows of every slot whose menu is active, the
        mask rows of every live grammar slot, and — once — neutral rows
        where either just ended. A step with no menu anywhere copies
        nothing."""
        active = {s for s, sl in enumerate(self._slots)
                  if sl is not None and sl.menu_active}
        rows = sorted(active | self._menu_dirty)
        if rows:
            idx = self._tensor(rows)
            self._menu_counts[idx] = self._tensor(self._tok_counts[rows],
                                                  torch.int32)
            self._menu_bias[idx] = self._tensor(self._logit_bias[rows],
                                                torch.float32)
        self._menu_dirty = active
        gram = self._grammar_rows(drafts, W, live)
        rows = sorted(set(gram) | self._mask_dirty[W])
        if rows:
            m = np.ones((len(rows), W, self._vocab), bool)
            for n, s in enumerate(rows):
                if s in gram:
                    m[n] = gram[s]
            self._menu_mask[W][self._tensor(rows)] = self._tensor(
                m, torch.bool)
        self._mask_dirty[W] = set(gram)

    # -- the prefill programs, one per (kind, bucket) ----------------- #

    def _prefill_program(self, kind: str, T: int) -> StepProgram:
        """The prefill program of ``kind`` "dense" (a whole prompt padded
        to T = bucket * page_size) or "chunk" (a chunk padded to T), built
        at its first use (a CUDA graph capture on the card; counted in
        ``prefill_trace_count`` and ``prefill_trace_counts[(kind, T)]``).
        Where the prompt or chunk sits, its pages, the slot, its sampling
        state and the weights are data to it."""
        key = (kind, T)
        prog = self._prefill_programs.get(key)
        if prog is None:
            i64, i32, f32 = torch.int64, torch.int32, torch.float32
            ins = [("ids", (T,), i64)]
            if kind == "chunk":
                ins += [("span", (2,), i32),
                        ("row", (self.max_pages,), i32)]
                body = InferenceEngine._chunk_body
            else:
                ins += [("t0", (1,), i64),
                        ("pages", (T // self.page_size,), i64)]
                body = InferenceEngine._dense_body
            ins += [("slot", (1,), i64), ("key", (1,), i64),
                    ("temp", (1,), f32), ("top_k", (1,), i32),
                    ("top_p", (1,), f32), ("rep_pen", (1,), f32),
                    ("pres_pen", (1,), f32)]
            prog = self._new_program(
                body, ins + self._amax_fields(),
                [("tok", (1,), i64)] + self._amax_fields())
            self._prefill_programs[key] = prog
        if not prog.built:
            prog.build()
            self.prefill_trace_count += 1
            self.prefill_trace_counts[key] = \
                self.prefill_trace_counts.get(key, 0) + 1
        return prog

    @torch.no_grad()
    def _dense_body(self, i: dict, o: dict):
        """Monolithic prompt forward for ONE slot, over ids (Tpad,)
        holding ``t0`` prompt tokens: dense attention under the mask
        ``pos_k <= pos_q and pos_k < t0`` (the prompt attends only
        itself), K/V written into the staged pages (padded entries are
        the null page; a code pool quantizes each page at a fresh scale
        over its whole rows, pad rows included, as the JAX program does),
        and the first token drawn from the last real row at position
        t0. Reads nothing on the host."""
        model = self.model
        ids, t0 = i["ids"], i["t0"]
        T = ids.shape[0]
        ar = torch.arange(T, device=ids.device)
        mask = ((ar[None, :] <= ar[:, None]) &
                (ar[None, :] < t0))[None, None]
        amax = i.get("amax")
        new_amax = [None] * (2 * len(self._kamax))
        x = model.embed(ids[None],
                        torch.clamp(ar, max=model.max_length - 1)[None])
        for li, blk in enumerate(model.blocks):
            q, k, v = _qkv_heads(blk.attn, blk.ln1(x))        # (1,T,H,D)
            self._write_kv(li, k[0], v[0], i["pages"], None, amax,
                           new_amax)
            out = _sdpa(q, k, v, mask=mask)
            x = x + blk.attn.proj(out.reshape(1, T, model.units))
            x = x + _mlp(blk, x)
        if amax is not None:
            o["amax"].copy_(torch.stack(new_amax))
        last = x[0].index_select(0, torch.clamp(t0 - 1, min=0))
        self._first_token(last, i, o, t0)

    @torch.no_grad()
    def _chunk_body(self, i: dict, o: dict):
        """ONE prefill chunk of ONE slot: ids (Cpad,) holding ``n_real``
        prompt tokens at positions ``start + j`` (``span = [start,
        n_real]``). Their K/V is written into the slot's pages (padded
        rows into the null page), then each query attends the slot's
        populated paged prefix plus the causal intra-chunk part
        (``ragged_prefill_attention`` with the span: the CUDA kernel reads
        it on the device). The last real row's token is drawn at position
        ``start + n_real``; the host keeps it only when this is the final
        chunk. Reads nothing on the host."""
        model = self.model
        ps = self.page_size
        ids, span, row = i["ids"], i["span"], i["row"]
        C = ids.shape[0]
        start, n_real = span[0].long(), span[1].long()
        jj = torch.arange(C, device=ids.device)
        pos = start + jj
        page_idx = torch.clamp(pos // ps, 0, self.max_pages - 1)
        tpage = torch.where(jj < n_real, row.long()[page_idx], NULL_PAGE)
        toff = pos % ps
        amax = i.get("amax")
        new_amax = [None] * (2 * len(self._kamax))
        x = model.embed(ids[None],
                        torch.clamp(pos, max=model.max_length - 1)[None])
        for li, blk in enumerate(model.blocks):
            q, k, v = _qkv_heads(blk.attn, blk.ln1(x))       # (1,C,H,D)
            kp, vp, ks, vs = self._write_kv(li, k[0], v[0], tpage, toff,
                                            amax, new_amax)
            out = ragged_prefill_attention(
                q[0].to(self._attn_dtype(kp)).contiguous(), kp, vp, row,
                span, k_scale=ks, v_scale=vs)
            x = x + blk.attn.proj(out.to(x.dtype).reshape(1, C,
                                                          model.units))
            x = x + _mlp(blk, x)
        if amax is not None:
            o["amax"].copy_(torch.stack(new_amax))
        last = x[0].index_select(0, torch.clamp(n_real - 1, min=0)[None])
        self._first_token(last, i, o, (start + n_real)[None])

    def _first_token(self, last, i: dict, o: dict, position):
        """A prefill program's generated token: ``_accept_emit`` at one
        column over the logits of ``last`` (1, U), the hidden state of
        the last real row, at ``position`` (1,) — its menu rows the
        resident ones of the staged slot, its grammar row
        ``_first_mask`` — into ``o["tok"]`` (sign-encoded by the
        guard)."""
        logits = _lm_head(self.model, last[None])            # (1, 1, V)
        zero = torch.zeros((1, 1), dtype=torch.long, device=logits.device)
        slot = i["slot"]
        menu = (self._menu_counts.index_select(0, slot),
                self._menu_bias.index_select(0, slot), self._first_mask,
                i["top_k"], i["top_p"], i["rep_pen"], i["pres_pen"])
        emitted, _ = self._accept_emit(logits, zero, zero[0], i["temp"],
                                       i["key"], position.view(1, 1), menu)
        o["tok"].copy_(emitted[:, 0])

    def _stage_dense(self, slot_idx: int) -> StepProgram:
        """The slot's whole prompt staged into the dense program of its
        power-of-two page bucket (built first if new); returns it."""
        slot = self._slots[slot_idx]
        t0, ps = slot.t0, self.page_size
        prompt_pages = -(-t0 // ps)
        bucket = min(_next_pow2(prompt_pages), self.max_pages)
        prog = self._prefill_program("dense", bucket * ps)
        h = prog.inp.host
        h["ids"][...] = 0
        h["ids"][:t0] = slot.attempt_ids
        h["t0"][0] = t0
        h["pages"][...] = NULL_PAGE
        h["pages"][:prompt_pages] = slot.row[:prompt_pages]
        self._stage_first_token(prog, slot_idx, kept=True)
        return prog

    def _stage_chunk(self, slot_idx: int, start: int, n: int) \
            -> StepProgram:
        """The slot's prompt tokens [start, start + n) staged into the
        chunk program of their power-of-two page bucket (built first if
        new), with the span the kernel reads; returns it."""
        slot = self._slots[slot_idx]
        bucket = min(_next_pow2(-(-n // self.page_size)), self.max_pages)
        Cpad = bucket * self.page_size
        if not 0 <= n <= Cpad or start < 0:
            raise MXNetError(f"prefill chunk: n_real {n} outside "
                             f"[0, {Cpad}] or start {start} < 0")
        prog = self._prefill_program("chunk", Cpad)
        h = prog.inp.host
        h["ids"][...] = 0
        h["ids"][:n] = slot.attempt_ids[start:start + n]
        h["span"][...] = (start, n)
        h["row"][...] = slot.row
        self._stage_first_token(prog, slot_idx, kept=start + n == slot.t0)
        return prog

    def _stage_first_token(self, prog: StepProgram, slot_idx: int,
                           kept: bool):
        """Stage the slot's sampling state and the amax into a prefill
        program's pinned inputs. When the token will be ``kept`` (a
        dense prefill, a final chunk), bring the resident menu rows of
        the slot and the first-token grammar row up to date first: an
        active menu's rows (marked dirty, so ``_sync_menu`` resets them
        once the menu ends), or neutral rows where a previous occupant's
        menu left them dirty."""
        slot = self._slots[slot_idx]
        h = prog.inp.host
        h["slot"][0] = slot_idx
        h["key"][0] = _key64(slot.key)
        h["temp"][0] = slot.request.temperature
        h["top_k"][0] = self._top_k[slot_idx]
        h["top_p"][0] = self._top_p[slot_idx]
        h["rep_pen"][0] = self._rep_pen[slot_idx]
        h["pres_pen"][0] = self._pres_pen[slot_idx]
        self._stage_amax(h)
        if not kept:
            return
        if slot.menu_active or slot_idx in self._menu_dirty:
            idx = self._tensor([slot_idx])
            self._menu_counts[idx] = self._tensor(
                self._tok_counts[slot_idx][None], torch.int32)
            self._menu_bias[idx] = self._tensor(
                self._logit_bias[slot_idx][None], torch.float32)
            if slot.menu_active:
                self._menu_dirty.add(slot_idx)
            else:
                self._menu_dirty.discard(slot_idx)
        sp = slot.request.sampling
        if sp is not None and sp.grammar is not None:
            self._first_mask[0, 0] = self._tensor(
                grammar_mask(sp.grammar, slot.grammar_state,
                             slot.request.eos_id), torch.bool)
            self._first_mask_dirty = True
        elif self._first_mask_dirty:
            self._first_mask.fill_(True)
            self._first_mask_dirty = False

    def _run_prefill(self, prog: StepProgram) -> int:
        """One copy in, one replay, one readback: the token (sign-encoded
        by the guard) and the grown amax."""
        out = prog.run()
        self._take_amax(out)
        return int(out["tok"][0])

    # -- the COW page copy, one program ------------------------------- #

    @torch.no_grad()
    def _copy_body(self, i: dict, o: dict):
        """Copy page ``pair[0]`` onto page ``pair[1]`` in every pool, in
        place (byte views: float8 indexing is not implemented on every
        device)."""
        src, dst = i["pair"][:1], i["pair"][1:]
        for p in self._kpools + self._vpools:
            raw = _raw(p)
            raw.index_copy_(0, dst, raw.index_select(0, src))

    def _copy_program(self) -> StepProgram:
        """The COW copy program, built at its first use (a CUDA graph
        capture on the card; counted in ``copy_trace_count``)."""
        prog = self._copy_prog
        if prog is None:
            prog = self._copy_prog = self._new_program(
                InferenceEngine._copy_body, [("pair", (2,), torch.int64)],
                [])
        if not prog.built:
            prog.build()
            self.copy_trace_count += 1
        return prog

    def _copy_page(self, src: int, dst: int):
        """COW boundary copy: duplicate one page's K/V across every
        layer, so the cached partial page becomes this slot's private
        page (the cached original stays read-only for its sharers): one
        replay of the copy program, whose readback orders the reuse of
        its pinned inputs. A code page carries its scale: the amax is
        page metadata, copied on the host."""
        prog = self._copy_program()
        prog.inp.host["pair"][...] = (src, dst)
        prog.run()
        for a in self._kamax + self._vamax:
            a[dst] = a[src]

    # -- the page gather and promotion, one program each -------------- #

    def _page_field(self):
        """The gather / promote programs' page field: page p of every K
        pool then every V pool, (2 L, H, ps, D) as the pools' bytes
        (``paged_kv._raw``), which a payload's numpy dtype views."""
        raw = _raw(self._kpools[0])
        return ("kv", (2 * len(self._kpools),) + tuple(raw.shape[1:]),
                raw.dtype)

    @torch.no_grad()
    def _gather_body(self, i: dict, o: dict):
        """Page ``page[0]`` of every pool into the output field."""
        for j, p in enumerate(self._kpools + self._vpools):
            o["kv"][j:j + 1].copy_(_raw(p).index_select(0, i["page"]))

    @torch.no_grad()
    def _promote_body(self, i: dict, o: dict):
        """The input field into page ``dst[0]`` of every pool, in
        place."""
        for j, p in enumerate(self._kpools + self._vpools):
            _raw(p).index_copy_(0, i["dst"], i["kv"][j:j + 1])

    def _gather_program(self) -> StepProgram:
        """The page gather program, built at its first use (a CUDA graph
        capture on the card; counted in ``demote_trace_count``)."""
        prog = self._gather_prog
        if prog is None:
            prog = self._gather_prog = self._new_program(
                InferenceEngine._gather_body, [("page", (1,), torch.int64)],
                [self._page_field()])
        if not prog.built:
            prog.build()
            self.demote_trace_count += 1
        return prog

    def _promote_program(self) -> StepProgram:
        """The page promotion program, built at its first use (a CUDA
        graph capture on the card; counted in ``promote_trace_count``)."""
        prog = self._promote_prog
        if prog is None:
            prog = self._promote_prog = self._new_program(
                InferenceEngine._promote_body,
                [("dst", (1,), torch.int64), self._page_field()], [])
        if not prog.built:
            prog.build()
            self.promote_trace_count += 1
        return prog

    def gather_page(self, page: int) -> tuple:
        """One page's payload: ``(k_payload, v_payload, kamax, vamax)``,
        per-layer (H, ps, D) numpy arrays of the pool's raw dtype or its
        codes (bf16 / float8 as their bits, ``paged_kv.payload_dtype``)
        and on a code pool the per-layer (L,) f32 amax, else None. One
        replay of the gather program and one readback, shared by tier
        demotion and page transport. The arrays are a copy of their own,
        never views of the pinned readback buffer (an entry outlives the
        next gather)."""
        prog = self._gather_program()
        prog.inp.host["page"][0] = page
        kv = prog.run()["kv"].view(
            payload_dtype(self._kpools[0].dtype)).copy()
        L = len(self._kpools)
        kamax = vamax = None
        if self._kamax:
            kamax = np.asarray([a[page] for a in self._kamax], np.float32)
            vamax = np.asarray([a[page] for a in self._vamax], np.float32)
        return tuple(kv[:L]), tuple(kv[L:]), kamax, vamax

    def _promote_page(self, k_payload, v_payload, kamax, vamax, dst: int):
        """Write one page payload (``gather_page``'s form) into page
        ``dst`` of every pool: staged into the promotion program's pinned
        input, one replay, whose readback orders the reuse of that input.
        A code page's amax is host metadata, set beside it."""
        prog = self._promote_program()
        h = prog.inp.host
        kv = h["kv"].view(payload_dtype(self._kpools[0].dtype))
        pages = list(k_payload) + list(v_payload)
        if len(pages) != kv.shape[0]:
            raise MXNetError(f"page payload of {len(pages)} arrays for "
                             f"{kv.shape[0]} pools")
        for j, a in enumerate(pages):
            a = np.asarray(a)
            if a.shape != kv.shape[1:] or a.dtype != kv.dtype:
                raise MXNetError(f"page payload {j}: {a.dtype}{a.shape} "
                                 f"!= the pool's {kv.dtype}{kv.shape[1:]}")
            kv[j] = a
        h["dst"][0] = dst
        prog.run()
        for l, a in enumerate(self._kamax):
            a[dst] = kamax[l]
        for l, a in enumerate(self._vamax):
            a[dst] = vamax[l]

    def _demote_entry(self, key: bytes, ent) -> None:
        """Capture an evicted prefix page's payload into the tiers before
        its page returns to the free list (``PrefixIndex.reclaim``'s
        ``demote`` callback)."""
        k, v, kamax, vamax = self.gather_page(ent.page)
        if self._tiers.put(key, ent.tokens, ent.depth, k, v, kamax, vamax):
            self.tier_demotions += 1
            self.flight.emit(self._component, EventType.CACHE_DEMOTE,
                             entity=f"tier:{key.hex()[:16]}",
                             tier="dram", depth=ent.depth)

    def _reclaim_prefix(self, n: int) -> int:
        """Reclaim ``n`` pages from the prefix index, demoting every
        victim's payload into the tiers when they are on."""
        demote = self._demote_entry if self._tiers is not None else None
        return self._prefix.reclaim(n, self._alloc, demote)

    def _reset_page_amax(self, pages):
        """Zero the scale metadata of freshly allocated pages: a recycled
        page must not quantize its new owner's rows against the previous
        owner's range (a quarantined slot's NaN scale included)."""
        if not self._kamax or not pages:
            return
        idx = np.asarray(list(pages), np.int64)
        for a in self._kamax + self._vamax:
            a[idx] = 0.0

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

    @property
    def brownout_level(self) -> int:
        return self._brownout.level if self._brownout is not None else 0

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
        bo = self._brownout
        tiers = self._tiers
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
            # the KV pool's capacity surface: payload dtype and the bytes
            # the cache pins, scale metadata included
            "kv_dtype": str(self._kpools[0].dtype).replace("torch.", ""),
            "kv_quant": self.kv_quant or "off",
            "kv_pool_bytes": int(
                sum(p.nelement() * p.element_size()
                    for p in self._kpools + self._vpools) +
                sum(a.nbytes for a in self._kamax + self._vamax)),
            "kv_quantized_pages": (
                self.num_pages - 1 - self._alloc.free_count
                if self._kv_spec is not None else 0),
            "decode_steps": self.decode_steps,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "accept_rate": self.accept_rate,
            "prefix_hits": self.prefix_hits,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            # cache tiers: zeros (but present) when the tiers are off
            "kv_tier_bytes": (tiers.tier_bytes() if tiers is not None
                              else {"dram": 0, "disk": 0}),
            "tier_demotions": self.tier_demotions,
            "tier_disk_demotions": (tiers.disk_demotions
                                    if tiers is not None else 0),
            "tier_promotions": self.tier_promotions,
            "tier_hits": self.tier_hits,
            "tier_hit_tokens": self.tier_hit_tokens,
            "tier_misses": self.tier_misses,
            "tier_crc_fallbacks": self.tier_crc_fallbacks,
            "tier_disk_errors": (tiers.disk_errors
                                 if tiers is not None else 0),
            "tier_dropped": tiers.dropped if tiers is not None else 0,
            # page transport: capsule traffic, and the pages detached
            # slots hold in custody right now
            "migrated_out_pages": self.migrated_out_pages,
            "migrated_in_pages": self.migrated_in_pages,
            "migrated_out_bytes": self.migrated_out_bytes,
            "migrated_in_bytes": self.migrated_in_bytes,
            "capsule_pages": sum(len(p) for p in
                                 self._capsule_pages.values()),
            "stop_hits": self.stop_hits,
            "constrained_requests": self.constrained_requests,
            "preemptions": self.preemptions,
            "brownout_level": self.brownout_level,
            "brownout_escalations": bo.escalations if bo else 0,
            "brownout_deescalations": bo.deescalations if bo else 0,
            "latency_hists": self.flight.hist_snapshot(),
        }

    def prefix_probe(self, prompt_ids) -> int:
        """READ-ONLY: how many leading tokens of ``prompt_ids`` the
        prefix index has cached right now (0 with the cache off)."""
        if self._prefix is None:
            return 0
        return int(self._prefix.probe(prompt_ids))

    def tier_probe(self, prompt_ids) -> int:
        """READ-ONLY twin of ``prefix_probe`` counting the tiers too: the
        leading tokens the engine could serve from HBM plus the pages its
        tiers would re-admit by copy (no LRU tick anywhere). Equals
        ``prefix_probe`` with the tiers off."""
        if self._prefix is None:
            return 0
        shared, _, cached_len = self._prefix.match(prompt_ids,
                                                   mutate=False)
        if self._tiers is None:
            return int(cached_len)
        n = self._tiers.probe(prompt_ids, len(shared))
        if n == 0:
            return int(cached_len)
        return (len(shared) + n) * self.page_size

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

    @property
    def accept_rate(self) -> float:
        """Fraction of drafted tokens the verify step accepted (0.0 when
        the engine never drafted)."""
        return self.accepted_tokens / self.drafted_tokens \
            if self.drafted_tokens else 0.0

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
        if self._tiers is not None and len(self._tiers):
            # demoted payloads come from the same cache lineage
            self._tiers.flush()

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

    def _queue_head(self, clamped_ok: bool = True) -> Optional[Request]:
        """The earliest-submitted request of the highest-priority tier
        queued; with ``clamped_ok`` False, skipping the tier brownout
        level 3 holds (BATCH: it stays queued without blocking
        others)."""
        best = None
        for q in self._queue:
            if not clamped_ok and self.brownout_level >= 3 and \
                    q.tier is Tier.BATCH:
                continue
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
        self._alloc.free(self._slots[slot_idx].refs)  # refcounted
        self._scrub_slot_arrays(slot_idx)

    def _scrub_slot_arrays(self, slot_idx: int):
        """Scrub a slot's per-slot arrays and free the slot without
        touching its page references (``detach_slot`` moves them into
        custody instead)."""
        self._page_table[slot_idx, :] = NULL_PAGE  # survive via sharers
        self._lengths[slot_idx] = 0
        self._temps[slot_idx] = 0.0
        self._keys[slot_idx] = 0
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
            req = self._queue_head(clamped_ok=False)
            if req is None:
                return
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
        reclaimable budget (evicted LRU when the free list is short).

        With cache tiers on, the walk continues through the tiers from
        the page where the index stopped; the chain found (which
        supersedes a boundary partial page) is pinned, promoted by copy
        into the slot's fresh private pages, and published back into the
        index. A payload failing its crc ends the chain there; the rest
        is recomputed."""
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

        tier_chain = []
        if self._tiers is not None:
            tier_chain = self._tiers.match_chain(ids, len(shared))
            if tier_chain:
                if partial is not None:
                    self._alloc.decref(partial[0])
                    partial = None
                    cached_len = len(shared) * self.page_size
                # this admission's reclaim demotes into the same store:
                # it must not spill or drop what it is about to promote
                self._tiers.pin(tier_chain)

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
            if tier_chain:
                self._tiers.unpin(tier_chain)
            return False
        if avail < n_new:
            self.prefix_reclaimed_pages += \
                self._reclaim_prefix(n_new - avail)
        if cached_len:
            self.prefix_hits += 1
            self.prefix_hit_tokens += cached_len

        self.withdraw(req)
        priv = [self._alloc.alloc()
                for _ in range(prompt_pages - len(shared))]
        self._reset_page_amax(priv)          # fresh pages, fresh scales
        row = np.zeros((self.max_pages,), np.int32)
        row[:len(shared)] = shared
        row[len(shared):prompt_pages] = priv
        if tier_chain:
            cached_len = self._promote_chain(req, tier_chain, ids, row,
                                             priv, len(shared), cached_len)
        elif self._tiers is not None \
                and (t0 - 1) // self.page_size > len(shared):
            # tiers consulted, nothing usable, and at least one full page
            # of this prompt could have been demoted: a true miss
            self.tier_misses += 1
            self.flight.emit(self._component, EventType.CACHE_TIER_MISS,
                             request_id=req.request_id, reason="absent")
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

    def _promote_chain(self, req, chain, ids, row, priv, n_shared: int,
                       cached_len: int) -> int:
        """Re-admit a pinned tier chain BY COPY into the admission's
        fresh private pages ``priv`` (one replay of the promotion program
        a page), in order, stopping at the first payload whose integrity
        check fails (counted, evented; the rest is recomputed). Publishes
        the promoted pages into the prefix index at once, so siblings
        share them. Returns the prompt tokens now cached."""
        promoted = 0
        for key, ent in chain:
            src_tier = ent.tier
            payload = self._tiers.load(key, ent)
            if payload is None:
                self.tier_crc_fallbacks += 1
                self.flight.emit(self._component, EventType.CACHE_TIER_MISS,
                                 request_id=req.request_id,
                                 reason="integrity", tier=src_tier,
                                 depth=ent.depth)
                break
            dst = int(priv[promoted])
            self._promote_page(*payload, dst)
            self._tiers.remove(key, ent)
            promoted += 1
            self.tier_promotions += 1
            self.flight.emit(self._component, EventType.CACHE_PROMOTE,
                             request_id=req.request_id, tier=src_tier,
                             depth=ent.depth, page=dst)
        self._tiers.unpin(chain)
        if not promoted:
            return cached_len
        cached_len = (n_shared + promoted) * self.page_size
        self.tier_hits += 1
        self.tier_hit_tokens += promoted * self.page_size
        self._prefix.insert(ids[:cached_len], row, self._alloc)
        return cached_len

    def _restore_stream_state(self, slot_idx: int, slot: _Slot):
        """Derive a slot's sampling-menu state from its attempt ids: knob
        vectors, bias row, the token-count table over the full attempt
        history, and (from the GENERATED part only: past ``prompt_len``
        when the request carries one) the grammar state and stop-sequence
        window, so a resume — a preemption's, or a transported slot's on
        its new engine — samples as the unbroken run would."""
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
            base = req.prompt_len if req.prompt_len is not None \
                else int(req.prompt_ids.size)
            gen = [int(t) for t in ids[base:]]
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

    # ------------------------------------------------------------- #
    # page transport (serve/transport.py owns the capsule)
    # ------------------------------------------------------------- #

    def kv_wire_sig(self) -> tuple:
        """The pool layout a page payload means something under: quant
        mode, page size, layer count, page shape and pool dtype. A capsule
        captured under one is never installed under another."""
        return (self.kv_quant or "off", self.page_size, len(self._kpools),
                tuple(self._kpools[0].shape[1:]),
                str(self._kpools[0].dtype).replace("torch.", ""))

    def _slot_of(self, request_id) -> Optional[int]:
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.request.request_id == request_id:
                return i
        return None

    def decode_ready(self, request_id: int) -> bool:
        """True when ``request_id`` holds a slot past prefill, the only
        state a slot can be captured from."""
        i = self._slot_of(request_id)
        return i is not None and not self._slots[i].prefilling

    def capture_slot(self, request_id: int) -> Optional[dict]:
        """READ-ONLY capture probe: the decode-ready slot's request, its
        sampling key, its populated page row (positions ``[0, n_pos)``;
        the destination recomputes the one after) and ``n_pos``. Nothing
        moves, so an aborted capture leaves the slot as it was. None when
        the request holds no decode-ready slot here."""
        i = self._slot_of(request_id)
        if i is None or self._slots[i].prefilling:
            return None
        n_pos = int(self._lengths[i])
        if n_pos <= 0:
            return None
        slot = self._slots[i]
        n_pages = -(-n_pos // self.page_size)
        return {"request": slot.request, "key": int(slot.key),
                "pages": [int(p) for p in self._page_table[i, :n_pages]],
                "n_pos": n_pos}

    def detach_slot(self, request_id: int) -> Optional[Request]:
        """Move a decode-ready slot's page references into custody
        (``_capsule_pages``) and free the slot, with no terminal: the
        transport owns the outcome. ``release_capsule`` returns the pages
        once the transfer lands or falls back. Returns the request, or
        None when it holds no decode-ready slot here."""
        i = self._slot_of(request_id)
        if i is None or self._slots[i].prefilling:
            return None
        slot = self._slots[i]
        self._capsule_pages[int(request_id)] = list(slot.refs)
        self._scrub_slot_arrays(i)
        return slot.request

    def release_capsule(self, request_id: int) -> int:
        """Drop a capsule's page custody (the source's end of every
        transfer, success or fallback); returns the references
        released."""
        pages = self._capsule_pages.pop(int(request_id), None)
        if pages is None:
            return 0
        self._alloc.free(pages)
        return len(pages)

    def install_slot(self, request: Request, payloads, n_pos: int, key,
                     wire_bytes: int = 0, page_hook=None,
                     abort=None) -> bool:
        """Install a transported slot: fresh private pages, every
        payload written through the promotion program, the capsule's
        sampling key pinned on the request (a seedless stream continues
        unchanged), the stream state re-derived as a resume would. The
        slot is decode-ready at once, at length ``n_pos`` with the
        attempt's last token to feed: the engine's next decode step
        writes that boundary token's K/V and samples after it, exactly as
        the source's next step would have (the same program on the same
        row, so the stream continues bitwise on a card too; the JAX
        engine recomputes the boundary through its chunk program
        instead). No prefill runs. Its full pages of positions ``[0,
        n_pos)`` are published into the prefix index. Refuses (False,
        engine untouched) with no free slot or pages, a terminal
        request, or a capsule that does not line up with the attempt
        (``n_pos != len(attempt) - 1``); an ``abort()`` mid-install
        frees the pages and refuses."""
        if request.outcome is not None:
            return False
        slot_idx = next((i for i in range(self.num_slots)
                         if self._slots[i] is None), None)
        if slot_idx is None:
            return False
        ids = self._attempt_ids(request)
        t0 = int(ids.size)
        if n_pos != t0 - 1 or n_pos <= 0:
            return False
        if -(-n_pos // self.page_size) != len(payloads):
            return False
        total = t0 + (request.max_new_tokens - len(request.token_ids))
        need = -(-total // self.page_size)
        prompt_pages = -(-t0 // self.page_size)
        avail = self._alloc.free_count - self._lazy_debt
        recl = self._prefix.reclaimable(self._alloc) \
            if self._prefix is not None else 0
        if avail + recl < need:
            return False
        if avail < prompt_pages:
            self.prefix_reclaimed_pages += \
                self._reclaim_prefix(prompt_pages - avail)
        priv = [self._alloc.alloc() for _ in range(prompt_pages)]
        self._reset_page_amax(priv)
        for j, payload in enumerate(payloads):
            if page_hook is not None:
                page_hook(j, len(payloads))
            if abort is not None and abort():
                # pages are identity-free: a half-written one needs only
                # its reference back on the free list
                self._alloc.free(priv)
                return False
            self._promote_page(*payload, int(priv[j]))
        row = np.zeros((self.max_pages,), np.int32)
        row[:prompt_pages] = priv
        request._assigned_key = int(key)
        if request.submit_time is None:
            request.submit_time = time.perf_counter()
        if request._deadline_abs is None and \
                request.deadline_s is not None:
            request._deadline_abs = request.submit_time + request.deadline_s
        slot = _Slot(request, reserved_pages=need, refs=priv, row=row,
                     t0=t0, attempt_ids=ids, prefill_pos=t0,
                     t_admit=time.perf_counter(), key=int(key))
        self._slots[slot_idx] = slot
        self._restore_stream_state(slot_idx, slot)
        self._page_table[slot_idx, :] = row
        self._lengths[slot_idx] = n_pos
        self._temps[slot_idx] = request.temperature
        self._keys[slot_idx] = _key64(slot.key)
        if self._prefix is not None:
            self._prefix.insert(ids[:n_pos], row, self._alloc)
        self.migrated_in_pages += len(payloads)
        self.migrated_in_bytes += int(wire_bytes)
        self.flight.emit(self._component, EventType.ADMIT,
                         request_id=request.request_id,
                         tier=request.tier.value, slot=slot_idx, t0=t0,
                         cached_len=n_pos, migrated=True,
                         queue_delay_s=None)
        return True

    def _dense_prefill(self, slot_idx: int):
        """Monolithic prompt prefill: the prompt padded to its
        power-of-two page bucket, one replay of that bucket's dense
        program."""
        slot = self._slots[slot_idx]
        req = slot.request
        t_start = time.perf_counter()
        tok = self._run_prefill(self._stage_dense(slot_idx))
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
        or the whole suffix in monolithic mode), padded to its
        power-of-two page bucket: one replay of that bucket's chunk
        program. Returns the number of prompt tokens processed."""
        slot = self._slots[slot_idx]
        req = slot.request
        t_start = time.perf_counter()
        start = slot.prefill_pos
        remaining = slot.t0 - start
        n = remaining if self.chunk_pages is None else \
            min(remaining, self.chunk_pages * self.page_size)
        tok = self._run_prefill(self._stage_chunk(slot_idx, start, n))
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
        self._keys[slot_idx] = _key64(slot.key)
        if self._prefix is not None:
            self._prefix.insert(slot.attempt_ids, slot.row, self._alloc)
        done = self._finish_token(slot_idx, tok,
                                  time.perf_counter() - slot.t_admit)
        if done is not None:
            self._evict(slot_idx, done)

    def _advance_prefill(self) -> int:
        """Chunked-prefill scheduler: round-robin one chunk at a time
        over prefilling slots, never exceeding ``token_budget`` prompt
        tokens per engine step (brownout level 2 clamps it to one chunk:
        the same buckets, no new capture). Returns tokens processed."""
        budget = self.token_budget
        if self.brownout_level >= 2:
            budget = min(budget, self.chunk_pages * self.page_size)
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

    def _propose_drafts(self):
        """Host-side drafting: up to ``spec_k`` tokens per decode-ready
        slot from its own prompt + emitted history, capped at
        ``max_new_tokens - emitted - 1`` so accepted output never
        exceeds the request's budget (which keeps every window write
        inside the admission-time page reservation). A custom
        ``draft_fn``'s out-of-vocab proposal is cut at the first invalid
        token; a grammar-constrained slot's drafts are cut at the first
        token the grammar forbids (a sure rejection) or after EOS.

        Adaptive gating: a slot whose last ``spec_patience`` windows were
        all rejected is skipped, probing again on every
        ``spec_probe_every``-th decode step (all gated slots on the same
        step). Returns ``(drafts, gated)``: {slot: int32 drafts}, and
        whether gating suppressed at least one slot."""
        drafts: dict = {}
        gated = False
        if self.spec_k == 0 or self.brownout_level >= 1:
            # brownout level 1 turns speculation off: W = 1 steps
            return drafts, gated
        vocab = self.model.vocab_size
        probe = self.spec_patience == 0 or \
            self.decode_steps % self.spec_probe_every == 0
        for s in range(self.num_slots):
            slot = self._slots[s]
            if slot is None or slot.prefilling:
                continue
            req = slot.request
            kmax = min(self.spec_k,
                       req.max_new_tokens - len(req.token_ids) - 1)
            if kmax <= 0:
                continue
            if not probe and slot.spec_streak >= self.spec_patience > 0:
                gated = True
                continue
            hist = np.concatenate([req.prompt_ids,
                                   np.asarray(req.token_ids, np.int32)])
            d = np.asarray(self._draft_fn(hist, kmax),
                           np.int32).reshape(-1)[:kmax]
            oob = np.nonzero((d < 0) | (d >= vocab))[0]
            if oob.size:
                d = d[:oob[0]]
            sp = req.sampling
            if d.size and sp is not None and sp.grammar is not None:
                st = slot.grammar_state
                keep = 0
                for t in d:
                    t = int(t)
                    if not grammar_mask(sp.grammar, st, req.eos_id)[t]:
                        break
                    keep += 1
                    if t == req.eos_id:
                        break            # drafting past EOS is waste
                    nxt = sp.grammar.advance(st, t)
                    if nxt is None:
                        break
                    st = nxt
                d = d[:keep]
            if d.size:
                drafts[s] = d
        return drafts, gated

    def _ensure_tail_pages(self, drafts=None) -> List[int]:
        """Lazily allocate the pages the NEXT write positions need —
        where cache memory tracks live tokens. A slot drafting d tokens
        writes positions [L, L + d] this step, so every page of that
        window is mapped up front. The FIRST page (position L) keeps the
        stall semantics: without it the slot cannot advance. Failing to
        map a LATER window page only truncates the slot's drafts (in
        place in ``drafts``): speculation degrades under page pressure,
        never into a stall plain decode would not have had.

        A slot whose tail page cannot be allocated (pool starved even
        after reclaiming prefix retention) is STALLED: it sits this step
        out (masked to length 0 with a NULL page row) and the watchdog
        evicts it FAILED_UNSERVABLE after ``watchdog_steps``."""
        drafts = {} if drafts is None else drafts
        ps = self.page_size
        stalled: List[int] = []
        for s in range(self.num_slots):
            slot = self._slots[s]
            if slot is None or slot.prefilling:
                continue
            L = int(self._lengths[s])
            d = drafts.get(s)
            dlen = 0 if d is None else int(d.size)
            first_pi = L // ps
            mapped_through = first_pi - 1
            starved = False
            for pi in range(first_pi, (L + dlen) // ps + 1):
                if self._page_table[s, pi] != NULL_PAGE:
                    mapped_through = pi
                    continue
                if self._alloc.free_count == 0 and \
                        self._prefix is not None:
                    self.prefix_reclaimed_pages += \
                        self._reclaim_prefix(1)
                if self._alloc.free_count == 0:
                    if pi == first_pi:
                        slot.stall_count += 1
                        if slot.stall_count > self.watchdog_steps:
                            self._evict(s, Outcome.FAILED_UNSERVABLE,
                                        f"watchdog: tail page starved for "
                                        f"{slot.stall_count} steps")
                        else:
                            stalled.append(s)
                        starved = True
                    break
                page = self._alloc.alloc()
                self._reset_page_amax((page,))   # fresh page, fresh scale
                self._page_table[s, pi] = page
                slot.row[pi] = page
                slot.refs.append(page)
                mapped_through = pi
            if starved:
                drafts.pop(s, None)
                continue
            slot.stall_count = 0
            if dlen:                             # clip to the mapped window
                cap = (mapped_through + 1) * ps - 1 - L
                if cap < dlen:
                    if cap <= 0:
                        drafts.pop(s, None)
                    else:
                        drafts[s] = d[:cap]
        return stalled

    def _grammar_rows(self, drafts: dict, W: int, live) -> dict:
        """The (W, V) vocabulary mask of each live grammar-constrained
        slot: column j is masked at the grammar state AFTER its drafts
        at columns <= j, so every verify column is constrained as the
        sequential decode at that position would be. Other slots' rows
        are all True."""
        rows = {}
        for s in live:
            slot = self._slots[s]
            sp = slot.request.sampling
            if sp is None or sp.grammar is None:
                continue
            m = np.ones((W, self._vocab), bool)
            eos = slot.request.eos_id
            st = slot.grammar_state
            m[0] = grammar_mask(sp.grammar, st, eos)
            for j, t in enumerate(drafts.get(s, ())):
                t = int(t)
                if t == eos:
                    break                    # later columns are dead
                nxt = sp.grammar.advance(st, t)
                if nxt is not None:
                    st = nxt
                if j + 1 < W:
                    m[j + 1] = grammar_mask(sp.grammar, st, eos)
            rows[s] = m
        return rows

    def step(self) -> int:
        """Enforce deadlines, admit, advance chunked prefill under the
        token budget, then run ONE decode/verify step for all
        decode-ready slots: each live slot advances 1..spec_k+1 tokens
        (exactly 1 when speculation is off, found no draft, or every
        draft missed). Returns the number of slots that advanced."""
        self._expire_queue()
        self._expire_slots()
        if self._brownout is not None:
            # one evaluation per scheduler step, before admission, so a
            # clamp applies to this step's admissions
            self._brownout.update(self)
        self._admit()
        if self.chunk_pages is not None:
            self._advance_prefill()
        drafts, gated = self._propose_drafts()
        stalled = self._ensure_tail_pages(drafts)
        live = [s for s in range(self.num_slots)
                if self._slots[s] is not None
                and not self._slots[s].prefilling and s not in stalled]
        if not live:
            return 0
        # width routing: a step where NO slot drafted runs the W = 1
        # decode step, so gated / zero-draft traffic pays no verify width
        W = self._spec_w if drafts else 1
        if W > 1:
            self.spec_steps += 1
        elif gated:
            self.spec_gated_steps += 1
        prog = self._program(W)              # built before the timed span
        tokens = np.zeros((self.num_slots, W), np.int64)
        draft_len = np.zeros((self.num_slots,), np.int32)
        for s in live:
            tokens[s, 0] = self._slots[s].attempt_last
            d = drafts.get(s)
            if d is not None:
                tokens[s, 1:1 + d.size] = d
                draft_len[s] = d.size
        t_start = time.perf_counter()
        self._sync_menu(W, drafts, live)
        self._stage_step(prog, tokens, draft_len, stalled)
        # one copy in, one replay, and the one designed host readback
        # per step: tokens, counts and the grown amax
        out = prog.run()
        emitted = out["emitted"].tolist()
        n_emit = out["n_emit"].tolist()
        self._take_amax(out)
        for s in live:
            self._lengths[s] += n_emit[s]
        dt = time.perf_counter() - t_start
        self.decode_steps += 1
        self.flight.emit(self._component, EventType.DECODE_STEP,
                         ts=t_start, step=self.decode_steps, width=W,
                         live=len(live), dur_s=dt)
        for s in live:
            if emitted[s][0] < 0:            # sign-encoded guard flag
                # poisoned step: NOTHING of it is recorded, accepted
                # drafts included (they were scored by non-finite math)
                self._quarantine(s, "non-finite logits in decode")
                continue
            slot = self._slots[s]
            req = slot.request
            d = int(draft_len[s])
            n = n_emit[s]
            if d:
                self.drafted_tokens += d
                req.drafted_tokens += d
                # gating signal: a fully rejected window grows the
                # streak, any acceptance resets it
                slot.spec_streak = 0 if n > 1 else slot.spec_streak + 1
            per_tok = dt / max(n, 1)
            recorded = 0
            for i in range(n):
                done = self._finish_token(s, emitted[s][i], per_tok)
                recorded += 1
                if done is not None:
                    # EOS (or a stop) inside the accepted window: the
                    # later tokens are dropped, as sequential decode
                    # would never have made them
                    self._evict(s, done)
                    break
            if d:
                # columns [0, n - 1) are drafts, n - 1 the bonus or
                # correction; count only accepted drafts RECORDED
                kept = min(recorded, n - 1)
                self.accepted_tokens += kept
                req.accepted_tokens += kept
        return len(live)

    # ------------------------------------------------------------- #
    # page accounting audit (tests / debugging)
    # ------------------------------------------------------------- #

    def audit_pages(self):
        """Assert the page invariant: every page 1..P-1 is EITHER on the
        free list (refcount 0) OR live, and a live page's refcount
        equals the slot mappings plus index entries (plus allocator
        holds, plus the custody of detached slots' capsules) that
        reference it; a request is never both slotted and in custody;
        and the tier store's own accounting balances (a demoted page is
        a payload with no page id). Raises MXNetError on a leak or a
        double grant."""
        for rid in self._capsule_pages:
            for slot in self._slots:
                if slot is not None and slot.request.request_id == rid:
                    raise MXNetError(
                        f"page audit: request {rid} holds a slot AND an "
                        f"in-flight capsule (double identity)")
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
        for pages in self._capsule_pages.values():
            for p in pages:
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
        if self._tiers is not None:
            self._tiers.audit()

    # ------------------------------------------------------------- #
    # warm restart
    # ------------------------------------------------------------- #

    def warm_start(self, params=None, manager=None, step=None) -> None:
        """Swap new weights into the live engine. ``params``: the port's
        own ``state_dict()`` names, or positional keys ``"<i>"`` /
        ``"param/<i>"`` in the JAX package's ``collect_params()`` order
        (``models.convert.gpt_param_names``; a training capsule's other
        entries are ignored) -> tensors or numpy arrays. Every shape and
        dtype is checked before the first write; the values are then
        ``copy_``-ed into the model's parameters, which the captured
        graphs hold by address, so they serve the new weights with no new
        capture. The prefix index and the tiers are flushed: cached K/V
        was computed under the old weights. ``manager=`` needs the
        checkpoint manager, which is not ported yet."""
        if manager is not None:
            raise MXNetError("warm_start(manager=...): the checkpoint "
                             "manager is not ported to the PyTorch engine "
                             "yet")
        if params is None:
            raise MXNetError("warm_start needs params")
        items = {k[len("param/"):]: v for k, v in params.items()
                 if k.startswith("param/")} or dict(params)
        targets = dict(self.model.named_parameters())
        positional = all(k.isdigit() for k in items)
        names = gpt_param_names(self.model.num_layers) if positional \
            else list(targets)
        new = []
        for i, name in enumerate(names):
            key = str(i) if positional else name
            if key not in items:
                raise MXNetError(f"warm_start: no value for parameter {i} "
                                 f"('{name}')")
            v = items[key]
            v = v.detach() if torch.is_tensor(v) else _to_tensor(v)
            cur = targets[name]
            if v.shape != cur.shape or v.dtype != cur.dtype:
                raise MXNetError(
                    f"warm_start: parameter '{name}' is "
                    f"{str(cur.dtype).replace('torch.', '')}"
                    f"{tuple(cur.shape)} but the new value is "
                    f"{str(v.dtype).replace('torch.', '')}{tuple(v.shape)}"
                    f" — shape/dtype changes require a new engine")
            new.append((cur, v))
        with torch.no_grad():
            for cur, v in new:
                cur.copy_(v)
        if self._prefix is not None:
            self._prefix.flush(self._alloc)
            self.prefix_flushes += 1
        if self._tiers is not None:
            self._tiers.flush()
        self.warm_restarts += 1

    def save_checkpoint(self, manager, step=None, block=False):
        raise MXNetError("save_checkpoint: the checkpoint manager is not "
                         "ported to the PyTorch engine yet")

    def install_preemption(self, manager, exit_after=True):
        raise MXNetError("install_preemption: the checkpoint manager is "
                         "not ported to the PyTorch engine yet")

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
        engine is otherwise idle. A head queued only because brownout
        holds its tier is not page-starved: it is SHED (retryable)."""
        head = self._queue_head(clamped_ok=False)
        if head is not None:
            self.withdraw(head)
            self._record_terminal(
                head, Outcome.FAILED_UNSERVABLE,
                f"page-starved: head of an idle engine for {polls} polls "
                f"(free={self._alloc.free_count})")
            return
        head = self._queue_head()
        self.withdraw(head)
        self._record_terminal(
            head, Outcome.SHED,
            f"brownout level {self.brownout_level} held "
            f"{head.tier.value} admissions clamped for {polls} idle "
            f"polls")

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
