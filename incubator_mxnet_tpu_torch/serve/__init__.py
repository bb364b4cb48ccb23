"""Continuous-batching serving over a paged KV cache (PyTorch port of
``incubator_mxnet_tpu/serve``):

  - ``paged_kv`` — a shared KV page pool + per-slot page tables, so
                   cache memory scales with LIVE tokens;
  - ``engine``   — a fixed-slot continuous-batching scheduler with
                   chunked prefill, copy-on-write prefix caching,
                   speculative decoding, a quantized KV cache, SLO tiers
                   and structured terminal outcomes;
  - ``draft``    — the n-gram (prompt-lookup) draft proposer.

The ragged attention kernels live in ``ops.ragged_attention``.
"""

from .draft import make_ngram_drafter, ngram_propose
from .events import Event, EventType, FlightRecorder
from .outcomes import Outcome
from .paged_kv import (NULL_PAGE, KVQuantSpec, PageAllocator, PrefixIndex,
                       init_kv_pools, kv_quant_spec, page_scales,
                       write_block_kv, write_block_kv_q, write_prompt_kv,
                       write_prompt_kv_q, write_token_kv, write_token_kv_q)
from .sampling import (SamplingParams, TokenFsm, TokenGrammar,
                       choice_grammar)
from .slo import Tier, TierPolicy, default_tier_policies
from .engine import InferenceEngine, Request

__all__ = ["InferenceEngine", "Request", "Outcome", "PageAllocator",
           "PrefixIndex", "NULL_PAGE", "init_kv_pools", "write_token_kv",
           "write_prompt_kv", "write_block_kv", "KVQuantSpec",
           "kv_quant_spec", "page_scales", "write_token_kv_q",
           "write_prompt_kv_q", "write_block_kv_q", "ngram_propose",
           "make_ngram_drafter", "Tier", "TierPolicy",
           "default_tier_policies", "Event", "EventType",
           "FlightRecorder", "SamplingParams", "TokenGrammar",
           "TokenFsm", "choice_grammar"]
