"""Continuous-batching serving over a paged KV cache (PyTorch port of
``incubator_mxnet_tpu/serve``):

  - ``paged_kv`` — a shared KV page pool + per-slot page tables, so
                   cache memory scales with LIVE tokens;
  - ``engine``   — a fixed-slot continuous-batching scheduler with
                   chunked prefill, copy-on-write prefix caching,
                   speculative decoding, a quantized KV cache, DRAM /
                   disk cache tiers, SLO tiers with brownout, warm
                   restart and structured terminal outcomes;
  - ``transport`` — page capsules: a live slot moved between engines;
  - ``router``   — a fleet front over N engine replicas: cache-affinity
                   admission, least-delay spill, heartbeat / circuit-
                   breaker health states, bounded structured failover,
                   live migration and elastic membership;
  - ``fleet_supervisor`` — autoscaling and rolling-upgrade policy;
  - ``frontend`` — the HTTP/SSE client protocol (stdlib asyncio);
  - ``chaos``    — seeded fault injectors for engines and fleets;
  - ``metrics``  — Prometheus text over health snapshots;
  - ``draft``    — the n-gram (prompt-lookup) draft proposer.

The ragged attention kernels live in ``ops.ragged_attention``.
"""

from .draft import make_ngram_drafter, ngram_propose
from .events import Event, EventType, FlightRecorder
from .outcomes import Outcome
from .paged_kv import (NULL_PAGE, KVQuantSpec, KVTierStore, PageAllocator,
                       PrefixIndex, init_kv_pools, kv_quant_spec,
                       page_scales, payload_crc, payload_nbytes,
                       write_block_kv, write_block_kv_q, write_prompt_kv,
                       write_prompt_kv_q, write_token_kv, write_token_kv_q)
from .sampling import (SamplingParams, TokenFsm, TokenGrammar,
                       choice_grammar)
from .slo import (BrownoutController, Tier, TierPolicy,
                  default_tier_policies, wants_rebalance)
from .engine import InferenceEngine, Request
from .metrics import render_frontend_metrics, render_metrics
from .transport import PageCapsule, PageTransport
from .router import (Replica, ReplicaKilled, ReplicaState, Router,
                     build_fleet)
from .fleet_supervisor import FleetSupervisor
from .frontend import (OUTCOME_HTTP_STATUS, ServeFrontend,
                       stream_completion)

__all__ = ["InferenceEngine", "Request", "Outcome", "PageAllocator",
           "PrefixIndex", "NULL_PAGE", "init_kv_pools", "write_token_kv",
           "write_prompt_kv", "write_block_kv", "KVQuantSpec",
           "kv_quant_spec", "page_scales", "write_token_kv_q",
           "write_prompt_kv_q", "write_block_kv_q", "ngram_propose",
           "make_ngram_drafter", "Tier", "TierPolicy",
           "default_tier_policies", "Event", "EventType",
           "FlightRecorder", "SamplingParams", "TokenGrammar",
           "TokenFsm", "choice_grammar", "KVTierStore", "payload_crc",
           "payload_nbytes", "BrownoutController", "wants_rebalance",
           "render_metrics", "render_frontend_metrics", "PageCapsule",
           "PageTransport", "Router", "Replica", "ReplicaState",
           "ReplicaKilled", "build_fleet", "FleetSupervisor",
           "ServeFrontend", "OUTCOME_HTTP_STATUS", "stream_completion"]
