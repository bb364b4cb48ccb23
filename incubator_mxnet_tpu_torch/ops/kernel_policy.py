"""Kernel / remat / batch selection policy for one H100: the port of the
JAX package's ``incubator_mxnet_tpu/ops/kernel_policy.py``.

One function family maps static shapes and the card's memory to a
training configuration: the attention kernels a shape takes
(``flash_kernel_plan``, read from the port's own CUDA dispatch so it
cannot drift from what runs), and the largest batch whose parameters,
optimizer state and saved activations fit (``training_plan``), clamped
to the batches the card has run.

Every number below was shown by an NVIDIA H100 80GB HBM3 at a 700.00 W
power limit, in ``chip_smoke.py`` runs (PERF.md §6 names them):

- ``HBM_BYTES``: the card's memory,
  ``torch.cuda.get_device_properties(0).total_memory``;
- ``HBM_USABLE``: what the plan may fill. The least that
  ``torch.cuda.mem_get_info`` reported free at the start of the
  ``pipelined`` phase in three runs (83.66-83.78 GB; caches emptied;
  the process's CUDA context, cuBLAS workspaces and an NCCL group of
  one held), less the caching allocator's reserve beyond its
  allocations at the largest peak the card has shown
  (``max_memory_reserved - max_memory_allocated`` of the bert_large
  step below): the plan counts allocations only;
- ``_MEASURED_MAX_BATCH``: bert_base trains at B=32, T=512 (the
  ``training`` phase).

Peak memory the card showed (``torch.cuda.max_memory_allocated``):
gpt_small bf16 B=16 T=512 9.51-9.58 GB without remat, 8.15-8.22 GB with
``"dots"``, 6.79-6.86 GB with ``True`` (the ``gpt_training`` phase); the
pipelined LAMB step with ``"dots"`` at T=512, bert_base B=32 6.46-6.47
GB, bert_large B=128 47.89-47.95 GB, the plan's batches (the
``pipelined`` phase). The arithmetic below counts only the dominant
terms: gpt_small's ``"dots"`` peak is 2.6x its estimate (the (B, T,
50257) logits and their log-sum-exp are not in it) and bert_large's
1.4x.
"""

from __future__ import annotations

# NVIDIA H100 80GB HBM3 at 700.00 W (see the module's docstring)
HBM_BYTES = 85_017_493_504
_FREE_AT_PHASE_START = 83_661_881_344       # the least of three runs
_ALLOCATOR_RESERVE = 2_565_252_064          # 50.45 GB reserved, 47.89 held
HBM_USABLE = _FREE_AT_PHASE_START - _ALLOCATOR_RESERVE

# (num_layers, units) -> the largest batch at T=512 the card has trained
_MEASURED_MAX_BATCH = {(12, 768): 32}

_BATCH_CANDIDATES = (128, 96, 64, 48, 32, 24, 16, 8, 4, 2, 1)


def flash_kernel_plan(Tq, H, Tk=None, bwd=False, D=64, causal=False):
    """The attention kernels a shape takes, from the port's own dispatch
    (``ops.flash_attention.cuda_kernel_eligible``): ``cuda`` is whether
    the CUDA flash kernels take it (else the blockwise plain path).
    ``dense`` (the JAX whole-row family) is always False: the CUDA
    kernels stream K / V in 64-key tiles at every length, and a block
    works on one (batch, head) unit, so ``heads_per_program`` is 1 when
    they run and None otherwise."""
    from .flash_attention import cuda_kernel_eligible
    ok = cuda_kernel_eligible(D, causal, Tq, Tk if Tk is not None else Tq)
    return {"dense": False, "heads_per_program": 1 if ok else None,
            "cuda": ok}


def _param_count(L, units, hidden, vocab, T):
    """Encoder-family parameter count: embeddings + L transformer layers
    (qkv/out projections 4*units^2 + FFN 2*units*hidden) + pooler/head
    order-of-magnitude terms (the JAX function)."""
    emb = (vocab + T + 8) * units
    layer = 4 * units * units + 2 * units * hidden + 9 * units
    head = units * units + vocab  # pooler + tied-embedding LM bias
    return emb + L * layer + head


def _saved_activation_bytes(B, T, units, hidden, dtype_bytes, remat):
    """Per-layer residual bytes the backward needs (the JAX function).

    remat="dots" keeps matmul OUTPUTS only (qkv 3u, attn out u, ffn-in
    hidden, ffn-out u; ``models/_remat.py`` saves the outputs of
    ``aten.mm`` / ``addmm`` / ``bmm`` and the dropout masks) and
    recomputes elementwise chains. remat=False keeps the elementwise
    intermediates too (~2x). remat=True keeps only layer boundaries and
    recomputes every product."""
    dots = B * T * (5 * units + hidden) * dtype_bytes
    if remat == "dots":
        return dots
    if remat is True:
        return B * T * units * dtype_bytes
    return 2 * dots


def training_plan(num_layers, units, hidden, vocab, seq_len,
                  dtype="bfloat16", hbm_bytes=HBM_USABLE):
    """{batch, remat, dense, fwd/bwd heads_per_program} for one card.

    The largest candidate batch whose parameters (multi-precision LAMB:
    bf16 weights + f32 master + 2 f32 moments = 14 B a parameter) plus
    saved activations under ``"dots"`` remat fit ``hbm_bytes``, clamped
    to the batch the card has run for a known model shape."""
    dtype_bytes = 2 if dtype in ("bfloat16", "float16") else 4
    params = _param_count(num_layers, units, hidden, vocab, seq_len)
    param_bytes = params * (14 if dtype_bytes == 2 else 12)
    batch = None
    for b in _BATCH_CANDIDATES:
        act = _saved_activation_bytes(b, seq_len, units, hidden,
                                      dtype_bytes, "dots") * num_layers
        if param_bytes + act <= hbm_bytes:
            batch = b
            break
    if batch is None:
        batch = 1
    anchor = _MEASURED_MAX_BATCH.get((num_layers, units))
    if anchor is not None:
        batch = min(batch, anchor)
    # heads: encoder convention units = H * 64
    H = max(1, units // 64)
    D = units // H
    plan = flash_kernel_plan(seq_len, H, D=D)
    return {"batch": batch, "remat": "dots", "dense": plan["dense"],
            "fwd_heads_per_program": plan["heads_per_program"],
            "bwd_heads_per_program": flash_kernel_plan(
                seq_len, H, bwd=True, D=D)["heads_per_program"]}
