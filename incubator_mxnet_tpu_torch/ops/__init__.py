"""Operators of the PyTorch port: masked dense attention, the ragged
paged-attention kernels of the serving path (decode, chunked prefill,
speculative verify; raw or quantized pools) and symmetric
quantization."""

from .attention import scaled_dot_product_attention
from .ragged_attention import (LAUNCHES, ragged_attention_reference,
                               ragged_paged_attention,
                               ragged_prefill_attention,
                               ragged_prefill_reference,
                               ragged_verify_attention,
                               ragged_verify_reference,
                               reset_launch_counts)

__all__ = ["scaled_dot_product_attention", "ragged_paged_attention",
           "ragged_attention_reference", "ragged_prefill_attention",
           "ragged_prefill_reference", "ragged_verify_attention",
           "ragged_verify_reference", "LAUNCHES", "reset_launch_counts"]
