"""Operators of the PyTorch port: masked dense attention and the ragged
paged-attention kernels of the serving path."""

from .attention import scaled_dot_product_attention
from .ragged_attention import (LAUNCHES, ragged_attention_reference,
                               ragged_paged_attention,
                               ragged_prefill_attention,
                               ragged_prefill_reference,
                               reset_launch_counts)

__all__ = ["scaled_dot_product_attention", "ragged_paged_attention",
           "ragged_attention_reference", "ragged_prefill_attention",
           "ragged_prefill_reference", "LAUNCHES", "reset_launch_counts"]
