"""Operators of the PyTorch port: attention (dense, blockwise and flash,
with the flash forward / backward kernels of the training path), the
ragged paged-attention kernels of the serving path (decode, chunked
prefill, speculative verify; raw or quantized pools) and symmetric
quantization. ``LAUNCHES`` counts the ragged kernels' launches,
``flash_attention.LAUNCHES`` the flash kernels'."""

from .attention import scaled_dot_product_attention
from .flash_attention import (cuda_kernel_eligible, flash_attention_bhtd,
                              use_flash_attention)
from .ragged_attention import (LAUNCHES, ragged_attention_reference,
                               ragged_paged_attention,
                               ragged_prefill_attention,
                               ragged_prefill_reference,
                               ragged_verify_attention,
                               ragged_verify_reference,
                               reset_launch_counts)

__all__ = ["scaled_dot_product_attention", "flash_attention_bhtd",
           "use_flash_attention", "cuda_kernel_eligible",
           "ragged_paged_attention",
           "ragged_attention_reference", "ragged_prefill_attention",
           "ragged_prefill_reference", "ragged_verify_attention",
           "ragged_verify_reference", "LAUNCHES", "reset_launch_counts"]
