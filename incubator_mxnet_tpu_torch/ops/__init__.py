"""Operators of the PyTorch port: attention (dense, blockwise and flash,
with the flash forward / backward kernels of the training path), the
ragged paged-attention kernels of the serving path (decode, chunked
prefill, speculative verify; raw or quantized pools) and symmetric
quantization. ``LAUNCHES`` counts the ragged kernels' launches,
``flash_attention.LAUNCHES`` the flash kernels'.

Importing the package also fills the operator registry (``registry``)
with the ops ``mx.nd`` surfaces: tensor, neural-network, miscellaneous,
random, optimizer-update, linear-algebra, attention, contrib (detection,
deformable convolution, count sketch, Hawkes, mask targets) and vision
(sampling, upsampling, im2col, fft), the fused RNN (``rnn``: cuDNN's on
the card) and the int8 quantization ops (``quantization``): all 312 of
the JAX registry's.
``control_flow`` holds ``foreach`` / ``while_loop`` / ``cond``
(``nd.contrib``)."""

from . import registry
from . import tensor  # noqa: F401  (registers ops)
from . import nn  # noqa: F401  (registers ops)
from . import misc  # noqa: F401  (registers ops)
from . import random_ops  # noqa: F401  (registers ops)
from . import optimizer_ops  # noqa: F401  (registers ops)
from . import linalg  # noqa: F401  (registers ops)
from . import attention  # noqa: F401  (registers ops)
from . import vision  # noqa: F401  (registers ops)
from . import contrib  # noqa: F401  (registers ops)
from . import rnn  # noqa: F401  (registers ops)
from . import quantization  # noqa: F401  (registers ops)

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

__all__ = ["registry", "scaled_dot_product_attention", "flash_attention_bhtd",
           "use_flash_attention", "cuda_kernel_eligible",
           "ragged_paged_attention",
           "ragged_attention_reference", "ragged_prefill_attention",
           "ragged_prefill_reference", "ragged_verify_attention",
           "ragged_verify_reference", "LAUNCHES", "reset_launch_counts"]
