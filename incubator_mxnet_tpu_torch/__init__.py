"""incubator_mxnet_tpu_torch — the PyTorch / CUDA port of
incubator_mxnet_tpu, built slice by slice beside the JAX package.

This slice is GPT serving: ``models.gpt`` (GPT-2-small widths and a tiny
test config), ``serve.InferenceEngine`` over a paged KV cache, and the
two hand-written CUDA kernels of that path in ``csrc/`` (ragged decode
and chunked-prefill attention), built with nvcc on first use.

    import incubator_mxnet_tpu_torch as mx
    model = mx.models.gpt_small(dtype="bfloat16")        # on the GPU
    eng = mx.serve.InferenceEngine(model, chunk_pages=4)

Entry points run on the GPU unless the caller passes ``device="cpu"``;
without CUDA they raise ``MXNetError``. The port imports neither ``jax``
nor the JAX package.
"""

from . import models, ops, serve
from .base import MXNetError
from .context import cpu, gpu

__all__ = ["MXNetError", "cpu", "gpu", "models", "ops", "serve"]
