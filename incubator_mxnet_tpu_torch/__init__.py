"""incubator_mxnet_tpu_torch — the PyTorch / CUDA port of
incubator_mxnet_tpu, built slice by slice beside the JAX package.

The slices so far are GPT serving: ``models.gpt`` (GPT-2-small widths
and a tiny test config), ``serve.InferenceEngine`` over a paged KV cache
with speculative decoding and int8 / fp8 pages, and the hand-written
CUDA kernels of that path in ``csrc/`` (ragged decode, chunked-prefill
and speculative-verify attention, each over raw or quantized pools),
built with nvcc on first use.

    import incubator_mxnet_tpu_torch as mx
    model = mx.models.gpt_small(dtype="bfloat16")        # on the GPU
    eng = mx.serve.InferenceEngine(model, chunk_pages=4, spec_k=4,
                                   kv_quant="int8")

Entry points run on the GPU unless the caller passes ``device="cpu"``;
without CUDA they raise ``MXNetError``. The port imports neither ``jax``
nor the JAX package.
"""

from . import models, ops, serve
from .base import MXNetError
from .context import cpu, gpu

__all__ = ["MXNetError", "cpu", "gpu", "models", "ops", "serve"]
