"""incubator_mxnet_tpu_torch — the PyTorch / CUDA port of
incubator_mxnet_tpu, built slice by slice beside the JAX package.

The slices so far are GPT serving and BERT pretraining:
``models.gpt`` (GPT-2-small widths and a tiny test config),
``serve.InferenceEngine`` over a paged KV cache with speculative decoding
and int8 / fp8 pages; ``models.bert`` (``bert_base``,
``BERTForPretraining``, ``pretraining_loss``) trained by
``parallel.SPMDTrainer`` with LAMB; and the hand-written CUDA kernels of
both paths in ``csrc/`` (ragged decode, chunked-prefill and
speculative-verify attention over raw or quantized pools; the flash
attention forward and its dq / dk-dv backward), built with nvcc on first
use.

    import incubator_mxnet_tpu_torch as mx
    model = mx.models.gpt_small(dtype="bfloat16")        # on the GPU
    eng = mx.serve.InferenceEngine(model, chunk_pages=4, spec_k=4,
                                   kv_quant="int8")

    bert = mx.models.bert_base(dtype="bfloat16", max_length=512,
                               flash=True)
    pre = mx.models.BERTForPretraining(bert)
    trainer = mx.parallel.SPMDTrainer(
        pre, forward_loss=mx.models.pretraining_loss, optimizer="lamb",
        optimizer_params={"learning_rate": 1e-4, "multi_precision": True})
    loss = trainer.step(*batch)

Entry points run on the GPU unless the caller passes ``device="cpu"``;
without CUDA they raise ``MXNetError``. The port imports neither ``jax``
nor the JAX package.
"""

from . import (amp, checkpoint, initializer, models, ops, optimizer,
               parallel, random, serve, train)
from .base import MXNetError
from .context import cpu, gpu

__all__ = ["MXNetError", "cpu", "gpu", "amp", "checkpoint", "initializer",
           "models", "ops", "optimizer", "parallel", "random", "serve",
           "train"]
