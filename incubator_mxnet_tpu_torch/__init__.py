"""incubator_mxnet_tpu_torch — the PyTorch / CUDA port of
incubator_mxnet_tpu, built slice by slice beside the JAX package.

MXNet 1.x's imperative front end: ``nd`` (``NDArray`` over a
``torch.Tensor`` and the registered ops), ``autograd`` on
``torch.autograd``, ``gluon`` (``Parameter``, ``Block`` /
``HybridBlock`` as ``torch.nn.Module``s, ``nn``, ``loss``, ``Trainer``
with its fused applier as CUDA graphs; ``gluon.data``, ``gluon.model_zoo``
and ``gluon.utils``), ``metric``, ``init`` and ``amp`` (``amp.init``
casting the registry's tensor-core ops to bf16 / f16, the dynamic loss
scale through ``gluon.Trainer``). The registry holds all 312 of the JAX
package's operators (``nd.linalg``, ``nd.contrib``, ``nd.random``, the
optimizer updates, the fused ``RNN`` on cuDNN and the int8 quantization
ops), with ``gluon.rnn`` (fused layers and cells), ``gluon.contrib``
(``nn``, ``rnn``, ``estimator``) and ``mx.contrib.quantization``
(``quantize_net``) over them. The model slices are
GPT serving and causal-LM training, BERT pretraining, the WMT
Transformer's beam searches and convolutional vision training (the
model zoo's ResNets through ``parallel.SPMDTrainer``, ``models.LeNet``
through ``gluon.Trainer``):
``models.gpt`` (GPT-2-small widths and a tiny test config, ``lm_loss``,
rematerialization), ``serve.InferenceEngine`` over a paged KV cache with
speculative decoding and int8 / fp8 pages; ``models.transformer``
(``transformer_base``, KV-cached beam search); ``models.bert`` (``bert_base``,
``BERTForPretraining``, ``pretraining_loss``) trained by
``parallel.SPMDTrainer`` with LAMB; and the hand-written CUDA kernels of
both paths in ``csrc/`` (ragged decode, chunked-prefill and
speculative-verify attention over raw or quantized pools; the flash
attention forward and its dq / dk-dv backward), built with nvcc on first
use.

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd, autograd, gluon
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(64, activation="relu"), gluon.nn.Dense(4))
    net.initialize()                                      # on gpu(0)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    with autograd.record():
        L = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    L.backward()
    trainer.step(x.shape[0])

    model = mx.models.gpt_small(dtype="bfloat16", flash=True)
    model.initialize()                                    # on gpu(0)
    lm = mx.parallel.SPMDTrainer(model, forward_loss=mx.models.lm_loss,
                                 optimizer="adamw")
    eng = mx.serve.InferenceEngine(model, chunk_pages=4, spec_k=4,
                                   kv_quant="int8")

    bert = mx.models.bert_base(dtype="bfloat16", max_length=512,
                               flash=True)
    bert.initialize()
    pre = mx.models.BERTForPretraining(bert)
    pre.initialize()
    trainer = mx.parallel.SPMDTrainer(
        pre, forward_loss=mx.models.pretraining_loss, optimizer="lamb",
        optimizer_params={"learning_rate": 1e-4, "multi_precision": True})
    loss = trainer.step(*batch)

The symbolic front end (``mx.sym`` / ``mx.symbol``, ``mx.mod``,
``mx.io``, ``mx.kv``, ``mx.model``, ``mx.callback``, ``mx.viz``,
``mx.executor``, ``mx.name``, ``mx.attribute`` and ``mx.AttrScope``),
the image input path (``mx.recordio``, ``mx.image``), ``mx.contrib``
(quantization, ONNX, SVRG, text) and the small modules (``mx.monitor`` /
``mx.mon``, ``mx.profiler``, ``mx.operator``, ``mx.engine``,
``mx.util``, ``mx.test_utils``, ``mx.rtc``) and the NumPy-style
namespaces (``mx.np`` / ``mx.numpy``, ``mx.npx``) load at first use.
``nd.sparse`` holds the row-sparse and CSR storage types: an
``Embedding(sparse_grad=True)`` table trains by lazy row updates through
``gluon.Trainer`` and ``mx.kv``'s ``row_sparse_pull``, and
``mx.io.LibSVMIter`` feeds CSR batches to ``Module``. ``mx.tpu()``
raises: the port's accelerator is ``mx.gpu()``. The symbolic front end runs MXNet 1.x's
``Module.fit`` flow: a Symbol bound by ``simple_bind`` / ``Module.bind`` runs as one CUDA graph per
signature; gluon's ``export`` / ``SymbolBlock.imports`` cross between
the front ends.

    sym = mx.sym.load("resnet50-symbol.json")
    net = mx.sym.SoftmaxOutput(sym, mx.sym.Variable("softmax_label"))
    mod = mx.mod.Module(net)                              # on gpu(0)
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=64), num_epoch=1,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})

Entry points run on the GPU (``gpu(0)``, the default context) unless the
caller asks for the CPU (``with mx.cpu():``, ``ctx=mx.cpu()`` or
``device="cpu"``); without CUDA they raise ``MXNetError``. The port
imports neither ``jax`` nor the JAX package.
"""

from . import (amp, autograd, checkpoint, initializer, metric, models, ops,
               optimizer, parallel, random, runtime, serve, train)
from . import ndarray
from . import ndarray as nd
from . import gluon
from . import initializer as init
from .base import MXNetError
from .context import (Context, cpu, cpu_pinned, current_context, gpu,
                      gpu_memory_info, num_devices, num_gpus, num_tpus, tpu)
from .ndarray import NDArray
from .optimizer import lr_scheduler

_LAZY_SUBMODULES = {
    "symbol": ".symbol", "sym": ".symbol", "module": ".module",
    "mod": ".module", "io": ".io", "kvstore": ".kvstore", "kv": ".kvstore",
    "callback": ".callback", "model": ".model",
    "visualization": ".visualization", "viz": ".visualization",
    "executor": ".symbol.executor", "attribute": ".attribute",
    "name": ".name", "recordio": ".io.recordio", "image": ".image",
    "contrib": ".contrib", "monitor": ".monitor", "mon": ".monitor",
    "profiler": ".profiler", "operator": ".operator", "engine": ".engine",
    "util": ".util", "test_utils": ".test_utils", "rtc": ".rtc",
    "np": ".numpy_shim", "numpy": ".numpy_shim", "npx": ".numpy_extension",
}


def __getattr__(name):
    """The symbolic front end's modules, loaded at first use (as the JAX
    package loads its submodules)."""
    if name == "AttrScope":
        from .attribute import AttrScope
        globals()["AttrScope"] = AttrScope
        return AttrScope
    if name in _LAZY_SUBMODULES:
        import importlib
        mod = importlib.import_module(_LAZY_SUBMODULES[name], __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["MXNetError", "Context", "cpu", "gpu", "cpu_pinned",
           "current_context", "num_gpus", "num_devices", "gpu_memory_info",
           "num_tpus", "tpu", "NDArray", "nd", "ndarray", "autograd", "gluon",
           "init", "initializer", "lr_scheduler", "runtime", "amp",
           "checkpoint", "metric", "models", "ops", "optimizer", "parallel",
           "random",
           "serve", "train"]
