"""Model zoo of the PyTorch port: GPT (causal-LM training and the
serving slices), BERT pretraining and LeNet, all gluon ``HybridBlock``s;
``resnet`` (the vision zoo's ResNets) and ``transformer`` (the WMT
Transformer and its beam searches) load on first use, as in the JAX
package."""

from . import lenet
from .lenet import LeNet

from .bert import (BERTClassifier, BERTForPretraining, BERTModel,
                   bert_base, bert_large, bert_tiny, pretraining_loss)
from .convert import (bert_params_from_jax, block_params_from_jax,
                      gpt_param_names)
from .gpt import (GPTModel, cached_generate, decode_forward, gpt_mini,
                  gpt_small, greedy_generate, init_kv_cache, lm_loss)

__all__ = ["GPTModel", "gpt_mini", "gpt_small", "cached_generate",
           "decode_forward", "init_kv_cache", "lm_loss", "greedy_generate",
           "gpt_param_names", "BERTModel", "BERTForPretraining",
           "BERTClassifier", "pretraining_loss", "bert_tiny", "bert_base",
           "bert_large", "bert_params_from_jax", "block_params_from_jax",
           "LeNet"]


def __getattr__(name):
    if name in ("resnet", "transformer"):
        import importlib
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
