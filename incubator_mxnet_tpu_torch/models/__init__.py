"""Model zoo of the PyTorch port: GPT (the serving slices, an
``nn.Module``), BERT pretraining and LeNet (gluon ``HybridBlock``s);
``resnet`` (the vision zoo's ResNets) loads on first use."""

from . import lenet
from .lenet import LeNet

from .bert import (BERTClassifier, BERTForPretraining, BERTModel,
                   bert_base, bert_large, bert_tiny, pretraining_loss)
from .convert import (bert_params_from_jax, block_params_from_jax,
                      gpt_param_names, params_from_jax)
from .gpt import (GPTModel, cached_generate, decode_forward, gpt_mini,
                  gpt_small, init_kv_cache)

__all__ = ["GPTModel", "gpt_mini", "gpt_small", "cached_generate",
           "decode_forward", "init_kv_cache", "params_from_jax",
           "gpt_param_names", "BERTModel", "BERTForPretraining",
           "BERTClassifier", "pretraining_loss", "bert_tiny", "bert_base",
           "bert_large", "bert_params_from_jax", "block_params_from_jax",
           "LeNet"]


def __getattr__(name):
    if name == "resnet":
        import importlib
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
