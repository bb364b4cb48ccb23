"""Model zoo of the PyTorch port: GPT (the serving slices) and BERT
pretraining."""

from .bert import (BERTForPretraining, BERTModel, bert_base, bert_large,
                   bert_tiny, pretraining_loss)
from .convert import (bert_params_from_jax, gluon_param_order,
                      gpt_param_names, params_from_jax)
from .gpt import (GPTModel, cached_generate, decode_forward, gpt_mini,
                  gpt_small, init_kv_cache)

__all__ = ["GPTModel", "gpt_mini", "gpt_small", "cached_generate",
           "decode_forward", "init_kv_cache", "params_from_jax",
           "gpt_param_names", "BERTModel", "BERTForPretraining",
           "pretraining_loss", "bert_tiny", "bert_base", "bert_large",
           "bert_params_from_jax", "gluon_param_order"]
