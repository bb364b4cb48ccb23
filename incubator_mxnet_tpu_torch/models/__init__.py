"""Model zoo of the PyTorch port (GPT for the serving slice)."""

from .convert import gpt_param_names, params_from_jax
from .gpt import (GPTModel, cached_generate, decode_forward, gpt_mini,
                  gpt_small, init_kv_cache)

__all__ = ["GPTModel", "gpt_mini", "gpt_small", "cached_generate",
           "decode_forward", "init_kv_cache", "params_from_jax",
           "gpt_param_names"]
