"""Copy the JAX package's weights into the port's models.

Gluon blocks (``block_params_from_jax``; ``bert_params_from_jax`` calls
it): by structural name. ``_collect_params_with_prefix()`` names every
parameter of a gluon block by its path
('block0.attn.qkv.weight', 'bert.layer0.attention.qkv.weight',
'features.1.0.body.1.running_mean'), in both packages, and the port's
``state_dict()`` keys are the same names: GPT, BERT, the Transformer, a
model zoo network and LeNet convert alike, convolution weights and
BatchNorm running statistics included.

GPT by position (``gpt_param_names``): the JAX model's
``collect_params()`` order, which for L layers is 2 + 12 L + 2 tensors —

    word embedding, position embedding,
    per block: ln1 gamma, ln1 beta, qkv W, qkv b, proj W, proj b,
               ln2 gamma, ln2 beta, ffn_in W, ffn_in b, ffn_out W,
               ffn_out b,
    ln_f gamma, ln_f beta

— the order of a JAX training capsule's ``param/<i>`` entries, which the
serving engine's ``warm_start`` reads. MXNet ``Dense`` weights are
(out, in), the same as ``torch.nn.functional.linear``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["gpt_param_names", "bert_params_from_jax",
           "block_params_from_jax"]

_BLOCK = ("ln1.gamma", "ln1.beta", "attn.qkv.weight", "attn.qkv.bias",
          "attn.proj.weight", "attn.proj.bias", "ln2.gamma", "ln2.beta",
          "ffn_in.weight", "ffn_in.bias", "ffn_out.weight", "ffn_out.bias")


def gpt_param_names(num_layers: int):
    """GPT's structural names (the port's state-dict keys), in the JAX
    ``collect_params`` order."""
    names = ["word_embed.weight", "position_embed.weight"]
    for i in range(num_layers):
        names += [f"block{i}.{n}" for n in _BLOCK]
    return names + ["ln_f.gamma", "ln_f.beta"]


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes, from a bf16 model
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))      # a writable copy


def block_params_from_jax(model, params) -> dict:
    """``params``: a JAX gluon block's parameters as a dict of structural
    names (``_collect_params_with_prefix()``) to arrays. ``model``: the
    port's block of the same configuration, its shapes known (initialized,
    and run once where a shape was deferred). Returns its ``state_dict``
    (CPU tensors, each in the JAX array's dtype; ``load_state_dict``
    writes them into the parameters in place). Raises ``MXNetError`` on a
    missing or extra name, or a shape or dtype mismatch."""
    if not isinstance(params, dict):
        raise MXNetError("block_params_from_jax takes a dict of structural "
                         "names to arrays (_collect_params_with_prefix())")
    want = model._collect_params_with_prefix()
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    if missing or extra:
        raise MXNetError(f"structural names differ: missing {missing[:4]}, "
                         f"extra {extra[:4]}")
    out = {}
    for name, p in want.items():
        a = np.asarray(params[name])
        if tuple(a.shape) != tuple(p.shape):
            raise MXNetError(f"parameter {name}: shape {tuple(a.shape)} "
                             f"!= expected {tuple(p.shape)}")
        t = _to_tensor(a)
        if t.dtype != p.data()._data.dtype:
            raise MXNetError(f"parameter {name}: dtype {t.dtype} != "
                             f"expected {p.data()._data.dtype}")
        out[name] = t
    return out


def bert_params_from_jax(model, params) -> dict:
    """``block_params_from_jax`` for the JAX ``BERTForPretraining`` (or
    ``BERTModel``) and the port's model of the same configuration."""
    return block_params_from_jax(model, params)
