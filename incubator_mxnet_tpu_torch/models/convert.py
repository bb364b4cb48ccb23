"""Copy the JAX package's weights into the port's models.

GPT (``params_from_jax``):

The JAX model's parameter names carry per-instance counters
(``gptmodel0_gptblock0_causalselfattention0_dense0_weight``, ...) that
change from one instance to the next, so the mapping is by ORDER: the
arrays come in ``collect_params()`` order, which for L layers is
2 + 12 L + 2 tensors —

    word embedding, position embedding,
    per block: ln1 gamma, ln1 beta, qkv W, qkv b, proj W, proj b,
               ln2 gamma, ln2 beta, ffn_in W, ffn_in b, ffn_out W,
               ffn_out b,
    ln_f gamma, ln_f beta.

MXNet ``Dense`` weights are (out, in), the same as ``nn.Linear``.

BERT (``bert_params_from_jax``): the map is derived, not listed. A gluon
block's ``collect_params()`` yields its children's parameters first, in
registration order, then its own; ``gluon_param_order`` walks a port
module the same way, and the port's BERT modules register their children
in the JAX package's order, so the two sequences align one to one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["params_from_jax", "gpt_param_names", "bert_params_from_jax",
           "gluon_param_order"]

_BLOCK = ("ln1.gamma", "ln1.beta", "attn.qkv.weight", "attn.qkv.bias",
          "attn.proj.weight", "attn.proj.bias", "ln2.gamma", "ln2.beta",
          "ffn_in.weight", "ffn_in.bias", "ffn_out.weight", "ffn_out.bias")


def gpt_param_names(num_layers: int):
    """The port's state-dict keys, in the JAX ``collect_params`` order."""
    names = ["word_embed.weight", "position_embed.weight"]
    for i in range(num_layers):
        names += [f"blocks.{i}.{n}" for n in _BLOCK]
    return names + ["ln_f.gamma", "ln_f.beta"]


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes, from a bf16 model
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))      # a writable copy


def params_from_jax(arrays) -> dict:
    """``arrays``: the JAX GPT model's parameters as numpy arrays in
    ``collect_params()`` order. Returns the port's ``state_dict`` (CPU
    tensors; ``model.load_state_dict`` moves them to the model's device
    and dtype). Raises ``MXNetError`` on a count or shape mismatch."""
    arrays = [np.asarray(a) for a in arrays]
    n = len(arrays)
    if n < 16 or (n - 4) % 12:
        raise MXNetError(f"{n} arrays is not 2 + 12 L + 2 for any L >= 1")
    L = (n - 4) // 12
    if arrays[0].ndim != 2 or arrays[1].ndim != 2:
        raise MXNetError("the first two arrays must be the word and "
                         "position embeddings")
    V, U = arrays[0].shape
    T = arrays[1].shape[0]
    Hd = arrays[2 + 8].shape[0]              # ffn_in weight (hidden, units)
    block_shapes = [(U,), (U,), (3 * U, U), (3 * U,), (U, U), (U,),
                    (U,), (U,), (Hd, U), (Hd,), (U, Hd), (U,)]
    expect = [(V, U), (T, U)] + block_shapes * L + [(U,), (U,)]
    names = gpt_param_names(L)
    out = {}
    for name, a, shp in zip(names, arrays, expect):
        if tuple(a.shape) != shp:
            raise MXNetError(f"parameter {name}: shape {tuple(a.shape)} "
                             f"!= expected {shp}")
        out[name] = _to_tensor(a)
    return out


def gluon_param_order(module, prefix=""):
    """[(state-dict name, parameter)] of a port module in gluon's
    ``collect_params`` order: each submodule's parameters (recursively, in
    registration order), then the module's own."""
    out = []
    for name, child in module.named_children():
        out += gluon_param_order(child, f"{prefix}{name}.")
    for name, p in module.named_parameters(recurse=False):
        out.append((prefix + name, p))
    return out


def bert_params_from_jax(model, params) -> dict:
    """``params``: the JAX ``BERTForPretraining`` (or ``BERTModel``)
    parameters as numpy arrays in ``collect_params()`` order — a dict of
    names to arrays, or a sequence of arrays. ``model``: the port's model
    of the same configuration. Returns its ``state_dict`` (CPU tensors,
    each in the JAX array's dtype; ``load_state_dict`` moves them to the
    model's device). The tied decoder reads ``bert.word_embed.weight``, so
    it follows the word embedding. Raises ``MXNetError`` on a count,
    kind, shape or dtype mismatch."""
    names = list(params) if isinstance(params, dict) else None
    arrays = [np.asarray(a) for a in (params.values()
                                      if isinstance(params, dict)
                                      else params)]
    order = gluon_param_order(model)
    if len(arrays) != len(order):
        raise MXNetError(f"{len(arrays)} arrays for a model of "
                         f"{len(order)} parameters")
    out = {}
    for i, ((name, p), a) in enumerate(zip(order, arrays)):
        kind = name.rsplit(".", 1)[-1].rsplit("_", 1)[-1]
        if names is not None and not names[i].endswith(kind):
            raise MXNetError(f"parameter {name}: JAX parameter {names[i]} "
                             f"is not a {kind}")
        if tuple(a.shape) != tuple(p.shape):
            raise MXNetError(f"parameter {name}: shape {tuple(a.shape)} "
                             f"!= expected {tuple(p.shape)}")
        t = _to_tensor(a)
        if t.dtype != p.dtype:
            raise MXNetError(f"parameter {name}: dtype {t.dtype} != "
                             f"expected {p.dtype}")
        out[name] = t
    return out
