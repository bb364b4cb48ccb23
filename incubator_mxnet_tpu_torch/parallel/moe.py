"""Mixture-of-Experts with expert parallelism over the ``ep`` mesh axis:
the port of the JAX package's ``incubator_mxnet_tpu/parallel/moe.py``.

Top-1 (Switch) routing with capacity, written as the JAX module writes
it: dense one-hot dispatch and combine einsums in f32 (static shapes, no
per-token control flow), tokens past an expert's capacity DROPPED
(their output is zero: the caller's residual carries them), the output
scaled by the gate, and the load-balancing auxiliary loss
E * sum_e fraction_e * mean_prob_e returned beside it.

The expert dimension is split over ``ep`` through ``spmd.constrain``:
each rank runs its E / ep experts (one ``expert_fn`` call a local
expert) on its slice of the (E, C, D) dispatched tokens. Where the JAX
program lets XLA move the tokens with an all_to_all between the token and
the expert layouts, the port's ranks each route the tokens they hold
(every rank of the ep axis holds the same tokens) and exchange the
experts' outputs with an all-gather over ep (``constrain`` leaving the
axis; its backward reduce-scatters). Every rank keeps the stacked expert
parameters whole and reads its experts' slice, so its gradient for the
other experts is zero; with the port's convention (a rank's gradients
are those of the SUM of every rank's loss, ``parallel/spmd.py``) the
mean over the ep ranks is one loss's gradient.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["switch_moe", "stack_expert_params"]


def stack_expert_params(param_trees):
    """Stack E per-expert pytrees of tensors on a leading expert
    dimension."""
    if not param_trees:
        raise MXNetError("stack_expert_params needs at least one expert")
    return pytree.tree_map(lambda *xs: torch.stack(xs), *param_trees)


def _constrain(x, mesh, *spec, src=None):
    from .spmd import constrain
    return constrain(x, *spec, mesh=mesh, src=src)


def switch_moe(x, gate_logits, expert_fn: Callable, expert_params,
               capacity_factor: float = 1.25, mesh=None,
               axis: str = "ep", token_axis: str = "dp"):
    """Top-1 sparse MoE layer.

    ``x`` (N, D) tokens (flatten batch x sequence first), ``gate_logits``
    (N, E), ``expert_fn(params_slice, h (C, D)) -> (C, D)`` one expert's
    FFN, ``expert_params`` a pytree with leading expert dimension E.
    Returns ``(out (N, D) in x's dtype, aux_loss)``; dropped tokens come
    back as zeros. ``mesh`` (default: the active step's) splits the
    experts over ``axis``; ``token_axis`` is the JAX argument (the tokens
    are the rank's, see the module's docstring). Tensors or ``NDArray``s
    in, the same out."""
    is_nd = isinstance(x, NDArray)
    xt = x._data if is_nd else x
    gl = gate_logits._data if isinstance(gate_logits, NDArray) \
        else gate_logits
    N, D = xt.shape
    E = gl.shape[-1]
    C = max(1, math.ceil(N / E * capacity_factor))

    probs = torch.softmax(gl.float(), dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)                # first on ties
    gate = probs.gather(-1, expert_idx[:, None])[:, 0]       # (N,)
    onehot = F.one_hot(expert_idx, E).float()                # (N, E)
    # each token's place in its expert's queue
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0         # (N, E)
    keep = (pos < C).float() * onehot                        # (N, E)
    dispatch = keep[..., None] * F.one_hot(
        pos.clamp(0, C - 1).long(), C).float()               # (N, E, C)

    expert_in = torch.einsum("nec,nd->ecd", dispatch, xt.float())
    local_in = _constrain(expert_in, mesh, axis, None, None)
    local = pytree.tree_map(
        lambda p: _constrain(p, mesh, axis, *([None] * (p.dim() - 1))),
        expert_params)
    outs = [expert_fn(pytree.tree_map(lambda p: p[e], local),
                      local_in[e].to(xt.dtype))
            for e in range(local_in.shape[0])]
    expert_out = _constrain(torch.stack(outs).float(), mesh, None, None,
                            None, src=(axis, None, None))
    out = torch.einsum("nec,ecd->nd", dispatch, expert_out)   # (N, D)
    out = out * gate[:, None]

    frac_tokens = onehot.mean(dim=0)                         # (E,)
    mean_prob = probs.mean(dim=0)                            # (E,)
    aux = E * torch.sum(frac_tokens * mean_prob)
    out = out.to(xt.dtype)
    return (NDArray(out), NDArray(aux)) if is_nd else (out, aux)
