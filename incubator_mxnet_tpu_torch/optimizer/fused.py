"""Whole-tree optimizer application and the non-finite guard: the port of
the JAX package's ``incubator_mxnet_tpu/optimizer/fused.py``
(``apply_updates``, ``all_finite``, ``norm_based``).

``apply_updates`` runs an ``Optimizer``'s functional update over every
trainable parameter with the step count ``t``, the learning rate ``lr``
and (optionally) ``rescale_grad`` as 0-d device tensors: nothing about a
step is staged as a host constant, so ``parallel.SPMDTrainer``'s step
graph replays it with each step's values, as the JAX package's jitted
step takes them as traced scalars. What the optimizer holds on the host
(wd, betas, epsilon, clipping, trust-ratio bounds) is read when the step
is built and baked into its graph. New weights and states keep their old
dtypes. LAMB runs as one multi-tensor pass over every parameter
(``LAMB.update_many``), the other optimizers one parameter at a time;
the functions read nothing back from the device, so they run inside a
CUDA graph capture.
"""

from __future__ import annotations

import torch

__all__ = ["apply_updates", "all_finite", "norm_based", "tree_map",
           "tree_leaves"]


def norm_based(optimizer) -> bool:
    """True for optimizers whose update reads a whole-tensor weight /
    update norm (LAMB and LARS trust ratios): correct only over full
    parameter values, never over shards."""
    name = type(optimizer).__name__.lower()
    return any(t in name for t in ("lamb", "lars"))


def all_finite(grad_vals):
    """An f32 0-d tensor on the gradients' device: 1.0 when every entry of
    every floating gradient is finite, else 0.0. The guard reduction the
    trainer selects on."""
    flags = [torch.isfinite(g).all() for g in grad_vals
             if g.is_floating_point()]
    if not flags:
        return torch.ones((), dtype=torch.float32)
    return torch.stack(flags).all().float()


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of equally shaped trees of tuples,
    lists and None (optimizer states)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    """The tensor leaves of a tree of tuples, lists and None, in
    ``tree_map``'s order."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def apply_updates(optimizer, indices, weight_vals, grad_vals, states, t,
                  lr, rescale_grad=None):
    """Functional whole-tree optimizer application.

    ``indices``: the parameters' optimizer indices; ``weight_vals`` /
    ``grad_vals``: tensors aligned to them; ``states``: their optimizer
    states. ``t``: the step count (a 0-d tensor; the JAX package's
    per-parameter count vector serves its eager Trainer, not ported);
    ``lr``: the base learning rate (the per-parameter multipliers apply
    inside); ``rescale_grad``, when given, replaces
    ``optimizer.rescale_grad`` for this call. One
    ``update_many_multi_precision`` call covers every parameter. Returns
    ``(new_weights, new_states)``, tuples aligned to ``indices``."""
    saved_rescale = optimizer.rescale_grad
    optimizer._traced_lr = lr
    if rescale_grad is not None:
        optimizer.rescale_grad = rescale_grad
    optimizer._traced_t = t
    try:
        new_w, new_s = optimizer.update_many_multi_precision(
            list(indices), list(weight_vals), list(grad_vals), list(states))
    finally:
        optimizer._traced_t = optimizer._traced_lr = None
        optimizer.rescale_grad = saved_rescale
    return (tuple(nw.to(w.dtype) for nw, w in zip(new_w, weight_vals)),
            tuple(tree_map(lambda old, new: new.to(old.dtype), s, ns)
                  for s, ns in zip(states, new_s)))
