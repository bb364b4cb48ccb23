"""Fused optimizer updates: the port of the JAX package's
``incubator_mxnet_tpu/ops/optimizer_ops.py`` for the optimizers the port
has (SGD, Adam, LAMB), as plain tensor functions.

Each returns new tensors and leaves its inputs untouched. Scalars (``lr``,
``t``, ``rescale_grad``) may be Python numbers or 0-d tensors; a trainer
passes 0-d f32 device tensors, so f32 arithmetic follows, as in the JAX
package's traced step. Clipping applies to the rescaled gradient, before
the moments.

The LAMB phases also take equal-length LISTS of tensors (and per-tensor
``wd`` / ``lr`` / ``t``): one multi-tensor pass (``torch._foreach_*``)
over every parameter instead of a dozen small ops per parameter. A single
tensor is the one-element case of the same code.
"""

from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update",
           "lamb_update_phase1", "lamb_update_phase2"]


def _rescale_clip(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    return weight - lr * g


def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (new_weight, new_mom)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (new_weight, new_mean, new_var). Bias correction is folded
    into ``lr`` by the optimizer, as in the reference."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * torch.square(g)
    new_weight = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_weight, new_mean, new_var


def _tensors(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _per_tensor(x):
    """A scalar (number or 0-d tensor) as is; a sequence as a list (the
    foreach ops' per-tensor scalars)."""
    return list(x) if isinstance(x, (list, tuple)) else x


def _out(single, xs):
    return xs[0] if single else xs


def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB phase 1, the raw update direction: returns (update, new_mean,
    new_var). ``t`` is the step count (a 0-d tensor in a trainer); with
    lists, ``t`` and ``wd`` may be per tensor."""
    single = torch.is_tensor(weight)
    W, G, Mn, V = (_tensors(x) for x in (weight, grad, mean, var))
    g = torch._foreach_mul(G, rescale_grad)
    if clip_gradient is not None and clip_gradient > 0:
        g = torch._foreach_clamp_max(
            torch._foreach_clamp_min(g, -clip_gradient), clip_gradient)
    new_mean = torch._foreach_add(torch._foreach_mul(Mn, beta1),
                                  torch._foreach_mul(g, 1.0 - beta1))
    new_var = torch._foreach_add(
        torch._foreach_mul(V, beta2),
        torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - beta2))
    if bias_correction:
        t = _per_tensor(t)
        if isinstance(t, list):
            c1 = [1.0 - beta1 ** ti for ti in t]
            c2 = [1.0 - beta2 ** ti for ti in t]
        else:
            c1, c2 = 1.0 - beta1 ** t, 1.0 - beta2 ** t
        mean_hat = torch._foreach_div(new_mean, c1)
        var_hat = torch._foreach_div(new_var, c2)
    else:
        mean_hat, var_hat = new_mean, new_var
    update = torch._foreach_div(
        mean_hat, torch._foreach_add(torch._foreach_sqrt(var_hat), epsilon))
    update = torch._foreach_add(update,
                                torch._foreach_mul(W, _per_tensor(wd)))
    return (_out(single, update), _out(single, new_mean),
            _out(single, new_var))


def lamb_update_phase2(weight, g_update, r1=None, r2=None, lr=0.001,
                       lower_bound=-1.0, upper_bound=-1.0):
    """LAMB phase 2, the trust-ratio step: r1 = ||weight||, r2 =
    ||update|| over each whole tensor (or given); r1 is bounded to
    [lower_bound, upper_bound] where those are > 0; the ratio is r1 / r2
    where both are > 0, else 1. With lists, ``lr`` may be per tensor."""
    single = torch.is_tensor(weight)
    W, U = _tensors(weight), _tensors(g_update)
    if r1 is None:
        r1 = torch.stack(torch._foreach_norm(W))
    if r2 is None:
        r2 = torch.stack(torch._foreach_norm(U))
    if lower_bound is not None and lower_bound > 0:
        r1 = torch.clamp(r1, min=lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1 = torch.clamp(r1, max=upper_bound)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, 1.0)
    if isinstance(lr, (list, tuple)):
        lr = torch.stack([torch.as_tensor(x, dtype=ratio.dtype,
                                          device=ratio.device) for x in lr])
    step = (lr * ratio).reshape(-1)
    new = torch._foreach_sub(W, torch._foreach_mul(U, list(step.unbind())))
    return _out(single, new)
