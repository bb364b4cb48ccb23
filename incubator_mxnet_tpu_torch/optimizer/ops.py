"""Fused optimizer updates: the port of the JAX package's
``incubator_mxnet_tpu/ops/optimizer_ops.py``, as plain tensor functions
(SGD, NAG, Adam, AdamW, RMSProp and its centered form, Ftrl, signSGD /
Signum, LAMB, LARS's trust ratio, FTML, AdaGrad, AdaDelta).

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

__all__ = ["sgd_update", "sgd_mom_update", "nag_mom_update", "adam_update",
           "adamw_update", "rmsprop_update", "rmspropalex_update",
           "ftrl_update", "signsgd_update", "signum_update",
           "lamb_update_phase1", "lamb_update_phase2", "lars_lr",
           "ftml_update", "adagrad_update", "adadelta_update"]


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


def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov momentum; returns (new_weight, new_mom)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


def adamw_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """Adam with decoupled weight decay; returns (new_weight, new_mean,
    new_var)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * torch.square(g)
    new_weight = weight - eta * (lr * new_mean / (torch.sqrt(new_var)
                                                  + epsilon) + wd * weight)
    return new_weight, new_mean, new_var


def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    """Returns (new_weight, new_n)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1.0 - gamma1) * torch.square(g)
    new_weight = weight - lr * g / torch.sqrt(new_n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        new_weight = torch.clamp(new_weight, -clip_weights, clip_weights)
    return new_weight, new_n


def rmspropalex_update(weight, grad, n, g_avg, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    """Centered RMSProp; returns (new_weight, new_n, new_g, new_delta)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1.0 - gamma1) * torch.square(g)
    new_g = gamma1 * g_avg + (1.0 - gamma1) * g
    new_delta = gamma2 * delta - \
        lr * g / torch.sqrt(new_n - torch.square(new_g) + epsilon)
    return weight + new_delta, new_n, new_g, new_delta


def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (new_weight, new_z, new_n)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_weight = torch.where(
        torch.abs(new_z) > lamda1,
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd),
        torch.zeros((), dtype=weight.dtype, device=weight.device))
    return new_weight, new_z, new_n


def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """Returns (new_weight, new_mom)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_mom = momentum * mom - (1.0 - momentum) * g
    new_weight = (1.0 - lr * wd_lh) * weight + lr * torch.sign(new_mom)
    return new_weight, new_mom


def lars_lr(lr, weight, grad, wd=0.0, eta=0.001, eps=1e-8,
            rescale_grad=1.0):
    """LARS's layer-wise learning rate: ``lr`` times the trust ratio
    eta ||w|| / (||g|| + wd ||w|| + eps) (1 where a norm is 0), the norms
    from f32 sums of squares (the JAX package's multi_sum_sq /
    multi_lars)."""
    w_norm = torch.sqrt(torch.sum(torch.square(weight.float())))
    g_norm = torch.sqrt(torch.sum(torch.square(grad.float()))) * \
        rescale_grad
    trust = torch.where((w_norm > 0) & (g_norm > 0),
                        eta * w_norm / (g_norm + wd * w_norm + eps),
                        torch.ones_like(w_norm))
    return lr * trust


def ftml_update(weight, grad, d, v, z, lr=0.0025, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0,
                t=1):
    """FTML; returns (new_weight, new_d, new_v, new_z). The clip applies to
    the whole rescale * grad + wd * weight."""
    g = grad * rescale_grad + wd * weight
    if clip_grad is not None and clip_grad > 0:
        g = torch.clamp(g, -clip_grad, clip_grad)
    new_v = beta2 * v + (1 - beta2) * torch.square(g)
    bias2 = 1 - beta2 ** t
    d_t = (1 - beta1 ** t) / lr * (torch.sqrt(new_v / bias2) + epsilon)
    sigma = d_t - beta1 * d
    new_z = beta1 * z + (1 - beta1) * g - sigma * weight
    new_w = -new_z / d_t
    return (new_w.to(weight.dtype), d_t.to(d.dtype), new_v,
            new_z.to(z.dtype))


def adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (new_weight, new_history); epsilon inside the sqrt."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_hist = history + torch.square(g)
    return weight - lr * g / torch.sqrt(new_hist + epsilon), new_hist


def adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (new_weight, new_acc_g, new_acc_delta)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient) + wd * weight
    new_acc_g = rho * acc_g + (1 - rho) * torch.square(g)
    delta = torch.sqrt(acc_delta + epsilon) / \
        torch.sqrt(new_acc_g + epsilon) * g
    new_acc_delta = rho * acc_delta + (1 - rho) * torch.square(delta)
    return weight - delta, new_acc_g, new_acc_delta


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
