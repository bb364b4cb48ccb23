"""Optimizers: the port of the JAX package's
``incubator_mxnet_tpu/optimizer/optimizer.py``: SGD, NAG, Adam, AdamW,
RMSProp, Ftrl, Signum, LAMB, LARS, FTML, AdaGrad, AdaDelta, Adamax,
Nadam, DCASGD and SGLD, with ``Updater`` / ``get_updater``.

The parity surface is the reference's: ``rescale_grad``, ``wd``,
``clip_gradient``, ``learning_rate`` (or an ``lr_scheduler`` of the update
count), per-parameter lr / wd multipliers, and ``multi_precision`` (an f32
master copy of every low-precision weight, updated in f32 and cast back).

Updates are functional: ``update(index, weight, grad, state)`` returns
``(new_weight, new_state)`` and mutates no tensor, so a trainer can
select between the old and new values on a device flag (the non-finite
guard). ``update_many`` does the same over several parameters at once
(LAMB in one multi-tensor pass; the others loop ``update``). Inside
``fused.apply_updates`` the step count and learning rate are 0-d device
tensors (``_traced_t`` / ``_traced_lr``; the step count may be one per
parameter), as the JAX package's traced scalars are. Nadam (its momentum
schedule) and SGLD (a fresh draw per update) keep host state from step to
step and set ``fusable = False``: gluon's Trainer runs them eagerly.
``Updater`` holds the per-parameter states of gluon's Trainer and writes
each update into the weight and the state tensors in place.

The one exception to the functional form is the lazy update (SGD, with
or without momentum, and Adam, ``lazy_update=True``, the default): given
a ``RowSparseNDArray`` gradient, ``update`` runs the registered update
op on the active rows and writes them into the weight and the state in
place (``_rows_update``), returning those same tensors; the rows outside
the active set stay bit-identical, momentum included.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

from ..base import MXNetError
from . import ops

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "RMSProp", "Ftrl",
           "Signum", "LAMB", "LARS", "FTML", "AdaGrad", "AdaDelta", "Adamax",
           "Nadam", "DCASGD", "SGLD", "Updater", "create", "register",
           "get_updater"]

_REGISTRY: Dict[str, type] = {}


def _rows_update(weight, grad, states, op_name, **op_kwargs):
    """The lazy row_sparse update: the registered update op ``op_name``
    (``ops/optimizer_ops.py``) on the gradient's active rows only, each
    result written back into its rows IN PLACE (``index_copy_`` into the
    weight and every state tensor, which CUDA graphs hold by address).
    Rows outside the active set are neither read nor written."""
    from ..ndarray import NDArray
    from ..ndarray.register import invoke_by_name
    idx = grad._sp_indices.long()
    rows = [NDArray(t.index_select(0, idx)) for t in [weight] + states]
    out = invoke_by_name(op_name, rows[0], NDArray(grad._sp_values),
                         *rows[1:], **op_kwargs)
    outs = out if isinstance(out, (list, tuple)) else (out,)
    with torch.no_grad():
        for t, new in zip([weight] + states, outs):
            t.index_copy_(0, idx, new._data.to(t.dtype))


def _lazy(optimizer, grad) -> bool:
    from ..ndarray.sparse import RowSparseNDArray
    return isinstance(grad, RowSparseNDArray) and optimizer.lazy_update


def register(name, aliases=()):
    """Class decorator: make the optimizer creatable by ``name``."""
    def deco(cls):
        for n in (name,) + tuple(aliases):
            _REGISTRY[n.lower()] = cls
        return cls
    return deco


def create(name, **kwargs) -> "Optimizer":
    if isinstance(name, Optimizer):
        return name
    cls = _REGISTRY.get(str(name).lower())
    if cls is None:
        raise MXNetError(f"unknown optimizer {name!r} (one of "
                         f"{sorted(_REGISTRY)})")
    return cls(**kwargs)


class Optimizer:
    """Base optimizer."""

    #: ``update`` is a pure function of (weight, grad, state, t, lr): safe
    #: to capture once and replay (``fused.FusedApplier``)
    fusable = True

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False, param_dict=None, **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and hasattr(lr_scheduler, "base_lr"):
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient if clip_gradient is not None \
            else -1.0
        self.multi_precision = multi_precision
        self.num_update = 0
        self._index_update_count: Dict[int, int] = {}
        self._traced_t = None
        self._traced_lr = None
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.lr_mult: Dict[str, float] = {}
        self.wd_mult: Dict[str, float] = {}

    # -- learning rate ------------------------------------------------- #
    @property
    def learning_rate(self) -> float:
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler(self.num_update))
        return self.lr

    def set_learning_rate(self, lr: float):
        if self.lr_scheduler is not None:
            raise MXNetError("cannot set lr directly when lr_scheduler is "
                             "set")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult: Dict[str, float]):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict[str, float]):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index: int):
        count = self._index_update_count.get(index, 0) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    def _step_t(self, index):
        """The step count: a 0-d tensor inside a trainer's step (or one
        per parameter index), else the parameter's own update count."""
        if isinstance(self._traced_t, dict):
            return self._traced_t[index]
        if self._traced_t is not None:
            return self._traced_t
        return self._index_update_count[index]

    def _mult(self, index, attr, table):
        name = self.idx2name.get(index, index)
        param = self.param_dict.get(name)
        if param is not None and hasattr(param, attr):
            return getattr(param, attr)
        return table.get(name, 1.0)

    def _get_lr(self, index):
        lr = self._traced_lr if self._traced_lr is not None \
            else self.learning_rate
        return lr * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    # -- state --------------------------------------------------------- #
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and weight.dtype != torch.float32:
            master = weight.detach().float()
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        """Returns (new_weight, new_state)."""
        raise NotImplementedError

    def update_many(self, indices, weights, grads, states):
        """``update`` over several parameters: returns (new_weights,
        new_states), lists aligned to ``indices``."""
        out = [self.update(i, w, g, s)
               for i, w, g, s in zip(indices, weights, grads, states)]
        return [o[0] for o in out], [o[1] for o in out]

    def update_many_multi_precision(self, indices, weights, grads, states):
        """``update_many`` on the f32 master of each low-precision weight
        (its gradient cast to f32); such a weight's new value is its new
        master cast back."""
        mp = [self.multi_precision and w.dtype != torch.float32
              for w in weights]
        new_w, new_s = self.update_many(
            indices, [s[0] if m else w for m, w, s in zip(mp, weights,
                                                          states)],
            [g.float() if m else g for m, g in zip(mp, grads)],
            [s[1] if m else s for m, s in zip(mp, states)])
        return ([nw.to(w.dtype) if m else nw
                 for m, nw, w in zip(mp, new_w, weights)],
                [(nw, ns) if m else ns
                 for m, nw, ns in zip(mp, new_w, new_s)])

    def update_multi_precision(self, index, weight, grad, state):
        """``update_many_multi_precision`` of one parameter."""
        new_w, new_s = self.update_many_multi_precision([index], [weight],
                                                        [grad], [state])
        return new_w[0], new_s[0]


@register("sgd")
class SGD(Optimizer):
    """SGD with momentum (reference: optimizer.py SGD + sgd_mom_update)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        """With a ``RowSparseNDArray`` gradient and ``lazy_update`` the
        active rows are written in place and ``(weight, state)`` come
        back as they are (the same tensors)."""
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if _lazy(self, grad):
            kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                      clip_gradient=self.clip_gradient)
            if state is None:
                _rows_update(weight, grad, [], "sgd_update", **kw)
            else:
                _rows_update(weight, grad, [state], "sgd_mom_update",
                             momentum=self.momentum, **kw)
            return weight, state
        grad = getattr(grad, "_data", grad)
        if state is None:
            return ops.sgd_update(weight, grad, lr=lr, wd=wd,
                                  rescale_grad=self.rescale_grad,
                                  clip_gradient=self.clip_gradient), None
        return ops.sgd_mom_update(weight, grad, state, lr=lr,
                                  momentum=self.momentum, wd=wd,
                                  rescale_grad=self.rescale_grad,
                                  clip_gradient=self.clip_gradient)


@register("adam")
class Adam(Optimizer):
    """(reference: optimizer.py Adam + adam_update). Bias correction is
    folded into lr, as in the reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def update(self, index, weight, grad, state):
        """A ``RowSparseNDArray`` gradient with ``lazy_update`` updates
        the active rows in place, as ``SGD.update`` does."""
        self._update_count(index)
        t = self._step_t(index)
        lr = self._get_lr(index)
        lr = lr * (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)
        mean, var = state
        if _lazy(self, grad):
            _rows_update(weight, grad, [mean, var], "adam_update", lr=lr,
                         beta1=self.beta1, beta2=self.beta2,
                         epsilon=self.epsilon, wd=self._get_wd(index),
                         rescale_grad=self.rescale_grad,
                         clip_gradient=self.clip_gradient)
            return weight, state
        grad = getattr(grad, "_data", grad)
        new_w, new_mean, new_var = ops.adam_update(
            weight, grad, mean, var, lr=lr, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, wd=self._get_wd(index),
            rescale_grad=self.rescale_grad,
            clip_gradient=self.clip_gradient)
        return new_w, (new_mean, new_var)


@register("lamb")
class LAMB(Optimizer):
    """Layer-wise adaptive moments for large-batch BERT pretraining
    (reference: optimizer.py LAMB + lamb_update_phase1/2)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound = lower_bound if lower_bound is not None else -1.0
        self.upper_bound = upper_bound if upper_bound is not None else -1.0
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def update(self, index, weight, grad, state):
        new_w, new_s = self.update_many([index], [weight], [grad], [state])
        return new_w[0], new_s[0]

    def update_many(self, indices, weights, grads, states):
        """Both LAMB phases over every parameter in one multi-tensor pass;
        the trust-ratio norms stay per parameter."""
        for i in indices:
            self._update_count(i)
        ts = [self._step_t(i) for i in indices]
        t = ts[0] if all(x is ts[0] for x in ts) else ts
        wds = [self._get_wd(i) for i in indices]
        wd = wds[0] if len(set(wds)) == 1 else wds
        lr = self._traced_lr if self._traced_lr is not None \
            else self.learning_rate
        mults = [self._mult(i, "lr_mult", self.lr_mult) for i in indices]
        if any(m != 1.0 for m in mults):
            lr = [lr * m for m in mults]
        g_upd, new_mean, new_var = ops.lamb_update_phase1(
            list(weights), list(grads), [s[0] for s in states],
            [s[1] for s in states], beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon, t=t, bias_correction=self.bias_correction,
            wd=wd, rescale_grad=self.rescale_grad,
            clip_gradient=self.clip_gradient)
        new_w = ops.lamb_update_phase2(
            list(weights), g_upd, lr=lr, lower_bound=self.lower_bound,
            upper_bound=self.upper_bound)
        return new_w, list(zip(new_mean, new_var))


def _zeros(weight, n):
    return tuple(torch.zeros_like(weight) for _ in range(n))


def _clip(g, clip_gradient):
    if clip_gradient is not None and clip_gradient > 0:
        return torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@register("nag")
class NAG(Optimizer):
    """SGD with Nesterov momentum."""

    def __init__(self, momentum=0.9, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        return ops.nag_mom_update(
            weight, grad, state, lr=self._get_lr(index),
            momentum=self.momentum, wd=self._get_wd(index),
            rescale_grad=self.rescale_grad,
            clip_gradient=self.clip_gradient)


@register("adamw")
class AdamW(Adam):
    """Adam with decoupled weight decay (a row-sparse gradient updates
    every row, as the JAX AdamW does)."""

    def update(self, index, weight, grad, state):
        grad = getattr(grad, "_data", grad)
        self._update_count(index)
        t = self._step_t(index)
        lr = self._get_lr(index)
        lr = lr * (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)
        mean, var = state
        new_w, new_mean, new_var = ops.adamw_update(
            weight, grad, mean, var, lr=lr, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, wd=self._get_wd(index),
            rescale_grad=self.rescale_grad,
            clip_gradient=self.clip_gradient)
        return new_w, (new_mean, new_var)


@register("rmsprop")
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights if clip_weights is not None \
            else -1.0

    def create_state(self, index, weight):
        if self.centered:
            return _zeros(weight, 3)
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if self.centered:
            n, g_avg, delta = state
            new_w, new_n, new_g, new_delta = ops.rmspropalex_update(
                weight, grad, n, g_avg, delta, lr=lr, gamma1=self.gamma1,
                gamma2=self.gamma2, epsilon=self.epsilon, wd=wd,
                rescale_grad=self.rescale_grad,
                clip_gradient=self.clip_gradient)
            return new_w, (new_n, new_g, new_delta)
        return ops.rmsprop_update(
            weight, grad, state, lr=lr, gamma1=self.gamma1,
            epsilon=self.epsilon, wd=wd, rescale_grad=self.rescale_grad,
            clip_gradient=self.clip_gradient,
            clip_weights=self.clip_weights)


@register("ftrl")
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        new_w, new_z, new_n = ops.ftrl_update(
            weight, grad, z, n, lr=self._get_lr(index), lamda1=self.lamda1,
            beta=self.beta, wd=self._get_wd(index),
            rescale_grad=self.rescale_grad,
            clip_gradient=self.clip_gradient)
        return new_w, (new_z, new_n)


@register("signum")
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is None:
            return ops.signsgd_update(weight, grad, lr=lr, wd=wd,
                                      rescale_grad=self.rescale_grad,
                                      clip_gradient=self.clip_gradient), \
                None
        return ops.signum_update(
            weight, grad, state, lr=lr, momentum=self.momentum, wd=wd,
            rescale_grad=self.rescale_grad,
            clip_gradient=self.clip_gradient, wd_lh=self.wd_lh)


@register("lars")
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling: the trust ratio rescales each
    parameter's learning rate, then momentum SGD steps."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        lr_eff = ops.lars_lr(lr, weight, grad, wd=wd, eta=self.eta,
                             eps=self.epsilon,
                             rescale_grad=self.rescale_grad)
        if state is None:
            return ops.sgd_update(weight, grad, lr=lr_eff, wd=wd,
                                  rescale_grad=self.rescale_grad,
                                  clip_gradient=self.clip_gradient), None
        return ops.sgd_mom_update(weight, grad, state, lr=lr_eff,
                                  momentum=self.momentum, wd=wd,
                                  rescale_grad=self.rescale_grad,
                                  clip_gradient=self.clip_gradient)


@register("ftml")
class FTML(Optimizer):
    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 3)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        d, v, z = state
        new_w, new_d, new_v, new_z = ops.ftml_update(
            weight, grad, d, v, z, lr=self._get_lr(index), beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, wd=self._get_wd(index),
            rescale_grad=self.rescale_grad, clip_grad=self.clip_gradient,
            t=self._step_t(index))
        return new_w, (new_d, new_v, new_z)


@register("adagrad")
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        return ops.adagrad_update(
            weight, grad, state, lr=self._get_lr(index),
            epsilon=self.float_stable_eps, wd=self._get_wd(index),
            rescale_grad=self.rescale_grad,
            clip_gradient=self.clip_gradient)


@register("adadelta")
class AdaDelta(Optimizer):
    def __init__(self, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        acc_g, acc_delta = state
        new_w, new_g, new_d = ops.adadelta_update(
            weight, grad, acc_g, acc_delta, rho=self.rho,
            epsilon=self.epsilon, wd=self._get_wd(index),
            rescale_grad=self.rescale_grad,
            clip_gradient=self.clip_gradient)
        return new_w, (new_g, new_d)


@register("adamax")
class Adamax(Optimizer):
    """Adam with an infinity-norm second moment; weight decay folds in
    before clipping."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._step_t(index)
        lr = self._get_lr(index) / (1.0 - self.beta1 ** t)
        g = _clip(grad * self.rescale_grad + self._get_wd(index) * weight,
                  self.clip_gradient)
        m, u = state
        new_m = self.beta1 * m + (1.0 - self.beta1) * g
        new_u = torch.maximum(self.beta2 * u, torch.abs(g))
        return weight - lr * new_m / (new_u + self.epsilon), (new_m, new_u)


@register("nadam")
class Nadam(Optimizer):
    """Nesterov Adam with the 0.96^(t * schedule_decay) momentum schedule,
    a host product carried from update to update."""

    fusable = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._step_t(index)
        lr = self._get_lr(index)
        g = _clip(grad * self.rescale_grad + self._get_wd(index) * weight,
                  self.clip_gradient)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m, v = state
        new_m = self.beta1 * m + (1.0 - self.beta1) * g
        new_v = self.beta2 * v + (1.0 - self.beta2) * g * g
        g_prime = g / (1.0 - self.m_schedule)
        m_prime = new_m / (1.0 - m_schedule_next)
        v_prime = new_v / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
        return weight - lr * m_bar / (torch.sqrt(v_prime) + self.epsilon), \
            (new_m, new_v)


@register("dcasgd")
class DCASGD(Optimizer):
    """Delay-compensated SGD: lambda g^2 (w - w_prev) compensates the
    gradient's staleness."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = torch.zeros_like(weight) if self.momentum != 0.0 else None
        return (mom, weight.detach().clone())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        g = _clip(grad * self.rescale_grad, self.clip_gradient)
        mom, prev = state
        comp = (g + self._get_wd(index) * weight
                + self.lamda * g * g * (weight - prev))
        if mom is not None:
            mom = self.momentum * mom - lr * comp
            step = mom
        else:
            step = -lr * comp
        return weight + step, (mom, weight.clone())


@register("sgld")
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: a half-gradient step plus
    N(0, lr) noise drawn from ``mx.random``'s generator for the weight's
    device."""

    fusable = False

    def __init__(self, learning_rate=0.01, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)

    def update(self, index, weight, grad, state):
        from .. import random as _random
        self._update_count(index)
        lr = self._get_lr(index)
        g = _clip(grad * self.rescale_grad, self.clip_gradient)
        g = g + self._get_wd(index) * weight
        noise = torch.empty_like(weight).normal_(
            0.0, 1.0, generator=_random.generator(weight.device)) * \
            float(lr) ** 0.5
        return weight - 0.5 * lr * g + noise, None


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _host_tree(tree):
    from ..ndarray.ndarray import host_array
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host_tree(t) for t in tree)
    return host_array(tree)


def _device_tree(tree, device):
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_device_tree(t, device) for t in tree)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _tensor(x):
    return x._data if hasattr(x, "_data") else x


class Updater:
    """The per-parameter optimizer states of gluon's Trainer (index ->
    state), applying one parameter's update in place (parity:
    ``get_updater``)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict = {}

    def __call__(self, index, grad, weight):
        w = _tensor(weight).detach()
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, w)
        state = self.states[index]
        opt = self.optimizer
        if getattr(opt, "lazy_update", False) and \
                getattr(grad, "stype", "default") == "row_sparse" and not (
                    opt.multi_precision and w.dtype != torch.float32):
            # SGD / Adam write the active rows in place and hand back the
            # same tensors
            new_w, new_s = opt.update(index, w, grad, state)
        else:
            new_w, new_s = opt.update_multi_precision(
                index, w, _tensor(grad).detach(), state)
        with torch.no_grad():
            if new_w is not w:
                w.copy_(new_w)
            for old, new in zip(_leaves(state), _leaves(new_s)):
                if new is not old:
                    old.copy_(new)

    def get_states(self) -> bytes:
        """The states (numpy) and the update counters, pickled."""
        payload = {
            "states": {i: _host_tree(s) for i, s in self.states.items()},
            "counters": {
                "num_update": self.optimizer.num_update,
                "index_update_count":
                    dict(self.optimizer._index_update_count)},
        }
        return pickle.dumps(payload)

    def set_states(self, states: bytes, device="cpu"):
        """Restore ``get_states``' payload: into the existing state tensors
        in place where there are, else onto ``device``."""
        data = pickle.loads(states)
        for i, tree in data["states"].items():
            new = _device_tree(tree, device)
            old = self.states.get(i)
            if old is not None and len(_leaves(old)) == len(_leaves(new)):
                with torch.no_grad():
                    for o, n in zip(_leaves(old), _leaves(new)):
                        o.copy_(n)
            else:
                self.states[i] = new
        counters = data.get("counters")
        if counters is not None:
            self.optimizer.num_update = counters["num_update"]
            self.optimizer._index_update_count = dict(
                counters["index_update_count"])


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
