"""Optimizers: the port of the JAX package's
``incubator_mxnet_tpu/optimizer/optimizer.py`` for SGD, Adam and LAMB.

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
tensors (``_traced_t`` / ``_traced_lr``), as the JAX package's traced
scalars are.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..base import MXNetError
from . import ops

__all__ = ["Optimizer", "SGD", "Adam", "LAMB", "create", "register"]

_REGISTRY: Dict[str, type] = {}


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
        """The step count: a 0-d tensor inside a trainer's step, else the
        parameter's own update count."""
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

    def __init__(self, momentum=0.0, **kwargs):
        kwargs.pop("lazy_update", None)       # row_sparse only: no-op here
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
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
                 epsilon=1e-8, **kwargs):
        kwargs.pop("lazy_update", None)
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._step_t(index)
        lr = self._get_lr(index)
        lr = lr * (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)
        mean, var = state
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
