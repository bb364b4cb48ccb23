"""Learning-rate schedulers: the port of the JAX package's
``incubator_mxnet_tpu/optimizer/lr_scheduler.py`` (a re-design of the
reference's ``python/mxnet/lr_scheduler.py``), with the same classes,
arguments, values and errors. Every scheduler supports the warmup protocol
the reference added for large-batch training.

A scheduler is host-side Python, a function of the update count: an
``Optimizer`` built with ``lr_scheduler=`` reads it once per step
(``Optimizer.learning_rate``), and ``parallel.SPMDTrainer`` stages that
value into its step program as a 0-d tensor, so a schedule advances
without a new build.
"""

from __future__ import annotations

import math

from ..base import MXNetError

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        if warmup_mode not in ("linear", "constant"):
            raise MXNetError(f"unknown warmup_mode {warmup_mode}")
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update: int) -> float:
        assert num_update < self.warmup_steps
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) \
                * num_update / max(self.warmup_steps, 1)
            return self.warmup_begin_lr + inc
        return self.warmup_begin_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every `step` updates (reference: FactorScheduler)."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 **kwargs):
        super().__init__(base_lr=base_lr, **kwargs)
        if step < 1:
            raise MXNetError("step must be >= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        n = (num_update - self.warmup_steps) // self.step
        lr = self.base_lr * (self.factor ** n)
        return max(lr, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each step in `step` list (reference:
    MultiFactorScheduler)."""

    def __init__(self, step, factor=1.0, base_lr=0.01, **kwargs):
        super().__init__(base_lr=base_lr, **kwargs)
        if not all(step[i] < step[i + 1] for i in range(len(step) - 1)):
            raise MXNetError("step list must be increasing")
        self.step = list(step)
        self.factor = factor

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        n = sum(1 for s in self.step if s <= num_update)
        return self.base_lr * (self.factor ** n)


class PolyScheduler(LRScheduler):
    """Polynomial decay to final_lr over max_update (reference: PolyScheduler)."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0.0, **kwargs):
        super().__init__(base_lr=base_lr, **kwargs)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr
        self.max_steps = max_update - self.warmup_steps

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / max(self.max_steps, 1)
        return self.final_lr + (self.base_lr - self.final_lr) * \
            ((1.0 - frac) ** self.power)


class CosineScheduler(LRScheduler):
    """Cosine decay (reference: CosineScheduler)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0, **kwargs):
        super().__init__(base_lr=base_lr, **kwargs)
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - self.warmup_steps

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / max(self.max_steps, 1)
        return self.final_lr + (self.base_lr - self.final_lr) * \
            (1 + math.cos(math.pi * frac)) / 2
