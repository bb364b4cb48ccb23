"""One-device fused training step: the port of the JAX package's
``incubator_mxnet_tpu/parallel/spmd.py`` ``SPMDTrainer`` for a mesh of one
device.

A step is the JAX program's sequence, run eagerly on the model's device:

  1. materialize the optimizer state (f32 masters with
     ``multi_precision``) at the first step;
  2. open the step in the ``StepRecorder``;
  3. loss x scale through autograd (the model in training mode, dropout
     drawing from the model's generator), and the gradients;
  4. ``all_finite`` over the gradients, on the device;
  5. ``apply_updates`` with ``rescale_grad = base / scale``, the step
     count ``t`` and the learning rate as 0-d device tensors;
  6. the guard: ``torch.where`` on the device flag selects the new or the
     old parameters and optimizer state, so a vetoed step leaves both
     bit-identical;
  7. one readback of the flag, which steers ``step_count``, the recorder
     (APPLIED / SKIPPED_NONFINITE / HALTED_POISONED) and the loss scaler.

Not ported, and refused with ``MXNetError``: a mesh of more than one
device, ``sharding="fsdp"``, ``pipeline=``, ``int8_allreduce``,
``remat_plan``, ``grad_collective="ring"``, ``step_microbatches`` and
checkpoint save / restore.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..base import MXNetError
from ..optimizer import create as opt_create
from ..optimizer.fused import all_finite, apply_updates, tree_map
from ..train.outcomes import StepOutcome, StepRecorder

__all__ = ["SPMDTrainer"]


def _not_ported(what):
    return MXNetError(f"SPMDTrainer: {what} is not ported (the port's "
                      f"trainer is single-device)")


class SPMDTrainer:
    """Fused train step over one device.

    Parameters follow the JAX package's: ``block`` (an ``nn.Module``),
    ``loss`` (``loss(out, *labels)``) or ``forward_loss``
    (``fn(block, *batch) -> scalar``), ``optimizer`` with
    ``optimizer_params``, ``loss_scaler`` (``amp.LossScaler``), ``guard``
    (the in-step non-finite guard, default on) and
    ``max_consecutive_nonfinite``. ``mesh`` may name one device (or be
    None); ``donate`` has no effect (the step updates the parameters in
    place)."""

    def __init__(self, block, loss=None, optimizer="sgd",
                 optimizer_params=None, mesh=None,
                 sharding: str = "replicated",
                 forward_loss: Optional[Callable] = None,
                 donate: bool = True, loss_scaler=None,
                 guard: Optional[bool] = None,
                 max_consecutive_nonfinite: Optional[int] = None,
                 pipeline=None, int8_allreduce: Optional[bool] = None,
                 grad_collective: Optional[str] = None,
                 remat_plan: Optional[Sequence] = None):
        if loss is None and forward_loss is None and pipeline is None:
            raise MXNetError("provide loss, forward_loss or pipeline")
        if mesh is not None:
            devices = list(mesh) if isinstance(mesh, (list, tuple)) \
                else [mesh]
            if len(devices) > 1:
                raise _not_ported(f"a mesh of {len(devices)} devices")
        if sharding == "fsdp":
            raise _not_ported("sharding='fsdp'")
        if sharding != "replicated":
            raise MXNetError(f"unknown sharding {sharding!r}")
        if pipeline is not None:
            raise _not_ported("pipeline=")
        if int8_allreduce:
            raise _not_ported("int8_allreduce")
        if remat_plan is not None:
            raise _not_ported("remat_plan")
        if grad_collective not in (None, "psum"):
            raise _not_ported(f"grad_collective={grad_collective!r}")
        self.block = block
        self.loss = loss
        self.forward_loss = forward_loss
        self.sharding_mode = sharding
        self.guard = True if guard is None else bool(guard)
        self.loss_scaler = loss_scaler
        if loss_scaler is not None and not self.guard:
            import warnings
            warnings.warn(
                "loss_scaler attached but the in-step guard is off — "
                "overflow detection never fires, so the scale would "
                "only ever grow; scale updates are disabled",
                UserWarning, stacklevel=2)
        self._recorder = StepRecorder(max_consecutive_nonfinite)
        named = list(block.named_parameters())
        if not named:
            raise MXNetError("the block has no parameters")
        self._names = [n for n, _ in named]
        self._params = [p for _, p in named]
        self._train_idx = [i for i, p in enumerate(self._params)
                           if p.requires_grad]
        self.device = self._params[0].device
        if isinstance(optimizer, str):
            self._optimizer = opt_create(
                optimizer, param_dict=dict(named),
                param_idx2name=dict(enumerate(self._names)),
                **(optimizer_params or {}))
        else:
            self._optimizer = optimizer
        self._opt_state = None      # list aligned with self._train_idx
        self.step_count = 0

    # ------------------------------------------------------------------ #
    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def health(self) -> dict:
        return self._recorder.health

    @property
    def last_outcome(self):
        return self._recorder.last_outcome

    def health_snapshot(self) -> dict:
        snap = self._recorder.snapshot()
        snap["loss_scale"] = (None if self.loss_scaler is None
                              else float(self.loss_scaler.loss_scale))
        snap["guard"] = self.guard
        return snap

    # ------------------------------------------------------------------ #
    def _materialize(self):
        self._opt_state = [
            self._optimizer.create_state_multi_precision(
                i, self._params[i].detach())
            for i in self._train_idx]

    def _scalar(self, value):
        return torch.tensor(float(value), dtype=torch.float32,
                            device=self.device)

    def _forward_backward(self, batch, scale):
        """(loss, gradients) of the block in training mode; the loss is
        scaled for the backward and divided back, as the JAX step does."""
        params = [self._params[i] for i in self._train_idx]
        was_training = self.block.training
        self.block.train()
        try:
            with torch.enable_grad():
                if self.forward_loss is not None:
                    L = self.forward_loss(self.block, *batch)
                else:
                    L = self.loss(self.block(batch[0]), *batch[1:])
                if L.dim() > 0:
                    L = L.mean()
                scaled = L * scale
                grads = torch.autograd.grad(scaled, params,
                                            allow_unused=True)
        finally:
            self.block.train(was_training)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return scaled.detach() / scale, grads

    @torch.no_grad()
    def _apply(self, grads, t, lr, scale):
        params = [self._params[i] for i in self._train_idx]
        weights = [p.detach() for p in params]
        base = self._scalar(self._optimizer.rescale_grad)
        new_w, new_states = apply_updates(
            self._optimizer, self._train_idx, weights, grads,
            self._opt_state, t, lr, rescale_grad=base / scale)
        if self.guard:
            ok = all_finite(grads)
            keep_new = ok > 0
            new_w = [torch.where(keep_new, nw, w)
                     for nw, w in zip(new_w, weights)]
            new_states = [tree_map(lambda n, o: torch.where(keep_new, n, o),
                                   ns, os_)
                          for ns, os_ in zip(new_states, self._opt_state)]
        else:
            ok = self._scalar(1.0)
        torch._foreach_copy_(params, new_w)
        self._opt_state = list(new_states)
        return ok

    def step(self, *batch):
        """Run one fused train step; returns the (device-resident) loss."""
        batch = [(b if torch.is_tensor(b) else torch.as_tensor(np.asarray(b)))
                 .to(self.device) for b in batch]
        if self._opt_state is None:
            self._materialize()
        self._optimizer.num_update = self.step_count  # drive lr schedules
        t = self._scalar(self.step_count + 1)
        lr = self._scalar(self._optimizer.learning_rate)
        scale = self._scalar(1.0 if self.loss_scaler is None
                             else self.loss_scaler.loss_scale)
        self._recorder.open_step()
        try:
            loss_val, grads = self._forward_backward(batch, scale)
            ok = self._apply(grads, t, lr, scale)
        except BaseException:
            # the step died before any outcome existed — close it so the
            # next one is not accused of a missing record
            self._recorder.abort_step()
            raise
        # the guard verdict is read once, after the update was selected on
        # the device; it only steers host counters, the scaler and the
        # outcome record
        applied = (not self.guard) or bool(ok.item() > 0)
        if applied:
            self.step_count += 1
            self._recorder.record(StepOutcome.APPLIED)
            if self.loss_scaler is not None and self.guard:
                self.loss_scaler.update_scale(overflow=False)
        else:
            if self.loss_scaler is not None:
                self.loss_scaler.update_scale(overflow=True)
            detail = (f"non-finite gradient in fused SPMD step at "
                      f"step_count={self.step_count} "
                      f"(loss={float(loss_val):g})")
            outcome = self._recorder.record(
                StepOutcome.SKIPPED_NONFINITE, detail)
            if outcome is StepOutcome.HALTED_POISONED:
                raise self._recorder.halt_error(
                    detail,
                    loss_scale=None if self.loss_scaler is None
                    else self.loss_scaler.loss_scale)
        return loss_val

    # ------------------------------------------------------------------ #
    def step_microbatches(self, microbatches):
        raise _not_ported("step_microbatches (in-step gradient "
                          "accumulation)")

    def save_checkpoint(self, manager, step=None, iterator=None,
                        block=False):
        raise _not_ported("save_checkpoint")

    def restore_checkpoint(self, manager, step=None, iterator=None):
        raise _not_ported("restore_checkpoint")
