"""Gluon ``Trainer``: the port of the JAX package's
``incubator_mxnet_tpu/gluon/trainer.py`` on one device.

``step(batch_size)`` applies the optimizer to every parameter whose
gradient a backward refreshed. By default the update runs through
``optimizer.FusedApplier``: one program per (dtype, storage type) group,
a CUDA graph on the card, with the in-step non-finite guard (a
non-finite gradient skips the whole update, weights and optimizer state
bit-identical, counters not advanced) and the optional dynamic
``LossScaler`` whose scale rides the staged ``rescale_grad``.
``fuse_step=False`` (and the optimizers with per-step host state, Nadam
and SGLD) run the eager per-parameter ``Updater`` instead. Every step
ends in one ``StepOutcome`` (``last_outcome``, ``health``,
``health_snapshot()``); K consecutive non-finite steps halt with
``HALTED_POISONED``.

``accumulate_grads()`` + ``step(k)`` folds microbatch gradients into
persistent f32 accumulators (one program per signature, whatever k) and
applies them with one guard verdict and one scaler update.

``save_states`` writes the checkpoint subsystem's capsule blob (the JAX
package's file; ``load_states`` also reads the port's older pickle), and
``save_checkpoint`` / ``restore_checkpoint`` / ``install_preemption`` go
through ``checkpoint.CheckpointManager``. A restore writes the parameters
and the optimizer states in place and rebuilds the fused applier, as the
JAX Trainer does: its programs are built anew at the next step.

``kvstore`` 'device', 'local' or None reduces nothing over one device.
Not ported, and refused with ``MXNetError``: the ``dist_*`` kvstores and
kvstore objects, ``compression_params``, ``int8_allreduce`` and
``overlap_allreduce=True``.
"""

from __future__ import annotations

import warnings
from typing import Dict, List

import numpy as np
import torch

from .. import optimizer as opt_mod
from ..base import MXNetError, getenv_bool
from ..train.outcomes import StepOutcome, StepRecorder
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _not_ported(what):
    return MXNetError(f"gluon.Trainer: {what} is not ported (the port's "
                      f"Trainer runs on one device)")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, fuse_step=None,
                 loss_scaler=None, guard=None,
                 max_consecutive_nonfinite=None,
                 int8_allreduce=False, overlap_allreduce=None):
        if isinstance(params, (dict, ParameterDict)):
            param_list = [params[k] for k in sorted(params.keys())] \
                if isinstance(params, dict) else list(params.values())
        elif isinstance(params, (list, tuple)):
            param_list = list(params)
        else:
            raise MXNetError("params must be a (Parameter)Dict or list")
        if kvstore is not None and not (
                isinstance(kvstore, str) and kvstore in ("device", "local")):
            raise _not_ported(f"kvstore={kvstore!r}")
        if compression_params:
            raise _not_ported("compression_params")
        if int8_allreduce:
            raise _not_ported("int8_allreduce")
        if overlap_allreduce:
            raise _not_ported("overlap_allreduce=True")
        for p in param_list:
            if not isinstance(p, Parameter):
                raise MXNetError(f"expected Parameter, got {type(p)}")
        self._params: List[Parameter] = param_list
        self._optimizer = opt_mod.create(
            optimizer, param_dict={p.name: p for p in self._params},
            param_idx2name={i: p.name for i, p in enumerate(self._params)},
            **(optimizer_params or {}))
        self._updaters = [opt_mod.get_updater(self._optimizer)]
        self._scale = self._optimizer.rescale_grad
        if fuse_step is None:
            fuse_step = getenv_bool("MXTPU_FUSED_STEP", True)
        self._fuse_step = fuse_step and getattr(self._optimizer, "fusable",
                                                True)
        self._fused = opt_mod.FusedApplier(self._optimizer, guard=guard) \
            if self._fuse_step else None
        self._recorder = StepRecorder(max_consecutive_nonfinite)
        self._amp_loss_scaler = loss_scaler
        self._amp_original_scale = self._scale
        self._headgrad_cache: Dict = {}
        if loss_scaler is not None and (
                self._fused is None or not self._fused.guard):
            warnings.warn(
                "loss_scaler attached but the fused in-step guard is off "
                "(fuse_step=False, a non-fusable optimizer, or guard=False) "
                "— overflow detection never fires and the scale will not "
                "adapt", UserWarning, stacklevel=2)
        if guard and self._fused is None:
            warnings.warn(
                "guard=True requested but the fused step is off "
                "(fuse_step=False or a non-fusable optimizer) — the eager "
                "per-param path has no non-finite guard, so skip-step and "
                "HALTED_POISONED protection are INERT",
                UserWarning, stacklevel=2)
        self._accum: Dict[int, torch.Tensor] = {}   # persistent f32 sums
        self._accum_round: List[int] = []           # indices this round
        self._accum_count = 0

    # ------------------------------------------------------------------ #
    @property
    def learning_rate(self) -> float:
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr: float):
        self._optimizer.set_learning_rate(lr)

    @property
    def health(self) -> dict:
        return self._recorder.health

    @property
    def last_outcome(self):
        return self._recorder.last_outcome

    @property
    def loss_scaler(self):
        return self._amp_loss_scaler

    def health_snapshot(self) -> dict:
        snap = self._recorder.snapshot()
        snap["loss_scale"] = (
            None if self._amp_loss_scaler is None
            else float(self._amp_loss_scaler.loss_scale))
        snap["guard"] = self._fused is not None and self._fused.guard
        snap["int8_allreduce"] = False
        snap["int8_buckets"] = 0
        snap["int8_bytes_saved"] = 0
        snap["overlap_allreduce"] = False
        snap["grad_issue_schedule"] = []
        snap["accumulated_microbatches"] = self._accum_count
        return snap

    def scale_loss(self, loss):
        """``loss`` times the dynamic loss scale (identity without a
        scaler)."""
        if self._amp_loss_scaler is None:
            return loss
        s = self._amp_loss_scaler.loss_scale
        if isinstance(loss, (list, tuple)):
            return type(loss)(l * s for l in loss)
        return loss * s

    def backward(self, loss):
        """``loss.backward()`` with the loss scale as the head gradient
        (no op added to the recorded graph)."""
        from .. import autograd
        heads = list(loss) if isinstance(loss, (list, tuple)) else [loss]
        if self._amp_loss_scaler is None:
            autograd.backward(heads)
            return
        s = float(self._amp_loss_scaler.loss_scale)
        autograd.backward(heads, [self._headgrad(s, h) for h in heads])

    def _headgrad(self, s, loss):
        key = (s, tuple(loss.shape), str(loss.dtype), str(loss.context))
        hg = self._headgrad_cache.get(key)
        if hg is None:
            from ..ndarray import NDArray
            if len(self._headgrad_cache) >= 16:
                self._headgrad_cache.clear()
            hg = NDArray(torch.full(loss.shape, s, dtype=loss._data.dtype,
                                    device=loss._data.device))
            self._headgrad_cache[key] = hg
        return hg

    # ------------------------------------------------------------------ #
    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce (nothing, on one device) and update (parity:
        Trainer.step). After ``accumulate_grads`` the update applies the
        f32 accumulators: pass the batch size the summed gradients stand
        for."""
        self.update(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        if self._amp_loss_scaler is not None:
            self._scale = self._amp_original_scale / \
                self._amp_loss_scaler.loss_scale
        self._optimizer.rescale_grad = self._scale / batch_size
        overrides = self._accum_overrides()
        try:
            self._update(ignore_stale_grad, overrides)
        finally:
            if overrides is not None:
                self._accum_round = []
                self._accum_count = 0

    def allreduce_grads(self):
        """Nothing to reduce on one device."""

    def zero_grad(self):
        for p in self._params:
            p.zero_grad()

    # ------------------------------------------------------------------ #
    def _accum_overrides(self):
        if not self._accum_count:
            return None
        from ..ndarray import NDArray
        return {i: NDArray(self._accum[i]) for i in self._accum_round}

    def accumulate_grads(self):
        """Fold the fresh gradients into the f32 accumulators and mark
        them consumed; returns the microbatches folded this round."""
        items = []
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or p._grad is None:
                continue
            g = p.grad()
            if not getattr(g, "_fresh", True):
                continue
            items.append((i, g))
        if not items:
            raise MXNetError("accumulate_grads() found no fresh "
                             "gradients; run backward() first")
        with torch.no_grad():
            for i, g in items:
                a = self._accum.get(i)
                if a is None:
                    a = torch.zeros(g.shape, dtype=torch.float32,
                                    device=g._data.device)
                    self._accum[i] = a
                if i not in self._accum_round:
                    a.zero_()
                    self._accum_round.append(i)
            accs = [self._accum[i] for i, _ in items]
            grads = [g._data for _, g in items]
            if self._fused is not None:
                self._fused.accumulate(accs, grads)
            else:
                torch._foreach_add_(accs, [g.float() for g in grads])
        for _, g in items:
            g._fresh = False
        self._accum_count += 1
        return self._accum_count

    def _update(self, ignore_stale_grad=False, overrides=None):
        self._recorder.open_step()
        try:
            self._update_inner(ignore_stale_grad, overrides)
        except BaseException:
            self._recorder.abort_step()
            raise

    def _update_inner(self, ignore_stale_grad=False, overrides=None):
        updater = self._updaters[0]
        fused_items, eager_items, touched = [], [], []
        saw_stale_skip = False
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            if overrides is not None:
                if i not in overrides:
                    if not ignore_stale_grad:
                        warnings.warn(
                            f"Parameter `{p.name}` received no gradient "
                            f"in any microbatch of the accumulated "
                            f"round; it is skipped this step.",
                            UserWarning, stacklevel=4)
                    saw_stale_skip = True
                    continue
                grad = overrides[i]
            else:
                grad = p.grad()
                if not getattr(grad, "_fresh", True):
                    if ignore_stale_grad:
                        saw_stale_skip = True
                        continue
                    warnings.warn(
                        f"Gradient of Parameter `{p.name}` has not been "
                        f"updated by backward since last `step`; the stale "
                        f"gradient is applied anyway. Call step with "
                        f"ignore_stale_grad=True to skip such parameters.",
                        UserWarning, stacklevel=4)
            touched.append(p)
            if self._fused is not None:
                fused_items.append((i, p, grad))
            else:
                eager_items.append((i, p, grad))
        applied = True
        if fused_items:
            applied = self._fused.apply(fused_items, updater)
        for i, p, grad in eager_items:
            updater(i, grad, p.data())
        for p in touched:
            if p._grad is not None:
                p._grad._fresh = False
        self._finish_step(applied, bool(touched), saw_stale_skip,
                          fused_items)

    def _finish_step(self, applied, any_touched, saw_stale_skip,
                     fused_items):
        scaler = self._amp_loss_scaler
        guard_on = self._fused is not None and self._fused.guard
        if not any_touched and saw_stale_skip:
            self._recorder.record(StepOutcome.SKIPPED_STALE,
                                  "all gradients stale; nothing applied")
            return
        if applied:
            self._recorder.record(StepOutcome.APPLIED)
            if scaler is not None and guard_on and any_touched:
                scaler.update_scale(overflow=False)
            return
        if scaler is not None:
            scaler.update_scale(overflow=True)
        detail = self._nonfinite_diagnostic(fused_items)
        outcome = self._recorder.record(StepOutcome.SKIPPED_NONFINITE,
                                        detail)
        if outcome is StepOutcome.HALTED_POISONED:
            raise self._recorder.halt_error(
                detail, loss_scale=None if scaler is None
                else scaler.loss_scale)

    @staticmethod
    def _nonfinite_diagnostic(fused_items) -> str:
        """Name the poisoned gradients (a host sweep, run only on a step
        already skipped)."""
        bad = []
        for _, p, g in fused_items:
            arr = np.asarray(g._data.detach().float().cpu())
            if not np.isfinite(arr).all():
                n = int((~np.isfinite(arr)).sum())
                bad.append(f"{p.name}({n}/{arr.size} non-finite)")
            if len(bad) >= 8:
                bad.append("...")
                break
        return "non-finite grads: " + (", ".join(bad) or "<none found>")

    # ------------------------------------------------------------------ #
    def _rebuild_applier(self):
        """A fresh fused applier after a restore (the JAX Trainer rebinds
        its applier the same way): its programs are built at the next
        step, over the restored state tensors."""
        if self._fused is not None:
            self._fused = opt_mod.FusedApplier(self._optimizer,
                                               guard=self._fused.guard)

    def save_states(self, fname):
        """The optimizer states and update counters, as a capsule blob
        (crc32-checked; the JAX package's ``save_states`` file)."""
        from .. import checkpoint as _ckpt
        tree, meta = _ckpt.updater_capsule(self._updaters[0])
        _ckpt.save_capsule_file(fname, tree, meta)

    def load_states(self, fname):
        """Restore a ``save_states`` file of either package (a capsule
        blob) or the port's older pickle; existing state tensors are
        written in place."""
        from .. import checkpoint as _ckpt
        with open(fname, "rb") as f:
            payload = f.read()
        if _ckpt.is_capsule_bytes(payload):
            arrays, meta = _ckpt.load_capsule_bytes(payload)
            _ckpt.restore_updater(self._updaters[0], self._params, arrays,
                                  meta)
        else:
            dev = self._params[0].data()._data.device if self._params \
                else "cpu"
            self._updaters[0].set_states(payload, device=dev)
        self._rebuild_applier()

    def save_checkpoint(self, manager, step=None, iterator=None,
                        block=False):
        """Snapshot the full training capsule (parameters, optimizer
        states, the scheduler's num_update, the random state, the
        iterator's position) into ``manager`` asynchronously. ``step``
        defaults to the optimizer's update count. Returns the step
        saved."""
        from .. import checkpoint as _ckpt
        tree, meta = _ckpt.trainer_capsule(self, iterator=iterator)
        if step is None:
            step = meta["step"]
        else:
            # an explicit step is the caller's loop position: num_update
            # drifts below it once the guard skips steps, and resuming
            # from num_update would re-run applied batches
            meta["step"] = int(step)
        manager.save(int(step), tree, meta=meta, block=block)
        return int(step)

    def restore_checkpoint(self, manager, step=None, iterator=None):
        """Bit-exact resume from ``manager`` (default: the latest committed
        step). Returns the restored step."""
        from .. import checkpoint as _ckpt
        arrays, meta = manager.restore(step)
        _ckpt.restore_trainer(self, arrays, meta, iterator=iterator)
        return int(meta.get("step", 0))

    def install_preemption(self, manager, iterator=None, exit_after=True):
        """Arm SIGTERM: drain any in-flight snapshot and write one final
        synchronous capsule before the process dies."""
        from .. import checkpoint as _ckpt

        def _state():
            tree, meta = _ckpt.trainer_capsule(self, iterator=iterator)
            return meta["step"], tree, meta

        return manager.install_preemption_hook(_state,
                                               exit_after=exit_after)
