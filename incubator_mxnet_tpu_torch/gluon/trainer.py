"""Gluon ``Trainer``: the port of the JAX package's
``incubator_mxnet_tpu/gluon/trainer.py``.

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

A parameter with ``grad_stype='row_sparse'`` (``Embedding(sparse_grad=
True)``) takes the lazy update: its dense gradient buffer is read as a
``RowSparseNDArray`` (the rows with a nonzero entry; one host sync) and
the optimizer writes those rows in place, after the guard's verdict and
only on a step it did not veto. Its gradient joins the guard's
all-finite reduction (``FusedApplier.apply``'s ``extra_grads``; an
all-sparse step runs ``grad_all_finite`` alone).

``accumulate_grads()`` + ``step(k)`` folds microbatch gradients into
persistent f32 accumulators (one program per signature, whatever k) and
applies them with one guard verdict and one scaler update.

``save_states`` writes the checkpoint subsystem's capsule blob (the JAX
package's file; ``load_states`` also reads the port's older pickle), and
``save_checkpoint`` / ``restore_checkpoint`` / ``install_preemption`` go
through ``checkpoint.CheckpointManager``. A restore writes the parameters
and the optimizer states in place and rebuilds the fused applier, as the
JAX Trainer does: its programs are built anew at the next step.

Gradient reduction goes through the kvstore (``kvstore`` a type string,
a ``kvstore.create`` object, or None for none), as the JAX Trainer's
does: over workers with a ``dist_*`` store (one process a device,
``parallel.initialize``), with ``compression_params`` set on the store.
It runs when the store has more than one worker or ``int8_allreduce`` is
on, in buckets of ``parallel.collectives.plan_grad_buckets`` (one flat
pushpull a dtype bucket, reduced values copied back into the gradient
buffers in place). ``int8_allreduce=True`` ships each bucket as int8
codes under one scale (the workers' summed amax), summed as int32 and
dequantized before the guarded apply, at one worker too.
``overlap_allreduce=True`` issues each bucket's pushpull during backward,
as its last gradient becomes final (the grad-ready hooks), strictly in
the plan's order, which is the same on every worker; ``step`` flushes
the tail. Accumulation (``accumulate_grads``) reduces the accumulated
sums once, at ``step``.
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
        self._accum_mode = False    # latched by accumulate_grads()

        # the EQuARX seam: int8 codes under one scale a bucket, the guard
        # judging the dequantized gradients
        self._int8_allreduce = bool(int8_allreduce)
        self.int8_buckets = 0            # buckets shipped quantized
        self.int8_bytes_saved = 0        # gradient bytes - int8 bytes
        if self._int8_allreduce and not self._fuse_step:
            warnings.warn(
                "int8_allreduce=True but the fused step is off "
                "(fuse_step=False or a non-fusable optimizer) — "
                "gradient bucketing never runs, so the compressed "
                "allreduce is INERT and gradients ship uncompressed",
                UserWarning, stacklevel=2)
        self._compression_params = compression_params
        self._kvstore = None
        self._kv_initialized = False
        self._kvstore_type = kvstore
        if overlap_allreduce is None:
            overlap_allreduce = getenv_bool("MXTPU_OVERLAP_ALLREDUCE",
                                            False)
        if overlap_allreduce and not self._fuse_step:
            warnings.warn(
                "overlap_allreduce=True but the fused step is off — "
                "gradient bucketing never runs, so the overlapped "
                "collective is INERT", UserWarning, stacklevel=2)
        self._overlap = bool(overlap_allreduce) and self._fuse_step
        self._overlap_sched = None     # BucketSchedule | False = disabled
        self._ov_members = {}          # id(grad buffer) -> (buffer, index)
        self.grad_issue_schedule = []  # last round's issued bucket keys
        self._hook_handle = None
        if self._overlap:
            import weakref
            from .. import autograd as _ag
            ref = weakref.ref(self)
            handle_box = []

            def _hook(leaf, gbuf, _ref=ref, _box=handle_box):
                tr = _ref()
                if tr is None:           # trainer collected: self-remove
                    _ag.remove_grad_ready_hook(_box[0])
                    return
                tr._on_grad_ready(leaf, gbuf)

            handle_box.append(_ag.register_grad_ready_hook(_hook))
            self._hook_handle = handle_box[0]

    def _init_kvstore(self):
        """The store, made at the first step (a type string through
        ``kvstore.create``; an object as given), with the compression
        set."""
        if self._kv_initialized:
            return
        kv = self._kvstore_type
        if isinstance(kv, str):
            from ..kvstore import create as kv_create
            kv = kv_create(kv)
        if kv is not None and self._compression_params:
            kv.set_gradient_compression(self._compression_params)
        self._kvstore = kv
        self._kv_initialized = True

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
        snap["int8_allreduce"] = self._int8_allreduce
        snap["int8_buckets"] = self.int8_buckets
        snap["int8_bytes_saved"] = self.int8_bytes_saved
        snap["overlap_allreduce"] = self._overlap
        snap["grad_issue_schedule"] = list(self.grad_issue_schedule)
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
        """Reduce the gradients through the kvstore, then update (parity:
        Trainer.step). After ``accumulate_grads`` the update applies the
        f32 accumulators: pass the batch size the summed gradients stand
        for."""
        self._round(batch_size, ignore_stale_grad, reduce=True)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update alone, on gradients already reduced
        (``allreduce_grads``); it closes the round, as ``step`` does."""
        self._round(batch_size, ignore_stale_grad, reduce=False)

    def _round(self, batch_size, ignore_stale_grad, reduce):
        """One round of ``step`` / ``update``: the loss scale into
        ``rescale_grad``, the reduction (``reduce``), the update, and the
        round closed even when one of them raised."""
        self._init_kvstore()
        if self._amp_loss_scaler is not None:
            self._scale = self._amp_original_scale / \
                self._amp_loss_scaler.loss_scale
        self._optimizer.rescale_grad = self._scale / batch_size
        overrides = self._accum_overrides()
        try:
            if reduce:
                self._allreduce_grads(overrides)
            self._update(ignore_stale_grad, overrides)
        finally:
            self._finish_round(overrides)

    def allreduce_grads(self):
        """The kvstore reduction of the fresh gradients alone."""
        self._init_kvstore()
        self._allreduce_grads()

    def _finish_round(self, overrides):
        """Close the step's overlap and accumulation round (runs even when
        the update raised): bank the issue order, reset the schedule for
        the next backward, end the accumulation round."""
        sched = self._overlap_sched
        if sched is not None and sched is not False:
            if sched.issued:
                self.grad_issue_schedule = list(sched.issued)
            sched.reset_round()
        if overrides is not None:
            self._accum_round = []
            self._accum_count = 0

    # -- the reduction --------------------------------------------------- #
    def _allreduce_grads(self, overrides=None):
        if self._kvstore is None:
            return
        if self._overlap and self._overlap_sched is None:
            # the plan is built at step time, never inside the autograd
            # hook; this step's reduction runs the serial path
            self._build_overlap_plan()
        if not (self._kvstore.num_workers > 1 or
                (self._int8_allreduce and self._fuse_step)):
            return
        from ..ndarray.sparse import RowSparseNDArray
        work = []
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or p._grad is None:
                continue
            if overrides is not None:
                if i not in overrides:
                    continue    # skipped at apply (_update_inner warns)
                work.append((i, overrides[i]))
            else:
                work.append((i, p.grad()))
        if not work:
            return
        bucketable = [(i, g) for i, g in work
                      if not isinstance(g, RowSparseNDArray)]
        rest = [(i, g) for i, g in work if isinstance(g, RowSparseNDArray)]
        sched = self._overlap_sched
        if overrides is None and sched not in (None, False) and \
                sched.issued:
            # overlap issued part of the plan during backward: flush the
            # tail through the SAME plan (re-packing would reduce issued
            # members a second time)
            self._overlap_flush(dict(bucketable))
        elif self._fuse_step and (len(bucketable) > 1 or
                                  (self._int8_allreduce and bucketable)):
            self._bucketed_pushpull(bucketable)
        else:
            rest = work
        for i, g in rest:
            self._kvstore.pushpull(i, g, out=g)

    def _bucketed_pushpull(self, work):
        """One pushpull a (dtype, byte limit) bucket of the forward-order
        plan; keys name the member composition, so a compression residual
        stays with its bucket."""
        from ..parallel.collectives import bucket_limit, plan_grad_buckets
        gmap = dict(work)
        members = [(i, g._data.numel(), g._data.element_size(),
                    str(g.dtype)) for i, g in gmap.items()]
        for bucket in plan_grad_buckets(members, bucket_limit(),
                                        reverse=False):
            self._pushpull_chunk(bucket.key,
                                 [(i, gmap[i]) for i in bucket.indices])

    @torch.no_grad()
    def _pushpull_chunk(self, key, chunk):
        """Ship one bucket (its members flattened into one buffer, int8
        when enabled) and copy the reduction back into the members'
        buffers in place."""
        from ..ndarray import NDArray
        flat = torch.cat([g._data.reshape(-1) for _, g in chunk])
        if self._int8_allreduce:
            flat = self._int8_pushpull(key, flat)
        else:
            bucket = NDArray(flat)
            self._kvstore.pushpull(key, bucket, out=bucket)
        off = 0
        for _, g in chunk:
            n = g._data.numel()
            g._data.copy_(flat[off:off + n].view(g._data.shape))
            off += n

    def _int8_pushpull(self, key, flat):
        """One bucket as int8 codes under a single symmetric scale: the
        workers' amaxes are summed first (a one-value pushpull; the sum
        bounds every worker's max), the codes travel as int32 so a
        W-way sum cannot wrap, and the sum is dequantized. A non-finite
        gradient makes amax, and every dequantized element, non-finite:
        the guard's verdict is the uncompressed one."""
        from ..ndarray import NDArray
        from ..ops.quantization import (dequantize_symmetric,
                                        quantize_symmetric,
                                        symmetric_scale)
        amax = flat.float().abs().max()
        if self._kvstore.num_workers > 1:
            am = NDArray(amax.reshape(1))
            self._kvstore.pushpull(key + "_int8amax", am, out=am)
            amax = am._data.reshape(())
        scale = symmetric_scale(amax)
        codes = NDArray(quantize_symmetric(flat, scale).to(torch.int32))
        self._kvstore.pushpull(key + "_int8q", codes, out=codes)
        self.int8_buckets += 1
        self.int8_bytes_saved += int(flat.numel()) * \
            (flat.element_size() - 1)
        return dequantize_symmetric(codes._data, scale).to(flat.dtype)

    # -- overlapped bucket-ready allreduce ------------------------------- #
    def _on_grad_ready(self, leaf, gbuf):
        """Grad-ready hook: marks the owning bucket's member ready and
        issues every bucket the plan-order gate clears. Foreign leaves and
        accumulation rounds fall through."""
        if self._accum_mode or self._accum_count:
            return      # only the accumulated sums cross, at step time
        sched = self._overlap_sched
        if sched is None or sched is False:
            return
        member = self._ov_members.get(id(gbuf))
        if member is None or member[0] is not gbuf:
            return                       # another model's or trainer's
        for bucket in sched.mark_ready(member[1]):
            self._issue_bucket(bucket)

    def _build_overlap_plan(self):
        """The deterministic bucket plan over the trainable set (the same
        on every worker), or False when overlap cannot engage: no
        reduction, a single non-int8 member (the step's per-parameter path
        would reduce it a second time) or a ``grad_req='add'`` parameter
        (final only after an unknowable number of backwards)."""
        from ..ndarray.sparse import RowSparseNDArray
        from ..parallel.collectives import (BucketSchedule, bucket_limit,
                                            plan_grad_buckets)
        engages = self._kvstore.num_workers > 1 or self._int8_allreduce
        members, tagged = [], []
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or p._grad is None:
                continue
            g = p.grad()
            if isinstance(g, RowSparseNDArray):
                continue
            if p.grad_req == "add":
                warnings.warn(
                    f"overlap_allreduce disabled: parameter `{p.name}` "
                    f"has grad_req='add' — its gradient is not final "
                    f"until the last of an unknowable number of "
                    f"backwards, so a mid-backward collective would "
                    f"ship a partial sum", UserWarning, stacklevel=3)
                self._overlap_sched = False
                return
            members.append((i, g._data.numel(), g._data.element_size(),
                            str(g.dtype)))
            tagged.append((i, g))
        if not engages or not (len(members) > 1 or
                               (self._int8_allreduce and members)):
            self._overlap_sched = False
            return
        self._ov_members = {id(g): (g, i) for i, g in tagged}
        self._overlap_sched = BucketSchedule(
            plan_grad_buckets(members, bucket_limit()))

    def _issue_bucket(self, bucket):
        self._pushpull_chunk(bucket.key, [(i, self._params[i].grad())
                                          for i in bucket.indices])

    def _overlap_flush(self, work_by_idx):
        """End-of-backward flush of the plan's unissued tail. If the
        trainable set changed since the plan was built, the never-issued
        members go one by one (int8 ones still quantized) and the plan is
        rebuilt at the next step."""
        sched = self._overlap_sched
        plan_idx = {i for b in sched.buckets for i in b.indices}
        if plan_idx != set(work_by_idx):
            issued_keys = set(sched.issued)
            issued_idx = {i for b in sched.buckets if b.key in issued_keys
                          for i in b.indices}
            for i, g in sorted(work_by_idx.items()):
                if i in issued_idx:
                    continue
                if self._int8_allreduce:
                    self._pushpull_chunk(f"__grad_bucket_{g.dtype}_fb{i}",
                                         [(i, g)])
                else:
                    self._kvstore.pushpull(i, g, out=g)
            self._overlap_sched = None
            return
        for bucket in sched.drain():
            self._issue_bucket(bucket)

    def zero_grad(self):
        for p in self._params:
            p.zero_grad()

    # ------------------------------------------------------------------ #
    def _accum_overrides(self):
        if not self._accum_count:
            return None
        from ..ndarray import NDArray
        return {i: NDArray(self._accum[i]) for i in self._accum_round}

    def set_grad_accumulation(self, active: bool):
        """Declare that the next backwards belong to accumulation rounds,
        so an overlapped allreduce defers to ``step`` from the first
        microbatch on; ``accumulate_grads`` latches it. False returns to
        per-step overlapped reduction."""
        self._accum_mode = bool(active)

    def accumulate_grads(self):
        """Fold the fresh gradients into the f32 accumulators and mark
        them consumed; returns the microbatches folded this round."""
        sched = self._overlap_sched
        if sched not in (None, False) and sched.issued:
            raise MXNetError(
                "accumulate_grads() cannot compose with an overlapped "
                "allreduce that already issued this round — the issued "
                "bucket reduced a single microbatch's gradients. Call "
                "set_grad_accumulation(True) before the first "
                "microbatch's backward, or build the Trainer with "
                "overlap_allreduce=False.")
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
        self._accum_mode = True
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
        fused_items, sparse_items, eager_items, touched = [], [], [], []
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
                            UserWarning, stacklevel=5)
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
                        UserWarning, stacklevel=5)
            touched.append(p)
            if p._grad_stype == "row_sparse":
                # the active rows change from step to step, so the lazy
                # update runs eagerly, after the guard's verdict
                sparse_items.append((i, p, grad))
            elif self._fused is not None:
                fused_items.append((i, p, grad))
            else:
                eager_items.append((i, p, grad))
        applied = True
        guard_on = self._fused is not None and self._fused.guard
        sparse_grads = [g._data for _, _, g in sparse_items]
        if fused_items:
            applied = self._fused.apply(
                fused_items, updater,
                extra_grads=sparse_grads if guard_on else ())
        elif sparse_items and guard_on:
            # an all-sparse step: no group program carries the verdict
            if self._fused.grad_all_finite(sparse_grads):
                applied = float(self._fused._ok.item()) > 0
                if not applied:
                    self._fused.skipped_steps += 1
        for i, p, grad in eager_items:
            updater(i, grad, p.data())
        if applied:
            # a skipped step leaves every parameter bit-identical
            from ..ndarray.sparse import _row_sparse_of
            for i, p, grad in sparse_items:
                updater(i, _row_sparse_of(grad._data.detach()), p.data())
        for p in touched:
            if p._grad is not None:
                p._grad._fresh = False
        self._finish_step(applied, bool(touched), saw_stale_skip,
                          fused_items + sparse_items)

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
