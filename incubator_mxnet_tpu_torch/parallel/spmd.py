"""One-device fused training step: the port of the JAX package's
``incubator_mxnet_tpu/parallel/spmd.py`` ``SPMDTrainer`` for a mesh of one
device.

A step is the JAX program's sequence:

  1. materialize the optimizer state (f32 masters with
     ``multi_precision``) at the first step;
  2. open the step in the ``StepRecorder``;
  3. loss x scale through autograd (the model in training mode, dropout
     drawing from the model's generators), and the gradients;
  4. ``all_finite`` over the gradients, on the device;
  5. ``apply_updates`` with ``rescale_grad = base / scale``, the step
     count ``t`` and the learning rate as 0-d device tensors;
  6. the guard: ``torch.where`` on the device flag selects the new or the
     old parameters, optimizer state and module buffers (a BatchNorm's
     running statistics and ``num_batches_tracked``, which the forward
     wrote), so a vetoed step leaves all three bit-identical; all three
     are written IN PLACE;
  7. one readback of the loss and the flag, which steer ``step_count``,
     the recorder (APPLIED / SKIPPED_NONFINITE / HALTED_POISONED) and the
     loss scaler.

Steps 3-6 are the body of a compiled-once program, one per batch
signature (the shapes and dtypes of the batch, on which the JAX jit
retraces too), built at the signature's first step. Its static buffers:
one device tensor per batch argument (filled by ``copy_``), ``t``, ``lr``
and ``scale`` in one ``serve.program.Packed`` (one copy in), ``loss`` and
``ok`` in another (one copy back). On a CUDA device the first step of a
signature runs the body eagerly on PyTorch's capture stream (a real
step: its outcome is recorded as any step's), then the body is captured
into one CUDA graph (the block's CUDA generators registered with it), and
every later step of that signature is staging, one ``replay()`` and the
readback. The graph holds the parameters and the optimizer state by
address: they are updated with ``copy_``, never rebound. A failed capture
raises ``MXNetError``; nothing runs the step eagerly in its place. On the
CPU the body runs eagerly every step. ``step_trace_count`` counts builds
(captures on the card, first meetings of a signature on the CPU), as the
JAX trainer counts traces.

Baked into a build, as the JAX trace closes over them: the optimizer's
hyperparameters (wd, betas, epsilon, clipping, bounds, ``rescale_grad``)
and the guard. Staged every step: ``t``, the learning rate (a schedule's
included) and the loss scale. The optimizer's host update counters move
at a build only, as they move at trace time in the JAX package.

Not ported, and refused with ``MXNetError``: a mesh of more than one
device, ``sharding="fsdp"``, ``pipeline=``, ``int8_allreduce``,
``remat_plan``, ``grad_collective="ring"``, ``step_microbatches`` and
checkpoint save / restore.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..base import MXNetError, getenv_bool
from ..optimizer import create as opt_create
from ..optimizer.fused import all_finite, apply_updates, tree_leaves
from ..serve.program import GraphCapture, Packed, add_launches
from ..train.outcomes import StepOutcome, StepRecorder

__all__ = ["SPMDTrainer"]


_INPUTS = (("t", (), torch.float32), ("lr", (), torch.float32),
           ("scale", (), torch.float32))
_OUTPUTS = (("loss", (), torch.float32), ("ok", (), torch.float32))


class _StepProgram:
    """One batch signature's train step: the static buffers its body
    reads and writes, and on a CUDA device its graph (``graph``, with
    the launches its capture counted and the ``replays`` so far).
    ``first_ms`` times the signature's eager first step, ``build_ms`` the
    capture."""

    def __init__(self, signature, device: torch.device):
        self.batch = [torch.empty(shape, dtype=dtype, device=device)
                      for shape, dtype in signature]
        self.inp = Packed(_INPUTS, device)
        self.out = Packed(_OUTPUTS, device)
        self.capture: Optional[GraphCapture] = None   # until it is built
        self.graph = None
        self.launches = {}
        self.replays = 0
        self.first_ms: Optional[float] = None
        self.build_ms: Optional[float] = None
        # the pinned fields are refilled only once their last copy ran
        self._staged = torch.cuda.Event() if device.type == "cuda" \
            else None

    def stage(self, batch, t, lr, scale):
        """A step's inputs into the static buffers: each batch tensor by
        ``copy_`` (device to device when it lies on the device), ``t``,
        ``lr`` and ``scale`` in one copy. Does not wait."""
        if self._staged is not None:
            self._staged.synchronize()
        host = self.inp.host
        host["t"][...] = t
        host["lr"][...] = lr
        host["scale"][...] = scale
        for dst, src in zip(self.batch, batch):
            dst.copy_(src, non_blocking=True)
        self.inp.dev_bytes.copy_(self.inp.host_bytes, non_blocking=True)
        if self._staged is not None:
            self._staged.record()

    def replay(self):
        """The captured step; adds its launches to the kernels' counters.
        Does not wait."""
        self.graph.replay()
        self.replays += 1
        add_launches(self.launches)

    def read(self):
        """``(loss, ok)`` as floats, in one transfer (waits for the
        step)."""
        self.out.host_bytes.copy_(self.out.dev_bytes)
        return float(self.out.host["loss"]), float(self.out.host["ok"])


def _not_ported(what):
    return MXNetError(f"SPMDTrainer: {what} is not ported (the port's "
                      f"trainer is single-device)")


class SPMDTrainer:
    """Fused train step over one device.

    Parameters follow the JAX package's: ``block`` (an ``nn.Module``),
    ``loss`` (``loss(out, *labels)``) or ``forward_loss``
    (``fn(block, *batch) -> scalar``), ``optimizer`` with
    ``optimizer_params``, ``loss_scaler`` (``amp.LossScaler``), ``guard``
    (the in-step non-finite guard; None reads ``MXTPU_STEP_GUARD``,
    default on) and
    ``max_consecutive_nonfinite``. ``mesh`` may name one device (or be
    None); ``donate`` has no effect (the step updates the parameters and
    the optimizer state in place)."""

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
        if guard is None:
            guard = getenv_bool("MXTPU_STEP_GUARD", True)
        self.guard = bool(guard)
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
        self._buffers = list(block.buffers())
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
        self.step_trace_count = 0   # step programs built (jit-once)
        self._programs = {}         # batch signature -> _StepProgram
        self._graph_pool = None     # shared by the trainer's graphs

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
        snap["step_trace_count"] = self.step_trace_count
        return snap

    # ------------------------------------------------------------------ #
    def _materialize(self):
        self._opt_state = [
            self._optimizer.create_state_multi_precision(
                i, self._params[i].detach())
            for i in self._train_idx]

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
        """The (guarded) update of every trainable parameter, written in
        place into the parameters and into the optimizer state tensors
        ``_materialize`` made. Returns the guard flag (an f32 0-d tensor
        on the device). Reads nothing back from the device."""
        weights = [self._params[i].detach() for i in self._train_idx]
        # rescale_grad is baked, as the JAX trace bakes it: a fill kernel,
        # not a copy from the host
        base = torch.full((), float(self._optimizer.rescale_grad),
                          dtype=torch.float32, device=self.device)
        new_w, new_states = apply_updates(
            self._optimizer, self._train_idx, weights, grads,
            self._opt_state, t, lr, rescale_grad=base / scale)
        old_leaves = tree_leaves(self._opt_state)
        new_leaves = tree_leaves(new_states)
        if self.guard:
            ok = all_finite(grads)
            keep_new = ok > 0
            new_w = [torch.where(keep_new, nw, w)
                     for nw, w in zip(new_w, weights)]
            new_leaves = [torch.where(keep_new, n, o)
                          for n, o in zip(new_leaves, old_leaves)]
        else:
            ok = torch.ones((), dtype=torch.float32, device=self.device)
        torch._foreach_copy_(weights, new_w)
        if old_leaves:
            torch._foreach_copy_(old_leaves, new_leaves)
        return ok

    def _run_body(self, prog: _StepProgram, moves_counters: bool):
        """The step's body over ``prog``'s static buffers. The
        optimizer's host update counters keep their values unless
        ``moves_counters`` (a build)."""
        opt = self._optimizer
        saved = dict(opt._index_update_count), opt.num_update
        inp, out = prog.inp.dev, prog.out.dev
        # what the forward writes into module buffers (running statistics,
        # num_batches_tracked) is kept only by an applied step
        before = [b.clone() for b in self._buffers] if self.guard else []
        loss, grads = self._forward_backward(prog.batch, inp["scale"])
        ok = self._apply(grads, inp["t"], inp["lr"], inp["scale"])
        if before:
            keep_new = ok > 0
            torch._foreach_copy_(self._buffers, [
                torch.where(keep_new, b, old)
                for b, old in zip(self._buffers, before)])
        out["loss"].copy_(loss)
        out["ok"].copy_(ok)
        if not moves_counters:
            opt._index_update_count, opt.num_update = saved

    def _generators(self):
        """The CUDA generators the block's modules draw from."""
        gens = {}
        for m in self.block.modules():
            g = getattr(m, "generator", None)
            if isinstance(g, torch.Generator) and g.device.type == "cuda":
                gens[id(g)] = g
        return list(gens.values())

    def _first_run(self, prog: _StepProgram):
        """A signature's first step, eagerly: on the card on the capture
        stream, ahead of the capture (``_capture``)."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            prog.capture = GraphCapture(self.device, self._graph_pool,
                                        self._generators())
            prog.capture.eager(lambda: self._run_body(prog, False))
        else:
            self._run_body(prog, True)
        prog.first_ms = (time.perf_counter() - t0) * 1e3

    def _capture(self, prog: _StepProgram):
        """On the card, capture the body into ``prog.graph`` (raises
        ``MXNetError`` if the capture fails); nothing on the CPU."""
        cap, prog.capture = prog.capture, None
        if cap is None:
            return
        t0 = time.perf_counter()
        prog.launches = cap.record(lambda: self._run_body(prog, True))
        prog.graph = cap.graph
        prog.build_ms = (time.perf_counter() - t0) * 1e3

    def step(self, *batch):
        """Run one fused train step; returns the loss, a device tensor of
        its own. The first step of a batch signature builds its program
        (see the module's docstring); later ones stage and replay it."""
        batch = [b if torch.is_tensor(b) else torch.as_tensor(np.asarray(b))
                 for b in batch]
        if self._opt_state is None:
            self._materialize()
        sig = tuple((tuple(b.shape), b.dtype) for b in batch)
        prog = self._programs.get(sig)
        build = prog is None
        if build:
            prog = _StepProgram(sig, self.device)
        self._optimizer.num_update = self.step_count  # drive lr schedules
        prog.stage(batch, self.step_count + 1,
                   self._optimizer.learning_rate,
                   1.0 if self.loss_scaler is None
                   else self.loss_scaler.loss_scale)
        self._recorder.open_step()
        try:
            if build:
                self._first_run(prog)
            elif prog.graph is not None:
                prog.replay()
            else:
                self._run_body(prog, False)
            loss = prog.out.dev["loss"].clone()
            verdict = prog.read() if self.guard else None
        except BaseException:
            # the step died before any outcome existed — close it so the
            # next one is not accused of a missing record
            self._recorder.abort_step()
            raise
        failure = None
        if build:
            try:
                self._capture(prog)
            except MXNetError as e:
                failure = e             # raised once the step is recorded
            else:
                self._programs[sig] = prog
                self.step_trace_count += 1
        self._settle(verdict)
        if failure is not None:
            raise failure
        return loss

    def _settle(self, verdict):
        """Host counters, the recorder and the loss scaler from the
        step's read-back ``(loss, ok)`` (None without the guard)."""
        applied = (not self.guard) or verdict[1] > 0
        if applied:
            self.step_count += 1
            self._recorder.record(StepOutcome.APPLIED)
            if self.loss_scaler is not None and self.guard:
                self.loss_scaler.update_scale(overflow=False)
            return
        if self.loss_scaler is not None:
            self.loss_scaler.update_scale(overflow=True)
        detail = (f"non-finite gradient in fused SPMD step at "
                  f"step_count={self.step_count} (loss={verdict[0]:g})")
        outcome = self._recorder.record(StepOutcome.SKIPPED_NONFINITE,
                                        detail)
        if outcome is StepOutcome.HALTED_POISONED:
            raise self._recorder.halt_error(
                detail,
                loss_scale=None if self.loss_scaler is None
                else self.loss_scaler.loss_scale)

    # ------------------------------------------------------------------ #
    def step_microbatches(self, microbatches):
        raise _not_ported("step_microbatches (in-step gradient "
                          "accumulation)")

    def save_checkpoint(self, manager, step=None, iterator=None,
                        block=False):
        raise _not_ported("save_checkpoint")

    def restore_checkpoint(self, manager, step=None, iterator=None):
        raise _not_ported("restore_checkpoint")
