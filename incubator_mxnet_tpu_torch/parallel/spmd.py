"""The fused training step over a dp x fsdp x tp x sp mesh: the port of
the JAX package's ``incubator_mxnet_tpu/parallel/spmd.py`` ``SPMDTrainer``,
``constrain`` and ``activation_sharding_scope``.

A step is the JAX program's sequence:

  1. materialize the optimizer state (f32 masters with
     ``multi_precision``) at the first step;
  2. open the step in the ``StepRecorder``;
  3. loss x scale through autograd (the model in training mode inside
     ``autograd.record(train_mode=True)``, dropout drawing from the
     model's generators and ``mx.random``'s generator for the device),
     and the gradients; a gluon block's forward takes the batch as
     ``NDArray``s over the static buffers;
  4. ``all_finite`` over the gradients, on the device;
  5. ``apply_updates`` with ``rescale_grad = base / scale``, the step
     count ``t`` and the learning rate as 0-d device tensors;
  6. the guard: ``torch.where`` on the device flag selects the new or the
     old parameters, optimizer state and module buffers (a BatchNorm's
     running statistics and ``num_batches_tracked``, which the forward
     wrote; a gluon BatchNorm's running statistics are parameters that
     do not require grad and are kept the same way), so a vetoed step
     leaves all three bit-identical; all three are written IN PLACE;
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

``step_microbatches(microbatches)`` is one optimizer step over k
microbatches (gradient accumulation inside the step, the JAX trainer's
contract): one program per microbatch signature, built as the step's
are, runs once per microbatch. It adds the microbatch's gradients into
f32 accumulators, multiplies its all-finite flag into the round's verdict
and adds its loss, all device tensors of the trainer's that every such
graph holds by address (written with ``copy_``). The apply of the mean
gradient is computed on every microbatch and selected on the device
(``torch.where``) only on the round's last one and only when every
microbatch was finite, as the JAX program's where-select does; the
BatchNorm statistics the forwards advance are copied aside on the first
microbatch and put back after a vetoed round. ``first``, ``last`` and
``1 / k`` are staged inputs, so k is host data: rounds of 1, 4 and 8
microbatches of one shape run one build (``accum_step_trace_count``).
One readback a round, after the last microbatch, steers the same
counters as a step's: a round with a non-finite microbatch leaves
parameters, optimizer state and module buffers bitwise, records one
``SKIPPED_NONFINITE`` and halves the loss scale once.

``save_checkpoint`` / ``restore_checkpoint`` / ``install_preemption``
go through ``checkpoint.CheckpointManager`` and the capsule
(``checkpoint.spmd_capsule``): a restore writes the parameters, the
optimizer state and the random state into the tensors and generators the
step graphs hold, so no capture follows it (``step_trace_count`` stays).

Data parallelism across processes (``mesh=build_mesh(...)`` over a
process group, one device a rank). Every rank is handed the same global
batch, as in the JAX contract, and runs its own tile of it: the tile at
the rank's index over (fsdp, dp), fsdp-major as the JAX batch sharding
``("fsdp", "dp")`` lays it out; a batch dimension the dp x fsdp size does
not divide raises. The step's collectives sit in its body, so on the
card they are captured into the step graph with the rest (NCCL
collectives capture into CUDA graphs; they are hand-issued on flat
buffers, not DDP's or FSDP2's hooks, whose bucketing and lazy
all-gathers run on the host around each backward):

- the loss is the mean over ranks of each rank's loss (for a loss that
  is a mean over rows, the global batch's loss);
- ``sharding="replicated"``: the gradients are averaged over dp x fsdp
  in ``plan_grad_buckets`` buckets (forward order, one flat all-reduce a
  bucket; ``MXTPU_GRAD_BUCKET_BYTES`` / ``MXTPU_GRAD_BUCKET_MB``);
- ``sharding="fsdp"``: the JAX rule ``_fsdp_spec`` picks each
  parameter's sharded dimension (rank >= 2 and at least
  ``MXTPU_FSDP_MIN_SIZE`` elements, the first dimension the fsdp size
  divides; the rest stay replicated). Its gradient is reduce-scattered
  over fsdp (and averaged over dp), the optimizer state and the f32
  master live on the shard, the update runs on the shard, and the
  updated shards are all-gathered into the full parameter, which the
  next forward and backward read (the step graph holds it by address).
  At an fsdp size of 1 nothing is sharded, as in JAX, and the step is
  the replicated one;
- the guard's verdict is global: one ``all_reduce(MIN)`` of the flag;
- floating module buffers a forward wrote (BatchNorm statistics) are
  averaged over the ranks so every rank keeps the same ones
  (``gluon.contrib.nn.SyncBatchNorm`` reduces its batch statistics
  inside the forward instead);
- ``step_microbatches`` reduces each microbatch's gradients before they
  are accumulated.

A process with no process group runs the step with no collective, as
the JAX trainer on a one-device mesh does.

Tensor and sequence parallelism (the tp and sp axes). The ranks of one
batch tile differ in tp and sp only, and get the same tile. The step
runs its forward and backward inside ``activation_sharding_scope(mesh)``:

- on a tp axis a gluon ``Dense`` whose weight hint names tp computes
  this rank's tile (``tp_linear``: column-parallel, or row-parallel with
  the partial products summed over tp), and the models run attention on
  the rank's heads; every rank holds its parameters whole (as under
  fsdp), and the update of a tp-hinted parameter runs on its tile;
- a ``seq_parallel`` model splits its sequence over sp (``constrain``)
  and runs attention by the ring (``parallel/ring_attention.py``);
- each cross-rank step of the forward (``constrain``, the tp sums, the
  ring's hops) has its adjoint over the ranks as its backward, so a
  rank's gradients are those of the SUM of every rank's loss. The ranks'
  losses sum to the world size times the global loss (a rank's loss is
  its share of its tile's, scaled to the whole, where the sequence is
  split; the tile's whole loss where it is not). So every gradient is
  averaged over every rank, whatever the parameter's placement: a
  replicated one by the world's all-reduce, a sharded one (the
  ``_shard_plan``: the JAX ``_param_sharding`` rule, tp hints kept and
  fsdp on a free dimension) reduce-scattered over each axis of its plan
  and averaged over the others. A weighted mean loss normalizes by the
  global weight sum (``split_sum``).

The pipelined-backward step (``pipeline=``, a
``parallel.pipelined.PipelineSpec``): the same programs with the
backward run block by block and each gradient bucket reduced between the
block pullbacks (``parallel/pipelined.py``). With it, as in JAX:
``int8_allreduce`` (the in-step int8 bucket all-reduce; default
``MXTPU_INT8_ALLREDUCE``), ``grad_collective`` ('psum' or 'ring', the
send / recv ring; default ``MXTPU_GRAD_COLLECTIVE``; int8 composes with
'psum' only) and ``remat_plan`` (a policy a pipeline block); the last
two and int8 need ``pipeline=``. ``pipelined_step_trace_count`` /
``pipelined_accum_step_trace_count`` count the pipelined builds,
``pipelined_issue_ledger`` / ``pipelined_bucket_order`` record the last
build's bucket issue. ``pipelined_hlo`` has no counterpart (there is no
lowered program text; ``pipelined_structure`` reads the ledger).

Refused with ``MXNetError``: ``sharding="fsdp"`` with a norm-based
optimizer (LAMB, LARS), whose trust ratio would read a shard's norm (on
the pipelined step at its first step, with the JAX message).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import autograd
from .. import random as _random
from ..base import MXNetError, getenv_bool
from ..gluon.block import Block
from ..ndarray import NDArray
from ..optimizer import create as opt_create
from ..optimizer.fused import (all_finite, apply_updates, norm_based,
                               tree_leaves)
from ..serve.program import GraphCapture, Packed, add_launches
from ..train.outcomes import StepOutcome, StepRecorder
from . import collectives as _coll
from . import mesh as _mesh

__all__ = ["SPMDTrainer", "batch_group", "gather_full_params",
           "shard_params", "replicate", "constrain",
           "activation_sharding_scope", "active_mesh", "TPAxis",
           "tp_linear", "vocab_split", "vocab_ce", "split_sum"]


_INPUTS = (("t", (), torch.float32), ("lr", (), torch.float32),
           ("scale", (), torch.float32))
_ACCUM_INPUTS = _INPUTS + (("inv_k", (), torch.float32),
                           ("first", (), torch.float32),
                           ("last", (), torch.float32))
_OUTPUTS = (("loss", (), torch.float32), ("ok", (), torch.float32))


class _StepProgram:
    """One batch signature's train step: the static buffers its body
    reads and writes, and on a CUDA device its graph (``graph``, with
    the launches its capture counted and the ``replays`` so far).
    ``first_ms`` times the signature's eager first step, ``build_ms`` the
    capture."""

    def __init__(self, signature, device: torch.device, inputs=_INPUTS):
        self.batch = [torch.empty(shape, dtype=dtype, device=device)
                      for shape, dtype in signature]
        self.inp = Packed(inputs, device)
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

    def stage(self, batch, t, lr, scale, **scalars):
        """A step's inputs into the static buffers: each batch tensor by
        ``copy_`` (device to device when it lies on the device), ``t``,
        ``lr``, ``scale`` and the program's other scalar inputs in one
        copy. Does not wait."""
        if self._staged is not None:
            self._staged.synchronize()
        host = self.inp.host
        host["t"][...] = t
        host["lr"][...] = lr
        host["scale"][...] = scale
        for name, value in scalars.items():
            host[name][...] = value
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


class _AccumState:
    """The trainer's accumulation state, device tensors every
    accumulation graph holds by address: an f32 sum per trainable
    parameter, the round's verdict and loss sum, and the round-start copy
    of the module buffers the guard may put back (``snap``)."""

    def __init__(self, targets, buffers, device):
        self.grads = [torch.zeros(t.shape, dtype=torch.float32,
                                  device=device) for t in targets]
        self.ok = torch.ones((), dtype=torch.float32, device=device)
        self.loss = torch.zeros((), dtype=torch.float32, device=device)
        self.snap = [b.detach().clone() for b in buffers]

    def restart(self):
        """Zero sums and a clean verdict, in place."""
        with torch.no_grad():
            torch._foreach_zero_(self.grads)
            self.ok.fill_(1.0)
            self.loss.zero_()


def _tensors(batch):
    """A batch's tensors: an ``NDArray``'s where it lies, a tensor as is,
    anything else through numpy."""
    return [b._data if isinstance(b, NDArray) else
            b if torch.is_tensor(b) else torch.as_tensor(np.asarray(b))
            for b in batch]


_BATCH_GROUP = contextvars.ContextVar("mxtpu_batch_group", default=None)


@contextlib.contextmanager
def _sync_scope(group):
    tok = _BATCH_GROUP.set(group)
    try:
        yield
    finally:
        _BATCH_GROUP.reset(tok)


def batch_group():
    """The process group the running ``SPMDTrainer`` step splits its batch
    over (``gluon.contrib.nn.SyncBatchNorm`` reduces its statistics over
    it); None outside a step and without a process group."""
    return _BATCH_GROUP.get()


# The mesh of the running SPMDTrainer step: ``constrain``, the
# tensor-parallel layers and the sequence-parallel models read it (outside
# a step, or on a mesh whose tp and sp axes are 1, they do what one device
# does).
_ACTIVE_MESH = contextvars.ContextVar("mxtpu_active_mesh", default=None)


@contextlib.contextmanager
def activation_sharding_scope(mesh):
    """Make ``mesh`` the active mesh inside the block (the trainer's step
    runs its forward and backward in one)."""
    tok = _ACTIVE_MESH.set(mesh)
    try:
        yield
    finally:
        _ACTIVE_MESH.reset(tok)


def active_mesh():
    """The mesh of the innermost ``activation_sharding_scope``, or None."""
    return _ACTIVE_MESH.get()


# the axes a layout change moves data over on a rank: the batch axes (dp,
# fsdp) name the tile the trainer already cut from the global batch
_MOVING = ("tp", "sp", "ep")


def _canonical(entry, sizes):
    axes = tuple(entry) if isinstance(entry, (tuple, list)) else \
        ((entry,) if entry is not None else ())
    kept = tuple(a for a in axes if sizes.get(a, 1) > 1)
    if set(kept) == {"dp", "fsdp"}:
        kept = ("fsdp", "dp")
    return kept


def constrain(x, *spec, mesh=None, src=None):
    """Put an activation into the layout ``spec`` names on this rank: the
    port of the JAX ``constrain`` (``lax.with_sharding_constraint``),
    where GSPMD moves the data; here the move is explicit and
    differentiable. Each ``spec`` entry is an axis name, a tuple of them
    or None; axes absent from the mesh or of size 1 are dropped, and
    ``("dp", "fsdp")`` in either order is canonicalized to
    ``("fsdp", "dp")``, as in JAX. ``src`` is the layout ``x`` is in
    (default: the trainer's, the batch tile with nothing on tp or sp).

    Only the tp, sp and ep axes move data (the batch axes name the tile
    the trainer already cut): a dimension ENTERING an axis is sliced to this
    rank's tile (its gradient is the tile's, zero elsewhere); one LEAVING
    an axis is all-gathered over it (its gradient is reduce-scattered, the
    sum over the ranks of each tile's). These are the adjoints over the
    ranks, under which a rank's gradients are those of the sum of every
    rank's loss, and ``SPMDTrainer`` averages the gradients over every
    rank (see ``SPMDTrainer``). The identity with no mesh (active or
    given) and when nothing moves."""
    if mesh is None:
        mesh = _ACTIVE_MESH.get()
    if mesh is None:
        return x
    sizes = _mesh.axis_sizes(mesh)
    dst = [_canonical(e, sizes) for e in spec]
    cur = [_canonical(e, sizes) for e in (src or ())]
    if not any(a in _MOVING for e in dst + cur for a in e):
        return x
    is_nd = isinstance(x, NDArray)
    t = x._data if is_nd else x
    dst += [()] * (t.dim() - len(dst))
    cur += [()] * (t.dim() - len(cur))
    for d in range(t.dim()):
        have = [a for a in cur[d] if a in _MOVING]
        want = [a for a in dst[d] if a in _MOVING]
        for a in reversed(have):
            if a not in want:
                t = _coll.gather_tiles(t, _mesh.axis_group(mesh, a), d)
        for a in want:
            if a not in have:
                n = t.shape[d] // sizes[a]
                if n * sizes[a] != t.shape[d]:
                    raise MXNetError(
                        f"constrain: dimension {d} of size {t.shape[d]} "
                        f"does not divide over the {a} axis of "
                        f"{sizes[a]}")
                t = t.narrow(d, _mesh.axis_index(mesh, a) * n, n)
    return NDArray(t) if is_nd else t


def split_sum(x, seq: bool = False):
    """``(n, total)``: the number of ranks that split the global batch
    in the active step (dp x fsdp, times sp when ``seq``: the sequence is
    split too) and ``x`` (a tensor) summed over them; ``(1, x)`` outside
    a step. A loss normalized by a global sum (a weighted mean) is
    ``n x (its rank's numerator) / total`` on each rank: the trainer's
    mean over the ranks is then the global batch's."""
    mesh = _ACTIVE_MESH.get()
    if mesh is None:
        return 1, x
    sizes = _mesh.axis_sizes(mesh)
    n = 1
    for a in ("dp", "fsdp") + (("sp",) if seq else ()):
        if sizes[a] > 1:
            x = _coll.psum(x, _mesh.axis_group(mesh, a))
            n *= sizes[a]
    return n, x


def neg_global_ratio(num, den, seq: bool = False):
    """``-num / den`` for a loss normalized by a global sum: ``den`` (an
    ``NDArray``, the rank's share) summed over the ranks that split the
    batch (``split_sum``) and the rank's numerator scaled by their
    number; the 1e-6 keeps an all-zero denominator finite."""
    n, total = split_sum(den._data, seq=seq)
    if n == 1:
        return -num / (den + 1e-6)
    return -num * n / (NDArray(total) + 1e-6)


class TPAxis:
    """A rank's place on the tp axis: ``size``, ``index`` and ``group``."""

    def __init__(self, size: int, index: int = 0, group=None):
        self.size, self.index, self.group = int(size), int(index), group

    @classmethod
    def of(cls, mesh) -> Optional["TPAxis"]:
        """The tp axis of ``mesh`` (default: the active one) when it has
        more than one rank, else None."""
        mesh = _ACTIVE_MESH.get() if mesh is None else mesh
        if mesh is None or _mesh.axis_sizes(mesh)["tp"] <= 1:
            return None
        return cls(_mesh.axis_sizes(mesh)["tp"],
                   _mesh.axis_index(mesh, "tp"),
                   _mesh.axis_group(mesh, "tp"))

    def rows(self, t, groups: int = 1):
        """This rank's tile of ``t``'s first dimension, read as ``groups``
        equal parts each split over tp (q, k and v of a fused projection:
        ``groups=3``, so a rank keeps whole heads of each)."""
        n = t.shape[0] // (groups * self.size)
        if groups == 1:
            return t.narrow(0, self.index * n, n)
        return t.reshape((groups, t.shape[0] // groups) + t.shape[1:]) \
            .narrow(1, self.index * n, n).reshape((groups * n,) + t.shape[1:])

    def cols(self, t):
        """This rank's tile of ``t``'s last dimension."""
        n = t.shape[-1] // self.size
        return t.narrow(-1, self.index * n, n)


def vocab_split(tp: Optional[TPAxis], vocab: int) -> Optional[TPAxis]:
    """``tp`` when logits over ``vocab`` are split over it (the JAX
    models' vocab-split logits), None when there is no tp axis or it
    does not divide the vocabulary (the head then computes it whole)."""
    return tp if tp is not None and vocab % tp.size == 0 else None


def vocab_ce(logits, labels, tp: TPAxis):
    """``(label score, logsumexp)`` over a vocabulary split over tp, in
    f32: ``logits`` (..., V / tp) this rank's tile, ``labels`` (...) ids
    in the whole vocabulary. The maximum is a ``MAX`` all-reduce (no
    gradient: the logsumexp does not depend on it), the sum of the
    exponentials and the label's score (one rank's tile holds it) are
    ``psum``-s over tp; every tp rank gets the same values."""
    lf = logits.float()
    m = lf.detach().amax(dim=-1)
    if tp.group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
    total = _coll.psum(torch.exp(lf - m[..., None]).sum(dim=-1), tp.group)
    lse = torch.log(total) + m
    n = logits.shape[-1]
    local = labels.long() - tp.index * n
    inside = (local >= 0) & (local < n)
    pick = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    score = _coll.psum(torch.where(inside, pick, torch.zeros_like(pick)),
                       tp.group)
    return score, lse


def _tp_entry(hint, dim):
    if hint is None or dim >= len(hint):
        return False
    e = hint[dim]
    return e == "tp" or (isinstance(e, (tuple, list)) and "tp" in e)


def tp_linear(x, weight, bias, hint, tp: Optional[TPAxis], groups: int = 1):
    """A Dense layer's ``x @ weight.T + bias`` on this rank's tile when
    the weight's sharding hint names tp (None when it does not, or when
    ``tp`` is None): ``("tp", None)`` is column-parallel (the rank
    computes its tile of the output features from the whole input; with
    ``groups`` parts, whole heads of each), ``(None, "tp")`` row-parallel
    (the input is this rank's tile of the features; the partial products
    are summed over tp with ``psum``, whose backward sums the input's
    gradient over tp too). Tensors in, a tensor out."""
    import torch.nn.functional as F
    if tp is None:
        return None
    if _tp_entry(hint, 0):
        return F.linear(x, tp.rows(weight, groups),
                        None if bias is None else tp.rows(bias, groups))
    if _tp_entry(hint, 1):
        y = _coll.psum(F.linear(x, tp.cols(weight)), tp.group)
        return y if bias is None else y + bias
    return None


def _fsdp_dim(shape, size: int) -> Optional[int]:
    """The dimension a parameter of ``shape`` is sharded on over an fsdp
    axis of ``size`` (the JAX ``_fsdp_spec`` rule without tensor-parallel
    hints): None at an fsdp size of 1 and for rank-1 and small tensors,
    else the first dimension ``size`` divides."""
    min_elems = int(os.environ.get("MXTPU_FSDP_MIN_SIZE", "16384"))
    if size == 1 or len(shape) < 2 or int(np.prod(shape)) < min_elems:
        return None
    for d, n in enumerate(shape):
        if n % size == 0 and n >= size:
            return d
    return None


def _hint_of(param):
    """A parameter's sharding hint (the JAX ``Parameter._sharding``
    ``PartitionSpec``, here a tuple), or None."""
    hint = getattr(param, "_sharding", None)
    return None if hint is None else tuple(hint)


def _shard_plan(shape, sizes, mode: str, hint=None):
    """How a parameter of ``shape`` is sharded on a mesh of axis
    ``sizes``: ``((dim, axis), ...)`` in the order the tiles nest (an
    entry naming two axes on one dimension is major-first), empty for a
    replicated parameter. The JAX ``_param_sharding`` rule: the hint (tp
    on a dimension) kept, and under ``sharding="fsdp"`` the ``_fsdp_spec``
    rule extending it (the first free dimension the fsdp size divides; a
    parameter with no hint only when rank >= 2 and at least
    ``MXTPU_FSDP_MIN_SIZE`` elements); axes of size 1 dropped."""
    entries = list(hint or ()) + [None] * (len(shape) - len(hint or ()))
    fsdp = sizes["fsdp"]
    if mode == "fsdp" and fsdp > 1:
        used = {a for e in entries if e is not None
                for a in (e if isinstance(e, (tuple, list)) else (e,))}
        if hint is None:
            d = _fsdp_dim(shape, fsdp)
            if d is not None:
                entries[d] = "fsdp"
        elif "fsdp" not in used:
            for d, n in enumerate(shape):
                if entries[d] is None and n % fsdp == 0 and n >= fsdp:
                    entries[d] = "fsdp"
                    break
    plan = []
    for d, e in enumerate(entries):
        n = shape[d]
        for a in (e if isinstance(e, (tuple, list)) else (e,)):
            # a dimension an axis does not divide stays whole on it (the
            # JAX placement pads such a shard)
            if a is not None and sizes.get(a, 1) > 1 and n % sizes[a] == 0:
                plan.append((d, a))
                n //= sizes[a]
    return tuple(plan)


def _mesh_of(mesh):
    """The trainer's mesh: ``build_mesh``'s, or the process default for
    None and for a list naming one device."""
    if mesh is None:
        return _mesh.default_mesh()
    if isinstance(mesh, (list, tuple, str, torch.device)):
        devices = list(mesh) if isinstance(mesh, (list, tuple)) else [mesh]
        if len(devices) > 1:
            raise MXNetError(
                f"SPMDTrainer: a mesh of {len(devices)} devices in one "
                f"process; the port runs one device a process (start one "
                f"process a device with tools/launch.py and pass "
                f"mesh=parallel.build_mesh(...))")
        return _mesh.default_mesh()
    return mesh


class SPMDTrainer:
    """Fused train step over a dp x fsdp x tp x sp mesh (see the module's
    docstring).

    Parameters follow the JAX package's: ``block`` (an ``nn.Module``; a
    gluon ``Block``, initialized, is one),
    ``loss`` (``loss(out, *labels)``) or ``forward_loss``
    (``fn(block, *batch) -> scalar``), ``optimizer`` with
    ``optimizer_params``, ``mesh`` (``parallel.build_mesh``'s; None is the
    process default, every rank on dp; a list naming one device is
    accepted), ``sharding`` ('replicated' or 'fsdp'), ``loss_scaler``
    (``amp.LossScaler``), ``guard`` (the in-step non-finite guard; None
    reads ``MXTPU_STEP_GUARD``, default on) and
    ``max_consecutive_nonfinite``, ``pipeline`` (a ``PipelineSpec``: the
    pipelined-backward step, whose head and finalize are the loss) with
    ``int8_allreduce``, ``grad_collective`` and ``remat_plan`` (see the
    module's docstring). ``donate`` has no effect (the step updates the
    parameters and the optimizer state in place)."""

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
        if sharding not in ("replicated", "fsdp"):
            raise MXNetError(f"unknown sharding {sharding!r}")
        self._pipeline = pipeline
        if int8_allreduce is None:
            int8_allreduce = getenv_bool("MXTPU_INT8_ALLREDUCE", False)
        self._int8_allreduce = bool(int8_allreduce)
        if grad_collective is None:
            grad_collective = os.environ.get("MXTPU_GRAD_COLLECTIVE",
                                             "psum")
        if grad_collective not in ("psum", "ring"):
            raise MXNetError(
                f"grad_collective must be 'psum' or 'ring', got "
                f"{grad_collective!r}")
        if grad_collective == "ring" and self._int8_allreduce:
            raise MXNetError(
                "int8_allreduce composes with grad_collective='psum' "
                "only (the ring carries f32 chunks)")
        self._grad_collective = grad_collective
        self._remat_plan = list(remat_plan) if remat_plan is not None \
            else None
        if pipeline is None and (self._int8_allreduce
                                 or remat_plan is not None):
            raise MXNetError(
                "int8_allreduce / remat_plan require pipeline= (the "
                "GSPMD step has no in-program collective seam)")
        self.pipelined_issue_ledger = None   # set by each pipelined run
        self.pipelined_bucket_order = None
        self._pipe_fb = None                 # pipelined.PipelinedBackward
        self.mesh = _mesh_of(mesh)
        sizes = self._sizes = _mesh.axis_sizes(self.mesh)
        self._fsdp_size = sizes["fsdp"]
        self._dp_size = sizes["dp"]
        self._replicas = sizes["dp"] * sizes["fsdp"]
        # collectives run over a process group's mesh (world 1 too)
        self._collective = not isinstance(self.mesh, _mesh.LocalMesh)
        coord = self._coord = dict(zip(self.mesh.mesh_dim_names,
                                       self.mesh.get_coordinate()))
        # the rank's batch tile: fsdp-major, as JAX's ("fsdp", "dp"); the
        # ranks of one tile differ in tp and sp only
        self._batch_index = coord["fsdp"] * sizes["dp"] + coord["dp"]
        self._fsdp_index = coord["fsdp"]
        self._dp_index = coord["dp"]
        self._groups = {a: _mesh.axis_group(self.mesh, a)
                        for a in ("dp", "fsdp", "tp", "sp")
                        if self._collective and sizes[a] > 1}
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
        if any(isinstance(p, torch.nn.UninitializedParameter)
               for _, p in named):
            raise MXNetError("the block has uninitialized parameters: call "
                             "initialize() (and run a forward for deferred "
                             "shapes) before building the trainer")
        self._gluon = isinstance(block, Block)
        self._names = [n for n, _ in named]
        self._params = [p for _, p in named]
        self._train_idx = [i for i, p in enumerate(self._params)
                           if p.requires_grad]
        # what the forward may write besides the trained parameters
        self._buffers = list(block.buffers()) + [
            p for p in self._params if not p.requires_grad]
        self.device = self._params[0].device
        if isinstance(optimizer, str):
            self._optimizer = opt_create(
                optimizer, param_dict=dict(named),
                param_idx2name=dict(enumerate(self._names)),
                **(optimizer_params or {}))
        else:
            self._optimizer = optimizer
        # each trainable parameter's shard plan (_shard_plan; empty:
        # replicated) aligned with _train_idx, the dimension it starts
        # on (None: replicated), and its shard tensors
        hints = {}
        if self._gluon:
            for p in block.collect_params().values():
                hints[id(p._var)] = _hint_of(p)
        self._shard_plans = [
            _shard_plan(tuple(self._params[i].shape), sizes, sharding,
                        hints.get(id(self._params[i])))
            for i in self._train_idx]
        self._shard_dims = [plan[0][0] if plan else None
                            for plan in self._shard_plans]
        # (the pipelined step refuses at its first step, as in JAX)
        if pipeline is None and norm_based(self._optimizer) and (
                sharding == "fsdp" or any(self._shard_plans)):
            raise MXNetError(
                f"SPMDTrainer: sharding='fsdp' or a tp axis with "
                f"{type(self._optimizer).__name__} is not ported: its "
                f"trust ratio reads the whole parameter's norm and a "
                f"sharded update runs on a shard")
        self._shards = None
        self._buckets = None        # plan of the replicated gradients
        self._opt_state = None      # list aligned with self._train_idx
        self.step_count = 0
        self.step_trace_count = 0   # step programs built (jit-once)
        self._programs = {}         # batch signature -> _StepProgram
        self._graph_pool = None     # shared by the trainer's graphs
        self.accum_step_trace_count = 0   # accumulation programs built
        self.last_accum_count = 0   # microbatches of the last round
        self._accum_programs = {}   # microbatch signature -> _StepProgram
        self._accum = None          # _AccumState, held by address

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
        snap["accum_step_trace_count"] = self.accum_step_trace_count
        snap["last_accum_count"] = self.last_accum_count
        snap["sharding"] = self.sharding_mode
        snap["replicas"] = self._replicas
        if self._pipeline is not None:
            snap["pipelined"] = True
            snap["pipelined_step_trace_count"] = \
                self.pipelined_step_trace_count
            snap["pipelined_accum_step_trace_count"] = \
                self.pipelined_accum_step_trace_count
            snap["pipelined_bucket_order"] = self.pipelined_bucket_order
            snap["grad_collective"] = self._grad_collective
            snap["int8_allreduce"] = self._int8_allreduce
        return snap

    @property
    def pipelined_step_trace_count(self) -> int:
        """The step programs captured through ``pipeline=`` (0 without
        one): a pipelined trainer's every step program is pipelined."""
        return self.step_trace_count if self._pipeline is not None else 0

    @property
    def pipelined_accum_step_trace_count(self) -> int:
        """The accumulation programs captured through ``pipeline=``."""
        return self.accum_step_trace_count if self._pipeline is not None \
            else 0

    def pipelined_hlo(self, accum: bool = False) -> str:
        """No counterpart: the port's step has no lowered program text.
        Raises ``MXNetError`` naming ``pipelined_structure`` /
        ``parallel.pipelined.structure_report``, which read the step's
        issue ledger (or a profiled replay's timeline on the card)."""
        raise MXNetError(
            "pipelined_hlo: the port's step is not lowered to program "
            "text; pipelined_structure() / parallel.pipelined."
            "structure_report read its issue ledger (and a profiled "
            "replay's kernel timeline on the card)")

    def pipelined_structure(self, accum: bool = False,
                            timeline=None) -> dict:
        """``pipelined.structure_report`` over the last pipelined run's
        issue ledger (``accum`` is the JAX argument: the ledger is the
        last run's, a step's or a microbatch's), or over ``timeline``,
        the kernel names of a profiled replay on the card."""
        from .pipelined import structure_report
        if self._pipeline is None:
            raise MXNetError("pipelined_structure: trainer has no "
                             "pipeline=")
        if self.pipelined_issue_ledger is None:
            raise MXNetError("pipelined_structure: run one step first")
        return structure_report(self.pipelined_issue_ledger, timeline)

    # ------------------------------------------------------------------ #
    def _shard_box(self, slot: int):
        """``[(dim, start, length), ...]`` of trainable ``slot``'s shard
        (one entry a sharded dimension), or None for a replicated
        parameter."""
        plan = self._shard_plans[slot]
        if not plan:
            return None
        shape = self._params[self._train_idx[slot]].shape
        box = {}
        for d, a in plan:
            start, n = box.get(d, (0, shape[d]))
            n //= self._sizes[a]
            box[d] = (start + self._coord[a] * n, n)
        return [(d, start, n) for d, (start, n) in sorted(box.items())]

    def _writes_shard(self, slot: int) -> bool:
        """Whether this rank writes slot's shard into a checkpoint: the
        rank of coordinate 0 on every axis the shard is not split over."""
        split = {a for _, a in self._shard_plans[slot]}
        return all(self._coord[a] == 0 for a in ("dp", "fsdp", "tp", "sp")
                   if a not in split)

    def _materialize(self):
        """The optimizer state (and under fsdp each sharded parameter's
        shard tensor, which the update writes), made at the first step."""
        self._shards = []
        for slot, i in enumerate(self._train_idx):
            box = self._shard_box(slot)
            t = self._params[i].detach()
            for d, start, n in box or ():
                t = t.narrow(d, start, n)
            self._shards.append(None if box is None else t.clone())
        self._opt_state = [
            self._optimizer.create_state_multi_precision(i, t)
            for i, t in zip(self._train_idx, self._targets())]

    def _targets(self):
        """What the update writes, aligned with ``_train_idx``: the
        parameter, or its fsdp shard."""
        return [self._params[i].detach() if sh is None else sh
                for i, sh in zip(self._train_idx, self._shards)]

    def local_batch(self, batch):
        """This rank's tile of a global batch (each tensor's rows; 0-d
        tensors whole); the batch itself without a process group."""
        n = self._replicas
        for b in batch:
            if b.dim() and b.shape[0] % n != 0:
                raise MXNetError(
                    f"batch dim {b.shape[0]} not divisible by the mesh's "
                    f"dp×fsdp size {n}; pad the batch or shrink the mesh")
        if n == 1:
            return batch
        return [b.narrow(0, self._batch_index * (b.shape[0] // n),
                         b.shape[0] // n) if b.dim() else b
                for b in batch]

    def _forward_backward(self, batch, scale):
        """(loss, gradients) of the block in training mode on this rank's
        tile, then reduced over the mesh (``_reduce``): the loss is
        scaled for the backward and divided back, as the JAX step does.
        The pipelined step's forward / backward in its place under
        ``pipeline=``."""
        if self._pipe_fb is not None:
            return self._pipe_fb(batch, scale)
        params = [self._params[i] for i in self._train_idx]
        was_training = self.block.training
        self.block.train()
        if self._gluon:
            batch = [NDArray(b) for b in batch]
        try:
            with torch.enable_grad(), autograd.record(train_mode=True), \
                    _sync_scope(None if not self._collective else
                                dist.group.WORLD), \
                    activation_sharding_scope(self.mesh):
                if self.forward_loss is not None:
                    L = self.forward_loss(self.block, *batch)
                else:
                    L = self.loss(self.block(batch[0]), *batch[1:])
                if isinstance(L, NDArray):
                    L = L._data
                if L.dim() > 0:
                    L = L.mean()
                scaled = L * scale
                grads = torch.autograd.grad(scaled, params,
                                            allow_unused=True)
        finally:
            self.block.train(was_training)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return self._reduce(scaled.detach() / scale, grads)

    @torch.no_grad()
    def _reduce(self, loss, grads):
        """The loss and the gradients averaged over every rank:
        replicated gradients by buckets of one flat all-reduce each over
        the world, sharded ones reduce-scattered over each axis of their
        plan (the mean; each comes back as this rank's shard) and then
        averaged over the other axes. The floating buffers the forward
        wrote are averaged too. Without a process group, the inputs as
        they are.

        Every rank's gradients are those of the SUM of every rank's loss
        (the collectives' backwards are their adjoints over the ranks),
        and the losses sum to the world size times the global loss: the
        ranks of a batch tile split its sequence (sp: each rank's loss is
        its block's share scaled to the tile's) or compute it whole (tp,
        and sp outside the sequence-parallel stretch). So the mean over
        every rank is the global loss's gradient for every parameter,
        wherever the model reads it."""
        if not self._collective:
            return loss, grads
        _coll.all_reduce_mean_(loss)
        out = list(grads)
        dense = [k for k, plan in enumerate(self._shard_plans) if not plan]
        if self._buckets is None:
            members = [(k, grads[k].numel(), grads[k].element_size(),
                        str(grads[k].dtype)) for k in dense]
            self._buckets = [b.indices for b in _coll.plan_grad_buckets(
                members, _coll.bucket_limit(), reverse=False)]
        for members in self._buckets:
            flat = torch.cat([grads[k].reshape(-1) for k in members])
            _coll.all_reduce_mean_(flat)
            for k, part in zip(members, flat.split(
                    [grads[k].numel() for k in members])):
                out[k] = part.view(grads[k].shape)
        for k, plan in enumerate(self._shard_plans):
            if plan:
                out[k], _ = self._reduce_sharded(k, grads[k])
        if _mesh.world_size() > 1:
            for b in self._buffers:
                if b.is_floating_point():
                    _coll.all_reduce_mean_(b.data)
        return loss, out

    def _reduce_sharded(self, slot: int, g):
        """Sharded ``slot``'s gradient ``g`` averaged over every rank:
        reduce-scattered over each axis of its plan (this rank's shard
        comes back), averaged over the other axes. Returns ``(shard,
        collective calls)``."""
        plan = self._shard_plans[slot]
        for d, a in plan:
            g = _coll.reduce_scatter(g, self._groups[a], d, op="mean")
        split = {a for _, a in plan}
        calls = len(plan)
        for a, group in self._groups.items():
            if a not in split:
                _coll.all_reduce_mean_(g, group)
                calls += 1
        return g, calls

    def _shard_of(self, slot: int, full):
        """This rank's shard of trainable ``slot``'s whole tensor ``full``
        (``full`` itself for a replicated parameter)."""
        for d, start, n in self._shard_box(slot) or ():
            full = full.narrow(d, start, n)
        return full

    def _buffer_names(self):
        """Names of ``_buffers``, in its order (error messages)."""
        names = [n for n, _ in self.block.named_buffers()]
        return names + [n for n, p in zip(self._names, self._params)
                        if not p.requires_grad]

    def _gather(self, slot: int, out=None):
        """Trainable ``slot``'s whole parameter from the ranks' shards
        (into ``out`` when given): all-gathers over its plan's axes,
        innermost first."""
        t = self._shards[slot]
        steps = list(reversed(self._shard_plans[slot]))
        for j, (d, a) in enumerate(steps):
            t = _coll.all_gather(t, self._groups[a], d,
                                 out=out if j == len(steps) - 1 else None)
        return t

    @torch.no_grad()
    def _gather_params(self):
        """Every sharded parameter rebuilt from the ranks' updated shards,
        written in place."""
        for slot, i in enumerate(self._train_idx):
            if self._shard_plans[slot]:
                self._gather(slot, out=self._params[i].detach())

    def _global_ok(self, ok):
        """The guard's flag, the minimum over the ranks."""
        if self._collective:
            dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        return ok

    @torch.no_grad()
    def _apply(self, grads, t, lr, scale):
        """The (guarded) update of every trainable parameter (or its
        shard), written in place into the targets and into the optimizer
        state tensors ``_materialize`` made, then the shards gathered.
        Returns the guard flag (an f32 0-d tensor on the device). Reads
        nothing back from the device."""
        weights = self._targets()
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
            ok = self._global_ok(all_finite(grads))
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
        self._gather_params()
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
        """The CUDA generators the block's modules draw from, and
        ``mx.random``'s for the device (gluon's Dropout draws from it)."""
        gens = {}
        if self.device.type == "cuda":
            g = _random.generator(self.device)
            gens[id(g)] = g
        for m in self.block.modules():
            g = getattr(m, "generator", None)
            if isinstance(g, torch.Generator) and g.device.type == "cuda":
                gens[id(g)] = g
        return list(gens.values())

    def _first_run(self, prog: _StepProgram, body):
        """A signature's first run of ``body(prog, moves_counters)``,
        eagerly: on the card on the capture stream, ahead of the capture
        (``_capture``)."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            prog.capture = GraphCapture(self.device, self._graph_pool,
                                        self._generators())
            prog.capture.eager(lambda: body(prog, False))
        else:
            body(prog, True)
        prog.first_ms = (time.perf_counter() - t0) * 1e3

    def _capture(self, prog: _StepProgram, body):
        """On the card, capture ``body`` into ``prog.graph`` (raises
        ``MXNetError`` if the capture fails); nothing on the CPU."""
        cap, prog.capture = prog.capture, None
        if cap is None:
            return
        t0 = time.perf_counter()
        prog.launches = cap.record(lambda: body(prog, True))
        prog.graph = cap.graph
        prog.build_ms = (time.perf_counter() - t0) * 1e3

    def step(self, *batch):
        """Run one fused train step; returns the loss, an ``NDArray`` on
        the device of its own. The batch may be ``NDArray``s, tensors or
        array-likes (an ``NDArray``'s tensor is read where it lies, never
        through the host). The first step of a batch signature builds its
        program (see the module's docstring); later ones stage and replay
        it."""
        batch = _tensors(batch)
        local = self.local_batch(batch)
        if self._pipeline is not None and self._pipe_fb is None:
            from .pipelined import build_pipelined_step
            self._pipe_fb = build_pipelined_step(self, len(batch))
        if self._opt_state is None:
            self._materialize()
        sig = tuple((tuple(b.shape), b.dtype) for b in batch)
        prog = self._programs.get(sig)
        build = prog is None
        if build:
            prog = _StepProgram(
                tuple((tuple(b.shape), b.dtype) for b in local), self.device)
        self._optimizer.num_update = self.step_count  # drive lr schedules
        prog.stage(local, self.step_count + 1,
                   self._optimizer.learning_rate,
                   1.0 if self.loss_scaler is None
                   else self.loss_scaler.loss_scale)
        self._recorder.open_step()
        try:
            if build:
                self._first_run(prog, self._run_body)
            elif prog.graph is not None:
                prog.replay()
            else:
                self._run_body(prog, False)
            loss = NDArray(prog.out.dev["loss"].clone())
            verdict = prog.read() if self.guard else None
        except BaseException:
            # the step died before any outcome existed — close it so the
            # next one is not accused of a missing record
            self._recorder.abort_step()
            raise
        failure = None
        if build:
            try:
                self._capture(prog, self._run_body)
            except MXNetError as e:
                failure = e             # raised once the step is recorded
            else:
                self._programs[sig] = prog
                self.step_trace_count += 1
        self._settle(verdict, f"non-finite gradient in fused SPMD step at "
                              f"step_count={self.step_count}")
        if failure is not None:
            raise failure
        return loss

    def _settle(self, verdict, what):
        """Host counters, the recorder and the loss scaler from the
        step's read-back ``(loss, ok)`` (None without the guard); ``what``
        begins the detail of a skipped step."""
        applied = (not self.guard) or verdict[1] > 0
        if applied:
            self.step_count += 1
            self._recorder.record(StepOutcome.APPLIED)
            if self.loss_scaler is not None and self.guard:
                self.loss_scaler.update_scale(overflow=False)
            return
        if self.loss_scaler is not None:
            self.loss_scaler.update_scale(overflow=True)
        detail = f"{what} (loss={verdict[0]:g})"
        outcome = self._recorder.record(StepOutcome.SKIPPED_NONFINITE,
                                        detail)
        if outcome is StepOutcome.HALTED_POISONED:
            raise self._recorder.halt_error(
                detail,
                loss_scale=None if self.loss_scaler is None
                else self.loss_scaler.loss_scale)

    # ------------------------------------------------------------------ #
    def _accum_state(self) -> "_AccumState":
        if self._accum is None:
            self._accum = _AccumState(
                self._targets(), self._buffers if self.guard else [],
                self.device)
        return self._accum

    @torch.no_grad()
    def _accum_apply(self, inp, apply):
        """The update from the accumulators' mean, computed whatever
        ``apply`` (a 0-d bool device tensor) holds and written into the
        parameters and the optimizer state only where it is true."""
        weights = self._targets()
        base = torch.full((), float(self._optimizer.rescale_grad),
                          dtype=torch.float32, device=self.device)
        new_w, new_states = apply_updates(
            self._optimizer, self._train_idx, weights,
            [a * inp["inv_k"] for a in self._accum.grads], self._opt_state,
            inp["t"], inp["lr"], rescale_grad=base / inp["scale"])
        torch._foreach_copy_(weights, [
            torch.where(apply, nw, w) for nw, w in zip(new_w, weights)])
        old_leaves = tree_leaves(self._opt_state)
        if old_leaves:
            torch._foreach_copy_(old_leaves, [
                torch.where(apply, n, o)
                for n, o in zip(tree_leaves(new_states), old_leaves)])
        self._gather_params()

    def _run_accum_body(self, prog: _StepProgram, moves_counters: bool):
        """One microbatch over ``prog``'s static buffers and the trainer's
        accumulators (see the module's docstring). The optimizer's host
        update counters keep their values unless ``moves_counters``."""
        opt = self._optimizer
        saved = dict(opt._index_update_count), opt.num_update
        inp, out, acc = prog.inp.dev, prog.out.dev, self._accum
        first, last = inp["first"] > 0, inp["last"] > 0
        if acc.snap:
            with torch.no_grad():   # the round-start copy of the buffers
                torch._foreach_copy_(acc.snap, [
                    torch.where(first, b, s)
                    for b, s in zip(self._buffers, acc.snap)])
        loss, grads = self._forward_backward(prog.batch, inp["scale"])
        with torch.no_grad():
            torch._foreach_add_(acc.grads, [g.float() for g in grads])
            ok = acc.ok * self._global_ok(all_finite(grads)) \
                if self.guard else acc.ok
            loss_round = acc.loss + loss
            self._accum_apply(inp, last & (ok > 0))
            if acc.snap:
                veto = last & (ok <= 0)
                torch._foreach_copy_(self._buffers, [
                    torch.where(veto, s, b)
                    for b, s in zip(self._buffers, acc.snap)])
            # the accumulators start again after a round's last microbatch
            torch._foreach_copy_(acc.grads, [
                torch.where(last, 0.0, a) for a in acc.grads])
            out["loss"].copy_(loss_round * inp["inv_k"])
            out["ok"].copy_(ok)
            acc.ok.copy_(torch.where(last, 1.0, ok))
            acc.loss.copy_(torch.where(last, 0.0, loss_round))
        if not moves_counters:
            opt._index_update_count, opt.num_update = saved

    def step_microbatches(self, microbatches):
        """One optimizer step over ``microbatches`` (each a batch tuple, or
        one array): the gradients of each, accumulated in f32 on the
        device, and the update from their mean applied once; returns the
        round's mean loss, an ``NDArray`` of its own. The count is host
        data: rounds of any count over one microbatch signature run one
        build (``accum_step_trace_count``), a graph on the card. A
        non-finite gradient in any microbatch skips the whole apply
        (parameters, optimizer state and module buffers bitwise those at
        the round's start), records one ``SKIPPED_NONFINITE`` and halves
        the loss scale once; ``step_count`` does not advance."""
        rounds = [_tensors(b if isinstance(b, (tuple, list)) else (b,))
                  for b in microbatches]
        if not rounds:
            raise MXNetError("step_microbatches needs >= 1 microbatch")
        for b in rounds:
            for t in b:
                if t.dim() and t.shape[0] % self._replicas:
                    raise MXNetError(
                        f"microbatch dim {t.shape[0]} not divisible by "
                        f"the mesh's dp×fsdp size {self._replicas}")
        k = len(rounds)
        if self._pipeline is not None and self._pipe_fb is None:
            from .pipelined import build_pipelined_accum_step
            self._pipe_fb = build_pipelined_accum_step(self, len(rounds[0]))
        if self._opt_state is None:
            self._materialize()
        acc = self._accum_state()
        self._optimizer.num_update = self.step_count  # drive lr schedules
        scalars = dict(t=self.step_count + 1,
                       lr=self._optimizer.learning_rate,
                       scale=1.0 if self.loss_scaler is None
                       else self.loss_scaler.loss_scale, inv_k=1.0 / k)
        self._recorder.open_step()
        try:
            for m, batch in enumerate(rounds):
                sig = tuple((tuple(b.shape), b.dtype) for b in batch)
                local = self.local_batch(batch)
                prog = self._accum_programs.get(sig)
                if prog is None:
                    prog = _StepProgram(
                        tuple((tuple(b.shape), b.dtype) for b in local),
                        self.device, _ACCUM_INPUTS)
                prog.stage(local, first=float(m == 0),
                           last=float(m == k - 1), **scalars)
                if sig not in self._accum_programs:
                    self._first_run(prog, self._run_accum_body)
                    self._capture(prog, self._run_accum_body)
                    self._accum_programs[sig] = prog
                    self.accum_step_trace_count += 1
                elif prog.graph is not None:
                    prog.replay()
                else:
                    self._run_accum_body(prog, False)
            loss = NDArray(prog.out.dev["loss"].clone())
            verdict = prog.read() if self.guard else None
        except BaseException:
            # a round that died drops what it accumulated
            self._recorder.abort_step()
            acc.restart()
            raise
        self.last_accum_count = k
        self._settle(verdict, f"non-finite gradient in accumulated SPMD "
                              f"round (k={k}) at step_count="
                              f"{self.step_count}")
        return loss

    # ------------------------------------------------------------------ #
    # checkpointing (checkpoint/): the gather copies every leaf to the
    # host before save returns, and a restore copies into the tensors the
    # step graphs hold, so a resume replays the captured graphs as they
    # are.
    # ------------------------------------------------------------------ #
    def save_checkpoint(self, manager, step=None, iterator=None,
                        block=False):
        """Async full-capsule snapshot (parameters, optimizer state, step
        count, the scheduler's num_update, the random state, the
        iterator's position); ``step`` defaults to ``step_count``.
        Returns the step saved."""
        from .. import checkpoint as _ckpt
        tree, meta = _ckpt.spmd_capsule(self, iterator=iterator)
        if step is None:
            step = meta["step"]
        else:
            # the caller's loop position wins: step_count does not advance
            # on guard-skipped steps, and a resume must not re-run batches
            meta["step"] = int(step)
        manager.save(int(step), tree, meta=meta, block=block)
        return int(step)

    def restore_checkpoint(self, manager, step=None, iterator=None):
        """Bit-exact resume from ``manager`` (default: the latest committed
        step), in place (see ``checkpoint.restore_spmd``). The block must
        be initialized with known shapes. Returns the restored step."""
        from .. import checkpoint as _ckpt
        arrays, meta = manager.restore(step)
        _ckpt.restore_spmd(self, arrays, meta, iterator=iterator)
        return int(meta.get("step", 0))

    def install_preemption(self, manager, iterator=None, exit_after=True):
        """Arm SIGTERM: drain any in-flight snapshot, write one final
        synchronous capsule, then let the process die."""
        from .. import checkpoint as _ckpt

        def _state():
            tree, meta = _ckpt.spmd_capsule(self, iterator=iterator)
            return meta["step"], tree, meta

        return manager.install_preemption_hook(_state,
                                               exit_after=exit_after)


@torch.no_grad()
def gather_full_params(trainer) -> dict:
    """``{name: numpy array}`` of every parameter of ``trainer``, each
    whole: a sharded parameter is all-gathered from the ranks' shards
    (the update's own tensors, not the resident full copy), a replicated
    one copied as it is (never a view of the live parameter, which later
    steps update in place). Every rank of the group must call it."""
    out = {}
    slots = {i: k for k, i in enumerate(trainer._train_idx)}
    for i, (name, p) in enumerate(zip(trainer._names, trainer._params)):
        k = slots.get(i)
        if trainer._shards is not None and k is not None and \
                trainer._shards[k] is not None:
            full = trainer._gather(k)
        else:
            full = p.detach()
        out[name] = np.array(full.float().cpu() if full.dtype ==
                             torch.bfloat16 else full.cpu())
    return out


def replicate(mesh):
    """The placements of a replicated array over ``mesh`` (the JAX
    ``replicate``'s ``NamedSharding(mesh, PartitionSpec())``)."""
    return _mesh.named_sharding(mesh)


def shard_params(block, mesh, mode: str = "replicated") -> dict:
    """``{name: placements}`` of every parameter of ``block`` over
    ``mesh`` under ``mode`` ('replicated' or 'fsdp'; the ``_shard_plan``
    rule, tp hints included). Unlike the JAX function it moves nothing: a
    rank holds its parameters whole on its own device and ``SPMDTrainer``
    shards their update inside its step."""
    sizes = _mesh.axis_sizes(mesh)
    hints = {}
    if isinstance(block, Block):
        hints = {id(p._var): _hint_of(p)
                 for p in block.collect_params().values()}
    out = {}
    for name, p in block.named_parameters():
        spec = [None] * p.dim()
        for d, a in _shard_plan(tuple(p.shape), sizes, mode,
                                hints.get(id(p))):
            spec[d] = a if spec[d] is None else (
                (spec[d] if isinstance(spec[d], tuple) else (spec[d],))
                + (a,))
        out[name] = _mesh.named_sharding(mesh, *spec)
    return out
