"""Pipeline parallelism over the ``pp`` mesh axis (GPipe schedule): the
port of the JAX package's ``incubator_mxnet_tpu/parallel/pipeline.py``.

Per-stage parameters are stacked on a leading dimension of S (the pp
size; ``stack_stage_params``). Each rank runs its stage, and activations
move to the next stage with ``collectives.ppermute`` (``dist.
batch_isend_irecv`` over the pp group) after every tick. A GPipe schedule
of M microbatches fills and drains the pipe in M + S - 1 ticks: stage 0
injects microbatch t (the last one again once they are spent), the last
stage emits microbatch t - (S - 1) once the pipe is full, and the outputs
are masked to the last stage and summed over pp, so every rank gets them.
The stage a rank plays is a device select (``torch.where``), as in the
JAX body, so every rank builds the same graph and runs the same hops
back in its backward.

Every rank keeps the stacked tree whole, as the port keeps every
parameter: rank i computes with slice i, so its gradient for the other
slices is zero. The backward is autograd through the stage function and
the collectives, whose backwards are their adjoints (the hops hop back,
the sum sums): a rank's gradients are those of the SUM of every rank's
loss, the port's convention (``parallel/spmd.py``), and their mean over
the pp ranks is the gradient of one rank's loss.

The tick loop (``gpipe_ticks``) is written once and takes the hop as an
argument: ``pipeline_apply`` holds one stage and hops over the pp group;
with every stage in one process the hop is ``rotate``, a rotation of the
list (the card's virtual stages in ``chip_smoke.py``).

Layout contract (the JAX module's): ``stacked_params`` a pytree whose
leaves have leading dimension S; ``x`` (M, B_micro, ...) microbatches,
the same on every rank; ``stage_fn(params_slice, x_micro) -> y_micro``
one stage, keeping the activation's shape.
"""

from __future__ import annotations

from typing import Callable, List

import torch
import torch.utils._pytree as pytree

from ..base import MXNetError
from ..ndarray import NDArray
from . import collectives as _coll
from . import mesh as _mesh

__all__ = ["pipeline_apply", "stack_stage_params", "gpipe_ticks", "rotate"]


def stack_stage_params(param_trees):
    """Stack S per-stage pytrees of tensors into one tree with a leading
    stage dimension."""
    if not param_trees:
        raise MXNetError("stack_stage_params needs at least one stage")
    return pytree.tree_map(lambda *xs: torch.stack(xs), *param_trees)


def rotate(ys: List) -> List:
    """The hop of stages held in one process: stage n receives stage
    n - 1's activation (the last stage's goes round to stage 0)."""
    return ys[-1:] + ys[:-1]


def gpipe_ticks(stage_fn: Callable, params: List, x, stages: List[int],
                size: int, hop: Callable = rotate) -> List:
    """The GPipe schedule's M + S - 1 ticks over the ``stages`` this
    process holds (each with its parameters in ``params``) of a pipe of
    ``size`` stages; ``x`` (M, B, ...) the microbatches. Each tick, each
    held stage runs on its input (stage 0: microbatch t, the last one
    again once they are spent; the others: what arrived), and after every
    tick but the last ``hop`` moves each held stage's activation to the
    next stage. Returns, for each held stage, the (M, B, ...) outputs of
    ticks S - 1 on, selected where the stage is the last and zero
    elsewhere.

    As in the JAX body, the stage's role is a select on device flags
    (``torch.where``), not Python control flow, so every rank builds the
    same graph: each hop's output reaches the outputs, and the backward
    runs every rank's hops back in the same order."""
    M = x.shape[0]
    ticks = M + size - 1

    def flag(v):
        return torch.full((), bool(v), dtype=torch.bool, device=x.device)

    first = [flag(n == 0) for n in stages]
    last = [flag(n == size - 1) for n in stages]
    cur = [torch.zeros_like(x[0]) for _ in stages]
    outs = [[] for _ in stages]
    for t in range(ticks):
        ys = []
        for j in range(len(stages)):
            y = stage_fn(params[j],
                         torch.where(first[j], x[min(t, M - 1)], cur[j]))
            if t >= size - 1:
                outs[j].append(y)
            ys.append(y)
        if t < ticks - 1:
            cur = hop(ys)
    return [torch.where(last[j], torch.stack(o), torch.zeros_like(o[0]))
            for j, o in enumerate(outs)]


def pipeline_apply(stage_fn: Callable, stacked_params, x, mesh,
                   axis: str = "pp"):
    """Run ``x`` (microbatched (M, B, ...)) through the S stages of the
    ``axis`` of ``mesh``, this rank running stage ``axis_index``. Returns
    the (M, B, ...) outputs, the same on every rank of the axis, and
    differentiable (see the module's docstring for what the gradients
    are). ``x`` may be an ``NDArray`` (an ``NDArray`` comes back)."""
    is_nd = isinstance(x, NDArray)
    xt = x._data if is_nd else x
    S = _mesh.axis_sizes(mesh)[axis]
    M = xt.shape[0]
    if M < S:
        raise MXNetError(
            f"pipeline needs microbatches >= stages ({M} < {S}); more "
            f"microbatches amortize the fill/drain bubble")
    for leaf in pytree.tree_leaves(stacked_params):
        if leaf.shape[0] != S:
            raise MXNetError(
                f"stacked_params leading dim {leaf.shape[0]} != pp mesh "
                f"size {S}: one stage per device (a multiple would be "
                f"silently truncated by the per-device slice)")
    i = _mesh.axis_index(mesh, axis)
    group = _mesh.axis_group(mesh, axis)
    mine = pytree.tree_map(lambda p: p[i], stacked_params)
    out, = gpipe_ticks(stage_fn, [mine], xt, [i], S,
                       hop=lambda ys: [_coll.ppermute(ys[0], group, 1)])
    out = _coll.psum(out, group)
    return NDArray(out) if is_nd else out
