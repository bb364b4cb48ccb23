"""The pipelined-backward SPMD step: the port of the JAX package's
``incubator_mxnet_tpu/parallel/pipelined.py``.

The step declares the model as stem -> blocks -> head (``PipelineSpec``)
and runs the backward block by block, deepest first: one
``torch.autograd.grad`` a block, from the cotangent of the block after
it. As each pullback completes its parameters' gradients, every gradient
bucket whose members are all complete is reduced, in
``collectives.plan_grad_buckets`` order (``BucketSchedule``), BETWEEN the
block pullbacks, so the reduction of block i+1's gradients can run while
block i's backward computes. On the card each bucket's NCCL call is
issued on a side stream that forks from the step's stream and joins it
again before the guard, and the whole step (forward, the pullbacks, the
bucket collectives, the guarded update) is still ONE CUDA graph per
batch signature (``SPMDTrainer``'s step program): the fork and the join
are captured with the rest.

The step is ``SPMDTrainer``'s own with another forward / backward
(``PipelinedBackward``): the guard reads the post-collective gradients
(under int8: the dequantized ones) and takes their verdict's minimum
over the ranks, a vetoed step is a ``torch.where`` select inside the
graph, the loss scale rides the backward seed, and
``step_microbatches`` folds each microbatch's reduced gradients into the
f32 sums of its ``_AccumState``.

Contract (``tests/test_torch_pipelined.py``):

- **Bitwise the plain step.** ``head`` returns the rank's LOCAL partial
  sums and ``finalize`` turns them into the rank's loss: the expression
  the plain step's loss computes on the rank (global sums through
  ``spmd.split_sum`` where the plain loss takes them, as a weighted mean
  does). As the plain step does, the step averages the ranks' losses and
  gradients, and a tied parameter's two cotangents (the stem's and the
  head's) are added before its bucket is reduced. The JAX ``finalize``
  reads the partials psummed over the batch axes and reduces the tied
  cotangents apart; the port's choice keeps its pipelined and plain
  steps bitwise equal, and both within rounding of the JAX trainer's.
- **Deterministic issue order.** Buckets are issued strictly in plan
  order. ``SPMDTrainer.pipelined_issue_ledger`` records each issue (the
  bucket's key, its members and their shapes, the op, the collective
  calls it made and the backward segments done before it) and
  ``structure_report`` reads it, or the card's profiler timeline of a
  replay (``timeline=``).

Supported meshes: dp and fsdp (tp, sp, pp and ep must be 1). Under fsdp
every rank keeps its parameters whole, as the port's plain step does; a
sharded parameter's gradient is reduce-scattered into its shard (the
psum-then-slice of the JAX body). A forward that writes a module buffer
(BatchNorm's running statistics) raises, and a norm-based optimizer
(LAMB, LARS) is refused under fsdp, both at the first step.
"""

from __future__ import annotations

import re

import torch

from .. import autograd
from ..base import MXNetError
from ..ndarray import NDArray
from . import collectives as _coll
from .collectives import (BucketSchedule, int8_bucket_allreduce,
                          plan_grad_buckets, ring_allreduce_flat)

__all__ = ["PipelineSpec", "build_pipelined_step",
           "build_pipelined_accum_step", "structure_report",
           "ring_allreduce_flat", "PipelinedBackward", "count_of",
           "mean_of"]


def _tensors_of(module):
    """The ``torch.nn.Parameter``s a pipeline entry owns: a gluon block's
    or a ``torch.nn.Module``'s parameters, a bare gluon ``Parameter`` (a
    tied decoder bias hung off the model) or a tensor."""
    if hasattr(module, "collect_params"):
        return [p._var for p in module.collect_params().values()]
    if isinstance(module, torch.nn.Module):
        return list(module.parameters())
    return [getattr(module, "_var", module)]


class PipelineSpec:
    """Declares a model's layer stack as stem -> blocks -> head for the
    pipelined backward (the JAX class's arguments).

    ``blocks``: the pipeline blocks in forward order, each a block
    (called ``blk(x, *ctx)``) or a ``(modules, fn)`` pair (``modules``
    own the entry's parameters, ``fn(x, *ctx)`` runs it); blocks have
    pairwise disjoint parameters. ``head(x, *batch)`` returns the loss's
    LOCAL partial sums (scalars); ``finalize(*partials)`` turns them into
    the rank's loss (see the module's docstring). ``stem(*batch)`` gives
    the first block's input (default: the first batch element);
    ``context(*batch)`` parameter-free values handed to every block (the
    BERT attention mask). ``stem_modules`` / ``head_modules`` own the
    stem's and head's parameters; one in both (a tied embedding) is the
    stem's, and the head's cotangent is added to the stem's."""

    def __init__(self, blocks, head, finalize, stem_modules=(),
                 head_modules=(), stem=None, context=None, name=""):
        self.block_entries = []
        for b in blocks:
            if isinstance(b, tuple):
                mods, fn = b
                self.block_entries.append((list(mods), fn))
            else:
                self.block_entries.append(
                    ([b], (lambda x, *ctx, _b=b: _b(x, *ctx))))
        self.head = head
        self.finalize = finalize
        self.stem_modules = list(stem_modules)
        self.head_modules = list(head_modules)
        self.stem = stem
        self.context = context
        self.name = name or "pipeline"

    def segment_params(self, params, train_idx, names=None):
        """Partition the trainable parameter indices over the segments:
        ``(stem_own, block_own, head_own, tied)``, lists of indices into
        ``params`` (tensors, or gluon ``Parameter``s); ``tied`` are
        head-visible parameters the stem owns. Raises on blocks sharing
        parameters, a tie that is not stem <-> head, and uncovered
        trainables."""
        train_set = set(train_idx)
        by_id = {id(getattr(p, "_var", p)): i for i, p in enumerate(params)}
        if names is None:
            names = [getattr(p, "name", str(i)) for i, p in enumerate(params)]

        def collect(modules):
            seen, out = set(), []
            for m in modules:
                for t in _tensors_of(m):
                    i = by_id.get(id(t))
                    if i is None or i not in train_set or i in seen:
                        continue
                    seen.add(i)
                    out.append(i)
            return sorted(out)

        stem_own = collect(self.stem_modules)
        head_raw = collect(self.head_modules)
        block_own, claimed = [], set(stem_own)
        for bi, (mods, _) in enumerate(self.block_entries):
            mine = collect(mods)
            dup = [i for i in mine if i in claimed and i not in stem_own]
            if dup:
                raise MXNetError(
                    f"pipeline block {bi} shares trainable params "
                    f"{[names[i] for i in dup]} with an earlier "
                    f"block — pipelined blocks must be disjoint")
            shared_stem = [i for i in mine if i in stem_own]
            if shared_stem:
                raise MXNetError(
                    f"pipeline block {bi} shares params "
                    f"{[names[i] for i in shared_stem]} with the "
                    f"stem — tie params only between stem and head")
            own = [i for i in mine if i not in claimed]
            block_own.append(own)
            claimed.update(own)
        tied = [i for i in head_raw if i in claimed]
        bad_tie = [i for i in tied if i not in stem_own]
        if bad_tie:
            raise MXNetError(
                f"head params {[names[i] for i in bad_tie]} are "
                f"owned by a pipeline block — ties are only supported "
                f"between stem and head (the embedding/decoder pattern)")
        head_own = [i for i in head_raw if i not in claimed]
        claimed.update(head_own)
        missing = [names[i] for i in train_idx if i not in claimed]
        if missing:
            raise MXNetError(
                f"pipeline spec does not cover trainable params "
                f"{missing}; add their blocks to stem_modules / blocks "
                f"/ head_modules")
        return stem_own, block_own, head_own, tied


def count_of(x):
    """``x``'s element count as an f32 0-d tensor on its device (a fill,
    no host copy inside a graph capture): a head's count partial."""
    t = _as_tensor(x)
    return NDArray(torch.full((), float(t.numel()), dtype=torch.float32,
                              device=t.device))


def mean_of(total, count):
    """``total / count`` as torch's ``mean`` of the summed values computes
    it on their device, forward and backward: a true division on the CPU,
    a product with the count's f32 reciprocal on CUDA (whose mean reduces
    with that factor and whose backward multiplies by it). A finalize
    that reproduces a plain ``x.mean()`` from the head's partials uses
    it."""
    t, c = _as_tensor(total), _as_tensor(count)
    out = t * torch.reciprocal(c) if t.is_cuda else t / c
    return NDArray(out) if isinstance(total, NDArray) else out


def _pipeline_prereqs(trainer):
    """The JAX rules: a dp / fsdp mesh only, and no norm-based optimizer
    under fsdp (its trust ratio would read a shard's norm). Returns the
    batch axes of size > 1."""
    sizes = trainer._sizes
    for ax in ("tp", "sp", "pp", "ep"):
        if sizes.get(ax, 1) > 1:
            raise MXNetError(
                f"pipelined step supports dp/fsdp meshes only; axis "
                f"{ax!r} has size {sizes[ax]} — use the GSPMD "
                f"step for tensor/sequence/pipeline-parallel models")
    from ..optimizer.fused import norm_based
    if trainer.sharding_mode == "fsdp" and norm_based(trainer._optimizer):
        raise MXNetError(
            f"pipelined fsdp step cannot run norm-based optimizer "
            f"{type(trainer._optimizer).__name__}: the fused update "
            f"would see shard-local norms")
    return tuple(a for a in ("fsdp", "dp") if sizes[a] > 1)


def _as_tensor(x):
    return x._data if isinstance(x, NDArray) else x


def _leaf(t):
    """A block's input as the leaf its pullback differentiates to."""
    return t.detach().requires_grad_(t.requires_grad or t.is_floating_point())


class PipelinedBackward:
    """The pipelined forward / backward of one trainer: called as the
    trainer's ``_forward_backward`` (``(batch, scale) -> (loss, reduced
    gradients aligned with _train_idx)``) inside its step and
    accumulation programs. Built once by ``build_pipelined_step`` /
    ``build_pipelined_accum_step``."""

    def __init__(self, trainer):
        self.raxes = _pipeline_prereqs(trainer)
        self.trainer = trainer
        spec = self.spec = trainer._pipeline
        self.stem_own, self.block_own, self.head_own, self.tied = \
            spec.segment_params(trainer._params, trainer._train_idx,
                                trainer._names)
        remat = trainer._remat_plan
        if remat is not None and len(remat) != len(spec.block_entries):
            raise MXNetError(
                f"remat_plan has {len(remat)} entries for "
                f"{len(spec.block_entries)} pipeline blocks")
        from ..models._remat import resolve_policy
        self.policies = [resolve_policy(e) for e in remat] if remat \
            else [None] * len(spec.block_entries)
        self.slot = {i: k for k, i in enumerate(trainer._train_idx)}
        params = trainer._params
        members = [(i, params[i].numel(), params[i].element_size(),
                    str(params[i].dtype).replace("torch.", ""))
                   for i in trainer._train_idx]
        self.plan = plan_grad_buckets(members, _coll.bucket_limit())
        self.mode = trainer._grad_collective
        self.int8 = bool(trainer._int8_allreduce)
        if self.mode == "ring" and len(self.raxes) > 1:
            raise MXNetError(
                "grad_collective='ring' needs exactly one batch axis "
                f"with size > 1, got {self.raxes}")
        self.ring_group = (trainer._groups.get(self.raxes[0])
                           if self.mode == "ring" and self.raxes else None)
        self.side = torch.cuda.Stream(trainer.device) \
            if trainer.device.type == "cuda" and trainer._collective \
            else None

    # ------------------------------------------------------------------ #
    def _mark_segment(self):
        """On the card, the end of a backward segment on the step's
        stream: a one-thread kernel that spins no cycles (ATen's
        ``spin_kernel``), so a profiled replay's timeline shows where each
        pullback ended (``structure_report``'s card form counts them).
        Nothing on the CPU."""
        if self.trainer.device.type == "cuda":
            torch.cuda._sleep(0)

    def _reduce_bucket(self, bucket, grads):
        """One bucket's collective over the batch axes: the mean over the
        ranks of its members' gradients, written into ``grads`` (slot ->
        tensor; a sharded member comes back as this rank's shard).
        Returns the ledger entry's op and its collective calls."""
        tr = self.trainer
        slots = [self.slot[i] for i in bucket.indices]
        if not tr._collective:
            return "none", 0
        n = tr._replicas
        vals = [grads[k] for k in slots]
        if self.int8 and all(v.is_floating_point() for v in vals):
            red = int8_bucket_allreduce(vals)
            for k, v in zip(slots, red):
                grads[k] = tr._shard_of(k, v.div_(n))
            return "int8_psum", 2
        if self.mode == "ring":
            flat = torch.cat([v.float().reshape(-1) for v in vals])
            red = ring_allreduce_flat(flat, self.ring_group).div_(n)
            for k, v, part in zip(slots, vals,
                                  red.split([v.numel() for v in vals])):
                grads[k] = tr._shard_of(k, part.view(v.shape).to(v.dtype))
            return "ring", 2 * (n - 1)
        dense = [k for k in slots if not tr._shard_plans[k]]
        calls = 0
        if dense:
            flat = torch.cat([grads[k].reshape(-1) for k in dense])
            _coll.all_reduce_mean_(flat)
            for k, part in zip(dense, flat.split(
                    [grads[k].numel() for k in dense])):
                grads[k] = part.view(grads[k].shape)
            calls += 1
        for k in slots:
            if tr._shard_plans[k]:
                grads[k], c = tr._reduce_sharded(k, grads[k])
                calls += c
        return "psum", calls

    def _issue(self, buckets, grads, ledger, segments):
        """Each of ``buckets`` (ready, in plan order) reduced now; on the
        card on the side stream, forked from the step's stream."""
        for b in buckets:
            shapes = [tuple(grads[self.slot[i]].shape) for i in b.indices]
            if self.side is not None:
                main = torch.cuda.current_stream(self.trainer.device)
                self.side.wait_stream(main)
                # the step's stream may not reuse the members' memory
                # before the side stream has read them, nor the side
                # stream the results' before the step has read them
                for i in b.indices:
                    grads[self.slot[i]].record_stream(self.side)
                with torch.cuda.stream(self.side):
                    op, calls = self._reduce_bucket(b, grads)
                for i in b.indices:
                    grads[self.slot[i]].record_stream(main)
            else:
                op, calls = self._reduce_bucket(b, grads)
            params = self.trainer._params
            ledger.append({
                "key": b.key, "op": op, "indices": list(b.indices),
                "shapes": [tuple(params[i].shape) for i in b.indices],
                "issued_shapes": shapes, "calls": calls,
                "segments_done": segments})

    def __call__(self, batch, scale):
        tr, spec = self.trainer, self.spec
        from .spmd import _sync_scope, activation_sharding_scope
        import torch.distributed as dist
        params = tr._params
        was_training = tr.block.training
        tr.block.train()
        if tr._gluon:
            batch = [NDArray(b) for b in batch]
        versions = [b._version for b in tr._buffers]
        sched = BucketSchedule(self.plan)
        grads = [None] * len(tr._train_idx)     # by slot
        ledger = []
        try:
            with torch.enable_grad(), autograd.record(train_mode=True), \
                    _sync_scope(None if not tr._collective else
                                dist.group.WORLD), \
                    activation_sharding_scope(tr.mesh):
                # forward: the stem, each block from a leaf of its own, the
                # head's local partials and the rank's loss
                x0 = _as_tensor(spec.stem(*batch) if spec.stem
                                else batch[0])
                ctx = tuple(spec.context(*batch)) if spec.context else ()
                ctx_nd = [c if c is None or isinstance(c, NDArray)
                          else NDArray(c) for c in ctx]
                from ..models._remat import remat_call
                x, ins, outs = x0, [], []
                for (_, fn), policy in zip(spec.block_entries,
                                           self.policies):
                    xin = _leaf(x)
                    out = remat_call(fn, NDArray(xin), *ctx_nd,
                                     policy=policy) if policy \
                        else fn(NDArray(xin), *ctx_nd)
                    ins.append(xin)
                    outs.append(_as_tensor(out))
                    x = outs[-1]
                xh = _leaf(x)
                parts = spec.head(NDArray(xh), *batch)
                for p in parts:
                    if getattr(_as_tensor(p), "dim", lambda: 0)() != 0:
                        raise MXNetError(
                            f"PipelineSpec.head must return scalar local "
                            f"partial sums; got shape "
                            f"{tuple(_as_tensor(p).shape)}")
                loss = _as_tensor(spec.finalize(*parts))
                if loss.dim() > 0:
                    loss = loss.mean()
                scaled = loss * scale
                for b, v, name in zip(tr._buffers, versions,
                                      tr._buffer_names()):
                    if b._version != v:
                        raise MXNetError(
                            f"pipelined step does not support parameter-"
                            f"mutating forwards (param {name} was "
                            f"reassigned, e.g. BatchNorm running stats); "
                            f"use the GSPMD step for this model")
                # backward, deepest segment first, each bucket reduced as
                # soon as its members are complete
                tied_head = {}
                want = [params[i] for i in self.head_own + self.tied]
                g = torch.autograd.grad(scaled, want + [xh],
                                        allow_unused=True)
                self._mark_segment()
                g_x = g[-1]
                for i, gi in zip(self.head_own + self.tied, g[:-1]):
                    gi = torch.zeros_like(params[i]) if gi is None else gi
                    if i in self.tied:
                        tied_head[i] = gi
                    else:
                        grads[self.slot[i]] = gi
                        self._issue(sched.mark_ready(i), grads, ledger, 1)
                done = 1
                for bi in range(len(spec.block_entries) - 1, -1, -1):
                    own = [params[i] for i in self.block_own[bi]]
                    wrt = own + ([ins[bi]] if ins[bi].requires_grad
                                 else [])
                    g = torch.autograd.grad(outs[bi], wrt, grad_outputs=g_x,
                                            allow_unused=True)
                    g_x = g[-1] if len(wrt) > len(own) else None
                    self._mark_segment()
                    done += 1
                    for i, gi in zip(self.block_own[bi], g[:len(own)]):
                        grads[self.slot[i]] = torch.zeros_like(params[i]) \
                            if gi is None else gi
                        self._issue(sched.mark_ready(i), grads, ledger,
                                    done)
                own = [params[i] for i in self.stem_own]
                if own:
                    g = torch.autograd.grad(x0, own, grad_outputs=g_x,
                                            allow_unused=True) \
                        if x0.requires_grad and g_x is not None \
                        else [None] * len(own)
                else:
                    g = []
                self._mark_segment()
                done += 1
                for i, gi in zip(self.stem_own, g):
                    gi = torch.zeros_like(params[i]) if gi is None else gi
                    if i in tied_head:      # the stem's and the head's
                        gi = tied_head[i] + gi
                    grads[self.slot[i]] = gi
                    self._issue(sched.mark_ready(i), grads, ledger, done)
                self._issue(sched.drain(), grads, ledger, done)
        finally:
            tr.block.train(was_training)
        if len(sched.issued) != len(self.plan):  # pragma: no cover
            raise MXNetError("pipelined bucket schedule did not drain")
        if self.side is not None:
            torch.cuda.current_stream(tr.device).wait_stream(self.side)
        tr.pipelined_issue_ledger = ledger
        tr.pipelined_bucket_order = [e["key"] for e in ledger]
        loss = scaled.detach() / scale
        if tr._collective:
            _coll.all_reduce_mean_(loss)
        return loss, grads


def build_pipelined_step(trainer, n_batch=None):
    """The pipelined forward / backward of ``trainer``'s step and
    accumulation programs (checked against the pipelined step's rules at
    the first step, as the JAX function checks them at its first trace;
    under ``step_microbatches`` each microbatch's reduced gradients are
    added into the f32 sums of the trainer's ``_AccumState``). ``n_batch``
    is the JAX function's argument, unused: one object serves every batch
    signature."""
    return PipelinedBackward(trainer)


# the JAX package's two builders are one here
build_pipelined_accum_step = build_pipelined_step


# ----------------------------------------------------------------------- #
# the structure of an issue: from the ledger, or a replay's timeline
# ----------------------------------------------------------------------- #
# kernel names on the card's timeline: NCCL's (a one-rank reduction runs
# its onerank kernel), and the step's mark at the end of each backward
# segment (PipelinedBackward._mark_segment)
_COLLECTIVE_KERNEL = re.compile(r"nccl|onerank", re.I)
_SEGMENT_MARK = re.compile(r"spin_kernel")


def structure_report(ledger, timeline=None):
    """Assertable facts about one pipelined step's bucket collectives.

    ``ledger`` is ``SPMDTrainer.pipelined_issue_ledger``. Without a
    ``timeline`` (the CPU) the facts come from the ledger, the record of
    each collective issue as the step made it:

    - ``n_buckets`` / ``n_grad_collective_groups``: the buckets issued,
      and the groups of issues with no backward segment between them;
    - ``order_matches_plan``: the buckets came in plan order (their
      ``plan_grad_buckets`` keys, each once) with the members' shapes
      handed to the collective equal to the parameters';
    - ``interleaved``: a backward pullback ran between the first bucket's
      issue and the last's (``n_backward_segments_between`` counts them).

    ``timeline`` is the kernel names of one profiled replay of the step
    on the card, in start order. The step marks the end of each backward
    segment there (``PipelinedBackward._mark_segment``), and the first
    ``sum(calls)`` NCCL kernels are the buckets' (the loss and guard
    reductions follow the drain). ``order_matches_plan`` then also needs
    as many of them as the ledger's calls and, before each bucket's first
    kernel, as many segment marks as the segments its issue followed;
    groups and ``interleaved`` count the marks between bucket kernels
    instead of the ledger's segments."""
    issued = [e for e in ledger if e.get("op") != "none"]
    keys = [e["key"] for e in ledger]
    order_ok = len(set(keys)) == len(keys) and all(
        e["shapes"] == e["issued_shapes"] for e in ledger)
    ring = any(e.get("op") == "ring" for e in ledger)
    out = {"collective_op": "collective_permute" if ring else "all_reduce",
           "n_buckets": len(ledger)}
    if timeline is None:
        segs = [e["segments_done"] for e in issued]
        groups = sum(1 for j, s in enumerate(segs) if j == 0
                     or s != segs[j - 1])
        between = (segs[-1] - segs[0]) if segs else 0
        out.update(n_grad_collective_groups=groups,
                   order_matches_plan=bool(order_ok),
                   interleaved=between > 0,
                   n_backward_segments_between=between)
        return out
    names = list(timeline)
    colls = [j for j, n in enumerate(names) if _COLLECTIVE_KERNEL.search(n)]
    n_calls = sum(e["calls"] for e in issued)
    mine = colls[:n_calls]
    marks = [j for j, n in enumerate(names) if _SEGMENT_MARK.search(n)]
    first_of, j = [], 0
    for e in issued:
        if e["calls"]:
            first_of.append((e, mine[j] if j < len(mine) else None))
        j += e["calls"]
    order_ok = order_ok and len(mine) == n_calls and all(
        pos is not None and sum(1 for m in marks if m < pos)
        >= e["segments_done"] for e, pos in first_of)
    groups = sum(1 for k, pos in enumerate(mine) if k == 0 or any(
        mine[k - 1] < m < pos for m in marks))
    between = sum(1 for m in marks if mine and mine[0] < m < mine[-1])
    out.update(n_grad_collective_groups=groups,
               order_matches_plan=bool(order_ok), interleaved=between > 0,
               n_backward_segments_between=between,
               n_segment_marks=len(marks))
    return out
