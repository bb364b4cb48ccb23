"""Whole-tree optimizer application, the non-finite guard and gluon's
fused applier: the port of the JAX package's
``incubator_mxnet_tpu/optimizer/fused.py`` (``apply_updates``,
``all_finite``, ``norm_based``, ``hyperparam_signature``,
``FusedApplier``).

``apply_updates`` runs an ``Optimizer``'s functional update over every
trainable parameter with the step count ``t``, the learning rate ``lr``
and (optionally) ``rescale_grad`` as 0-d device tensors: nothing about a
step is staged as a host constant, so ``parallel.SPMDTrainer``'s step
graph replays it with each step's values, as the JAX package's jitted
step takes them as traced scalars. What the optimizer holds on the host
(wd, betas, epsilon, clipping, trust-ratio bounds) is read when the step
is built and baked into its graph. New weights and states keep their old
dtypes. LAMB runs as one multi-tensor pass over every parameter
(``LAMB.update_many``), the other optimizers one parameter at a time;
the functions read nothing back from the device, so they run inside a
CUDA graph capture.

``FusedApplier`` is gluon ``Trainer``'s step. It groups the parameters by
(dtype, gradient storage type) and keys each group's program as the JAX
applier keys its jit (members, state structure, every baked host scalar
of the optimizer, the lr / wd multipliers, the guard's mode) plus the
gradients' dtypes (on which the JAX jit retraces too). A program reads
the weights, the gradient buffers and the optimizer state by address and
takes ``lr``, ``rescale_grad`` and the per-parameter step counts ``t`` as
staged device tensors; it writes the weights and the state in place. On
a CUDA device a program runs eagerly at its first call (a real update)
and is then captured into one CUDA graph, replayed at every later call;
on the CPU it runs eagerly every call. ``trace_count``,
``guard_trace_count`` and ``accum_trace_count`` count the programs built
(captures on the card, first meetings on the CPU), so they equal the JAX
applier's trace counts on the same steps. The guard keeps the JAX
layout: inline in the group's program when there is one group, else one
all-finite program ahead of the groups; the flag is read back once,
after every group is dispatched, and a vetoed step rolls the host update
counters back.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..base import MXNetError, getenv_bool

__all__ = ["apply_updates", "all_finite", "norm_based", "tree_map",
           "tree_leaves", "hyperparam_signature", "FusedApplier"]


def norm_based(optimizer) -> bool:
    """True for optimizers whose update reads a whole-tensor weight /
    update norm (LAMB and LARS trust ratios): correct only over full
    parameter values, never over shards."""
    name = type(optimizer).__name__.lower()
    return any(t in name for t in ("lamb", "lars"))


def all_finite(grad_vals):
    """An f32 0-d tensor on the gradients' device: 1.0 when every entry of
    every floating gradient is finite, else 0.0. The guard reduction the
    trainer selects on."""
    flags = [torch.isfinite(g).all() for g in grad_vals
             if g.is_floating_point()]
    if not flags:
        return torch.ones((), dtype=torch.float32)
    return torch.stack(flags).all().float()


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of equally shaped trees of tuples,
    lists and None (optimizer states)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    """The tensor leaves of a tree of tuples, lists and None, in
    ``tree_map``'s order."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def apply_updates(optimizer, indices, weight_vals, grad_vals, states, t,
                  lr, rescale_grad=None):
    """Functional whole-tree optimizer application.

    ``indices``: the parameters' optimizer indices; ``weight_vals`` /
    ``grad_vals``: tensors aligned to them; ``states``: their optimizer
    states. ``t``: the step count (a 0-d tensor, or a 1-d tensor of one
    count per parameter, as gluon's Trainer passes);
    ``lr``: the base learning rate (the per-parameter multipliers apply
    inside); ``rescale_grad``, when given, replaces
    ``optimizer.rescale_grad`` for this call. One
    ``update_many_multi_precision`` call covers every parameter. Returns
    ``(new_weights, new_states)``, tuples aligned to ``indices``."""
    saved_rescale = optimizer.rescale_grad
    optimizer._traced_lr = lr
    if rescale_grad is not None:
        optimizer.rescale_grad = rescale_grad
    if torch.is_tensor(t) and t.dim() == 1:
        t = {i: t[k] for k, i in enumerate(indices)}
    optimizer._traced_t = t
    try:
        new_w, new_s = optimizer.update_many_multi_precision(
            list(indices), list(weight_vals), list(grad_vals), list(states))
    finally:
        optimizer._traced_t = optimizer._traced_lr = None
        optimizer.rescale_grad = saved_rescale
    return (tuple(nw.to(w.dtype) for nw, w in zip(new_w, weight_vals)),
            tuple(tree_map(lambda old, new: new.to(old.dtype), s, ns)
                  for s, ns in zip(states, new_s)))


def hyperparam_signature(optimizer):
    """Every host scalar of the optimizer a program bakes in (the step
    count, the learning rate and ``rescale_grad`` are staged, not
    baked)."""
    skip = {"num_update", "lr", "rescale_grad", "_traced_t", "_traced_lr"}
    items = [(k, v) for k, v in sorted(vars(optimizer).items())
             if k not in skip and (isinstance(v, (int, float, bool, str))
                                   or v is None)]
    return (type(optimizer).__name__, tuple(items))


def _structure(tree):
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return tuple(_structure(t) for t in tree)
    return "*"


class _Program:
    """One program of the applier: ``body(program)`` over tensors held by
    address. ``bound`` are the tensors it reads that a caller may pass
    anew (gradients): a call with other tensors copies them in first.
    ``inp`` are staged host scalars (one copy to the device). ``pool`` is
    the graph memory pool the applier's captures share. A body takes
    the program as its argument rather than closing over it: a program
    is then freed when dropped, never by the garbage collector."""

    def __init__(self, body, sources, inputs=(), pool=None):
        from ..serve.program import Packed
        self.body = body
        self.pool = pool
        self.bound = list(sources)
        self.device = self.bound[0].device
        self.inp = Packed(inputs, self.device) if inputs else None
        self.graph = None
        self.built = False
        self.replays = 0
        self._staged = torch.cuda.Event() \
            if self.device.type == "cuda" else None

    def run(self, sources, values=None):
        """Stage and run: the body at the first call (then captured on a
        CUDA device), a replay after; the body every call on the CPU.
        Returns True when this call built the program."""
        with torch.no_grad():
            for b, s in zip(self.bound, sources):
                if s is not b:
                    b.copy_(s)
            if self.inp is not None:
                if self._staged is not None:
                    self._staged.synchronize()
                for k, v in values.items():
                    self.inp.host[k][...] = v
                self.inp.dev_bytes.copy_(self.inp.host_bytes,
                                         non_blocking=True)
                if self._staged is not None:
                    self._staged.record()
            if self.built:
                if self.graph is not None:
                    self.graph.replay()
                    self.replays += 1
                else:
                    self.body(self)
                return False
            if self.device.type == "cuda":
                self._capture()
            else:
                self.body(self)
            self.built = True
            return True

    def _capture(self):
        from ..serve.program import GraphCapture
        try:
            cap = GraphCapture(self.device, self.pool)
            cap.eager(lambda: self.body(self))
        except RuntimeError as e:            # MXNetError included
            raise MXNetError(f"fused applier capture failed: {e}") from e
        cap.record(lambda: self.body(self))
        self.graph = cap.graph


class FusedApplier:
    """Gluon Trainer's whole-tree apply: one program per parameter group
    (see the module's docstring)."""

    def __init__(self, optimizer, guard=None):
        self.optimizer = optimizer
        if guard is None:
            guard = getenv_bool("MXTPU_STEP_GUARD", True)
        self.guard = bool(guard)
        self._programs: Dict = {}
        self._guard_programs: Dict = {}
        self._accum_programs: Dict = {}
        self._pool = None
        self._ok = None               # the step's guard flag, on the device
        self.trace_count = 0          # group programs built
        self.call_count = 0           # group programs run
        self.guard_trace_count = 0    # all-finite programs built (inline
        #                               ones counted with their group)
        self.accum_trace_count = 0    # accumulate programs built
        self.skipped_steps = 0        # guard-vetoed apply() calls

    def _flag(self, device):
        if self._ok is None:
            self._ok = torch.ones((), dtype=torch.float32, device=device)
        return self._ok

    def _new(self, body, sources, inputs=()):
        """A program on the sources' device (sharing one graph pool)."""
        if self._pool is None and sources[0].is_cuda:
            self._pool = torch.cuda.graph_pool_handle()
        return _Program(body, sources, inputs, self._pool)

    def grad_all_finite(self, grad_vals: Sequence) -> bool:
        """The all-finite program over every floating gradient, writing
        the flag (False when there is no floating gradient)."""
        vals = [g for g in grad_vals if g.is_floating_point()]
        if not vals:
            return False
        ok = self._flag(vals[0].device)
        sig = tuple((tuple(v.shape), v.dtype) for v in vals)
        prog = self._guard_programs.get(sig)
        if prog is None:
            prog = self._new(lambda p: ok.copy_(all_finite(p.bound)), vals)
            self._guard_programs[sig] = prog
        if prog.run(vals):
            self.guard_trace_count += 1
        return True

    def accumulate(self, acc_vals: Sequence, grad_vals: Sequence):
        """``acc += grad`` in f32 over the whole set, in place; one program
        per (shape, dtype) signature, whatever the accumulation count."""
        sig = tuple((tuple(v.shape), v.dtype) for v in grad_vals)
        prog = self._accum_programs.get(sig)
        n = len(acc_vals)
        if prog is None:
            prog = self._new(lambda p: torch._foreach_add_(
                p.bound[:n], [g.float() for g in p.bound[n:]]),
                list(acc_vals) + list(grad_vals))
            self._accum_programs[sig] = prog
        if prog.run(list(acc_vals) + list(grad_vals)):
            self.accum_trace_count += 1

    def apply(self, items: Sequence, updater,
              extra_grads: Sequence = ()) -> bool:
        """Apply one update to ``items`` = [(index, param, grad NDArray)];
        the optimizer states live in ``updater.states``. Returns True when
        applied, False when the guard skipped the step (weights and state
        bit-identical, host counters rolled back). ``extra_grads`` are
        gradient tensors applied outside this call (the Trainer's
        row_sparse parameters) that join the all-finite verdict: with any
        of them the guard runs as one program ahead of the groups, as the
        JAX applier's does."""
        opt = self.optimizer
        groups: Dict = {}
        for i, p, g in items:
            if i not in updater.states:
                updater.states[i] = opt.create_state_multi_precision(
                    i, p.data()._data.detach())
            gkey = (str(p.data().dtype), getattr(p, "_grad_stype",
                                                 "default"))
            groups.setdefault(gkey, []).append((i, p, g))
        grads = [g._data for _, _, g in items]
        extra = [getattr(g, "_data", g) for g in extra_grads]
        self._flag(grads[0].device)
        inline = self.guard and len(groups) == 1 and not extra
        external = self.guard and not inline and \
            self.grad_all_finite(grads + extra)
        mode = "inline" if inline else "external" if external else "off"
        counts = opt._index_update_count
        prev_counts = dict(counts)
        prev_num_update = opt.num_update
        new_counts = {i: counts.get(i, 0) + 1 for i, _, _ in items}
        counts.update(new_counts)
        opt.num_update = max(counts.values(), default=opt.num_update)
        lr = float(opt.learning_rate)
        rescale = float(opt.rescale_grad)
        for gkey, group in groups.items():
            self._apply_group(gkey, group, updater, lr, rescale, mode)
            counts.update(new_counts)
            opt.num_update = max(counts.values(), default=opt.num_update)
        if mode == "off" or float(self._ok.item()) > 0:
            return True
        counts.clear()
        counts.update(prev_counts)
        opt.num_update = prev_num_update
        self.skipped_steps += 1
        return False

    def _apply_group(self, gkey, group, updater, lr, rescale, mode):
        opt = self.optimizer
        indices = tuple(i for i, _, _ in group)
        states = [updater.states[i] for i in indices]
        grads = [g._data for _, _, g in group]
        mults = tuple((float(getattr(p, "lr_mult", 1.0)),
                       float(getattr(p, "wd_mult", 1.0)))
                      for _, p, _ in group)
        sig = (gkey, indices, _structure(states),
               hyperparam_signature(opt), mults, mode,
               tuple(g.dtype for g in grads))
        prog = self._programs.get(sig)
        if prog is None:
            weights = [p.data()._data.detach() for _, p, _ in group]
            prog = self._new(
                self._group_body(indices, weights, states, mode), grads,
                inputs=(("lr", (), torch.float32),
                        ("rescale", (), torch.float32),
                        ("t", (len(indices),), torch.float32)))
            self._programs[sig] = prog
        t = [opt._index_update_count.get(i, 1) for i in indices]
        if prog.run(grads, {"lr": lr, "rescale": rescale, "t": t}):
            self.trace_count += 1
            # the inline guard is built into the group's program
            self.guard_trace_count += mode == "inline"
        self.call_count += 1

    def _group_body(self, indices, weights, states, mode):
        opt, ok_flag = self.optimizer, self._ok

        def body(prog):
            inp = prog.inp.dev
            new_w, new_states = apply_updates(
                opt, indices, weights, prog.bound, states, inp["t"],
                inp["lr"], rescale_grad=inp["rescale"])
            old_leaves = tree_leaves(states)
            new_leaves = tree_leaves(new_states)
            ok = None
            if mode == "inline":
                ok = all_finite(prog.bound)
                ok_flag.copy_(ok)
            elif mode == "external":
                ok = ok_flag
            if ok is not None:
                keep = ok > 0
                new_w = [torch.where(keep, nw, w)
                         for nw, w in zip(new_w, weights)]
                new_leaves = [torch.where(keep, n, o)
                              for n, o in zip(new_leaves, old_leaves)]
            torch._foreach_copy_(weights, list(new_w))
            if old_leaves:
                torch._foreach_copy_(old_leaves, new_leaves)

        return body
