"""Graph execution for the symbolic front end: the port of the JAX
package's ``incubator_mxnet_tpu/symbol/executor.py``.

``evaluate`` is the imperative interpreter: it walks the DAG through
``imperative_invoke``, so ``autograd.record()`` sees every op (what
``SymbolBlock`` and ``Symbol.eval`` run). ``infer_shapes`` /
``infer_types`` propagate shapes and dtypes to a fixpoint, each op run on
``meta`` tensors (the host on zeros for an op ``meta`` cannot run), and
the parameters' shapes filled from the data's by the per-op rules. A
variable's ``__shape__`` is a shape, or the string a file holds (this
repo's ``"[64, 3, 7, 7]"``, MXNet 1.x's ``"(64, 3, 7, 7)"``); its
``__dtype__`` a name or MXNet's type code.

``Executor`` is the bound program of ``simple_bind`` and ``Module``. Its
programs are keyed as the JAX executor's jits are: ``False`` (inference),
``True`` (the training forward alone) and ``("train", diff_names,
seed_ones)`` (forward and backward in one program), and under each key
there is one program per signature (the shapes and dtypes of the
arguments, the auxiliary states and the explicit head gradients), as
many as the JAX jit traces for the same calls. On a CUDA device a
signature's first call runs its body eagerly on PyTorch's capture stream
(a real call: its outputs, gradients and running statistics are the
call's), then captures the body into one CUDA graph (``mx.random``'s
generator registered with it when the graph draws, so each replay draws
fresh masks); every later call is one ``replay()``. A capture that fails
raises ``MXNetError`` (an op that reads the device from the host, such
as ``boolean_mask``, names itself in it); nothing runs the body eagerly
in a graph's place. On the CPU the body runs eagerly every call and the
signatures are counted the same way (``signature_counts()``).

A graph holds the bound arrays by address: ``arg_dict``, ``aux_dict``
and ``grad_dict`` are its inputs and outputs. ``forward(**kwargs)``,
``copy_params_from``, ``Module.set_params`` and ``init_params`` write
into them with ``copy_``; a value of another shape or dtype re-binds the
entry (a new signature, as the JAX executor retraces). A tensor put in
an entry behind the executor's back is copied into the graph's before a
replay. The outputs handed out are copies: a later replay does not
change them.

Training is lazy, as in the JAX executor: ``forward(is_train=True)``
saves the auxiliary states (and the generator's state) and defers the
work to ``backward``, which runs the fused program. Reading ``outputs``
first runs the training forward alone; ``backward`` then recomputes from
the saved values, so the running statistics end a step with one update
either way, and the masks are the same.
"""

from __future__ import annotations

import ast
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import random as _random
from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray import NDArray
from ..ndarray.ndarray import from_host, to_torch_dtype
from ..ndarray.register import imperative_invoke
from ..ops import registry as _registry
from .symbol import Symbol, _topo

__all__ = ["evaluate", "Executor", "infer_shapes", "infer_types"]

# MXNet's type codes (mshadow's TypeFlag), as a 1.x file's __dtype__
_MX_TYPE_CODES = {0: "float32", 1: "float64", 2: "float16", 3: "uint8",
                  4: "int32", 5: "int8", 6: "int64", 7: "bool",
                  12: "bfloat16"}


def _node_kwargs(node) -> dict:
    return {k: v for k, v in node.attrs.items() if not k.startswith("__")}


def _var_shape(value) -> Optional[tuple]:
    """A variable's ``__shape__`` as a tuple: a list or tuple as given, a
    string parsed; None when absent or when a dimension is unknown (0)."""
    if value is None:
        return None
    if isinstance(value, str):
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            raise MXNetError(f"unreadable __shape__ {value!r}") from None
    if isinstance(value, int):
        value = (value,)
    shape = tuple(int(d) for d in value)
    return None if any(d <= 0 for d in shape) else shape


def _var_dtype(value) -> torch.dtype:
    """A variable's ``__dtype__`` (a name, or MXNet's type code)."""
    if value is None:
        return torch.float32
    if isinstance(value, int) or (isinstance(value, str) and
                                  value.isdigit()):
        value = _MX_TYPE_CODES[int(value)]
    return to_torch_dtype(value)


def evaluate(sym: Symbol, bindings: Dict[str, NDArray], training=None):
    """The graph run imperatively over ``NDArray``s (recorded under
    ``autograd.record()``); one output an ``NDArray``, several a list."""
    from ..ndarray import array
    vals: Dict[int, tuple] = {}
    for node in _topo(sym._heads):
        if node.is_variable:
            if node.name not in bindings:
                raise MXNetError(
                    f"symbol input {node.name!r} is not bound; provided: "
                    f"{sorted(bindings)}")
            v = bindings[node.name]
            vals[id(node)] = (v if isinstance(v, NDArray) else array(v),)
            continue
        spec = _registry.get(node.op)
        ins = [vals[id(src)][idx] for src, idx in node.inputs]
        kwargs = _node_kwargs(node)
        if spec.training_aware and training is not None:
            kwargs.setdefault("training", training)
        out = imperative_invoke(spec, *ins, **kwargs)
        vals[id(node)] = tuple(out) if isinstance(out, (list, tuple)) \
            else (out,)
    outs = [vals[id(n)][i] for n, i in sym._heads]
    return outs if len(outs) > 1 else outs[0]


def _interpret(sym: Symbol, vals: Dict[str, torch.Tensor], training: bool,
               generator):
    """The graph over tensors: ``(heads, {aux name: updated value})``.
    Training folds each BatchNorm's batch statistics into its auxiliary
    running statistics (the JAX interpreter's functional update)."""
    heads_of: Dict[int, tuple] = {}
    aux_updates: Dict[str, torch.Tensor] = {}
    for node in _topo(sym._heads):
        if node.is_variable:
            heads_of[id(node)] = (vals[node.name],)
            continue
        spec = _registry.get(node.op)
        ins = [heads_of[id(src)][idx] for src, idx in node.inputs]
        kwargs = _node_kwargs(node)
        if spec.training_aware:
            kwargs.setdefault("training", training)
        if spec.needs_key:
            kwargs["generator"] = generator
        try:
            out = spec.fn(*ins, **kwargs)
        except MXNetError:
            raise
        except (TypeError, ValueError, IndexError, RuntimeError) as e:
            raise MXNetError(f"symbol node {node.name!r} (op {node.op}) "
                             f"failed: {e}") from e
        out = tuple(out) if isinstance(out, (list, tuple)) else (out,)
        heads_of[id(node)] = out
        if node.op == "BatchNorm" and training:
            momentum = float(node.attrs.get("momentum", 0.9))
            for pos, stat in ((3, out[1]), (4, out[2])):
                src, _ = node.inputs[pos]
                if src.is_variable and src.attrs.get("__aux__"):
                    aux_updates[src.name] = (
                        momentum * heads_of[id(src)][0]
                        + (1 - momentum) * stat.detach())
    heads = [heads_of[id(n)][i] for n, i in sym._heads]
    return heads, aux_updates


def _graph_needs_key(sym: Symbol) -> bool:
    return any(not n.is_variable and _registry.get(n.op).needs_key
               for n in _topo(sym._heads))


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


# The parameters' shapes from the data input's shape and the node's
# attributes ({input position: shape}): the inverse half of MXNet's per-op
# shape functions; the forward half runs the op on meta tensors.
def _rule_fc(din, attrs):
    nh = int(attrs["num_hidden"])
    in_units = _prod(din[1:]) if attrs.get("flatten", True) else din[-1]
    return {1: (nh, in_units), 2: (nh,)}


def _rule_conv(din, attrs):
    nf, ng = int(attrs["num_filter"]), int(attrs.get("num_group", 1))
    return {1: (nf, din[1] // ng) + tuple(attrs["kernel"]), 2: (nf,)}


def _rule_deconv(din, attrs):
    nf, ng = int(attrs["num_filter"]), int(attrs.get("num_group", 1))
    return {1: (din[1], nf // ng) + tuple(attrs["kernel"]), 2: (nf,)}


def _rule_bn(din, attrs):
    c = (din[int(attrs.get("axis", 1)) % len(din)],)
    return {1: c, 2: c, 3: c, 4: c}


def _rule_ln(din, attrs):
    c = (din[int(attrs.get("axis", -1)) % len(din)],)
    return {1: c, 2: c}


def _rule_embedding(din, attrs):
    return {1: (int(attrs["input_dim"]), int(attrs["output_dim"]))}


_PARAM_SHAPE_RULES = {
    "FullyConnected": _rule_fc,
    "Convolution": _rule_conv,
    "Deconvolution": _rule_deconv,
    "BatchNorm": _rule_bn,
    "LayerNorm": _rule_ln,
    "InstanceNorm": _rule_ln,
    "Embedding": _rule_embedding,
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _node_eval_shape(node, ins: List[torch.Tensor],
                     types_only: bool = False) -> tuple:
    """The node's outputs as meta tensors: the op on meta inputs, or, for
    an op ``meta`` cannot run, on zeros on the host. ``types_only``
    (type inference over placeholder shapes): an op that refuses the
    placeholders gives its inputs' promoted dtype."""
    if types_only:
        try:
            return _node_eval_shape(node, ins)
        except MXNetError:
            dt = ins[0].dtype if ins else torch.float32
            for t in ins[1:]:
                dt = torch.promote_types(dt, t.dtype)
            return tuple(_meta((1,), dt) for _ in range(node.num_outputs()))
    spec = _registry.get(node.op)
    kwargs = _node_kwargs(node)
    if spec.training_aware:
        kwargs["training"] = False
    try:
        out = spec.fn(*ins, **kwargs)
    except MXNetError:
        raise
    except Exception:
        try:
            out = spec.fn(*[torch.zeros(t.shape, dtype=t.dtype)
                            for t in ins], **kwargs)
        except MXNetError:
            raise
        except Exception as e:
            raise MXNetError(f"shape inference: node {node.name!r} (op "
                             f"{node.op}) failed: {e}") from e
    out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    return tuple(_meta(o.shape, o.dtype) for o in out)


class _Underdetermined(MXNetError):
    """Shape inference could not reach every variable."""


def _propagate(sym: Symbol, known: Dict[str, tuple],
               dtypes: Optional[Dict[str, Any]] = None,
               types_only: bool = False):
    """Shapes and dtypes to a fixpoint over the DAG: ``({variable: meta
    tensor}, [head meta tensors])``; ``_Underdetermined`` names the
    variables left unknown."""
    dtypes = dtypes or {}
    nodes = _topo(sym._heads)
    var_shape: Dict[str, tuple] = {k: tuple(v) for k, v in known.items()}
    structs: Dict[tuple, torch.Tensor] = {}

    def var_struct(node):
        s = var_shape.get(node.name)
        if s is None:
            s = _var_shape(node.attrs.get("__shape__"))
        if s is None:
            return None
        dt = dtypes.get(node.name)
        dt = to_torch_dtype(dt) if dt is not None else \
            _var_dtype(node.attrs.get("__dtype__"))
        return _meta(s, dt)

    changed = True
    while changed:
        changed = False
        for node in nodes:
            if (id(node), 0) in structs:
                continue
            if node.is_variable:
                st = var_struct(node)
                if st is not None:
                    structs[(id(node), 0)] = st
                    changed = True
                continue
            in_keys = [(id(src), i) for src, i in node.inputs]
            if all(k in structs for k in in_keys):
                outs = _node_eval_shape(node, [structs[k] for k in in_keys],
                                        types_only)
                for i, o in enumerate(outs):
                    structs[(id(node), i)] = o
                changed = True
                continue
            rule = _PARAM_SHAPE_RULES.get(node.op)
            data_key = (id(node.inputs[0][0]), node.inputs[0][1]) \
                if node.inputs else None
            if rule and data_key in structs:
                din = tuple(structs[data_key].shape)
                for pos, shape in rule(din, node.attrs).items():
                    if pos >= len(node.inputs):
                        continue
                    src, _ = node.inputs[pos]
                    if src.is_variable and src.name not in var_shape and \
                            _var_shape(src.attrs.get("__shape__")) is None:
                        var_shape[src.name] = tuple(shape)
                        changed = True

    missing = [n.name for n in nodes
               if n.is_variable and (id(n), 0) not in structs]
    if missing:
        raise _Underdetermined(
            f"shape inference under-determined for {missing}")
    var_structs = {n.name: structs[(id(n), 0)]
                   for n in nodes if n.is_variable}
    return var_structs, [structs[(id(n), i)] for n, i in sym._heads]


def infer_shapes(sym: Symbol, known: Dict[str, tuple],
                 dtypes: Optional[Dict[str, Any]] = None) -> dict:
    """``{"args": {variable: shape}, "outs": [shape]}`` from partial
    shapes."""
    var_structs, heads = _propagate(sym, known, dtypes)
    return {"args": {n: tuple(s.shape) for n, s in var_structs.items()},
            "outs": [tuple(o.shape) for o in heads]}


def infer_types(sym: Symbol, known: Dict[str, Any]) -> dict:
    """``{"args": {variable: dtype name}, "outs": [dtype name]}``."""
    shapes = {n.name: _var_shape(n.attrs.get("__shape__")) or (1,)
              for n in _topo(sym._heads) if n.is_variable}
    var_structs, heads = _propagate(sym, shapes, dtypes=known,
                                    types_only=True)

    def name(t):
        return str(t.dtype).replace("torch.", "")
    return {"args": {n: name(s) for n, s in var_structs.items()},
            "outs": [name(o) for o in heads]}


def _as_req_map(grad_req, arg_names: Sequence[str]) -> Dict[str, str]:
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    if isinstance(grad_req, dict):
        return {n: grad_req.get(n, "null") for n in arg_names}
    raise MXNetError(f"bad grad_req {grad_req!r}")


def _as_tensor(val) -> torch.Tensor:
    if isinstance(val, NDArray):
        return val._data.detach()
    if torch.is_tensor(val):
        return val.detach()
    a = np.asarray(val)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return from_host(a)


class _LazyOutputs:
    """``forward(is_train=True)``'s return: reading it runs the training
    forward (a step that goes straight to ``backward`` never does)."""

    __slots__ = ("_exe",)

    def __init__(self, exe):
        self._exe = exe

    def __iter__(self):
        return iter(self._exe.outputs)

    def __len__(self):
        return len(self._exe.outputs)

    def __getitem__(self, i):
        return self._exe.outputs[i]

    def __repr__(self):
        return repr(self._exe.outputs)


class _Program:
    """One signature under one key: on a CUDA device its graph, the head
    tensors the graph writes, the bound entries it holds by address
    (``held``: (dict, key, tensor)), the launches its capture counted,
    its replays, and the eager first call's and the capture's ms."""

    __slots__ = ("graph", "outs", "held", "launches", "replays",
                 "first_ms", "capture_ms")

    def __init__(self):
        self.graph = None
        self.outs: List[torch.Tensor] = []
        self.held: list = []
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self.first_ms: Optional[float] = None
        self.capture_ms: Optional[float] = None


class Executor:
    """A bound symbolic program (parity: ``mx.executor.Executor``); see
    the module's docstring."""

    def __init__(self, symbol: Symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None):
        self._symbol = symbol
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        ctx = ctx if ctx is not None else current_context()
        self._ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        self._device = self._ctx.torch_device
        self.arg_dict: Dict[str, NDArray] = self._to_dict(
            args, self._arg_names, "args")
        self.aux_dict: Dict[str, NDArray] = self._to_dict(
            aux_states, self._aux_names, "aux_states")
        self._req = _as_req_map(grad_req, self._arg_names)
        grad_names = [n for n in self._arg_names
                      if self._req.get(n, "null") != "null"]
        if args_grad is None:
            args_grad = {n: NDArray(torch.zeros_like(
                self.arg_dict[n]._data.detach())) for n in grad_names
                if n in self.arg_dict}
        self.grad_dict: Dict[str, NDArray] = self._to_dict(
            args_grad, grad_names, "args_grad")
        self._outputs: Optional[List[NDArray]] = []
        self._pending = None
        self._aux_in: Dict[str, NDArray] = {}    # aux saved at forward
        self._cot_in: Dict[int, NDArray] = {}    # explicit head gradients
        self._spares: Dict[tuple, torch.Tensor] = {}
        self._pinned: Dict[tuple, tuple] = {}    # host -> card staging
        self._programs: Dict[Any, Dict[tuple, _Program]] = {}
        self._pool = None
        self._needs_key = _graph_needs_key(symbol)

    def _to_dict(self, vals, names, what) -> Dict[str, NDArray]:
        if vals is None:
            return {}
        if isinstance(vals, dict):
            items = list(vals.items())
        elif isinstance(vals, (list, tuple)):
            if len(vals) != len(names):
                raise MXNetError(
                    f"{what}: expected {len(names)} entries ({names}), "
                    f"got {len(vals)}")
            items = list(zip(names, vals))
        else:
            raise MXNetError(f"{what} must be list or dict")
        out = {}
        for name, v in items:
            if isinstance(v, NDArray) and v._data.device == self._device:
                out[name] = v          # shared by reference
            else:
                out[name] = NDArray(_as_tensor(v).to(self._device,
                                                     copy=True))
        return out

    @classmethod
    def simple_bind(cls, symbol: Symbol, ctx=None, grad_req="write",
                    **shapes):
        """Zeroed argument, gradient and auxiliary arrays of the inferred
        shapes (parity: ``sym.simple_bind``)."""
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        if arg_shapes is None:
            raise MXNetError(
                "simple_bind: could not infer all shapes; provide shapes "
                f"for {symbol.list_arguments()}")
        ctx = ctx if ctx is not None else current_context()
        ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        dev = ctx.torch_device
        args = [NDArray(torch.zeros(s, dtype=torch.float32, device=dev))
                for s in arg_shapes]
        aux = [NDArray(torch.zeros(s, dtype=torch.float32, device=dev))
               for s in aux_shapes]
        return cls(symbol, ctx, args, None, grad_req, aux)

    # ------------------------------------------------------------------ #
    # binding
    # ------------------------------------------------------------------ #
    def _copy_in(self, tag, dst: torch.Tensor, src: torch.Tensor):
        """``src`` into ``dst``; a host value bound for the card crosses
        through a pinned buffer of the entry's, so the copy does not hold
        the host (the buffer is refilled once its last copy ran)."""
        with torch.no_grad():
            if not (dst.is_cuda and src.device.type == "cpu"):
                dst.copy_(src)
                return
            key = tag + (tuple(src.shape), src.dtype)
            staged = self._pinned.get(key)
            if staged is None:
                staged = self._pinned[key] = (
                    torch.empty(src.shape, dtype=src.dtype,
                                pin_memory=True), torch.cuda.Event())
            else:
                staged[1].synchronize()
            staged[0].copy_(src)
            dst.copy_(staged[0], non_blocking=True)
            staged[1].record()

    def _bind_value(self, d: dict, name, val):
        """``val`` into entry ``name`` of ``d``: by ``copy_`` into the
        bound tensor; a value of another shape or dtype re-binds the entry
        (to a tensor kept from an earlier binding of that shape and dtype
        when there is one)."""
        src = _as_tensor(val)
        cur = d.get(name)
        tag = (id(d), name)
        if cur is not None and cur._data.shape == src.shape and \
                cur._data.dtype == src.dtype:
            self._copy_in(tag, cur._data, src)
            return
        if cur is not None:
            self._spares[tag + (tuple(cur._data.shape),
                                cur._data.dtype)] = cur._data
        dst = self._spares.pop(tag + (tuple(src.shape), src.dtype), None)
        if dst is None:
            dst = torch.empty(src.shape, dtype=src.dtype,
                              device=self._device)
        self._copy_in(tag, dst, src)
        if cur is None:
            d[name] = NDArray(dst)
        else:
            cur._data = dst

    def _stage_aux(self):
        """The auxiliary states saved for the training programs (one
        batched copy on the device)."""
        dsts, srcs = [], []
        for n in self._aux_names:
            src = self.aux_dict[n]._data.detach()
            box = self._aux_in.get(n)
            if box is None or box._data.shape != src.shape or \
                    box._data.dtype != src.dtype:
                box = self._aux_in[n] = NDArray(torch.empty_like(src))
            dsts.append(box._data)
            srcs.append(src)
        if dsts:
            torch._foreach_copy_(dsts, srcs)

    def _ensure_grads(self, diff_names):
        for n in diff_names:
            arg = self.arg_dict[n]._data
            g = self.grad_dict.get(n)
            if g is None:
                self.grad_dict[n] = NDArray(torch.zeros_like(arg.detach()))
            elif g._data.shape != arg.shape or g._data.dtype != arg.dtype:
                g._data = torch.zeros_like(arg.detach())

    def _gen_state(self):
        if not self._needs_key:
            return None
        return _random.generator(self._device).get_state()

    def _restore_gen(self, state):
        if state is not None:
            _random.generator(self._device).set_state(state)

    # ------------------------------------------------------------------ #
    # programs
    # ------------------------------------------------------------------ #
    def _signature(self, key) -> tuple:
        ts = [self.arg_dict[n]._data for n in self._arg_names]
        ts += [self.aux_dict[n]._data for n in self._aux_names]
        if isinstance(key, tuple) and not key[2]:
            ts += [self._cot_in[i]._data
                   for i in range(len(self._symbol._heads))]
        return tuple((tuple(t.shape), t.dtype) for t in ts)

    def _body(self, key, held: Optional[list] = None) -> List[torch.Tensor]:
        """One call of the program ``key`` over the bound entries; returns
        the heads. With ``held``, records each entry it reads or writes
        (the capture)."""
        def entry(d, name):
            t = d[name]._data
            if held is not None:
                held.append((d, name, t))
            return t

        vals = {n: entry(self.arg_dict, n).detach() for n in self._arg_names}
        aux_src = self.aux_dict if key is False else self._aux_in
        vals.update({n: entry(aux_src, n).detach() for n in self._aux_names})
        gen = _random.generator(self._device) if self._needs_key else None
        if not isinstance(key, tuple):
            with torch.no_grad():
                heads, aux_up = _interpret(self._symbol, vals, bool(key), gen)
                for n, v in aux_up.items():
                    entry(self.aux_dict, n).copy_(v)
            return heads
        _, diff_names, seed_ones = key
        diff = [vals[n].requires_grad_() for n in diff_names]
        with torch.enable_grad():
            heads, aux_up = _interpret(self._symbol, vals, True, gen)
            seeds = [torch.ones_like(h) for h in heads] if seed_ones else \
                [entry(self._cot_in, i) for i in range(len(heads))]
            pairs = [(h, s) for h, s in zip(heads, seeds) if h.requires_grad]
            grads = torch.autograd.grad(
                [h for h, _ in pairs], diff,
                grad_outputs=[s for _, s in pairs], allow_unused=True) \
                if pairs else [None] * len(diff)
        with torch.no_grad():
            for n, v in aux_up.items():
                entry(self.aux_dict, n).copy_(v)
            for n, g in zip(diff_names, grads):
                dst = entry(self.grad_dict, n)
                if self._req[n] == "add":
                    if g is not None:
                        dst.add_(g)
                elif g is None:
                    dst.zero_()
                else:
                    dst.copy_(g)
        return [h.detach() for h in heads]

    def _run(self, key) -> List[NDArray]:
        """The program ``key`` at the current signature: on the card a
        replay of its graph, built at the signature's first call."""
        if isinstance(key, tuple):
            self._ensure_grads(key[1])
        sig = self._signature(key)
        progs = self._programs.setdefault(key, {})
        prog = progs.get(sig)
        if self._device.type != "cuda":
            if prog is None:
                progs[sig] = _Program()
            return [NDArray(h) for h in self._body(key)]
        if prog is None:
            return self._build(key, sig, progs)
        from ..serve.program import add_launches
        with torch.no_grad():
            for d, name, t in prog.held:
                cur = d[name]
                if cur._data is not t:    # put there behind our back
                    t.copy_(cur._data)
                    cur._data = t
        prog.graph.replay()
        prog.replays += 1
        add_launches(prog.launches)
        return [NDArray(t.clone()) for t in prog.outs]

    def _build(self, key, sig, progs) -> List[NDArray]:
        from ..serve.program import GraphCapture
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        gens = [_random.generator(self._device)] if self._needs_key else []
        cap = GraphCapture(self._device, self._pool, gens)
        prog, box = _Program(), {}
        t0 = time.perf_counter()
        cap.eager(lambda: box.__setitem__("first", self._body(key)))
        prog.first_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()

        def record():
            try:
                box["outs"] = self._body(key, prog.held)
            except MXNetError as e:      # the op that broke the capture
                box["error"] = e
                raise
        try:
            prog.launches = cap.record(record)
        except MXNetError as e:
            if "error" in box:
                raise MXNetError(f"program capture failed: "
                                 f"{box['error']}") from e
            raise
        prog.capture_ms = (time.perf_counter() - t0) * 1e3
        prog.graph, prog.outs = cap.graph, box["outs"]
        progs[sig] = prog
        return [NDArray(h) for h in box["first"]]

    def signature_counts(self) -> Dict[Any, int]:
        """Signatures under each key (the JAX jits' ``_cache_size()``)."""
        return {k: len(v) for k, v in self._programs.items()}

    # ------------------------------------------------------------------ #
    # execution
    # ------------------------------------------------------------------ #
    def forward(self, is_train: bool = False, **kwargs):
        """Bind ``kwargs`` and run (parity: ``Executor.forward``); with
        ``is_train`` and something to differentiate, the work waits for
        ``backward`` (or a read of ``outputs``)."""
        if self._pending is not None and self._outputs is None:
            _ = self.outputs     # an unconsumed training forward lands
        for name, val in kwargs.items():
            d = self.arg_dict if (name in self.arg_dict or
                                  name not in self.aux_dict) \
                else self.aux_dict
            self._bind_value(d, name, val)
        missing = [n for n in self._arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError(f"executor: unbound arguments {missing}")
        diff_names = tuple(n for n in self._arg_names
                           if self._req.get(n, "null") != "null")
        if is_train:
            self._stage_aux()
            gen_state = self._gen_state()
            if diff_names:
                self._pending = (diff_names, gen_state)
                self._outputs = None
                return _LazyOutputs(self)
        self._pending = None
        self._outputs = self._run(bool(is_train))
        return self._outputs

    @property
    def outputs(self) -> List[NDArray]:
        """The outputs; under a pending training step this runs the
        training forward alone (``backward`` recomputes it fused with the
        backward)."""
        if self._outputs is None and self._pending is not None:
            self._restore_gen(self._pending[1])
            self._outputs = self._run(True)
        return self._outputs if self._outputs is not None else []

    def backward(self, out_grads=None):
        """The pending step's forward and backward in one program;
        gradients land in ``grad_dict`` per ``grad_req`` (write, add,
        null)."""
        if self._pending is None:
            if not any(self._req.get(n, "null") != "null"
                       for n in self._arg_names):
                return self.grad_dict
            raise MXNetError("backward called before forward(is_train=True)")
        diff_names, gen_state = self._pending
        seed_ones = out_grads is None
        if seed_ones:
            if len(self._symbol.list_outputs()) != 1:
                raise MXNetError("multi-output executor needs explicit "
                                 "out_grads")
        else:
            if isinstance(out_grads, NDArray) or torch.is_tensor(out_grads):
                out_grads = [out_grads]
            for i, g in enumerate(out_grads):
                self._bind_value(self._cot_in, i, g)
        self._restore_gen(gen_state)
        self._outputs = self._run(("train", diff_names, seed_ones))
        self._pending = None
        return self.grad_dict

    # ------------------------------------------------------------------ #
    @property
    def arg_arrays(self) -> List[NDArray]:
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self) -> List[Optional[NDArray]]:
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self) -> List[NDArray]:
        return [self.aux_dict[n] for n in self._aux_names]

    @staticmethod
    def _set_in_place(dst: NDArray, val, what: str, name: str):
        """``val`` into ``dst``'s tensor (cast to its dtype): the graphs
        and the executors sharing ``dst`` see it."""
        src = _as_tensor(val)
        if tuple(src.shape) != tuple(dst.shape):
            raise MXNetError(
                f"{what} {name!r}: shape {tuple(src.shape)} does not match "
                f"bound shape {tuple(dst.shape)}")
        with torch.no_grad():
            dst._data.copy_(src)

    def copy_params_from(self, arg_params: Dict[str, NDArray],
                         aux_params: Optional[Dict[str, NDArray]] = None,
                         allow_extra_params: bool = False):
        for names, d, params, what in (
                (self._arg_names, self.arg_dict, arg_params, "argument"),
                (self._aux_names, self.aux_dict, aux_params or {},
                 "aux state")):
            for name, val in params.items():
                if name in names:
                    if name in d:
                        self._set_in_place(d[name], val, what, name)
                    else:
                        d[name] = NDArray(_as_tensor(val).to(
                            self._device, copy=True))
                elif not allow_extra_params:
                    raise MXNetError(f"unknown {what} {name!r}")

    def reshape(self, partial_shaping=False, **shapes):
        """A new executor for new shapes, sharing this one's arrays where
        their shapes are unchanged (parity: ``Executor.reshape``)."""
        new = Executor.simple_bind(self._symbol, self._ctx,
                                   grad_req=self._req, **shapes)
        for name, old in self.arg_dict.items():
            if name in new.arg_dict and \
                    tuple(new.arg_dict[name].shape) == tuple(old.shape):
                new.arg_dict[name] = old
            elif not partial_shaping and name not in shapes:
                raise MXNetError(
                    f"reshape: parameter {name!r} changed shape; pass "
                    f"partial_shaping=True to allow re-initialization")
        for name, old in self.aux_dict.items():
            if name in new.aux_dict and \
                    tuple(new.aux_dict[name].shape) == tuple(old.shape):
                new.aux_dict[name] = old
        return new
