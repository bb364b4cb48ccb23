"""The symbolic graph: the port of the JAX package's
``incubator_mxnet_tpu/symbol/symbol.py``.

A ``Symbol`` is a list of ``(node, output index)`` heads over a DAG of
``_Node``s: variables (``op='null'``) and applications of ops of the
same registry ``mx.nd`` uses. ``tojson`` writes NNVM's layout
(``nodes`` / ``arg_nodes`` / ``heads``) with every attribute value a
string, as MXNet 1.x writes it; ``fromjson`` parses the literals back,
keeping dunder attributes (``__shape__``, ``__dtype__``, ``__init__``,
...) as the strings MXNet's attribute API promises. Shape inference
(``executor.infer_shapes``) reads a variable's ``__shape__`` either way.
The two packages write the same JSON for the same graph and read each
other's files.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError
from ..ops import registry as _registry

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "fromjson"]

_counter_lock = threading.Lock()
_name_counters: Dict[str, int] = {}


def _auto_name(op: str) -> str:
    """``op`` lower-cased with the op's next counter value (``relu0``)."""
    with _counter_lock:
        idx = _name_counters.get(op, 0)
        _name_counters[op] = idx + 1
    return f"{op.lower()}{idx}"


class _Node:
    """One node: a variable (``op='null'``) or an op application.
    ``attrs`` are the op's keyword arguments (and a variable's dunder
    attributes); ``annotations`` are graph metadata (``AttrScope``,
    ``_set_attr``) that no op sees."""

    __slots__ = ("op", "name", "inputs", "attrs", "annotations")

    def __init__(self, op: str, name: str,
                 inputs: Sequence[Tuple["_Node", int]] = (),
                 attrs: Optional[dict] = None,
                 annotations: Optional[dict] = None):
        self.op = op
        self.name = name
        self.inputs = list(inputs)
        self.attrs = dict(attrs or {})
        self.annotations = dict(annotations or {})

    @property
    def is_variable(self) -> bool:
        return self.op == "null"

    def num_outputs(self) -> int:
        if self.is_variable:
            return 1
        spec = _registry.get(self.op)
        if callable(spec.num_outputs):
            return spec.num_outputs(self.attrs)
        if spec.num_outputs:
            return spec.num_outputs
        # variadic outputs: the arity from the static attributes
        if "num_outputs" in self.attrs:
            return int(self.attrs["num_outputs"])
        ios = self.attrs.get("indices_or_sections")
        if ios is not None:
            return len(ios) + 1 if isinstance(ios, (list, tuple)) \
                else int(ios)
        return 1


def _topo(heads: Sequence[Tuple[_Node, int]]) -> List[_Node]:
    """Deterministic post-order topological sort of the DAG (the JAX
    package's recursive order, walked with a stack: a deep net would
    pass Python's recursion limit)."""
    seen = set()
    order: List[_Node] = []
    for head, _ in heads:
        if id(head) in seen:
            continue
        seen.add(id(head))
        stack = [(head, 0)]
        while stack:
            node, i = stack[-1]
            if i < len(node.inputs):
                stack[-1] = (node, i + 1)
                src = node.inputs[i][0]
                if id(src) not in seen:
                    seen.add(id(src))
                    stack.append((src, 0))
            else:
                stack.pop()
                order.append(node)
    return order


class Symbol:
    """A symbolic multi-output expression (parity: ``mx.sym.Symbol``)."""

    def __init__(self, heads: Sequence[Tuple[_Node, int]]):
        self._heads: List[Tuple[_Node, int]] = list(heads)

    # -- identity ------------------------------------------------------ #
    @property
    def name(self) -> str:
        if len(self._heads) == 1:
            return self._heads[0][0].name
        return "grouped"

    @property
    def _node(self) -> _Node:
        return self._heads[0][0]

    def attr(self, key: str):
        node = self._node
        if key in node.annotations:
            return node.annotations[key]
        return node.attrs.get(key)

    def list_attr(self) -> dict:
        merged = dict(self._node.attrs)
        merged.update(self._node.annotations)
        return merged

    def attr_dict(self) -> dict:
        """Node name -> its attributes as strings, for every node that has
        any."""
        out = {}
        for node in _topo(self._heads):
            merged = dict(node.attrs)
            merged.update(node.annotations)
            if merged:
                out[node.name] = {k: str(v) for k, v in merged.items()}
        return out

    def _set_attr(self, **kwargs):
        self._node.annotations.update(
            {k: str(v) for k, v in kwargs.items()})

    # -- composition --------------------------------------------------- #
    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            try:
                index = names.index(index)
            except ValueError:
                raise MXNetError(f"no output named {index!r} in {names}")
        return Symbol([self._heads[index]])

    def __len__(self):
        return len(self._heads)

    def __iter__(self):
        for i in range(len(self._heads)):
            yield self[i]

    def get_internals(self) -> "Symbol":
        """Every output of every node, as a group (parity:
        ``get_internals``)."""
        return Symbol([(node, k) for node in _topo(self._heads)
                       for k in range(node.num_outputs())])

    def get_children(self) -> Optional["Symbol"]:
        if self._node.is_variable:
            return None
        return Symbol(list(self._node.inputs))

    # -- introspection ------------------------------------------------- #
    def list_arguments(self) -> List[str]:
        """Input variables in topological order, auxiliary states left
        out."""
        return [n.name for n in _topo(self._heads)
                if n.is_variable and not n.attrs.get("__aux__")]

    def list_auxiliary_states(self) -> List[str]:
        return [n.name for n in _topo(self._heads)
                if n.is_variable and n.attrs.get("__aux__")]

    def list_inputs(self) -> List[str]:
        return [n.name for n in _topo(self._heads) if n.is_variable]

    def list_outputs(self) -> List[str]:
        return [f"{node.name}_output{idx}" if node.num_outputs() > 1
                else f"{node.name}_output" for node, idx in self._heads]

    @property
    def num_outputs(self) -> int:
        return len(self._heads)

    # -- shape / type inference ---------------------------------------- #
    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from the shapes given
        (positionally in ``list_arguments`` order, or by name); the
        parameters' shapes follow from the data's where an op's rule
        says how. ``(None, None, None)`` when under-determined."""
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        known: Dict[str, tuple] = {}
        for name, shape in zip(arg_names, args):
            if shape is not None:
                known[name] = tuple(shape)
        known.update({k: tuple(v) for k, v in kwargs.items()})
        from . import executor as _exec
        try:
            shapes = _exec.infer_shapes(self, known)
        except MXNetError:
            return None, None, None
        return ([shapes["args"][n] for n in arg_names], shapes["outs"],
                [shapes["args"][n] for n in aux_names])

    def infer_shape_partial(self, *args, **kwargs):
        try:
            return self.infer_shape(*args, **kwargs)
        except Exception:
            return None, None, None

    def infer_type(self, *args, **kwargs):
        arg_names = self.list_arguments()
        known = dict(zip(arg_names, args))
        known.update(kwargs)
        if any(n not in known for n in arg_names):
            return None, None, None
        from . import executor as _exec
        dtypes = _exec.infer_types(
            self, {k: v for k, v in known.items() if v is not None})
        return ([dtypes["args"][n] for n in arg_names], dtypes["outs"],
                [dtypes["args"][n] for n in self.list_auxiliary_states()])

    # -- execution ----------------------------------------------------- #
    def eval(self, ctx=None, **kwargs):
        """Evaluate imperatively on ``NDArray`` bindings; a list of
        ``NDArray``s (parity: ``sym.eval``)."""
        from . import executor as _exec
        out = _exec.evaluate(self, kwargs, training=False)
        return out if isinstance(out, list) else [out]

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, **kwargs):
        from .executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def simple_bind(self, ctx=None, grad_req="write", **shapes):
        from .executor import Executor
        return Executor.simple_bind(self, ctx, grad_req, **shapes)

    def grad(self, wrt):
        raise MXNetError(
            "Symbol.grad is deprecated (as in the reference); bind the "
            "symbol and use Executor.backward, or autograd.record")

    # -- serialization ------------------------------------------------- #
    def tojson(self) -> str:
        nodes = _topo(self._heads)
        node_id = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        for n in nodes:
            spec = {
                "op": n.op,
                "name": n.name,
                "attrs": {k: v if isinstance(v, str) else str(v)
                          for k, v in n.attrs.items()},
                "inputs": [[node_id[id(src)], idx, 0]
                           for src, idx in n.inputs],
            }
            if n.annotations:
                spec["annotations"] = n.annotations
            out_nodes.append(spec)
        payload = {
            "nodes": out_nodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_variable],
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": [[node_id[id(n)], idx, 0] for n, idx in self._heads],
            # the file format's tag, the JAX package's (either reads both)
            "attrs": {"framework": "incubator_mxnet_tpu",
                      "format_version": 1},
        }
        return json.dumps(payload, indent=2)

    def save(self, fname: str):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- operator sugar ------------------------------------------------ #
    _SCALAR_OPS = {
        "broadcast_add": ("_plus_scalar", "_plus_scalar"),
        "broadcast_sub": ("_minus_scalar", "_rminus_scalar"),
        "broadcast_mul": ("_mul_scalar", "_mul_scalar"),
        "broadcast_div": ("_div_scalar", "_rdiv_scalar"),
        "broadcast_power": ("_power_scalar", "_rpower_scalar"),
    }

    def _binop(self, op_name, other, reverse=False):
        from . import _invoke_symbol
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _invoke_symbol(op_name, a, b)
        fwd, rev = self._SCALAR_OPS[op_name]
        return _invoke_symbol(rev if reverse else fwd, self,
                              scalar=float(other))

    def __add__(self, o):
        return self._binop("broadcast_add", o)

    def __radd__(self, o):
        return self._binop("broadcast_add", o)

    def __sub__(self, o):
        return self._binop("broadcast_sub", o)

    def __rsub__(self, o):
        return self._binop("broadcast_sub", o, reverse=True)

    def __mul__(self, o):
        return self._binop("broadcast_mul", o)

    def __rmul__(self, o):
        return self._binop("broadcast_mul", o)

    def __truediv__(self, o):
        return self._binop("broadcast_div", o)

    def __rtruediv__(self, o):
        return self._binop("broadcast_div", o, reverse=True)

    def __pow__(self, o):
        return self._binop("broadcast_power", o)

    def __neg__(self):
        return self * -1.0

    def __repr__(self):
        return f"<Symbol {self.name} [{', '.join(self.list_outputs())}]>"


def Variable(name: str, shape=None, dtype=None, init=None, **attrs) -> Symbol:
    """An input placeholder (parity: ``mx.sym.Variable``); the innermost
    ``AttrScope``'s attributes annotate it."""
    node_attrs = dict(attrs)
    if shape is not None:
        node_attrs["__shape__"] = list(shape)
    if dtype is not None:
        node_attrs["__dtype__"] = str(dtype)
    from ..attribute import current_attrs
    return Symbol([(_Node("null", name, (), node_attrs,
                          current_attrs() or None), 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    """The outputs of ``symbols`` as one multi-output symbol."""
    heads: List[Tuple[_Node, int]] = []
    for s in symbols:
        heads.extend(s._heads)
    return Symbol(heads)


def _coerce_attr(k, v):
    """MXNet 1.x writes every attribute value as a string ("4", "(3,
    3)", "True"): parse literals back and keep real strings
    ("relu"). Dunder attributes stay strings, as MXNet's attribute API
    types them."""
    if not isinstance(v, str) or k.startswith("__"):
        return v
    import ast
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def fromjson(text: str) -> Symbol:
    payload = json.loads(text)
    nodes: List[_Node] = []
    for spec in payload["nodes"]:
        attrs = spec.get("attrs") or spec.get("param") or {}
        attrs = {k: _coerce_attr(k, v) for k, v in attrs.items()}
        inputs = [(nodes[i], idx) for i, idx, *_ in spec.get("inputs", [])]
        nodes.append(_Node(spec["op"], spec["name"], inputs, attrs,
                           spec.get("annotations")))
    return Symbol([(nodes[i], idx) for i, idx, *_ in payload["heads"]])


load_json = fromjson


def load(fname: str) -> Symbol:
    """A symbol from its JSON file (parity: ``mx.sym.load``)."""
    with open(fname) as f:
        return fromjson(f.read())
