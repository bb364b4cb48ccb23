"""Graph passes over the Symbol DAG: the port of the JAX package's
``incubator_mxnet_tpu/symbol/passes.py``.

``register_pass`` / ``apply_pass`` name graph-to-graph transforms;
``rewrite(sym, fn)`` rebuilds the DAG bottom-up, letting ``fn`` keep,
replace or splice out each node. Built in: ``EliminateIdentity``,
``FoldTransposePairs``, ``CountOps`` (analysis) and ``ReplaceOp``.
Passes build new nodes and never change the symbol they are given.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError
from .symbol import Symbol, _Node, _topo

__all__ = ["register_pass", "apply_pass", "list_passes", "rewrite",
           "eliminate_identity", "fold_transpose_pairs", "count_ops",
           "replace_op", "NodeView"]

_PASSES: Dict[str, Callable] = {}


def register_pass(name: str):
    """Register a named graph pass: ``fn(sym, **kwargs) -> Symbol``."""
    def deco(fn):
        if name in _PASSES:
            raise MXNetError(f"pass {name!r} already registered")
        _PASSES[name] = fn
        return fn
    return deco


def apply_pass(sym: Symbol, name: str, **kwargs) -> Symbol:
    """Apply a registered pass by name (parity: nnvm.ApplyPass)."""
    if name not in _PASSES:
        raise MXNetError(
            f"unknown pass {name!r}; registered: {sorted(_PASSES)}")
    return _PASSES[name](sym, **kwargs)


def list_passes() -> List[str]:
    return sorted(_PASSES)


class NodeView:
    """Read-only view of one node handed to rewriter callbacks."""

    __slots__ = ("op", "name", "attrs", "inputs")

    def __init__(self, node: _Node, inputs):
        self.op = node.op
        self.name = node.name
        self.attrs = dict(node.attrs)
        self.inputs = inputs        # list of (NodeView | None for vars)


def rewrite(sym: Symbol, fn: Callable[["_Node", List[Tuple[_Node, int]]],
                                      Optional[Tuple]]) -> Symbol:
    """Rebuild the DAG bottom-up, letting ``fn`` replace nodes.

    ``fn(node, new_inputs)`` receives the ORIGINAL node and its already-
    rewritten inputs ``[(node, out_idx), ...]``; it returns None to keep
    the node as-is, or ``(op, name, attrs, inputs)`` to substitute, or a
    single ``(node, out_idx)`` tuple to splice an existing output in
    place of this node (e.g. identity elimination)."""
    mapping: Dict[int, _Node] = {}
    redirect: Dict[int, Tuple[_Node, int]] = {}
    multi_out: Dict[int, bool] = {}

    def lookup(src: _Node, idx: int) -> Tuple[_Node, int]:
        if id(src) in redirect:
            if multi_out.get(id(src)):
                raise MXNetError(
                    f"rewrite: cannot splice multi-output node "
                    f"{src.name!r} to a single output — consumers "
                    f"reference distinct output slots")
            return redirect[id(src)]
        return mapping[id(src)], idx

    for node in _topo(sym._heads):
        new_inputs = [lookup(src, idx) for src, idx in node.inputs]
        out = fn(node, new_inputs)
        if out is None:
            mapping[id(node)] = _Node(node.op, node.name, new_inputs,
                                      node.attrs, node.annotations)
        elif isinstance(out, tuple) and len(out) == 2 \
                and isinstance(out[0], _Node):
            redirect[id(node)] = out
            multi_out[id(node)] = node.num_outputs() > 1
        elif isinstance(out, tuple) and len(out) == 4:
            op, name, attrs, inputs = out
            mapping[id(node)] = _Node(op, name, list(inputs), attrs,
                                      node.annotations)
        else:
            raise MXNetError(
                "rewriter must return None, (node, idx), or "
                "(op, name, attrs, inputs)")
    heads = [lookup(n, i) for n, i in sym._heads]
    return Symbol(heads)


# --------------------------------------------------------------------- #
# built-in passes
# --------------------------------------------------------------------- #

_IDENTITY_OPS = ("identity", "_copy")


@register_pass("EliminateIdentity")
def eliminate_identity(sym: Symbol, ops: Sequence[str] = _IDENTITY_OPS
                       ) -> Symbol:
    """Splice out identity-like single-input ops (reference:
    graph_editor / CSE-style cleanups). BlockGrad/stop_gradient are NOT
    in the default set: they are identity only in the forward pass, and
    removing them changes gradient semantics — pass them via ``ops``
    explicitly for inference-only graphs."""
    ops = set(ops)

    def fn(node, new_inputs):
        if node.op in ops and len(new_inputs) == 1:
            return new_inputs[0]
        return None

    return rewrite(sym, fn)


@register_pass("FoldTransposePairs")
def fold_transpose_pairs(sym: Symbol) -> Symbol:
    """Cancel transpose(transpose(x, p), q) when q∘p is the identity."""
    def fn(node, new_inputs):
        if node.op != "transpose" or len(new_inputs) != 1:
            return None
        src, idx = new_inputs[0]
        if src.op != "transpose":
            return None
        p = src.attrs.get("axes")
        q = node.attrs.get("axes")
        if p is None and q is None:
            # both default = full reversal: reversal∘reversal = identity
            return src.inputs[0]
        if p is None or q is None:
            # one explicit, one default reversal: the composite depends
            # on the (unknown at graph level) rank — keep the pair
            return None
        perm = [p[qi] for qi in q]
        if perm == list(range(len(perm))):
            return src.inputs[0]
        return None

    return rewrite(sym, fn)


@register_pass("CountOps")
def count_ops(sym: Symbol) -> Dict[str, int]:
    """Analysis pass: op histogram (reference: graph attr passes)."""
    counts: Dict[str, int] = {}
    for node in _topo(sym._heads):
        counts[node.op] = counts.get(node.op, 0) + 1
    return counts


@register_pass("ReplaceOp")
def replace_op(sym: Symbol, from_op: str = "", to_op: str = "",
               attr_map: Optional[Callable[[dict], dict]] = None
               ) -> Symbol:
    """Substitute every ``from_op`` node with ``to_op`` (the minimal
    custom-backend rewrite, e.g. swapping an op for a quantized twin)."""
    if not from_op or not to_op:
        raise MXNetError("ReplaceOp needs from_op and to_op")

    def fn(node, new_inputs):
        if node.op != from_op:
            return None
        attrs = attr_map(dict(node.attrs)) if attr_map else node.attrs
        return (to_op, node.name, attrs, new_inputs)

    return rewrite(sym, fn)
