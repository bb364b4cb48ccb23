"""Network visualization: the port of the JAX package's
``incubator_mxnet_tpu/visualization.py``.

``print_summary`` prints a layer table of a Symbol with output shapes
(from ``infer_shape``, when ``shape`` is given) and parameter counts;
``plot_network`` returns a graphviz ``Digraph`` when the ``graphviz``
package imports, and raises ``MXNetError`` otherwise."""

from __future__ import annotations

from typing import Dict, Optional

from .base import MXNetError
from .symbol.symbol import _topo as _topo_heads

__all__ = ["print_summary", "plot_network"]


def _topo(symbol):
    return _topo_heads(symbol._heads)


def print_summary(symbol, shape: Optional[Dict[str, tuple]] = None,
                  line_length: int = 98, positions=(0.44, 0.64, 0.74, 1.0)):
    """Print a Keras-style layer summary of ``symbol``.

    ``shape``: dict of input-name -> shape used to infer per-layer output
    shapes (optional — the Shape column is empty without it).
    """
    shapes_by_name: Dict[str, tuple] = {}
    arg_shape_by_name: Dict[str, tuple] = {}
    if shape is not None:
        arg_shapes, _, _ = symbol.infer_shape(**shape)
        arg_shape_by_name = dict(zip(symbol.list_arguments(),
                                     (tuple(a) for a in arg_shapes)))
        internals = symbol.get_internals()
        # one entry per internal output, keyed by node name
        _, int_shapes, _ = internals.infer_shape(**shape)
        for s, (node, idx) in zip(int_shapes, internals._heads):
            if idx == 0:
                shapes_by_name[node.name] = tuple(s)

    positions = [int(line_length * p) for p in positions]
    headers = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(fields):
        line = ""
        for f, pos in zip(fields, positions):
            line += str(f)
            line = line[:pos - 1]
            line += " " * (pos - len(line))
        print(line)

    print("_" * line_length)
    print_row(headers)
    print("=" * line_length)

    # inputs = the user-provided shape keys (fall back to the "data"
    # naming convention when no shapes are given); everything else that
    # is a variable counts as a parameter
    input_names = set(shape.keys()) if shape else {"data"}
    total_params = 0
    for node in _topo(symbol):
        if node.is_variable:
            continue
        out_shape = shapes_by_name.get(node.name, "")
        n_params = 0
        prev = []
        for inp, _ in node.inputs:
            if inp.is_variable and inp.name not in input_names:
                sh = shapes_by_name.get(inp.name) or \
                    arg_shape_by_name.get(inp.name)
                if sh:
                    p = 1
                    for d in sh:
                        p *= int(d)
                    n_params += p
            elif not inp.is_variable:
                prev.append(inp.name)
        total_params += n_params
        print_row([f"{node.name} ({node.op})", out_shape, n_params,
                   ",".join(prev)])
    print("=" * line_length)
    print(f"Total params: {total_params}")
    print("_" * line_length)
    return total_params


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Render the Symbol graph as a graphviz Digraph (gated on the
    ``graphviz`` package; parity: mx.viz.plot_network)."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise MXNetError(
            "plot_network requires the 'graphviz' python package, which "
            "is not installed in this image; use "
            "mx.viz.print_summary(sym, shape) for a text summary"
        ) from e

    node_attrs = node_attrs or {}
    dot = Digraph(name=title, format=save_format)
    dot.attr("node", shape="box", fixedsize="false",
             fontsize="10", **node_attrs)
    for node in _topo(symbol):
        if node.is_variable and hide_weights and node.name != "data":
            continue
        color = "#8dd3c7" if node.is_variable else "#fb8072"
        dot.node(str(id(node)), label=f"{node.name}\n{node.op}",
                 style="filled", fillcolor=color)
        for inp, _ in node.inputs:
            if inp.is_variable and hide_weights and inp.name != "data":
                continue
            dot.edge(str(id(inp)), str(id(node)))
    return dot
