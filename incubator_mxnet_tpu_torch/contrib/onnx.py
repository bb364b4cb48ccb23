"""ONNX export / import: the port of the JAX package's
``incubator_mxnet_tpu/contrib/onnx.py`` (parity: python/mxnet/contrib/onnx/
— mx2onnx/_op_translations.py and onnx2mx/import_model.py).

Two-stage design, environment-independent:

  1. ``graph_to_ir(sym, params, input_shapes)`` — pure-Python lowering of
     the symbol graph to ONNX-shaped node dicts (op_type, inputs,
     outputs, attrs, initializers). No onnx dependency.
  2. ``export_model(...)`` / ``import_model(...)`` — proto
     (de)serialization. Uses the real ``onnx`` package when installed
     (adds ``onnx.checker`` validation); otherwise the vendored
     wire-format layer in ``_onnx_proto.py`` writes/reads spec-compliant
     ``.onnx`` bytes directly, so export/import work without the wheel.

The lowering runs over the port's Symbol JSON, which is the JAX
package's, and the wire layer is a copy of the JAX one, so both packages
write byte-equal files for the same graph and weights. An imported
Symbol binds in the port's ``Executor`` (on the card: one CUDA graph per
signature); the BatchNorm statistics come back in ``arg_params``, as the
JAX importer returns them, and ``Executor.copy_params_from`` places
them.

Covered op set (the reference's CNN export core): Convolution,
FullyConnected, Pooling (incl. global), Activation/relu/sigmoid/tanh,
flatten, softmax, BatchNorm, Dropout, elementwise/broadcast add & mul,
Concat, Reshape.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as _np

from ..base import MXNetError

__all__ = ["graph_to_ir", "export_model", "import_model", "ir_to_symbol"]


def _maybe_onnx():
    """The real onnx package if installed, else None (vendored fallback)."""
    try:
        import onnx  # noqa: F401
        return onnx
    except ImportError:
        return None


def _tup(v, n):
    if v is None:
        return (1,) * n
    if isinstance(v, (int, float)):
        return (int(v),) * n
    return tuple(int(x) for x in v)


def _conv_attrs(attrs):
    kernel = tuple(int(k) for k in attrs["kernel"])
    nsp = len(kernel)
    stride = _tup(attrs.get("stride"), nsp)
    dilate = _tup(attrs.get("dilate"), nsp)
    pad = _tup(attrs.get("pad") or (0,) * nsp, nsp)
    return {
        "kernel_shape": list(kernel),
        "strides": list(stride),
        "dilations": list(dilate),
        "pads": list(pad) + list(pad),      # symmetric begin+end
        "group": int(attrs.get("num_group", 1) or 1),
    }


def graph_to_ir(sym, params: Dict, input_shapes: Dict[str, Sequence[int]]):
    """Lower a Symbol graph to an ONNX-shaped IR dict.

    params: name → NDArray/ndarray for every non-input variable.
    input_shapes: name → shape for genuine graph inputs.
    Returns {"nodes", "inputs", "outputs", "initializers"}."""
    graph = json.loads(sym.tojson())
    nodes_in = graph["nodes"]
    # tojson stringifies attr values (reference nnvm Map<string,string>
    # convention); parse literals back before reading kernel/stride/...
    from ..symbol.symbol import _coerce_attr
    for n in nodes_in:
        if n.get("attrs"):
            n["attrs"] = {k: _coerce_attr(k, v)
                          for k, v in n["attrs"].items()}
    heads = graph["heads"]

    def np_of(v):
        return v.asnumpy() if hasattr(v, "asnumpy") else _np.asarray(v)

    out_name: Dict[Tuple[int, int], str] = {}
    ir_nodes: List[dict] = []
    initializers: Dict[str, _np.ndarray] = {}
    inputs = []

    for i, n in enumerate(nodes_in):
        if n["op"] == "null":
            name = n["name"]
            out_name[(i, 0)] = name
            if name in input_shapes:
                inputs.append({"name": name,
                               "shape": list(input_shapes[name])})
            elif name in params:
                initializers[name] = np_of(params[name])
            else:
                raise MXNetError(
                    f"variable {name!r} has neither an input shape nor a "
                    f"parameter value")
            continue

        op = n["op"]
        attrs = n["attrs"]
        name = n["name"]
        ins = [out_name[(src, idx)] for src, idx, _ in n["inputs"]]
        out = name + "_out"

        def emit(op_type, node_inputs, node_attrs=None, out_names=None):
            outs = out_names or [out]
            ir_nodes.append({"op_type": op_type, "name": name,
                             "inputs": list(node_inputs),
                             "outputs": outs,
                             "attrs": dict(node_attrs or {})})

        if op == "Convolution":
            a = _conv_attrs(attrs)
            no_bias = bool(attrs.get("no_bias", False))
            emit("Conv", ins[:2] if no_bias else ins[:3], a)
        elif op == "FullyConnected":
            no_bias = bool(attrs.get("no_bias", False))
            flatten = bool(attrs.get("flatten", True))
            data = ins[0]
            if flatten:
                flat = name + "_flat"
                ir_nodes.append({"op_type": "Flatten", "name": flat,
                                 "inputs": [data], "outputs": [flat],
                                 "attrs": {"axis": 1}})
                data = flat
            gemm_in = [data, ins[1]] if no_bias else [data, ins[1], ins[2]]
            emit("Gemm", gemm_in, {"transB": 1, "alpha": 1.0, "beta": 1.0})
        elif op == "Pooling":
            kind = attrs.get("pool_type", "max")
            if attrs.get("global_pool", False):
                emit("GlobalMaxPool" if kind == "max"
                     else "GlobalAveragePool", ins[:1])
            else:
                kernel = tuple(int(k) for k in attrs["kernel"])
                nsp = len(kernel)
                a = {"kernel_shape": list(kernel),
                     "strides": list(_tup(attrs.get("stride"), nsp)),
                     "pads": list(_tup(attrs.get("pad") or (0,) * nsp,
                                       nsp)) * 2}
                emit("MaxPool" if kind == "max" else "AveragePool",
                     ins[:1], a)
        elif op in ("Activation", "relu", "sigmoid", "tanh", "softrelu"):
            act = attrs.get("act_type", op)
            table = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
                     "softrelu": "Softplus"}
            if act not in table:
                raise MXNetError(f"unsupported activation {act!r}")
            emit(table[act], ins[:1])
        elif op in ("flatten", "Flatten"):
            emit("Flatten", ins[:1], {"axis": 1})
        elif op in ("softmax", "SoftmaxOutput", "SoftmaxActivation"):
            emit("Softmax", ins[:1], {"axis": int(attrs.get("axis", -1))})
        elif op == "BatchNorm":
            emit("BatchNormalization", ins[:5],
                 {"epsilon": float(attrs.get("eps", 1e-5)),
                  "momentum": float(attrs.get("momentum", 0.9))})
        elif op == "Dropout":
            emit("Dropout", ins[:1])
        elif op in ("elemwise_add", "broadcast_add", "_plus"):
            emit("Add", ins[:2])
        elif op in ("elemwise_mul", "broadcast_mul", "_mul"):
            emit("Mul", ins[:2])
        elif op == "Concat":
            emit("Concat", ins,
                 {"axis": int(attrs.get("dim", attrs.get("axis", 1)))})
        elif op in ("Reshape", "reshape"):
            shape_name = name + "_shape"
            initializers[shape_name] = _np.asarray(
                [int(s) for s in attrs["shape"]], _np.int64)
            emit("Reshape", [ins[0], shape_name])
        else:
            raise MXNetError(f"ONNX export: unsupported op {op!r}")
        for k in range(len(nodes_in[i].get("outputs", [])) or 1):
            out_name[(i, k)] = out

    outputs = [{"name": out_name[(h[0], h[1])]} for h in heads]
    return {"nodes": ir_nodes, "inputs": inputs, "outputs": outputs,
            "initializers": initializers}


# --------------------------------------------------------------------- #
# IR → onnx protos
# --------------------------------------------------------------------- #

def export_model(sym, params, input_shapes, onnx_file: str,
                 model_name: str = "incubator_mxnet_tpu",
                 opset: int = 13) -> str:
    """Serialize ``sym`` + ``params`` to an ONNX file. Mirrors the
    reference's ``onnx_mxnet.export_model``. Writes through the vendored
    wire-format layer; validates with onnx.checker when the real package
    happens to be installed."""
    from . import _onnx_proto as op

    ir = graph_to_ir(sym, params, input_shapes)
    nodes = [op.node_bytes(n["op_type"], n["inputs"], n["outputs"],
                           name=n["name"], attrs=n["attrs"])
             for n in ir["nodes"]]
    graph_inputs = [op.value_info_bytes(i["name"], op.FLOAT, i["shape"])
                    for i in ir["inputs"]]
    graph_outputs = [op.value_info_bytes(o["name"], op.FLOAT, None)
                     for o in ir["outputs"]]
    inits = [op.tensor_bytes(k, v.astype(_np.float32)
                             if v.dtype != _np.int64 else v)
             for k, v in ir["initializers"].items()]
    graph = op.graph_bytes(nodes, model_name, graph_inputs,
                           graph_outputs, inits)
    blob = op.model_bytes(graph, opset=opset)
    onnx = _maybe_onnx()
    if onnx is not None:
        model = onnx.ModelProto()
        model.ParseFromString(blob)
        onnx.checker.check_model(model)
    with open(onnx_file, "wb") as f:
        f.write(blob)
    return onnx_file


# --------------------------------------------------------------------- #
# import: onnx → symbol
# --------------------------------------------------------------------- #

_IMPORT_ACT = {"Relu": "relu", "Sigmoid": "sigmoid", "Tanh": "tanh",
               "Softplus": "softrelu"}


def ir_to_symbol(nodes, inputs, initializers):
    """Rebuild a Symbol graph + params from ONNX-shaped node dicts
    (the inverse of graph_to_ir for the supported op set)."""
    from .. import symbol as sym_mod
    from ..ndarray import array as nd_array

    env: Dict[str, object] = {}
    for i in inputs:
        env[i["name"]] = sym_mod.Variable(i["name"])
    arg_params = {}
    for k, v in initializers.items():
        if v.dtype == _np.int64:
            env[k] = v  # shape tensors consumed inline
        else:
            env[k] = sym_mod.Variable(k)
            arg_params[k] = nd_array(v)

    last = None
    for n in nodes:
        op, ins, outs = n["op_type"], n["inputs"], n["outputs"]
        a = n.get("attrs", {})
        x = [env[i] for i in ins]
        if op == "Conv":
            nsp = len(a["kernel_shape"])
            pads = list(a.get("pads") or [0] * (2 * nsp))
            if pads[:nsp] != pads[nsp:]:
                raise MXNetError(
                    f"ONNX import: asymmetric Conv pads {pads} are not "
                    f"supported (reference Convolution pads symmetrically)")
            out = sym_mod.Convolution(
                *x, kernel=tuple(a["kernel_shape"]),
                stride=tuple(a.get("strides", (1,) * nsp)),
                dilate=tuple(a.get("dilations", (1,) * nsp)),
                pad=tuple((a.get("pads") or [0] * nsp)[:nsp]),
                num_filter=initializers[ins[1]].shape[0],
                num_group=int(a.get("group", 1)),
                no_bias=len(ins) == 2, name=n["name"])
        elif op == "Gemm":
            out = sym_mod.FullyConnected(
                *x, num_hidden=initializers[ins[1]].shape[0],
                no_bias=len(ins) == 2, flatten=False, name=n["name"])
        elif op in ("MaxPool", "AveragePool"):
            nsp = len(a["kernel_shape"])
            out = sym_mod.Pooling(
                x[0], kernel=tuple(a["kernel_shape"]),
                stride=tuple(a.get("strides", (1,) * nsp)),
                pad=tuple((a.get("pads") or [0] * nsp)[:nsp]),
                pool_type="max" if op == "MaxPool" else "avg",
                name=n["name"])
        elif op in ("GlobalMaxPool", "GlobalAveragePool"):
            out = sym_mod.Pooling(
                x[0], kernel=(1, 1), global_pool=True,
                pool_type="max" if op == "GlobalMaxPool" else "avg",
                name=n["name"])
        elif op in _IMPORT_ACT:
            out = sym_mod.Activation(x[0], act_type=_IMPORT_ACT[op],
                                     name=n["name"])
        elif op == "Flatten":
            out = sym_mod.flatten(x[0], name=n["name"])
        elif op == "Softmax":
            out = sym_mod.softmax(x[0], axis=int(a.get("axis", -1)),
                                  name=n["name"])
        elif op == "BatchNormalization":
            out = sym_mod.BatchNorm(*x, eps=float(a.get("epsilon", 1e-5)),
                                    momentum=float(a.get("momentum", 0.9)),
                                    name=n["name"])
        elif op == "Dropout":
            out = sym_mod.Dropout(x[0], p=float(a.get("ratio", 0.5)),
                                  name=n["name"])
        elif op == "Add":
            out = sym_mod.broadcast_add(x[0], x[1], name=n["name"])
        elif op == "Mul":
            out = sym_mod.broadcast_mul(x[0], x[1], name=n["name"])
        elif op == "Concat":
            out = sym_mod.Concat(*x, dim=int(a.get("axis", 1)),
                                 name=n["name"])
        elif op == "Reshape":
            shape = env[ins[1]]
            out = sym_mod.reshape(x[0], shape=tuple(int(s) for s in shape),
                                  name=n["name"])
        else:
            raise MXNetError(f"ONNX import: unsupported op {op!r}")
        for o in outs:
            env[o] = out
        last = out
    return last, arg_params


def import_model(onnx_file: str):
    """Load an ONNX file → (sym, arg_params, aux_params). Mirrors the
    reference's ``onnx_mxnet.import_model``. Reads through the vendored
    wire-format layer (also parses files written by the real library)."""
    from . import _onnx_proto as op

    with open(onnx_file, "rb") as f:
        parsed = op.parse_model(f.read())
    g = parsed["graph"]
    initializers = g["initializers"]
    inputs = [i for i in g["inputs"] if i["name"] not in initializers]
    nodes = [{"op_type": n["op_type"],
              "name": n["name"] or n["outputs"][0],
              "inputs": n["inputs"], "outputs": n["outputs"],
              "attrs": n["attrs"]} for n in g["nodes"]]
    sym, arg_params = ir_to_symbol(nodes, inputs, initializers)
    return sym, arg_params, {}
