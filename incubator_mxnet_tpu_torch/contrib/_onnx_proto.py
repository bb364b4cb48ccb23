"""Minimal vendored ONNX protobuf (de)serializer — no onnx wheel needed:
the port's own copy of the JAX package's
``incubator_mxnet_tpu/contrib/_onnx_proto.py``. Its defaults (the
producer name included) are the JAX copy's, so both packages write the
same bytes for the same graph.

Implements the protobuf wire format by hand for exactly the schema subset
the converter (`contrib/onnx.py`) emits and consumes: ModelProto /
GraphProto / NodeProto / AttributeProto / TensorProto / ValueInfoProto
with raw_data tensors. Field numbers follow the public onnx.proto3 schema
(ONNX IR; reference counterpart: python/mxnet/contrib/onnx's dependency on
the onnx package — this build is environment-independent instead).

Wire format recap: each field is a varint key ``(field_number << 3) |
wire_type`` followed by a varint (type 0), 8-byte scalar (1), length-
delimited bytes (2), or 4-byte scalar (5). Unknown fields are skipped on
read, so files produced by the real onnx library parse fine.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

# TensorProto.DataType (onnx.proto3 enum)
FLOAT = 1
UINT8 = 2
INT8 = 3
INT32 = 6
INT64 = 7
BOOL = 9
FLOAT16 = 10
DOUBLE = 11
BFLOAT16 = 16

_NP_OF = {FLOAT: np.float32, UINT8: np.uint8, INT8: np.int8,
          INT32: np.int32, INT64: np.int64, BOOL: np.bool_,
          FLOAT16: np.float16, DOUBLE: np.float64}
_DT_OF = {np.dtype(v): k for k, v in _NP_OF.items()}

# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING = 1, 2, 3
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


# --------------------------------------------------------------------- #
# wire primitives
# --------------------------------------------------------------------- #

def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # two's-complement for negative int64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _signed(n: int) -> int:
    return n - (1 << 64) if n >= 1 << 63 else n


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _varint_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _str_field(field: int, s) -> bytes:
    return _len_field(field, s if isinstance(s, bytes) else s.encode())


def _parse(buf: bytes) -> Dict[int, List]:
    """One message level → {field_number: [raw values in order]}."""
    fields: Dict[int, List] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        fnum, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            v = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            v = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(fnum, []).append(v)
    return fields


def _first(fields, n, default=None):
    return fields[n][0] if n in fields else default


# --------------------------------------------------------------------- #
# writers (dict-shaped messages → bytes)
# --------------------------------------------------------------------- #

def tensor_bytes(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    dt = _DT_OF.get(arr.dtype)
    if dt is None:
        raise ValueError(f"unsupported tensor dtype {arr.dtype}")
    out = b"".join(_varint_field(1, int(d)) for d in arr.shape)
    out += _varint_field(2, dt)
    out += _str_field(8, name)
    out += _len_field(9, np.ascontiguousarray(arr).tobytes())
    return out


def _attr_bytes(name: str, value) -> bytes:
    """AttributeProto: name=1 f=2 i=3 s=4 floats=7 ints=8 type=20.
    Python-typed values map the way onnx.helper.make_node does."""
    out = _str_field(1, name)
    if isinstance(value, bool):
        out += _varint_field(3, int(value)) + _varint_field(20, ATTR_INT)
    elif isinstance(value, int):
        out += _varint_field(3, value) + _varint_field(20, ATTR_INT)
    elif isinstance(value, float):
        out += _key(2, 5) + struct.pack("<f", value)
        out += _varint_field(20, ATTR_FLOAT)
    elif isinstance(value, (str, bytes)):
        out += _str_field(4, value) + _varint_field(20, ATTR_STRING)
    elif isinstance(value, (list, tuple)) and value and \
            all(isinstance(v, float) for v in value):
        for v in value:
            out += _key(7, 5) + struct.pack("<f", v)
        out += _varint_field(20, ATTR_FLOATS)
    elif isinstance(value, (list, tuple)):
        for v in value:
            out += _varint_field(8, int(v))
        out += _varint_field(20, ATTR_INTS)
    else:
        raise ValueError(f"unsupported attribute {name}={value!r}")
    return out


def node_bytes(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
               name: str = "", attrs: Optional[Dict] = None) -> bytes:
    """NodeProto: input=1 output=2 name=3 op_type=4 attribute=5."""
    out = b"".join(_str_field(1, i) for i in inputs)
    out += b"".join(_str_field(2, o) for o in outputs)
    if name:
        out += _str_field(3, name)
    out += _str_field(4, op_type)
    for k in sorted(attrs or {}):
        out += _len_field(5, _attr_bytes(k, (attrs or {})[k]))
    return out


def value_info_bytes(name: str, elem_type: int,
                     shape: Optional[Sequence[int]]) -> bytes:
    """ValueInfoProto: name=1 type=2{tensor_type=1{elem_type=1
    shape=2{dim=1{dim_value=1}}}}."""
    tensor = _varint_field(1, elem_type)
    if shape is not None:
        dims = b"".join(
            _len_field(1, _varint_field(1, int(d))) for d in shape)
        tensor += _len_field(2, dims)
    return _str_field(1, name) + _len_field(2, _len_field(1, tensor))


def graph_bytes(nodes: Sequence[bytes], name: str,
                inputs: Sequence[bytes], outputs: Sequence[bytes],
                initializers: Sequence[bytes]) -> bytes:
    """GraphProto: node=1 name=2 initializer=5 input=11 output=12."""
    out = b"".join(_len_field(1, n) for n in nodes)
    out += _str_field(2, name)
    out += b"".join(_len_field(5, t) for t in initializers)
    out += b"".join(_len_field(11, i) for i in inputs)
    out += b"".join(_len_field(12, o) for o in outputs)
    return out


def model_bytes(graph: bytes, opset: int = 13, ir_version: int = 8,
                producer: str = "incubator_mxnet_tpu") -> bytes:
    """ModelProto: ir_version=1 producer_name=2 graph=7 opset_import=8;
    OperatorSetIdProto: domain=1 version=2."""
    opset_id = _str_field(1, "") + _varint_field(2, opset)
    return (_varint_field(1, ir_version) + _str_field(2, producer)
            + _len_field(7, graph) + _len_field(8, opset_id))


# --------------------------------------------------------------------- #
# readers (bytes → dict-shaped messages)
# --------------------------------------------------------------------- #

def parse_tensor(buf: bytes):
    f = _parse(buf)
    dims = [v for v in f.get(1, [])]
    dt_enum = _first(f, 2, FLOAT)
    dtype = _NP_OF.get(dt_enum)
    name = _first(f, 8, b"").decode()
    if dtype is None:
        raise ValueError(
            f"ONNX tensor {name!r}: unsupported data_type enum {dt_enum} "
            f"(supported: {sorted(_NP_OF)}; bfloat16/float16 initializers "
            f"are not handled by the vendored parser)")
    if 9 in f:                                   # raw_data
        arr = np.frombuffer(f[9][0], dtype=dtype).reshape(dims).copy()
    elif 4 in f:                                 # packed float_data
        arr = np.frombuffer(f[4][0], np.float32).reshape(dims).copy()
    elif 7 in f:                                 # packed int64_data
        vals, pos = [], 0
        buf7 = f[7][0]
        while pos < len(buf7):
            v, pos = _read_varint(buf7, pos)
            vals.append(_signed(v))
        arr = np.array(vals, np.int64).reshape(dims)
    else:
        arr = np.zeros(dims, dtype)
    return name, arr


def _parse_attr(buf: bytes):
    f = _parse(buf)
    name = _first(f, 1, b"").decode()
    atype = _first(f, 20)
    if atype == ATTR_INT or (atype is None and 3 in f):
        return name, _signed(_first(f, 3, 0))
    if atype == ATTR_FLOAT or (atype is None and 2 in f):
        return name, struct.unpack("<f", _first(f, 2))[0]
    if atype == ATTR_STRING or (atype is None and 4 in f):
        return name, _first(f, 4)          # bytes, like onnx.helper
    if atype == ATTR_INTS or (atype is None and 8 in f):
        vals = []
        for raw in f.get(8, []):
            if isinstance(raw, int):        # unpacked
                vals.append(_signed(raw))
            else:                           # packed
                pos = 0
                while pos < len(raw):
                    v, pos = _read_varint(raw, pos)
                    vals.append(_signed(v))
        return name, vals
    if atype == ATTR_FLOATS or (atype is None and 7 in f):
        vals = []
        for raw in f.get(7, []):
            if isinstance(raw, bytes) and len(raw) > 4:  # packed
                vals.extend(struct.unpack(f"<{len(raw) // 4}f", raw))
            else:
                vals.append(struct.unpack("<f", raw)[0])
        return name, vals
    return name, None


def parse_node(buf: bytes):
    f = _parse(buf)
    return {
        "op_type": _first(f, 4, b"").decode(),
        "name": _first(f, 3, b"").decode(),
        "inputs": [v.decode() for v in f.get(1, [])],
        "outputs": [v.decode() for v in f.get(2, [])],
        "attrs": dict(_parse_attr(a) for a in f.get(5, [])),
    }


def parse_value_info(buf: bytes):
    f = _parse(buf)
    name = _first(f, 1, b"").decode()
    shape: List[int] = []
    tt = _first(_parse(_first(f, 2, b"")), 1)
    if tt:
        shape_f = _parse(tt)
        if 2 in shape_f:
            for dim_buf in _parse(shape_f[2][0]).get(1, []):
                shape.append(_first(_parse(dim_buf), 1, 0))
    return {"name": name, "shape": shape}


def parse_model(buf: bytes):
    """bytes → {"graph": {nodes, inputs, outputs, initializers}, "opset"}."""
    f = _parse(buf)
    g = _parse(_first(f, 7, b""))
    opset = 0
    for op_buf in f.get(8, []):
        opset = max(opset, _first(_parse(op_buf), 2, 0))
    initializers = dict(parse_tensor(t) for t in g.get(5, []))
    return {
        "opset": opset,
        "graph": {
            "name": _first(g, 2, b"").decode(),
            "nodes": [parse_node(n) for n in g.get(1, [])],
            "inputs": [parse_value_info(i) for i in g.get(11, [])],
            "outputs": [parse_value_info(o) for o in g.get(12, [])],
            "initializers": initializers,
        },
    }
