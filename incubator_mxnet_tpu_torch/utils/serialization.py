"""NDArray / parameter files: the port of the JAX package's
``incubator_mxnet_tpu/utils/serialization.py``, byte for byte the same two
formats, auto-detected on load by their magic, so a file written by one
package loads in the other:

**MXTPU v1** (the native format), little-endian:
    8 bytes  magic  b'MXTPU\\x00\\x01\\x00'
    8 bytes  header length N (uint64)
    N bytes  JSON header: {"names": [...], "arrays": [{dtype, shape}, ...]}
    raw buffers, each 64-byte aligned, in header order (C-contiguous;
    bfloat16 as its uint16 bits)

**MXNet 1.x ``.params``**:
    uint64  0x112, uint64 0, uint64 array count, then per array:
        uint32 0xF993fac9 (V2; V3 0xF993faca also read), int32 storage
        type (0 = dense only), uint32 ndim, int64 x ndim shape, int32
        dev_type, int32 dev_id (written 1, 0; ignored on read), int32
        mshadow type flag (0 f32, 1 f64, 2 f16, 3 u8, 4 i32, 5 i8, 6 i64,
        7 bool, 12 bf16), raw C-order little-endian buffer
    uint64 name count, then per name: uint64 length + utf-8 bytes

Arrays are copied to the host to save; ``load_ndarrays`` returns
``NDArray``s on ``device``. As in the JAX package, an MXNet file's int64
records are narrowed to int32 (refused when a value does not fit) and
float64 to float32. The third input is a training capsule blob of the
checkpoint subsystem (magic ``MXTPUCK\x01``): ``load_ndarrays`` returns
its ``param/`` entries keyed by parameter name (``meta.param_names``), or
every entry when it holds no parameter.
"""

from __future__ import annotations

import json
import struct
from typing import List

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["save_ndarrays", "load_ndarrays", "MAGIC"]

MAGIC = b"MXTPU\x00\x01\x00"
_ALIGN = 64
_MX_LIST_MAGIC = 0x112
_NDARRAY_V2_MAGIC = 0xF993FAC9
_NDARRAY_V3_MAGIC = 0xF993FACA
_MX_DENSE_STYPE = 0
_MX_TYPE_FLAGS = {"float32": 0, "float64": 1, "float16": 2, "uint8": 3,
                  "int32": 4, "int8": 5, "int64": 6, "bool": 7,
                  "bfloat16": 12}
_MX_FLAG_NAMES = {v: k for k, v in _MX_TYPE_FLAGS.items()}


def _tohost(arr):
    """(dtype name, C-contiguous numpy array; bfloat16 as uint16 bits)."""
    from ..ndarray.ndarray import NDArray
    if isinstance(arr, NDArray):
        arr = arr._data
    if torch.is_tensor(arr):
        t = arr.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).cpu().numpy() \
                .view(np.uint16)
        a = t.cpu().numpy()
    else:
        a = np.asarray(arr)
        if a.dtype.name == "bfloat16":
            return "bfloat16", np.ascontiguousarray(a).view(np.uint16)
    return a.dtype.name, np.ascontiguousarray(a)


def save_ndarrays(fname: str, data, format: str = "mxtpu") -> None:
    """Save a dict / list of arrays (``NDArray``s, tensors or numpy)."""
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [_tohost(v) for v in data.values()]
        named = True
    elif isinstance(data, (list, tuple)):
        names = [str(i) for i in range(len(data))]
        arrays = [_tohost(v) for v in data]
        named = False
    else:
        names = ["0"]
        arrays = [_tohost(data)]
        named = False
    if format == "mxnet":
        _save_mxnet(fname, names if named else [], arrays)
        return
    if format != "mxtpu":
        raise MXNetError(f"unknown params format {format!r} "
                         f"(want 'mxtpu' or 'mxnet')")
    metas = [{"dtype": name, "shape": list(a.shape)} for name, a in arrays]
    header = json.dumps({"names": names, "arrays": metas}).encode("utf-8")
    with open(fname, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        pos = len(MAGIC) + 8 + len(header)
        for _, a in arrays:
            padding = (-pos) % _ALIGN
            f.write(b"\x00" * padding)
            pos += padding
            buf = a.tobytes(order="C")
            f.write(buf)
            pos += len(buf)


def _save_mxnet(fname: str, names: List[str], arrays) -> None:
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQQ", _MX_LIST_MAGIC, 0, len(arrays)))
        for name, a in arrays:
            flag = _MX_TYPE_FLAGS.get(name)
            if flag is None:
                raise MXNetError(f"dtype {name} has no MXNet 1.x type flag; "
                                 f"save in the native format instead")
            f.write(struct.pack("<Ii", _NDARRAY_V2_MAGIC, _MX_DENSE_STYPE))
            f.write(struct.pack("<I", a.ndim))
            f.write(struct.pack(f"<{a.ndim}q", *a.shape))
            f.write(struct.pack("<ii", 1, 0))
            f.write(struct.pack("<i", flag))
            f.write(a.tobytes(order="C"))
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            b = n.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def _read_exact(f, n, fname):
    raw = f.read(n)
    if len(raw) != n:
        raise MXNetError(f"{fname}: truncated .params file")
    return raw


def _tensor(name: str, raw: bytes, shape, device) -> torch.Tensor:
    """The tensor of a record's raw bytes (bfloat16 from its bits)."""
    if name == "bfloat16":
        a = np.frombuffer(raw, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(a).view(torch.bfloat16).to(device)
    a = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()
    return torch.from_numpy(a).to(device)


def _load_capsule(fname: str, device):
    """A capsule blob's ``param/<i>`` entries keyed by their parameter
    names (every entry when it holds no parameter)."""
    from ..checkpoint import capsule as _capsule
    from ..ndarray.ndarray import NDArray
    arrays, meta = _capsule.load_capsule_file(fname)
    names = meta.get("param_names") or []
    out = {}
    for key, a in arrays.items():
        if not key.startswith("param/"):
            continue
        idx = key[len("param/"):]
        name = names[int(idx)] \
            if idx.isdigit() and int(idx) < len(names) else idx
        out[name] = a, _capsule.logical_dtype(arrays, key)
    if not out:
        out = {k: (a, _capsule.logical_dtype(arrays, k))
               for k, a in arrays.items()}
    return {k: NDArray(_capsule.host_to_tensor(a, dt).to(device))
            for k, (a, dt) in out.items()}


def _load_mxnet(fname: str, device):
    from ..ndarray.ndarray import NDArray
    records = []
    with open(fname, "rb") as f:
        _magic, _reserved, count = struct.unpack(
            "<QQQ", _read_exact(f, 24, fname))
        for _ in range(count):
            (nd_magic,) = struct.unpack("<I", _read_exact(f, 4, fname))
            if nd_magic not in (_NDARRAY_V2_MAGIC, _NDARRAY_V3_MAGIC):
                raise MXNetError(
                    f"{fname}: pre-V2 (legacy) NDArray record "
                    f"0x{nd_magic:x} not supported; re-save with a "
                    f"MXNet >= 1.3 build")
            (stype,) = struct.unpack("<i", _read_exact(f, 4, fname))
            if stype != _MX_DENSE_STYPE:
                raise MXNetError(f"{fname}: sparse storage type {stype} "
                                 f"not supported by the migration loader")
            (ndim,) = struct.unpack("<I", _read_exact(f, 4, fname))
            shape = struct.unpack(f"<{ndim}q",
                                  _read_exact(f, 8 * ndim, fname))
            struct.unpack("<ii", _read_exact(f, 8, fname))
            (flag,) = struct.unpack("<i", _read_exact(f, 4, fname))
            name = _MX_FLAG_NAMES.get(flag)
            if name is None:
                raise MXNetError(f"{fname}: unsupported mshadow type flag "
                                 f"{flag}")
            itemsize = 2 if name == "bfloat16" else np.dtype(name).itemsize
            n_items = int(np.prod(shape)) if shape else 1
            records.append((name, _read_exact(f, n_items * itemsize, fname),
                            shape))
        (n_names,) = struct.unpack("<Q", _read_exact(f, 8, fname))
        names = []
        for _ in range(n_names):
            (ln,) = struct.unpack("<Q", _read_exact(f, 8, fname))
            names.append(_read_exact(f, ln, fname).decode("utf-8"))
    if names and len(names) != len(records):
        raise MXNetError(f"{fname}: {len(records)} arrays but "
                         f"{len(names)} names")
    out = []
    for name, raw, shape in records:
        t = _tensor(name, raw, shape, "cpu")
        if t.dtype == torch.int64:
            if t.numel() and (int(t.max()) > np.iinfo(np.int32).max
                              or int(t.min()) < np.iinfo(np.int32).min):
                raise MXNetError(
                    f"{fname}: int64 record holds values outside the "
                    f"int32 range; the 32-bit runtime cannot represent "
                    f"them losslessly")
            t = t.to(torch.int32)
        elif t.dtype == torch.float64:
            t = t.to(torch.float32)
        out.append(NDArray(t.to(device)))
    if not names:
        return out
    return dict(zip(names, out))


def load_ndarrays(fname: str, device="cpu"):
    """A dict name -> ``NDArray`` (a list when the names are all
    indices), on ``device``; the format is detected by its magic."""
    from ..ndarray.ndarray import NDArray
    with open(fname, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            if (len(magic) == 8
                    and struct.unpack("<Q", magic)[0] == _MX_LIST_MAGIC):
                return _load_mxnet(fname, device)
            from ..checkpoint import capsule as _capsule
            if magic == _capsule.CAPSULE_MAGIC:
                return _load_capsule(fname, device)
            raise MXNetError(f"{fname}: neither a MXTPU params file, a "
                             f"MXNet 1.x .params file nor a capsule")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode("utf-8"))
        pos = len(MAGIC) + 8 + hlen
        out = {}
        for name, meta in zip(header["names"], header["arrays"]):
            padding = (-pos) % _ALIGN
            f.read(padding)
            pos += padding
            shape = tuple(meta["shape"])
            itemsize = 2 if meta["dtype"] == "bfloat16" \
                else np.dtype(meta["dtype"]).itemsize
            count = int(np.prod(shape)) if shape else 1
            raw = f.read(count * itemsize)
            pos += len(raw)
            out[name] = NDArray(_tensor(meta["dtype"], raw, shape, device))
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out
