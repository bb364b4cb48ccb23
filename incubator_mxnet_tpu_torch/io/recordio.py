"""RecordIO: MXNet's binary record format, byte for byte (parity:
``mx.recordio``); the port of the JAX package's
``incubator_mxnet_tpu/io/recordio.py``.

    record  := magic(u32) | cflag_len(u32) | payload | pad to 4 bytes
    magic   =  0xced7230a
    cflag   =  top 3 bits (0 = whole, 1 = first, 2 = middle, 3 = last)
    length  =  low 29 bits

A ``.rec`` / ``.idx`` pair written by either package, or by MXNet's
``im2rec``, reads in the other. This module is the writer and the
always-present Python reader; ``io._native.NativeRecordReader`` reads
batches of records off the Python thread where its library builds.
"""

from __future__ import annotations

import collections
import io as _io
import os
import struct
from typing import Dict, List, Optional

import numpy as np

from ..base import MXNetError

__all__ = ["MXRecordIO", "IndexedRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_LEN_MASK = (1 << 29) - 1


class MXRecordIO:
    """Sequential record reader (``flag="r"``) or writer (``"w"``)."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self._fp = None
        self.open()

    def open(self):
        if self.flag == "w":
            self._fp = open(self.uri, "wb")
        elif self.flag == "r":
            self._fp = open(self.uri, "rb")
        else:
            raise MXNetError(f"invalid flag {self.flag!r}")
        self.writable = self.flag == "w"

    def close(self):
        if self._fp is not None:
            self._fp.close()
            self._fp = None

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        self.close()

    def __getstate__(self):
        """Pickles to a reader that reopens the file at the same position
        (a closed one at the start): what a DataLoader worker needs."""
        d = dict(self.__dict__)
        d["_fp"] = None
        d["_pos"] = self.tell() if (not self.writable
                                    and self._fp is not None) else 0
        return d

    def __setstate__(self, d):
        pos = d.pop("_pos", 0)
        self.__dict__.update(d)
        self.open()
        if not self.writable:
            self._fp.seek(pos)

    def write(self, buf: bytes):
        if not self.writable:
            raise MXNetError("not opened for writing")
        self._fp.write(struct.pack("<II", _MAGIC, len(buf) & _LEN_MASK))
        self._fp.write(buf)
        pad = (-len(buf)) % 4
        if pad:
            self._fp.write(b"\x00" * pad)

    def read(self) -> Optional[bytes]:
        """The next record's payload; None at the end of the file."""
        if self.writable:
            raise MXNetError("not opened for reading")
        header = self._fp.read(8)
        if len(header) < 8:
            return None
        magic, clen = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise MXNetError(f"invalid record magic {magic:#x} in {self.uri}")
        length = clen & _LEN_MASK
        payload = self._fp.read(length)
        pad = (-length) % 4
        if pad:
            self._fp.read(pad)
        return payload

    def tell(self) -> int:
        return self._fp.tell()

    def seek(self, pos: int):
        if self.writable:
            raise MXNetError("seek is read-mode only")
        self._fp.seek(pos)


class IndexedRecordIO(MXRecordIO):
    """Random access through a ``.idx`` file of ``key<TAB>offset`` lines
    (parity: ``mx.recordio.MXIndexedRecordIO``); the writer writes it at
    ``close``."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx: Dict = {}
        self.keys: List = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if flag == "r" and os.path.exists(idx_path):
            with open(idx_path) as f:
                for line in f:
                    key, pos = line.strip().split("\t")
                    key = key_type(key)
                    self.idx[key] = int(pos)
                    self.keys.append(key)

    def close(self):
        if self.writable and self._fp is not None and self.idx:
            with open(self.idx_path, "w") as f:
                for key in self.keys:
                    f.write(f"{key}\t{self.idx[key]}\n")
        super().close()

    def read_idx(self, idx) -> bytes:
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf: bytes):
        pos = self._fp.tell()
        self.write(buf)
        self.idx[idx] = pos
        self.keys.append(idx)


MXIndexedRecordIO = IndexedRecordIO

IRHeader = collections.namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """A header and its payload as one record (parity:
    ``mx.recordio.pack``); a label array of n floats is written before the
    payload with ``flag = n``."""
    label = header.label
    if isinstance(label, (list, tuple, np.ndarray)):
        label_arr = np.asarray(label, np.float32)
        header = header._replace(flag=label_arr.size, label=0.0)
        s = label_arr.tobytes() + s
    return struct.pack(_IR_FORMAT, header.flag, float(header.label),
                       header.id, header.id2) + s


def unpack(s: bytes):
    """``(header, payload)`` of a record (parity: ``mx.recordio.unpack``)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    payload = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(payload, np.float32, header.flag)
        payload = payload[header.flag * 4:]
        header = header._replace(label=label)
    return header, payload


def pack_img(header: IRHeader, img: np.ndarray, quality=95,
             img_fmt=".jpg") -> bytes:
    """An image encoded into a record: cv2, else PIL, else the image's
    raw ``.npy`` bytes behind the ``NPY0`` tag."""
    return pack(header, _encode_img(img, quality, img_fmt))


def unpack_img(s: bytes, iscolor=1):
    """``(header, HWC uint8 image)`` of a record."""
    from ..image import decode_to_numpy
    header, payload = unpack(s)
    return header, decode_to_numpy(payload, flag=iscolor,
                                   to_rgb=bool(iscolor))


def _encode_img(img, quality, img_fmt):
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        ok, buf = cv2.imencode(img_fmt, img,
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise MXNetError("cv2.imencode failed")
        return buf.tobytes()
    bio = _io.BytesIO()
    try:
        from PIL import Image
    except ImportError:
        np.save(bio, np.asarray(img))
        return b"NPY0" + bio.getvalue()
    Image.fromarray(img).save(bio, format="JPEG", quality=quality)
    return bio.getvalue()
