"""The native RecordIO reader (``csrc/io/recordio_native.cc``) through
ctypes, and the g++ build of the port's C++ libraries.

The port of the JAX package's ``incubator_mxnet_tpu/io/_native.py``.
``lib()`` builds the library with ``g++`` at its first call into
``build/native/<hash>/`` at the root of the checkout (listed in
``.gitignore``), keyed by a hash of the source, the flags and the
libraries it links, as ``ops/_build.py`` builds the CUDA kernels: the
compiler writes a file of its own (named by process and thread) and
``os.replace`` moves it into place, so processes that build at once (the
test workers) each finish with a whole library. A library that does not
build (no compiler, no libjpeg headers) or is turned off by
``MXTPU_NO_NATIVE`` gives ``None``; ``build_error(name)`` says why. The
callers keep a Python path for that case.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["lib", "build_library", "build_error", "NativeRecordReader"]

CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_CSRC = Path(__file__).resolve().parents[1] / "csrc" / "io"
_ROOT = Path(__file__).resolve().parents[2]
_LOCK = threading.Lock()
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}
_ERRORS: Dict[str, str] = {}


def build_library(name: str, source: str,
                  libs: Sequence[str] = ()) -> Optional[ctypes.CDLL]:
    """``lib<name>.so`` from ``csrc/io/<source>``, built once per checkout
    and loaded once per process; None when it cannot be built or loaded
    (the reason in ``build_error(name)``)."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        _LIBS[name] = None
        if os.environ.get("MXTPU_NO_NATIVE"):
            _ERRORS[name] = "MXTPU_NO_NATIVE is set"
            return None
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            _ERRORS[name] = "no C++ compiler (g++) on PATH"
            return None
        src = _CSRC / source
        h = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS + tuple(libs))
                           .encode())
        h.update(src.read_bytes())
        out_dir = _ROOT / "build" / "native" / h.hexdigest()[:16]
        path = out_dir / f"lib{name}.so"
        if not path.is_file():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / (f"lib{name}.so.{os.getpid()}."
                             f"{threading.get_ident()}.tmp")
            cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(src), *libs]
            try:
                run = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                _ERRORS[name] = f"{' '.join(cmd)}: {e}"
                return None
            if run.returncode != 0:
                tmp.unlink(missing_ok=True)
                _ERRORS[name] = (f"{' '.join(cmd)} (exit {run.returncode}):"
                                 f"\n{run.stdout}{run.stderr}")
                return None
            os.replace(tmp, path)
        try:
            _LIBS[name] = ctypes.CDLL(str(path))
        except OSError as e:
            _ERRORS[name] = f"loading {path}: {e}"
        return _LIBS[name]


def build_error(name: str) -> Optional[str]:
    """Why ``lib<name>.so`` is not loaded (None when it is, or was never
    asked for)."""
    return _ERRORS.get(name) if _LIBS.get(name) is None else None


def lib() -> Optional[ctypes.CDLL]:
    """The RecordIO library with its signatures declared, or None."""
    lib_ = build_library("mxtpu_io", "recordio_native.cc")
    if lib_ is None or hasattr(lib_, "_declared"):
        return lib_
    c = ctypes
    lib_.mxtpu_rio_open.restype = c.c_void_p
    lib_.mxtpu_rio_open.argtypes = [c.c_char_p]
    lib_.mxtpu_rio_close.restype = None
    lib_.mxtpu_rio_close.argtypes = [c.c_void_p]
    lib_.mxtpu_rio_scan.restype = c.c_int64
    lib_.mxtpu_rio_scan.argtypes = [c.c_void_p]
    lib_.mxtpu_rio_count.restype = c.c_int64
    lib_.mxtpu_rio_count.argtypes = [c.c_void_p]
    lib_.mxtpu_rio_index.restype = c.c_int64
    lib_.mxtpu_rio_index.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                     c.c_int64]
    lib_.mxtpu_rio_read_at.restype = c.c_int64
    lib_.mxtpu_rio_read_at.argtypes = [c.c_void_p, c.c_int64, c.c_void_p,
                                       c.c_int64]
    lib_.mxtpu_rio_read_batch.restype = c.c_int64
    lib_.mxtpu_rio_read_batch.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_void_p, c.c_int64,
        c.c_void_p, c.c_int64]
    lib_._declared = True
    return lib_


class NativeRecordReader:
    """Random-access RecordIO reader over the native library: the file's
    records indexed by one scan, read by position (``read``) or many at a
    time on ``n_threads`` threads (``read_batch``). Raises ``RuntimeError``
    when the library is not there, ``OSError`` on a file it cannot read."""

    def __init__(self, path: str, n_threads: int = 4):
        lib_ = lib()
        if lib_ is None:
            raise RuntimeError(f"native RecordIO library unavailable: "
                               f"{build_error('mxtpu_io')}")
        self._lib = lib_
        self._path = path
        self._n_threads = max(1, int(n_threads))
        self._h = lib_.mxtpu_rio_open(os.fsencode(path))
        if not self._h:
            raise OSError(f"cannot open {path}")
        n = lib_.mxtpu_rio_scan(self._h)
        if n < 0:
            self.close()
            raise OSError(f"corrupt recordio file {path} (code {n})")
        self.offsets = np.empty(n, np.int64)
        self.lengths = np.empty(n, np.int64)
        lib_.mxtpu_rio_index(self._h, self.offsets.ctypes.data,
                             self.lengths.ctypes.data, n)

    def __len__(self):
        return len(self.offsets)

    def read(self, i: int) -> bytes:
        length = int(self.lengths[i])
        buf = ctypes.create_string_buffer(max(length, 1))
        got = self._lib.mxtpu_rio_read_at(self._h, int(self.offsets[i]),
                                          buf, length)
        if got != length:
            raise OSError(f"short read on record {i} (code {got})")
        return buf.raw[:length]

    def read_batch(self, indices) -> list:
        """The payloads of records ``indices``, in that order."""
        idx = np.asarray(indices, np.int64)
        if idx.size == 0:
            return []
        offs = np.ascontiguousarray(self.offsets[idx])
        total = int(self.lengths[idx].sum())
        out = ctypes.create_string_buffer(max(total, 1))
        lens = np.empty(len(idx), np.int64)
        got = self._lib.mxtpu_rio_read_batch(
            self._h, offs.ctypes.data, len(idx), out, total,
            lens.ctypes.data, self._n_threads)
        if got < 0:
            raise OSError(f"batch read failed (code {got})")
        raw = out.raw
        ends = np.cumsum(lens)
        return [raw[e - n:e] for n, e in zip(lens.tolist(), ends.tolist())]

    def close(self):
        if getattr(self, "_h", None):
            self._lib.mxtpu_rio_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def __getstate__(self):
        return {"path": self._path, "n_threads": self._n_threads}

    def __setstate__(self, d):
        self.__init__(d["path"], d["n_threads"])
