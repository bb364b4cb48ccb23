"""Build the port's CUDA kernels from ``csrc/`` on first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (``lib<name>.so``), loaded through
``ctypes``. All sources build in parallel, one ``nvcc`` each. Outputs go
to ``build/kernels/<hash>/`` at the root of the checkout (listed in
``.gitignore``), keyed by a hash of every source and the flags, so an
unchanged tree reuses its libraries and an edited one rebuilds.

Importing this module does nothing: a build starts only when a kernel is
requested on a CUDA tensor, so the CPU tests import it where there is no
``nvcc``. A failed build raises ``MXNetError`` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

from ..base import MXNetError

__all__ = ["KERNELS", "NVCC_FLAGS", "build", "load", "build_dir"]

KERNELS = ("ragged_decode", "ragged_prefill", "ragged_verify", "flash_fwd",
           "flash_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "--ptxas-options=-v")

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_ROOT = Path(__file__).resolve().parents[2]
_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise MXNetError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda): "
                     "the CUDA kernels cannot be built")


def build_dir() -> Path:
    """``build/kernels/<hash of csrc/* and the flags>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _ROOT / "build" / "kernels" / h.hexdigest()[:16]


def build(names=KERNELS) -> Dict[str, Tuple[float, str]]:
    """Compile every missing ``lib<name>.so`` in parallel; returns
    ``{name: (seconds, compiler output)}`` for the ones built (an empty
    dict when all were cached)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out_dir / f"lib{n}.so").is_file()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out_dir / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    results, failed = {}, []
    for n, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out_dir / f"lib{n}.so")
        (out_dir / f"{n}.log").write_text(log)
        results[n] = (secs, log)
    if failed:
        raise MXNetError("CUDA kernel build failed:\n" + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, building it first when missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if name not in KERNELS:
                raise MXNetError(f"unknown kernel library {name!r}")
            build((name,))
            lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
            lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mx_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib
