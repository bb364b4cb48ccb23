"""Runtime feature introspection: the port of the JAX package's
``incubator_mxnet_tpu/runtime.py``.

MXNet reports its compiled feature flags through ``mx.runtime.Features``.
The port's features are properties of the installation, probed when a
``Features`` is made: ``CUDA`` (a CUDA device is present), ``HOPPER``
(device 0 is compute capability 9.x, the ``sm_90a`` target of the
hand-written kernels), ``NVCC`` (the compiler the kernels build with) and
``TRITON``, where the JAX package reports ``TPU`` and ``PALLAS``.
"""

from __future__ import annotations

import importlib.util
from typing import Dict, List

import torch

__all__ = ["Feature", "Features", "feature_list", "is_enabled"]


class Feature:
    """One named capability flag (parity: ``mx.runtime.Feature``)."""

    def __init__(self, name: str, enabled: bool):
        self.name = name
        self.enabled = bool(enabled)

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _probe() -> Dict[str, bool]:
    from .ops import _build
    cuda = torch.cuda.is_available()
    hopper = cuda and torch.cuda.get_device_capability(0)[0] == 9
    try:
        _build._nvcc()
        nvcc = True
    except Exception:
        nvcc = False
    return {
        "CUDA": cuda,
        "HOPPER": hopper,
        "CPU": True,
        "NVCC": nvcc,
        "TRITON": importlib.util.find_spec("triton") is not None,
        "CUDA_GRAPHS": cuda,
        "DIST_KVSTORE": False,
        "INT64_TENSOR_SIZE": True,
        "PROFILER": True,
        "AMP": True,
    }


class Features:
    """Mapping of feature name -> ``Feature`` (parity:
    ``mx.runtime.Features``)."""

    def __init__(self):
        self._features = {k: Feature(k, v) for k, v in _probe().items()}

    def __getitem__(self, name: str) -> Feature:
        return self._features[name]

    def __contains__(self, name: str) -> bool:
        return name in self._features

    def keys(self):
        return self._features.keys()

    def values(self):
        return self._features.values()

    def is_enabled(self, name: str) -> bool:
        return self._features[name].enabled

    def __repr__(self):
        return ", ".join(repr(f) for f in self._features.values())


def feature_list() -> List[Feature]:
    return list(Features().values())


def is_enabled(name: str) -> bool:
    return Features().is_enabled(name)
