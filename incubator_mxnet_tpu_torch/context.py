"""Device resolution: MXNet contexts as ``torch.device``.

Every entry point of the port runs on the card unless the caller asks
for the CPU: ``resolve_device(None)`` is ``gpu(0)``, and it raises
``MXNetError`` when no CUDA device is present instead of quietly
running on the host. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "resolve_device"]


def cpu(device_id: int = 0) -> torch.device:
    return torch.device("cpu")


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", int(device_id))


def resolve_device(device=None) -> torch.device:
    """``None`` -> the first GPU; a string or ``torch.device`` as given.
    A CUDA device that is not there raises ``MXNetError``."""
    dev = gpu(0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device: the port runs on the GPU by default — "
                "pass device='cpu' to run on the host")
        if dev.index is None:
            dev = gpu(torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise MXNetError(f"no CUDA device {dev.index} "
                             f"({torch.cuda.device_count()} present)")
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev}")
    return dev
