"""Device contexts: the port of the JAX package's
``incubator_mxnet_tpu/context.py``.

A ``Context`` names a device type and id, as MXNet's does; it resolves to
a ``torch.device`` (``Context.torch_device``). ``with ctx:`` pushes it as
the current context for the thread (``current_context``). The default is
``gpu(0)``: every entry point of the port runs on the card unless the
caller asks for the CPU, and a call that needs the default device raises
``MXNetError`` when no CUDA device is present instead of quietly running
on the host. Tests run under ``with mx.cpu():`` or pass ``device="cpu"``.

``tpu()`` raises ``MXNetError`` naming ``gpu()`` and ``num_tpus()`` is 0:
the port's accelerator is the CUDA device. ``gpu_memory_info`` reads
``torch.cuda.mem_get_info``.

``resolve_device`` turns ``None`` (the current context), a ``Context``, a
string or a ``torch.device`` into a checked ``torch.device``.
"""

from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context",
           "num_gpus", "num_devices", "gpu_memory_info", "num_tpus", "tpu",
           "resolve_device"]


class Context:
    """Device context holding a device type and id.

    ``device_type`` is one of 'cpu', 'gpu', 'cpu_pinned', 'cpu_shared'
    (the codes of MXNet's ``DeviceType`` enum); 'gpu' is a CUDA device."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared"}
    devstr2type = {v: k for k, v in devtype2str.items()}

    _default = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_id = device_type.device_id
            device_type = device_type.device_type
        if device_type not in Context.devstr2type:
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_typeid = Context.devstr2type[device_type]
        self.device_id = int(device_id)

    @property
    def device_type(self) -> str:
        return Context.devtype2str[self.device_typeid]

    device_typestr = device_type

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device``; a 'gpu' context that is not there raises
        ``MXNetError``."""
        if self.device_type == "gpu":
            return resolve_device(torch.device("cuda", self.device_id))
        return torch.device("cpu")

    def __eq__(self, other) -> bool:
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        if not hasattr(Context._default, "stack"):
            Context._default.stack = []
        Context._default.stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._default.stack.pop()

    def empty_cache(self):
        """Release the caching allocator's unused blocks (MXNet: the
        pooled GPU allocator's cache)."""
        if self.device_type == "gpu" and torch.cuda.is_available():
            torch.cuda.empty_cache()


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    return Context("cpu_pinned", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def num_devices() -> int:
    """The devices a context can name: the host and every CUDA device."""
    return 1 + num_gpus()


def gpu_memory_info(device_id: int = 0):
    """(free, total) bytes of CUDA device ``device_id`` (parity:
    ``mx.context.gpu_memory_info``, ``cudaMemGetInfo``)."""
    if not torch.cuda.is_available():
        raise MXNetError("gpu_memory_info: no CUDA device")
    if not 0 <= device_id < torch.cuda.device_count():
        raise MXNetError(f"gpu_memory_info: device_id {device_id} out of "
                         f"range ({torch.cuda.device_count()} devices)")
    free, total = torch.cuda.mem_get_info(device_id)
    return int(free), int(total)


def num_tpus() -> int:
    """0: the port runs on CUDA devices (``gpu()``), never on a TPU."""
    return 0


def tpu(device_id: int = 0):
    """Refused: the port has no TPU context; its accelerator is
    ``gpu(device_id)`` (the JAX package's ``tpu()`` names its TPU)."""
    raise MXNetError(f"mx.tpu({device_id}): the PyTorch port runs on CUDA "
                     f"devices; use mx.gpu({device_id})")


def current_context() -> Context:
    """The context of the innermost ``with ctx:`` block, else ``gpu(0)``."""
    stack = getattr(Context._default, "stack", None)
    if stack:
        return stack[-1]
    return gpu(0)


def context_of(device) -> Context:
    """The ``Context`` of a ``torch.device``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return gpu(dev.index if dev.index is not None
                   else torch.cuda.current_device())
    return cpu(0)


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current context (``gpu(0)`` unless a ``with ctx:``
    block says otherwise); a ``Context``, string or ``torch.device`` as
    given. A CUDA device that is not there raises ``MXNetError``."""
    if device is None:
        device = current_context()
    if isinstance(device, Context):
        dev = torch.device("cuda", device.device_id) \
            if device.device_type == "gpu" else torch.device("cpu")
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device: the port runs on the GPU by default — "
                "run under `with mx.cpu():` or pass device='cpu' to run "
                "on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise MXNetError(f"no CUDA device {dev.index} "
                             f"({torch.cuda.device_count()} present)")
    elif dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev}")
    return dev
