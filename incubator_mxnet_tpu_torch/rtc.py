"""``mx.rtc``: runtime kernel compilation, refused: the port of the JAX
package's ``incubator_mxnet_tpu/rtc.py`` gate.

MXNet's ``mx.rtc.CudaModule`` compiles CUDA C at runtime (NVRTC). The
port's CUDA kernels are sources in the repository (``csrc/``), built by
``nvcc`` at first use through ``ops/_build.py``; compiling user CUDA
strings at runtime would be a feature the JAX package lacks, so
``CudaModule`` raises ``MXNetError`` as the JAX gate does."""

from __future__ import annotations

from .base import MXNetError

__all__ = ["CudaModule"]

_MSG = ("mx.rtc.CudaModule (runtime compilation of CUDA source strings) "
        "is not supported: write the kernel as a source under the "
        "package's csrc/ and build it with ops/_build.py (nvcc at first "
        "use, as the port's own kernels are), or register an op "
        "(incubator_mxnet_tpu_torch.ops.registry.register).")


class CudaModule:
    def __init__(self, *args, **kwargs):
        raise MXNetError(_MSG)
