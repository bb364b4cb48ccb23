"""Training monitor: the port of the JAX package's
``incubator_mxnet_tpu/monitor.py`` (parity: ``python/mxnet/monitor.py``,
``mx.mon.Monitor``).

MXNet installs a stat callback on every executor output; here the
Monitor attaches forward hooks to a Gluon block tree and collects
``(batch, tensor_name, stat)`` rows. Between ``tic()`` and ``toc()`` the
captured outputs stay on the device (the hooks hold the arrays, nothing
is copied); ``toc()`` is the sync point, where each is read to the host
and ``stat_func`` (numpy; default mean |x|) runs on it."""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from .ndarray import NDArray

__all__ = ["Monitor"]


def _default_stat(arr: np.ndarray) -> np.ndarray:
    return np.abs(arr).mean(keepdims=True)


class Monitor:
    """Collect per-tensor statistics every ``interval`` batches
    (parity: mx.mon.Monitor)."""

    def __init__(self, interval: int = 1,
                 stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False):
        import re
        self.interval = max(1, interval)
        self.stat_func = stat_func or _default_stat
        self.re = re.compile(pattern)
        self.sort = sort
        self.activated = False
        self.step = 0
        self._pending: List[Tuple[int, str, NDArray]] = []
        self._installed = []

    # -- gluon ---------------------------------------------------------- #
    def install(self, block, name: str = ""):
        """Attach to a Block tree: records every sub-block's output."""

        def make_hook(path):
            def hook(blk, inputs, output):
                if not self.activated:
                    return
                outs = output if isinstance(output, (list, tuple)) \
                    else (output,)
                for i, o in enumerate(outs):
                    nm = f"{path}_output{i}" if len(outs) > 1 \
                        else f"{path}_output"
                    if isinstance(o, NDArray) and self.re.match(nm):
                        self._pending.append((self.step, nm, o))
            return hook

        def walk(blk, path):
            for cname, child in blk._children.items():
                p = f"{path}.{cname}" if path else cname
                child.register_forward_hook(make_hook(p))
                self._installed.append(p)
                walk(child, p)

        walk(block, name)
        return self

    # -- lifecycle (parity: tic/toc/toc_print) -------------------------- #
    def tic(self):
        if self.step % self.interval == 0:
            self.activated = True
            self._pending = []

    def toc(self) -> List[Tuple[int, str, np.ndarray]]:
        """Sync + compute stats for everything captured since tic()."""
        if not self.activated:
            self.step += 1
            return []
        self.activated = False
        rows = []
        for step, name, arr in self._pending:
            try:
                rows.append((step, name, self.stat_func(arr.asnumpy())))
            except Exception as e:  # stat functions are user code
                rows.append((step, name, np.asarray([float("nan")])))
        self._pending = []
        self.step += 1
        if self.sort:
            rows.sort(key=lambda r: r[1])
        return rows

    def toc_print(self):
        for step, name, stat in self.toc():
            print(f"Batch: {step:7d} {name:30s} "
                  f"{np.array2string(np.asarray(stat), precision=5)}")
