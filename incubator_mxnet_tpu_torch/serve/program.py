"""The serving engine's compiled-once programs.

The counterpart of the JAX engine's jitted programs
(``incubator_mxnet_tpu/serve/engine.py``): one ``StepProgram`` per
decode-family width (``_decode_step_fn``), per dense prefill bucket
(``_prefill_fn``), per prefill chunk bucket (``_chunk_prefill_fn``), and
one for the COW page copy (``_copy_page_fn``), each built lazily at its
first use. Its body reads only static buffers and writes only static
buffers:

  - ``inputs``: named typed fields packed into one byte buffer — on the
    host (pinned on a CUDA device) and its twin on the device, so one
    copy moves a step's inputs;
  - ``outputs``: the same on the way back, one copy per step.

On a CUDA device ``build`` warms the body up once on a side stream, over
ZEROED inputs (the caller's body must treat them as dead work: lengths,
prompt lengths and chunk spans 0, every write to the null page, a copy
of the null page onto itself), then captures it into one CUDA graph;
every later run is a copy in, one ``replay()`` and a copy out. On the
CPU the same object runs its body eagerly. A capture that fails raises
``MXNetError``: nothing falls back to running the body eagerly on the
card.

Launch accounting: the kernel wrappers count launches in Python
(``ops.ragged_attention.LAUNCHES`` and ``ops.flash_attention.LAUNCHES``),
which happens at capture only. ``GraphCapture.record`` keeps its
capture's count per kernel and restores the counters the capture touched;
the program restores those its warm-up touched, and adds the capture's
count to both counters on every replay (``add_launches``; ``replays``
counts them).

``GraphCapture`` is the mechanics ``parallel.SPMDTrainer``'s train step
shares: PyTorch's one capture stream, an eager run on it, the capture
with the block's random generators registered, and ``MXNetError`` on a
failed capture.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..ops import flash_attention, ragged_attention

__all__ = ["Packed", "StepProgram", "GraphCapture", "launch_counts",
           "add_launches"]

_ALIGN = 16
Field = Tuple[str, Tuple[int, ...], torch.dtype]
# every kernel wrapper's launch counter (kernel names are unique across)
_COUNTERS = (ragged_attention.LAUNCHES, flash_attention.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count so far, by kernel name."""
    return {k: n for c in _COUNTERS for k, n in c.items()}


def _set_launch_counts(counts: Dict[str, int]) -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = counts[k]


def add_launches(launches: Dict[str, int]) -> None:
    """Add a replayed capture's launches to the kernels' counters."""
    for c in _COUNTERS:
        for k in c:
            c[k] += launches.get(k, 0)


class Packed:
    """Named typed fields over one byte buffer on the host and one on
    ``device``: ``host[name]`` are numpy views to fill or read,
    ``dev[name]`` the device tensors the body uses. Fields start on
    16-byte boundaries."""

    def __init__(self, fields: Sequence[Field], device: torch.device):
        layout, n = [], 0
        for name, shape, dtype in fields:
            n = -(-n // _ALIGN) * _ALIGN
            nbytes = int(np.prod(shape, dtype=np.int64)) * \
                torch.empty((), dtype=dtype).element_size()
            layout.append((name, shape, dtype, n, nbytes))
            n += nbytes
        n = max(_ALIGN, -(-n // _ALIGN) * _ALIGN)
        self.host_bytes = torch.zeros(n, dtype=torch.uint8,
                                      pin_memory=device.type == "cuda")
        self.dev_bytes = torch.zeros(n, dtype=torch.uint8, device=device)
        raw = self.host_bytes.numpy()
        self.host: Dict[str, np.ndarray] = {}
        self.dev: Dict[str, torch.Tensor] = {}
        for name, shape, dtype, off, nbytes in layout:
            np_dtype = torch.empty((), dtype=dtype).numpy().dtype
            self.host[name] = raw[off:off + nbytes].view(np_dtype) \
                .reshape(shape)
            self.dev[name] = self.dev_bytes[off:off + nbytes] \
                .view(dtype).view(shape)


class StepProgram:
    """One program: ``body(inputs, outputs)`` over the device fields of
    two ``Packed`` buffers, built once (``build``) and run per use
    (``launch`` then ``read``, or ``run``). ``pool`` is the graph memory
    pool to share with the engine's other programs (CUDA only)."""

    def __init__(self, body: Callable[[dict, dict], None],
                 inputs: Sequence[Field], outputs: Sequence[Field],
                 device: torch.device, pool=None):
        self.body = body
        self.device = device
        self.inp = Packed(inputs, device)
        self.out = Packed(outputs, device)
        self.pool = pool
        self.built = False
        self.build_ms: Optional[float] = None
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self._graph = None

    def run_body(self):
        """The body once, eagerly, over the current device fields."""
        self.body(self.inp.dev, self.out.dev)

    def build(self):
        """Make the program runnable; idempotent. On a CUDA device: one
        warm-up of the body over zeroed inputs on the capture stream (so
        its cuBLAS workspace exists before the capture), then the
        capture; ``build_ms`` times both."""
        if self.built:
            return
        if self.device.type != "cuda":
            self.built = True
            return
        t0 = time.perf_counter()
        saved = launch_counts()
        try:
            torch.cuda.synchronize(self.device)
            self.inp.dev_bytes.zero_()
            cap = GraphCapture(self.device, self.pool)
            cap.eager(self.run_body)
        except RuntimeError as e:            # MXNetError included
            raise MXNetError(f"program capture failed: {e}") from e
        finally:
            _set_launch_counts(saved)
        self.launches = cap.record(self.run_body)
        self._graph = cap.graph
        self.built = True
        self.build_ms = (time.perf_counter() - t0) * 1e3

    def launch(self):
        """Copy the staged host inputs in and run the step: a replay on
        the card, the body on the CPU. Does not wait."""
        self.build()
        self.inp.dev_bytes.copy_(self.inp.host_bytes, non_blocking=True)
        if self._graph is None:
            self.run_body()
            return
        self._graph.replay()
        self.replays += 1
        add_launches(self.launches)

    def read(self) -> Dict[str, np.ndarray]:
        """The outputs, copied back in one transfer (this waits for the
        step); the returned views are overwritten by the next read."""
        self.out.host_bytes.copy_(self.out.dev_bytes)
        return self.out.host

    def run(self) -> Dict[str, np.ndarray]:
        self.launch()
        return self.read()


class GraphCapture:
    """One CUDA graph, captured on PyTorch's one process-wide capture
    stream (a new stream per capture would pin a cuBLAS workspace per
    stream for good) into ``pool``. ``generators`` are the CUDA
    ``torch.Generator``s the body draws from besides the default one
    (registered with the graph, so each replay draws from the
    generator's state at the replay and advances it as an eager run
    would). ``eager(fn)`` runs ``fn`` uncaptured on that stream;
    ``record(fn)`` captures it."""

    def __init__(self, device: torch.device, pool=None, generators=()):
        self.device = device
        self.generators = tuple(generators)
        self.graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            self.graph.register_generator_state(gen)
        self._capture = torch.cuda.graph(self.graph, pool=pool)

    def eager(self, fn: Callable) -> None:
        """``fn()`` once, uncaptured, on the capture stream, after the
        work queued on the current stream and before any queued later;
        waits for it."""
        current = torch.cuda.current_stream(self.device)
        side = self._capture.capture_stream
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)

    def record(self, fn: Callable) -> Dict[str, int]:
        """Capture ``fn()`` (nothing runs). Returns the launches the
        kernel wrappers counted during the capture and leaves their
        counters as they were; a failed capture raises ``MXNetError``."""
        saved = launch_counts()
        try:
            with self._capture:
                fn()
            torch.cuda.synchronize(self.device)
        except RuntimeError as e:            # MXNetError included
            self._close_generators()
            raise MXNetError(f"program capture failed: {e}") from e
        finally:
            counted = launch_counts()
            _set_launch_counts(saved)
        return {k: n - saved[k] for k, n in counted.items() if n != saved[k]}

    def _close_generators(self):
        """A capture that fails to end leaves its generators (the default
        one and those registered) in capture mode, refusing every later
        eager draw; a one-kernel capture with the same generators opens
        and closes that mode again."""
        scratch = torch.zeros((), device=self.device)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph):
            scratch.add_(1)
        torch.cuda.synchronize(self.device)
