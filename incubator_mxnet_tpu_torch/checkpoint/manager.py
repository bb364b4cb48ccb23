"""Async checkpoint manager: the port of the JAX package's
``incubator_mxnet_tpu/checkpoint/manager.py``.

The step loop's critical path pays ONLY the device-to-host gather of the
state tree; serialization and disk I/O run on a background writer
thread. The gather is two-phase: it issues a non-blocking copy of every
CUDA leaf into pinned host memory on the current stream (after the step
that wrote the state), then synchronizes once, so ``save`` returns only
when every copy has landed. The writer never reads a device tensor: the
next step's replay writes the parameters and the optimizer state in
place, and the snapshot must stay the state at the step it names. At
most ONE snapshot is in flight: ``save(step=N+1)`` gathers, then waits
for N's write if it has not finished yet. Pinned buffers are PyTorch's
cached host allocations, reused once a snapshot's write has dropped
them.

Commit is atomic (manifest.py) and GC keeps the last ``keep`` committed
steps. ``install_preemption_hook`` arms a SIGTERM handler that drains the
in-flight snapshot and writes a final synchronous one before the process
dies.

Transient IO errors are retried with bounded exponential backoff before
the error latches: ``MXTPU_CKPT_RETRY_ATTEMPTS`` (default 3) total
attempts, ``MXTPU_CKPT_RETRY_BACKOFF`` (default 0.1 s) base delay,
doubling per retry. ``MXTPU_CKPT_FAIL_WRITES=n`` fault-injects ``n``
transient failures (one per attempt) for tests.

Across the processes of a ``torch.distributed`` job every rank calls
``save`` with the same step: each writes its own shard file and manifest
piece (``process_index`` / ``process_count`` in it), a tree leaf given as
a ``ShardLeaf`` (an fsdp shard) is written with its index into the
global array, and a leaf a rank does not own is left out of its tree, so
each piece of global data is written once. ``_process_barrier`` is a
real barrier over a gloo group of the manager's own (made by every rank
at its first multi-process save; the writer thread's barriers never
interleave with the training collectives of the default group): before
the ranks write, before rank 0 commits and after the commit. Rank 0
alone collects old steps.
"""

from __future__ import annotations

import os
import signal
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError
from . import manifest as _manifest
from .capsule import (_as_tensor, bits_of, host_leaf, numpy_of_bits,
                      torch_dtype_name)

__all__ = ["CheckpointManager", "gather_tree", "ShardLeaf"]


def _full_index(shape):
    return [(0, int(s)) for s in shape]


class ShardLeaf:
    """A capsule leaf this rank holds one shard of: ``tensor`` is the
    shard, ``index`` its ``[(start, stop)]`` per dimension of the global
    ``shape``, ``spec`` the manifest's sharding string."""

    __slots__ = ("tensor", "index", "shape", "spec")

    def __init__(self, tensor, index, shape, spec):
        self.tensor = tensor
        self.index = [(int(a), int(b)) for a, b in index]
        self.shape = tuple(int(s) for s in shape)
        self.spec = spec


def gather_tree(tree: Dict[str, object]) -> Dict[str, dict]:
    """Device-to-host gather of a flat name -> leaf tree (tensors,
    ``NDArray``s, numpy arrays, scalars) into manifest entries, each leaf
    whole (``spec`` None). Phase 1 issues every CUDA leaf's copy into a
    pinned host buffer (non-blocking, on the current stream) and copies
    the host leaves; phase 2 synchronizes each device once. The returned
    arrays are the caller's own: no later write to a leaf reaches them."""
    entries: Dict[str, dict] = {}
    devices = set()
    for name, leaf in tree.items():          # phase 1: issue every copy
        shard = leaf if isinstance(leaf, ShardLeaf) else None
        t = _as_tensor(shard.tensor if shard is not None else leaf)
        if torch.is_tensor(t) and t.is_cuda:
            bits = bits_of(t)
            host = torch.empty(bits.shape, dtype=bits.dtype,
                               pin_memory=True)
            host.copy_(bits, non_blocking=True)
            devices.add(t.device)
            dtype, arr = torch_dtype_name(t.dtype), \
                numpy_of_bits(host, t.dtype)
        else:
            dtype, arr = host_leaf(t)
        if shard is not None:
            entries[name] = {"shape": shard.shape, "dtype": dtype,
                             "spec": shard.spec,
                             "shards": [(shard.index, arr)]}
            continue
        entries[name] = {"shape": tuple(int(s) for s in arr.shape),
                         "dtype": dtype, "spec": None,
                         "shards": [(_full_index(arr.shape), arr)]}
    for dev in devices:                      # phase 2: one wait a device
        torch.cuda.current_stream(dev).synchronize()
    return entries


class CheckpointManager:
    """Directory of committed ``step_<N>`` snapshots with async writes.

    Parameters
    ----------
    directory : checkpoint root (created if missing).
    keep : keep-last-k garbage collection after each commit (None/0 =
        keep everything).
    async_save : write snapshots on the background thread (default);
        ``False`` forces every save onto the critical path.
    recorder : the flight recorder (``events.py``) each commit lands on.

    ``last_gather_ms`` (the caller's critical path of the last ``save``)
    and ``last_write_ms`` (the last commit's write, on whichever thread
    ran it) time the two phases.
    """

    def __init__(self, directory: str, keep: Optional[int] = 3,
                 async_save: bool = True, recorder=None):
        self.directory = os.fspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep or 0
        self.async_save = async_save
        from ..events import resolve_recorder
        self.flight = resolve_recorder(recorder, histograms=False)
        # RLock: the SIGTERM handler runs on the main thread and may
        # interrupt save() inside its critical section; its drain (wait())
        # must be able to re-enter. Condition releases an RLock fully
        # across wait(), so the writer thread still makes progress.
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._pending: Optional[Tuple] = None   # (step, entries, meta)
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._sig_prev = None
        self.committed_steps = 0                # cumulative commits
        self.write_retries = 0                  # transient IO retries
        self.restore_fallbacks = 0              # corrupt-latest fallbacks
        self._injected_failures = 0             # MXTPU_CKPT_FAIL_WRITES
        self.last_gather_ms: Optional[float] = None
        self.last_write_ms: Optional[float] = None
        self._group = None          # the barrier group of a multi-rank job
        self._ranks = (0, 1)        # (process_index, process_count)

    # -- background writer -------------------------------------------- #
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="mxtpu-ckpt-writer")
            self._thread.start()

    def _writer_loop(self):
        try:
            # the background write loses scheduler contests against the
            # step loop's host thread instead of splitting them evenly
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 10)
        except (OSError, AttributeError):
            pass
        while True:
            with self._cv:
                while self._pending is None and not self._closed:
                    # bounded wait: a SIGTERM handler can interrupt save()
                    # between setting _pending and notify_all; the timeout
                    # turns that lost wakeup into at most a 200 ms stall
                    self._cv.wait(timeout=0.2)
                if self._pending is None and self._closed:
                    return
                job = self._pending
            try:
                self._write(*job)
            except BaseException as e:          # surfaced on next call
                with self._cv:
                    self._error = e
            finally:
                job = None      # the host buffers go back to their pool
                with self._cv:
                    self._pending = None
                    self._cv.notify_all()

    def _maybe_inject_write_failure(self):
        """``MXTPU_CKPT_FAIL_WRITES=n``: the first n write ATTEMPTS (not
        snapshots) raise a transient OSError."""
        budget = int(os.environ.get("MXTPU_CKPT_FAIL_WRITES", "0") or 0)
        with self._lock:
            if self._injected_failures >= budget:
                return
            self._injected_failures += 1
            count = self._injected_failures
        raise OSError(
            f"injected transient checkpoint write failure "
            f"({count}/{budget})")

    def _write(self, step, entries, meta):
        """One snapshot write with bounded exponential-backoff retry on
        transient IO errors (OSError); structural errors (MXNetError, e.g.
        the step already committed) are never retried."""
        attempts = max(1, int(os.environ.get(
            "MXTPU_CKPT_RETRY_ATTEMPTS", "3") or 3))
        backoff = float(os.environ.get(
            "MXTPU_CKPT_RETRY_BACKOFF", "0.1") or 0.1)
        for attempt in range(attempts):
            try:
                self._maybe_inject_write_failure()
                self._write_once(step, entries, meta)
                return
            except MXNetError:
                raise
            except OSError:
                if attempt + 1 >= attempts:
                    raise
                with self._lock:
                    self.write_retries += 1
                time.sleep(backoff * (2 ** attempt))

    def _write_once(self, step, entries, meta):
        t0 = time.perf_counter()
        index, count = self._ranks
        _manifest.write_step(self.directory, step, entries, meta=meta,
                             process_index=index, process_count=count,
                             sync_fn=self._process_barrier)
        with self._lock:
            self.committed_steps += 1
            self.last_write_ms = (time.perf_counter() - t0) * 1e3
        from ..events import EventType
        self.flight.emit("checkpoint", EventType.CHECKPOINT_COMMIT,
                         entity=self.directory, step=int(step),
                         preempted=bool(meta.get("preempted", False)))
        if self.keep and index == 0:
            _manifest.gc_steps(self.directory, self.keep)

    def _join_job(self):
        """At a save in a multi-process job: this rank's place, and (once,
        on every rank) the manager's barrier group."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            return
        self._ranks = (dist.get_rank(), dist.get_world_size())
        if self._group is None and self._ranks[1] > 1:
            self._group = dist.new_group(backend="gloo")

    def _process_barrier(self):
        """The cross-process barrier around a commit (nothing to wait for
        in one process)."""
        if self._group is not None:
            import torch.distributed as dist
            dist.barrier(group=self._group)

    def _raise_pending_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise MXNetError(
                f"background checkpoint write failed: {err!r}") from err

    # -- public API ---------------------------------------------------- #
    def save(self, step: int, tree: Dict[str, object],
             meta: Optional[dict] = None, block: bool = False) -> None:
        """Snapshot ``tree`` (flat name -> leaf) at ``step``.

        Gathers the state to the host on the caller thread (the only
        critical-path cost; every copy has landed when it returns), then
        hands the host arrays to the writer. With ``block=True`` (or
        ``async_save=False``) the write itself also runs here."""
        if self._closed:
            raise MXNetError("CheckpointManager is closed")
        self._join_job()
        t0 = time.perf_counter()
        entries = gather_tree(tree)
        self.last_gather_ms = (time.perf_counter() - t0) * 1e3
        meta = dict(meta or {})
        if not (self.async_save and not block):
            self.wait()
            self._write(step, entries, meta)
            self._raise_pending_error()
            return
        self._ensure_thread()
        with self._cv:
            while self._pending is not None:    # bound: one in flight
                self._cv.wait()
            self._raise_pending_error()
            self._pending = (step, entries, meta)
            self._cv.notify_all()

    def wait(self) -> None:
        """Drain the in-flight snapshot (no-op when idle)."""
        if self._thread is None:
            self._raise_pending_error()
            return
        with self._cv:
            while self._pending is not None:
                self._cv.wait()
        self._raise_pending_error()

    def all_steps(self) -> List[int]:
        return _manifest.list_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, fallback: bool = True
                ) -> Tuple[Dict[str, np.ndarray], dict]:
        """Load a committed step (default: latest) -> (arrays, meta);
        ``arrays`` is a ``manifest.HostArrays``.

        When the LATEST step turns out unreadable (a crc32 mismatch, a
        truncated or missing file, a damaged manifest) the restore walks
        back through the older committed steps, warning each time and
        naming the bad shard. ``fallback=False``, or an explicit ``step``,
        fails loudly instead."""
        if step is not None:
            return _manifest.load_step(self.directory, step)
        steps = self.all_steps()
        if not steps:
            raise MXNetError(
                f"no committed checkpoint under {self.directory}")
        if not fallback:
            return _manifest.load_step(self.directory, steps[-1])
        last_err: Optional[BaseException] = None
        for s in reversed(steps):
            try:
                out = _manifest.load_step(self.directory, s)
            # MXNetError: crc / truncation / coverage; a corrupt manifest
            # raises ValueError (JSONDecodeError) or KeyError, an
            # unreadable file OSError — all mean "this step is damaged"
            except (MXNetError, OSError, ValueError, KeyError) as e:
                warnings.warn(
                    f"checkpoint step {s} is unreadable ({e}); falling "
                    f"back to the previous committed step",
                    RuntimeWarning, stacklevel=2)
                self.restore_fallbacks += 1
                last_err = e
                continue
            if s != steps[-1]:
                warnings.warn(
                    f"restored checkpoint step {s} instead of latest "
                    f"step {steps[-1]} — newer step(s) were corrupt",
                    RuntimeWarning, stacklevel=2)
            return out
        raise MXNetError(
            f"every committed checkpoint under {self.directory} "
            f"({steps}) is unreadable; last error: {last_err}"
        ) from last_err

    def close(self):
        """Drain and shut down. Raises a latched background-write error
        rather than swallowing it."""
        try:
            self.wait()
        finally:
            with self._cv:
                self._closed = True
                self._cv.notify_all()
            if self._thread is not None:
                self._thread.join(timeout=30)
            self.uninstall_preemption_hook()

    # -- preemption ---------------------------------------------------- #
    def install_preemption_hook(self, state_fn: Callable[[], Tuple],
                                exit_after: bool = True):
        """Arm SIGTERM: drain the in-flight snapshot, then write a final
        SYNCHRONOUS one from ``state_fn() -> (step, tree, meta)``.

        With ``exit_after`` the previous SIGTERM disposition is re-raised
        once the final snapshot is committed (the process still dies, with
        no work lost since the last commit); ``exit_after=False`` lets a
        test observe the drain in-process. Main thread only."""
        manager = self

        def _handler(signum, frame):
            manager.drain_and_save_final(state_fn)
            if exit_after:
                prev = manager.uninstall_preemption_hook()
                if callable(prev):
                    prev(signum, frame)
                elif prev == signal.SIG_IGN:
                    pass        # the process had opted to survive TERM
                else:
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

        self._sig_prev = signal.signal(signal.SIGTERM, _handler)
        return _handler

    def uninstall_preemption_hook(self):
        prev, self._sig_prev = self._sig_prev, None
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        return prev

    def drain_and_save_final(self, state_fn: Callable[[], Tuple]):
        """The preemption sequence, callable directly: drain, then one
        blocking snapshot. Skips if that step is already on disk (e.g.
        SIGTERM lands right after a periodic save)."""
        self.wait()
        step, tree, meta = state_fn()
        if step in self.all_steps():
            return
        meta = dict(meta or {})
        meta["preempted"] = True
        self.save(int(step), tree, meta=meta, block=True)
