"""Auto-resume supervisor: run a training process to completion across
crashes, kills and hangs. The port of the JAX package's
``incubator_mxnet_tpu/train/supervisor.py`` (standard library only).

A checkpoint nobody restarts from is a tombstone. ``Supervisor`` closes
the loop for long preemptible runs: it launches the training command as
a child process and

  - **restarts on crash** (non-zero exit, or death by signal — a
    ``kill -9`` / OOM-kill / preemption): the training script restores
    from its latest committed checkpoint at startup
    (``CheckpointManager.restore()``), so a restart re-enters the run
    bit-exactly at the last commit;
  - **converts hangs into restarts**: a zero-progress wall-time
    watchdog (``hang_timeout_s``) watches a progress signal — a
    ``progress_file`` the training loop appends to, or the latest
    committed step under ``ckpt_dir`` — and SIGKILLs a child that
    stops advancing (a wedged collective, a dead data pipeline, a host
    stall);
  - **bounds the retries**: ``max_restarts`` total restarts with
    exponential backoff (``backoff_s`` doubling to ``backoff_max_s``);
    an attempt that made observable progress resets the backoff — a
    crash-loop is distinguished from an occasional preemption. Past
    the bound the supervisor gives up LOUDLY with the attempt history.

The supervisor never reads training state itself: process boundaries
are the fault isolation (a SIGKILL'd child cannot be observed from
inside). ``example_target`` is the deterministic child its end-to-end
check runs: killed twice mid-training, its per-step losses equal an
uninterrupted run's bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import time
from typing import List, Optional, Sequence

from ..base import MXNetError

__all__ = ["Supervisor", "SupervisorReport", "Attempt"]


@dataclasses.dataclass
class Attempt:
    """One child-process lifetime."""
    exit_code: Optional[int]      # None when hang-killed before exit
    term_signal: Optional[int]    # signal that killed the child, if any
    runtime_s: float
    reason: str                   # "completed" | "crash" | "hang_kill"
    progressed: bool              # progress signal advanced during it


@dataclasses.dataclass
class SupervisorReport:
    completed: bool
    restarts: int
    hang_kills: int
    attempts: List[Attempt]
    backoffs: List[float]         # scheduled sleep before each restart
    total_wall_s: float

    def summary(self) -> str:
        return (f"completed={self.completed} restarts={self.restarts} "
                f"hang_kills={self.hang_kills} "
                f"wall={self.total_wall_s:.2f}s attempts="
                + "; ".join(
                    f"[{a.reason} rc={a.exit_code} sig={a.term_signal} "
                    f"{a.runtime_s:.2f}s]" for a in self.attempts))


class Supervisor:
    """Run ``argv`` to completion across crashes.

    Parameters
    ----------
    argv : the training command (e.g. ``[sys.executable, "train.py"]``).
        Exit 0 is completion; anything else (including death by
        signal) is a crash to restart from.
    ckpt_dir : checkpoint root the child commits ``step_N`` dirs into —
        used as the default progress signal (latest committed step).
    progress_file : a file the training loop appends to (loss log,
        heartbeat); preferred progress signal when given (finer-grained
        than checkpoint commits).
    max_restarts : restart budget (crashes AND hang kills). 0 = run
        once, never restart.
    backoff_s / backoff_max_s : exponential restart backoff (doubles
        per consecutive unproductive attempt, reset by progress).
    hang_timeout_s : zero-progress wall-time watchdog; None disables.
    startup_grace_s : the FIRST watchdog deadline after each launch —
        a cold start (interpreter + device init + checkpoint restore +
        kernel builds and captures) makes no observable progress for a
        while and must not read as a hang, or the supervisor kill-loops
        healthy children on a loaded host. Default: max(30 s, 5x the hang
        timeout). Once the attempt shows progress the normal
        ``hang_timeout_s`` clock applies.
    env : extra environment for the child (merged over ``os.environ``).
    """

    def __init__(self, argv: Sequence[str], ckpt_dir: Optional[str] = None,
                 progress_file: Optional[str] = None,
                 max_restarts: int = 5, backoff_s: float = 0.5,
                 backoff_max_s: float = 30.0,
                 hang_timeout_s: Optional[float] = None,
                 startup_grace_s: Optional[float] = None,
                 poll_s: float = 0.05, env: Optional[dict] = None,
                 stdout=None, stderr=None, recorder=None,
                 postmortem_dir: Optional[str] = None):
        if hang_timeout_s is not None and \
                ckpt_dir is None and progress_file is None:
            raise MXNetError(
                "hang_timeout_s needs a progress signal: pass ckpt_dir "
                "and/or progress_file")
        self.argv = list(argv)
        self.ckpt_dir = ckpt_dir
        self.progress_file = progress_file
        self.max_restarts = int(max_restarts)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.hang_timeout_s = hang_timeout_s
        if startup_grace_s is None and hang_timeout_s is not None:
            startup_grace_s = max(30.0, 5.0 * hang_timeout_s)
        self.startup_grace_s = startup_grace_s
        self.poll_s = float(poll_s)
        self.env = dict(env or {})
        self.stdout = stdout
        self.stderr = stderr
        # flight recorder (events.py): every restart is an
        # event, and an exhausted budget dumps a postmortem naming the
        # supervised command — written next to the checkpoints by
        # default so the evidence survives the dead run
        from ..events import resolve_recorder
        self.flight = resolve_recorder(
            recorder, histograms=False,
            postmortem_dir=postmortem_dir or ckpt_dir)

    # ------------------------------------------------------------------ #
    def _progress_token(self):
        """A comparable snapshot of the progress signal; ``None`` when
        nothing observable exists yet (treated as 'no progress')."""
        if self.progress_file is not None:
            try:
                st = os.stat(self.progress_file)
                return ("file", st.st_mtime_ns, st.st_size)
            except OSError:
                return None
        if self.ckpt_dir is not None:
            from ..checkpoint import manifest as _manifest
            steps = _manifest.list_steps(self.ckpt_dir)
            return ("step", steps[-1]) if steps else None
        return None

    def _launch(self) -> subprocess.Popen:
        env = dict(os.environ)
        env.update(self.env)
        # own session/process group: a launcher-style command that
        # spawned workers must die as a TREE on a hang kill — a
        # SIGKILL'd wrapper alone leaks wedged grandchildren that keep
        # holding devices (and ticking the progress signal)
        return subprocess.Popen(self.argv, env=env,
                                stdout=self.stdout, stderr=self.stderr,
                                start_new_session=True)

    @staticmethod
    def _kill_tree(proc: subprocess.Popen) -> None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)  # pgid == pid (setsid)
        except (ProcessLookupError, PermissionError, OSError):
            proc.kill()

    # ------------------------------------------------------------------ #
    def run(self, raise_on_failure: bool = True) -> SupervisorReport:
        """Supervise until the child completes or the restart budget is
        exhausted. Returns the attempt history; with
        ``raise_on_failure`` (default) an exhausted budget raises
        ``MXNetError`` carrying the same history."""
        t_start = time.monotonic()
        attempts: List[Attempt] = []
        backoffs: List[float] = []
        restarts = 0
        hang_kills = 0
        backoff = self.backoff_s
        while True:
            t0 = time.monotonic()
            last_token = self._progress_token()
            last_change = t0
            progressed = False
            proc = self._launch()
            hang = False
            while proc.poll() is None:
                time.sleep(self.poll_s)
                if self.hang_timeout_s is None:
                    continue
                token = self._progress_token()
                now = time.monotonic()
                if token != last_token:
                    last_token = token
                    last_change = now
                    progressed = True
                    continue
                # a cold-starting attempt gets the startup grace; once
                # it has shown progress, the normal hang clock applies
                deadline = self.hang_timeout_s if progressed else \
                    max(self.hang_timeout_s, self.startup_grace_s or 0.0)
                if now - last_change > deadline:
                    # zero-progress watchdog: a hang becomes a restart
                    self._kill_tree(proc)
                    proc.wait()
                    hang = True
                    break
            rc = proc.returncode
            runtime = time.monotonic() - t0
            if not progressed and self._progress_token() != last_token:
                progressed = True
            if hang:
                hang_kills += 1
                attempts.append(Attempt(None, signal.SIGKILL, runtime,
                                        "hang_kill", progressed))
            elif rc == 0:
                attempts.append(Attempt(0, None, runtime, "completed",
                                        progressed))
                return SupervisorReport(
                    True, restarts, hang_kills, attempts, backoffs,
                    time.monotonic() - t_start)
            else:
                sig = -rc if rc is not None and rc < 0 else None
                attempts.append(Attempt(rc, sig, runtime, "crash",
                                        progressed))
            if progressed:
                backoff = self.backoff_s   # not a crash-loop: reset
            if restarts >= self.max_restarts:
                report = SupervisorReport(
                    False, restarts, hang_kills, attempts, backoffs,
                    time.monotonic() - t_start)
                from ..events import EventType
                self.flight.emit("supervisor",
                                 EventType.SUPERVISOR_GIVEUP,
                                 entity=self.argv[0],
                                 restarts=restarts,
                                 hang_kills=hang_kills)
                self.flight.postmortem(
                    "supervisor give-up", " ".join(self.argv)[:200],
                    context={"restarts": restarts,
                             "hang_kills": hang_kills,
                             "summary": report.summary()})
                if raise_on_failure:
                    raise MXNetError(
                        f"supervisor gave up after {restarts} restarts "
                        f"(max {self.max_restarts}): {report.summary()}")
                return report
            restarts += 1
            backoffs.append(backoff)
            from ..events import EventType
            last = attempts[-1]
            self.flight.emit("supervisor",
                             EventType.SUPERVISOR_RESTART,
                             entity=self.argv[0], restart=restarts,
                             reason=last.reason,
                             exit_code=last.exit_code,
                             term_signal=last.term_signal,
                             backoff_s=backoff,
                             progressed=last.progressed)
            time.sleep(backoff)
            backoff = min(backoff * 2.0, self.backoff_max_s)
