"""Training resilience of the PyTorch port: structured step outcomes,
the auto-resume supervisor and the seeded training chaos harness (the
port of ``incubator_mxnet_tpu/train``). The in-step non-finite guard and
dynamic loss scaling live where the steps live (``optimizer/fused.py``,
``gluon/trainer.py``, ``parallel/spmd.py``); ``example_target`` is the
deterministic child a ``Supervisor`` restarts.
"""

from .outcomes import StepOutcome, StepRecorder
from .supervisor import Attempt, Supervisor, SupervisorReport
from . import chaos
from .chaos import (KillSelf, NaNBatch, NaNGrad, OverflowStorm, SlowStep,
                    TrainChaosInjector, run_train_chaos)

__all__ = [
    "StepOutcome", "StepRecorder",
    "Supervisor", "SupervisorReport", "Attempt",
    "chaos", "TrainChaosInjector", "NaNGrad", "OverflowStorm",
    "NaNBatch", "SlowStep", "KillSelf", "run_train_chaos",
]
