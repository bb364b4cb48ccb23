"""Training-step outcomes of the PyTorch port."""

from .outcomes import StepOutcome, StepRecorder

__all__ = ["StepOutcome", "StepRecorder"]
