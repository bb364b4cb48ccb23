"""Dynamic loss scaler: the port of the JAX package's
``incubator_mxnet_tpu/amp/loss_scaler.py``.

Used for float16 AMP; bfloat16 has f32's exponent range and normally runs
with ``loss_scale=1``. The scaler still works, so the fp16 contract holds.
"""

from __future__ import annotations

import torch

__all__ = ["LossScaler"]


class LossScaler:
    """Dynamic loss scaling: multiply the loss by ``loss_scale`` before
    backward; after backward, check gradients for inf/nan — on overflow skip
    the update and halve the scale, otherwise grow the scale 2x every
    ``scale_window`` clean steps (the reference's exact policy)."""

    def __init__(self, init_scale: float = 2. ** 16, scale_factor: float = 2.,
                 scale_window: int = 2000, tolerance: float = 0.):
        self.loss_scale = float(init_scale)
        self._scale_factor = float(scale_factor)
        self._scale_window = int(scale_window)
        self._unskipped = 0

    def has_overflow(self, params) -> bool:
        """True if any gradient (a tensor, or a parameter's ``.grad``)
        holds inf/nan; one small readback."""
        total = None
        for p in params:
            g = p.grad if isinstance(p, torch.nn.Parameter) else p
            if g is None:
                continue
            bad = torch.logical_not(torch.isfinite(g)).sum()
            total = bad if total is None else total + bad
        if total is None:
            return False
        return bool(total.item() > 0)

    def update_scale(self, overflow: bool) -> None:
        if overflow:
            self.loss_scale = max(1., self.loss_scale / self._scale_factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0

    def state_dict(self) -> dict:
        """Scale and clean-step streak, so a resumed run re-enters the
        same scaler trajectory."""
        return {"loss_scale": float(self.loss_scale),
                "scale_factor": float(self._scale_factor),
                "scale_window": int(self._scale_window),
                "unskipped": int(self._unskipped)}

    def load_state_dict(self, state: dict) -> None:
        self.loss_scale = float(state["loss_scale"])
        self._scale_factor = float(
            state.get("scale_factor", self._scale_factor))
        self._scale_window = int(
            state.get("scale_window", self._scale_window))
        self._unskipped = int(state.get("unskipped", 0))
