"""Automatic mixed precision: the port of the JAX package's
``incubator_mxnet_tpu/amp/__init__.py``, the MXNet 1.x loop::

    amp.init()                      # bfloat16 (or "float16")
    trainer = gluon.Trainer(net.collect_params(), "sgd", {...})
    amp.init_trainer(trainer)
    with autograd.record():
        loss = loss_fn(net(x), y)
        with amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
    trainer.step(batch_size)

``init()`` wraps the ``OpSpec.fn`` of every op in ``lists`` in the
registry, the one table ``nd.<op>``, its aliases and gluon's
``F.<op>`` dispatch through: the float positional inputs of
``TARGET_DTYPE_OPS`` are cast to the AMP dtype and the result cast back
to the widest input float type (the JAX rule: an input sets ``widest``
when it is the first float or promotes with it to another type); the
bf16 / f16 inputs of ``FP32_OPS`` run in float32 and the result is cast
back. It is process-wide and idempotent; ``_deinit_for_tests()`` puts
every ``OpSpec.fn`` back. Call it before the first ``SPMDTrainer`` or
``FusedApplier`` capture: a CUDA graph keeps the ops it captured.

``init_trainer`` gives a Trainer a ``LossScaler`` (scale 1 for bfloat16,
2^16 for float16), which ``Trainer.step`` consumes: its fused guard
skips a non-finite step (parameters and optimizer state untouched) and
halves the scale, or counts a clean one. Without that guard (no fused
step, or ``guard=False``) it warns: overflow would never be seen.
``unscale`` is for a manual loop with the guard off.
"""

from __future__ import annotations

import functools
import warnings
from contextlib import contextmanager
from typing import Optional

import torch

from ..base import MXNetError
from ..ops import registry as _registry
from . import lists
from .loss_scaler import LossScaler

__all__ = ["init", "init_trainer", "scale_loss", "unscale", "convert_model",
           "convert_hybrid_block", "LossScaler"]

_initialized = False
_target_dtype: Optional[str] = None
_orig_fns = {}


def _is_float(x) -> bool:
    return torch.is_tensor(x) and x.is_floating_point()


def _cast_out(out, dtype):
    if isinstance(out, (tuple, list)):
        return type(out)(o.to(dtype) if _is_float(o) else o for o in out)
    return out.to(dtype) if _is_float(out) else out


def _wrap_target(fn, target):
    @functools.wraps(fn)
    def autocast(*args, **kwargs):
        widest = None
        cast_args = []
        for a in args:
            if _is_float(a):
                if widest is None or \
                        torch.promote_types(a.dtype, widest) != widest:
                    widest = a.dtype
                cast_args.append(a.to(target) if a.dtype != target else a)
            else:
                cast_args.append(a)
        out = fn(*cast_args, **kwargs)
        if widest is None or widest == target:
            return out
        return _cast_out(out, widest)

    return autocast


def _wrap_fp32(fn):
    @functools.wraps(fn)
    def force_fp32(*args, **kwargs):
        in_dtype = None
        cast_args = []
        for a in args:
            if _is_float(a) and a.dtype in (torch.bfloat16, torch.float16):
                in_dtype = a.dtype
                cast_args.append(a.to(torch.float32))
            else:
                cast_args.append(a)
        out = fn(*cast_args, **kwargs)
        return out if in_dtype is None else _cast_out(out, in_dtype)

    return force_fp32


def init(target_dtype: str = "bfloat16", target_precision_ops=None,
         fp32_ops=None, **_ignored) -> None:
    """Enable AMP process-wide (parity: ``amp.init``). Idempotent."""
    global _initialized, _target_dtype
    if _initialized:
        return
    if target_dtype not in ("bfloat16", "float16"):
        raise MXNetError("AMP target_dtype must be bfloat16 or float16 "
                         f"(got {target_dtype!r})")
    target = torch.bfloat16 if target_dtype == "bfloat16" else torch.float16
    target_ops = list(target_precision_ops or lists.TARGET_DTYPE_OPS)
    fp32 = list(fp32_ops or lists.FP32_OPS)
    for name in target_ops + fp32:
        if not _registry.exists(name):
            continue
        spec = _registry.get(name)
        if spec.name in _orig_fns:
            continue
        _orig_fns[spec.name] = spec.fn
        spec.fn = (_wrap_target(spec.fn, target) if name in target_ops
                   else _wrap_fp32(spec.fn))
    _initialized = True
    _target_dtype = target_dtype


def _deinit_for_tests() -> None:
    """Put back every op's original ``fn`` (the reference has no
    un-init)."""
    global _initialized, _target_dtype
    for name, fn in _orig_fns.items():
        _registry.get(name).fn = fn
    _orig_fns.clear()
    _initialized = False
    _target_dtype = None


def init_trainer(trainer) -> None:
    """Attach a dynamic loss scaler to a gluon Trainer (parity:
    ``amp.init_trainer``); ``Trainer.step`` consumes it. Do not also call
    ``unscale`` in that flow: the scale would be updated twice."""
    if not _initialized:
        raise MXNetError("call amp.init() before amp.init_trainer()")
    if getattr(trainer, "_fused", None) is None or \
            not trainer._fused.guard:
        warnings.warn(
            "amp.init_trainer on a Trainer without the fused in-step "
            "guard (fuse_step=False, a non-fusable optimizer, or "
            "guard=False) — overflow detection never fires and the "
            "dynamic loss scale will not adapt",
            UserWarning, stacklevel=2)
    trainer._amp_loss_scaler = LossScaler(
        init_scale=2. ** 16 if _target_dtype == "float16" else 1.)
    trainer._amp_original_scale = trainer._scale


@contextmanager
def scale_loss(loss, trainer):
    """The loss times the loss scale, for ``backward()``; the trainer
    divides the gradients back in its step (parity: ``amp.scale_loss``)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        raise MXNetError("trainer not AMP-initialised; call amp.init_trainer")
    trainer._scale = trainer._amp_original_scale / scaler.loss_scale
    if isinstance(loss, (list, tuple)):
        yield type(loss)(l * scaler.loss_scale for l in loss)
    else:
        yield loss * scaler.loss_scale


def unscale(trainer) -> bool:
    """Check the gradients for overflow and update the scale; True when
    the step should be skipped."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return False
    overflow = scaler.has_overflow(trainer._params)
    scaler.update_scale(overflow)
    return overflow


def convert_model(block, target_dtype: str = "bfloat16"):
    """Cast a trained model's parameters for low-precision inference
    (parity: ``amp.convert_model``)."""
    block.cast(target_dtype)
    return block


convert_hybrid_block = convert_model
