"""Imperative autograd on ``torch.autograd``: the port of the JAX package's
``incubator_mxnet_tpu/autograd.py``.

MXNet records only inside ``record()``; PyTorch records whenever an input
requires grad. The port joins the two at the op: every ``mx.nd`` op runs
under ``torch.set_grad_enabled(is_recording())`` (``ndarray.register``),
so an op outside ``record()`` builds no graph, even on a parameter, and
``backward()`` on an unrecorded array raises ``MXNetError``.

A marked variable (``attach_grad``, ``mark_variables``, a gluon
``Parameter``) is a leaf tensor that requires grad, with a persistent
gradient buffer (an ``NDArray``). Its ``post_accumulate_grad`` hook runs
once per backward, when the leaf's gradient is final: it writes the
gradient into the buffer in place (``copy_`` for ``grad_req='write'``,
``add_`` for 'add', nothing for 'null'), marks the buffer fresh, drops
the leaf's ``.grad`` and fires the grad-ready hooks
(``register_grad_ready_hook``). The buffer is never rebound, so CUDA
graphs that read it by address stay valid.

``grad()`` is ``torch.autograd.grad`` (``create_graph=True`` returns
gradients that are themselves differentiable); ``Function`` is a
``torch.autograd.Function`` whose forward and backward run the user's
NDArray code with recording paused.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "mark_variables", "backward", "grad", "Function",
           "set_recording", "set_training", "register_grad_ready_hook",
           "remove_grad_ready_hook"]

_STATE = threading.local()
_GRAD_READY_HOOKS: Dict[int, object] = {}
_GRAD_HOOK_SEQ = [0]


def register_grad_ready_hook(fn) -> int:
    """Register ``fn(variable, grad_buffer)`` to run when a marked
    variable's gradient is final inside a backward (written into its
    buffer). Returns a handle for ``remove_grad_ready_hook``."""
    _GRAD_HOOK_SEQ[0] += 1
    handle = _GRAD_HOOK_SEQ[0]
    _GRAD_READY_HOOKS[handle] = fn
    return handle


def remove_grad_ready_hook(handle) -> None:
    _GRAD_READY_HOOKS.pop(handle, None)


def _st():
    if not hasattr(_STATE, "recording"):
        _STATE.recording = False
        _STATE.training = False
    return _STATE


def is_recording() -> bool:
    return _st().recording


def is_training() -> bool:
    return _st().training


def set_recording(is_record: bool) -> bool:
    st = _st()
    prev, st.recording = st.recording, bool(is_record)
    return prev


def set_training(train: bool) -> bool:
    st = _st()
    prev, st.training = st.training, bool(train)
    return prev


class _ModeScope:
    def __init__(self, recording, training):
        self._rec = recording
        self._train = training

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._rec is not None:
            st.recording = self._rec
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.training = self._prev


def record(train_mode: bool = True) -> _ModeScope:
    """Scope in which ops are recorded for differentiation."""
    return _ModeScope(recording=True, training=train_mode)


def pause(train_mode: bool = False) -> _ModeScope:
    """Scope in which ops are not recorded."""
    return _ModeScope(recording=False, training=train_mode)


def train_mode() -> _ModeScope:
    return _ModeScope(recording=None, training=True)


def predict_mode() -> _ModeScope:
    return _ModeScope(recording=None, training=False)


# --------------------------------------------------------------------- #
# marked variables
# --------------------------------------------------------------------- #
def _flush_hook(var_ref):
    """The post-accumulate hook of a marked leaf: the leaf's gradient is
    final; write it into the variable's buffer and fire the grad-ready
    hooks."""

    def hook(leaf):
        g = leaf.grad
        leaf.grad = None
        var = var_ref()
        # a leaf the variable no longer holds (rebound by a recorded
        # in-place op) still feeds the variable's buffer
        if var is None or g is None:
            return
        buf, req = var._ag_grad, var._ag_grad_req
        if buf is None or req == "null":
            return
        with torch.no_grad():
            if req == "add":
                buf._data.add_(g)
            else:
                buf._data.copy_(g)
        buf._fresh = True
        for fn in tuple(_GRAD_READY_HOOKS.values()):
            fn(var, buf)

    return hook


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to variables (parity:
    ``mx.autograd.mark_variables``). Each variable becomes a leaf that
    requires grad (its recorded history is cut) with a hook that writes
    its gradient into the buffer."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req!r}")
        t = var._data
        if not t.is_floating_point():
            raise MXNetError(f"cannot mark a {t.dtype} array as a "
                             f"variable: only floating arrays have "
                             f"gradients")
        if t.grad_fn is not None or not t.requires_grad:
            t = t.detach().requires_grad_(True)
            var._data = t
        if var._hooked is None or var._hooked() is not t:
            t.register_post_accumulate_grad_hook(
                _flush_hook(weakref.ref(var)))
            var._hooked = weakref.ref(t)
        var._ag_grad = g
        var._ag_grad_req = req


# --------------------------------------------------------------------- #
# backward / grad
# --------------------------------------------------------------------- #
def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    heads = list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray) or torch.is_tensor(head_grads):
        head_grads = [head_grads]
    if len(heads) != len(head_grads):
        raise MXNetError("heads and head_grads length mismatch")
    tensors, seeds = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            raise MXNetError(
                "head array is neither recorded nor a marked variable; "
                "did you forget autograd.record() or attach_grad()?")
        if hg is None:
            g = torch.ones_like(t)
        else:
            g = hg._data if isinstance(hg, NDArray) else torch.as_tensor(hg)
            g = g.to(device=t.device, dtype=t.dtype)
        tensors.append(t)
        seeds.append(g)
    return tensors, seeds


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Backward from ``heads``, writing every reached variable's gradient
    into its buffer (parity: ``MXAutogradBackwardEx``)."""
    tensors, seeds = _heads(heads, head_grads)
    with _ModeScope(recording=False, training=train_mode):
        try:
            torch.autograd.backward(tensors, seeds,
                                    retain_graph=retain_graph)
        except RuntimeError as e:
            raise MXNetError(f"backward failed: {e}") from e


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, leaving the
    variables' buffers untouched (parity: ``mx.autograd.grad``). With
    ``create_graph=True`` the gradients are recorded, so a later
    ``backward`` or ``grad`` differentiates them again."""
    from .ndarray.ndarray import NDArray
    if isinstance(variables, NDArray):
        variables = [variables]
    if retain_graph is None:
        retain_graph = create_graph
    tensors, seeds = _heads(heads, head_grads)
    inputs = [v._data for v in variables]
    with _ModeScope(recording=create_graph, training=train_mode):
        try:
            gs = torch.autograd.grad(tensors, inputs, seeds,
                                     retain_graph=retain_graph,
                                     create_graph=create_graph,
                                     allow_unused=True)
        except RuntimeError as e:
            raise MXNetError(f"grad failed: {e}") from e
    return [NDArray(torch.zeros_like(t) if g is None else g)
            for g, t in zip(gs, inputs)]


# --------------------------------------------------------------------- #
# user-defined functions
# --------------------------------------------------------------------- #
class _Bridge(torch.autograd.Function):
    """Runs a ``Function``'s NDArray forward and backward with recording
    paused, as one node of torch's graph."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        from .ndarray.ndarray import NDArray
        ctx.fn = fn
        ctx.n_in = len(tensors)
        with pause():
            outs = fn.forward(*[NDArray(t) for t in tensors])
        fn._single = not isinstance(outs, (list, tuple))
        outs = [outs] if fn._single else list(outs)
        # an output that aliases an input gets storage of its own
        return tuple(o._data.clone() if any(o._data is t for t in tensors)
                     else o._data for o in outs)

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray.ndarray import NDArray
        with pause():
            gs = ctx.fn.backward(*[NDArray(g) for g in out_grads])
        if not isinstance(gs, (list, tuple)):
            gs = [gs]
        if len(gs) != ctx.n_in:
            raise MXNetError(f"Function.backward returned {len(gs)} grads "
                             f"for {ctx.n_in} inputs")
        return (None,) + tuple(None if g is None else g._data for g in gs)


class Function:
    """User-defined differentiable function (parity:
    ``mx.autograd.Function``): subclass and implement ``forward(*inputs)``
    and ``backward(*output_grads)`` over NDArrays; recording is paused
    inside both."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        with torch.enable_grad():
            outs = _Bridge.apply(self, *[x._data for x in inputs])
        outs = [NDArray(o) for o in outs]
        return outs[0] if self._single else outs
