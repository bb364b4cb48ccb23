"""The fused recurrent op (RNN / LSTM / GRU): the port of the JAX
package's ``incubator_mxnet_tpu/ops/rnn.py``.

The flat parameter vector keeps the JAX package's documented layout
(cuDNN's canonical order, as MXNet 1.x's ``RNN`` op packs it):

  for layer in layers:            # all weights first ...
    for direction in directions:
      W_i2h (G*H, in)  then  W_h2h (G*H, H)
  for layer in layers:            # ... then all biases
    for direction in directions:
      b_i2h (G*H,)  then  b_h2h (G*H,)

Gate order: LSTM ``i, f, g, o``; GRU ``r, z, n`` with ``b_hn`` inside
``r * (...)``. These are ``torch._VF``'s weight lists and gate orders, so
``_unpack``'s views of the one flat tensor go to ``torch._VF.<mode>``
as they are (autograd gives the flat vector its gradient). The JAX op is
a ``lax.scan`` outside any Pallas kernel; here each layer is one
``torch._VF`` call: cuDNN's RNN on the card (as MXNet 1.x's GPU path
calls it), ATen's on the CPU. cuDNN copies a layer's weights into its
packed buffer on every call where the views are not laid out as that
buffer (the biases lie after every layer's weights, so only a
single-layer, one-direction vector is), and PyTorch warns that it does.

A CUDA f32 layer runs its forward and its backward with cuDNN's RNN math
set to IEEE f32 (cuDNN would take TF32 by default): each layer is one
``torch.autograd.Function`` that runs the ``_VF`` call on detached
inputs with the setting in force, and its backward differentiates that
inner graph with the setting in force again (the backward reads cuDNN's
settings when it runs, as ``ops.nn._Convolution``'s does).

Inter-layer dropout ``p`` (every layer but the last, training only) is
inverted dropout drawn from ``mx.random``'s generator for the input's
device (the ``generator=`` the front end passes, in place of the JAX
op's key), never cuDNN's dropout state: that state is not
``mx.random``'s and a CUDA graph cannot replay it.
"""

from __future__ import annotations

import contextlib

import torch

from .nn import dropout as _dropout
from .registry import register

__all__ = ["rnn", "rnn_param_size"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(num_layers, input_size, state_size, mode,
                   bidirectional=False, projection_size=None):
    """Total length of the flat parameter vector (parity:
    ``rnn_param_size`` in src/operator/rnn-inl.h)."""
    if projection_size is not None:
        raise NotImplementedError(
            "projected LSTM (LSTMP) is not supported; the flat layout here "
            "has no projection weights")
    gates = _GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        size += dirs * gates * state_size * (in_sz + state_size + 2)
    return size


def _unpack(params, num_layers, input_size, state_size, mode, dirs):
    """Views of the flat vector: ``weights[layer][d] = (W_i2h, W_h2h)``,
    ``biases[layer][d] = (b_i2h, b_h2h)``."""
    G, H = _GATES[mode], state_size
    weights, biases = [], []
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else H * dirs
        per_dir = []
        for _ in range(dirs):
            w_i2h = params[off:off + G * H * in_sz].view(G * H, in_sz)
            off += G * H * in_sz
            w_h2h = params[off:off + G * H * H].view(G * H, H)
            off += G * H * H
            per_dir.append((w_i2h, w_h2h))
        weights.append(per_dir)
    for layer in range(num_layers):
        per_dir = []
        for _ in range(dirs):
            per_dir.append((params[off:off + G * H],
                            params[off + G * H:off + 2 * G * H]))
            off += 2 * G * H
        biases.append(per_dir)
    return weights, biases


@contextlib.contextmanager
def _ieee_fp32(device):
    """cuDNN's f32 RNN math in IEEE f32 (not TF32) for the block, on a
    CUDA device; the setting in force before is restored after it."""
    if device.type != "cuda":
        yield
        return
    rnn_backend = torch.backends.cudnn.rnn
    old = rnn_backend.fp32_precision
    rnn_backend.fp32_precision = "ieee"
    try:
        yield
    finally:
        rnn_backend.fp32_precision = old


def _vf_layer(mode, bidirectional, train, x, h0, *rest):
    """One layer (both directions) through ``torch._VF``: ``rest`` is
    ``(c0, *weights)`` for an LSTM, else the weights; returns
    ``(out, h_n)`` or ``(out, h_n, c_n)``."""
    if mode == "lstm":
        return tuple(torch._VF.lstm(x, (h0, rest[0]), list(rest[1:]), True,
                                    1, 0.0, train, bidirectional, False))
    return tuple(getattr(torch._VF, mode)(x, h0, list(rest), True, 1, 0.0,
                                          train, bidirectional, False))


class _Layer(torch.autograd.Function):
    """One ``_vf_layer`` whose forward and backward both run under
    ``_ieee_fp32``: the forward records the ``_VF`` call on detached
    inputs, the backward differentiates that record."""

    @staticmethod
    def forward(ctx, mode, bidirectional, *inputs):
        leaves = [t.detach().requires_grad_(t.requires_grad) for t in inputs]
        with torch.enable_grad(), _ieee_fp32(inputs[0].device):
            outs = _vf_layer(mode, bidirectional, True, *leaves)
        ctx.inner = (outs, leaves)
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        outs, leaves = ctx.inner
        del ctx.inner
        wanted = [t for t in leaves if t.requires_grad]
        with _ieee_fp32(leaves[0].device):
            got = iter(torch.autograd.grad(outs, wanted, grads,
                                           allow_unused=True))
        return (None, None) + tuple(next(got) if t.requires_grad else None
                                    for t in leaves)


def _layer(mode, bidirectional, inputs):
    """``inputs`` = ``[x, h0, (c0), *weights]``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _Layer.apply(mode, bidirectional, *inputs)
    with _ieee_fp32(inputs[0].device):
        return _vf_layer(mode, bidirectional, False, *inputs)


def _rnn_num_outputs(attrs):
    if not attrs.get("state_outputs"):
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


@register("RNN", aliases=("rnn",), num_outputs=_rnn_num_outputs,
          needs_key=True, training_aware=True)
def rnn(data, parameters, state, state_cell=None, *, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=False, projection_size=None, generator=None,
        training=None):
    """Fused multi-layer recurrence (reference: the ``RNN`` op,
    src/operator/rnn.cc). ``data`` is TNC ``(T, B, input)``;
    ``parameters`` the flat vector (layout in the module docstring);
    ``state`` ``(L*dirs, B, H)``; ``state_cell`` the same (LSTM only).

    Returns ``output (T, B, dirs*H)`` or, with ``state_outputs=True``,
    ``(output, state_n[, state_cell_n])``. Inter-layer dropout ``p``
    applies to each layer's output but the last, in training, drawn
    from ``generator``."""
    if state_size is None or mode not in _GATES:
        raise ValueError("RNN requires state_size and a valid mode")
    if projection_size is not None:
        raise NotImplementedError("projected LSTM (LSTMP) is not supported")
    T, B, input_size = data.shape
    dirs = 2 if bidirectional else 1
    weights, biases = _unpack(parameters, num_layers, input_size,
                              state_size, mode, dirs)
    x = data
    h_n, c_n = [], []
    for layer in range(num_layers):
        flat = [t for d in range(dirs)
                for t in weights[layer][d] + biases[layer][d]]
        rows = slice(layer * dirs, (layer + 1) * dirs)
        cell = [state_cell[rows]] if mode == "lstm" else []
        outs = _layer(mode, bidirectional, [x, state[rows]] + cell + flat)
        x = outs[0]
        h_n.append(outs[1])
        if mode == "lstm":
            c_n.append(outs[2])
        if p > 0.0 and training and layer < num_layers - 1:
            x = _dropout(x, p=p, generator=generator, training=True)
    if not state_outputs:
        return x
    if mode == "lstm":
        return x, torch.cat(h_n), torch.cat(c_n)
    return x, torch.cat(h_n)
