"""Fused RNN layers: the port of the JAX package's
``incubator_mxnet_tpu/gluon/rnn/rnn_layer.py``.

Each layer owns per-(layer, direction) parameters under the JAX names
(``{l,r}{layer}_{i2h,h2h}_{weight,bias}``) and concatenates them, all
weights then all biases, into the flat vector the fused ``RNN`` op
consumes (``ops/rnn.py``: cuDNN's RNN on the card), as MXNet 1.x's layer
does before calling its cuDNN op.
"""

from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


class _RNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers=1, layout="TNC",
                 dropout=0.0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"invalid layout {layout!r}; expected TNC or NTC")
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = _GATES[mode]
        G, H = self._gates, hidden_size
        self._param_names = []
        with self.name_scope():
            for layer in range(num_layers):
                in_sz = input_size if layer == 0 else H * self._dir
                for d in range(self._dir):
                    tag = f"{'lr'[d]}{layer}"
                    names = [f"{tag}_i2h_weight", f"{tag}_h2h_weight",
                             f"{tag}_i2h_bias", f"{tag}_h2h_bias"]
                    shapes = [(G * H, in_sz), (G * H, H), (G * H,), (G * H,)]
                    inits = [i2h_weight_initializer, h2h_weight_initializer,
                             i2h_bias_initializer, h2h_bias_initializer]
                    for n, s, i in zip(names, shapes, inits):
                        p = self.params.get(n, shape=s, init=i,
                                            allow_deferred_init=True)
                        setattr(self, n, p)
                    self._param_names.append(names)

    def infer_shape(self, x, *args):
        in_sz = x.shape[2]  # the channel axis is last in TNC and NTC
        G, H = self._gates, self._hidden_size
        for idx, names in enumerate(self._param_names):
            layer = idx // self._dir
            layer_in = in_sz if layer == 0 else H * self._dir
            getattr(self, names[0]).shape = (G * H, layer_in)

    def state_info(self, batch_size=0):
        infos = [{"shape": (self._num_layers * self._dir, batch_size,
                            self._hidden_size), "__layout__": "LNC"}]
        if self._mode == "lstm":
            infos.append(dict(infos[0]))
        return infos

    def begin_state(self, batch_size=0, func=None, **kwargs):
        from ... import ndarray as nd
        func = func or nd.zeros
        return [func(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def hybrid_forward(self, F, inputs, states=None, **params):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        batch = inputs.shape[1]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch, dtype=inputs.dtype,
                                      ctx=getattr(inputs, "context", None))
        if not isinstance(states, (list, tuple)):
            states = [states]

        # pack: all weights (layer-major, direction-minor), then all biases
        # (the layout ops/rnn.py documents)
        flat = []
        for names in self._param_names:
            flat.append(F.reshape(params[names[0]], shape=(-1,)))
            flat.append(F.reshape(params[names[1]], shape=(-1,)))
        for names in self._param_names:
            flat.append(params[names[2]])
            flat.append(params[names[3]])
        packed = F.concat(*flat, dim=0) if len(flat) > 1 else flat[0]

        out = F.RNN(inputs, packed, *states, state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=True)
        outputs, states_out = out[0], list(out[1:])
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        if skip_states:
            return outputs
        return outputs, states_out

    def __repr__(self):
        return (f"{type(self).__name__}({self._hidden_size}, "
                f"num_layers={self._num_layers}, layout={self._layout!r}, "
                f"bidirectional={self._dir == 2})")


class RNN(_RNNLayer):
    """Multi-layer Elman RNN with tanh / relu (parity: gluon.rnn.RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="tanh",
                 layout="TNC", **kwargs):
        mode = "rnn_relu" if activation == "relu" else "rnn_tanh"
        super().__init__(mode, hidden_size, num_layers, layout, **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer LSTM (parity: gluon.rnn.LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, **kwargs)


class GRU(_RNNLayer):
    """Multi-layer GRU (parity: gluon.rnn.GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, **kwargs)
