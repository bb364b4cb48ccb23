"""gluon.contrib.rnn, experimental recurrent cells: the port of the JAX
package's ``incubator_mxnet_tpu/gluon/contrib/rnn.py`` (parity:
python/mxnet/gluon/contrib/rnn/: the Conv*RNN / LSTM / GRU cells,
LSTMPCell with a projected hidden state, VariationalDropoutCell).

Each cell is a step function over (input, states), unrolled by the core
cells' ``unroll``. The convolutional cells run the registry's
``Convolution`` (cuDNN on the card, IEEE f32 for f32 inputs).
"""

from __future__ import annotations

from ...base import MXNetError
from ..rnn.rnn_cell import RecurrentCell, ModifierCell
from ..block import HybridBlock

__all__ = ["Conv2DLSTMCell", "Conv2DGRUCell", "Conv2DRNNCell",
           "LSTMPCell", "VariationalDropoutCell"]


class _BaseConvCell(RecurrentCell):
    """Shared plumbing for convolutional recurrent cells.

    ``input_shape`` is (C, H, W); spatial dims are preserved (same-pad).
    Gate pre-activations are ``conv(x; Wi) + conv(h; Wh) + b``.
    """

    _gates = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if isinstance(i2h_kernel, int):
            i2h_kernel = (i2h_kernel, i2h_kernel)
        if isinstance(h2h_kernel, int):
            h2h_kernel = (h2h_kernel, h2h_kernel)
        if any(k % 2 == 0 for k in i2h_kernel) or \
                any(k % 2 == 0 for k in h2h_kernel):
            raise MXNetError("i2h_kernel and h2h_kernel must be odd for "
                             "same-padding (spatial dims are preserved)")
        self._input_shape = tuple(input_shape)
        self._channels = hidden_channels
        self._i2h_kernel = tuple(i2h_kernel)
        self._h2h_kernel = tuple(h2h_kernel)
        in_c = self._input_shape[0]
        G = self._gates
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight",
                shape=(G * hidden_channels, in_c) + self._i2h_kernel,
                init=i2h_weight_initializer)
            self.h2h_weight = self.params.get(
                "h2h_weight",
                shape=(G * hidden_channels, hidden_channels)
                + self._h2h_kernel,
                init=h2h_weight_initializer)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(G * hidden_channels,),
                init=i2h_bias_initializer)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(G * hidden_channels,),
                init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        shape = (batch_size, self._channels) + self._input_shape[1:]
        n = 2 if isinstance(self, Conv2DLSTMCell) else 1
        return [{"shape": shape, "__layout__": "NCHW"}] * n

    def _pre(self, F, x, h, i2h_weight, h2h_weight, i2h_bias, h2h_bias):
        G = self._gates
        ip = tuple(k // 2 for k in self._i2h_kernel)
        hp = tuple(k // 2 for k in self._h2h_kernel)
        gx = F.Convolution(x, i2h_weight, i2h_bias,
                           kernel=self._i2h_kernel, pad=ip,
                           num_filter=G * self._channels)
        gh = F.Convolution(h, h2h_weight, h2h_bias,
                           kernel=self._h2h_kernel, pad=hp,
                           num_filter=G * self._channels)
        return gx + gh


class Conv2DRNNCell(_BaseConvCell):
    """h' = act(conv(x) + conv(h)) (parity: contrib.rnn.Conv2DRNNCell)."""

    _gates = 1

    def __init__(self, input_shape, hidden_channels, activation="tanh",
                 **kwargs):
        super().__init__(input_shape, hidden_channels, **kwargs)
        self._activation = activation

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight=None,
                       h2h_weight=None, i2h_bias=None, h2h_bias=None):
        pre = self._pre(F, inputs, states[0], i2h_weight, h2h_weight,
                        i2h_bias, h2h_bias)
        out = F.Activation(pre, act_type=self._activation)
        return out, [out]


class Conv2DLSTMCell(_BaseConvCell):
    """ConvLSTM (Shi et al. 2015; parity: contrib.rnn.Conv2DLSTMCell).
    Gate order ``i, f, g, o`` matches the core LSTMCell."""

    _gates = 4

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight=None,
                       h2h_weight=None, i2h_bias=None, h2h_bias=None):
        h, c = states
        pre = self._pre(F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                        h2h_bias)
        i, f, g, o = F.split(pre, num_outputs=4, axis=1)
        i = F.sigmoid(i)
        f = F.sigmoid(f)
        g = F.tanh(g)
        o = F.sigmoid(o)
        c2 = f * c + i * g
        h2 = o * F.tanh(c2)
        return h2, [h2, c2]


class Conv2DGRUCell(_BaseConvCell):
    """ConvGRU, gate order ``r, z, n`` (parity: contrib.rnn.Conv2DGRUCell)."""

    _gates = 3

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight=None,
                       h2h_weight=None, i2h_bias=None, h2h_bias=None):
        h = states[0]
        G = self._gates
        ip = tuple(k // 2 for k in self._i2h_kernel)
        hp = tuple(k // 2 for k in self._h2h_kernel)
        gx = F.Convolution(inputs, i2h_weight, i2h_bias,
                           kernel=self._i2h_kernel, pad=ip,
                           num_filter=G * self._channels)
        gh = F.Convolution(h, h2h_weight, h2h_bias,
                           kernel=self._h2h_kernel, pad=hp,
                           num_filter=G * self._channels)
        xr, xz, xn = F.split(gx, num_outputs=3, axis=1)
        hr, hz, hn = F.split(gh, num_outputs=3, axis=1)
        r = F.sigmoid(xr + hr)
        z = F.sigmoid(xz + hz)
        n = F.tanh(xn + r * hn)
        out = (1.0 - z) * n + z * h
        return out, [out]


class LSTMPCell(RecurrentCell):
    """LSTM with a projection of the hidden state (LSTMP, Sak et al. 2014;
    parity: contrib.rnn.LSTMPCell). The cell state has ``hidden_size``
    units; the output/recurrent state is projected to ``projection_size``.
    """

    def __init__(self, hidden_size, projection_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(4 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(4 * hidden_size, projection_size),
                init=h2h_weight_initializer)
            self.h2r_weight = self.params.get(
                "h2r_weight", shape=(projection_size, hidden_size),
                init=h2r_weight_initializer)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(4 * hidden_size,),
                init=i2h_bias_initializer)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(4 * hidden_size,),
                init=h2h_bias_initializer)

    def infer_shape(self, inputs, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, inputs.shape[-1])

    def state_info(self, batch_size=0):
        return [
            {"shape": (batch_size, self._projection_size),
             "__layout__": "NC"},
            {"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
        ]

    def _alias(self):
        return "lstmp"

    def hybrid_forward(self, F, inputs, states, i2h_weight=None,
                       h2h_weight=None, h2r_weight=None, i2h_bias=None,
                       h2h_bias=None):
        r, c = states
        G = 4 * self._hidden_size
        gates = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                                 num_hidden=G) + \
            F.FullyConnected(r, h2h_weight, h2h_bias, num_hidden=G)
        i, f, g, o = F.split(gates, num_outputs=4, axis=-1)
        i = F.sigmoid(i)
        f = F.sigmoid(f)
        g = F.tanh(g)
        o = F.sigmoid(o)
        c2 = f * c + i * g
        h2 = o * F.tanh(c2)
        r2 = F.FullyConnected(h2, h2r_weight, None, no_bias=True,
                              num_hidden=self._projection_size)
        return r2, [r2, c2]


class VariationalDropoutCell(ModifierCell):
    """Same dropout mask reused at every time step (Gal & Ghahramani 2016;
    parity: contrib.rnn.VariationalDropoutCell). Masks are drawn once per
    unroll (``reset`` clears them) for inputs, states and outputs."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self._drop_inputs = drop_inputs
        self._drop_states = drop_states
        self._drop_outputs = drop_outputs
        self._input_mask = None
        self._state_masks = None
        self._output_mask = None

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_masks = None
        self._output_mask = None

    @staticmethod
    def _mask(like, p):
        from ... import ndarray as nd
        keep = 1.0 - p
        m = nd.random.uniform(0, 1, like.shape, ctx=like.context)
        # the mask in the activation dtype: an f32 mask would promote a
        # bf16 stream to f32 for the rest of the unroll
        return ((m < keep) / keep).astype(str(like.dtype))

    def forward(self, inputs, states):
        from ... import autograd
        if autograd.is_training():
            if self._drop_inputs > 0:
                if self._input_mask is None or \
                        self._input_mask.shape != inputs.shape:
                    self._input_mask = self._mask(inputs, self._drop_inputs)
                inputs = inputs * self._input_mask
            if self._drop_states > 0:
                if self._state_masks is None or any(
                        m.shape != s.shape
                        for m, s in zip(self._state_masks, states)):
                    self._state_masks = [self._mask(s, self._drop_states)
                                         for s in states]
                states = [s * m for s, m in zip(states, self._state_masks)]
        out, nstates = self.base_cell(inputs, states)
        if autograd.is_training() and self._drop_outputs > 0:
            if self._output_mask is None or \
                    self._output_mask.shape != out.shape:
                self._output_mask = self._mask(out, self._drop_outputs)
            out = out * self._output_mask
        return out, nstates
