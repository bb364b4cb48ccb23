"""Recurrent cells: the port of the JAX package's
``incubator_mxnet_tpu/gluon/rnn/rnn_cell.py`` (parity:
python/mxnet/gluon/rnn/rnn_cell.py).

Cells are single-step HybridBlocks: ``cell(input_t, states) ->
(output_t, new_states)``. ``unroll`` runs a fixed length as a Python loop
of the same cell; the fused ``rnn.LSTM`` / ``GRU`` / ``RNN`` layers
(rnn_layer.py, one cuDNN call a layer) are the path for long sequences.
Begin states and random masks are made on the input's device.
"""

from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "ZoneoutCell", "HybridSequentialRNNCell",
           "GRUCell", "SequentialRNNCell", "BidirectionalCell",
           "ResidualCell", "DropoutCell", "ModifierCell"]


class RecurrentCell(HybridBlock):
    """Base class (parity: gluon.rnn.RecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset step counters before a new unroll."""
        self._init_counter = -1
        self._counter = -1
        for child in self._children.values():
            if isinstance(child, RecurrentCell):
                child.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states (zeros by default), one per ``state_info`` entry."""
        from ... import ndarray as nd
        func = func or nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            shape = list(info["shape"])
            if shape[0] == 0:
                shape[0] = batch_size
            states.append(func(shape=tuple(shape), **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell ``length`` steps (parity: RecurrentCell.unroll).

        inputs: one array in ``layout`` or a length-``length`` list of
        (B, C) steps. Returns (outputs, states).
        """
        from ... import ndarray as nd
        self.reset()
        axis = layout.find("T")
        if not isinstance(inputs, (list, tuple)):
            batch = inputs.shape[layout.find("N")]
            steps = [nd.squeeze(s, axis=axis)
                     for s in nd.split(inputs, num_outputs=length, axis=axis)]
        else:
            steps = list(inputs)
            batch = steps[0].shape[0]
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch,
                                           dtype=steps[0].dtype,
                                           ctx=steps[0].context)
        states = begin_state
        outputs = []
        for t in range(length):
            out, states = self(steps[t], states)
            outputs.append(out)
        if valid_length is not None:
            stacked = nd.stack(*outputs, axis=axis)
            masked = nd.SequenceMask(stacked, sequence_length=valid_length,
                                     use_sequence_length=True,
                                     axis=axis)
            if merge_outputs is False:
                outputs = [nd.squeeze(s, axis=axis) for s in
                           nd.split(masked, num_outputs=length, axis=axis)]
            else:
                outputs = masked
        elif merge_outputs or merge_outputs is None:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


HybridRecurrentCell = RecurrentCell  # the reference distinguishes them


class _BaseGatedCell(RecurrentCell):
    """Shared param plumbing for RNN/LSTM/GRU cells."""

    _gates = 1

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        G = self._gates
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(G * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(G * hidden_size, hidden_size),
                init=h2h_weight_initializer)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(G * hidden_size,),
                init=i2h_bias_initializer)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(G * hidden_size,),
                init=h2h_bias_initializer)

    def infer_shape(self, inputs, *args):
        self.i2h_weight.shape = (self._gates * self._hidden_size,
                                 inputs.shape[-1])

    @property
    def hidden_size(self):
        return self._hidden_size


class RNNCell(_BaseGatedCell):
    """Elman cell: h' = act(W_x x + b_x + W_h h + b_h)
    (reference: rnn_cell.py RNNCell)."""

    _gates = 1

    def __init__(self, hidden_size, activation="tanh", **kwargs):
        super().__init__(hidden_size, **kwargs)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight=None,
                       h2h_weight=None, i2h_bias=None, h2h_bias=None):
        h = states[0]
        pre = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size) + \
            F.FullyConnected(h, h2h_weight, h2h_bias,
                             num_hidden=self._hidden_size)
        out = F.Activation(pre, act_type=self._activation)
        return out, [out]


class LSTMCell(_BaseGatedCell):
    """LSTM cell, gate order ``i, f, g, o`` (reference: rnn_cell.py
    LSTMCell; same order as the fused op — ops/rnn.py)."""

    _gates = 4

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight=None,
                       h2h_weight=None, i2h_bias=None, h2h_bias=None):
        h, c = states
        G = 4 * self._hidden_size
        gates = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=G) \
            + F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=G)
        i, f, g, o = F.split(gates, num_outputs=4, axis=-1)
        i = F.sigmoid(i)
        f = F.sigmoid(f)
        g = F.tanh(g)
        o = F.sigmoid(o)
        c2 = f * c + i * g
        h2 = o * F.tanh(c2)
        return h2, [h2, c2]


class GRUCell(_BaseGatedCell):
    """GRU cell, gate order ``r, z, n`` (reference: rnn_cell.py GRUCell)."""

    _gates = 3

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight=None,
                       h2h_weight=None, i2h_bias=None, h2h_bias=None):
        h = states[0]
        G = 3 * self._hidden_size
        gx = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=G)
        gh = F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=G)
        xr, xz, xn = F.split(gx, num_outputs=3, axis=-1)
        hr, hz, hn = F.split(gh, num_outputs=3, axis=-1)
        r = F.sigmoid(xr + hr)
        z = F.sigmoid(xz + hz)
        n = F.tanh(xn + r * hn)
        h2 = (1.0 - z) * n + z * h
        return h2, [h2]


class SequentialRNNCell(RecurrentCell):
    """Stack of cells applied in sequence each step
    (parity: SequentialRNNCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        infos = []
        for cell in self._children.values():
            infos.extend(cell.state_info(batch_size))
        return infos

    def begin_state(self, batch_size=0, func=None, **kwargs):
        states = []
        for cell in self._children.values():
            states.extend(cell.begin_state(batch_size=batch_size, func=func,
                                           **kwargs))
        return states

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def forward(self, inputs, states):
        next_states = []
        pos = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            inputs, sub = cell(inputs, states[pos:pos + n])
            pos += n
            next_states.extend(sub)
        return inputs, next_states


class ModifierCell(RecurrentCell):
    """Wraps a cell, reusing its parameters (parity: ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__(prefix=None, params=None)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return self.base_cell.begin_state(batch_size=batch_size, func=func,
                                          **kwargs)


class ResidualCell(ModifierCell):
    """output = cell(input) + input (parity: ResidualCell)."""

    def forward(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout regularization: each step keeps the PREVIOUS state with
    probability ``zoneout_states`` (and the previous output with
    ``zoneout_outputs``) instead of the new one (parity: ZoneoutCell;
    Krueger et al. 2017). Training-mode gated like Dropout; at
    inference the cell is a passthrough (the reference's
    Dropout-generated mask becomes all-ones)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def forward(self, inputs, states):
        from ... import autograd as _ag
        from ... import ndarray as _nd

        out, next_states = self.base_cell(inputs, states)

        def _mix(p, new, old):
            # train/predict-mode gating matches Dropout (is_training,
            # not is_recording); inference is an identity passthrough
            if p == 0.0 or old is None or not _ag.is_training():
                return new
            mask = _nd.random.uniform(0.0, 1.0, shape=new.shape,
                                      ctx=new.context) < p
            return _nd.where(mask, old, new)

        prev_out = self._prev_output
        if prev_out is None:
            prev_out = _nd.zeros_like(out)
        out = _mix(self._zo, out, prev_out)
        next_states = [_mix(self._zs, ns, s)
                       for ns, s in zip(next_states, states)]
        self._prev_output = out
        return out, next_states


class DropoutCell(RecurrentCell):
    """Applies dropout to the input each step (parity: DropoutCell)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class BidirectionalCell(RecurrentCell):
    """Runs two cells over the sequence in opposite directions; only
    usable via ``unroll`` (parity: BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix=None, params=None)
        self.l_cell = l_cell
        self.r_cell = r_cell
        self._output_prefix = output_prefix

    def state_info(self, batch_size=0):
        return self.l_cell.state_info(batch_size) + \
            self.r_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return self.l_cell.begin_state(batch_size=batch_size, func=func,
                                       **kwargs) + \
            self.r_cell.begin_state(batch_size=batch_size, func=func,
                                    **kwargs)

    def forward(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll()")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as nd
        self.reset()
        axis = layout.find("T")
        if not isinstance(inputs, (list, tuple)):
            batch = inputs.shape[layout.find("N")]
            steps = [nd.squeeze(s, axis=axis)
                     for s in nd.split(inputs, num_outputs=length, axis=axis)]
        else:
            steps = list(inputs)
            batch = steps[0].shape[0]
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch,
                                           dtype=steps[0].dtype,
                                           ctx=steps[0].context)
        nl = len(self.l_cell.state_info())
        l_out, l_states = self.l_cell.unroll(
            length, steps, begin_state[:nl], layout="NTC",
            merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            rev_steps = list(reversed(steps))
        else:
            # length-aware reversal so the backward cell sees each
            # sequence's valid frames first, not its padding (reference:
            # SequenceReverse with use_sequence_length)
            stacked = nd.stack(*steps, axis=0)  # (T,B,C)
            rev = nd.SequenceReverse(stacked, sequence_length=valid_length,
                                     use_sequence_length=True)
            rev_steps = [nd.squeeze(s, axis=0) for s in
                         nd.split(rev, num_outputs=length, axis=0)]
        r_out, r_states = self.r_cell.unroll(
            length, rev_steps, begin_state[nl:], layout="NTC",
            merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            r_out = list(reversed(r_out))
        else:
            rev = nd.SequenceReverse(nd.stack(*r_out, axis=0),
                                     sequence_length=valid_length,
                                     use_sequence_length=True)
            r_out = [nd.squeeze(s, axis=0) for s in
                     nd.split(rev, num_outputs=length, axis=0)]
        outputs = [nd.concat(lo, ro, dim=-1)
                   for lo, ro in zip(l_out, r_out)]
        if merge_outputs or merge_outputs is None:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states


# the reference distinguishes hybrid / non-hybrid sequential containers;
# one implementation serves both
HybridSequentialRNNCell = SequentialRNNCell
