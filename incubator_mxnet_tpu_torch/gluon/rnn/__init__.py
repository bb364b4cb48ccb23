"""Gluon recurrent layers and cells: the port of the JAX package's
``incubator_mxnet_tpu/gluon/rnn/`` (parity: python/mxnet/gluon/rnn/)."""

from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell, LSTMCell,
                       GRUCell, SequentialRNNCell, BidirectionalCell,
                       ResidualCell, DropoutCell, ModifierCell,
                       ZoneoutCell, HybridSequentialRNNCell)
from .rnn_layer import RNN, LSTM, GRU

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "ZoneoutCell", "HybridSequentialRNNCell",
           "GRUCell", "SequentialRNNCell", "BidirectionalCell",
           "ResidualCell", "DropoutCell", "ModifierCell", "RNN", "LSTM",
           "GRU"]
