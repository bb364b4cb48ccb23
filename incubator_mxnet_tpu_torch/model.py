"""Checkpoint files of the symbolic front end: the port of the JAX
package's ``incubator_mxnet_tpu/model.py`` (``save_checkpoint`` /
``load_checkpoint``).

``<prefix>-symbol.json`` holds the graph and ``<prefix>-NNNN.params`` the
arrays under ``arg:`` / ``aux:`` keys, in either ``.params`` layout
(``format="mxnet"``: MXNet 1.x's); ``load_checkpoint`` reads both, and
the files of either package.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .ndarray import NDArray, load as nd_load, save as nd_save
from .symbol.symbol import Symbol, load as sym_load

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(prefix: str, epoch: int, symbol: Symbol,
                    arg_params: Dict[str, NDArray],
                    aux_params: Dict[str, NDArray],
                    format: str = "mxtpu") -> None:
    """(parity: ``mx.model.save_checkpoint``) ``format="mxnet"`` writes
    MXNet 1.x's ``.params`` layout."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    payload = {}
    payload.update({f"arg:{k}": v for k, v in (arg_params or {}).items()})
    payload.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
    nd_save(f"{prefix}-{epoch:04d}.params", payload, format=format)


def load_checkpoint(prefix: str, epoch: int
                    ) -> Tuple[Symbol, Dict[str, NDArray],
                               Dict[str, NDArray]]:
    """Parity: ``mx.model.load_checkpoint`` → (symbol, arg_params,
    aux_params)."""
    symbol = sym_load(f"{prefix}-symbol.json")
    payload = nd_load(f"{prefix}-{epoch:04d}.params", ctx="cpu")
    arg_params, aux_params = {}, {}
    for key, val in payload.items():
        kind, _, name = key.partition(":")
        if kind == "arg":
            arg_params[name] = val
        elif kind == "aux":
            aux_params[name] = val
        else:
            arg_params[key] = val
    return symbol, arg_params, aux_params
