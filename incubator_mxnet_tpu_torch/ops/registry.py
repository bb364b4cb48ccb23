"""Operator registry: the port of the JAX package's
``incubator_mxnet_tpu/ops/registry.py``.

An operator is one plain function over ``torch.Tensor``s, registered
under the JAX package's name and aliases; ``mx.nd`` surfaces each as a
generated function (``ndarray.register``). Gradients come from
``torch.autograd`` through the same function, as the JAX package's come
from ``jax.vjp``. Two flags steer the imperative front end:

  - ``needs_key``: the op draws random numbers. It takes a ``generator=``
    keyword, which the front end fills with ``mx.random``'s generator for
    the input's device (where the JAX op takes a PRNG key);
  - ``training_aware``: the op takes a ``training=`` keyword, resolved from
    ``autograd.is_training()`` at the call (dropout, batch norm).
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Optional, Tuple

from ..base import MXNetError

__all__ = ["register", "get", "exists", "list_all_ops", "list_all_names",
           "OpSpec", "describe_op"]

_OP_REGISTRY: Dict[str, "OpSpec"] = {}


class OpSpec:
    """A registered operator: ``name`` (canonical), ``fn``, ``aliases``,
    ``num_outputs`` (None when variadic), ``needs_key``,
    ``training_aware`` and ``wrap_list`` (the first argument may be a list
    of arrays)."""

    __slots__ = ("name", "fn", "aliases", "num_outputs", "needs_key",
                 "training_aware", "wrap_list", "doc")

    def __init__(self, name, fn, aliases=(), num_outputs=1, needs_key=False,
                 training_aware=False, wrap_list=False):
        self.name = name
        self.fn = fn
        self.aliases = tuple(aliases)
        self.num_outputs = num_outputs
        self.needs_key = needs_key
        self.training_aware = training_aware
        self.wrap_list = wrap_list
        self.doc = fn.__doc__

    def __repr__(self):
        return f"OpSpec({self.name})"


def register(name: str, aliases: Tuple[str, ...] = (),
             num_outputs: Optional[int] = 1, needs_key: bool = False,
             training_aware: bool = False,
             wrap_list: bool = False) -> Callable:
    """Register ``fn`` under ``name`` and ``aliases``; a name registered
    twice raises ``MXNetError``."""

    def _deco(fn):
        spec = OpSpec(name, fn, aliases, num_outputs, needs_key,
                      training_aware, wrap_list)
        for n in (name,) + tuple(aliases):
            if n in _OP_REGISTRY:
                raise MXNetError(f"operator {n!r} registered twice")
            _OP_REGISTRY[n] = spec
        return fn

    return _deco


def get(name: str) -> OpSpec:
    try:
        return _OP_REGISTRY[name]
    except KeyError:
        raise MXNetError(f"operator {name!r} not registered") from None


def exists(name: str) -> bool:
    return name in _OP_REGISTRY


def list_all_ops() -> List[str]:
    """Canonical names only (parity: ``MXListAllOpNames``)."""
    return sorted({s.name for s in _OP_REGISTRY.values()})


def list_all_names() -> List[str]:
    """Every registered name, aliases included."""
    return sorted(_OP_REGISTRY)


def describe_op(name: str) -> str:
    """The op's documentation from the registry: name, aliases, signature
    and docstring."""
    spec = get(name)
    lines = [f"Operator `{spec.name}`"]
    if spec.aliases:
        lines.append(f"aliases: {', '.join(spec.aliases)}")
    lines.append(f"signature: {spec.name}{inspect.signature(spec.fn)}")
    if spec.doc:
        lines += ["", inspect.cleandoc(spec.doc)]
    return "\n".join(lines)
