"""Automatic symbol naming: the port of the JAX package's
``incubator_mxnet_tpu/name.py`` (``NameManager``, ``Prefix``).

``with mx.name.Prefix("stage1_"):`` prefixes every automatic symbol name
made in the scope. The managers share the symbolic front end's counters
(``symbol.symbol._auto_name``), so names made inside and outside a scope
never collide, and auto-names follow the JAX package's node for node."""

from __future__ import annotations

import threading
from typing import Optional

__all__ = ["NameManager", "Prefix", "current"]


class NameManager:
    """``get(name, hint)``: ``name`` if given, else ``hint`` and the
    hint's next counter value."""

    _current: threading.local = threading.local()

    def __init__(self):
        self._old_manager: Optional["NameManager"] = None

    def get(self, name: Optional[str], hint: str) -> str:
        if name:
            return name
        from .symbol.symbol import _auto_name
        return _auto_name(hint)

    def __enter__(self) -> "NameManager":
        self._old_manager = getattr(NameManager._current, "value", None)
        NameManager._current.value = self
        return self

    def __exit__(self, *exc):
        NameManager._current.value = self._old_manager
        self._old_manager = None
        return False


class Prefix(NameManager):
    """A NameManager that puts ``prefix`` before every automatic name."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name: Optional[str], hint: str) -> str:
        return self._prefix + super().get(name, hint)


def current() -> Optional[NameManager]:
    """The innermost active NameManager (None outside any scope)."""
    return getattr(NameManager._current, "value", None)
