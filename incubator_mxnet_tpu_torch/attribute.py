"""Symbol attribute scoping: the port of the JAX package's
``incubator_mxnet_tpu/attribute.py`` (``AttrScope``).

``with mx.AttrScope(ctx_group="stage1"):`` attaches the given attributes
to every symbol made inside the scope, as annotations the executor never
passes to an op. Scopes nest (thread-local); inner values win on a key
both name."""

from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["AttrScope", "current_attrs"]


class AttrScope:
    _current: threading.local = threading.local()

    def __init__(self, **attrs: str):
        self._attrs = {k: v if isinstance(v, str) else str(v)
                       for k, v in attrs.items()}
        self._old: Optional["AttrScope"] = None

    def get(self, attrs: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        """The scope's attributes under the explicitly passed ``attrs``."""
        merged = dict(self._attrs)
        if attrs:
            merged.update(attrs)
        return merged

    def __enter__(self) -> "AttrScope":
        prev = getattr(AttrScope._current, "value", None)
        self._old = prev
        merged = dict(prev._attrs) if prev is not None else {}
        merged.update(self._attrs)
        self._attrs = merged
        AttrScope._current.value = self
        return self

    def __exit__(self, *exc):
        AttrScope._current.value = self._old
        self._old = None
        return False


def current_attrs() -> Dict[str, str]:
    """The innermost active scope's attributes ({} outside any)."""
    scope = getattr(AttrScope._current, "value", None)
    return dict(scope._attrs) if scope is not None else {}
