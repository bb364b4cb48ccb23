"""Seeding: the port of the JAX package's ``incubator_mxnet_tpu/random.py``
``seed``.

The port draws its random numbers (initial weights, dropout masks) from
explicit ``torch.Generator``s. ``generator(device)`` is the default one
for a device, which the models use when no ``generator=`` is passed;
``seed(n)`` reseeds every default generator. The streams differ from the
JAX package's threefry streams for the same seed.
"""

from __future__ import annotations

import torch

__all__ = ["seed", "generator"]

_SEED = 0
_GENERATORS = {}


def _key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def seed(seed_state: int) -> None:
    """Seed the default generator of every device (parity:
    ``mx.random.seed``)."""
    global _SEED
    _SEED = int(seed_state) & 0x7FFFFFFF
    for g in _GENERATORS.values():
        g.manual_seed(_SEED)


def generator(device="cpu") -> torch.Generator:
    """The default generator of ``device``, seeded by the last ``seed``
    call (0 before any)."""
    key = _key(device)
    g = _GENERATORS.get(key)
    if g is None:
        g = torch.Generator(device=key)
        g.manual_seed(_SEED)
        _GENERATORS[key] = g
    return g
