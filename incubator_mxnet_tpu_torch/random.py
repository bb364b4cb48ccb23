"""Seeding: the port of the JAX package's ``incubator_mxnet_tpu/random.py``
``seed``.

The port draws its random numbers (initial weights, dropout masks) from
explicit ``torch.Generator``s. ``generator(device)`` is the default one
for a device, which the models use when no ``generator=`` is passed;
``seed(n)`` reseeds every default generator. The streams differ from the
JAX package's threefry streams for the same seed.

``np_rng()`` is the host side (the data loader's shuffles, the random
transforms): each call returns a numpy ``RandomState`` of its own, seeded
from a host stream that ``seed(n)`` restarts. The JAX package derives
each one from its threefry key, which the port does not reproduce, so a
shuffled epoch is a different permutation in each package.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["seed", "generator", "np_rng"]

_SEED = 0
_GENERATORS = {}
_HOST = np.random.RandomState(_SEED)


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
    _HOST.seed(_SEED)


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


def np_rng() -> np.random.RandomState:
    """A host numpy RNG of its own, the next one of the stream ``seed``
    restarts (for shuffling and random transforms)."""
    return np.random.RandomState(int(_HOST.randint(0, 0x7FFFFFFF)))
