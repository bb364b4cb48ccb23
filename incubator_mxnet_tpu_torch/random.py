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

``get_state()`` / ``set_state(state)`` carry all of it: the seed, each
default generator's ``get_state()`` keyed by its device, and the host
stream. ``set_state`` writes into the generators that exist (never
replacing one): a CUDA graph that registered a generator reads the
restored state at its next replay.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["seed", "generator", "np_rng", "get_state", "set_state"]

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


def get_state() -> dict:
    """The whole random state: ``{"seed": int, "generators": {device:
    uint8 CPU tensor}, "host": numpy RandomState state}`` (parity:
    ``mx.random.get_state``; the JAX package's is a threefry key)."""
    return {"seed": _SEED,
            "generators": {k: g.get_state() for k, g in _GENERATORS.items()},
            "host": _HOST.get_state()}


def set_state(state: dict) -> None:
    """Restore ``get_state()``'s value. Each generator's state is set on
    the generator object that exists for its device (created first if
    none does), so graphs holding it draw from the restored state."""
    global _SEED
    _SEED = int(state["seed"])
    for key, gen_state in state.get("generators", {}).items():
        generator(key).set_state(gen_state)
    if state.get("host") is not None:
        _HOST.set_state(state["host"])
