"""Per-layer rematerialization: the port of the JAX package's
``incubator_mxnet_tpu/models/_remat.py``.

``remat_call`` runs one block under ``torch.utils.checkpoint``
(non-reentrant) with a selective-checkpoint policy: the block's
activations are dropped after the forward and recomputed in the backward,
except the outputs the policy saves.

Dropout masks: the JAX helper draws the block's key outside
``jax.checkpoint`` so the recompute replays the same masks. The port's
Dropout draws its mask with one out-of-place ``aten.bernoulli`` from
``mx.random``'s generator, and the policy SAVES that op's output: the
recompute reuses the forward's masks instead of drawing again. So the
gradients are those of the non-remat step, the generator ends where the
non-remat step leaves it, and nothing touches a generator's state, which
keeps it safe inside a CUDA graph capture (``preserve_rng_state`` is off:
it would save and restore only the default generators, which the models
do not draw from). The cost is one saved mask per dropout.

Policies (``resolve_policy``): ``True`` recomputes everything but the
masks; ``"dots"`` also saves the outputs of the matrix products
(``aten.mm`` / ``addmm`` / ``bmm``), JAX's ``checkpoint_dots``, and
recomputes the elementwise and normalization work; the flash kernels are
not products here, as a Pallas call is not a dot in JAX, and are
recomputed. The autograd mode of the forward (recording, training) is
restored around the recompute, which runs inside the backward.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import autograd
from ..ndarray import NDArray

__all__ = ["remat_call", "resolve_policy", "plan_remat_from_profile"]


_aten = torch.ops.aten
# the port's Dropout draws its mask with one out-of-place bernoulli
_RANDOM_OPS = frozenset((_aten.bernoulli.p,))
_DOT_OPS = frozenset((_aten.mm.default, _aten.addmm.default,
                      _aten.bmm.default))


def resolve_policy(remat):
    """Map a model-level ``remat`` flag to a checkpoint policy.

    False -> no remat (None); True -> whole-layer remat ("all": recompute
    everything but the dropout masks); "dots" -> selective: matrix-product
    outputs are saved, only elementwise / norm intermediates are
    recomputed."""
    if remat == "dots":
        return "dots"
    if remat not in (False, True):
        raise ValueError(
            f"remat must be False, True, or 'dots'; got {remat!r}")
    return "all" if remat else None


def plan_remat_from_profile(stats, num_blocks):
    """Derive a per-block remat plan from a measured overlap profile.

    ``stats`` is ``tools.trace_summary.overlap_stats(trace_dir)`` — the
    per-lane compute/collective split of a real profile. Returns a list
    of ``num_blocks`` entries (``False`` | ``"dots"`` | ``True``)
    suitable for ``SPMDTrainer(remat_plan=...)``, which wraps each
    pipeline block in ``jax.checkpoint`` with the matching policy
    (parallel/pipelined.py).

    Heuristic, keyed on the EXPOSED fraction (collective time the
    backward failed to hide, relative to compute):

      exposed/compute < 0.05  → no remat: collectives already overlap,
                                extra recompute only slows the step.
      exposed/compute < 0.25  → ``"dots"`` everywhere: cheap recompute
                                (elementwise/norm only) lengthens each
                                block's backward a little, giving the
                                in-flight bucket reductions more compute
                                to hide behind, and frees activation HBM.
      otherwise               → full remat on the EARLIEST
                                ``ceil(frac * num_blocks)`` blocks (they
                                backward LAST, exactly when the deep
                                buckets drain and exposure concentrates)
                                and ``"dots"`` on the rest.

    A profile with no compute attribution (e.g. cpu_mode traces) maps to
    no remat — never guess from an empty window."""
    num_blocks = int(num_blocks)
    if num_blocks <= 0:
        return []
    compute = float(stats.get("compute_us") or 0.0)
    exposed = float(stats.get("exposed_us") or 0.0)
    if compute <= 0.0:
        return [False] * num_blocks
    frac = exposed / compute
    if frac < 0.05:
        return [False] * num_blocks
    if frac < 0.25:
        return ["dots"] * num_blocks
    n_full = min(num_blocks, max(1, math.ceil(min(frac, 1.0) * num_blocks)))
    return [True] * n_full + ["dots"] * (num_blocks - n_full)


def _policy_fn(save_dots):
    def policy(ctx, op, *args, **kwargs):
        if op in _RANDOM_OPS or (save_dots and op in _DOT_OPS):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def remat_call(block, *args, policy="all"):
    """Apply ``block(*args)`` under a selective checkpoint (``policy``
    from ``resolve_policy``: "all" or "dots"). ``args`` are NDArrays or
    None; returns an NDArray. Outside ``autograd.record()`` nothing is
    saved for a backward, and the block runs as it is."""
    recording, training = autograd.is_recording(), autograd.is_training()
    if not recording:
        return block(*args)
    tensors = [None if a is None else a._data for a in args]

    def run(*ts):
        with autograd._ModeScope(recording=recording, training=training):
            out = block(*[None if t is None else NDArray(t) for t in ts])
        return out._data

    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   _policy_fn(policy == "dots"))
    with torch.enable_grad():
        out = checkpoint(run, *tensors, use_reentrant=False,
                         preserve_rng_state=False, context_fn=context_fn)
    return NDArray(out)
