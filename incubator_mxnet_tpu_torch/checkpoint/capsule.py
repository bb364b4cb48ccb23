"""The training capsule: the port of the JAX package's
``incubator_mxnet_tpu/checkpoint/capsule.py``, everything a bit-exact
resume needs, in one tree.

A capsule is a flat ``name -> array`` tree plus a JSON-able meta dict:

    param/<i>         every parameter, in the trainer's order
    opt/<i>/<j>       j-th optimizer-state leaf of parameter / slot i
    rng/torch/<dev>   each default generator's ``get_state()`` (uint8)
    rng/host/key, rng/host/aux
                      the host stream behind ``np_rng()`` (MT19937 key;
                      position, gauss flag, cached gauss, seed)
    meta.num_update, meta.index_update_count
                      optimizer step counters (Adam/LAMB bias
                      correction and lr schedules depend on them)
    meta.step         trainer step count (SPMD) / num_update (Trainer)
    meta.iterator     the iterator's ``tell()`` position

The entry names and the meta keys are the JAX package's, so a capsule
crosses the packages in both directions, with one departure: the JAX
capsule's ``rng/key`` is a threefry key the port cannot map onto its
Philox generators, so the port skips it, and writes its own state under
the ``rng/torch`` and ``rng/host`` names, which the JAX restore ignores.

Two encodings share the tree: the step-directory format (manifest.py,
through ``CheckpointManager``) and a single-file BLOB (magic
``MXTPUCK\\x01``, crc32-checked), byte for byte the JAX package's, which
``Trainer.save_states`` writes. Host arrays of bf16 / float8 entries are
their bits (``manifest.bits_dtype``); ``HostArrays.dtypes`` names the
logical dtype.

A restore writes into the tensors that exist, with ``copy_``, and never
rebinds one: the captured step graphs hold the parameters and the
optimizer state by address. Every shape and dtype (no silent cast) and
every state's leaf count is checked before the first write. Optimizer
states that do not exist yet are made by ``create_state_multi_precision``
and then filled.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..optimizer.fused import tree_leaves
from .manifest import HostArrays, bits_dtype

__all__ = ["CAPSULE_MAGIC", "dump_capsule_bytes", "load_capsule_bytes",
           "save_capsule_file", "load_capsule_file", "is_capsule_bytes",
           "trainer_capsule", "restore_trainer",
           "spmd_capsule", "restore_spmd",
           "updater_capsule", "restore_updater",
           "flatten_state", "fill_state"]

CAPSULE_MAGIC = b"MXTPUCK\x01"
CAPSULE_VERSION = 1

# dtypes numpy lacks: the torch dtype a tensor's bits are viewed as
_BITS_VIEW = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
              torch.float8_e5m2: torch.uint8}
_NUMPY_BITS = {torch.int16: np.uint16, torch.uint8: np.uint8}


def torch_dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise MXNetError(f"capsule dtype {name!r} has no torch dtype")
    return dtype


def _as_tensor(leaf):
    """An ``NDArray``'s tensor, a tensor detached, anything else as is."""
    if hasattr(leaf, "_data") and hasattr(leaf, "asnumpy"):
        leaf = leaf._data
    return leaf.detach() if torch.is_tensor(leaf) else leaf


def bits_of(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as the integer of its width where numpy lacks its
    dtype (bf16, float8), else ``t``; made contiguous."""
    t = t.contiguous()
    view = _BITS_VIEW.get(t.dtype)
    return t if view is None else t.view(view)


def numpy_of_bits(host: torch.Tensor, logical: torch.dtype) -> np.ndarray:
    """A host tensor of ``bits_of``'s as numpy, sharing its memory (bf16
    bits as ``uint16``)."""
    a = host.numpy()
    if logical in _BITS_VIEW:
        a = a.view(_NUMPY_BITS[host.dtype])
    return a


def host_leaf(leaf) -> Tuple[str, np.ndarray]:
    """``(logical dtype name, C-contiguous numpy copy)`` of a tensor,
    ``NDArray``, numpy array or scalar; bf16 / float8 as their bits."""
    leaf = _as_tensor(leaf)
    if torch.is_tensor(leaf):
        bits = bits_of(leaf).cpu()
        return (torch_dtype_name(leaf.dtype),
                np.array(numpy_of_bits(bits, leaf.dtype), copy=True))
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":            # ml_dtypes, from the JAX side
        return "bfloat16", np.ascontiguousarray(a).view(np.uint16).copy()
    return a.dtype.name, np.array(a, copy=True, order="C")


def logical_dtype(arrays: Dict[str, np.ndarray], name: str) -> str:
    """The logical dtype of entry ``name``: ``HostArrays.dtypes``' record
    while the array still has its bits' dtype, else the array's own
    (``ml_dtypes``' bfloat16 included)."""
    a = arrays[name]
    recorded = (getattr(arrays, "dtypes", None) or {}).get(name)
    if recorded is not None and a.dtype == bits_dtype(recorded):
        return recorded
    return a.dtype.name


def host_to_tensor(a: np.ndarray, logical: str) -> torch.Tensor:
    """A CPU tensor of dtype ``logical`` from a host array (its bits for
    bf16 / float8); shares the array's memory when it is writable."""
    dtype = _torch_dtype(logical)
    a = np.ascontiguousarray(a)
    view = _BITS_VIEW.get(dtype)
    if view is not None:
        a = a.view(np.int16 if view == torch.int16 else np.uint8)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    return t.view(dtype) if view is not None else t


# ---------------------------------------------------------------------- #
# single-file blob encoding
# ---------------------------------------------------------------------- #

def dump_capsule_bytes(tree: Dict[str, object],
                       meta: Optional[dict] = None) -> bytes:
    bufs, recs = [], []
    for name, leaf in tree.items():
        dtype, a = host_leaf(leaf)
        buf = a.tobytes()
        recs.append({"name": name, "dtype": dtype,
                     "shape": list(a.shape), "nbytes": len(buf),
                     "crc32": zlib.crc32(buf) & 0xFFFFFFFF})
        bufs.append(buf)
    header = json.dumps({"capsule_version": CAPSULE_VERSION,
                         "meta": meta or {},
                         "arrays": recs}).encode("utf-8")
    out = [CAPSULE_MAGIC, struct.pack("<Q", len(header)), header]
    out.extend(bufs)
    return b"".join(out)


def is_capsule_bytes(data: bytes) -> bool:
    return data[:len(CAPSULE_MAGIC)] == CAPSULE_MAGIC


def load_capsule_bytes(data: bytes) -> Tuple[HostArrays, dict]:
    if not is_capsule_bytes(data):
        raise MXNetError("not a MXTPU capsule blob (bad magic)")
    off = len(CAPSULE_MAGIC)
    (hlen,) = struct.unpack("<Q", data[off:off + 8])
    off += 8
    header = json.loads(data[off:off + hlen].decode("utf-8"))
    off += hlen
    out = HostArrays()
    for rec in header["arrays"]:
        buf = data[off:off + rec["nbytes"]]
        if len(buf) != rec["nbytes"]:
            raise MXNetError(
                f"capsule blob truncated at array '{rec['name']}'")
        if (zlib.crc32(buf) & 0xFFFFFFFF) != rec["crc32"]:
            raise MXNetError(
                f"capsule blob: array '{rec['name']}' failed crc32 "
                f"verification — refusing to load corrupt state")
        off += rec["nbytes"]
        out[rec["name"]] = np.frombuffer(
            buf, dtype=bits_dtype(rec["dtype"])).reshape(
                tuple(rec["shape"]))
        out.dtypes[rec["name"]] = rec["dtype"]
    return out, header.get("meta", {})


def save_capsule_file(fname: str, tree: Dict[str, object],
                      meta: Optional[dict] = None) -> None:
    with open(fname, "wb") as f:
        f.write(dump_capsule_bytes(tree, meta))


def load_capsule_file(fname: str) -> Tuple[HostArrays, dict]:
    with open(fname, "rb") as f:
        return load_capsule_bytes(f.read())


# ---------------------------------------------------------------------- #
# checked writes into live tensors
# ---------------------------------------------------------------------- #

def _pair(label: str, arrays, key: str, dst: torch.Tensor):
    """``(dst, host tensor)`` for entry ``key`` after checking its shape
    and dtype against ``dst`` (no silent cast)."""
    a = arrays[key]
    got = logical_dtype(arrays, key)
    want = torch_dtype_name(dst.dtype)
    if tuple(a.shape) != tuple(dst.shape):
        raise MXNetError(f"capsule {label} shape {tuple(a.shape)} != "
                         f"current {tuple(dst.shape)}")
    if got != want:
        raise MXNetError(
            f"capsule {label} dtype {got} != current {want} — refusing "
            f"a silent cast (bit-exact resume contract)")
    return dst, host_to_tensor(a, got)


@torch.no_grad()
def _write(pairs) -> None:
    """Every checked pair's value into its live tensor, in place."""
    for dst, src in pairs:
        dst.copy_(src)


def flatten_state(st) -> Tuple[List[torch.Tensor], object]:
    """One optimizer state's tensor leaves (None leaves vanish, as in the
    JAX package) and the state itself as its structure."""
    leaves = tree_leaves(st)
    for leaf in leaves:
        if not torch.is_tensor(leaf):
            raise MXNetError(
                f"optimizer state leaf of type {type(leaf).__name__} is "
                f"not a tensor; cannot capsule it")
    return leaves, st


def _state_pairs(template, arrays, prefix: str,
                 expect: Optional[int] = None):
    leaves, _ = flatten_state(template)
    if expect is not None and len(leaves) != expect:
        raise MXNetError(
            f"capsule mismatch at {prefix}: checkpoint has {expect} "
            f"state leaves, current optimizer creates {len(leaves)} — "
            f"optimizer type or multi_precision setting changed")
    pairs = []
    for j, leaf in enumerate(leaves):
        key = f"{prefix}/{j}"
        if key not in arrays:
            raise MXNetError(f"capsule missing optimizer state '{key}'")
        pairs.append(_pair(f"state '{key}'", arrays, key, leaf))
    return pairs


def fill_state(template, arrays: Dict[str, np.ndarray], prefix: str,
               expect: Optional[int] = None):
    """Fill ``template``'s leaves in place from ``arrays[f'{prefix}/{j}']``
    (all checked first); returns ``template``."""
    _write(_state_pairs(template, arrays, prefix, expect))
    return template


def _param_pairs(params, arrays, names) -> list:
    """The checked ``(tensor, value)`` pair of every ``param/<i>``;
    ``params`` are the live tensors, ``names`` their names."""
    pairs = []
    for i, (t, name) in enumerate(zip(params, names)):
        key = f"param/{i}"
        if key not in arrays:
            raise MXNetError(f"capsule has no entry for parameter "
                             f"{i} ('{name}')")
        pairs.append(_pair(f"param '{key}' ('{name}')", arrays, key, t))
    return pairs


def _check_count(meta: dict, n: int):
    names = meta.get("param_names") or []
    if names and len(names) != n:
        raise MXNetError(f"capsule holds {len(names)} params, trainer has "
                         f"{n} — model structure changed")


def _counters(opt) -> dict:
    return {"num_update": int(opt.num_update),
            "index_update_count": {str(k): int(v) for k, v in
                                   opt._index_update_count.items()}}


def _restore_counters(opt, meta: dict):
    opt.num_update = int(meta.get("num_update", 0))
    opt._index_update_count = {
        int(k): int(v)
        for k, v in (meta.get("index_update_count") or {}).items()}


def _opt_entries(tree: dict, states) -> dict:
    """``opt/<i>/<j>`` entries of ``(i, state)`` pairs; returns the leaf
    counts."""
    counts = {}
    for i, st in states:
        leaves, _ = flatten_state(st)
        counts[str(i)] = len(leaves)
        for j, leaf in enumerate(leaves):
            tree[f"opt/{i}/{j}"] = leaf
    return counts


# ---------------------------------------------------------------------- #
# random state, iterator, scaler, health
# ---------------------------------------------------------------------- #

_RNG_TORCH = "rng/torch/"


def _rng_entry(tree: dict):
    from .. import random as _random
    state = _random.get_state()
    for dev, gen_state in state["generators"].items():
        tree[_RNG_TORCH + dev] = gen_state
    _kind, key, pos, has_gauss, gauss = state["host"]
    tree["rng/host/key"] = np.array(key, dtype=np.uint32)
    tree["rng/host/aux"] = np.array(
        [pos, has_gauss, gauss, state["seed"]], dtype=np.float64)


def _device_present(dev: str) -> bool:
    d = torch.device(dev)
    return d.type == "cpu" or (
        d.type == "cuda" and torch.cuda.is_available()
        and (d.index or 0) < torch.cuda.device_count())


def _restore_rng(arrays):
    """The port's random state from its ``rng/`` entries (a JAX capsule's
    ``rng/key`` is skipped). Generators of devices this host lacks are
    left out: nothing here can draw from them."""
    if "rng/host/aux" not in arrays:
        return
    from .. import random as _random
    pos, has_gauss, gauss, seed = (float(v) for v in arrays["rng/host/aux"])
    gens = {}
    for name in arrays:
        dev = name[len(_RNG_TORCH):] if name.startswith(_RNG_TORCH) else None
        if dev is not None and _device_present(dev):
            gens[dev] = torch.from_numpy(
                np.array(arrays[name], dtype=np.uint8))
    _random.set_state({
        "seed": int(seed), "generators": gens,
        "host": ("MT19937", np.array(arrays["rng/host/key"],
                                     dtype=np.uint32),
                 int(pos), int(has_gauss), gauss)})


def _iterator_meta(iterator) -> Optional[dict]:
    return None if iterator is None else iterator.tell()


def _restore_iterator(iterator, meta: dict):
    pos = meta.get("iterator")
    if iterator is not None and pos is not None:
        iterator.set_position(pos)


def _scaler_meta(scaler) -> Optional[dict]:
    return None if scaler is None else scaler.state_dict()


def _restore_scaler(owner, attr: str, meta: dict, inject: bool):
    """Re-enter the dynamic loss-scaler trajectory (a resumed run must not
    re-warm the scale from its initial value).

    ``inject``: whether a capsule's scaler state is given to a trainer
    built WITHOUT a scaler. The SPMD trainer applies the scale inside its
    step, so injecting one is self-consistent; gluon's Trainer relies on
    the user scaling the loss (``trainer.backward``), so there the state
    is dropped with a warning and training resumes unscaled."""
    state = meta.get("loss_scaler")
    if state is None:
        return
    scaler = getattr(owner, attr, None)
    if scaler is None:
        if not inject:
            if float(state.get("loss_scale", 1.0)) != 1.0:
                import warnings
                warnings.warn(
                    f"capsule carries dynamic loss-scaler state (scale "
                    f"{state.get('loss_scale')}) but this Trainer has no "
                    f"loss_scaler — the state is DROPPED and training "
                    f"resumes unscaled; construct the Trainer with "
                    f"loss_scaler=LossScaler() to resume scaled training",
                    RuntimeWarning, stacklevel=3)
            return
        from ..amp.loss_scaler import LossScaler
        scaler = LossScaler()
        setattr(owner, attr, scaler)
    scaler.load_state_dict(state)


def _restore_step_health(trainer, meta: dict):
    rec = getattr(trainer, "_recorder", None)
    state = meta.get("step_health")
    if rec is not None and state is not None:
        rec.load_state_dict(state)


def _health_meta(trainer):
    rec = getattr(trainer, "_recorder", None)
    return None if rec is None else rec.state_dict()


# ---------------------------------------------------------------------- #
# gluon.Trainer capsule
# ---------------------------------------------------------------------- #

def trainer_capsule(trainer, iterator=None,
                    extra_meta: Optional[dict] = None
                    ) -> Tuple[Dict[str, object], dict]:
    """Capsule of a ``gluon.Trainer``: parameters, updater states, step
    counters, the random state and the iterator's position. Parameters
    are keyed by position (names are session-global counters); the names
    ride in ``meta.param_names``."""
    opt = trainer._optimizer
    tree: Dict[str, object] = {f"param/{i}": p.data()
                               for i, p in enumerate(trainer._params)}
    leaf_counts = _opt_entries(tree, trainer._updaters[0].states.items())
    _rng_entry(tree)
    meta = {
        "kind": "trainer",
        "step": int(opt.num_update),
        **_counters(opt),
        "opt_leaf_counts": leaf_counts,
        "param_names": [p.name for p in trainer._params],
        "iterator": _iterator_meta(iterator),
        "loss_scaler": _scaler_meta(
            getattr(trainer, "_amp_loss_scaler", None)),
        "step_health": _health_meta(trainer),
    }
    meta.update(extra_meta or {})
    return tree, meta


def _updater_pairs(updater, params, arrays, meta) -> Tuple[list, dict]:
    """The checked pairs of every ``opt/`` entry, and the state of each
    index: the updater's existing state (filled in place) or a new one
    from ``create_state_multi_precision``."""
    opt = updater.optimizer
    pairs, states = [], {}
    for sidx, count in (meta.get("opt_leaf_counts") or {}).items():
        i = int(sidx)
        if i >= len(params):
            raise MXNetError(
                f"capsule optimizer state for param index {i} but only "
                f"{len(params)} params are bound")
        st = updater.states.get(i)
        if st is None:
            st = opt.create_state_multi_precision(
                i, params[i].data()._data.detach())
        pairs += _state_pairs(st, arrays, f"opt/{i}", expect=int(count))
        states[i] = st
    return pairs, states


def _install_states(updater, states: dict):
    """The updater keeps exactly the capsule's states (the JAX restore
    clears the others: they restart from zero at their next update)."""
    updater.states.clear()
    updater.states.update(states)


def restore_trainer(trainer, arrays: Dict[str, np.ndarray], meta: dict,
                    iterator=None) -> None:
    if meta.get("kind") not in ("trainer", None):
        raise MXNetError(f"capsule kind {meta.get('kind')!r} is not a "
                         f"Trainer capsule")
    _check_count(meta, len(trainer._params))
    updater = trainer._updaters[0]
    pairs = _param_pairs([p.data()._data for p in trainer._params], arrays,
                         [p.name for p in trainer._params])
    state_pairs, states = _updater_pairs(updater, trainer._params, arrays,
                                         meta)
    _write(pairs + state_pairs)
    _install_states(updater, states)
    _restore_counters(trainer._optimizer, meta)
    trainer._rebuild_applier()
    _restore_scaler(trainer, "_amp_loss_scaler", meta, inject=False)
    _restore_step_health(trainer, meta)
    _restore_rng(arrays)
    _restore_iterator(iterator, meta)


# ---------------------------------------------------------------------- #
# Updater-only capsule (Trainer.save_states)
# ---------------------------------------------------------------------- #

def updater_capsule(updater) -> Tuple[Dict[str, object], dict]:
    tree: Dict[str, object] = {}
    leaf_counts = _opt_entries(tree, updater.states.items())
    meta = {"kind": "updater", **_counters(updater.optimizer),
            "opt_leaf_counts": leaf_counts}
    return tree, meta


def restore_updater(updater, params: List, arrays: Dict[str, np.ndarray],
                    meta: dict) -> None:
    """Fill an Updater from a capsule; ``params`` is the index-aligned
    Parameter list (new states are made against their data)."""
    pairs, states = _updater_pairs(updater, params, arrays, meta)
    _write(pairs)
    _install_states(updater, states)
    _restore_counters(updater.optimizer, meta)


# ---------------------------------------------------------------------- #
# parallel.SPMDTrainer capsule
# ---------------------------------------------------------------------- #

def _shard_spec(ndim: int, plan) -> str:
    """The manifest's sharding string, in the JAX package's spelling, of
    a shard plan ``((dim, axis), ...)``."""
    axes = {}
    for d, a in plan:
        axes.setdefault(d, []).append(a)

    def entry(k):
        if k not in axes:
            return "None"
        if len(axes[k]) == 1:
            return repr(axes[k][0])
        return "(" + ", ".join(repr(a) for a in axes[k]) + ")"
    return "PartitionSpec(" + ", ".join(entry(k) for k in range(ndim)) + ")"


def _shard_index(shape, box):
    starts = {d: (start, start + n) for d, start, n in box}
    return [starts.get(k, (0, int(s))) for k, s in enumerate(shape)]


def _spmd_tree(trainer) -> Dict[str, object]:
    """The capsule's arrays of this rank: each shard (parameter and
    shard-shaped optimizer state) as a ``ShardLeaf`` written by the ranks
    at coordinate 0 on the axes it is not split over, every replicated
    entry by rank 0 alone."""
    from ..parallel import mesh as _mesh
    from .manager import ShardLeaf
    lead = _mesh.rank() == 0
    slots = {i: k for k, i in enumerate(trainer._train_idx)}
    tree: Dict[str, object] = {}
    for i, p in enumerate(trainer._params):
        slot = slots.get(i)
        box = None if slot is None else trainer._shard_box(slot)
        if box is None:
            if lead:
                tree[f"param/{i}"] = p
        elif trainer._writes_shard(slot):
            tree[f"param/{i}"] = ShardLeaf(
                trainer._shards[slot], _shard_index(p.shape, box), p.shape,
                _shard_spec(p.dim(), trainer._shard_plans[slot]))
    for slot, st in enumerate(trainer._opt_state):
        leaves, _ = flatten_state(st)
        box = trainer._shard_box(slot)
        shard = None if box is None else trainer._shards[slot]
        full = trainer._params[trainer._train_idx[slot]].shape
        for j, leaf in enumerate(leaves):
            if shard is not None and tuple(leaf.shape) == tuple(shard.shape):
                if trainer._writes_shard(slot):
                    tree[f"opt/{slot}/{j}"] = ShardLeaf(
                        leaf, _shard_index(full, box), full,
                        _shard_spec(len(full), trainer._shard_plans[slot]))
            elif lead:
                tree[f"opt/{slot}/{j}"] = leaf
    if lead:
        _rng_entry(tree)
    return tree


def spmd_capsule(trainer, iterator=None,
                 extra_meta: Optional[dict] = None
                 ) -> Tuple[Dict[str, object], dict]:
    if trainer._opt_state is None:
        raise MXNetError(
            "SPMDTrainer has no optimizer state yet (no step taken); "
            "nothing to checkpoint — save Block parameters instead")
    opt = trainer._optimizer
    tree = _spmd_tree(trainer)
    leaf_counts = {str(k): len(flatten_state(st)[0])
                   for k, st in enumerate(trainer._opt_state)}
    meta = {
        "kind": "spmd",
        "step": int(trainer.step_count),
        # the trainer's own counter rides separately: meta["step"] may be
        # the caller's loop position (save_checkpoint(step=)), which runs
        # ahead of step_count once the guard skips steps
        "step_count": int(trainer.step_count),
        **_counters(opt),
        "opt_leaf_counts": leaf_counts,
        "train_idx": [int(i) for i in trainer._train_idx],
        "param_names": list(trainer._names),
        "sharding": trainer.sharding_mode,
        "iterator": _iterator_meta(iterator),
        "loss_scaler": _scaler_meta(getattr(trainer, "loss_scaler", None)),
        "step_health": _health_meta(trainer),
    }
    meta.update(extra_meta or {})
    return tree, meta


def _shard_arrays(trainer, arrays):
    """``arrays`` with each fsdp slot's shard-shaped optimizer entries cut
    to this rank's shard, plus ``shard/<i>``: the rank's slice of each
    sharded parameter (the tensor the update writes)."""
    out = HostArrays(arrays)
    out.dtypes = dict(getattr(arrays, "dtypes", {}))
    for slot, shard in enumerate(trainer._shards or ()):
        if shard is None:
            continue
        i = trainer._train_idx[slot]
        cut = [slice(None)] * trainer._params[i].dim()
        for d, start, n in trainer._shard_box(slot):
            cut[d] = slice(start, start + n)
        cut = tuple(cut)
        src = f"param/{i}"
        if src in arrays:
            out[f"shard/{i}"] = np.ascontiguousarray(arrays[src][cut])
            out.dtypes[f"shard/{i}"] = out.dtypes.get(src)
        for j, leaf in enumerate(flatten_state(
                trainer._opt_state[slot])[0]):
            key = f"opt/{slot}/{j}"
            if key in arrays and tuple(leaf.shape) == tuple(shard.shape) \
                    and tuple(arrays[key].shape) != tuple(shard.shape):
                out[key] = np.ascontiguousarray(arrays[key][cut])
    return out


def restore_spmd(trainer, arrays: Dict[str, np.ndarray], meta: dict,
                 iterator=None) -> None:
    """Fill a ``SPMDTrainer`` in place: its captured step graphs go on
    reading the same tensors, now holding the restored values, and no
    new capture is made. A trainer that has taken no step materializes
    its optimizer state first. Under fsdp each rank takes its slice of
    the assembled arrays into its shard tensors and optimizer state."""
    if meta.get("kind") != "spmd":
        raise MXNetError(f"capsule kind {meta.get('kind')!r} is not an "
                         f"SPMDTrainer capsule")
    if meta.get("train_idx") is not None and \
            [int(i) for i in meta["train_idx"]] != \
            [int(i) for i in trainer._train_idx]:
        raise MXNetError(
            "capsule trainable-parameter set differs from this "
            "trainer's (grad_req changed?) — refusing to misalign "
            "optimizer state")
    _check_count(meta, len(trainer._params))
    pairs = _param_pairs(trainer._params, arrays, trainer._names)
    if trainer._opt_state is None:
        trainer._materialize()
    arrays = _shard_arrays(trainer, arrays)
    for slot, shard in enumerate(trainer._shards):
        if shard is not None:
            i = trainer._train_idx[slot]
            pairs.append(_pair(f"shard of param/{i}", arrays, f"shard/{i}",
                               shard))
    counts = meta.get("opt_leaf_counts") or {}
    for slot, st in enumerate(trainer._opt_state):
        pairs += _state_pairs(st, arrays, f"opt/{slot}",
                              expect=int(counts.get(str(slot), 0)) or None)
    _write(pairs)
    trainer.step_count = int(meta.get("step_count", meta.get("step", 0)))
    _restore_counters(trainer._optimizer, meta)
    _restore_scaler(trainer, "loss_scaler", meta, inject=True)
    _restore_step_health(trainer, meta)
    _restore_rng(arrays)
    _restore_iterator(iterator, meta)
