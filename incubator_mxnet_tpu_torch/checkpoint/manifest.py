"""Sharded on-disk checkpoint step format (the port of
``incubator_mxnet_tpu/checkpoint/manifest.py``: numpy only, the same
files).

One committed snapshot is a DIRECTORY::

    <root>/step_00000042/
        manifest.json          # authoritative array index (rank 0)
        manifest.p<r>.json     # per-process piece, multi-host runs only
        shards_p<r>.bin        # rank r's addressable shards, concatenated

Write protocol (torn-write safety):

  1. every process writes its shard file into ``step_<N>.tmp/``;
  2. the manifest — which references every shard by (file, offset,
     nbytes, crc32, global index) — is written LAST;
  3. rank 0 renames ``step_<N>.tmp`` → ``step_<N>`` (atomic on POSIX).

A kill at any point leaves either a fully committed step or an ignorable
``.tmp``; readers only see directories whose manifest and shard set were
complete at rename time. Shard payloads are crc32-checked on read, so a
corrupt committed file fails loudly with the shard named.

Dtypes numpy lacks. bf16 and float8 arrays travel as their BIT PATTERNS:
an entry's ``dtype`` names the logical dtype (``"bfloat16"``,
``"float8_e4m3fn"``, ``"float8_e5m2"``, as the JAX package writes it) and
its shards are arrays of the same width (``uint16`` / ``uint8``: a
torch tensor's ``.view(torch.int16 | torch.uint8)`` bits); ``load_step``
returns those arrays as the bits (``bits_dtype``), bitwise. The files
are the JAX package's: a step either package writes, the other loads.

``MXTPU_CKPT_WRITE_DELAY`` (seconds) throttles the writer between
shards (a fault-injection hook); ``MXTPU_CKPT_FSYNC=1`` also fsyncs the
shard file, the manifest and the directories.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..base import MXNetError

__all__ = ["write_step", "load_step", "list_steps", "gc_steps",
           "step_dir", "bits_dtype", "FORMAT_VERSION", "MANIFEST_NAME"]

FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"
_STEP_PREFIX = "step_"
_TMP_SUFFIX = ".tmp"


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{_STEP_PREFIX}{step:08d}")


def _fsync_enabled() -> bool:
    return os.environ.get("MXTPU_CKPT_FSYNC", "0") not in ("0", "", "false")


def _fsync_file(path: str):
    if not _fsync_enabled():
        return
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str):
    if not _fsync_enabled():
        return
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse directory fsync; rename still atomic
    finally:
        os.close(fd)


# logical dtypes numpy lacks -> the unsigned integer of their width
_BITS = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
         "float8_e5m2": np.uint8}


def bits_dtype(name: str) -> np.dtype:
    """The numpy dtype an entry of logical dtype ``name`` is read back as:
    the dtype itself, or for bf16 / float8 the unsigned integer of their
    width (the bits)."""
    return np.dtype(_BITS.get(name, name))


def _raw_bytes(a: np.ndarray, dtype: str):
    """A shard's payload as a zero-copy byte view; its element width must
    be the entry dtype's."""
    a = np.ascontiguousarray(a)
    if a.dtype.itemsize != bits_dtype(dtype).itemsize:
        raise MXNetError(f"a {a.dtype} shard cannot hold {dtype} bits")
    return memoryview(a.reshape(-1).view(np.uint8))


def write_step(root: str, step: int, entries: Dict[str, dict],
               meta: Optional[dict] = None, process_index: int = 0,
               process_count: int = 1, sync_fn=None) -> str:
    """Write and commit one step directory.

    ``entries``: name → {"shape": tuple, "dtype": str, "spec": str|None,
    "shards": [(index, np.ndarray)]} where ``index`` is a list of
    [start, stop) pairs into the global shape (already deduplicated to
    this process's replica-0 shards). ``sync_fn`` is the cross-process
    barrier for multi-host runs (no-op when process_count == 1); rank 0
    commits after it returns. Returns the committed directory.
    """
    final = step_dir(root, step)
    tmp = final + _TMP_SUFFIX
    if os.path.exists(final):
        raise MXNetError(f"checkpoint step {step} already committed "
                         f"at {final}")
    # a stale .tmp from an aborted earlier attempt must NOT leak into
    # this commit: its per-rank manifests would merge after ours at
    # load time and silently overwrite fresh tensor regions (worse
    # when the job resumed with fewer processes). Rank 0 clears it,
    # and multi-host runs barrier before any rank writes.
    if process_index == 0 and os.path.exists(tmp):
        shutil.rmtree(tmp)
    if sync_fn is not None and process_count > 1:
        sync_fn()
    os.makedirs(tmp, exist_ok=True)
    delay = float(os.environ.get("MXTPU_CKPT_WRITE_DELAY", "0") or 0)

    shard_fname = f"shards_p{process_index}.bin"
    records: Dict[str, dict] = {}
    offset = 0
    with open(os.path.join(tmp, shard_fname), "wb") as f:
        for name, ent in entries.items():
            recs = []
            for index, arr in ent["shards"]:
                buf = _raw_bytes(arr, ent["dtype"])
                f.write(buf)
                recs.append({
                    "file": shard_fname,
                    "offset": offset,
                    "nbytes": len(buf),
                    "index": [list(map(int, pair)) for pair in index],
                    "crc32": zlib.crc32(buf) & 0xFFFFFFFF,
                })
                offset += len(buf)
                if delay:
                    f.flush()
                    time.sleep(delay)
            records[name] = {
                "shape": [int(s) for s in ent["shape"]],
                "dtype": ent["dtype"],
                "spec": ent.get("spec"),
                "shards": recs,
            }
    _fsync_file(os.path.join(tmp, shard_fname))

    manifest = {
        "format_version": FORMAT_VERSION,
        "step": int(step),
        "process_count": int(process_count),
        "timestamp": time.time(),
        "meta": meta or {},
        "arrays": records,
    }
    piece = MANIFEST_NAME if process_index == 0 \
        else f"manifest.p{process_index}.json"
    mpath = os.path.join(tmp, piece)
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    _fsync_file(mpath)

    if sync_fn is not None and process_count > 1:
        sync_fn()
    if process_index == 0:
        _fsync_dir(tmp)
        os.rename(tmp, final)
        _fsync_dir(root)
    return final


def list_steps(root: str) -> List[int]:
    """Committed steps, ascending. ``.tmp`` (torn) dirs are ignored."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if not name.startswith(_STEP_PREFIX) or name.endswith(_TMP_SUFFIX):
            continue
        if not os.path.exists(os.path.join(root, name, MANIFEST_NAME)):
            continue  # never legal post-commit; treat as torn
        try:
            out.append(int(name[len(_STEP_PREFIX):]))
        except ValueError:
            continue
    return sorted(out)


def _read_manifests(d: str) -> List[dict]:
    manifests = []
    for name in sorted(os.listdir(d)):
        if name == MANIFEST_NAME or (name.startswith("manifest.p")
                                     and name.endswith(".json")):
            with open(os.path.join(d, name)) as f:
                manifests.append(json.load(f))
    if not manifests:
        raise MXNetError(f"{d}: no manifest.json — not a committed "
                         f"checkpoint step")
    return manifests


def load_step(root: str, step: int) -> Tuple[Dict[str, np.ndarray], dict]:
    """Read one committed step → (name → assembled host array, meta).

    Every shard's crc32 is verified; a mismatch, truncation, or
    incomplete coverage of an array raises MXNetError naming the
    offending shard file and entry.
    """
    d = step_dir(root, step)
    if not os.path.isdir(d):
        raise MXNetError(f"checkpoint step {step} not found under {root}")
    manifests = _read_manifests(d)
    meta = manifests[0].get("meta", {})

    merged: Dict[str, dict] = {}
    for m in manifests:
        for name, rec in m.get("arrays", {}).items():
            if name in merged:
                merged[name]["shards"].extend(rec["shards"])
            else:
                merged[name] = {"shape": rec["shape"],
                                "dtype": rec["dtype"],
                                "spec": rec.get("spec"),
                                "shards": list(rec["shards"])}

    files = {}

    def _file(fname):
        if fname not in files:
            path = os.path.join(d, fname)
            if not os.path.exists(path):
                raise MXNetError(f"{d}: shard file {fname} missing from "
                                 f"committed step")
            files[fname] = open(path, "rb")
        return files[fname]

    out: Dict[str, np.ndarray] = {}
    try:
        for name, rec in merged.items():
            shape = tuple(rec["shape"])
            dt = bits_dtype(rec["dtype"])
            arr = np.empty(shape, dt)
            covered = 0
            for sh in rec["shards"]:
                f = _file(sh["file"])
                f.seek(sh["offset"])
                buf = f.read(sh["nbytes"])
                if len(buf) != sh["nbytes"]:
                    raise MXNetError(
                        f"{d}: shard of '{name}' in {sh['file']} @"
                        f"{sh['offset']} truncated "
                        f"({len(buf)}/{sh['nbytes']} bytes)")
                if (zlib.crc32(buf) & 0xFFFFFFFF) != sh["crc32"]:
                    raise MXNetError(
                        f"{d}: shard of '{name}' in {sh['file']} @"
                        f"{sh['offset']} failed crc32 verification — "
                        f"checkpoint is corrupt, refusing to load")
                idx = tuple(slice(a, b) for a, b in sh["index"])
                view = np.frombuffer(buf, dtype=dt)
                sub_shape = tuple(b - a for a, b in sh["index"])
                if not sub_shape:
                    arr[()] = view.reshape(())
                    covered += 1
                else:
                    arr[idx] = view.reshape(sub_shape)
                    covered += int(np.prod(sub_shape))
            total = int(np.prod(shape)) if shape else 1
            if covered < total:
                raise MXNetError(
                    f"{d}: shards of '{name}' cover {covered}/{total} "
                    f"elements — a process's shard file is missing")
            out[name] = arr
    finally:
        for f in files.values():
            f.close()
    return out, meta


def gc_steps(root: str, keep: int) -> List[int]:
    """Delete all but the newest ``keep`` committed steps (and any stale
    ``.tmp`` turds older than the newest commit). Returns deleted steps."""
    steps = list_steps(root)
    deleted = []
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(step_dir(root, s), ignore_errors=True)
        deleted.append(s)
    if steps:
        newest = step_dir(root, steps[-1])
        for name in os.listdir(root):
            if name.endswith(_TMP_SUFFIX):
                full = os.path.join(root, name)
                try:
                    if os.path.getmtime(full) < os.path.getmtime(newest):
                        shutil.rmtree(full, ignore_errors=True)
                except OSError:
                    pass
    return deleted
