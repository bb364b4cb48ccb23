"""The port's checkpoint manager and capsule against the JAX package's,
on the CPU.

  - the manager cases of ``tests/test_checkpoint.py`` on the port: the
    round trip and keep-last-k GC, one write in flight, the latched
    background error, transient and persistent write failures (and the
    synchronous path), torn and stale ``.tmp`` directories, a corrupt or
    missing shard named in the error, a ``kill -9`` mid-shard, and the
    three walk-back cases of ``restore()``;
  - step directories cross the packages: a step the JAX
    ``CheckpointManager`` wrote restores in the port with its arrays
    bitwise (bf16 as its bits) and its meta equal, and the reverse;
  - capsule blobs cross both ways: for the same tree the two packages
    write the same bytes, each loads the other's, and ``nd.load`` opens
    a blob of either package;
  - the gather copies: a leaf written after ``save`` returns does not
    reach the snapshot;
  - SIGTERM drains the in-flight snapshot and writes a final capsule,
    and skips when the step is already committed (``test_sigterm_*``).
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from incubator_mxnet_tpu import checkpoint as jckpt
from incubator_mxnet_tpu import nd as jnd

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, nd
from incubator_mxnet_tpu_torch import checkpoint as ckpt
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.optimizer.lr_scheduler import FactorScheduler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ------------------------------------------------------------------ #
# manager
# ------------------------------------------------------------------ #

def test_manifest_roundtrip_and_gc(tmp_path):
    m = ckpt.CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(24.0).reshape(4, 6),
            "b": np.arange(3, dtype=np.int32),
            "s": np.float32(2.5)}
    for s in (1, 2, 3):
        m.save(s, tree, meta={"tag": s}, block=True)
    assert m.all_steps() == [2, 3]          # keep-last-2 GC ran
    arrays, meta = m.restore()
    assert meta["tag"] == 3
    np.testing.assert_array_equal(arrays["w"],
                                  np.arange(24.0).reshape(4, 6))
    np.testing.assert_array_equal(arrays["b"], np.arange(3))
    assert arrays["s"].shape == ()
    arrays2, meta2 = m.restore(step=2)
    assert meta2["tag"] == 2
    m.close()


def test_async_writer_commits_and_one_in_flight(tmp_path):
    m = ckpt.CheckpointManager(str(tmp_path), keep=0)
    tree = {"x": torch.ones((64, 64))}
    for s in range(4):
        m.save(s, tree)                     # async; bounded at 1 in flight
    m.wait()
    assert m.all_steps() == [0, 1, 2, 3]
    assert m.committed_steps == 4 and m.last_write_ms is not None
    m.close()


def test_snapshot_is_the_state_at_save(tmp_path, monkeypatch):
    """The gather copies every leaf before ``save`` returns: in-place
    writes made while the write is still in flight do not reach it."""
    monkeypatch.setenv("MXTPU_CKPT_WRITE_DELAY", "0.02")
    m = ckpt.CheckpointManager(str(tmp_path), keep=0)
    w = torch.arange(16.0)
    bf = torch.linspace(-1, 1, 8).to(torch.bfloat16)
    want_w, want_bf = w.clone(), bf.clone()
    m.save(1, {"w": w, "bf": bf, "nd": nd.array(np.ones(3), ctx=mx.cpu())})
    w.add_(100.0)
    bf.mul_(3)
    m.wait()
    arrays, _ = m.restore()
    np.testing.assert_array_equal(arrays["w"], want_w.numpy())
    assert arrays.dtypes["bf"] == "bfloat16"
    np.testing.assert_array_equal(
        arrays["bf"], want_bf.view(torch.int16).numpy().view(np.uint16))
    m.close()


def test_background_write_error_surfaces(tmp_path):
    m = ckpt.CheckpointManager(str(tmp_path), keep=0)
    tree = {"x": torch.ones((4,))}
    m.save(7, tree, block=True)
    m.save(7, tree)                         # async duplicate -> fails
    with pytest.raises(MXNetError, match="background checkpoint write"):
        m.wait()
        m.save(8, tree)
        m.wait()
    m.close()


def test_transient_write_failures_retried_then_commit(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("MXTPU_CKPT_RETRY_ATTEMPTS", "3")
    monkeypatch.setenv("MXTPU_CKPT_RETRY_BACKOFF", "0.01")
    monkeypatch.setenv("MXTPU_CKPT_FAIL_WRITES", "2")
    m = ckpt.CheckpointManager(str(tmp_path), keep=0)
    m.save(1, {"x": torch.ones((8,))})      # async
    m.wait()
    assert m.all_steps() == [1]
    assert m.write_retries == 2
    m.save(2, {"x": torch.ones((8,))}, block=True)
    assert m.all_steps() == [1, 2]
    assert m.write_retries == 2
    m.close()


def test_persistent_write_failure_latches_after_retries(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("MXTPU_CKPT_RETRY_ATTEMPTS", "3")
    monkeypatch.setenv("MXTPU_CKPT_RETRY_BACKOFF", "0.01")
    monkeypatch.setenv("MXTPU_CKPT_FAIL_WRITES", "3")
    m = ckpt.CheckpointManager(str(tmp_path), keep=0)
    m.save(1, {"x": torch.ones((8,))})      # async: all 3 attempts fail
    with pytest.raises(MXNetError, match="background checkpoint write"):
        m.wait()
    assert m.all_steps() == []
    assert m.write_retries == 2
    m.close()


def test_sync_write_failure_raises_after_retries(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_CKPT_RETRY_ATTEMPTS", "2")
    monkeypatch.setenv("MXTPU_CKPT_RETRY_BACKOFF", "0.01")
    monkeypatch.setenv("MXTPU_CKPT_FAIL_WRITES", "1")
    m = ckpt.CheckpointManager(str(tmp_path), keep=0)
    m.save(3, {"x": torch.ones((4,))}, block=True)   # 1 failure, retried
    assert m.all_steps() == [3]
    monkeypatch.setenv("MXTPU_CKPT_FAIL_WRITES", "3")
    m._injected_failures = 0
    with pytest.raises(OSError, match="injected transient"):
        m.save(4, {"x": torch.ones((4,))}, block=True)
    assert m.all_steps() == [3]
    m.close()


def test_torn_tmp_and_manifestless_dirs_ignored(tmp_path):
    root = str(tmp_path)
    m = ckpt.CheckpointManager(root, keep=0)
    m.save(5, {"x": torch.ones((8,))}, block=True)
    os.makedirs(os.path.join(root, "step_00000006.tmp"))
    with open(os.path.join(root, "step_00000006.tmp", "shards_p0.bin"),
              "wb") as f:
        f.write(b"\x00" * 128)
    os.makedirs(os.path.join(root, "step_00000007"))
    assert m.all_steps() == [5]
    arrays, _ = m.restore()
    assert "x" in arrays
    m.close()


def test_stale_tmp_from_aborted_attempt_is_cleared(tmp_path):
    root = str(tmp_path)
    stale = ckpt.step_dir(root, 4) + ".tmp"
    os.makedirs(stale)
    with open(os.path.join(stale, "shards_p1.bin"), "wb") as f:
        f.write(b"\xde\xad" * 64)
    with open(os.path.join(stale, "manifest.p1.json"), "w") as f:
        f.write('{"arrays": {"w": {"shape": [4], "dtype": "float32", '
                '"shards": [{"file": "shards_p1.bin", "offset": 0, '
                '"nbytes": 16, "crc32": 0, "index": [[0, 4]]}]}}, '
                '"meta": {}}')
    m = ckpt.CheckpointManager(root, keep=0)
    m.save(4, {"w": torch.arange(4.0)}, block=True)
    committed = ckpt.step_dir(root, 4)
    assert not os.path.exists(os.path.join(committed, "shards_p1.bin"))
    arrays, _ = m.restore(step=4)
    np.testing.assert_array_equal(arrays["w"], np.arange(4.0))
    m.close()


def test_corrupt_shard_fails_loudly_naming_shard(tmp_path):
    root = str(tmp_path)
    m = ckpt.CheckpointManager(root, keep=0)
    m.save(1, {"w": torch.arange(256.0), "v": torch.ones((16,))},
           block=True)
    shard = os.path.join(ckpt.step_dir(root, 1), "shards_p0.bin")
    with open(shard, "r+b") as f:           # flip one byte mid-file
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(MXNetError) as ei:
        m.restore(step=1)
    assert "shards_p0.bin" in str(ei.value) and "crc32" in str(ei.value)
    m.close()


def test_missing_shard_file_fails_loudly(tmp_path):
    root = str(tmp_path)
    m = ckpt.CheckpointManager(root, keep=0)
    m.save(1, {"w": torch.ones((8, 8))}, block=True)
    os.remove(os.path.join(ckpt.step_dir(root, 1), "shards_p0.bin"))
    with pytest.raises(MXNetError, match="shards_p0.bin"):
        m.restore(step=1)
    m.close()


def test_kill9_mid_shard_previous_commit_survives(tmp_path):
    """SIGKILL the process while the background writer is mid-shard
    (the MXTPU_CKPT_WRITE_DELAY throttle): the previous commit loads and
    the torn step is invisible."""
    root = str(tmp_path / "ckpts")
    script = f"""
import os
import torch
from incubator_mxnet_tpu_torch import checkpoint as ckpt
m = ckpt.CheckpointManager({root!r}, keep=0)
tree1 = {{f'a{{i}}': torch.full((32,), float(i)) for i in range(8)}}
m.save(1, tree1, meta={{'ok': True}}, block=True)
print('COMMITTED', flush=True)
os.environ['MXTPU_CKPT_WRITE_DELAY'] = '0.05'
big = {{f'b{{i}}': torch.full((64,), float(i)) for i in range(200)}}
m.save(2, big)                       # async: ~10 s of throttled writing
print('WRITING', flush=True)
import time; time.sleep(60)
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, cwd=ROOT, env=env,
                            text=True)
    try:
        tmp_dir = ckpt.step_dir(root, 2) + ".tmp"
        deadline = time.time() + 120
        saw_writing = False
        while time.time() < deadline:
            line = proc.stdout.readline()
            if "WRITING" in line:
                saw_writing = True
                break
        assert saw_writing, "child never started the async write"
        shard = os.path.join(tmp_dir, "shards_p0.bin")
        while time.time() < deadline:
            if os.path.exists(shard) and os.path.getsize(shard) > 0:
                break
            time.sleep(0.01)
        proc.kill()                          # SIGKILL mid-shard
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
    assert os.path.exists(tmp_dir), "expected a torn .tmp dir"
    assert ckpt.list_steps(root) == [1], "torn step leaked into commits"
    arrays, meta = ckpt.load_step(root, 1)
    assert meta == {"ok": True}
    for i in range(8):
        np.testing.assert_array_equal(arrays[f"a{i}"],
                                      np.full((32,), i, np.float32))


def test_restore_falls_back_to_previous_step_on_corrupt_latest(tmp_path):
    root = str(tmp_path)
    m = ckpt.CheckpointManager(root, keep=3)
    for s in (1, 2, 3):
        m.save(s, {"w": torch.full((64,), float(s))}, block=True)
    shard = os.path.join(ckpt.step_dir(root, 3), "shards_p0.bin")
    with open(shard, "r+b") as f:           # truncate the latest shard
        f.truncate(17)
    with pytest.warns(RuntimeWarning, match="step 3 is unreadable"):
        arrays, _ = m.restore()
    np.testing.assert_array_equal(arrays["w"], np.full((64,), 2.0))
    assert m.restore_fallbacks == 1
    with pytest.raises(MXNetError, match="shards_p0.bin"):
        m.restore(step=3)
    with pytest.raises(MXNetError, match="shards_p0.bin"):
        m.restore(fallback=False)
    m.close()


def test_restore_every_step_corrupt_raises(tmp_path):
    root = str(tmp_path)
    m = ckpt.CheckpointManager(root, keep=2)
    for s in (1, 2):
        m.save(s, {"w": torch.ones((32,))}, block=True)
    for s in (1, 2):
        with open(os.path.join(ckpt.step_dir(root, s),
                               "shards_p0.bin"), "r+b") as f:
            f.truncate(3)
    with pytest.warns(RuntimeWarning):
        with pytest.raises(MXNetError, match="every committed"):
            m.restore()
    m.close()


def test_restore_falls_back_on_corrupt_manifest(tmp_path):
    root = str(tmp_path)
    m = ckpt.CheckpointManager(root, keep=3)
    for s in (1, 2):
        m.save(s, {"w": torch.full((16,), float(s))}, block=True)
    mpath = os.path.join(ckpt.step_dir(root, 2), "manifest.json")
    with open(mpath, "w") as f:
        f.write('{"format_version": 1, "arrays": {TRUNCATED')
    with pytest.warns(RuntimeWarning, match="step 2 is unreadable"):
        arrays, _ = m.restore()
    np.testing.assert_array_equal(arrays["w"], np.full((16,), 1.0))
    m.close()


# ------------------------------------------------------------------ #
# across the packages
# ------------------------------------------------------------------ #

def _tree_np():
    """One tree as numpy: f32, bf16 (ml_dtypes), int32, a 0-d f32."""
    import ml_dtypes
    rng = np.random.RandomState(0)
    return {"param/0": rng.randn(4, 6).astype(np.float32),
            "param/1": rng.randn(8).astype(ml_dtypes.bfloat16),
            "opt/0/0": np.arange(5, dtype=np.int32),
            "step": np.float32(3.5)}


def _port_tree(tree):
    out = {}
    for k, a in tree.items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            out[k] = torch.from_numpy(a.view(np.int16).copy()) \
                .view(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(a.copy())
    return out


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


_META = {"kind": "spmd", "step": 3, "num_update": 3,
         "index_update_count": {"0": 3}, "opt_leaf_counts": {"0": 1}}


def test_jax_step_directory_restores_in_the_port(tmp_path):
    tree = _tree_np()
    jm = jckpt.CheckpointManager(str(tmp_path), keep=0)
    jm.save(3, {k: jnp.asarray(v) for k, v in tree.items()}, meta=_META,
            block=True)
    jm.close()
    arrays, meta = ckpt.CheckpointManager(str(tmp_path)).restore()
    assert meta == _META
    assert sorted(arrays) == sorted(tree)
    assert arrays.dtypes["param/1"] == "bfloat16"
    for k, a in tree.items():
        got = arrays[k]
        assert got.shape == np.asarray(a).shape
        np.testing.assert_array_equal(got, _bits(a))


def test_port_step_directory_restores_in_jax(tmp_path):
    tree = _tree_np()
    m = ckpt.CheckpointManager(str(tmp_path), keep=0)
    m.save(3, _port_tree(tree), meta=_META)
    m.close()
    arrays, meta = jckpt.CheckpointManager(str(tmp_path)).restore()
    assert meta == _META
    for k, a in tree.items():
        assert arrays[k].dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(_bits(arrays[k]), _bits(a))


def test_capsule_blobs_cross_the_packages():
    tree = _tree_np()
    jblob = jckpt.dump_capsule_bytes(
        {k: jnp.asarray(v) for k, v in tree.items()}, _META)
    tblob = ckpt.dump_capsule_bytes(_port_tree(tree), _META)
    assert tblob == jblob                    # the same bytes
    arrays, meta = ckpt.load_capsule_bytes(jblob)
    assert meta == _META and arrays.dtypes["param/1"] == "bfloat16"
    for k, a in tree.items():
        np.testing.assert_array_equal(arrays[k], _bits(a))
    jarrays, jmeta = jckpt.load_capsule_bytes(tblob)
    assert jmeta == _META
    for k, a in tree.items():
        np.testing.assert_array_equal(_bits(jarrays[k]), _bits(a))
    bad = bytearray(tblob)
    bad[-3] ^= 0xFF
    with pytest.raises(MXNetError, match="crc32"):
        ckpt.load_capsule_bytes(bytes(bad))
    with pytest.raises(MXNetError, match="bad magic"):
        ckpt.load_capsule_bytes(b"not a capsule")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_nd_load_opens_a_capsule_blob(tmp_path, writer):
    tree = _tree_np()
    meta = dict(_META, param_names=["w", "b"])
    fname = str(tmp_path / "run.capsule")
    if writer == "jax":
        jckpt.save_capsule_file(fname, {k: jnp.asarray(v)
                                        for k, v in tree.items()}, meta)
    else:
        ckpt.save_capsule_file(fname, _port_tree(tree), meta)
    got = nd.load(fname, ctx=mx.cpu())
    assert sorted(got) == ["b", "w"]
    np.testing.assert_array_equal(got["w"].asnumpy(), tree["param/0"])
    assert got["b"]._data.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["b"]._data.view(torch.int16).numpy().view(np.uint16),
        _bits(tree["param/1"]))
    jgot = jnd.load(fname)
    np.testing.assert_array_equal(jgot["w"].asnumpy(), tree["param/0"])


# ------------------------------------------------------------------ #
# preemption (the gluon Trainer of tests/test_checkpoint.py: an f32 and
# a bf16 Dense, Adam under a stepped FactorScheduler)
# ------------------------------------------------------------------ #

_RNG = np.random.RandomState(0)
_X = _RNG.randn(80, 8).astype(np.float32)
_Y = _RNG.randn(80, 8).astype(np.float32)


class PositionIter:
    """The smallest resumable iterator: ``tell`` / ``set_position`` over
    fixed batches of 8."""

    def __init__(self):
        self.pos = 0

    def next(self):
        i = self.pos % 10
        self.pos += 1
        with mx.cpu():
            return (nd.array(_X[8 * i:8 * i + 8]),
                    nd.array(_Y[8 * i:8 * i + 8]))

    def tell(self):
        return {"pos": self.pos}

    def set_position(self, state):
        self.pos = int(state["pos"])


def make_trainer(seed):
    mx.random.seed(seed)
    net = nn.Sequential()
    net.add(nn.Dense(16, in_units=8))
    net.add(nn.Dense(8, in_units=16))
    with mx.cpu():
        net.initialize()
    for p in net[1].collect_params().values():
        p.cast("bfloat16")
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 1e-2,
                        "lr_scheduler": FactorScheduler(step=3,
                                                        factor=0.5)},
                       kvstore=None, fuse_step=True)
    return net, tr


def train_steps(net, tr, it, n):
    out = []
    loss_fn = gluon.loss.L2Loss()
    for _ in range(n):
        x, y = it.next()
        with mx.cpu(), autograd.record():
            h = net[0](x).astype("bfloat16")
            L = loss_fn(net[1](h).astype("float32"), y)
        L.backward()
        tr.step(x.shape[0])
        out.append(float(L.mean().asnumpy()))
    return out


def test_sigterm_drains_inflight_and_saves_final_capsule(tmp_path,
                                                         monkeypatch):
    net, tr = make_trainer(0)
    it = PositionIter()
    train_steps(net, tr, it, 3)
    m = ckpt.CheckpointManager(str(tmp_path), keep=0)
    monkeypatch.setenv("MXTPU_CKPT_WRITE_DELAY", "0.01")
    try:
        tr.save_checkpoint(m, step=100, iterator=it)   # in flight
        tr.install_preemption(m, iterator=it, exit_after=False)
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        monkeypatch.delenv("MXTPU_CKPT_WRITE_DELAY")
        m.uninstall_preemption_hook()
    steps = m.all_steps()
    assert 100 in steps
    assert tr._optimizer.num_update in steps
    arrays, meta = m.restore(step=tr._optimizer.num_update)
    assert meta.get("preempted") is True
    net2, tr2 = make_trainer(1)
    it2 = PositionIter()
    tr2.restore_checkpoint(m, step=tr._optimizer.num_update, iterator=it2)
    assert it2.pos == it.pos == 3
    for a, b in zip(tr._params, tr2._params):
        assert torch.equal(a.data()._data, b.data()._data)
    m.close()


def test_sigterm_skips_when_step_already_committed(tmp_path):
    net, tr = make_trainer(0)
    it = PositionIter()
    train_steps(net, tr, it, 2)
    m = ckpt.CheckpointManager(str(tmp_path), keep=0)
    tr.save_checkpoint(m, iterator=it, block=True)
    before = m.all_steps()
    tr.install_preemption(m, iterator=it, exit_after=False)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        m.uninstall_preemption_hook()
    assert m.all_steps() == before       # no duplicate-step crash
    m.close()


# ------------------------------------------------------------------ #
# iterator position export (tests/test_checkpoint.py's four cases; the
# port's shuffles draw from mx.random's host stream)
# ------------------------------------------------------------------ #

def test_ndarrayiter_tell_set_position_mid_epoch_shuffled(tmp_path):
    from incubator_mxnet_tpu_torch.io import NDArrayIter
    mx.random.seed(4)
    a = NDArrayIter(_X, _Y, batch_size=8, shuffle=True)
    [a.next() for _ in range(4)]
    pos = a.tell()
    rest_ref = [b.data[0].asnumpy() for b in list(a)]
    b_it = NDArrayIter(_X, _Y, batch_size=8, shuffle=True)
    b_it.set_position(pos)
    rest = [b.data[0].asnumpy() for b in list(b_it)]
    assert len(rest) == len(rest_ref) == 6
    for r, rr in zip(rest, rest_ref):
        np.testing.assert_array_equal(r, rr)
    # the capsule carries it: a trainer's checkpoint with iterator=
    net, tr = make_trainer(0)
    m = ckpt.CheckpointManager(str(tmp_path), keep=0)
    a.reset()
    [a.next() for _ in range(3)]
    tr.save_checkpoint(m, step=3, iterator=a, block=True)
    want = [b.data[0].asnumpy() for b in list(a)]
    c = NDArrayIter(_X, _Y, batch_size=8, shuffle=True)
    make_trainer(1)[1].restore_checkpoint(m, iterator=c)
    got = [b.data[0].asnumpy() for b in list(c)]
    assert len(got) == len(want) == 7
    for r, rr in zip(got, want):
        np.testing.assert_array_equal(r, rr)
    m.close()


def test_prefetching_iter_reports_resumable_position():
    from incubator_mxnet_tpu_torch.io import NDArrayIter, PrefetchingIter
    mx.random.seed(5)
    pf = PrefetchingIter(NDArrayIter(_X, _Y, batch_size=8, shuffle=True))
    [pf.next() for _ in range(4)]
    pos = pf.tell()
    assert pos["delivered"] == 4
    rest_ref = [b.data[0].asnumpy() for b in list(pf)]
    pf2 = PrefetchingIter(NDArrayIter(_X, _Y, batch_size=8, shuffle=True))
    pf2.set_position(pos)
    rest = [b.data[0].asnumpy() for b in list(pf2)]
    assert len(rest) == len(rest_ref) == 6
    for r, rr in zip(rest, rest_ref):
        np.testing.assert_array_equal(r, rr)


def test_resize_iter_position_delegates():
    from incubator_mxnet_tpu_torch.io import NDArrayIter, ResizeIter
    r = ResizeIter(NDArrayIter(_X, _Y, batch_size=8), size=6)
    r.next(), r.next()
    pos = r.tell()
    assert pos["cur"] == 2 and pos["inner"]["cursor"] >= 0
    r2 = ResizeIter(NDArrayIter(_X, _Y, batch_size=8), size=6)
    r2.set_position(pos)
    np.testing.assert_array_equal(r2.next().data[0].asnumpy(),
                                  r.next().data[0].asnumpy())


def test_non_resumable_iterator_refuses_loudly():
    from incubator_mxnet_tpu_torch.io import DataIter, PrefetchingIter
    with pytest.raises(MXNetError, match="position export"):
        DataIter().tell()
    with pytest.raises(MXNetError, match="position restore"):
        DataIter().set_position({})

    class Plain(DataIter):
        def next(self):
            raise StopIteration
    with pytest.raises(MXNetError, match="not resumable"):
        PrefetchingIter(Plain(8)).tell()
