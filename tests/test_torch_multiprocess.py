"""Data parallelism across processes, on the CPU: two gloo ranks started
once through the unchanged ``tools/launch.py --launcher local``, each
running every scenario of ``tests/test_torch_dist_worker.py`` in one
process group, held here against the JAX package on its forced CPU
devices or against the port in one process.

  - ``SPMDTrainer`` dp2 and fsdp2, 3 Adam steps (lr 1e-2) of a
    (512 -> 64 -> 8) MLP: losses against the JAX trainer on a dp2 /
    fsdp2 mesh within rtol 1e-5, whole parameters (fsdp shards
    all-gathered) within rtol 1e-5 / atol 5e-5 (the reductions add in
    another order, and Adam's normalized step turns an ulp of a
    near-zero gradient into up to 2e-5); both ranks' parameters bitwise
    equal; ``step_trace_count`` equal to the JAX jit count;
  - ``step_microbatches`` at k = 2, the same against JAX; its
    ``accum_step_trace_count`` is 1, the JAX contract (the JAX trainer
    itself retraces on this CPU, a known failure of its own suite:
    ``tests/test_train_perf.py::test_spmd_accum_count_change_never_retraces``);
  - a NaN in one rank's rows: the step is skipped on both ranks,
    parameters bitwise frozen;
  - ``SyncBatchNorm`` over dp2: the trajectory of the port in one
    process on the whole batch within rtol 1e-5 (a plain BatchNorm's
    per-shard statistics miss it);
  - ``dist_sync`` push / pull sums, bf16 and 2-bit compression with
    error feedback (the values of the JAX ``tests/dist_worker.py``);
  - ``gluon.Trainer(kvstore="dist_sync", overlap_allreduce=True)`` over
    the two workers against the port's single-process Trainer on the
    whole batch (rtol 1e-5) over 4 steps, buckets issued during backward
    in the plan's order; with ``int8_allreduce`` within 2e-3 of it;
    ``allreduce_grads()`` + ``update()`` bitwise ``step()``;
  - the fsdp capsule writes each shard once (two shard files, the
    process index and count in each manifest piece), and a dp2 / fsdp2
    resume is bitwise the uninterrupted run.

A rank that dies, or a run past its 240 s limit, fails the tests.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import jax
import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.parallel import mesh as jmesh

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, nd, parallel
from incubator_mxnet_tpu_torch.gluon.contrib.nn import SyncBatchNorm

import test_torch_dist_worker as w

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' results: ``(arrays, scalars)`` per rank, and the
    output directory."""
    out = str(tmp_path_factory.mktemp("dist"))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
           "2", "--launcher", "local", "--", sys.executable,
           os.path.join(ROOT, "tests", "test_torch_dist_worker.py"), out]
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        pytest.fail("the two-rank run passed its 240 s limit:\n" + log[-4000:])
    if proc.returncode != 0:
        pytest.fail(f"a rank failed (exit {proc.returncode}):\n"
                    + log[-6000:])
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            scalars = json.load(f)
        ranks.append((dict(np.load(os.path.join(out, f"rank{r}.npz"))),
                      scalars))
    return ranks, out


def _jax_trainer(mode, loss=w.mse, **kw):
    jmx.random.seed(0)
    net = w.mlp(jgluon)
    net.initialize()
    w.seed_params(net, 0, jnd)
    axes = {"dp": 2} if mode == "replicated" else {"fsdp": 2}
    mesh = jmesh.build_mesh(devices=jax.devices()[:2], axis_sizes=axes)
    return net, jparallel.SPMDTrainer(
        net, loss=loss, optimizer="adam",
        optimizer_params={"learning_rate": 1e-2}, mesh=mesh,
        sharding=mode, **kw)


def _in_order(arrays, prefix):
    """The worker's arrays under ``prefix``, in its parameter order (the
    names' counters differ between processes)."""
    return [v for k, v in arrays.items() if k.startswith(prefix + "/")]


def _same_on_both_ranks(run, prefix):
    (a0, _), (a1, _) = run[0]
    for k in a0:
        if k.startswith(prefix + "/"):
            np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)


def test_two_gloo_ranks(run):
    (_, s0), (_, s1) = run[0]
    assert s0["world"] == s1["world"] == 2
    assert s0["backend"] == "gloo"
    assert (s0["kv_rank"], s1["kv_rank"]) == (0, 1)
    assert s0["kv_workers"] == 2


@pytest.mark.parametrize("poison", [False, True])
def test_int8_bucket_allreduce_matches_jax(run, poison):
    """The port's two ranks against the JAX function over the stacked
    per-rank gradients (``vmap`` over a named axis stands for the
    ranks): equal where finite; a NaN on one rank poisons every member
    on both, in both packages."""
    from incubator_mxnet_tpu.parallel.collectives import \
        int8_bucket_allreduce as jint8
    stacked = [np.stack(m) for m in zip(*[w.rank_grads(r, poison)
                                          for r in range(2)])]
    want = jax.vmap(lambda *v: jint8(list(v), "r"), axis_name="r")(
        *stacked)
    tag = "int8nan" if poison else "int8"
    for r, (arrays, _) in enumerate(run[0]):
        for k in range(2):
            got, ref = arrays[f"coll/{tag}{k}"], np.asarray(want[k][r])
            if poison:
                assert not np.isfinite(got).any()
                assert not np.isfinite(ref).any()
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_collectives_over_two_ranks(run):
    """The ring, reduce-scatter, all-gather, bf16 all-reduce, broadcast
    and the 2-bit all-reduce against numpy on both ranks' inputs."""
    from incubator_mxnet_tpu.parallel import collectives as jcoll
    flats = [w.rank_flat(r) for r in range(2)]
    mats = [w.rank_flat(r, 24).reshape(4, 6) for r in range(2)]
    mean = (mats[0] + mats[1]) / 2
    bf16 = sum(np.asarray(jnd.array(f).astype("bfloat16")
                          .astype("float32").asnumpy()) for f in flats)
    for r, (arrays, _) in enumerate(run[0]):
        np.testing.assert_array_equal(arrays["coll/ring"],
                                      flats[0] + flats[1])
        np.testing.assert_allclose(arrays["coll/reduce_scatter"],
                                   mean[:, 3 * r:3 * r + 3], rtol=1e-6)
        np.testing.assert_array_equal(arrays["coll/all_gather"],
                                      np.concatenate(mats, axis=1))
        np.testing.assert_array_equal(arrays["coll/bf16"], bf16)
        np.testing.assert_array_equal(arrays["coll/broadcast"], flats[1])
    # 2-bit: every rank's quantized contribution (with its own residual
    # stream, run here through the JAX codec) summed
    res = [None, None]
    for t in range(3):
        total = 0.0
        for r in range(2):
            _, deq, res[r] = jcoll.quantize_2bit(
                jnd.array(w.rank_flat(r, 103))._data, res[r], 0.5)
            total = total + np.asarray(deq)
        for arrays, _ in run[0]:
            np.testing.assert_array_equal(arrays[f"coll/2bit{t}"], total)


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_spmd_trainer_matches_jax(run, mode):
    (a0, s0), (_, s1) = run[0]
    _same_on_both_ranks(run, mode)
    assert s0[f"{mode}_losses"] == s1[f"{mode}_losses"]
    x, y = w.data()
    net, tr = _jax_trainer(mode)
    want = [float(tr.step(jnd.array(x), jnd.array(y)).asnumpy())
            for _ in range(3)]
    np.testing.assert_allclose(s0[f"{mode}_losses"], want, rtol=1e-5)
    assert s0[f"{mode}_trace"] == tr.step_trace_count == 1
    jparams = [p.data().asnumpy() for p in net.collect_params().values()]
    names = [k for k in a0 if k.startswith(mode + "/")
             and "resident" not in k]
    assert len(names) == len(jparams)
    order = sorted(names, key=lambda k: list(a0).index(k))
    for k, want_p in zip(order, jparams):
        np.testing.assert_allclose(a0[k], want_p, rtol=1e-5, atol=5e-5,
                                   err_msg=k)
    # the resident full weight is the gathered shards
    np.testing.assert_array_equal(a0[f"{mode}/resident0"], a0[order[0]])
    assert s0[f"{mode}_shard_dims"] == (
        [0, None, None, None] if mode == "fsdp" else [None] * 4)
    # shard_params names the same plan: the first matrix on the fsdp axis
    fsdp_axis = list(parallel.mesh.AXES).index("fsdp")
    for k, pl in enumerate(s0[f"{mode}_placements"]):
        sharded = mode == "fsdp" and k == 0
        assert pl[fsdp_axis] == ("Shard(dim=0)" if sharded
                                 else "Replicate()"), (k, pl)


def test_step_microbatches_matches_jax(run):
    (a0, s0), (_, s1) = run[0]
    _same_on_both_ranks(run, "micro")
    x, y = w.data()
    net, tr = _jax_trainer("replicated")
    want = [float(tr.step_microbatches(
        [(jnd.array(x[:8]), jnd.array(y[:8])),
         (jnd.array(x[8:]), jnd.array(y[8:]))]).asnumpy())
        for _ in range(2)]
    np.testing.assert_allclose(s0["micro_losses"], want, rtol=1e-5)
    assert s0["micro_trace"] == 1
    order = [k for k in a0 if k.startswith("micro/")]
    for k, p in zip(order, net.collect_params().values()):
        np.testing.assert_allclose(a0[k], p.data().asnumpy(), rtol=1e-5,
                                   atol=5e-5, err_msg=k)


def test_nan_step_skipped_on_both_ranks(run):
    for _, s in run[0]:
        assert s["nan_outcome"].endswith("SKIPPED_NONFINITE")
        assert s["nan_step_count"] == 1
        assert s["nan_frozen"] is True
        assert s["nan_trace"] == 1


def test_sync_batch_norm_global_statistics(run):
    (a0, s0), (_, s1) = run[0]
    _same_on_both_ranks(run, "syncbn")
    bx, by = w.bn_data()
    with mx.cpu():
        mx.random.seed(5)
        net = w.bn_net(gluon, SyncBatchNorm)
        net.initialize()
        w.seed_params(net, 5, nd)
        tr = parallel.SPMDTrainer(
            net, loss=gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
            optimizer_params={"learning_rate": 0.05})
        want = [float(tr.step(nd.array(bx), nd.array(by)).asnumpy())
                for _ in range(3)]
        params = [p.data().asnumpy()
                  for p in net.collect_params().values()]
    np.testing.assert_allclose(s0["syncbn_losses"], want, rtol=1e-5)
    got = _in_order(a0, "syncbn")
    assert len(got) == len(params)
    for g, v in zip(got, params):
        np.testing.assert_allclose(g, v, rtol=1e-5, atol=1e-6)
    # per-shard statistics are another trajectory
    assert not np.allclose(s0["plainbn_losses"], want, rtol=1e-5)


def test_dist_sync_kvstore_and_2bit_compression(run):
    for arrays, _ in run[0]:
        np.testing.assert_allclose(arrays["kv/sum"], 3.0)      # 1 + 2
        np.testing.assert_allclose(arrays["kv/bf16"], 3.0)
        # 0.3 >= threshold / 2 rounds up to 0.5 on each worker, leaving
        # residual -0.2; the second push sees 0.1 -> 0, residual 0.1
        np.testing.assert_allclose(arrays["kv/2bit0"], 1.0)
        np.testing.assert_allclose(arrays["kv/2bit_residual0"], -0.2,
                                   rtol=1e-6)
        np.testing.assert_allclose(arrays["kv/2bit1"], 0.0)
        np.testing.assert_allclose(arrays["kv/2bit_residual1"], 0.1,
                                   rtol=1e-5)
        np.testing.assert_allclose(arrays["kv/2bit_acc"], 12.0, atol=1.0)


def _single_process_gluon(**kw):
    sx = np.random.RandomState(1).randn(16, 8).astype(np.float32)
    sy = np.random.RandomState(2).randn(16, 4).astype(np.float32)
    with mx.cpu():
        net = w.small_mlp(gluon)
        net.initialize()
        w.seed_params(net, 3, nd)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore="device", **kw)
        loss_fn = gluon.loss.L2Loss()
        for _ in range(4):
            with autograd.record():
                L = loss_fn(net(nd.array(sx)), nd.array(sy))
            L.backward()
            tr.step(16)
        return [p.data().asnumpy() for p in net.collect_params().values()]


def test_gluon_trainer_over_workers(run):
    (a0, s0), (_, s1) = run[0]
    _same_on_both_ranks(run, "gluon")
    _same_on_both_ranks(run, "gluon_int8")
    _same_on_both_ranks(run, "gluon_split")
    want = _single_process_gluon()
    for g, q, v in zip(_in_order(a0, "gluon"), _in_order(a0, "gluon_int8"),
                       want):
        np.testing.assert_allclose(g, v, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(q, v, atol=2e-3)
    # allreduce_grads() + update() is step(): the same parameters
    for g, v in zip(_in_order(a0, "gluon_split"), _in_order(a0, "gluon")):
        np.testing.assert_array_equal(g, v)
    for tag in ("gluon", "gluon_int8", "gluon_split"):
        assert s0[f"{tag}_schedule"] == s0[f"{tag}_plan"] == \
            s1[f"{tag}_schedule"]
        assert len(s0[f"{tag}_plan"]) > 1
        # after the first step builds the plan, every bucket is issued
        # during backward
        assert s0[f"{tag}_in_backward"] == [len(s0[f"{tag}_plan"])] * 3
    assert s0["gluon_int8_buckets"] == 0
    assert s0["gluon_int8_int8_buckets"] > 0


def test_fsdp_capsule_saves_each_shard_once(run):
    out = run[1]
    d = mx.checkpoint.step_dir(os.path.join(out, "fsdp_shards"), 1)
    pieces = {}
    for name in ("manifest.json", "manifest.p1.json"):
        with open(os.path.join(d, name)) as f:
            pieces[name] = json.load(f)
    assert os.path.exists(os.path.join(d, "shards_p0.bin"))
    assert os.path.exists(os.path.join(d, "shards_p1.bin"))
    assert [pieces[n]["process_index"] for n in sorted(pieces)] == [0, 1]
    assert all(m["process_count"] == 2 for m in pieces.values())
    shards = [sh for m in pieces.values()
              for sh in m["arrays"].get("param/0", {}).get("shards", [])]
    spec = pieces["manifest.json"]["arrays"]["param/0"]["spec"]
    assert "fsdp" in spec
    n = sum(int(np.prod([b - a for a, b in sh["index"]])) for sh in shards)
    assert n == 64 * 512 and len(shards) == 2     # each element once
    # the replicated bias is written by rank 0 alone
    assert "param/1" in pieces["manifest.json"]["arrays"]
    assert "param/1" not in pieces["manifest.p1.json"]["arrays"]


@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_resume_is_bit_exact(run, mode):
    for _, s in run[0]:
        r = s[f"resume_{mode}"]
        assert r["saved"] == r["got"] == 3
        assert r["res"] == r["ref"][3:]
