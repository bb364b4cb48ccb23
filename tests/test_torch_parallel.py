"""The port's parallel layer in one process, on the CPU, against the JAX
package's: ``parallel.mesh``, ``parallel.collectives`` and the
single-process cases of the multi-worker paths.

  - the 2-bit codec bitwise (``_pack_2bit``, ``_unpack_2bit``,
    ``quantize_2bit`` with its residual chain), ``plan_grad_buckets``
    equal and ``BucketSchedule`` the JAX schedule;
  - in one process ``host_allreduce`` and ``host_broadcast`` are the
    identity and ``host_allreduce_2bit`` still quantizes; the
    ``int8_bucket_allreduce`` of one rank equals the JAX function over an
    axis of one (rtol 1e-6);
  - ``MeshConfig`` resolves and refuses as the JAX one; ``build_mesh``
    without a process group is a ``LocalMesh``; tp / sp / pp / ep > 1
    refuse one device as the JAX one does; ``pipeline_apply`` and
    ``switch_moe`` (and their modules) are exported and run;
  - ``SPMDTrainer(sharding="fsdp")`` on one device against the JAX
    trainer (losses rtol 1e-5) and bitwise the replicated port trainer;
  - ports of the JAX single-process overlap / int8 tests
    (``tests/test_train_perf.py``, ``tests/test_kv_quant.py``): buckets
    issued during backward in the plan's order, overlap bitwise the
    serial reduction, the partial-backward flush, the refusal of a
    mid-round accumulation, one reduction for a single member, and the
    int8 seam's verdict read on dequantized gradients.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.parallel import collectives as jcoll
from incubator_mxnet_tpu.parallel import mesh as jmesh

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, nd, parallel
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.parallel import collectives as coll
from incubator_mxnet_tpu_torch.train import StepOutcome

import test_torch_dist_worker as w

import torch


# ------------------------------------------------------------------ #
# the 2-bit codec and the bucket plan
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("n", [1, 4, 103])
def test_2bit_codec_bitwise_equal_jax(n):
    rng = np.random.RandomState(n)
    codes = rng.randint(0, 3, size=(n,)).astype(np.uint8)
    packed = coll._pack_2bit(torch.tensor(codes)).numpy()
    np.testing.assert_array_equal(
        packed, np.asarray(jcoll._pack_2bit(jnp.asarray(codes))))
    assert packed.dtype == np.uint8 and packed.size == (n + 3) // 4
    np.testing.assert_array_equal(
        coll._unpack_2bit(torch.tensor(packed), n).numpy(), codes)
    x = (rng.randn(n) * 0.6).astype(np.float32)
    res, jres = None, None
    for _ in range(4):
        p, d, res = coll.quantize_2bit(torch.tensor(x), res, 0.5)
        jp, jd, jres = jcoll.quantize_2bit(jnp.asarray(x), jres, 0.5)
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(res.numpy(), np.asarray(jres))


def _member_sets():
    return [
        [(i, 1000 + i, 4, "float32") for i in range(10)] +
        [(i, 500, 2, "bfloat16") for i in range(10, 14)],
        [(i, 10, 4, "float32") for i in range(6)],
        [(3, 1 << 20, 4, "float32"), (0, 7, 4, "float32")],
    ]


@pytest.mark.parametrize("reverse", [True, False])
def test_plan_grad_buckets_equals_jax(reverse):
    for members in _member_sets():
        for limit in (80, 8 * 1024, 1 << 22):
            got = coll.plan_grad_buckets(members, limit, reverse=reverse)
            want = jcoll.plan_grad_buckets(members, limit, reverse=reverse)
            assert [(b.key, b.dtype, b.indices, b.nbytes) for b in got] == \
                [(b.key, b.dtype, b.indices, b.nbytes) for b in want]


def test_bucket_schedule_matches_jax():
    buckets = coll.plan_grad_buckets(
        [(i, 10, 4, "float32") for i in range(6)], 2 * 40)
    for cls, plan in ((coll.BucketSchedule, buckets),
                      (jcoll.BucketSchedule, jcoll.plan_grad_buckets(
                          [(i, 10, 4, "float32") for i in range(6)],
                          2 * 40))):
        sched = cls(plan)
        issued = []
        for i in plan[1].indices:
            issued += sched.mark_ready(i)
        assert issued == []                # gated behind plan bucket 0
        for i in plan[0].indices:
            issued += sched.mark_ready(i)
        assert [b.key for b in issued] == [plan[0].key, plan[1].key]
        assert [b.key for b in sched.drain()] == [b.key for b in plan[2:]]
        assert sched.issued == [b.key for b in plan] == sched.order
        sched.reset_round()
        assert sched.issued == [] and sched.mark_ready(999) == []


# ------------------------------------------------------------------ #
# one process: the collectives' single-process contract
# ------------------------------------------------------------------ #

def test_single_process_collectives():
    x = torch.ones(4)
    assert coll.host_allreduce(x) is x          # JAX: identity
    np.testing.assert_allclose(
        np.asarray(jparallel.host_allreduce(jnp.ones((4,)))), np.ones(4))
    assert coll.host_broadcast(x) is x
    coll.host_barrier()
    assert coll.group_size() == 1
    assert coll.ring_allreduce_flat(x) is x
    np.testing.assert_array_equal(coll.all_gather(x).numpy(), x.numpy())
    np.testing.assert_array_equal(coll.reduce_scatter(x).numpy(), x.numpy())
    red, res = coll.host_allreduce_2bit(torch.full((4,), 0.3), None, 0.5)
    np.testing.assert_allclose(red.numpy(), 0.5)      # still quantized
    np.testing.assert_allclose(res.numpy(), -0.2, rtol=1e-6)
    vals = w.rank_grads(0)
    got = coll.int8_bucket_allreduce([torch.tensor(v) for v in vals])
    want = jax.vmap(lambda *v: jcoll.int8_bucket_allreduce(list(v), "r"),
                    axis_name="r")(*[v[None] for v in vals])
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r)[0], rtol=1e-6)


def test_kvstore_dist_and_compression_single_process():
    """The JAX ``tests/test_parallel.py`` single-process cases: a
    ``dist_sync`` store runs with one worker, the 2-bit push quantizes
    with a residual a key."""
    with mx.cpu():
        for store in ("dist_sync", "dist_async", "dist_sync_device",
                      "dist_async_device", "nccl", "horovod", "byteps"):
            kv = mx.kv.create(store)
            assert (kv.rank, kv.num_workers) == (0, 1)
            kv.init(0, nd.ones((3,)))
            kv.push(0, nd.ones((3,)) * 2)
            out = nd.zeros((3,))
            kv.pull(0, out=out)
            np.testing.assert_allclose(out.asnumpy(), 2.0)
        kv = mx.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init("w", nd.zeros((4,)))
        g = nd.array(np.full(4, 0.3, np.float32))
        out = nd.zeros((4,))
        for want in (0.5, 0.0):
            kv.push("w", g)
            kv.pull("w", out=out)
            np.testing.assert_allclose(out.asnumpy(), want)
        kv.init("v", nd.zeros((4,)))          # its own residual
        kv.push("v", g)
        kv.pull("v", out=out)
        np.testing.assert_allclose(out.asnumpy(), 0.5)
        with pytest.raises(MXNetError, match="unsupported gradient"):
            kv.set_gradient_compression({"type": "1bit"})


# ------------------------------------------------------------------ #
# meshes
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("kw,n", [
    (dict(dp=-1, fsdp=-1), 2), (dict(dp=0), 1), (dict(dp=-1, fsdp=3), 4),
    (dict(dp=2, fsdp=1), 4), (dict(dp=-1, fsdp=2), 8), (dict(), 1)])
def test_mesh_config_resolves_as_jax(kw, n):
    def outcome(cls):
        try:
            return cls(**kw).resolve(n)
        except Exception as e:             # noqa: BLE001 - compared below
            return (type(e).__name__, str(e))
    assert outcome(parallel.MeshConfig) == outcome(jmesh.MeshConfig)


def test_build_mesh_and_initialize_in_one_process(monkeypatch):
    monkeypatch.delenv("MXTPU_COORDINATOR", raising=False)
    parallel.initialize()                      # one process: a no-op
    assert not parallel.mesh.is_distributed()
    with mx.cpu():
        m = parallel.build_mesh()
        assert isinstance(m, parallel.mesh.LocalMesh)
        assert m.mesh_dim_names == jmesh.AXES == parallel.mesh.AXES
        assert parallel.mesh.axis_sizes(m) == {a: 1 for a in jmesh.AXES}
        assert m.size() == 1 and m.get_coordinate() == [0] * 6
        # every axis is ported: one process holds one device, and the
        # refusal is the JAX package's on one device
        for axes in ({"tp": 2}, {"sp": 2}, {"pp": 2}, {"ep": 2}):
            with pytest.raises(MXNetError) as port_err:
                parallel.build_mesh(axis_sizes=axes)
            with pytest.raises(Exception) as jax_err:
                jmesh.build_mesh(devices=jax.devices()[:1], axis_sizes=axes)
            assert str(port_err.value) == str(jax_err.value)
        with pytest.raises(MXNetError, match="mesh axes product"):
            parallel.build_mesh(axis_sizes={"dp": 2})      # one device
        with pytest.raises(MXNetError, match="one device per process"):
            parallel.build_mesh(devices=["cpu", "cpu", "cpu"])
        d = parallel.default_mesh()
        assert parallel.current_mesh() is d
    with pytest.raises(MXNetError, match="coordinator"):
        parallel.initialize(num_processes=2)
    from torch.distributed.tensor import Replicate, Shard
    pl = parallel.mesh.named_sharding(m, "fsdp", None)
    assert pl[1] == Shard(0) and pl[0] == Replicate()
    # the pipeline and expert names run: on a mesh of one rank the GPipe
    # schedule is the stage applied to each microbatch, and switch_moe
    # with one expert keeps every token at capacity factor 1
    assert parallel.pipeline.pipeline_apply is parallel.pipeline_apply
    assert parallel.moe.switch_moe is parallel.switch_moe
    x = torch.arange(12.0).reshape(3, 2, 2)
    stacked = parallel.stack_stage_params([{"w": torch.eye(2) * 2}])
    out = parallel.pipeline_apply(lambda p, h: h @ p["w"], stacked, x, m)
    assert torch.equal(out, x * 2)
    experts = parallel.stack_expert_params([{"w": torch.eye(2)}])
    y, aux = parallel.switch_moe(x[0], torch.zeros(2, 1),
                                 lambda p, h: h @ p["w"], experts,
                                 capacity_factor=1.0)
    assert torch.equal(y, x[0]) and float(aux) == 1.0
    # ported: importable, and with no mesh active constrain is the
    # identity, as the JAX one is
    x = torch.arange(6.0).reshape(2, 3)
    assert parallel.constrain(x, "dp", "tp") is x
    with parallel.activation_sharding_scope(m):
        assert parallel.constrain(x, ("dp", "fsdp"), "sp") is x
    assert callable(parallel.ring_self_attention) and \
        callable(parallel.ring_flash_attention)


# ------------------------------------------------------------------ #
# SPMDTrainer(sharding="fsdp") in one process
# ------------------------------------------------------------------ #

def test_fsdp_on_one_device_matches_jax_and_replicated():
    x, y = w.data()
    losses = {}
    with mx.cpu():
        for mode in ("replicated", "fsdp"):
            net = w.mlp(gluon)
            net.initialize()
            w.seed_params(net, 0, nd)
            tr = parallel.SPMDTrainer(
                net, loss=w.mse, optimizer="adam",
                optimizer_params={"learning_rate": 1e-2},
                mesh=parallel.build_mesh(), sharding=mode)
            losses[mode] = [float(tr.step(nd.array(x), nd.array(y))
                                  .asnumpy()) for _ in range(3)]
            if mode == "fsdp":
                # the JAX rule: nothing is sharded over an fsdp axis of 1
                assert tr._shard_dims == [None] * 4
                full = parallel.gather_full_params(tr)
                np.testing.assert_array_equal(
                    next(iter(full.values())),
                    tr._params[0].detach().numpy())
    assert losses["fsdp"] == losses["replicated"]
    jmx.random.seed(0)
    jnet = w.mlp(jgluon)
    jnet.initialize()
    w.seed_params(jnet, 0, jnd)
    jtr = jparallel.SPMDTrainer(
        jnet, loss=w.mse, optimizer="adam",
        optimizer_params={"learning_rate": 1e-2},
        mesh=jmesh.build_mesh(devices=jax.devices()[:1],
                              axis_sizes={"fsdp": 1}), sharding="fsdp")
    want = [float(jtr.step(jnd.array(x), jnd.array(y)).asnumpy())
            for _ in range(3)]
    np.testing.assert_allclose(losses["fsdp"], want, rtol=1e-5)


@pytest.mark.parametrize("size", [1, 2, 4])
def test_fsdp_dimension_rule_matches_jax(size):
    """The port's ``_fsdp_dim`` picks the JAX ``_fsdp_spec``'s dimension
    (its default minimum of 16384 elements) for every shape; at an fsdp
    size of 1 both replicate."""
    from incubator_mxnet_tpu.parallel.spmd import _fsdp_spec
    from incubator_mxnet_tpu_torch.parallel.spmd import _fsdp_dim
    mesh = jmesh.build_mesh(devices=jax.devices()[:size],
                            axis_sizes={"fsdp": size})
    for shape in [(64, 512), (512, 64), (3, 8192), (30000, 3), (4096,),
                  (8, 8), (50257, 768), (5, 7, 1024), (6, 4096)]:
        spec = tuple(_fsdp_spec(shape, mesh))
        want = spec.index("fsdp") if "fsdp" in spec else None
        assert _fsdp_dim(shape, size) == want, (shape, spec)


def test_shard_params_and_replicate_placements():
    from torch.distributed.tensor import Replicate
    with mx.cpu():
        net = w.mlp(gluon)
        net.initialize()
        m = parallel.build_mesh()
        # over an fsdp axis of 1 the rule shards nothing (Shard(0) over
        # fsdp 2: tests/test_torch_multiprocess.py)
        plan = parallel.shard_params(net, m, "fsdp")
        assert all(p == Replicate() for pl in plan.values() for p in pl)
        assert all(p == Replicate() for pl in parallel.shard_params(
            net, m).values() for p in pl)
        assert parallel.replicate(m) == [Replicate()] * 6


def test_fsdp_refuses_norm_based_optimizers():
    with mx.cpu():
        net = w.mlp(gluon)
        net.initialize()
        with pytest.raises(MXNetError, match="fsdp.*LAMB"):
            parallel.SPMDTrainer(net, loss=w.mse, optimizer="lamb",
                                 sharding="fsdp")


# ------------------------------------------------------------------ #
# gluon.Trainer: the JAX single-process overlap / int8 tests
# ------------------------------------------------------------------ #

def _build_net(seed=0):
    mx.random.seed(seed)
    net = nn.Sequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"),
            nn.Dense(4, in_units=16))
    net.initialize()
    return net


def _spy_kv(num_workers=2):
    """A 'device' store on the reduction path (``_num_workers`` forced),
    every pushpull key recorded."""
    kv = mx.kv.create("device")
    kv._num_workers = num_workers
    calls = []
    orig = kv.pushpull

    def spy(key, value, out=None, priority=0):
        calls.append(key)
        return orig(key, value, out=out, priority=priority)

    kv.pushpull = spy
    return kv, calls


def _snapshot(net):
    return [p.data().asnumpy() for p in net.collect_params().values()]


def _x():
    return nd.array(np.random.RandomState(0).randn(4, 8).astype(np.float32))


def _one_step(net, tr, x):
    with autograd.record():
        loss = (net(x) ** 2).mean()
    loss.backward()
    tr.step(4)


def test_overlap_issues_during_backward_in_plan_order(monkeypatch):
    monkeypatch.setenv("MXTPU_GRAD_BUCKET_BYTES", "600")
    with mx.cpu():
        net = _build_net()
        kv, calls = _spy_kv()
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore=kv,
                           overlap_allreduce=True)
        x = _x()
        _one_step(net, tr, x)                  # the plan builds here
        scheds = []
        for _ in range(3):
            with autograd.record():
                loss = (net(x) ** 2).mean()
            before = len(calls)
            loss.backward()
            in_backward = calls[before:]
            assert len(in_backward) >= 1
            tr.step(4)
            scheds.append(list(tr.grad_issue_schedule))
            assert in_backward == scheds[-1][:len(in_backward)]
        assert scheds[0] == scheds[1] == scheds[2] == tr._overlap_sched.order
        assert len(scheds[0]) > 1
        snap = tr.health_snapshot()
        assert snap["overlap_allreduce"] is True
        assert snap["grad_issue_schedule"] == scheds[0]


def test_overlap_matches_serial_reduction_bitwise():
    results = []
    with mx.cpu():
        for overlap in (False, True):
            net = _build_net()
            kv, _ = _spy_kv()
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore=kv,
                               overlap_allreduce=overlap)
            for _ in range(4):
                _one_step(net, tr, _x())
            results.append(_snapshot(net))
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)


def test_overlap_partial_backward_flushes_at_step(monkeypatch):
    monkeypatch.setenv("MXTPU_GRAD_BUCKET_BYTES", "300")
    with mx.cpu():
        mx.random.seed(0)
        d1 = nn.Dense(16, in_units=8, activation="relu")
        d2 = nn.Dense(4, in_units=16)
        d1.initialize()
        d2.initialize()
        params = list(d1.collect_params().values()) + \
            list(d2.collect_params().values())
        kv, calls = _spy_kv()
        tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.1},
                           kvstore=kv, overlap_allreduce=True)
        x = _x()
        with autograd.record():
            loss = (d2(d1(x)) ** 2).mean()
        loss.backward()
        tr.step(4)
        h = d1(x)                              # outside the tape
        with autograd.record():
            loss = (d2(h) ** 2).mean()
        before = len(calls)
        loss.backward()                        # only d2's grads refresh
        assert len(calls) > before             # deep bucket issued anyway
        tr.step(4, ignore_stale_grad=True)     # drains the unready tail
        assert list(tr.grad_issue_schedule) == tr._overlap_sched.order
        assert sum(tr.health.values()) == 2


def test_overlap_refuses_mid_round_accumulation(monkeypatch):
    monkeypatch.setenv("MXTPU_GRAD_BUCKET_BYTES", "600")
    with mx.cpu():
        net = _build_net()
        kv, calls = _spy_kv()
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore=kv,
                           overlap_allreduce=True)
        x = _x()
        _one_step(net, tr, x)
        with autograd.record():
            loss = (net(x) ** 2).mean()
        loss.backward()                        # the hooks issued buckets
        with pytest.raises(MXNetError, match="overlapped allreduce"):
            tr.accumulate_grads()
        tr.step(4)
        tr.set_grad_accumulation(True)         # defers from microbatch 1
        with autograd.record():
            loss = (net(x) ** 2).mean()
        before = len(calls)
        loss.backward()
        assert calls[before:] == []
        tr.accumulate_grads()
        tr.step(1)
        assert tr.last_outcome is StepOutcome.APPLIED


def test_overlap_single_member_never_double_reduces():
    with mx.cpu():
        mx.random.seed(0)
        d = nn.Dense(4, in_units=8, use_bias=False)
        d.initialize()
        kv, calls = _spy_kv()
        tr = gluon.Trainer(d.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore=kv,
                           overlap_allreduce=True)
        for _ in range(3):
            with autograd.record():
                loss = (d(_x()) ** 2).mean()
            loss.backward()
            tr.step(4)
        assert tr._overlap_sched is False
        assert len(calls) == 3                 # one pushpull a step


def test_int8_allreduce_verdict_on_dequantized():
    """The JAX ``test_kv_quant`` / ``test_train_perf`` int8 cases: the
    bucket ships quantized at one worker, a poisoned gradient skips the
    step with every parameter bitwise, accumulation composes."""
    rng = np.random.RandomState(0)
    X = rng.randn(4, 8).astype(np.float32)
    Y = rng.randn(4, 4).astype(np.float32)
    with mx.cpu():
        net = _build_net()
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore="device",
                           int8_allreduce=True, guard=True)
        with autograd.record():
            loss = ((net(nd.array(X)) - nd.array(Y)) ** 2).mean()
        loss.backward()
        tr.step(1)
        assert tr.last_outcome is StepOutcome.APPLIED
        assert tr.int8_buckets >= 1
        assert tr.health_snapshot()["int8_bytes_saved"] > 0
        with autograd.record():
            loss = ((net(nd.array(X)) - nd.array(Y)) ** 2).mean()
        loss.backward()
        before = _snapshot(net)
        p0 = next(iter(net.collect_params().values()))
        p0.grad()._data[0, 0] = float("nan")
        tr.step(1)
        assert tr.last_outcome is StepOutcome.SKIPPED_NONFINITE
        for a, b in zip(before, _snapshot(net)):
            np.testing.assert_array_equal(a, b)
        # accumulation: the accumulated bucket ships at apply time
        net = _build_net()
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.01}, kvstore="device",
                           int8_allreduce=True)
        tr.set_grad_accumulation(True)

        def round_(poison):
            for m in range(2):
                xb = X[m * 2:(m + 1) * 2].copy()
                if poison and m == 1:
                    xb[0, 0] = np.nan
                with autograd.record():
                    loss = ((net(nd.array(xb)) -
                             nd.array(Y[m * 2:(m + 1) * 2])) ** 2).mean()
                tr.backward(loss)
                tr.accumulate_grads()
            tr.step(2)

        round_(False)
        assert tr.int8_buckets > 0
        before = _snapshot(net)
        round_(True)
        assert tr.last_outcome is StepOutcome.SKIPPED_NONFINITE
        for a, b in zip(before, _snapshot(net)):
            np.testing.assert_array_equal(a, b)
        round_(False)
        assert tr.last_outcome is StepOutcome.APPLIED


def test_int8_allreduce_matches_jax_trainer():
    """One int8 step of the port's Trainer against the JAX Trainer's on
    the same weights and batch (rtol 1e-5: the same codes, dequantized
    and applied)."""
    rng = np.random.RandomState(3)
    X = rng.randn(4, 8).astype(np.float32)
    outs = []
    with mx.cpu():
        for pkg, g, nd_ in ((mx, gluon, nd), (jmx, jgluon, jnd)):
            net = w.small_mlp(g)
            net.initialize()
            w.seed_params(net, 3, nd_)
            tr = g.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore="device",
                           int8_allreduce=True)
            with pkg.autograd.record():
                loss = (net(nd_.array(X)) ** 2).mean()
            loss.backward()
            tr.step(4)
            outs.append([p.data().asnumpy() for p in
                         net.collect_params().values()])
            assert tr.int8_buckets == 1
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
