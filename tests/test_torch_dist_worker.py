"""The worker of ``tests/test_torch_multiprocess.py``: every scenario the
multi-process tests check, run once by each rank of a two-process gloo
group on the CPU.

Run through the unchanged launcher (which sets ``MXTPU_COORDINATOR``,
``MXTPU_NUM_PROCS`` and ``MXTPU_PROC_ID``)::

    python tools/launch.py -n 2 --launcher local -- \\
        python tests/test_torch_dist_worker.py OUTDIR

Each rank writes ``OUTDIR/rank<r>.npz`` (arrays) and ``rank<r>.json``
(scalars and lists); checkpoints go under ``OUTDIR``. The module holds no
test: it imports neither JAX nor the JAX package, and the parent test
builds the same models from ``init_params`` to hold the results against
the JAX package.
"""

import json
import os
import sys

import numpy as np

B, IN, HID, OUT = 16, 512, 64, 8


def init_params(params, seed):
    """Every parameter of a ``collect_params()`` ordering from
    ``RandomState(seed)``: 0.1 x normal weights, zero biases and
    statistics, unit BatchNorm scales and variances (either package's
    ``Parameter.set_data`` takes the arrays)."""
    rng = np.random.RandomState(seed)
    out = []
    for p in params:
        shape = tuple(p.shape)
        if len(shape) > 1:
            a = (0.1 * rng.randn(*shape)).astype(np.float32)
        elif p.name.endswith(("gamma", "running_var")):
            a = np.ones(shape, np.float32)
        else:
            a = np.zeros(shape, np.float32)
        out.append(a)
    return out


def data(seed=0, n=B):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, IN).astype(np.float32),
            rng.randn(n, OUT).astype(np.float32))


def mlp(g):
    """The dp / fsdp model: its first weight (64, 512) is large enough to
    shard, the rest stays replicated."""
    net = g.nn.Sequential()
    net.add(g.nn.Dense(HID, in_units=IN, activation="relu"),
            g.nn.Dense(OUT, in_units=HID))
    return net


def small_mlp(g):
    net = g.nn.Sequential()
    net.add(g.nn.Dense(16, in_units=8, activation="relu"),
            g.nn.Dense(4, in_units=16))
    return net


def bn_net(g, sync_bn):
    net = g.nn.HybridSequential()
    net.add(g.nn.Conv2D(4, kernel_size=3, padding=1, in_channels=2),
            sync_bn(in_channels=4),
            g.nn.Activation("relu"), g.nn.GlobalAvgPool2D(),
            g.nn.Dense(3, in_units=4))
    return net


def bn_data():
    rng = np.random.RandomState(0)
    # per-sample scales vary widely: a per-shard BatchNorm would diverge
    x = (rng.randn(32, 2, 6, 6) * np.linspace(0.1, 10, 32).reshape(
        32, 1, 1, 1)).astype(np.float32)
    return x, rng.randint(0, 3, size=(32,)).astype(np.float32)


def mse(o, y):
    return ((o - y) ** 2).mean()


def flagged_mse(block, x, y, flag):
    """MSE times the mean of a per-row flag: a NaN flag row poisons the
    loss and every gradient of the rank that holds it."""
    return ((block(x) - y) ** 2).mean() * flag.mean()


def rank_grads(rank, poison=False):
    """One gradient bucket of a rank: two members of different shapes,
    a NaN in rank 1's when ``poison``."""
    rng = np.random.RandomState(10 + rank)
    a = (rng.randn(5, 3) * (1 + rank)).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    if poison and rank == 1:
        b[2] = np.nan
    return [a, b]


def rank_flat(rank, n=11):
    return np.random.RandomState(20 + rank).randn(n).astype(np.float32)


def seed_params(net, seed, nd):
    """``init_params(seed)`` into every parameter of ``net`` (``nd`` is
    the package's: either package's net takes its own arrays)."""
    params = list(net.collect_params().values())
    for p, a in zip(params, init_params(params, seed)):
        p.set_data(nd.array(a))


def main(outdir):
    import torch

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon, nd, parallel
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    from incubator_mxnet_tpu_torch.gluon.contrib.nn import SyncBatchNorm

    torch.manual_seed(0)
    os.environ["MXTPU_GRAD_BUCKET_BYTES"] = "600"
    arrays, scalars = {}, {}
    with mx.cpu():
        parallel.initialize()
        rank = parallel.mesh.rank()
        scalars["world"] = parallel.mesh.world_size()
        scalars["backend"] = torch.distributed.get_backend()
        x, y = data()

        def trainer(mode, seed=0, **kw):
            net = mlp(gluon)
            net.initialize()
            seed_params(net, seed, nd)
            axes = {"dp": 2} if mode == "replicated" else {"fsdp": 2}
            return parallel.SPMDTrainer(
                net, optimizer="adam",
                optimizer_params={"learning_rate": 1e-2},
                mesh=parallel.build_mesh(axis_sizes=axes), sharding=mode,
                **kw)

        # -- the collectives -------------------------------------------- #
        coll = parallel.collectives
        for tag, poison in (("int8", False), ("int8nan", True)):
            got = coll.int8_bucket_allreduce(
                [torch.tensor(a) for a in rank_grads(rank, poison)])
            for k, t in enumerate(got):
                arrays[f"coll/{tag}{k}"] = t.numpy().copy()
        flat = torch.tensor(rank_flat(rank))
        arrays["coll/ring"] = coll.ring_allreduce_flat(flat).numpy().copy()
        m = torch.tensor(rank_flat(rank, 24).reshape(4, 6))
        arrays["coll/reduce_scatter"] = coll.reduce_scatter(
            m, scatter_dimension=1, op="mean").numpy().copy()
        arrays["coll/all_gather"] = coll.all_gather(m, axis=1).numpy().copy()
        arrays["coll/bf16"] = coll.host_allreduce(
            torch.tensor(rank_flat(rank)), compression="bf16").numpy().copy()
        arrays["coll/broadcast"] = coll.host_broadcast(
            torch.tensor(rank_flat(rank)), root=1).numpy().copy()
        res = None
        for t in range(3):
            red, res = coll.host_allreduce_2bit(
                torch.tensor(rank_flat(rank, 103)), res, 0.5)
            arrays[f"coll/2bit{t}"] = red.numpy().copy()

        # -- SPMDTrainer dp2 / fsdp2, 3 steps ---------------------------- #
        for mode in ("replicated", "fsdp"):
            tr = trainer(mode, loss=mse)
            scalars[f"{mode}_losses"] = [
                float(tr.step(nd.array(x), nd.array(y)).asnumpy())
                for _ in range(3)]
            scalars[f"{mode}_trace"] = tr.step_trace_count
            scalars[f"{mode}_shard_dims"] = list(tr._shard_dims)
            scalars[f"{mode}_placements"] = [
                [repr(p) for p in pl] for pl in parallel.shard_params(
                    tr.block, tr.mesh, mode).values()]
            for name, a in parallel.gather_full_params(tr).items():
                arrays[f"{mode}/{name}"] = a
            arrays[f"{mode}/resident0"] = \
                tr._params[0].detach().cpu().numpy()

        # -- step_microbatches, k = 2 (dp2) ------------------------------ #
        tr = trainer("replicated", loss=mse)
        losses = []
        for _ in range(2):
            losses.append(float(tr.step_microbatches(
                [(nd.array(x[:8]), nd.array(y[:8])),
                 (nd.array(x[8:]), nd.array(y[8:]))]).asnumpy()))
        scalars["micro_losses"] = losses
        scalars["micro_trace"] = tr.accum_step_trace_count
        for name, a in parallel.gather_full_params(tr).items():
            arrays[f"micro/{name}"] = a

        # -- a NaN in rank 1's rows: the step is skipped on both ---------- #
        tr = trainer("fsdp", forward_loss=flagged_mse)
        flag = np.ones((B,), np.float32)
        tr.step(nd.array(x), nd.array(y), nd.array(flag))
        before = parallel.gather_full_params(tr)
        flag[B - 1] = np.nan             # the last row: rank 1's tile
        tr.step(nd.array(x), nd.array(y), nd.array(flag))
        after = parallel.gather_full_params(tr)
        scalars["nan_outcome"] = str(tr.last_outcome)
        scalars["nan_step_count"] = tr.step_count
        scalars["nan_frozen"] = all(
            np.array_equal(before[k], after[k]) for k in before)
        scalars["nan_trace"] = tr.step_trace_count

        # -- SyncBatchNorm: global batch statistics ---------------------- #
        bx, by = bn_data()
        for sync in (True, False):
            mx.random.seed(5)
            net = bn_net(gluon, SyncBatchNorm if sync else
                         gluon.nn.BatchNorm)
            net.initialize()
            seed_params(net, 5, nd)
            tr = parallel.SPMDTrainer(
                net, loss=gluon.loss.SoftmaxCrossEntropyLoss(),
                optimizer="sgd", optimizer_params={"learning_rate": 0.05},
                mesh=parallel.build_mesh(axis_sizes={"dp": 2}))
            tag = "syncbn" if sync else "plainbn"
            scalars[f"{tag}_losses"] = [
                float(tr.step(nd.array(bx), nd.array(by)).asnumpy())
                for _ in range(3)]
            for name, p in net.collect_params().items():
                arrays[f"{tag}/{name}"] = p.data().asnumpy()

        # -- dist_sync kvstore --------------------------------------------- #
        kv = mx.kv.create("dist_sync")
        scalars["kv_rank"], scalars["kv_workers"] = kv.rank, kv.num_workers
        kv.init("w", nd.zeros((4,)))
        kv.push("w", nd.array(np.full(4, float(rank + 1), np.float32)))
        out = nd.zeros((4,))
        kv.pull("w", out=out)
        arrays["kv/sum"] = out.asnumpy().copy()
        kv2 = mx.kv.create("dist_sync")
        kv2.set_gradient_compression({"type": "bf16"})
        kv2.init("g", nd.zeros((4,)))
        kv2.push("g", nd.array(np.full(4, float(rank + 1), np.float32)))
        kv2.pull("g", out=out)
        arrays["kv/bf16"] = out.asnumpy().copy()
        kv3 = mx.kv.create("dist_sync")
        kv3.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv3.init("h", nd.zeros((4,)))
        g = nd.array(np.full(4, 0.3, np.float32))
        for t in range(2):
            kv3.push("h", g)
            kv3.pull("h", out=out)
            arrays[f"kv/2bit{t}"] = out.asnumpy().copy()
            arrays[f"kv/2bit_residual{t}"] = \
                kv3._residuals["h"].cpu().numpy()
        kv4 = mx.kv.create("dist_sync")
        kv4.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv4.init("acc", nd.zeros((4,)))
        acc = np.zeros(4, np.float32)
        for _ in range(20):
            kv4.push("acc", g)
            kv4.pull("acc", out=out)
            acc += out.asnumpy().copy()
        arrays["kv/2bit_acc"] = acc

        # -- gluon.Trainer over the workers ---------------------------------- #
        sx = np.random.RandomState(1).randn(16, 8).astype(np.float32)
        sy = np.random.RandomState(2).randn(16, 4).astype(np.float32)
        loss_fn = gluon.loss.L2Loss()
        for tag, kw in (("gluon", {}),
                        ("gluon_int8", {"int8_allreduce": True}),
                        ("gluon_split", {})):
            net = small_mlp(gluon)
            net.initialize()
            seed_params(net, 3, nd)
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore="dist_sync",
                               overlap_allreduce=True, **kw)
            mine = slice(rank * 8, (rank + 1) * 8)
            issued_in_backward = []
            for _ in range(4):
                with autograd.record():
                    L = loss_fn(net(nd.array(sx[mine])),
                                nd.array(sy[mine]))
                before_n = len(tr._overlap_sched.issued) \
                    if tr._overlap_sched else 0
                L.backward()
                if tr._overlap_sched:
                    issued_in_backward.append(
                        len(tr._overlap_sched.issued) - before_n)
                if tag == "gluon_split":
                    # the MXNet 1.x form that clips between the two
                    tr.allreduce_grads()
                    tr.update(16)
                else:
                    tr.step(16)
            scalars[f"{tag}_schedule"] = list(tr.grad_issue_schedule)
            scalars[f"{tag}_plan"] = tr._overlap_sched.order
            scalars[f"{tag}_in_backward"] = issued_in_backward
            scalars[f"{tag}_int8_buckets"] = tr.int8_buckets
            for name, p in net.collect_params().items():
                arrays[f"{tag}/{name}"] = p.data().asnumpy()

        # -- checkpoints: the fsdp capsule's shards, bit-exact resume ----- #
        mx.random.seed(0)
        net = gluon.nn.Dense(64, in_units=512)
        net.initialize()
        seed_params(net, 0, nd)
        tr = parallel.SPMDTrainer(
            net, loss=mse, optimizer="sgd",
            optimizer_params={"learning_rate": 1e-2},
            mesh=parallel.build_mesh(axis_sizes={"fsdp": 2}),
            sharding="fsdp")
        rng = np.random.RandomState(4)
        tr.step(nd.array(rng.randn(8, 512).astype(np.float32)),
                nd.array(rng.randn(8, 64).astype(np.float32)))
        m = ckpt.CheckpointManager(os.path.join(outdir, "fsdp_shards"),
                                   keep=0)
        tr.save_checkpoint(m, block=True)
        m.close()
        for mode in ("replicated", "fsdp"):
            ref_tr = trainer(mode, loss=mse)
            ref = [float(ref_tr.step(nd.array(x), nd.array(y)).asnumpy())
                   for _ in range(6)]
            tr2 = trainer(mode, loss=mse)
            for _ in range(3):
                tr2.step(nd.array(x), nd.array(y))
            m = ckpt.CheckpointManager(os.path.join(outdir, "resume_" + mode),
                                       keep=2)
            saved = tr2.save_checkpoint(m)
            m.wait()
            tr3 = trainer(mode, seed=7, loss=mse)
            got = tr3.restore_checkpoint(m)
            res = [float(tr3.step(nd.array(x), nd.array(y)).asnumpy())
                   for _ in range(3)]
            m.close()
            scalars[f"resume_{mode}"] = {"ref": ref, "res": res,
                                         "saved": saved, "got": got}
        parallel.collectives.host_barrier()

    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(scalars, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
