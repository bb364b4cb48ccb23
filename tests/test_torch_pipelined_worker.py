"""The worker of ``tests/test_torch_pipelined.py``: every scenario of the
pipelined-backward SPMD step the tests check, run once by each rank of a
two-process gloo group on the CPU.

Run through the unchanged launcher (which sets ``MXTPU_COORDINATOR``,
``MXTPU_NUM_PROCS`` and ``MXTPU_PROC_ID``)::

    python tools/launch.py -n 2 --launcher local -- \\
        python tests/test_torch_pipelined_worker.py OUTDIR

``OUTDIR`` holds the inputs the parent test wrote (``inputs.npz``: the
JAX models' weights by structural name). Each rank writes
``OUTDIR/rank<r>.npz`` (arrays) and ``rank<r>.json`` (scalars, lists and
the refusals' messages). The module holds no test and imports neither
JAX nor the JAX package.
"""

import json
import os
import sys

import numpy as np

BUCKET_BYTES = "256"          # the toy nets: a multi-bucket plan
MODEL_BUCKET_BYTES = "262144"
GPT_B, GPT_T, GPT_V = 4, 16, 512
BERT_B, BERT_T, BERT_V, BERT_M = 4, 16, 1024, 6


def toy_data(seed=1, n=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 8).astype(np.float32),
            rng.randn(n, 4).astype(np.float32))


def flags(n, s, nan_at):
    f = np.ones((n,), np.float32)
    if s == nan_at:
        f[0] = np.nan
    return f


def gpt_batches(weighted, steps=3):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(steps):
        b = [rng.randint(0, GPT_V, (GPT_B, GPT_T)).astype(np.int32),
             rng.randint(0, GPT_V, (GPT_B, GPT_T)).astype(np.int32)]
        if weighted:
            b.append(rng.rand(GPT_B, GPT_T).astype(np.float32))
        out.append(b)
    return out


def bert_batches(steps=3):
    rng = np.random.RandomState(1)
    B, T, V, M = BERT_B, BERT_T, BERT_V, BERT_M
    out = []
    for _ in range(steps):
        out.append([
            rng.randint(0, V, (B, T)).astype(np.int32),
            rng.randint(0, 2, (B, T)).astype(np.int32),
            np.array([T, 11, 0, 5], np.int32),
            np.stack([rng.choice(T, M, replace=False)
                      for _ in range(B)]).astype(np.int32),
            rng.randint(0, V, (B, M)).astype(np.int32),
            (rng.rand(B, M) > 0.2).astype(np.float32),
            rng.randint(0, 2, (B,)).astype(np.int32)])
    return out


def main(outdir):
    import torch
    torch.set_num_threads(1)
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd, parallel
    from incubator_mxnet_tpu_torch.base import MXNetError
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.models import bert as tb, convert
    from incubator_mxnet_tpu_torch.models import gpt as tg
    from incubator_mxnet_tpu_torch.parallel.collectives import \
        plan_grad_buckets
    from incubator_mxnet_tpu_torch.parallel.pipelined import (
        PipelineSpec, count_of, mean_of)

    inputs = dict(np.load(os.path.join(outdir, "inputs.npz")))

    def weights(prefix):
        return {k[len(prefix) + 1:]: v for k, v in inputs.items()
                if k.startswith(prefix + "/")}

    arrays, scalars = {}, {}

    def toy_net():
        net = nn.Sequential()
        net.add(nn.Dense(16, in_units=8, activation="relu"),
                nn.Dense(4, in_units=16))
        net.initialize()
        for p, a in zip(net.collect_params().values(),
                        [inputs[f"toy/{j}"] for j in range(4)]):
            p.set_data(nd.array(a))
        return net

    def flagged_mse(block, x, y, flag):
        out = block(x)
        return ((out - y) ** 2).mean() * flag.mean()

    def mse_spec(net):
        """The plain ``flagged_mse`` as local partial sums: its finalize
        is the rank's loss."""
        def head(x, X, y, flag):
            sq = (x - y) ** 2
            return (sq.sum(), count_of(sq), flag.sum(), count_of(flag))

        def fin(n1, d1, n2, d2):
            return mean_of(n1, d1) * mean_of(n2, d2)

        return PipelineSpec(blocks=[net[0], net[1]], head=head,
                            finalize=fin)

    def toy(axes, sharding, pipelined, optimizer="adam", **kw):
        net = toy_net()
        mesh = parallel.build_mesh(axis_sizes=axes)
        loss = dict(pipeline=mse_spec(net)) if pipelined \
            else dict(forward_loss=flagged_mse)
        tr = parallel.SPMDTrainer(
            net, optimizer=optimizer,
            optimizer_params={"learning_rate": 0.01}, mesh=mesh,
            sharding=sharding, **loss, **kw)
        return net, tr

    def keep(tag, tr):
        for name, a in parallel.gather_full_params(tr).items():
            arrays[f"{tag}/{name}"] = a

    def record(tag, tr, losses):
        scalars[f"{tag}_losses"] = losses
        scalars[f"{tag}_step_count"] = tr.step_count
        scalars[f"{tag}_trace"] = tr.step_trace_count
        scalars[f"{tag}_accum_trace"] = tr.accum_step_trace_count
        if tr._pipeline is not None:
            snap = tr.health_snapshot()
            scalars[f"{tag}_pipelined_trace"] = \
                snap["pipelined_step_trace_count"]
            scalars[f"{tag}_pipelined_accum_trace"] = \
                snap["pipelined_accum_step_trace_count"]
            scalars[f"{tag}_order"] = snap["pipelined_bucket_order"]
            scalars[f"{tag}_ops"] = [e["op"]
                                     for e in tr.pipelined_issue_ledger]
            scalars[f"{tag}_structure"] = tr.pipelined_structure()
            members = [(i, tr._params[i].numel(),
                        tr._params[i].element_size(),
                        str(tr._params[i].dtype).replace("torch.", ""))
                       for i in tr._train_idx]
            limit = int(os.environ["MXTPU_GRAD_BUCKET_BYTES"])
            scalars[f"{tag}_plan"] = [b.key for b in plan_grad_buckets(
                members, limit)]
        keep(tag, tr)

    def toy_run(tag, axes, sharding, pipelined, nan_at=None, n=5, **kw):
        X, y = toy_data()
        net, tr = toy(axes, sharding, pipelined, **kw)
        losses = [float(tr.step(nd.array(X), nd.array(y),
                                nd.array(flags(8, s, nan_at))).asnumpy())
                  for s in range(n)]
        record(tag, tr, losses)

    def refusal(tag, fn):
        try:
            fn()
        except MXNetError as e:
            scalars[f"{tag}_error"] = str(e)
        else:
            scalars[f"{tag}_error"] = None

    with mx.cpu():
        parallel.initialize()
        rank = parallel.mesh.rank()
        scalars["world"] = parallel.mesh.world_size()

        # the toy net: dp2 and fsdp2, plain against pipelined, clean and
        # with a NaN flag (the guard's veto), the ring, int8
        os.environ["MXTPU_GRAD_BUCKET_BYTES"] = BUCKET_BYTES
        os.environ["MXTPU_FSDP_MIN_SIZE"] = "0"
        for nan_at in (None, 2):
            for pipelined in (False, True):
                toy_run(f"toy_dp_{nan_at}_{int(pipelined)}", {"dp": 2},
                        "replicated", pipelined, nan_at)
        for nan_at in (None, 1):
            for pipelined in (False, True):
                toy_run(f"toy_fsdp_{nan_at}_{int(pipelined)}",
                        {"dp": 1, "fsdp": 2}, "fsdp", pipelined, nan_at)
        toy_run("toy_ring", {"dp": 2}, "replicated", True,
                grad_collective="ring")
        toy_run("toy_int8", {"dp": 2}, "replicated", True, nan_at=1, n=3,
                int8_allreduce=True)

        # accumulation: k in (1, 4, 8) microbatches of 2 rows, one build
        for axes, sharding in (({"dp": 2}, "replicated"),
                               ({"dp": 1, "fsdp": 2}, "fsdp")):
            X, y = toy_data(seed=2, n=16)
            for pipelined in (False, True):
                tag = f"accum_{sharding}_{int(pipelined)}"
                net, tr = toy(axes, sharding, pipelined)
                losses = []
                for k in (1, 4, 8):
                    micros = [(nd.array(X[m * 2:(m + 1) * 2]),
                               nd.array(y[m * 2:(m + 1) * 2]),
                               nd.array(np.ones(2, np.float32)))
                              for m in range(k)]
                    losses.append(float(tr.step_microbatches(
                        micros).asnumpy()))
                record(tag, tr, losses)

        # a non-finite microbatch vetoes its whole round
        X, y = toy_data(seed=3, n=16)
        net, tr = toy({"dp": 2}, "replicated", True)

        def micros(nan_at=None):
            return [(nd.array(X[m * 4:(m + 1) * 4]),
                     nd.array(y[m * 4:(m + 1) * 4]),
                     nd.array(flags(4, m, nan_at))) for m in range(4)]

        tr.step_microbatches(micros())
        before = [p.data().asnumpy() for p in net.collect_params().values()]
        tr.step_microbatches(micros(nan_at=1))
        scalars["veto_outcome"] = tr.last_outcome.name
        scalars["veto_frozen"] = all(
            np.array_equal(a, p.data().asnumpy()) for a, p in
            zip(before, net.collect_params().values()))
        tr.step_microbatches(micros())
        scalars["veto_after"] = tr.last_outcome.name
        scalars["veto_accum_trace"] = tr.pipelined_accum_step_trace_count

        # the refusals of the pipelined step's rules (at the first step)
        X, y = toy_data()
        batch = (nd.array(X), nd.array(y), nd.array(np.ones(8, np.float32)))
        refusal("tp", lambda: toy({"tp": 2}, "replicated", True)[1]
                .step(*batch))
        refusal("norm", lambda: toy({"dp": 1, "fsdp": 2}, "fsdp", True,
                                    optimizer="lamb")[1].step(*batch))

        def mutating():
            net = nn.Sequential()
            net.add(nn.Dense(16, in_units=8), nn.BatchNorm(in_channels=16),
                    nn.Dense(4, in_units=16))
            net.initialize()

            def head(x, X, y, flag):
                sq = (x - y) ** 2
                return (sq.sum(), count_of(sq))

            spec = PipelineSpec(blocks=[net[0], net[1], net[2]], head=head,
                                finalize=mean_of)
            parallel.SPMDTrainer(
                net, pipeline=spec, optimizer="adam",
                optimizer_params={"learning_rate": 0.01},
                mesh=parallel.build_mesh(axis_sizes={"dp": 2})).step(*batch)
        refusal("mutating", mutating)

        # the models: gpt_mini (mean and weighted) and bert_tiny, plain
        # against pipelined on dp2 and fsdp2; the remat plan against the
        # model-level remat
        os.environ["MXTPU_GRAD_BUCKET_BYTES"] = MODEL_BUCKET_BYTES
        os.environ.pop("MXTPU_FSDP_MIN_SIZE")

        def gpt_run(tag, axes, sharding, weighted=False, remat=False,
                    plan=None, pipelined=True):
            m = tg.gpt_mini(max_length=GPT_T, remat=remat)
            m.initialize()
            m.load_state_dict(convert.block_params_from_jax(
                m, weights("gpt")))
            loss = dict(pipeline=tg.lm_pipeline(m, weighted=weighted),
                        remat_plan=plan) if pipelined \
                else dict(forward_loss=tg.lm_loss)
            tr = parallel.SPMDTrainer(
                m, optimizer="adam", optimizer_params={"learning_rate": 1e-3},
                mesh=parallel.build_mesh(axis_sizes=axes),
                sharding=sharding, **loss)
            losses = [float(tr.step(*[nd.array(a) for a in b]).asnumpy())
                      for b in gpt_batches(weighted)]
            record(tag, tr, losses)

        for axes, sharding in (({"dp": 2}, "replicated"),
                               ({"dp": 1, "fsdp": 2}, "fsdp")):
            for pipelined in (False, True):
                gpt_run(f"gpt_{sharding}_{int(pipelined)}", axes, sharding,
                        pipelined=pipelined)
        for pipelined in (False, True):
            gpt_run(f"gptw_{int(pipelined)}", {"dp": 2}, "replicated",
                    weighted=True, pipelined=pipelined)
        for rm in ("dots", True):
            name = "dots" if rm == "dots" else "all"
            gpt_run(f"gpt_remat_{name}_0", {"dp": 2}, "replicated",
                    remat=rm, pipelined=False)
            gpt_run(f"gpt_remat_{name}_1", {"dp": 2}, "replicated",
                    plan=[rm] * 2)

        for axes, sharding in (({"dp": 2}, "replicated"),
                               ({"dp": 1, "fsdp": 2}, "fsdp")):
            for pipelined in (False, True):
                pre = tb.BERTForPretraining(tb.bert_tiny(
                    vocab_size=BERT_V, max_length=BERT_T, dropout=0.0))
                pre.initialize()
                pre.load_state_dict(convert.bert_params_from_jax(
                    pre, weights("bert")))
                loss = dict(pipeline=tb.pretraining_pipeline(pre)) \
                    if pipelined else dict(forward_loss=tb.pretraining_loss)
                tr = parallel.SPMDTrainer(
                    pre, optimizer="adam",
                    optimizer_params={"learning_rate": 1e-3},
                    mesh=parallel.build_mesh(axis_sizes=axes),
                    sharding=sharding, **loss)
                losses = [float(tr.step(*[nd.array(a) for a in b])
                                .asnumpy()) for b in bert_batches()]
                record(f"bert_{sharding}_{int(pipelined)}", tr, losses)

    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(scalars, f)


if __name__ == "__main__":
    main(sys.argv[1])
