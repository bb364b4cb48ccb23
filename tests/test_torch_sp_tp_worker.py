"""The worker of ``tests/test_torch_sp_tp.py``: every sequence- and
tensor-parallel scenario the tests check, run once by each rank of a
four-process gloo group on the CPU.

Run through the unchanged launcher (which sets ``MXTPU_COORDINATOR``,
``MXTPU_NUM_PROCS`` and ``MXTPU_PROC_ID``)::

    python tools/launch.py -n 4 --launcher local -- \\
        python tests/test_torch_sp_tp_worker.py OUTDIR

``OUTDIR`` holds the inputs the parent test wrote (``inputs.npz``: the
JAX models' weights by structural name and the batches). Each rank writes
``OUTDIR/rank<r>.npz`` (arrays) and ``rank<r>.json`` (scalars and
lists). The module holds no test and imports neither JAX nor the JAX
package.
"""

import json
import os
import sys

import numpy as np

# the shapes both sides use
V, T, B = 64, 32, 4          # gpt_mini / bert_tiny vocabulary, sequence
BERT_B, BERT_M = 4, 4
EMB_V, EMB_U, EMB_B, EMB_T = 64, 8, 8, 4
ENGINE_PROMPTS = (5, 13)
ENGINE_NEW = 9
ENGINE_VL = 64               # the engine model's max_length


def gpt_batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, V, (B, T)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], ids[:, :1]], axis=1)
    weights = (rng.rand(B, T) > 0.3).astype(np.float32)
    return ids, labels.astype(np.int32), weights


# ragged MLM weights: the two dp tiles (rows 0-1, 2-3) weigh 5 and 2
# positions, so the mean over the tiles' ratios is not the global ratio
RAGGED_MLM_WEIGHTS = np.array([[1, 1, 1, 0], [1, 1, 0, 0], [0, 1, 0, 0],
                               [0, 0, 0, 1]], np.float32)


def bert_batches(steps=2, masked_weights=None):
    rng = np.random.RandomState(0)
    vls = np.array([T, 24, 0, 13], np.int32)
    mw = np.ones((BERT_B, BERT_M), np.float32) if masked_weights is None \
        else masked_weights
    out = []
    for _ in range(steps):
        out.append((rng.randint(0, V, (BERT_B, T)).astype(np.int32),
                    rng.randint(0, 2, (BERT_B, T)).astype(np.int32),
                    vls,
                    rng.randint(0, T, (BERT_B, BERT_M)).astype(np.int32),
                    rng.randint(0, V, (BERT_B, BERT_M)).astype(np.int32),
                    mw,
                    rng.randint(0, 2, (BERT_B,)).astype(np.int32)))
    return out


# the distributed flash ring on CPU tensors: (B, T, H, D) f32, and the
# meshes it runs on (two and four ranks on sp)
RING_SHAPE = (2, 32, 2, 8)
RING_MESHES = {"ring_sp2": {"dp": 2, "sp": 2}, "ring_sp4": {"sp": 4}}


def ring_inputs():
    rng = np.random.RandomState(11)
    return [rng.randn(*RING_SHAPE).astype(np.float32) for _ in range(4)]


def ring_block(a, n, sp):
    """Rank ``n``'s block on an sp axis of ``sp`` of a (B, T, H, D)
    array."""
    t = a.shape[1] // sp
    return a[:, n * t:(n + 1) * t]


def emb_batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, EMB_V, (EMB_B, EMB_T)).astype(np.int32),
            rng.randint(0, 4, (EMB_B,)).astype(np.float32))


def engine_prompts():
    rng = np.random.RandomState(7)
    return [rng.randint(0, V, size=(n,)).astype(np.int32)
            for n in ENGINE_PROMPTS]


def emb_net(g, sharded):
    """The JAX ``test_sharded_embedding_vocab_split_matches_replicated``
    model: a (V, U) table, a mean over the sequence, a Dense head."""
    class Tiny(g.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.emb = g.nn.Embedding(EMB_V, EMB_U, sharded=sharded)
                self.out = g.nn.Dense(4, in_units=EMB_U)

        def hybrid_forward(self, F, x):
            return self.out(self.emb(x).mean(axis=1))
    return Tiny()


def main(outdir):
    import torch
    torch.set_num_threads(1)
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    from incubator_mxnet_tpu_torch import gluon, nd, parallel
    from incubator_mxnet_tpu_torch.models import bert as tb, convert
    from incubator_mxnet_tpu_torch.models import gpt as tg
    from incubator_mxnet_tpu_torch.parallel import ring_attention as ra
    from incubator_mxnet_tpu_torch.serve import InferenceEngine, Request

    inputs = dict(np.load(os.path.join(outdir, "inputs.npz")))

    def weights(prefix):
        return {k[len(prefix) + 1:]: v for k, v in inputs.items()
                if k.startswith(prefix + "/")}

    arrays, scalars = {}, {}

    def keep(tag, tr):
        """The trainer's whole parameters (every rank gathers) under
        ``tag/<structural name>``."""
        for name, a in parallel.gather_full_params(tr).items():
            arrays[f"{tag}/{name}"] = a

    with mx.cpu():
        parallel.initialize()
        rank = parallel.mesh.rank()
        scalars["world"] = parallel.mesh.world_size()

        # the flash ring across ranks (ring_flash_attention: the
        # distributed loop, the plain block versions on CPU tensors), its
        # output and gradients of this rank's blocks
        rq, rk, rv, rg = ring_inputs()
        for name, axes in RING_MESHES.items():
            mesh = parallel.build_mesh(axis_sizes=axes)
            n, sp = parallel.mesh.axis_index(mesh, "sp"), axes["sp"]
            scalars[f"{name}_index"] = n
            for causal in (False, True):
                tag = f"{name}_{'causal' if causal else 'full'}"
                tq, tk, tv = (torch.tensor(ring_block(a, n, sp),
                                           requires_grad=True)
                              for a in (rq, rk, rv))
                out = ra.ring_flash_attention(tq, tk, tv, mesh=mesh,
                                              causal=causal)
                out.backward(torch.tensor(ring_block(rg, n, sp)))
                for part, t in (("out", out.detach()), ("dq", tq.grad),
                                ("dk", tk.grad), ("dv", tv.grad)):
                    arrays[f"{tag}/{part}"] = t.numpy()

        def gpt(seq_parallel, src="gpt", **kw):
            m = tg.gpt_mini(vocab_size=V, max_length=T,
                            seq_parallel=seq_parallel, **kw)
            m.initialize()
            if src is not None:
                m.load_state_dict(convert.block_params_from_jax(
                    m, weights(src)))
            return m

        ids, labels, w = gpt_batch()

        def gpt_run(tag, model, axes, sharding="replicated", weighted=False,
                    steps=3):
            mesh = parallel.build_mesh(axis_sizes=axes)
            fl = (lambda mdl, i, l, ww: tg.lm_loss(mdl, i, l, ww)) \
                if weighted else tg.lm_loss
            tr = parallel.SPMDTrainer(
                model, forward_loss=fl, optimizer="adam",
                optimizer_params={"learning_rate": 1e-3}, mesh=mesh,
                sharding=sharding)
            batch = [nd.array(ids), nd.array(labels)] + \
                ([nd.array(w)] if weighted else [])
            scalars[f"{tag}_losses"] = [
                float(tr.step(*batch).asnumpy()) for _ in range(steps)]
            scalars[f"{tag}_trace"] = tr.step_trace_count
            scalars[f"{tag}_plans"] = [list(map(list, p))
                                       for p in tr._shard_plans]
            keep(tag, tr)
            return tr

        # sequence parallelism: dp2 x sp2, the mean and the weighted loss
        gpt_run("gpt_sp", gpt(True), {"dp": 2, "sp": 2})
        gpt_run("gpt_sp_w", gpt(True), {"dp": 2, "sp": 2}, weighted=True)
        # the sp ring with every rank on one sequence (sp4), rematerialized
        gpt_run("gpt_sp4", gpt(True, remat=True), {"sp": 4})
        # tensor parallelism: fsdp2 x tp2 (the JAX multihost case's mesh)
        tr = gpt_run("gpt_tp", gpt(False), {"fsdp": 2, "tp": 2},
                     sharding="fsdp")
        # its capsule: saved after the 3 steps, 3 more steps, then a
        # trainer of other weights restored from it takes the same 3
        m = ckpt.CheckpointManager(os.path.join(outdir, "tp_capsule"),
                                   keep=0)
        scalars["tp_capsule_saved"] = tr.save_checkpoint(m, block=True)
        m.close()
        batch = (nd.array(ids), nd.array(labels))
        scalars["tp_capsule_ref"] = [float(tr.step(*batch).asnumpy())
                                     for _ in range(3)]
        mx.random.seed(9)
        tr2 = parallel.SPMDTrainer(
            gpt(False, src=None), forward_loss=tg.lm_loss, optimizer="adam",
            optimizer_params={"learning_rate": 1e-3},
            mesh=parallel.build_mesh(axis_sizes={"fsdp": 2, "tp": 2}),
            sharding="fsdp")
        m = ckpt.CheckpointManager(os.path.join(outdir, "tp_capsule"),
                                   keep=0)
        scalars["tp_capsule_got"] = tr2.restore_checkpoint(m)
        m.close()
        scalars["tp_capsule_res"] = [float(tr2.step(*batch).asnumpy())
                                     for _ in range(3)]
        # both axes at once: sp2 x tp2
        gpt_run("gpt_sptp", gpt(True), {"sp": 2, "tp": 2})

        # BERT with ragged valid lengths (one of them 0): sp4, sp2 x tp2
        # (its heads and its vocabulary split over tp), and dp2 x sp2 with
        # ragged MLM weights (the ratio over the global weight sum)
        for tag, axes, mw in (
                ("bert_sp", {"sp": 4}, None),
                ("bert_sptp", {"sp": 2, "tp": 2}, None),
                ("bert_dpsp", {"dp": 2, "sp": 2}, RAGGED_MLM_WEIGHTS)):
            bm = tb.bert_tiny(vocab_size=V, max_length=T, seq_parallel=True,
                              dropout=0.0)
            pre = tb.BERTForPretraining(bm)
            pre.initialize()
            pre.load_state_dict(convert.bert_params_from_jax(
                pre, weights("bert")))
            tr = parallel.SPMDTrainer(
                pre, forward_loss=tb.pretraining_loss, optimizer="adam",
                optimizer_params={"learning_rate": 1e-3},
                mesh=parallel.build_mesh(axis_sizes=axes))
            scalars[f"{tag}_losses"] = [
                float(tr.step(*[nd.array(a) for a in b]).asnumpy())
                for b in bert_batches(masked_weights=mw)]
            scalars[f"{tag}_trace"] = tr.step_trace_count
            keep(tag, tr)

        # Embedding(sharded=True) over tp2 x fsdp2 against the replicated
        # table on the same mesh
        ex, ey = emb_batch()
        for sharded in (False, True):
            tag = "emb_sharded" if sharded else "emb_plain"
            net = emb_net(gluon, sharded)
            net.initialize()
            for p, a in zip(net.collect_params().values(),
                            (inputs["emb/0"], inputs["emb/1"],
                             inputs["emb/2"])):
                p.set_data(nd.array(a))
            tr = parallel.SPMDTrainer(
                net, loss=gluon.loss.SoftmaxCrossEntropyLoss(),
                optimizer="sgd", optimizer_params={"learning_rate": 0.5},
                mesh=parallel.build_mesh(axis_sizes={"fsdp": 2, "tp": 2}),
                sharding="fsdp")
            scalars[f"{tag}_losses"] = [
                float(tr.step(nd.array(ex), nd.array(ey)).asnumpy())
                for _ in range(3)]
            scalars[f"{tag}_shard"] = list(tr._shards[0].shape) \
                if tr._shards[0] is not None else None
            scalars[f"{tag}_trace"] = tr.step_trace_count
            keep(tag, tr)

        # the engine on a tp2 mesh (each dp pair serves the same requests)
        em = tg.gpt_mini(vocab_size=V, max_length=ENGINE_VL)
        em.initialize()
        em.load_state_dict(convert.block_params_from_jax(
            em, weights("engine")))
        for tag, mesh in (("engine_tp", parallel.build_mesh(
                axis_sizes={"dp": 2, "tp": 2})), ("engine_one", None)):
            eng = InferenceEngine(em, num_slots=2, page_size=8,
                                  max_len=ENGINE_VL, mesh=mesh)
            reqs = [Request(p, max_new_tokens=ENGINE_NEW)
                    for p in engine_prompts()]
            eng.run(reqs)
            scalars[f"{tag}_streams"] = [[int(t) for t in r.token_ids]
                                         for r in reqs]
            scalars[f"{tag}_pool_heads"] = int(eng._kpools[0].shape[1])

    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(scalars, f)


if __name__ == "__main__":
    main(sys.argv[1])
