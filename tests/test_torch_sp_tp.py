"""Sequence and tensor parallelism across processes, on the CPU: four gloo
ranks started once through the unchanged ``tools/launch.py --launcher
local``, each running every scenario of ``tests/test_torch_sp_tp_worker.py``
in one process group, held here against the JAX package on its forced
CPU devices (the same mesh over 4 of them) or against the port in one
process. Every case has at least two ranks on the axis it tests.

  - ``ring_flash_attention`` (the distributed flash ring: its hops over
    the sp group, the dk / dv accumulators riding home, on the plain
    block versions) on sp2 (dp2 x sp2) and sp4, causal and not, against
    the JAX ``ring_flash_attention`` on that mesh: every rank's output
    block and q / k / v gradients within rtol 1e-5;
  - GPT (``gpt_mini``, ``seq_parallel=True``, Adam 1e-3, 3 steps) on
    dp2 x sp2 against the JAX trainer on that mesh: losses within rtol
    1e-4, whole parameters within rtol 5e-4 / atol 5e-5 (the JAX test's
    own bounds); the weighted ``lm_loss`` (the weight sum over the dp and
    sp ranks) against the JAX trainer on that mesh and the port in one
    process; sp4 with ``remat=True`` and sp2 x tp2 against the dp2 x sp2
    JAX trajectory (the global batch's loss does not depend on how the
    ranks split it);
  - GPT on fsdp2 x tp2 (``sharding="fsdp"``: the tp hints kept, fsdp on a
    free dimension; the logits vocab-split over tp) against the JAX
    trainer on that mesh, with every rank's losses equal; its capsule
    writes every shard once and a trainer restored from it resumes
    bit-exact;
  - BERT (``bert_tiny``, ``seq_parallel=True``, ragged valid lengths with
    a 0) on sp4, 2 Adam steps, against the JAX trainer: losses within
    rtol 2e-4; on sp2 x tp2 (the MLM scores vocab-split over tp) against
    the same trajectory; on dp2 x sp2 with ragged MLM weights against the
    JAX trainer on that mesh, losses within rtol 2e-4 and parameters
    within rtol 5e-4 / atol 5e-5;
  - ``Embedding(sharded=True)`` on fsdp2 x tp2: the update of V/4 rows a
    rank, the trajectory of the replicated table's within 1e-5 and the
    JAX trainer's;
  - the serving engine on a tp2 mesh: every rank's pools hold 2 of the 4
    heads, and the greedy streams equal the unsharded engine's and the
    JAX ``cached_generate``'s;
  - ``step_trace_count`` equals the JAX jit count on every mesh.

A rank that dies, or a run past its 300 s limit, fails the tests.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.models import bert as jb, gpt as jg
from incubator_mxnet_tpu.parallel import mesh as jmesh
from incubator_mxnet_tpu.parallel import ring_attention as jra

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd, parallel
from incubator_mxnet_tpu_torch.models import convert, gpt as tg

import test_torch_sp_tp_worker as w
from test_torch_parity import fresh_names, jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 300


def _jax_gpt(max_length=w.T, **kw):
    jmx.random.seed(3)
    fresh_names()
    m = jg.gpt_mini(vocab_size=w.V, max_length=max_length, **kw)
    m.initialize()
    return m


def _jax_bert():
    jmx.random.seed(4)
    fresh_names()
    m = jb.bert_tiny(vocab_size=w.V, max_length=w.T, seq_parallel=True,
                     dropout=0.0)
    m.initialize()
    pre = jb.BERTForPretraining(m)
    pre.initialize()
    return pre


def _jax_emb():
    jmx.random.seed(3)
    fresh_names()
    net = w.emb_net(jgluon, True)
    net.initialize()
    return net


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmesh.build_mesh(devices=jax.devices()[:n], axis_sizes=axes)


def _jax_gpt_run(axes, sharding="replicated", weighted=False):
    m = _jax_gpt(seq_parallel=True)
    tr = jparallel.SPMDTrainer(
        m, forward_loss=jg.lm_loss, optimizer="adam",
        optimizer_params={"learning_rate": 1e-3}, mesh=_mesh(axes),
        sharding=sharding)
    ids, labels, wts = w.gpt_batch()
    batch = [jnd.array(ids), jnd.array(labels)] + \
        ([jnd.array(wts)] if weighted else [])
    losses = [float(tr.step(*batch).asnumpy()) for _ in range(3)]
    return dict(losses=losses, trace=tr.step_trace_count,
                params=jax_params(m))


def _jax_bert_run(axes, masked_weights=None):
    pre = _jax_bert()
    tr = jparallel.SPMDTrainer(
        pre, forward_loss=jb.pretraining_loss, optimizer="adam",
        optimizer_params={"learning_rate": 1e-3}, mesh=_mesh(axes))
    losses = [float(tr.step(*[jnd.array(a, dtype=str(a.dtype))
                              for a in b]).asnumpy())
              for b in w.bert_batches(masked_weights=masked_weights)]
    return dict(losses=losses, trace=tr.step_trace_count,
                params=jax_params(pre))


def _jax_rings():
    """The JAX ``ring_flash_attention`` on each ring mesh, causal and
    not: output and the q / k / v gradients at the ranks' cotangent, as
    one jitted program each."""
    q, k, v, g = (jnp.asarray(a) for a in w.ring_inputs())
    out = {}
    for name, axes in w.RING_MESHES.items():
        mesh = _mesh(axes)
        for causal in (False, True):
            def fn(q, k, v, causal=causal):
                return jra.ring_flash_attention(q, k, v, mesh=mesh,
                                                causal=causal)

            @jax.jit
            def run(q, k, v, g):
                o, vjp = jax.vjp(fn, q, k, v)
                return (o,) + vjp(g)
            out[f"{name}_{'causal' if causal else 'full'}"] = dict(zip(
                ("out", "dq", "dk", "dv"),
                (np.asarray(a) for a in run(q, k, v, g))))
    return out


def _jax_references():
    """Every JAX trajectory the tests hold the ranks against."""
    ref = {"gpt_sp": _jax_gpt_run({"dp": 2, "sp": 2}),
           "gpt_sp_w": _jax_gpt_run({"dp": 2, "sp": 2}, weighted=True),
           "gpt_tp": _jax_gpt_run({"fsdp": 2, "tp": 2}, "fsdp"),
           "bert_sp": _jax_bert_run({"sp": 4}),
           "bert_dpsp": _jax_bert_run({"dp": 2, "sp": 2},
                                      w.RAGGED_MLM_WEIGHTS),
           "ring": _jax_rings()}
    net = _jax_emb()
    tr = jparallel.SPMDTrainer(
        net, loss=jgluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        optimizer_params={"learning_rate": 0.5},
        mesh=_mesh({"fsdp": 2, "tp": 2}), sharding="fsdp")
    ex, ey = w.emb_batch()
    ref["emb"] = dict(
        losses=[float(tr.step(jnd.array(ex, dtype="int32"),
                              jnd.array(ey)).asnumpy()) for _ in range(3)],
        trace=tr.step_trace_count, params=jax_params(net))
    em = _jax_gpt(max_length=w.ENGINE_VL)
    ref["engine"] = [
        jg.cached_generate(em, jnd.array(p[None, :], dtype="int32"),
                           max_new_tokens=w.ENGINE_NEW).asnumpy()
        [0, p.size:].tolist() for p in w.engine_prompts()]
    return ref


def _inputs(out):
    """The JAX models' initial weights, by structural name, for the
    ranks."""
    arrays = {}
    for tag, params in (("gpt", jax_params(_jax_gpt())),
                        ("bert", jax_params(_jax_bert())),
                        ("engine", jax_params(_jax_gpt(w.ENGINE_VL)))):
        arrays.update({f"{tag}/{k}": v for k, v in params.items()})
    net = _jax_emb()
    for j, p in enumerate(net.collect_params().values()):
        arrays[f"emb/{j}"] = p.data().asnumpy()
    np.savez(os.path.join(out, "inputs.npz"), **arrays)


@pytest.fixture(scope="module")
def outdir(tmp_path_factory):
    """The ranks' directory: the inputs, their results, the capsule."""
    return str(tmp_path_factory.mktemp("sptp"))


@pytest.fixture(scope="module")
def run(outdir):
    """Every rank's ``(arrays, scalars)`` and the JAX references (built
    while the ranks run)."""
    out = outdir
    _inputs(out)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
           "4", "--launcher", "local", "--", sys.executable,
           os.path.join(ROOT, "tests", "test_torch_sp_tp_worker.py"), out]
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        ref = _jax_references()
        log, _ = proc.communicate(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        pytest.fail(f"the four-rank run passed its {LIMIT_S} s limit:\n"
                    + log[-4000:])
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if proc.returncode != 0:
        pytest.fail(f"a rank failed (exit {proc.returncode}):\n"
                    + log[-6000:])
    ranks = []
    for r in range(4):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            scalars = json.load(f)
        ranks.append((dict(np.load(os.path.join(out, f"rank{r}.npz"))),
                      scalars))
    return ranks, ref


def _params(arrays, tag):
    return {k[len(tag) + 1:]: v for k, v in arrays.items()
            if k.startswith(tag + "/")}


def _same_on_every_rank(ranks, tag):
    a0, s0 = ranks[0]
    for a, s in ranks[1:]:
        assert s[f"{tag}_losses"] == s0[f"{tag}_losses"], tag
        for k, v in _params(a0, tag).items():
            np.testing.assert_array_equal(_params(a, tag)[k], v,
                                          err_msg=f"{tag}/{k}")


def _close_params(got, want, rtol=5e-4, atol=5e-5):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_four_gloo_ranks(run):
    assert [s["world"] for _, s in run[0]] == [4] * 4


@pytest.mark.parametrize("tag", ["gpt_sp", "gpt_sp4", "gpt_sptp"])
def test_gpt_seq_parallel_matches_jax(run, tag):
    """dp2 x sp2 against the JAX trainer on that mesh; sp4 (remat) and
    sp2 x tp2 against the same trajectory."""
    ranks, ref = run
    _same_on_every_rank(ranks, tag)
    a0, s0 = ranks[0]
    want = ref["gpt_sp"]
    np.testing.assert_allclose(s0[f"{tag}_losses"], want["losses"],
                               rtol=1e-4)
    assert s0[f"{tag}_trace"] == want["trace"] == 1
    _close_params(_params(a0, tag), want["params"])


@pytest.mark.parametrize("tag", [f"{n}_{c}" for n in w.RING_MESHES
                                 for c in ("full", "causal")])
def test_ring_flash_attention_across_ranks_matches_jax(run, tag):
    """Every rank's output block and q / k / v gradients of the
    distributed flash ring against the JAX ring on the same mesh."""
    ranks, ref = run
    name = tag.rsplit("_", 1)[0]
    sp = w.RING_MESHES[name]["sp"]
    seen = set()
    for arrays, scalars in ranks:
        n = scalars[f"{name}_index"]
        seen.add(n)
        for part in ("out", "dq", "dk", "dv"):
            want = w.ring_block(ref["ring"][tag][part], n, sp)
            np.testing.assert_allclose(arrays[f"{tag}/{part}"], want,
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{tag} rank {n} {part}")
    assert seen == set(range(sp))


def test_gpt_seq_parallel_weighted_loss(run):
    """The weighted ``lm_loss`` on dp2 x sp2 (the weighted sum over the
    global weight sum, the tiles' sums added over dp and sp) against the
    JAX trainer on that mesh and the port in one process."""
    ranks, ref = run
    _same_on_every_rank(ranks, "gpt_sp_w")
    a0, s0 = ranks[0]
    jw = ref["gpt_sp_w"]
    np.testing.assert_allclose(s0["gpt_sp_w_losses"], jw["losses"],
                               rtol=1e-4)
    assert s0["gpt_sp_w_trace"] == jw["trace"] == 1
    _close_params(_params(a0, "gpt_sp_w"), jw["params"])
    ids, labels, wts = w.gpt_batch()
    with mx.cpu():
        m = tg.gpt_mini(vocab_size=w.V, max_length=w.T)
        m.initialize()
        m.load_state_dict(convert.block_params_from_jax(
            m, jax_params(_jax_gpt())))
        tr = parallel.SPMDTrainer(
            m, forward_loss=tg.lm_loss, optimizer="adam",
            optimizer_params={"learning_rate": 1e-3},
            mesh=parallel.build_mesh())
        want = [float(tr.step(nd.array(ids), nd.array(labels),
                              nd.array(wts)).asnumpy()) for _ in range(3)]
        params = {k: p.data().asnumpy()
                  for k, p in m._collect_params_with_prefix().items()}
    np.testing.assert_allclose(s0["gpt_sp_w_losses"], want, rtol=1e-4)
    _close_params(_params(a0, "gpt_sp_w"), params)


def test_gpt_tensor_parallel_matches_jax(run):
    """fsdp2 x tp2 against the JAX trainer on that mesh (the four-rank
    form of the JAX multihost tp x fsdp case), every rank's losses equal;
    the shard plans keep the tp hints and put fsdp on a free dimension."""
    ranks, ref = run
    _same_on_every_rank(ranks, "gpt_tp")
    a0, s0 = ranks[0]
    want = ref["gpt_tp"]
    np.testing.assert_allclose(s0["gpt_tp_losses"], want["losses"],
                               rtol=1e-4)
    assert s0["gpt_tp_trace"] == want["trace"] == 1
    _close_params(_params(a0, "gpt_tp"), want["params"])
    plans = {tuple(map(tuple, p)) for p in s0["gpt_tp_plans"]}
    assert ((0, "tp"), (1, "fsdp")) in plans          # qkv, ffn_in
    assert ((0, "fsdp"), (1, "tp")) in plans          # proj, ffn_out
    assert ((0, "tp"), (0, "fsdp")) in plans          # word_embed


@pytest.mark.parametrize("tag", ["bert_sp", "bert_sptp", "bert_dpsp"])
def test_bert_seq_parallel_matches_jax(run, tag):
    """sp4 against the JAX trainer on that mesh; sp2 x tp2 (heads and the
    MLM vocabulary over tp) against the same trajectory; dp2 x sp2 with
    ragged MLM weights against the JAX trainer on that mesh, parameters
    too."""
    ranks, ref = run
    _same_on_every_rank(ranks, tag)
    a0, s0 = ranks[0]
    want = ref["bert_dpsp" if tag == "bert_dpsp" else "bert_sp"]
    np.testing.assert_allclose(s0[f"{tag}_losses"], want["losses"],
                               rtol=2e-4)
    assert s0[f"{tag}_trace"] == want["trace"] == 1
    if tag == "bert_dpsp":
        _close_params(_params(a0, tag), want["params"])


def test_tp_capsule_writes_each_shard_once(run, outdir):
    """The fsdp2 x tp2 GPT trainer's capsule: every rank writes its
    manifest; each sharded entry's shards are distinct boxes that cover
    the whole array once, and a replicated entry is written by rank 0
    alone."""
    d = mx.checkpoint.step_dir(os.path.join(outdir, "tp_capsule"), 3)
    mans = []
    for r in range(4):
        name = "manifest.json" if r == 0 else f"manifest.p{r}.json"
        with open(os.path.join(d, name)) as f:
            mans.append(json.load(f))
        assert mans[-1]["process_index"] == r
    entries = {}
    for r, m in enumerate(mans):
        for key, e in m["arrays"].items():
            entries.setdefault(key, []).append((r, e))
    specs = set()
    for key, found in entries.items():
        shape = found[0][1]["shape"]
        boxes = [tuple(map(tuple, sh["index"])) for _, e in found
                 for sh in e["shards"]]
        assert len(set(boxes)) == len(boxes), key          # none twice
        n = sum(int(np.prod([b - a for a, b in box])) for box in boxes)
        assert n == int(np.prod(shape)), key               # all covered
        if found[0][1]["spec"] is None:
            assert [r for r, _ in found] == [0], key
        else:
            specs.add(found[0][1]["spec"])
    assert any("tp" in sp and "fsdp" in sp for sp in specs), specs


def test_tp_capsule_resume_is_bit_exact(run):
    for _, s in run[0]:
        assert s["tp_capsule_saved"] == s["tp_capsule_got"] == 3
        assert s["tp_capsule_res"] == s["tp_capsule_ref"]


def test_sharded_embedding_vocab_split_matches_replicated(run):
    ranks, ref = run
    for tag in ("emb_plain", "emb_sharded"):
        _same_on_every_rank(ranks, tag)
    a0, s0 = ranks[0]
    # the vocabulary really split 4 ways (tp2 x fsdp2): V/4 rows a rank
    assert s0["emb_sharded_shard"] == [w.EMB_V // 4, w.EMB_U]
    assert s0["emb_plain_shard"] is None
    np.testing.assert_allclose(s0["emb_sharded_losses"],
                               s0["emb_plain_losses"], atol=1e-5)
    np.testing.assert_allclose(s0["emb_sharded_losses"],
                               ref["emb"]["losses"], rtol=1e-5)
    assert s0["emb_sharded_trace"] == ref["emb"]["trace"] == 1
    got = list(_params(a0, "emb_sharded").values())
    plain = list(_params(a0, "emb_plain").values())
    for g, p, j in zip(got, plain, ref["emb"]["params"].values()):
        np.testing.assert_allclose(g, p, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g, j, rtol=1e-5, atol=1e-6)


def test_engine_tp_streams_match_unsharded_and_jax(run):
    ranks, ref = run
    for _, s in ranks:
        assert s["engine_tp_pool_heads"] == 2
        assert s["engine_one_pool_heads"] == 4
        assert s["engine_tp_streams"] == s["engine_one_streams"] == \
            ref["engine"]
