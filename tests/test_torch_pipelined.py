"""The pipelined-backward SPMD step across processes, on the CPU: two gloo
ranks started once through the unchanged ``tools/launch.py --launcher
local``, each running every scenario of
``tests/test_torch_pipelined_worker.py`` in one process group, held here
against the port's plain step on the same ranks (bitwise) and against
the JAX pipelined trainer on the same mesh over two of its forced CPU
devices (losses within rtol 2e-4, parameters within rtol 5e-4 / atol
5e-5: the trainer tolerances of the other parity files). The cases are
those of ``tests/test_pipelined_step.py``:

  - the toy Dense net on dp2 and fsdp2 (``MXTPU_FSDP_MIN_SIZE=0``: every
    weight sharded), clean and with a NaN at one step (the guard vetoes
    it on both steps), ``grad_collective="ring"`` on dp2: bitwise the
    plain step's losses and parameters, one capture
    (``pipelined_step_trace_count``) as the JAX trainer traces once;
  - the issue ledger: the bucket order equals ``plan_grad_buckets``'
    (256-byte buckets, a multi-bucket plan) and the buckets are
    interleaved with the block pullbacks (``structure_report``);
  - accumulation at k in (1, 4, 8): one build, bitwise the plain
    accumulation; a non-finite microbatch vetoes its round;
  - int8: the guard reads the dequantized gradients (the NaN step is
    vetoed, every issue is ``int8_psum``);
  - the refusals at the first step: a tp mesh, LAMB under fsdp, a
    BatchNorm forward (it writes its running statistics);
  - ``gpt_mini``'s ``lm_pipeline`` (mean and weighted) and ``bert_tiny``'s
    ``pretraining_pipeline`` on dp2 and fsdp2, bitwise the plain step;
    the remat plan ``["dots"] * 2`` / ``[True] * 2`` bitwise the model's
    own remat.

In one process: ``PipelineSpec``'s validation, ``remat_plan`` /
``int8_allreduce`` without ``pipeline=`` and int8 with the ring refused
as in JAX, and ``pipelined_hlo``'s departure (no program text).

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
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.gluon import nn as jnn
from incubator_mxnet_tpu.models import bert as jb, gpt as jg
from incubator_mxnet_tpu.parallel import mesh as jmesh
from incubator_mxnet_tpu.parallel.pipelined import PipelineSpec as JSpec

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import parallel
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.parallel.pipelined import PipelineSpec

import test_torch_pipelined_worker as w
from test_torch_parity import fresh_names, jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 300


def _mesh(axes):
    return jmesh.build_mesh(devices=jax.devices()[:2], axis_sizes=axes)


def _jax_toy():
    jmx.random.seed(7)
    fresh_names()
    net = jnn.Sequential()
    net.add(jnn.Dense(16, in_units=8, activation="relu"),
            jnn.Dense(4, in_units=16))
    net.initialize()
    return net


def _jax_mse_spec(net):
    """The JAX test's spec: global partial sums, finalize on them."""
    def head(x, X, y, flag):
        sq = (x._data - y._data) ** 2
        f = flag._data
        return (jnp.sum(sq), jnp.float32(sq.size), jnp.sum(f),
                jnp.float32(f.size))

    def fin(n1, d1, n2, d2):
        return (n1 / d1) * (n2 / d2)

    return JSpec(blocks=[net[0], net[1]], head=head, finalize=fin)


def _jax_toy_run(axes, sharding, accum=False):
    net = _jax_toy()
    tr = jparallel.SPMDTrainer(
        net, pipeline=_jax_mse_spec(net), optimizer="adam",
        optimizer_params={"learning_rate": 0.01}, mesh=_mesh(axes),
        sharding=sharding)
    if accum:
        X, y = w.toy_data(seed=2, n=16)
        losses = [float(tr.step_microbatches([
            (jnd.array(X[m * 2:(m + 1) * 2]), jnd.array(y[m * 2:(m + 1) * 2]),
             jnd.array(np.ones(2, np.float32))) for m in range(k)])
            .asnumpy()) for k in (1, 4, 8)]
        trace = tr.pipelined_accum_step_trace_count
    else:
        X, y = w.toy_data()
        losses = [float(tr.step(jnd.array(X), jnd.array(y),
                                jnd.array(np.ones(8, np.float32)))
                        .asnumpy()) for _ in range(5)]
        trace = tr.pipelined_step_trace_count
    return dict(losses=losses, trace=trace,
                params=[p.data().asnumpy()
                        for p in net.collect_params().values()])


def _jax_gpt():
    jmx.random.seed(3)
    fresh_names()
    m = jg.gpt_mini(max_length=w.GPT_T)
    m.initialize()
    return m


def _jax_bert():
    jmx.random.seed(5)
    fresh_names()
    pre = jb.BERTForPretraining(jb.bert_tiny(
        vocab_size=w.BERT_V, max_length=w.BERT_T, dropout=0.0))
    pre.initialize()
    return pre


def _jax_model_run(model, spec, batches, axes, sharding):
    tr = jparallel.SPMDTrainer(
        model, pipeline=spec, optimizer="adam",
        optimizer_params={"learning_rate": 1e-3}, mesh=_mesh(axes),
        sharding=sharding)
    losses = [float(tr.step(*[jnd.array(a, dtype=str(a.dtype))
                              for a in b]).asnumpy()) for b in batches]
    return dict(losses=losses, trace=tr.pipelined_step_trace_count,
                params=jax_params(model))


def _jax_references():
    """Every JAX pipelined trajectory the tests hold the ranks against."""
    ref = {}
    with _Env("MXTPU_GRAD_BUCKET_BYTES", w.BUCKET_BYTES), \
            _Env("MXTPU_FSDP_MIN_SIZE", "0"):
        ref["toy_dp"] = _jax_toy_run({"dp": 2}, "replicated")
        ref["toy_fsdp"] = _jax_toy_run({"dp": 1, "fsdp": 2}, "fsdp")
        ref["accum_replicated"] = _jax_toy_run({"dp": 2}, "replicated",
                                               accum=True)
    with _Env("MXTPU_GRAD_BUCKET_BYTES", w.MODEL_BUCKET_BYTES):
        for axes, sharding in (({"dp": 2}, "replicated"),
                               ({"dp": 1, "fsdp": 2}, "fsdp")):
            m = _jax_gpt()
            ref[f"gpt_{sharding}"] = _jax_model_run(
                m, jg.lm_pipeline(m), w.gpt_batches(False), axes, sharding)
        m = _jax_gpt()
        ref["gptw"] = _jax_model_run(m, jg.lm_pipeline(m, weighted=True),
                                     w.gpt_batches(True), {"dp": 2},
                                     "replicated")
        pre = _jax_bert()
        ref["bert_replicated"] = _jax_model_run(
            pre, jb.pretraining_pipeline(pre), w.bert_batches(), {"dp": 2},
            "replicated")
    return ref


def _inputs(out):
    arrays = {f"toy/{j}": p.data().asnumpy()
              for j, p in enumerate(_jax_toy().collect_params().values())}
    for tag, params in (("gpt", jax_params(_jax_gpt())),
                        ("bert", jax_params(_jax_bert()))):
        arrays.update({f"{tag}/{k}": v for k, v in params.items()})
    np.savez(os.path.join(out, "inputs.npz"), **arrays)


class _Env:
    """A scoped environment variable (the JAX plan reads it at trace
    time)."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        self.old = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(self.name, None)
        else:
            os.environ[self.name] = self.old


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every rank's ``(arrays, scalars)`` and the JAX references (built
    while the ranks run)."""
    out = str(tmp_path_factory.mktemp("pipelined"))
    _inputs(out)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
           "2", "--launcher", "local", "--", sys.executable,
           os.path.join(ROOT, "tests", "test_torch_pipelined_worker.py"),
           out]
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        ref = _jax_references()
        log, _ = proc.communicate(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        pytest.fail(f"the two-rank run passed its {LIMIT_S} s limit:\n"
                    + log[-4000:])
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if proc.returncode != 0:
        pytest.fail(f"a rank failed (exit {proc.returncode}):\n"
                    + log[-6000:])
    ranks = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            scalars = json.load(f)
        ranks.append((dict(np.load(os.path.join(out, f"rank{r}.npz"))),
                      scalars))
    return ranks, ref


def _params(arrays, tag):
    return [v for k, v in sorted(arrays.items())
            if k.startswith(tag + "/")]


def _bitwise(ranks, plain, piped):
    """Every rank's pipelined losses and whole parameters bitwise the
    plain step's, and the same on both ranks."""
    for arrays, s in ranks:
        np.testing.assert_array_equal(s[f"{piped}_losses"],
                                      s[f"{plain}_losses"])
        assert s[f"{piped}_step_count"] == s[f"{plain}_step_count"]
        for a, b in zip(_params(arrays, piped), _params(arrays, plain)):
            np.testing.assert_array_equal(a, b)
    a0, s0 = ranks[0]
    a1, s1 = ranks[1]
    assert s0[f"{piped}_losses"] == s1[f"{piped}_losses"]
    for a, b in zip(_params(a0, piped), _params(a1, piped)):
        np.testing.assert_array_equal(a, b)


def _close_to_jax(ranks, tag, want, positional=False):
    arrays, s = ranks[0]
    np.testing.assert_allclose(s[f"{tag}_losses"], want["losses"],
                               rtol=2e-4)
    assert s[f"{tag}_pipelined_trace"] == want["trace"] == 1
    got = {k[len(tag) + 1:]: v for k, v in arrays.items()
           if k.startswith(tag + "/")}
    if positional:     # the toy net's names differ between the packages
        pairs = zip([got[k] for k in got], want["params"])
    else:
        assert sorted(got) == sorted(want["params"])
        pairs = ((got[k], want["params"][k]) for k in want["params"])
    for g, j in pairs:
        np.testing.assert_allclose(g, j, rtol=5e-4, atol=5e-5)


def test_two_gloo_ranks(run):
    assert [s["world"] for _, s in run[0]] == [2, 2]


@pytest.mark.parametrize("mesh", ["dp", "fsdp"])
@pytest.mark.parametrize("nan_at", [None, "veto"])
def test_toy_bitwise_plain_and_veto(run, mesh, nan_at):
    ranks, ref = run
    at = None if nan_at is None else (2 if mesh == "dp" else 1)
    tag = f"toy_{mesh}_{at}"
    _bitwise(ranks, tag + "_0", tag + "_1")
    s = ranks[0][1]
    assert s[f"{tag}_1_pipelined_trace"] == s[f"{tag}_1_trace"] == 1
    if nan_at is not None:
        assert s[f"{tag}_0_step_count"] == s[f"{tag}_1_step_count"] == 4
    else:
        _close_to_jax(ranks, tag + "_1", ref[f"toy_{mesh}"],
                      positional=True)


def test_ring_collective_bitwise_dp2(run):
    ranks, _ = run
    _bitwise(ranks, "toy_dp_None_0", "toy_ring")
    s = ranks[0][1]
    assert set(s["toy_ring_ops"]) == {"ring"}
    rep = s["toy_ring_structure"]
    assert rep["collective_op"] == "collective_permute"
    assert rep["n_grad_collective_groups"] >= 1


@pytest.mark.parametrize("mesh", ["dp", "fsdp"])
def test_order_matches_plan_and_interleaves(run, mesh):
    """The ledger of the run with a veto (the same program): buckets in
    plan order, a real multi-bucket plan, interleaved with the block
    pullbacks."""
    ranks, _ = run
    at = 2 if mesh == "dp" else 1
    for _, s in ranks:
        tag = f"toy_{mesh}_{at}_1"
        assert len(s[f"{tag}_plan"]) > 1
        assert s[f"{tag}_order"] == s[f"{tag}_plan"]
        rep = s[f"{tag}_structure"]
        assert rep["n_buckets"] == len(s[f"{tag}_plan"])
        assert rep["order_matches_plan"] and rep["interleaved"]
        assert rep["n_backward_segments_between"] >= 1


@pytest.mark.parametrize("sharding", ["replicated", "fsdp"])
def test_accumulation_one_build_and_bitwise(run, sharding):
    ranks, ref = run
    _bitwise(ranks, f"accum_{sharding}_0", f"accum_{sharding}_1")
    s = ranks[0][1]
    assert s[f"accum_{sharding}_1_pipelined_accum_trace"] == 1
    assert s[f"accum_{sharding}_1_accum_trace"] == 1
    rep = s[f"accum_{sharding}_1_structure"]
    assert rep["order_matches_plan"] and rep["interleaved"]
    if sharding == "replicated":
        want = ref["accum_replicated"]
        np.testing.assert_allclose(s["accum_replicated_1_losses"],
                                   want["losses"], rtol=2e-4)
        # the JAX accumulation retraces once more on this tree (ROADMAP,
        # Known hazards: tests/test_train_perf.py's reference failures);
        # the port holds the one-build contract, not that count
        assert want["trace"] == 2


def test_nonfinite_microbatch_vetoes_round(run):
    for _, s in run[0]:
        assert s["veto_outcome"] == "SKIPPED_NONFINITE"
        assert s["veto_frozen"] is True
        assert s["veto_after"] == "APPLIED"
        assert s["veto_accum_trace"] == 1


def test_int8_guard_reads_dequantized_grads(run):
    for _, s in run[0]:
        assert s["toy_int8_step_count"] == 2
        assert set(s["toy_int8_ops"]) == {"int8_psum"}
        rep = s["toy_int8_structure"]
        assert rep["order_matches_plan"] and rep["interleaved"]


@pytest.mark.parametrize("case,match", [("tp", "dp/fsdp"),
                                        ("norm", "norm-based"),
                                        ("mutating", "mutating")])
def test_pipelined_refusals(run, case, match):
    for _, s in run[0]:
        assert s[f"{case}_error"] is not None and \
            match in s[f"{case}_error"], s[f"{case}_error"]


@pytest.mark.parametrize("tag", ["gpt_replicated", "gpt_fsdp", "gptw",
                                 "bert_replicated", "bert_fsdp"])
def test_model_pipelines_bitwise_and_match_jax(run, tag):
    """``lm_pipeline`` (mean, weighted) and ``pretraining_pipeline``:
    bitwise the plain step on the ranks, one capture; against the JAX
    pipelined trainer on the same mesh where it ran."""
    ranks, ref = run
    _bitwise(ranks, f"{tag}_0", f"{tag}_1")
    s = ranks[0][1]
    assert s[f"{tag}_1_pipelined_trace"] == 1
    rep = s[f"{tag}_1_structure"]
    assert rep["order_matches_plan"] and rep["interleaved"]
    if tag in ref:
        _close_to_jax(ranks, f"{tag}_1", ref[tag])


@pytest.mark.parametrize("rm", ["dots", "all"])
def test_remat_plan_bitwise_model_remat(run, rm):
    _bitwise(run[0], f"gpt_remat_{rm}_0", f"gpt_remat_{rm}_1")


def _toy_net():
    with mx.cpu():
        net = nn.Sequential()
        net.add(nn.Dense(16, in_units=8, activation="relu"),
                nn.Dense(4, in_units=16))
        net.initialize()
    return net


def test_pipeline_spec_validation_errors():
    net = _toy_net()
    params = [p._var for p in net.collect_params().values()]
    train_idx = list(range(len(params)))
    # a block listed twice -> overlap error
    spec = PipelineSpec(blocks=[net[0], net[0]], head=lambda x: (x,),
                        finalize=lambda n: n)
    with pytest.raises(MXNetError, match="disjoint"):
        spec.segment_params(params, train_idx)
    # an uncovered trainable -> loud error naming it
    spec = PipelineSpec(blocks=[net[0]], head=lambda x: (x,),
                        finalize=lambda n: n)
    with pytest.raises(MXNetError, match="does not cover"):
        spec.segment_params(params, train_idx)
    # a tie into a pipeline block (not stem<->head) -> rejected
    spec = PipelineSpec(blocks=[net[0], net[1]], head=lambda x: (x,),
                        finalize=lambda n: n, head_modules=[net[1]])
    with pytest.raises(MXNetError, match="stem and head"):
        spec.segment_params(params, train_idx)


def test_option_rules_match_jax():
    """``remat_plan`` / ``int8_allreduce`` need ``pipeline=``, int8
    composes with 'psum' only, a bad collective name: the JAX refusals,
    message for message, at construction."""
    net = _toy_net()
    jnet = _jax_toy()

    def fl(block, x):
        return block(x).mean()

    for kw in (dict(remat_plan=["dots", "dots"]),
               dict(int8_allreduce=True),
               dict(grad_collective="tree"),
               dict(pipeline=object(), int8_allreduce=True,
                    grad_collective="ring")):
        with pytest.raises(MXNetError) as port_err:
            parallel.SPMDTrainer(net, forward_loss=fl, optimizer="adam",
                                 **kw)
        with pytest.raises(Exception) as jax_err:
            jparallel.SPMDTrainer(jnet, forward_loss=fl, optimizer="adam",
                                  mesh=_mesh({"dp": 2}), **kw)
        assert str(port_err.value) == str(jax_err.value)


def test_pipelined_hlo_is_a_departure():
    """The port's step has no lowered program text: ``pipelined_hlo``
    raises naming what reads the issue instead (ROADMAP, departures)."""
    net = _toy_net()
    with mx.cpu():
        tr = parallel.SPMDTrainer(
            net, pipeline=PipelineSpec(blocks=[net[0], net[1]],
                                       head=lambda x, *b: (x.sum(),),
                                       finalize=lambda n: n),
            optimizer="sgd")
        with pytest.raises(MXNetError, match="structure_report"):
            tr.pipelined_hlo()
        with pytest.raises(MXNetError, match="run one step first"):
            tr.pipelined_structure()
        snap = tr.health_snapshot()
    assert snap["pipelined"] is True and snap["grad_collective"] == "psum"
    assert snap["pipelined_step_trace_count"] == 0
    assert snap["int8_allreduce"] is False


def test_structure_report_reads_a_replay_timeline():
    """The card's form of the report on synthetic kernel names: three
    buckets issued after the head's, block 1's and block 0's pullbacks,
    each pullback ending in the step's segment mark, the loss's reduction
    after them. Buckets running between the pullbacks are in order and
    interleaved; all of them after the backward are in order but not
    interleaved; a bucket running before the pullback it waits for is out
    of order. The marks, not the model's kernels, place the pullbacks: a
    block without attention kernels reads the same."""
    from incubator_mxnet_tpu_torch.parallel.pipelined import structure_report
    ledger = [{"key": f"b{j}", "op": "psum", "shapes": [(4,)],
               "issued_shapes": [(4,)], "calls": 1, "segments_done": j + 1}
              for j in range(3)]
    mark = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    fwd = ["gemm_fwd", "mxt::flash_fwd_kernel"] * 2
    head = ["gemm_bwd", mark]
    tail = ["ncclDevKernel_AllReduce_loss"]
    for blk in (["gemm_bwd", "mxt::flash_bwd_dq_kernel",
                 "mxt::flash_bwd_dkv_kernel", mark],
                ["elementwise_bwd", "gemm_bwd", mark]):
        over = fwd + head + ["ncclKernel_b0"] + blk + ["onerank_b1"] + \
            blk + ["onerank_b2"] + tail
        rep = structure_report(ledger, over)
        assert rep["order_matches_plan"] and rep["interleaved"]
        assert rep["n_grad_collective_groups"] == 3
        assert rep["n_backward_segments_between"] == 2
        after = fwd + head + blk + blk + ["onerank_b0", "onerank_b1",
                                          "onerank_b2"] + tail
        rep = structure_report(ledger, after)
        assert rep["order_matches_plan"] and not rep["interleaved"]
        assert rep["n_grad_collective_groups"] == 1
        early = fwd + head + ["onerank_b0", "onerank_b1"] + blk + \
            ["onerank_b2"] + blk + tail
        assert not structure_report(ledger, early)["order_matches_plan"]
        assert not structure_report(ledger, fwd + head + ["onerank_b0"] +
                                    blk)["order_matches_plan"]  # one missing
