"""The port's optimizer and single-device ``SPMDTrainer`` against the JAX
package's, on the same numpy inputs.

  - ``lamb_update_phase1/2`` against the JAX ops (bias correction with
    ``t`` as a tensor, clipping, weight decay, trust-ratio bounds, the
    zero-norm case): rtol 1e-6 (elementwise f32, one reduction order);
  - SGD / Adam / LAMB ``update_multi_precision`` on a bf16 weight with f32
    masters against the JAX optimizers: masters rtol 1e-6, weights equal
    to within one bf16 rounding;
  - ``SPMDTrainer`` on ``bert_tiny`` f32 with LAMB: an 8-step loss
    sequence against the JAX ``SPMDTrainer(sharding="replicated")`` (its
    8-device CPU mesh: the batch is a multiple of 8) at rtol 2e-4, the
    final parameters at rtol 1e-3 of each tensor's largest entry;
  - the in-step guard: a NaN batch leaves parameters and optimizer state
    bit-identical, records SKIPPED_NONFINITE, halves the loss scale and
    does not move ``step_count``; consecutive NaN steps escalate to
    HALTED_POISONED; the options this slice does not port are refused.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd, parallel as jparallel
from incubator_mxnet_tpu.models import bert as jb
from incubator_mxnet_tpu.ops import optimizer_ops as jops

from incubator_mxnet_tpu_torch import amp, optimizer as topt
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models import bert as tb, convert
from incubator_mxnet_tpu_torch.optimizer import ops as tops
from incubator_mxnet_tpu_torch.optimizer.fused import (all_finite,
                                                       apply_updates,
                                                       norm_based)
from incubator_mxnet_tpu_torch.parallel import SPMDTrainer
from incubator_mxnet_tpu_torch.train import StepOutcome
from incubator_mxnet_tpu_torch.utils import flops


@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("clip,wd,bounds", [
    (-1.0, 0.0, (-1.0, -1.0)), (0.05, 0.01, (-1.0, -1.0)),
    (0.5, 0.0, (3.0, 5.0)), (-1.0, 0.1, (0.5, 1.5))])
def test_lamb_phases_match_jax(bias_correction, clip, wd, bounds):
    rng = np.random.RandomState(0)
    w, g, m, v = (rng.randn(7, 5).astype(np.float32) for _ in range(4))
    v = np.abs(v)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6,
              bias_correction=bias_correction, wd=wd, rescale_grad=0.5,
              clip_gradient=clip)
    ju, jm, jv = jops.lamb_update_phase1(*(jnp.asarray(a) for a in
                                           (w, g, m, v)),
                                         t=jnp.float32(3), **kw)
    tu, tm, tv = tops.lamb_update_phase1(*(torch.from_numpy(a) for a in
                                           (w, g, m, v)),
                                         t=torch.tensor(3.0), **kw)
    for a, b in ((tu, ju), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    lo, hi = bounds
    for weight in (w, np.zeros_like(w)):          # zero norm: ratio 1
        jw = jops.lamb_update_phase2(jnp.asarray(weight), ju, lr=0.01,
                                     lower_bound=lo, upper_bound=hi)
        tw = tops.lamb_update_phase2(torch.from_numpy(weight), tu,
                                     lr=torch.tensor(0.01), lower_bound=lo,
                                     upper_bound=hi)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("name,kw", [
    ("lamb", dict(learning_rate=0.01, wd=0.01, clip_gradient=0.5)),
    ("adam", dict(learning_rate=0.01, wd=0.01)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01))])
def test_multi_precision_updates_match_jax(name, kw):
    rng = np.random.RandomState(1)
    w0 = torch.from_numpy(rng.randn(6, 4).astype(np.float32)).bfloat16()
    jopt = jmx.optimizer.create(name, multi_precision=True, **kw)
    topt_ = topt.create(name, multi_precision=True, **kw)
    jw = nd.array(w0.float().numpy()).astype("bfloat16")
    jstate = jopt.create_state_multi_precision(0, jw)
    tw, tstate = w0.clone(), topt_.create_state_multi_precision(0, w0)
    for step in range(3):
        g = rng.randn(6, 4).astype(np.float32)
        jg = nd.array(g).astype("bfloat16")
        tg = torch.from_numpy(g).bfloat16()
        jopt.update_multi_precision(0, jw, jg, jstate)
        tw, tstate = topt_.update_multi_precision(0, tw, tg, tstate)
        assert tw.dtype == torch.bfloat16
        np.testing.assert_allclose(tstate[0].numpy(),
                                   jstate[0].asnumpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=f"master, step {step}")
        np.testing.assert_allclose(tw.float().numpy(),
                                   jw.astype("float32").asnumpy(),
                                   rtol=2 ** -7, atol=0)


def test_apply_updates_keeps_dtypes_and_all_finite():
    opt = topt.create("lamb", learning_rate=0.1, multi_precision=True)
    w = [torch.randn(3, 3).bfloat16(), torch.randn(4)]
    g = [torch.randn(3, 3).bfloat16(), torch.randn(4)]
    st = [opt.create_state_multi_precision(i, x) for i, x in enumerate(w)]
    nw, ns = apply_updates(opt, [0, 1], w, g, st, torch.tensor(1.0),
                           torch.tensor(0.1),
                           rescale_grad=torch.tensor(0.5))
    assert [x.dtype for x in nw] == [torch.bfloat16, torch.float32]
    assert ns[0][0].dtype == torch.float32 and ns[1][0].dtype == \
        torch.float32
    assert opt.rescale_grad == 1.0 and opt._traced_t is None
    assert norm_based(opt) and not norm_based(topt.create("sgd"))
    assert float(all_finite(g)) == 1.0
    g[1][2] = float("inf")
    assert float(all_finite(g)) == 0.0


def test_lamb_update_many_equals_per_parameter_updates():
    """The multi-tensor pass over several parameters (each with its own
    lr multiplier, wd multiplier and step count) equals one update per
    parameter."""
    rng = np.random.RandomState(4)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    kw = dict(learning_rate=0.05, wd=0.01, clip_gradient=0.3,
              lower_bound=0.1, upper_bound=3.0)
    many, one = topt.create("lamb", **kw), topt.create("lamb", **kw)
    for opt in (many, one):
        opt.set_lr_mult({1: 0.5})
        opt.set_wd_mult({2: 0.0})
        opt._index_update_count = {0: 2, 1: 0, 2: 5}
    w = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in shapes]
    g = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in shapes]
    st = [(torch.from_numpy(rng.randn(*s).astype(np.float32)),
           torch.from_numpy(rng.rand(*s).astype(np.float32)))
          for s in shapes]
    got_w, got_s = many.update_many([0, 1, 2], w, g, st)
    for i in range(3):
        want_w, want_s = one.update(i, w[i], g[i], st[i])
        assert torch.equal(got_w[i], want_w)
        assert all(torch.equal(a, b) for a, b in zip(got_s[i], want_s))


B, T, M, V = 8, 16, 4, 64


def _batch(rng):
    return (rng.randint(0, V, (B, T)), rng.randint(0, 2, (B, T)),
            rng.randint(8, T + 1, (B,)), rng.randint(0, 8, (B, M)),
            rng.randint(0, V, (B, M)), np.ones((B, M), np.float32),
            rng.randint(0, 2, (B,)))


def _port_model(params=None, dropout=0.0):
    tm = tb.bert_tiny(vocab_size=V, max_length=T, dropout=dropout,
                      device="cpu")
    tp = tb.BERTForPretraining(tm)
    if params is not None:
        tp.load_state_dict(convert.bert_params_from_jax(tp, params))
    return tp


def test_spmd_lamb_loss_sequence_matches_jax():
    jmx.random.seed(0)
    jm = jb.bert_tiny(vocab_size=V, max_length=T, dropout=0.0)
    jm.initialize()
    jp = jb.BERTForPretraining(jm)
    jp.initialize()
    params = {n: p.data().asnumpy() for n, p in jp.collect_params().items()}
    tp = _port_model(params)
    arrays = _batch(np.random.RandomState(0))
    jbatch = [nd.array(a, dtype="float32" if a.dtype == np.float32
                       else "int32") for a in arrays]
    tbatch = [torch.tensor(a) for a in arrays]
    opt_params = {"learning_rate": 1e-2, "wd": 0.01}
    jt = jparallel.SPMDTrainer(jp, forward_loss=jb.pretraining_loss,
                               optimizer="lamb",
                               optimizer_params=opt_params,
                               sharding="replicated")
    tt = SPMDTrainer(tp, forward_loss=tb.pretraining_loss,
                     optimizer="lamb", optimizer_params=opt_params,
                     sharding="replicated")
    jl = [float(jt.step(*jbatch).asnumpy()) for _ in range(8)]
    tl = [float(tt.step(*tbatch)) for _ in range(8)]
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    assert tl[-1] < tl[0] and tt.step_count == 8
    assert tt.health[StepOutcome.APPLIED.value] == 8
    final = {n: p.data().asnumpy() for n, p in jp.collect_params().items()}
    want = convert.bert_params_from_jax(tp, final)
    for name, p in tp.state_dict().items():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.numpy(), ref, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(ref).max()),
                                   err_msg=name)


def _snapshot(tr):
    params = [p.detach().clone() for p in tr.block.parameters()]
    state = [[x.clone() for x in s] for s in tr._opt_state]
    return params, state


def test_nonfinite_batch_is_skipped_bit_identically():
    torch.manual_seed(0)
    tp = _port_model()
    scaler = amp.LossScaler(init_scale=2.0 ** 10)
    tr = SPMDTrainer(tp, forward_loss=tb.pretraining_loss,
                     optimizer="lamb",
                     optimizer_params={"learning_rate": 1e-3,
                                       "multi_precision": True},
                     loss_scaler=scaler)
    rng = np.random.RandomState(2)
    clean = [torch.tensor(a) for a in _batch(rng)]
    assert torch.isfinite(tr.step(*clean))
    assert tr.step_count == 1 and scaler.loss_scale == 2.0 ** 10
    before = _snapshot(tr)
    poisoned = list(clean)
    poisoned[5] = clean[5].clone()
    poisoned[5][0, 0] = float("nan")                 # NaN loss and grads
    tr.step(*poisoned)
    after = _snapshot(tr)
    for a, b in zip(before[0] + sum(before[1], []),
                    after[0] + sum(after[1], [])):
        assert torch.equal(a, b)
    assert tr.last_outcome is StepOutcome.SKIPPED_NONFINITE
    assert tr.step_count == 1 and scaler.loss_scale == 2.0 ** 9
    snap = tr.health_snapshot()
    assert snap["health"]["SKIPPED_NONFINITE"] == 1
    assert snap["loss_scale"] == 2.0 ** 9 and snap["guard"] is True
    assert torch.isfinite(tr.step(*clean))
    assert tr.step_count == 2 and tr.last_outcome is StepOutcome.APPLIED


def test_consecutive_nonfinite_steps_halt():
    tp = _port_model()
    tr = SPMDTrainer(tp, forward_loss=tb.pretraining_loss, optimizer="sgd",
                     optimizer_params={"learning_rate": 0.1},
                     max_consecutive_nonfinite=3)
    batch = [torch.tensor(a) for a in _batch(np.random.RandomState(3))]
    batch[5] = torch.full((B, M), float("nan"))
    tr.step(*batch)
    tr.step(*batch)
    with pytest.raises(MXNetError, match="3 consecutive non-finite"):
        tr.step(*batch)
    assert tr.last_outcome is StepOutcome.HALTED_POISONED
    assert tr.step_count == 0


def test_refused_options():
    tp = _port_model()
    kw = dict(forward_loss=tb.pretraining_loss, optimizer="lamb")
    for bad, match in ((dict(mesh=["cuda:0", "cuda:1"]), "mesh of 2"),
                       (dict(sharding="fsdp"), "fsdp"),
                       (dict(pipeline=object()), "pipeline"),
                       (dict(int8_allreduce=True), "int8_allreduce"),
                       (dict(remat_plan=[True]), "remat_plan"),
                       (dict(grad_collective="ring"), "ring")):
        with pytest.raises(MXNetError, match=match):
            SPMDTrainer(tp, **kw, **bad)
    with pytest.raises(MXNetError, match="loss"):
        SPMDTrainer(tp, optimizer="lamb")
    tr = SPMDTrainer(tp, **kw, mesh=["cpu"])
    for call in (lambda: tr.step_microbatches([]),
                 lambda: tr.save_checkpoint(None),
                 lambda: tr.restore_checkpoint(None)):
        with pytest.raises(MXNetError, match="not ported"):
            call()
    with pytest.raises(MXNetError, match="unknown optimizer"):
        topt.create("nope")


def test_flops_and_peak_table():
    # bench.py's count for bert_base at the bench shapes, by hand
    B_, T_, M_, L, U, Hd, Vb = 32, 512, 76, 12, 768, 3072, 30522
    want = 6.0 * B_ * T_ * L * (4 * U * U + 2 * U * Hd) + \
        12.0 * L * B_ * T_ * T_ * U + \
        6.0 * B_ * M_ * U * (Vb + U) + 6.0 * B_ * (U * U + 2 * U)
    assert flops.bert_train_flops(B_, T_, M_, L, U, Hd, Vb) == want
    assert flops.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    with pytest.raises(MXNetError, match="no peak known"):
        flops.peak_flops("TPU v5 lite")
    assert flops.transformer_train_flops(10, 2, 4, 8, 3) == \
        3 * (60 + 12 * 2 * 8 * 4)
