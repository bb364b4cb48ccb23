"""Training resume through the checkpoint capsule: the port's
``gluon.Trainer`` and ``SPMDTrainer`` against the JAX package's, on the
CPU.

  - ``gluon.Trainer`` on a small Dense net (Adam under a stepped
    ``FactorScheduler``, an f32 and a bf16 layer) saves at step 4; a
    fresh trainer from another seed restores and continues with losses
    equal to the uninterrupted run's BITWISE;
  - a JAX Trainer's capsule restores into the port's Trainer, and the
    port's into the JAX Trainer: the continuations agree at rtol 1e-5
    (f32);
  - ``save_states`` files cross both ways, and the port's older pickle
    ``.states`` still loads;
  - after a restore and the next steps the fused applier's counts
    (``trace_count``, ``guard_trace_count``, ``accum_trace_count``,
    ``call_count``) equal the JAX applier's (one group under a scaler
    with accumulation; two dtype groups);
  - ``SPMDTrainer`` on ``gpt_mini`` f32, dropout 0: a restore into the
    trainer whose step program exists (``step_trace_count`` unchanged)
    and into a fresh one from another seed continue bitwise, the
    restored state bitwise the saved one; a JAX trainer's capsule
    continues in the port at rtol 2e-4;
  - dropout 0.1, port only: ``mx.random.get_state`` / ``set_state``
    repeat the masks, and the capsule's RNG entries make a resumed run's
    losses bitwise (without them the losses differ);
  - the capsule cases of ``tests/test_train_resilience.py``: the loss
    scaler and the step health ride the capsule, and an explicit save
    step survives guard skips.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import checkpoint as jckpt
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.models import gpt as jg
from incubator_mxnet_tpu.optimizer import lr_scheduler as jsched

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, nd
from incubator_mxnet_tpu_torch import checkpoint as ckpt
from incubator_mxnet_tpu_torch.amp import LossScaler
from incubator_mxnet_tpu_torch.gluon import nn
from incubator_mxnet_tpu_torch.models import gpt as tg
from incubator_mxnet_tpu_torch.optimizer import lr_scheduler as tsched
from incubator_mxnet_tpu_torch.optimizer.fused import tree_leaves
from incubator_mxnet_tpu_torch.parallel import SPMDTrainer
from incubator_mxnet_tpu_torch.train import NaNGrad, run_train_chaos

from test_torch_checkpoint import PositionIter, make_trainer, train_steps
from test_torch_gluon_trainer import JAX, PORT, _counts, _net, _pair, _run
from test_torch_parity import cpu_gpt, fresh_names

V = 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(tr):
    """Every parameter and optimizer-state tensor of a gluon Trainer."""
    return [p.data()._data.clone() for p in tr._params] + [
        x.clone() for i in sorted(tr._updaters[0].states)
        for x in tree_leaves(tr._updaters[0].states[i])]


# ------------------------------------------------------------------ #
# gluon.Trainer
# ------------------------------------------------------------------ #

def test_trainer_resume_bit_exact_multi_dtype_scheduler(tmp_path):
    net, tr = make_trainer(0)
    ref = train_steps(net, tr, PositionIter(), 8)
    assert len(tr._fused._programs) == 2, "needs two dtype groups"

    net2, tr2 = make_trainer(0)
    it2 = PositionIter()
    train_steps(net2, tr2, it2, 4)
    m = ckpt.CheckpointManager(str(tmp_path), keep=3)
    saved = tr2.save_checkpoint(m, iterator=it2)
    m.wait()
    assert m.all_steps() == [saved]

    net3, tr3 = make_trainer(99)          # any missed restore diverges
    it3 = PositionIter()
    assert tr3.restore_checkpoint(m, iterator=it3) == saved
    assert it3.pos == 4
    assert all(torch.equal(a, b) for a, b in zip(_state(tr2), _state(tr3)))
    assert train_steps(net3, tr3, it3, 4) == ref[4:]
    assert tr3.optimizer.num_update == tr.optimizer.num_update
    assert tr3.learning_rate == tr.learning_rate
    m.close()


def _adam(P, net):
    sched = (jsched if P is JAX else tsched).FactorScheduler(step=2,
                                                             factor=0.5)
    return P.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.01, "lr_scheduler": sched},
                           kvstore=None)


def _manager(P, path):
    return (jckpt if P is JAX else ckpt).CheckpointManager(str(path))


@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_trainer_capsule_crosses_the_packages(tmp_path, src, dst):
    """3 steps in ``src``, a capsule, 3 more there; ``dst`` from other
    weights restores the capsule and takes the same 3 steps."""
    nets = dict(zip((JAX, PORT), _pair()))
    net = nets[src]
    tr = _adam(src, net)
    _run(src, net, tr, 3, seed=1)
    m = _manager(src, tmp_path)
    tr.save_checkpoint(m, block=True)
    want, _, _ = _run(src, net, tr, 3, seed=7)
    other = _net(dst, seed=5)
    tr2 = _adam(dst, other)
    assert tr2.restore_checkpoint(_manager(dst, tmp_path)) == 3
    got, _, _ = _run(dst, other, tr2, 3, seed=7)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tr2.optimizer.num_update == tr.optimizer.num_update == 6


def test_save_states_files_cross_both_ways_and_the_pickle_loads(tmp_path):
    jnet, tnet = _pair()
    jtr, ttr = _adam(JAX, jnet), _adam(PORT, tnet)
    _run(JAX, jnet, jtr, 2)
    _run(PORT, tnet, ttr, 2)

    def leaves(P, tr):
        st = tr._updaters[0].states
        if P is JAX:
            import jax.tree_util as jtu
            return [np.asarray(x.asnumpy(), np.float64)
                    for i in sorted(st) for x in jtu.tree_leaves(
                        st[i], is_leaf=lambda v: hasattr(v, "asnumpy"))]
        return [x.double().numpy() for i in sorted(st)
                for x in tree_leaves(st[i])]

    for src, src_tr, dst in ((JAX, jtr, PORT), (PORT, ttr, JAX)):
        fname = str(tmp_path / f"{src is JAX}.states")
        src_tr.save_states(fname)
        with open(fname, "rb") as f:
            assert f.read(8) == ckpt.CAPSULE_MAGIC
        fresh = _adam(dst, _net(dst, seed=3))
        fresh.load_states(fname)
        assert fresh.optimizer.num_update == 2
        for a, b in zip(leaves(dst, fresh), leaves(src, src_tr)):
            np.testing.assert_array_equal(a, b)
    legacy = str(tmp_path / "legacy.states")
    with open(legacy, "wb") as f:
        f.write(ttr._updaters[0].get_states())
    fresh = _adam(PORT, _net(PORT, seed=3))
    fresh.load_states(legacy)
    assert fresh.optimizer.num_update == 2
    for a, b in zip(leaves(PORT, fresh), leaves(PORT, ttr)):
        np.testing.assert_array_equal(a, b)


def _one_group(P, path):
    net = _net(P)
    tr = P.gluon.Trainer(net.collect_params(), "adam",
                         {"learning_rate": 0.01},
                         loss_scaler=P.LossScaler(init_scale=8.0,
                                                  scale_window=2))
    _run(P, net, tr, 3, scaled=True)
    m = _manager(P, path)
    tr.save_checkpoint(m, block=True)
    before = _counts(tr)
    tr.restore_checkpoint(m)
    restored = _counts(tr)
    _run(P, net, tr, 2, accum=2, scaled=True)
    return before, restored, _counts(tr)


def _two_groups(P, path):
    rng = np.random.RandomState(5)
    params = []
    with P.ctx():
        for i, dt in enumerate(["float32", "float32", "float16",
                                "float16"]):
            p = P.gluon.Parameter(f"p{i}", shape=(6, 6), dtype=dt)
            p.initialize()
            p.set_data(P.nd.array(rng.randn(6, 6).astype(np.float32))
                       .astype(dt))
            params.append(p)
        tr = P.gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                             "momentum": 0.9},
                             kvstore=None)
        grng = np.random.RandomState(6)
        counts = []
        for step in range(5):
            if step == 3:
                m = _manager(P, path)
                tr.save_checkpoint(m, block=True)
                counts.append(_counts(tr))
                tr.restore_checkpoint(m)
                counts.append(_counts(tr))
            for p in params:
                g = p.grad()
                new = P.nd.array(grng.randn(6, 6).astype(np.float32)) \
                    .astype(p.dtype)
                if P is JAX:
                    g._data = new._data
                else:
                    g._data.copy_(new._data)
                g._fresh = True
            tr.step(1)
    return tuple(counts) + (_counts(tr),)


@pytest.mark.parametrize("scenario", [_one_group, _two_groups],
                         ids=["one_group_accum", "two_groups"])
def test_applier_counts_after_restore_equal_jax(tmp_path, scenario):
    j = scenario(JAX, tmp_path / "jax")
    t = scenario(PORT, tmp_path / "port")
    assert t == j
    assert t[1] == (0, 0, 0, 0)            # a fresh applier


def _build_net(seed):
    mx.random.seed(seed)
    net = nn.Sequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"),
            nn.Dense(4, in_units=16))
    with mx.cpu():
        net.initialize()
    return net


def _data(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(8, 8).astype(np.float32),
            rng.randn(8, 4).astype(np.float32))


def _mse(out, label):
    return (out - label) ** 2


def _trainer(net, scaler=None):
    return mx.gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.01}, kvstore=None,
                            loss_scaler=scaler)


def test_scaler_and_health_ride_the_capsule(tmp_path):
    net = _build_net(9)
    tr = _trainer(net, LossScaler(init_scale=32.0, scale_window=4))
    X, y = _data(10)
    with mx.cpu():
        run_train_chaos(net, tr, _mse, (X, y), 3, [NaNGrad(at_step=1)])
    assert tr._amp_loss_scaler.loss_scale == 16.0
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), keep=2)
    tr.save_checkpoint(mgr, block=True)
    mgr.wait()
    net2 = _build_net(9)
    tr2 = _trainer(net2, LossScaler(init_scale=2.0, scale_window=4))
    tr2.restore_checkpoint(mgr)
    assert tr2._amp_loss_scaler.loss_scale == 16.0
    assert tr2._amp_loss_scaler._unskipped == \
        tr._amp_loss_scaler._unskipped
    assert tr2.health == tr.health
    assert tr2._recorder.consecutive_nonfinite == \
        tr._recorder.consecutive_nonfinite
    with mx.cpu():
        l_a, _ = run_train_chaos(net, tr, _mse, (X, y), 2)
        l_b, _ = run_train_chaos(net2, tr2, _mse, (X, y), 2)
    assert l_a == l_b
    tr3 = _trainer(_build_net(9))
    with pytest.warns(RuntimeWarning, match="DROPPED"):
        tr3.restore_checkpoint(mgr)
    assert tr3._amp_loss_scaler is None
    mgr.close()


def test_explicit_save_step_survives_guard_skips(tmp_path):
    net = _build_net(21)
    tr = _trainer(net, LossScaler(init_scale=8.0, scale_window=50))
    X, y = _data(22)
    with mx.cpu():
        run_train_chaos(net, tr, _mse, (X, y), 4, [NaNGrad(at_step=1)])
    assert tr.optimizer.num_update == 3
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), keep=2)
    tr.save_checkpoint(mgr, step=4, block=True)
    tr2 = _trainer(_build_net(21))
    assert tr2.restore_checkpoint(mgr) == 4   # the caller's loop index
    assert tr2.optimizer.num_update == 3
    mgr.close()


# ------------------------------------------------------------------ #
# SPMDTrainer on gpt_mini
# ------------------------------------------------------------------ #

_OPT = {"learning_rate": 3e-3, "wd": 0.01}
_X_IDS = np.random.RandomState(4).randint(0, V, (8, 13))


def _ids(a):
    return nd.array(a, ctx=mx.cpu(), dtype="int32")


_BATCH = (_ids(_X_IDS[:, :-1]), _ids(_X_IDS[:, 1:]))


def _spmd(seed, dropout=0.0):
    mx.random.seed(seed)
    fresh_names()
    model = cpu_gpt(vocab_size=V, max_length=16, dropout=dropout)
    return SPMDTrainer(model, forward_loss=tg.lm_loss, optimizer="adamw",
                       optimizer_params=_OPT)


def _steps(tr, n):
    return [float(tr.step(*_BATCH).asnumpy()) for _ in range(n)]


def _spmd_state(tr):
    return [p.detach().clone() for p in tr._params] + \
        [x.clone() for x in tree_leaves(tr._opt_state)]


def test_spmd_resume_bit_exact_and_no_new_program(tmp_path):
    ref = _steps(_spmd(0), 6)
    tr = _spmd(0)
    _steps(tr, 3)
    m = ckpt.CheckpointManager(str(tmp_path), keep=2)
    assert tr.save_checkpoint(m) == 3
    saved = _spmd_state(tr)
    counters = (tr._optimizer.num_update,
                dict(tr._optimizer._index_update_count))
    _steps(tr, 2)                        # writes the state in place
    m.wait()
    where = [t.data_ptr() for t in tr._params + tree_leaves(tr._opt_state)]
    assert tr.restore_checkpoint(m) == 3
    assert tr.step_trace_count == 1 and tr.step_count == 3
    assert [t.data_ptr() for t in
            tr._params + tree_leaves(tr._opt_state)] == where
    assert all(torch.equal(a, b) for a, b in zip(saved, _spmd_state(tr)))
    assert _steps(tr, 3) == ref[3:]
    assert tr.step_trace_count == 1

    fresh = _spmd(11)                    # another seed, no step taken
    fresh.restore_checkpoint(m, step=3)
    assert all(torch.equal(a, b) for a, b in
               zip(saved, _spmd_state(fresh)))
    assert (fresh._optimizer.num_update,
            fresh._optimizer._index_update_count) == counters
    assert _steps(fresh, 3) == ref[3:]
    assert fresh.step_trace_count == 1
    m.close()


def test_spmd_restore_refuses_other_shapes_before_any_write(tmp_path):
    tr = _spmd(0)
    _steps(tr, 1)
    m = ckpt.CheckpointManager(str(tmp_path))
    tr.save_checkpoint(m, block=True)
    arrays, meta = m.restore()
    other = _spmd(3)
    _steps(other, 1)
    before = _spmd_state(other)
    last = f"opt/{len(other._opt_state) - 1}/1"
    arrays[last] = arrays[last][:1]
    with pytest.raises(mx.MXNetError, match="shape"):
        ckpt.restore_spmd(other, arrays, meta)
    arrays, meta = m.restore()
    arrays["param/0"] = arrays["param/0"].astype(np.float16)
    with pytest.raises(mx.MXNetError, match="silent cast"):
        ckpt.restore_spmd(other, arrays, meta)
    assert all(torch.equal(a, b) for a, b in zip(before, _spmd_state(other)))
    with pytest.raises(mx.MXNetError, match="not an SPMDTrainer"):
        ckpt.restore_spmd(other, arrays, dict(meta, kind="trainer"))
    m.close()


def test_jax_spmd_capsule_continues_in_the_port(tmp_path):
    jmx.random.seed(5)
    fresh_names()
    jm = jg.gpt_mini(vocab_size=V, max_length=16)
    jm.initialize()
    jt = jparallel.SPMDTrainer(jm, forward_loss=jg.lm_loss,
                               optimizer="adamw", optimizer_params=_OPT,
                               sharding="replicated")
    jb = (jnd.array(_X_IDS[:, :-1], dtype="int32"),
          jnd.array(_X_IDS[:, 1:], dtype="int32"))
    for _ in range(3):
        jt.step(*jb)
    jm_mgr = jckpt.CheckpointManager(str(tmp_path))
    jt.save_checkpoint(jm_mgr, block=True)
    want = [float(jt.step(*jb).asnumpy()) for _ in range(3)]
    tr = _spmd(11)
    assert tr.restore_checkpoint(ckpt.CheckpointManager(str(tmp_path))) == 3
    got = _steps(tr, 3)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert tr.step_count == 6 and tr.step_trace_count == 1


def test_random_state_reproduces_dropout_masks(tmp_path):
    tr = _spmd(0, dropout=0.1)
    x = _BATCH[0]
    with mx.cpu(), autograd.record(train_mode=True):
        state = mx.random.get_state()
        a = tr.block(x)._data.detach().clone()
        b = tr.block(x)._data.detach().clone()
        mx.random.set_state(state)
        c = tr.block(x)._data.detach().clone()
    assert not torch.equal(a, b) and torch.equal(a, c)
    rng_state = mx.random.get_state()
    draws = mx.random.np_rng().randint(0, 1 << 30, 4)
    mx.random.set_state(rng_state)
    np.testing.assert_array_equal(mx.random.np_rng().randint(0, 1 << 30, 4),
                                  draws)

    _steps(tr, 3)
    m = ckpt.CheckpointManager(str(tmp_path))
    tr.save_checkpoint(m, block=True)
    ref = _steps(tr, 3)
    arrays, meta = m.restore()
    assert any(k.startswith("rng/torch/") for k in arrays)
    fresh = _spmd(11, dropout=0.1)
    fresh.restore_checkpoint(m)
    assert _steps(fresh, 3) == ref
    without = _spmd(11, dropout=0.1)
    ckpt.restore_spmd(without, {k: v for k, v in arrays.items()
                                if not k.startswith("rng/")}, meta)
    assert _steps(without, 3) != ref
