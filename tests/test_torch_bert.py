"""The port's BERT pretraining model against the JAX package's, on the
same weights.

A ``bert_tiny`` ``BERTForPretraining`` is initialized in the JAX package;
its parameters go across by structural name
(``_collect_params_with_prefix``) through
``models.convert.bert_params_from_jax`` into the port's gluon model,
initialized on the CPU; the port runs under ``autograd.record()`` as
MXNet user code does.
With dropout off, in f32: the encoder outputs ``(seq, pooled)`` and the
MLM / NSP scores agree to atol 1e-4, with ``flash=False`` and
``flash=True`` (the JAX package then runs its Pallas kernels in interpret
mode, ``MXTPU_FLASH_INTERPRET=1``; the port the plain versions of its
kernels), at valid lengths below T; ``pretraining_loss`` agrees to rtol
1e-4 and every parameter's gradient to rtol 1e-4 (atol 1e-4 of the
gradient's largest entry, for the entries near zero). The frameworks sum
the products in different orders, hence the tolerances.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd, nd
from incubator_mxnet_tpu.models import bert as jb

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd as tautograd
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models import bert as tb, convert

from test_torch_parity import port_arrays

V, T, M, B = 64, 16, 3, 4


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, V, (B, T)), rng.randint(0, 2, (B, T)),
            np.asarray([16, 9, 1, 5]), rng.randint(0, 5, (B, M)),
            rng.randint(0, V, (B, M)),
            (rng.rand(B, M) > 0.3).astype(np.float32),
            rng.randint(0, 2, (B,)))


def _jax(arrays):
    return [nd.array(a, dtype="float32" if a.dtype == np.float32
                     else "int32") for a in arrays]


def _torch(arrays):
    return port_arrays(arrays)


def _port_pretraining(**kw):
    m = tb.bert_tiny(vocab_size=V, max_length=T, **kw)
    m.initialize(ctx=mx.cpu())
    pre = tb.BERTForPretraining(m)
    pre.initialize(ctx=mx.cpu())
    return pre


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "flash"])
def pair(request):
    flash = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXTPU_FLASH_INTERPRET", "1" if flash else "0")
        jmx.random.seed(0)
        jm = jb.bert_tiny(vocab_size=V, max_length=T, dropout=0.0,
                          flash=flash)
        jm.initialize()
        jp = jb.BERTForPretraining(jm)
        jp.initialize()
        params = {n: p.data().asnumpy()
                  for n, p in jp._collect_params_with_prefix().items()}
        tp = _port_pretraining(dropout=0.0, flash=flash)
        tp.load_state_dict(convert.bert_params_from_jax(tp, params))
        yield jp, tp, params, mp


def test_params_from_jax_round_trip(pair):
    _, tp, params, _ = pair
    names = tp._collect_params_with_prefix()
    assert len(names) == len(params) == 5 + 2 * 12 + 2 + 6 + 1
    assert list(names) == list(params) == list(tp.state_dict())
    assert list(names)[0] == "mlm_bias"
    for name, p in names.items():
        np.testing.assert_array_equal(p.data().asnumpy(), params[name],
                                      err_msg=name)
    # the decoder is tied: no second copy of the word embedding
    assert sum(p.numel() for p in tp.parameters()) == \
        sum(a.size for a in params.values())


def test_params_from_jax_refuses_bad_input(pair):
    _, tp, params, _ = pair
    names = list(params)
    with pytest.raises(MXNetError, match="structural names differ"):
        convert.bert_params_from_jax(
            tp, {n: params[n] for n in names[:-1]})
    qkv = "bert.layer0.attention.qkv.weight"
    bad = dict(params, **{qkv: params[qkv][:-1]})   # one row short
    with pytest.raises(MXNetError, match="qkv.weight"):
        convert.bert_params_from_jax(tp, bad)
    renamed = dict(params)
    renamed["bert.layer0.ln1.scale"] = renamed.pop("bert.layer0.ln1.gamma")
    with pytest.raises(MXNetError, match="structural names differ"):
        convert.bert_params_from_jax(tp, renamed)
    with pytest.raises(MXNetError, match="dict of structural names"):
        convert.bert_params_from_jax(tp, list(params.values()))
    with pytest.raises(MXNetError, match="dtype"):
        convert.bert_params_from_jax(
            tp, {n: a.astype(np.float64) for n, a in params.items()})


def test_forward_matches_jax(pair):
    jp, tp, _, mp = pair
    arrays = _batch()
    jb_, tb_ = _jax(arrays), _torch(arrays)
    jseq, jpool = jp.bert(*jb_[:3])
    jmlm, jnsp = jp(*jb_[:4])
    tseq, tpool = tp.bert(*tb_[:3])
    tmlm, tnsp = tp(*tb_[:4])
    for got, want in ((tseq, jseq), (tpool, jpool), (tmlm, jmlm),
                      (tnsp, jnsp)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                   atol=1e-4, rtol=0)


def test_loss_and_grads_match_jax(pair):
    jp, tp, _, _ = pair
    arrays = _batch(1)
    with autograd.record():
        jl = jb.pretraining_loss(jp, *_jax(arrays))
    jl.backward()
    tp.collect_params().zero_grad()
    with tautograd.record():
        tl = tb.pretraining_loss(tp, *_torch(arrays))
    tl.backward()
    np.testing.assert_allclose(float(tl.asscalar()), float(jl.asnumpy()),
                               rtol=1e-4)
    jgrads = {n: p.grad().asnumpy()
              for n, p in jp._collect_params_with_prefix().items()}
    for name, p in tp._collect_params_with_prefix().items():
        g = jgrads[name]
        np.testing.assert_allclose(
            p.grad().asnumpy(), g, rtol=1e-4,
            atol=1e-4 * float(np.abs(g).max()), err_msg=name)


def test_bf16_parameter_dtypes_and_casts():
    pre = _port_pretraining(dtype="bfloat16", flash=True)
    m = pre.bert
    narrow = {n for n, p in pre.named_parameters()
              if p.dtype == torch.bfloat16}
    want = {f"bert.layer{i}.{mod}.{kind}"
            for i in range(2)
            for mod in ("attention.qkv", "attention.proj", "ffn_in",
                        "ffn_out")
            for kind in ("weight", "bias")}
    assert narrow == want
    assert all(p.dtype == torch.float32 for n, p in pre.named_parameters()
               if n not in want)
    arrays = _torch(_batch())
    seq, pooled = m(*arrays[:3])
    mlm, nsp = pre(*arrays[:4])
    loss = tb.pretraining_loss(pre, *arrays)
    assert seq._data.dtype == torch.bfloat16 and \
        pooled._data.dtype == torch.float32
    assert mlm._data.dtype == torch.bfloat16 and \
        nsp._data.dtype == torch.float32
    assert loss._data.dtype == torch.float32 and \
        np.isfinite(loss.asscalar())


def test_dropout_draws_from_the_model_generator():
    """Dropout draws from ``mx.random``'s generator for the device, in
    training mode only: reseeding repeats the masks, another seed
    changes them, and outside ``train_mode`` nothing is dropped."""
    mx.random.seed(3)
    m = tb.bert_tiny(vocab_size=V, max_length=T, dropout=0.3)
    m.initialize(ctx=mx.cpu())
    arrays = _torch(_batch())[:3]

    def run(seed):
        mx.random.seed(seed)
        with tautograd.train_mode():
            return m(*arrays)[0].asnumpy()
    a, b = run(100), run(100)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, run(101))
    np.testing.assert_array_equal(m(*arrays)[0].asnumpy(),
                                  m(*arrays)[0].asnumpy())


def test_refused_options_and_default_device():
    for remat in (True, "dots"):                  # ported: accepted
        assert tb.bert_tiny(remat=remat)._remat == remat
    with pytest.raises(ValueError, match="remat"):
        tb.bert_tiny(remat="bogus")
    # seq_parallel is ported (tests/test_torch_sp_tp.py runs it over sp
    # ranks): accepted, and outside an SPMD step the plain encoder
    with mx.cpu():
        outs = []
        for sp in (False, True):
            mx.random.seed(2)
            m = tb.bert_tiny(vocab_size=V, max_length=T, seq_parallel=sp,
                             dropout=0.0)
            m.initialize()
            ids = mx.nd.array(np.random.RandomState(0).randint(
                0, V, (2, T)), dtype="int32")
            outs.append(m(ids, None, mx.nd.array([T, 5], dtype="int32"))[0]
                        .asnumpy())
        assert m._seq_parallel
        np.testing.assert_array_equal(outs[0], outs[1])
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            tb.bert_tiny().initialize()


def test_gluon_trainer_lamb_steps_match_jax():
    """bert_tiny, dropout off, 3 LAMB steps of MXNet user code
    (``autograd.record()``, ``backward()``, ``gluon.Trainer.step``) in
    both packages from the same weights: the loss sequences at rtol 2e-4,
    and the applier's build counts equal (two groups would need two
    dtypes: f32 here is one group with its guard inline)."""
    from incubator_mxnet_tpu import gluon as jgluon
    from incubator_mxnet_tpu_torch import gluon as tgluon
    jmx.random.seed(1)
    jm = jb.bert_tiny(vocab_size=V, max_length=T, dropout=0.0)
    jm.initialize()
    jp = jb.BERTForPretraining(jm)
    jp.initialize()
    tp = _port_pretraining(dropout=0.0)
    tp.load_state_dict(convert.bert_params_from_jax(tp, {
        n: p.data().asnumpy()
        for n, p in jp._collect_params_with_prefix().items()}))
    opt = {"learning_rate": 1e-2, "wd": 0.01}
    jt = jgluon.Trainer(jp.collect_params(), "lamb", dict(opt))
    tt = tgluon.Trainer(tp.collect_params(), "lamb", dict(opt))
    arrays = _batch(2)
    jl, tl = [], []
    for _ in range(3):
        with autograd.record():
            L = jb.pretraining_loss(jp, *_jax(arrays))
        L.backward()
        jt.step(1)
        jl.append(float(L.asnumpy()))
        with tautograd.record():
            L = tb.pretraining_loss(tp, *_torch(arrays))
        L.backward()
        tt.step(1)
        tl.append(float(L.asscalar()))
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    assert tl[-1] < tl[0]
    f, g = tt._fused, jt._fused
    assert (f.trace_count, f.guard_trace_count, f.call_count) == \
        (g.trace_count, g.guard_trace_count, g.call_count) == (1, 1, 3)


def test_spmd_trainer_on_the_gluon_bert_builds_once():
    """``SPMDTrainer`` over the gluon BERT: ``NDArray`` batches, an
    ``NDArray`` loss, one step program for one batch signature."""
    from incubator_mxnet_tpu_torch.parallel import SPMDTrainer
    tp = _port_pretraining(dropout=0.0)
    tr = SPMDTrainer(tp, forward_loss=tb.pretraining_loss, optimizer="lamb",
                     optimizer_params={"learning_rate": 1e-2})
    batch = _torch(_batch(3))
    losses = [tr.step(*batch) for _ in range(3)]
    assert all(isinstance(x, mx.NDArray) for x in losses)
    assert float(losses[-1]) < float(losses[0])
    assert tr.step_trace_count == 1 and tr.step_count == 3
    assert tr._programs and \
        next(iter(tr._programs.values())).batch[0].dtype == torch.int32
