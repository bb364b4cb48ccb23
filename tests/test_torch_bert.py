"""The port's BERT pretraining model against the JAX package's, on the
same weights.

A ``bert_tiny`` ``BERTForPretraining`` is initialized in the JAX package;
its ``collect_params()`` go across through
``models.convert.bert_params_from_jax`` into the port's model on the CPU.
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

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models import bert as tb, convert

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
    return [torch.tensor(a) for a in arrays]


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
                  for n, p in jp.collect_params().items()}
        tm = tb.bert_tiny(vocab_size=V, max_length=T, dropout=0.0,
                          flash=flash, device="cpu")
        tp = tb.BERTForPretraining(tm)
        tp.load_state_dict(convert.bert_params_from_jax(tp, params))
        tp.eval()
        yield jp, tp, params, mp


def test_params_from_jax_round_trip(pair):
    _, tp, params, _ = pair
    order = convert.gluon_param_order(tp)
    assert len(order) == len(params) == 5 + 2 * 12 + 2 + 6 + 1
    assert [n for n, _ in order][-1] == "mlm_bias"
    for (name, p), a in zip(order, params.values()):
        np.testing.assert_array_equal(p.detach().numpy(), a, err_msg=name)
    # the decoder is tied: no second copy of the word embedding
    assert sum(p.numel() for p in tp.parameters()) == \
        sum(a.size for a in params.values())


def test_params_from_jax_refuses_bad_input(pair):
    _, tp, params, _ = pair
    arrays = list(params.values())
    with pytest.raises(MXNetError, match="arrays for a model"):
        convert.bert_params_from_jax(tp, arrays[:-1])
    bad = list(arrays)
    bad[5] = bad[5][:-1]                          # qkv weight one row short
    with pytest.raises(MXNetError, match="qkv.weight"):
        convert.bert_params_from_jax(tp, bad)
    names = list(params)
    swapped = dict(zip(names[:3] + [names[4], names[3]] + names[5:],
                       arrays))
    with pytest.raises(MXNetError, match="is not a"):
        convert.bert_params_from_jax(tp, swapped)
    with pytest.raises(MXNetError, match="dtype"):
        convert.bert_params_from_jax(
            tp, [a.astype(np.float64) for a in arrays])


def test_forward_matches_jax(pair):
    jp, tp, _, mp = pair
    arrays = _batch()
    jb_, tb_ = _jax(arrays), _torch(arrays)
    jseq, jpool = jp.bert(*jb_[:3])
    jmlm, jnsp = jp(*jb_[:4])
    with torch.no_grad():
        tseq, tpool = tp.bert(*tb_[:3])
        tmlm, tnsp = tp(*tb_[:4])
    for got, want in ((tseq, jseq), (tpool, jpool), (tmlm, jmlm),
                      (tnsp, jnsp)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want.asnumpy(), atol=1e-4,
                                   rtol=0)


def test_loss_and_grads_match_jax(pair):
    jp, tp, _, _ = pair
    arrays = _batch(1)
    with autograd.record():
        jl = jb.pretraining_loss(jp, *_jax(arrays))
    jl.backward()
    tp.zero_grad()
    tl = tb.pretraining_loss(tp, *_torch(arrays))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl.asnumpy()),
                               rtol=1e-4)
    jgrads = [p.grad().asnumpy() for p in jp.collect_params().values()]
    for (name, p), g in zip(convert.gluon_param_order(tp), jgrads):
        np.testing.assert_allclose(
            p.grad.numpy(), g, rtol=1e-4,
            atol=1e-4 * float(np.abs(g).max()), err_msg=name)


def test_bf16_parameter_dtypes_and_casts():
    m = tb.bert_tiny(vocab_size=V, max_length=T, dtype="bfloat16",
                     flash=True, device="cpu")
    pre = tb.BERTForPretraining(m)
    narrow = {n for n, p in pre.named_parameters()
              if p.dtype == torch.bfloat16}
    want = {f"bert.layers.{i}.{mod}.{kind}"
            for i in range(2)
            for mod in ("attention.qkv", "attention.proj", "ffn_in",
                        "ffn_out")
            for kind in ("weight", "bias")}
    assert narrow == want
    assert all(p.dtype == torch.float32 for n, p in pre.named_parameters()
               if n not in want)
    arrays = _torch(_batch())
    pre.eval()
    with torch.no_grad():
        seq, pooled = m(*arrays[:3])
        mlm, nsp = pre(*arrays[:4])
        loss = tb.pretraining_loss(pre, *arrays)
    assert seq.dtype == torch.bfloat16 and pooled.dtype == torch.float32
    assert mlm.dtype == torch.bfloat16 and nsp.dtype == torch.float32
    assert loss.dtype == torch.float32 and torch.isfinite(loss)


def test_dropout_draws_from_the_model_generator():
    def run(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        m = tb.bert_tiny(vocab_size=V, max_length=T, dropout=0.3,
                         device="cpu", generator=gen)
        gen.manual_seed(100)                  # the dropout stream
        m.train()
        with torch.no_grad():
            return m(*_torch(_batch())[:3])[0]
    a, b = run(3), run(3)
    assert torch.equal(a, b)
    assert not torch.equal(a, run(4))


def test_refused_options_and_default_device():
    with pytest.raises(MXNetError, match="remat"):
        tb.bert_tiny(remat=True, device="cpu")
    with pytest.raises(MXNetError, match="remat"):
        tb.bert_tiny(remat="dots", device="cpu")
    with pytest.raises(MXNetError, match="seq_parallel"):
        tb.bert_tiny(seq_parallel=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            tb.bert_tiny()
