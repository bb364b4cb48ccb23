"""The port's WMT Transformer (``models/transformer.py``) against the JAX
package's: the ports of the model cases of ``tests/test_transformer.py``.

One tiny model (units 32, 4 heads, 2 layers, dropout 0) is built in both
packages from the same seed, the JAX weights carried into the port by
structural name; inputs are seeded numpy ids. Held: forward shapes and
logits (f32, within 1e-5 of the largest |logit|), the source padding
mask (scrambled padding changes nothing), the causal decoder (a changed
future leaves earlier logits), ``flash=True`` equal to the dense form
(the flash path: length-form masks into the kernels' plain versions on
the CPU), 3 gluon ``Trainer`` Adam steps on the copy task (losses rtol
2e-4), the 'base' config, the length guards and the positional
encoding (odd width included).
"""

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.models import transformer as jt

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, gluon, nd
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models import transformer as tt

from test_torch_parity import build_pair, copy_params

SRC, TGT = 23, 19
TINY = dict(src_vocab=SRC, tgt_vocab=TGT, units=32, hidden_size=64,
            num_heads=4, num_layers=2, max_length=64, dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU runs here are tiny: on one intra-op thread they do
    not contend with the other test processes for the cores (restored
    after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j(a, dtype="int32"):
    return jnd.array(a, dtype=dtype)


def _t(a, dtype="int32"):
    return nd.array(a, ctx=mx.cpu(), dtype=dtype)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def pair():
    return build_pair(lambda: jt.TransformerModel(**TINY),
                      lambda: tt.TransformerModel(**TINY))


def test_forward_shapes(pair):
    jm, tm = pair
    rng = np.random.RandomState(0)
    src = rng.randint(0, SRC, (2, 7))
    tgt = rng.randint(0, TGT, (2, 5))
    out = tm(_t(src), _t(tgt))
    assert out.shape == (2, 5, TGT)
    _close(out.asnumpy(), jm(_j(src), _j(tgt)).asnumpy())


def test_src_padding_mask_effective(pair):
    """Padding tokens past valid_length do not affect the output."""
    jm, tm = pair
    rng = np.random.RandomState(0)
    src = rng.randint(1, SRC, (1, 8))
    tgt = rng.randint(1, TGT, (1, 4))
    vl = np.array([5], np.int32)
    out1 = tm(_t(src), _t(tgt), _t(vl)).asnumpy()
    src2 = src.copy()
    src2[0, 5:] = 7
    out2 = tm(_t(src2), _t(tgt), _t(vl)).asnumpy()
    np.testing.assert_allclose(out1, out2, rtol=1e-4, atol=1e-5)
    _close(out1, jm(_j(src), _j(tgt), _j(vl)).asnumpy())


def test_causal_decoder(pair):
    """Future target tokens do not influence earlier logits."""
    _, tm = pair
    rng = np.random.RandomState(1)
    src = _t(rng.randint(1, SRC, (1, 6)))
    tgt1 = rng.randint(1, TGT, (1, 5))
    tgt2 = tgt1.copy()
    tgt2[0, 3:] = 11
    o1 = tm(src, _t(tgt1)).asnumpy()
    o2 = tm(src, _t(tgt2)).asnumpy()
    np.testing.assert_allclose(o1[:, :3], o2[:, :3], rtol=1e-4, atol=1e-5)


def test_flash_attention_path_matches_dense(pair):
    jm, dense = pair
    flash = tt.TransformerModel(flash=True, **TINY)
    flash.initialize(ctx=mx.cpu())
    copy_params(jm, flash)
    rng = np.random.RandomState(5)
    src = rng.randint(1, SRC, (2, 6))
    tgt = np.random.RandomState(6).randint(1, TGT, (2, 4))
    for vl in (None, np.array([6, 3], np.int32)):
        args = () if vl is None else (_t(vl),)
        want = dense(_t(src), _t(tgt), *args).asnumpy()
        np.testing.assert_allclose(flash(_t(src), _t(tgt), *args).asnumpy(),
                                   want, rtol=1e-4, atol=1e-5)
        jargs = () if vl is None else (_j(vl),)
        _close(want, jm(_j(src), _j(tgt), *jargs).asnumpy())


def test_training_steps_match_jax():
    """The copy task (teacher forcing) of the JAX slow case: 3 gluon
    Trainer Adam steps in both packages, losses rtol 2e-4."""
    V = 12
    cfg = dict(src_vocab=V, tgt_vocab=V, units=32, hidden_size=64,
               num_heads=4, num_layers=1, max_length=32, dropout=0.0)
    jm, tm = build_pair(lambda: jt.TransformerModel(**cfg),
                        lambda: tt.TransformerModel(**cfg), seed=1)
    rng = np.random.RandomState(0)
    src = rng.randint(2, V, (16, 6)).astype(np.float32)
    tgt_in = np.concatenate([np.ones((16, 1), np.float32), src[:, :-1]], 1)
    losses = []
    for pkg, net, arr, ag, gl in (
            ("jax", jm, _j, jautograd, jgluon),
            ("port", tm, _t, autograd, gluon)):
        loss_fn = gl.loss.SoftmaxCrossEntropyLoss()
        tr = gl.Trainer(net.collect_params(), "adam",
                        {"learning_rate": 5e-3})
        seq = []
        for _ in range(3):
            with ag.record():
                logits = net(arr(src, "float32"), arr(tgt_in, "float32"))
                L = loss_fn(logits.reshape((-1, V)),
                            arr(src.reshape(-1), "float32"))
            L.backward()
            tr.step(16)
            seq.append(float(L.mean().asnumpy()))
        losses.append(seq)
    np.testing.assert_allclose(losses[1], losses[0], rtol=2e-4)
    assert losses[1][-1] < losses[1][0]


def test_transformer_base_config():
    net = tt.transformer_base(src_vocab=100, tgt_vocab=100)
    assert net.units == 512
    big = tt.transformer_big(src_vocab=100, tgt_vocab=100)
    assert big.units == 1024


def test_length_guards(pair):
    _, tm = pair
    with pytest.raises(MXNetError):
        tm(_t(np.ones((1, 70))), _t(np.ones((1, 4))))
    with pytest.raises(MXNetError):
        tt.beam_search_translate(tm, np.ones((1, 4), np.int32),
                                 max_length=64)
    with pytest.raises(MXNetError):
        tt.beam_search_translate_cached(tm, np.ones((1, 4), np.int32),
                                        max_length=64)


@pytest.mark.parametrize("max_len,units", [(10, 33), (64, 32)])
def test_odd_units_positional_encoding(max_len, units):
    pe = tt._positional_encoding(max_len, units)
    assert tuple(pe.shape) == (max_len, units)
    want = np.asarray(jt._positional_encoding(max_len, units))
    np.testing.assert_allclose(pe.numpy(), want, rtol=0, atol=2e-6)


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(MXNetError, match="CUDA"):
        tt.TransformerModel(**TINY).initialize()
