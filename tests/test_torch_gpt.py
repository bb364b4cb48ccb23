"""The port's GPT model against the JAX package's, on the same weights.

One ``gpt_mini`` is initialized in the JAX package from a seed; its
parameters go across by structural name
(``models.convert.block_params_from_jax``) into the port's gluon
``GPTModel``, initialized on the CPU. Logits must agree to atol 1e-4 in f32
(the two frameworks sum matmuls in different orders), and greedy token
streams of ``cached_generate`` must be equal."""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models import gpt as jg

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models import convert, gpt as tg

from test_torch_parity import cpu_gpt, jax_params, port_gpt


@pytest.fixture(scope="module")
def models():
    jmx.random.seed(0)
    jm = jg.gpt_mini(vocab_size=64, max_length=64)
    jm.initialize()
    arrays = [p.data().asnumpy() for p in jm.collect_params().values()]
    tm = port_gpt(jm, vocab_size=64, max_length=64)
    return jm, tm, arrays


def _ids(ids):
    return tnd.array(ids, ctx=mx.cpu(), dtype="int32")


def test_params_from_jax_round_trip(models):
    _, tm, arrays = models
    sd = tm.state_dict()
    assert list(sd) == convert.gpt_param_names(2)
    assert len(arrays) == 2 + 12 * 2 + 2
    for a, (name, t) in zip(arrays, sd.items()):
        np.testing.assert_array_equal(t.numpy(), a, err_msg=name)


def test_params_from_jax_refuses_bad_input(models):
    """GPT's weights cross by structural name: a missing name or a short
    tensor is refused."""
    jm, tm, _ = models
    params = jax_params(jm)
    del params["ln_f.beta"]
    with pytest.raises(MXNetError, match="ln_f.beta"):
        convert.block_params_from_jax(tm, params)
    params = jax_params(jm)
    params["block0.attn.qkv.weight"] = \
        params["block0.attn.qkv.weight"][:-1]     # one row short
    with pytest.raises(MXNetError, match="attn.qkv.weight"):
        convert.block_params_from_jax(tm, params)


def test_logits_match_jax(models):
    jm, tm, _ = models
    ids = np.random.RandomState(1).randint(0, 64, size=(2, 13))
    want = jm(nd.array(ids, dtype="int32")).asnumpy()
    got = tm(_ids(ids)).asnumpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_decode_forward_matches_jax(models):
    jm, tm, _ = models
    ids = np.random.RandomState(2).randint(0, 64, size=(1, 9))
    from incubator_mxnet_tpu import autograd
    jc = jg.init_kv_cache(jm, 1, max_len=16)
    tc = tg.init_kv_cache(tm, 1, max_len=16)
    with autograd.predict_mode():
        jl, jc = jg.decode_forward(jm, nd.array(ids, dtype="int32")._data,
                                   jc, 0, last_only=True)
        nxt = np.asarray([[5]], np.int32)
        jl2, _ = jg.decode_forward(jm, nd.array(nxt, dtype="int32")._data,
                                   jc, 9)
    tl, tc = tg.decode_forward(tm, torch.tensor(ids), tc, 0,
                               last_only=True)
    tl2, _ = tg.decode_forward(tm, torch.tensor(nxt), tc, 9)
    np.testing.assert_allclose(tl.numpy(), jl.asnumpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tl2.numpy(), jl2.asnumpy(), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("seed,T0", [(3, 7), (4, 20)])
def test_cached_generate_greedy_matches_jax(models, seed, T0):
    jm, tm, _ = models
    prompt = np.random.RandomState(seed).randint(0, 64, size=(1, T0))
    want = jg.cached_generate(jm, nd.array(prompt, dtype="int32"),
                              max_new_tokens=12).asnumpy()
    got = tg.cached_generate(tm, torch.tensor(prompt), max_new_tokens=12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cached_generate_temperature_is_seeded(models):
    _, tm, _ = models
    prompt = torch.tensor(np.random.RandomState(5).randint(0, 64,
                                                           size=(1, 6)))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tg.cached_generate(tm, prompt, max_new_tokens=10,
                                  temperature=1.0, generator=g)

    np.testing.assert_array_equal(run(1).numpy(), run(1).numpy())
    assert not np.array_equal(run(1).numpy(), run(2).numpy())


def test_bf16_model_keeps_f32_norms_and_head(models):
    _, tm, _ = models
    bm = cpu_gpt(vocab_size=64, max_length=64, dtype="bfloat16")
    bm.load_state_dict(tm.state_dict())
    assert bm.blocks[0].attn.qkv.weight._var.dtype == torch.bfloat16
    assert bm.blocks[0].ln1.gamma._var.dtype == torch.float32
    assert bm.word_embed.weight._var.dtype == torch.float32
    ids = torch.tensor(np.random.RandomState(6).randint(0, 64,
                                                        size=(1, 8)))
    caches = tg.init_kv_cache(bm, 1, max_len=8)
    assert caches[0][0].dtype == torch.bfloat16
    logits, _ = tg.decode_forward(bm, ids, caches, 0)
    assert logits.dtype == torch.float32          # the f32 head
    np.testing.assert_allclose(logits.numpy(),
                               tm(_ids(ids.numpy())).asnumpy(), atol=0.1)


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(MXNetError, match="CUDA"):
        tg.gpt_small().initialize()
    with pytest.raises(MXNetError, match="CUDA"):
        tg.GPTModel(vocab_size=8, units=8, hidden_size=8, num_layers=1,
                    num_heads=2, max_length=8).initialize()
