"""The port's gluon GPT against the JAX package's: structure, forward,
``lm_loss``, ``SPMDTrainer`` causal-LM training and the decoders.

One ``gpt_mini`` (f32, dropout 0) is built in each package from the same
seed and the JAX model's weights are carried across by structural name
(``convert.block_params_from_jax``); inputs are seeded numpy ids. Held:

  - structural names (``block{i}.attn.qkv.weight`` ...) and the
    ``collect_params()`` keys equal the JAX model's;
  - logits, ``flash=False`` and ``flash=True`` (the packed path: the
    flash kernels' plain versions on the CPU), within 1e-5 of the
    largest |logit|; ``lm_loss`` with and without ``weights``, rtol
    1e-5;
  - 3 ``SPMDTrainer`` AdamW steps against the JAX trainer (its 8-device
    CPU mesh, batch 8): losses rtol 2e-4, final parameters within 1e-3
    of each tensor's largest entry, ``step_trace_count`` equal;
  - ``greedy_generate`` greedy tokens equal the JAX package's bitwise;
    the temperature draw is held by distribution and seed (the port
    draws from ``mx.random``'s generator, not a threefry key);
  - the ports of the JAX ``tests/test_models.py`` GPT cases:
    ``test_gpt_train_and_generate`` (single device; the JAX case's
    dp/fsdp/tp mesh is not ported), the KV-cache decode against the full
    recompute, and ``decode_forward``'s logits against the forward;
  - ``seq_parallel=True`` outside an SPMD step is the plain model, and
    the refusal of ``lm_pipeline`` names ROADMAP's Queue 1 item 11.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jautograd
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import parallel as jparallel
from incubator_mxnet_tpu.models import gpt as jg

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, nd
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models import convert, gpt as tg
from incubator_mxnet_tpu_torch.parallel import SPMDTrainer

from test_torch_parity import fresh_names, jax_params, port_gpt

V = 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU runs here are tiny: on one intra-op thread they do
    not contend with the other test processes for the cores (restored
    after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(a):
    return nd.array(a, ctx=mx.cpu(), dtype="int32")


@pytest.fixture(scope="module")
def pair():
    jmx.random.seed(3)
    fresh_names()
    jm = jg.gpt_mini(vocab_size=V, max_length=32)
    jm.initialize()
    fresh_names()
    tm = port_gpt(jm, vocab_size=V, max_length=32)
    return jm, tm


def test_structural_names_and_prefixes_equal_jax(pair):
    jm, tm = pair
    assert list(tm._collect_params_with_prefix()) == \
        list(jm._collect_params_with_prefix())
    assert list(tm.state_dict()) == convert.gpt_param_names(2)
    assert sorted(tm.collect_params()) == sorted(jm.collect_params())
    assert tm.blocks[1] is tm.block1 and tm.units == 128
    assert tm.num_heads == 4 and tm.dtype == torch.float32


@pytest.mark.parametrize("flash", [False, True])
def test_logits_match_jax(pair, flash):
    jm, tm = pair
    ids = np.random.RandomState(1).randint(0, V, size=(2, 24))
    want = jm(jnd.array(ids, dtype="int32")).asnumpy()
    model = tm
    if flash:
        model = port_gpt(jm, vocab_size=V, max_length=32, flash=True)
    got = model(_ids(ids)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("weighted", [False, True])
def test_lm_loss_matches_jax(pair, weighted):
    jm, tm = pair
    rng = np.random.RandomState(2)
    x = rng.randint(0, V, size=(2, 16))
    w = (rng.rand(2, 15) > 0.3).astype(np.float32) if weighted else None
    jw = None if w is None else jnd.array(w)
    tw = None if w is None else nd.array(w, ctx=mx.cpu())
    want = float(jg.lm_loss(jm, jnd.array(x[:, :-1], dtype="int32"),
                            jnd.array(x[:, 1:], dtype="int32"),
                            jw).asnumpy())
    got = float(tg.lm_loss(tm, _ids(x[:, :-1]), _ids(x[:, 1:]),
                           tw).asnumpy())
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_adamw_steps_match_the_jax_trainer():
    rng = np.random.RandomState(4)
    X = rng.randint(0, V, (8, 13))
    opt = {"learning_rate": 3e-3, "wd": 0.01}
    jmx.random.seed(5)
    jm = jg.gpt_mini(vocab_size=V, max_length=16)
    jm.initialize()
    tm = port_gpt(jm, vocab_size=V, max_length=16)
    jt = jparallel.SPMDTrainer(jm, forward_loss=jg.lm_loss,
                               optimizer="adamw", optimizer_params=opt,
                               sharding="replicated")
    tt = SPMDTrainer(tm, forward_loss=tg.lm_loss, optimizer="adamw",
                     optimizer_params=opt)
    jb = (jnd.array(X[:, :-1], dtype="int32"),
          jnd.array(X[:, 1:], dtype="int32"))
    tb = (_ids(X[:, :-1]), _ids(X[:, 1:]))
    jl = [float(jt.step(*jb).asnumpy()) for _ in range(3)]
    tl = [float(tt.step(*tb).asnumpy()) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    assert tt.step_trace_count == jt.step_trace_count
    want = convert.block_params_from_jax(tm, jax_params(jm))
    for name, p in tm.state_dict().items():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.numpy(), ref, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(ref).max()),
                                   err_msg=name)


@pytest.mark.parametrize("seed,T0", [(6, 5), (7, 11)])
def test_greedy_generate_equals_jax(pair, seed, T0):
    jm, tm = pair
    prompt = np.random.RandomState(seed).randint(0, V, size=(2, T0))
    want = jg.greedy_generate(jm, jnd.array(prompt, dtype="int32"),
                              max_new_tokens=10).asnumpy()
    got = tg.greedy_generate(tm, prompt, max_new_tokens=10)
    assert got.dtype == np.int32 or str(got.dtype) == "int32"
    np.testing.assert_array_equal(got.asnumpy(), want)


def test_greedy_generate_temperature_draw(pair):
    """The draw follows softmax(logits / T): a one-token continuation of
    one prompt, 4000 rows at once, against the model's own probabilities
    (chi-square); one seed gives one stream."""
    _, tm = pair
    prompt = np.tile(np.random.RandomState(8).randint(0, V, (1, 6)),
                     (4000, 1))
    mx.random.seed(11)
    a = tg.greedy_generate(tm, prompt, max_new_tokens=1,
                           temperature=0.7).asnumpy()
    mx.random.seed(11)
    b = tg.greedy_generate(tm, prompt, max_new_tokens=1,
                           temperature=0.7).asnumpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[:, :6], prompt)
    with autograd.predict_mode():
        logits = tm(_ids(prompt[:1])).asnumpy()[0, -1].astype(np.float64)
    p = np.exp((logits - logits.max()) / 0.7)
    p /= p.sum()
    counts = np.bincount(a[:, 6], minlength=V)
    keep = p * len(a) >= 5
    expect = p[keep] * len(a)
    rest = len(a) - expect.sum()
    obs = np.append(counts[keep], len(a) - counts[keep].sum())
    exp_ = np.append(expect, rest)
    chi2 = float(((obs - exp_) ** 2 / np.maximum(exp_, 1e-9)).sum())
    assert chi2 < 3.0 * len(obs), (chi2, len(obs))


def test_gpt_train_and_generate():
    """The JAX case on one device: the causal loss drops under
    SPMDTrainer (Adam) on a repeating pattern, and greedy_generate
    continues the memorized sequence."""
    mx.random.seed(0)
    with mx.cpu():
        model = tg.gpt_mini(vocab_size=32, max_length=24, dropout=0.0)
        model.initialize()
    seq = np.tile(np.arange(8, dtype=np.int32), 3)[:16]
    X = np.stack([seq] * 8)
    inp, lab = _ids(X[:, :-1]), _ids(X[:, 1:])
    tr = SPMDTrainer(model, forward_loss=tg.lm_loss, optimizer="adam",
                     optimizer_params={"learning_rate": 3e-3})
    l0 = float(tr.step(inp, lab).asnumpy())
    for _ in range(25):
        ln = float(tr.step(inp, lab).asnumpy())
    assert ln < 0.5 * l0, (l0, ln)
    out = tg.greedy_generate(model, X[:1, :8], max_new_tokens=4)
    got = out.asnumpy()[0]
    np.testing.assert_array_equal(got[:8], X[0, :8])
    np.testing.assert_array_equal(got[8:12], X[0, 8:12])


def test_gpt_kv_cache_decode_matches_full_recompute(pair):
    """cached_generate (prefill + one-token steps) emits greedy_generate's
    tokens: greedy and bf16 (the ln_f cast order of the decode head)."""
    _, tm = pair
    prompt = np.random.RandomState(0).randint(0, V, (2, 8))
    slow = tg.greedy_generate(tm, prompt, max_new_tokens=12).asnumpy()
    fast = tg.cached_generate(tm, prompt, max_new_tokens=12).numpy()
    np.testing.assert_array_equal(slow, fast)
    np.testing.assert_array_equal(fast[:, :8], prompt)
    mx.random.seed(1)
    with mx.cpu():
        mb = tg.gpt_mini(vocab_size=V, max_length=32, dtype="bfloat16")
        mb.initialize()
    b1 = tg.greedy_generate(mb, prompt, max_new_tokens=10).asnumpy()
    b2 = tg.cached_generate(mb, prompt, max_new_tokens=10).numpy()
    np.testing.assert_array_equal(b1, b2)


def test_gpt_decode_forward_logits_match_full_forward(pair):
    _, tm = pair
    ids = np.random.RandomState(0).randint(0, V, (2, 16))
    with autograd.predict_mode():
        full = tm(_ids(ids)).asnumpy()
    caches = tg.init_kv_cache(tm, 2, max_len=16)
    logits, _ = tg.decode_forward(tm, _ids(ids), caches, 0)
    np.testing.assert_allclose(logits.numpy(), full, rtol=2e-4, atol=2e-5)


def test_refusals_name_what_they_wait_for(pair):
    jm, tm = pair
    # seq_parallel is ported (tests/test_torch_sp_tp.py runs it over sp
    # ranks); outside an SPMD step it is the plain model, as in JAX
    sp = port_gpt(jm, vocab_size=V, max_length=32, seq_parallel=True)
    ids = np.random.RandomState(1).randint(0, V, (2, 16))
    with autograd.predict_mode():
        np.testing.assert_array_equal(sp(_ids(ids)).asnumpy(),
                                      tm(_ids(ids)).asnumpy())
    with pytest.raises(MXNetError, match="item 11"):
        tg.lm_pipeline(tm)
    with pytest.raises(ValueError, match="remat"):
        tg.gpt_mini(remat="all")
    with pytest.raises(MXNetError, match="max_length"):
        tg.greedy_generate(tm, np.zeros((1, 30), np.int32),
                           max_new_tokens=8)


def test_dropout_is_off_outside_training(pair):
    """With dropout 0.1 the forward is deterministic in predict mode and
    draws masks under ``autograd.record()`` (training)."""
    jm, _ = pair
    m = port_gpt(jm, vocab_size=V, max_length=32, dropout=0.1)
    ids = _ids(np.random.RandomState(9).randint(0, V, (2, 10)))
    with autograd.predict_mode():
        a, b = m(ids).asnumpy(), m(ids).asnumpy()
    np.testing.assert_array_equal(a, b)
    with autograd.record():
        c = m(ids).asnumpy()
    assert not np.array_equal(a, c)
    with jautograd.predict_mode():
        want = jm(jnd.array(ids.asnumpy(), dtype="int32")).asnumpy()
    np.testing.assert_allclose(a, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
