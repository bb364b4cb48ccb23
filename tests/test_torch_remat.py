"""Rematerialization (``models/_remat.py``) on the CPU.

  - the ports of the JAX ``tests/test_models.py`` cases
    ``test_bert_remat_matches_no_remat`` and ``test_gpt_remat_parity``:
    3 ``SPMDTrainer`` steps (dropout 0) with ``remat`` False, True and
    "dots" give losses within 1e-5 of each other;
  - with dropout 0.1 and one seed, ``remat=True`` and "dots" give the
    no-remat loss and every gradient bitwise, and leave ``mx.random``'s
    generator in the same state: the recompute replays the forward's
    masks instead of drawing new ones (GPT and BERT);
  - "dots" saves the matrix products (the backward recomputes none of
    them) and True recomputes them;
  - ``plan_remat_from_profile`` equals the JAX function over a table of
    profile stats; ``resolve_policy`` refuses what JAX refuses.
"""

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.models import _remat as jremat

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import autograd, nd
from incubator_mxnet_tpu_torch.models import _remat as tremat
from incubator_mxnet_tpu_torch.models import bert as tb, gpt as tg
from incubator_mxnet_tpu_torch.parallel import SPMDTrainer

REMATS = (False, True, "dots")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU runs here are tiny: on one intra-op thread they do
    not contend with the other test processes for the cores (restored
    after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nd(a, dtype="int32"):
    return nd.array(a, ctx=mx.cpu(), dtype=dtype)


def _bert(remat, dropout=0.0, seed=9, T=16):
    mx.random.seed(seed)
    with mx.cpu():
        model = tb.bert_tiny(vocab_size=128, max_length=T, remat=remat,
                             dropout=dropout)
        model.initialize()
        pre = tb.BERTForPretraining(model)
        pre.initialize()
    return pre


def _bert_batch(T=16):
    rng = np.random.RandomState(0)
    B, M = 8, 3
    return (_nd(rng.randint(0, 128, (B, T))), _nd(rng.randint(0, 2, (B, T))),
            _nd(np.full((B,), T)), _nd(rng.randint(0, T, (B, M))),
            _nd(rng.randint(0, 128, (B, M))), _nd(np.ones((B, M)), "float32"),
            _nd(rng.randint(0, 2, (B,))))


def _gpt(remat, dropout=0.0, seed=4):
    mx.random.seed(seed)
    with mx.cpu():
        m = tg.gpt_mini(vocab_size=64, max_length=16, dropout=dropout,
                        remat=remat)
        m.initialize()
    return m


def _gpt_batch():
    X = np.random.RandomState(1).randint(0, 64, (8, 12))
    return _nd(X[:, :-1]), _nd(X[:, 1:])


def test_bert_remat_matches_no_remat():
    batch = _bert_batch()
    losses = {}
    for remat in REMATS:
        tr = SPMDTrainer(_bert(remat), forward_loss=tb.pretraining_loss,
                         optimizer="sgd",
                         optimizer_params={"learning_rate": 0.1})
        for _ in range(3):
            L = tr.step(*batch)
        losses[remat] = float(L.asnumpy())
    assert abs(losses[True] - losses[False]) < 1e-5, losses
    assert abs(losses["dots"] - losses[False]) < 1e-5, losses


def test_gpt_remat_parity():
    batch = _gpt_batch()
    losses = {}
    for remat in REMATS:
        tr = SPMDTrainer(_gpt(remat), forward_loss=tg.lm_loss,
                         optimizer="sgd",
                         optimizer_params={"learning_rate": 0.1})
        for _ in range(3):
            L = tr.step(*batch)
        losses[remat] = float(L.asnumpy())
    assert abs(losses[True] - losses[False]) < 1e-5, losses
    assert abs(losses["dots"] - losses[False]) < 1e-5, losses


def _loss_grads(kind, remat, seed=13):
    """Loss, gradients and the CPU generator's state after one recorded
    forward and backward with dropout 0.1, reseeded to ``seed``."""
    if kind == "gpt":
        block, batch, fn = _gpt(remat, dropout=0.1), _gpt_batch(), tg.lm_loss
    else:
        block, batch, fn = (_bert(remat, dropout=0.1), _bert_batch(),
                            tb.pretraining_loss)
    params = [p for p in block.parameters() if p.requires_grad]
    gen = mx.random.generator("cpu")
    mx.random.seed(seed)
    with autograd.record():
        loss = fn(block, *batch)._data
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss, grads, gen.get_state()


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_remat_replays_the_forward_dropout_masks_bitwise(kind):
    want, wgrads, wstate = _loss_grads(kind, False)
    for remat in (True, "dots"):
        got, grads, state = _loss_grads(kind, remat)
        assert torch.equal(got, want), (remat, float(got), float(want))
        assert len(grads) == len(wgrads)
        for i, (g, w) in enumerate(zip(grads, wgrads)):
            assert (g is None) == (w is None), (remat, i)
            if g is not None:
                assert torch.equal(g, w), (remat, i)
        assert torch.equal(state, wstate), remat


def _matmuls_in_backward(remat):
    """aten matrix products the backward of one GPT forward runs."""
    from torch.utils._python_dispatch import TorchDispatchMode
    names = ("mm", "addmm", "bmm", "baddbmm")
    seen = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in names:
                seen.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    block = _gpt(remat)
    params = [p for p in block.parameters() if p.requires_grad]
    with autograd.record():
        loss = tg.lm_loss(block, *_gpt_batch())._data
    with Count():
        torch.autograd.grad(loss, params)
    return len(seen)


def test_dots_saves_the_products_and_true_recomputes_them():
    plain, full, dots = (_matmuls_in_backward(r) for r in REMATS)
    assert dots == plain
    assert full > plain


@pytest.mark.parametrize("stats", [
    {}, {"compute_us": 0.0, "exposed_us": 5.0},
    {"compute_us": 100.0, "exposed_us": 1.0},
    {"compute_us": 100.0, "exposed_us": 10.0},
    {"compute_us": 100.0, "exposed_us": 24.9},
    {"compute_us": 100.0, "exposed_us": 25.0},
    {"compute_us": 100.0, "exposed_us": 60.0},
    {"compute_us": 100.0, "exposed_us": 400.0},
    {"compute_us": None, "exposed_us": None}])
@pytest.mark.parametrize("num_blocks", [0, 1, 5, 12])
def test_plan_remat_from_profile_equals_jax(stats, num_blocks):
    assert tremat.plan_remat_from_profile(stats, num_blocks) == \
        jremat.plan_remat_from_profile(stats, num_blocks)


def test_resolve_policy_refuses_what_jax_refuses():
    assert tremat.resolve_policy(False) is None
    assert jremat.resolve_policy(False) is None
    assert tremat.resolve_policy(True) == "all"
    assert tremat.resolve_policy("dots") == "dots"
    for bad in ("all", 2, "full"):
        with pytest.raises(ValueError, match="remat"):
            tremat.resolve_policy(bad)
        with pytest.raises(ValueError, match="remat"):
            jremat.resolve_policy(bad)
