"""GPT causal-LM training's CUDA graphs, on the card.

A small gluon GPT (2 layers, 2 heads of 64: the flash kernels' bf16
tensor-core bodies, causal), bf16 with f32 masters, AdamW through
``SPMDTrainer(forward_loss=lm_loss)``, dropout 0.1 drawn from
``mx.random``'s CUDA generator (registered with each graph). Each case
skips without a CUDA device. Held here: a replay equals the step's body
run eagerly bitwise (loss, every parameter, every optimizer-state
tensor) over 3 steps reseeded alike, and adds one causal launch of each
flash kernel a layer; with ``remat=True`` and "dots", replays reseeded
alike give the no-remat trainer's losses and state bitwise and leave the
generator where it leaves it, so the recompute inside a replay uses the
forward's dropout masks. This file imports no JAX, so ``chip_smoke.py``
runs it with ``pytest --noconftest -m cuda``.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.models import gpt as tg
from incubator_mxnet_tpu_torch.ops import flash_attention as fa
from incubator_mxnet_tpu_torch.parallel import SPMDTrainer

from test_torch_train_graphs import _differ, _eager_step, _loss, _state

V, T, B = 512, 128, 4
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the flash kernels)")


def _trainer(remat=False, like=None):
    mx.random.seed(0)
    model = tg.GPTModel(vocab_size=V, units=128, hidden_size=512,
                        num_layers=2, num_heads=2, max_length=T,
                        dtype="bfloat16", flash=True, dropout=0.1,
                        remat=remat)
    model.initialize(ctx=mx.gpu(0))
    if like is not None:
        model.load_state_dict(like.block.state_dict())
    tr = SPMDTrainer(model, forward_loss=tg.lm_loss, optimizer="adamw",
                     optimizer_params={"learning_rate": 1e-3,
                                       "multi_precision": True})
    return tr, mx.random.generator("cuda")


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randint(0, V, (B, T + 1))
    return [nd.array(a, ctx=mx.gpu(0), dtype="int32")._data
            for a in (X[:, :-1], X[:, 1:])]


@pytest.mark.cuda
def test_gpt_causal_replay_equals_eager_body_bitwise(cuda):
    tr, gen = _trainer()
    ref, _ = _trainer(like=tr)
    batch = _batch()
    for i in range(3):
        before = dict(fa.CAUSAL_LAUNCHES)
        gen.manual_seed(10 + i)
        got = _loss(tr.step(*batch))
        torch.cuda.synchronize()
        if i:
            for name in FLASH:
                key = name + "_causal"
                assert fa.CAUSAL_LAUNCHES[key] - before[key] == 2, name
        gen.manual_seed(10 + i)
        want = _eager_step(ref, batch)
        assert torch.equal(got, want), (i, float(got), float(want))
        assert _differ(_state(tr), _state(ref)) == [], i
    assert tr.step_trace_count == 1


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_replay_recomputes_with_the_forward_masks(cuda, remat):
    plain, gen = _trainer()
    re_tr, _ = _trainer(remat=remat, like=plain)
    batch = _batch(1)
    for i in range(3):
        gen.manual_seed(20 + i)
        want = _loss(plain.step(*batch))
        state_after = gen.get_state()
        gen.manual_seed(20 + i)
        got = _loss(re_tr.step(*batch))
        assert torch.equal(got, want), (i, float(got), float(want))
        assert torch.equal(gen.get_state(), state_after), i
        assert _differ(_state(re_tr), _state(plain)) == [], i
    assert re_tr.step_trace_count == 1 and plain.step_trace_count == 1
