"""The train step's CUDA graphs, on the card.

bert_tiny, bf16 with f32 masters, the flash kernels' tensor-core bodies
(D = 64), LAMB, dropout 0.1 drawn from the model's own CUDA generator
(registered with each graph). Each case skips without a CUDA device.
Held here: a replay equals the step's body run eagerly on the current
stream bitwise (loss, every parameter, every optimizer-state tensor) over
3 steps reseeded alike, so the replay's dropout masks are the eager
body's; a replay draws from the generator's state at the replay and
advances it; two batch signatures alternating, sharing one graph memory
pool, equal the eager body with one capture each; each replay adds
layers x 1 launches of each flash kernel (layers x 3 in all); a NaN
batch through a replay leaves every parameter and state tensor bitwise
(and a BatchNorm's running statistics and step count);
a capture that fails raises ``MXNetError`` after the eager first step is
recorded (and leaves the generators drawing eagerly again), and no step
runs eagerly in its place. This file imports no JAX, so
``chip_smoke.py`` runs it with ``pytest --noconftest -m cuda``.
"""

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch import models
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import flash_attention as fa
from incubator_mxnet_tpu_torch.optimizer.fused import tree_leaves
from incubator_mxnet_tpu_torch.parallel import SPMDTrainer
from incubator_mxnet_tpu_torch.train import StepOutcome

B, M, V = 8, 20, 1024
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the flash kernels)")


def _batch(T, seed, poison=False):
    rng = np.random.RandomState(seed)
    lens = rng.randint(T // 2, T + 1, size=B)
    pos = np.stack([rng.choice(n, size=M, replace=False) for n in lens])
    weights = np.ones((B, M), np.float32)
    if poison:
        weights[0, 0] = np.nan              # a NaN loss and gradients
    arrays = (rng.randint(0, V, (B, T)), rng.randint(0, 2, (B, T)), lens,
              pos, rng.randint(0, V, (B, M)), weights,
              rng.randint(0, 2, (B,)))
    return [torch.tensor(a, device="cuda") for a in arrays]


def _trainer(dropout=0.1, lr=1e-3, forward_loss=models.pretraining_loss,
             like=None):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bert = models.bert_tiny(vocab_size=V, max_length=128, dtype="bfloat16",
                            flash=True, dropout=dropout, device="cuda",
                            generator=gen)
    pre = models.BERTForPretraining(bert)
    if like is not None:
        pre.load_state_dict(like.block.state_dict())
    tr = SPMDTrainer(pre, forward_loss=forward_loss, optimizer="lamb",
                     optimizer_params={"learning_rate": lr,
                                       "multi_precision": True})
    return tr, gen


def _eager_step(tr, batch):
    """The step's body run eagerly on the current stream, outside any
    graph: what a replay is held to. Returns the loss."""
    if tr._opt_state is None:
        tr._materialize()
    dev = tr.device
    t = torch.full((), tr.step_count + 1.0, device=dev)
    lr = torch.full((), tr.learning_rate, device=dev)
    one = torch.ones((), device=dev)
    loss, grads = tr._forward_backward(batch, one)
    if float(tr._apply(grads, t, lr, one)) > 0:
        tr.step_count += 1
    return loss


def _state(tr):
    return [p.detach().clone() for p in tr._params] + \
        [x.clone() for x in tree_leaves(tr._opt_state)]


def _differ(a, b):
    """Indices of the tensors that are not bitwise equal."""
    return [i for i, (x, y) in enumerate(zip(a, b))
            if not torch.equal(x, y)]


def _prog(tr, T):
    return next(p for sig, p in tr._programs.items() if sig[0][0][1] == T)


@pytest.mark.cuda
def test_replay_equals_eager_body_bitwise(cuda):
    tr, gen = _trainer()
    ref, ref_gen = _trainer(like=tr)
    batch = _batch(128, 0)
    for i in range(3):
        gen.manual_seed(10 + i)
        ref_gen.manual_seed(10 + i)
        got = tr.step(*batch)
        want = _eager_step(ref, batch)
        assert torch.equal(got, want), (i, float(got), float(want))
        assert _differ(_state(tr), _state(ref)) == [], i
    assert tr.step_count == ref.step_count == 3
    assert tr.step_trace_count == 1 and _prog(tr, 128).replays == 2


@pytest.mark.cuda
def test_replay_draws_from_the_generators_current_state(cuda):
    """lr 0 keeps the weights: a replay reseeded as the eager first step
    was gives its loss bitwise; another seed, or no reseed (the state the
    last replay advanced), gives other masks."""
    tr, gen = _trainer(lr=0.0)
    batch = _batch(128, 1)
    before = [p.detach().clone() for p in tr._params]
    losses = []
    for seed in (1, 1, 2, None):
        if seed is not None:
            gen.manual_seed(seed)
        losses.append(tr.step(*batch))
    assert torch.equal(losses[0], losses[1])
    assert not torch.equal(losses[1], losses[2])
    assert not torch.equal(losses[2], losses[3])
    assert _differ(before, [p.detach() for p in tr._params]) == []
    assert tr.step_trace_count == 1 and _prog(tr, 128).replays == 3


@pytest.mark.cuda
def test_two_signatures_alternating_equal_eager_body(cuda):
    tr, gen = _trainer()
    ref, ref_gen = _trainer(like=tr)
    batches = {128: _batch(128, 2), 64: _batch(64, 3)}
    for i, T in enumerate((128, 64, 128, 64, 128)):
        gen.manual_seed(i)
        ref_gen.manual_seed(i)
        got = tr.step(*batches[T])
        want = _eager_step(ref, batches[T])
        assert torch.equal(got, want), (i, T, float(got), float(want))
        assert _differ(_state(tr), _state(ref)) == [], (i, T)
    assert tr.step_trace_count == 2
    assert (_prog(tr, 128).replays, _prog(tr, 64).replays) == (2, 1)
    assert _prog(tr, 128).graph is not None and _prog(tr, 64).graph \
        is not None


@pytest.mark.cuda
def test_flash_launches_per_replay(cuda):
    tr, gen = _trainer()
    L = tr.block.bert.num_layers
    batch = _batch(128, 4)
    for i in range(3):
        before = dict(fa.LAUNCHES)
        tr.step(*batch)
        delta = {k: fa.LAUNCHES[k] - before[k] for k in FLASH}
        # the first step runs eagerly (real launches), its capture
        # counts none; each replay adds what the capture counted
        assert delta == {k: L for k in FLASH}, (i, delta)
    prog = _prog(tr, 128)
    assert prog.launches == {k: L for k in FLASH}
    assert sum(prog.launches.values()) == 3 * L and prog.replays == 2


@pytest.mark.cuda
def test_nan_batch_through_a_replay_leaves_state_bitwise(cuda):
    tr, gen = _trainer()
    clean, bad = _batch(128, 5), _batch(128, 5, poison=True)
    tr.step(*clean)
    before = _state(tr)
    tr.step(*bad)
    assert tr.last_outcome is StepOutcome.SKIPPED_NONFINITE
    assert _differ(before, _state(tr)) == []
    assert tr.step_count == 1 and _prog(tr, 128).replays == 1
    tr.step(*clean)
    assert tr.last_outcome is StepOutcome.APPLIED and tr.step_count == 2
    assert len(_differ(before, _state(tr))) > 0
    assert tr.step_trace_count == 1 and _prog(tr, 128).replays == 2


@pytest.mark.cuda
def test_failed_capture_raises(cuda):
    """A body that reads the host runs eagerly (the first step, recorded
    as any step) but cannot be captured: ``MXNetError``, no program, and
    the next step tries the build again rather than running eagerly."""
    def reads_host(block, *batch):
        loss = models.pretraining_loss(block, *batch)
        if not np.isfinite(float(loss.detach())):    # a host read
            raise AssertionError("unreachable: the batch is clean")
        return loss

    tr, gen = _trainer(forward_loss=reads_host)
    batch = _batch(128, 6)
    for n in (1, 2):
        with pytest.raises(MXNetError, match="capture failed"):
            tr.step(*batch)
        assert tr.step_count == n and tr.last_outcome is StepOutcome.APPLIED
        assert tr.step_trace_count == 0 and tr._programs == {}
    # the failed captures left the generators drawing eagerly again
    gen.manual_seed(3)
    a = torch.empty(64, device="cuda").bernoulli_(0.5, generator=gen)
    b = torch.empty(64, device="cuda").bernoulli_(0.5)
    assert a.sum() > 0 and b.sum() > 0


@pytest.mark.cuda
def test_batchnorm_buffers_through_a_skipped_replay(cuda):
    """A BatchNorm's running statistics and ``num_batches_tracked``
    through the step graph: a clean replay moves them, a NaN batch's
    replay leaves them (and the parameters) bitwise, as the JAX trainer
    leaves its running statistics."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                              torch.nn.BatchNorm1d(16),
                              torch.nn.Linear(16, 4)).cuda()
    tr = SPMDTrainer(net, loss=lambda o, y: torch.nn.functional
                     .cross_entropy(o, y.long()), optimizer="adam",
                     optimizer_params={"learning_rate": 0.01})
    rng = np.random.RandomState(2)
    X = torch.tensor(rng.randn(16, 8).astype(np.float32), device="cuda")
    y = torch.tensor(rng.randint(0, 4, size=(16,)), device="cuda")
    bad = X.clone()
    bad[0, 0] = float("nan")
    for _ in range(2):                        # the capture, one replay
        tr.step(X, y)
    bn = net[2]
    before = [b.clone() for b in net.buffers()] + \
        [p.detach().clone() for p in net.parameters()]
    tr.step(bad, y)
    assert tr.last_outcome is StepOutcome.SKIPPED_NONFINITE
    after = list(net.buffers()) + [p.detach() for p in net.parameters()]
    for b, a in zip(before, after):
        assert torch.equal(a, b)
    assert int(bn.num_batches_tracked) == 2
    tr.step(X, y)
    assert tr.last_outcome is StepOutcome.APPLIED
    assert int(bn.num_batches_tracked) == 3
    assert not torch.equal(bn.running_mean, before[0])
    prog = next(iter(tr._programs.values()))
    assert tr.step_trace_count == 1 and prog.replays == 3
