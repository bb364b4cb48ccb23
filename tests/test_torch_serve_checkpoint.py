"""Checkpoints into the port's serving engines, on the CPU (``gpt_mini``
f32, V = 64).

  - on a live engine, ``save_checkpoint`` of another engine then
    ``warm_start(manager=)`` keeps ``decode_trace_count`` and the other
    capture counts, counts a prefix flush, and serves the streams of a
    ``params=`` warm start with the same weights;
  - a training capsule of the port's ``SPMDTrainer`` over a GPT warm-
    starts an engine over the same architecture: the two orders of
    ``param/<i>`` agree (``models.convert.gpt_param_names``), the engine's
    weights are the trainer's bitwise;
  - a JAX capsule of a tiny f32 GPT warm-starts the port's engine, whose
    greedy streams equal the JAX engine's warm-started from the same
    directory;
  - ``FleetSupervisor(manager=)`` re-warms the replacement of a dead
    replica from the latest step, and ``start_upgrade(manager=)`` (through
    ``Router.upgrade_replica(manager=)``) rolls a checkpoint out over the
    fleet with no request lost.
"""

import copy

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import checkpoint as jckpt
from incubator_mxnet_tpu.models import gpt as jg
from incubator_mxnet_tpu.serve import InferenceEngine as JaxEngine
from incubator_mxnet_tpu.serve import Request as JaxRequest

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.checkpoint import CheckpointManager
from incubator_mxnet_tpu_torch.models import convert, gpt as tg
from incubator_mxnet_tpu_torch.parallel import SPMDTrainer
from incubator_mxnet_tpu_torch.serve import (FleetSupervisor,
                                             InferenceEngine, ReplicaState,
                                             Request, build_fleet)

from test_torch_parity import cpu_gpt, fresh_names, port_gpt

V = 64
ENG_KW = dict(num_slots=2, page_size=8, max_len=64, chunk_pages=1,
              prefix_cache=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(seed):
    mx.random.seed(seed)
    fresh_names()
    return cpu_gpt(vocab_size=V, max_length=64)


@pytest.fixture(scope="module")
def weights():
    """Two port models: the one served first (A) and the new weights
    (B)."""
    return _port(3), _port(7)


def _prompts(seed=11, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, size=(5 + 4 * i,)).astype(np.int32)
            for i in range(n)]


def _streams(eng, Req=Request, seed=11):
    reqs = [Req(p, max_new_tokens=8) for p in _prompts(seed)]
    eng.run(reqs)
    return [list(r.token_ids) for r in reqs]


def _counts(eng):
    return (eng.decode_trace_count, eng.prefill_trace_count,
            eng.copy_trace_count)


def test_live_warm_start_from_a_manager_keeps_programs(weights, tmp_path):
    a, b = weights
    eng = InferenceEngine(copy.deepcopy(a), **ENG_KW)
    _streams(eng)
    _streams(eng)                        # a prefix hit builds a COW copy
    before = _counts(eng)
    assert before[0] == 1
    flushes = eng.prefix_flushes
    mgr = CheckpointManager(str(tmp_path), keep=1)
    assert InferenceEngine(b, **ENG_KW).save_checkpoint(
        mgr, step=4) == 4
    mgr.wait()
    eng.warm_start(manager=mgr)
    assert eng.prefix_flushes == flushes + 1 and eng.warm_restarts == 1
    got = _streams(eng)
    assert _counts(eng) == before        # no new capture
    ref = InferenceEngine(copy.deepcopy(a), **ENG_KW)
    ref.warm_start(params=b.state_dict())
    assert got == _streams(ref)
    assert got == _streams(InferenceEngine(b, **ENG_KW))
    mgr.close()


def test_training_capsule_warm_starts_an_engine(weights, tmp_path):
    a, _ = weights
    model = _port(5)
    tr = SPMDTrainer(model, forward_loss=tg.lm_loss, optimizer="adamw",
                     optimizer_params={"learning_rate": 3e-3})
    x = np.random.RandomState(4).randint(0, V, (4, 13))
    ids = [nd.array(v, ctx=mx.cpu(), dtype="int32")
           for v in (x[:, :-1], x[:, 1:])]
    for _ in range(2):
        tr.step(*ids)
    assert tr._names == convert.gpt_param_names(model.num_layers)
    mgr = CheckpointManager(str(tmp_path))
    tr.save_checkpoint(mgr, block=True)
    eng = InferenceEngine(copy.deepcopy(a), **ENG_KW)
    eng.warm_start(manager=mgr)
    served = dict(eng.model.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(served[name], p.detach()), name
    ref = InferenceEngine(copy.deepcopy(a), **ENG_KW)
    ref.warm_start(params=model.state_dict())
    assert _streams(eng) == _streams(ref)


def test_jax_capsule_warm_starts_the_port_engine(tmp_path):
    jmx.random.seed(0)
    fresh_names()
    jm = jg.gpt_mini(vocab_size=V, max_length=64)
    jm.initialize()
    tm = port_gpt(jm, vocab_size=V, max_length=64)
    jmx.random.seed(9)
    fresh_names()
    jm_new = jg.gpt_mini(vocab_size=V, max_length=64)
    jm_new.initialize()
    mgr = jckpt.CheckpointManager(str(tmp_path))
    JaxEngine(jm_new, num_slots=2, page_size=8, max_len=64) \
        .save_checkpoint(mgr, step=2, block=True)
    jeng = JaxEngine(jm, num_slots=2, page_size=8, max_len=64)
    jeng.warm_start(manager=mgr)
    want = _streams(jeng, JaxRequest, seed=13)
    eng = InferenceEngine(tm, num_slots=2, page_size=8, max_len=64)
    eng.warm_start(manager=CheckpointManager(str(tmp_path)))
    assert _streams(eng, seed=13) == want
    mgr.close()


def _fleet(model):
    return build_fleet(model, 2, engine_kw=dict(ENG_KW), seed=3,
                       heartbeat_timeout_s=30.0)


def _weights_of(rep):
    return {k: v.clone() for k, v in rep.engine.model.state_dict().items()}


def _equal(w, model):
    return all(torch.equal(w[k], v) for k, v in model.state_dict().items())


def test_fleet_supervisor_rewarms_a_replacement_from_the_latest_step(
        weights, tmp_path):
    a, b = weights
    mgr = CheckpointManager(str(tmp_path))
    InferenceEngine(b, **ENG_KW).save_checkpoint(mgr, step=1, block=True)
    rt = _fleet(a)
    sup = FleetSupervisor(
        rt, spawn=lambda: InferenceEngine(copy.deepcopy(a), **ENG_KW),
        min_replicas=1, max_replicas=3, down_steps=10 ** 6, manager=mgr)
    rt.replicas[0].kill("test kill")
    for _ in range(3):
        rt.step()
        sup.tick()
    assert rt.replicas[0].state is ReplicaState.DEAD
    assert sup.replacements == 1 and len(rt.replicas) == 3
    new = rt.replicas[2]
    assert new.engine.warm_restarts == 1
    assert _equal(_weights_of(new), b)
    assert _equal(_weights_of(rt.replicas[1]), a)    # untouched
    mgr.close()


def test_upgrade_roll_from_a_manager(weights, tmp_path):
    a, b = weights
    mgr = CheckpointManager(str(tmp_path))
    InferenceEngine(b, **ENG_KW).save_checkpoint(mgr, step=1, block=True)
    rt = _fleet(a)
    sup = FleetSupervisor(
        rt, spawn=lambda: InferenceEngine(copy.deepcopy(a), **ENG_KW),
        min_replicas=1, max_replicas=2, down_steps=10 ** 6)
    reqs = [Request(p, max_new_tokens=8) for p in _prompts(17, 4)]
    for r in reqs:
        rt.submit(r)
    sup.start_upgrade(manager=mgr)
    guard = 0
    while any(r.outcome is None for r in reqs) or \
            sup.snapshot()["roll"] is not None:
        rt.step()
        sup.tick()
        guard += 1
        assert guard < 5000
    assert all(r.outcome.ok for r in reqs)
    assert rt.upgrades == 2 and sup.upgrades_completed == 1
    for rep in rt.replicas:
        assert _equal(_weights_of(rep), b)
        rep.engine.audit_pages()
    after = [Request(p, max_new_tokens=8) for p in _prompts(19)]
    rt.run(after)
    ref = _streams(InferenceEngine(b, **ENG_KW), seed=19)
    assert [list(r.token_ids) for r in after] == ref
    mgr.close()
