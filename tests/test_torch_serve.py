"""The port's serving engine against the JAX package's.

``gpt_mini`` (f32) is initialized in the JAX package and its weights go
across into the port. For fixed prompts the two ``InferenceEngine``s
must emit equal greedy token streams and equal outcomes — monolithic
prefill, chunked prefill at ``chunk_pages`` 1 and 2, a prefix-cache hit
(with its copy-on-write boundary page), several slots at mixed lengths
and a sampling menu — with ``audit_pages()`` clean on both. Temperature
streams use different generators in the two frameworks, so they are
held inside the port: reproducible per (request seed, position) and
independent of chunking and occupancy."""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.models import gpt as jg
from incubator_mxnet_tpu.serve import InferenceEngine as JaxEngine
from incubator_mxnet_tpu.serve import Request as JaxRequest
from incubator_mxnet_tpu.serve import SamplingParams as JaxSampling

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.checkpoint import CheckpointManager
from incubator_mxnet_tpu_torch.models import gpt as tg
from incubator_mxnet_tpu_torch.serve import (EventType, InferenceEngine,
                                             Outcome, Request,
                                             SamplingParams, Tier)

from test_torch_parity import cpu_gpt, port_gpt

V = 64


@pytest.fixture(scope="module")
def models():
    jmx.random.seed(0)
    jm = jg.gpt_mini(vocab_size=V, max_length=64)
    jm.initialize()
    tm = port_gpt(jm, vocab_size=V, max_length=64)
    return jm, tm


def _workload():
    """Seven prompts for three slots: mixed lengths, and two that share a
    20-token prefix with the first (two full pages plus a partial one at
    page_size 8: a prefix hit with a copy-on-write boundary page)."""
    rng = np.random.RandomState(2)
    prefix = rng.randint(0, V, size=20)
    prompts = [np.concatenate([prefix, rng.randint(0, V, size=3)])]
    prompts += [rng.randint(0, V, size=n) for n in (3, 9, 17, 5, 12)]
    prompts += [np.concatenate([prefix, rng.randint(0, V, size=6)])]
    news = (10, 6, 14, 8, 12, 7, 9)
    eos = (-1, 7, -1, 3, -1, -1, 11)
    return [dict(prompt_ids=p.astype(np.int32), max_new_tokens=n,
                 eos_id=e) for p, n, e in zip(prompts, news, eos)]


def _run_both(models, specs, **engine_kw):
    jm, tm = models
    kw = dict(num_slots=3, page_size=8, max_len=64, num_pages=24,
              **engine_kw)
    je, te = JaxEngine(jm, **kw), InferenceEngine(tm, **kw)
    jr = [JaxRequest(**s) for s in specs]
    tr = [Request(**s) for s in specs]
    je.run(jr)
    te.run(tr)
    je.audit_pages()
    te.audit_pages()
    return je, te, jr, tr


@pytest.mark.parametrize("mode", [dict(), dict(chunk_pages=1),
                                  dict(chunk_pages=2)],
                         ids=["monolithic", "chunk1", "chunk2"])
def test_greedy_streams_match_jax(models, mode):
    je, te, jr, tr = _run_both(models, _workload(), **mode)
    for a, b in zip(jr, tr):
        assert b.token_ids == a.token_ids
        assert b.outcome.value == a.outcome.value
    assert te.prefix_hits == je.prefix_hits > 0
    assert te.prefix_hit_tokens == je.prefix_hit_tokens
    assert te.decode_steps == je.decode_steps


def test_sampling_menu_greedy_matches_jax(models):
    menus = [dict(top_k=5, repetition_penalty=1.3),
             dict(presence_penalty=0.7, logit_bias={3: 2.0, 9: -5.0}),
             dict(top_k=3)]
    specs = _workload()[:3]
    jm, tm = models
    kw = dict(num_slots=3, page_size=8, max_len=64, chunk_pages=2)
    je, te = JaxEngine(jm, **kw), InferenceEngine(tm, **kw)
    jr = [JaxRequest(**s, sampling=JaxSampling(**m))
          for s, m in zip(specs, menus)]
    tr = [Request(**s, sampling=SamplingParams(**m))
          for s, m in zip(specs, menus)]
    je.run(jr)
    te.run(tr)
    for a, b in zip(jr, tr):
        assert b.token_ids == a.token_ids
        assert b.outcome.value == a.outcome.value
    te.audit_pages()


@pytest.mark.parametrize("mode", [dict(), dict(chunk_pages=2)],
                         ids=["monolithic", "chunk2"])
def test_engine_matches_port_cached_generate(models, mode):
    _, tm = models
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, V, size=n) for n in (6, 19)]
    eng = InferenceEngine(tm, num_slots=2, page_size=8, max_len=64, **mode)
    reqs = [Request(p, max_new_tokens=12) for p in prompts]
    eng.run(reqs)
    for p, r in zip(prompts, reqs):
        ref = tg.cached_generate(tm, torch.tensor(p[None]),
                                 max_new_tokens=12)[0, p.size:]
        assert r.token_ids == ref.tolist()


def test_temperature_streams_reproducible_and_independent(models):
    _, tm = models
    rng = np.random.RandomState(4)
    hot = rng.randint(0, V, size=13)
    others = [rng.randint(0, V, size=n) for n in (4, 21, 9)]

    def hot_tokens(seed, mode, with_others):
        eng = InferenceEngine(tm, num_slots=4, page_size=8, max_len=64,
                              **mode)
        reqs = [Request(p, max_new_tokens=10, temperature=0.7, seed=i)
                for i, p in enumerate(others)] if with_others else []
        target = Request(hot, max_new_tokens=12, temperature=0.9,
                         seed=seed)
        eng.run(reqs[:1] + [target] + reqs[1:])
        eng.audit_pages()
        return target.token_ids

    alone = hot_tokens(11, {}, False)
    assert hot_tokens(11, {}, False) == alone
    assert hot_tokens(11, dict(chunk_pages=1), True) == alone
    assert hot_tokens(11, dict(chunk_pages=2), True) == alone
    assert hot_tokens(12, {}, False) != alone


def test_stop_sequence_and_eos_outcomes(models):
    _, tm = models
    prompt = np.random.RandomState(24).randint(0, V, size=8)
    ref = tg.cached_generate(tm, torch.tensor(prompt[None]),
                             max_new_tokens=12)[0, 8:].tolist()
    eng = InferenceEngine(tm, num_slots=2, page_size=8, max_len=64)
    eos = Request(prompt, max_new_tokens=12, eos_id=ref[4])
    stop = Request(prompt, max_new_tokens=12,
                   sampling=SamplingParams(stop_sequences=[ref[5:7]]))
    eng.run([eos, stop])
    first = ref.index(ref[4])
    assert eos.outcome is Outcome.EOS and eos.token_ids == ref[:first + 1]
    hit = next(j for j in range(11) if ref[j:j + 2] == ref[5:7])
    assert first > 0 and hit > 0            # streams that say something
    assert stop.outcome is Outcome.STOP
    assert stop.token_ids == ref[:hit]      # the match is not output
    assert eng.stop_hits == 1
    eng.audit_pages()


def test_shed_cancel_deadline_and_unservable(models):
    _, tm = models
    rng = np.random.RandomState(6)
    eng = InferenceEngine(tm, num_slots=1, page_size=8, max_len=64,
                          max_queue=1)
    a = Request(rng.randint(0, V, size=5), max_new_tokens=30)
    b = Request(rng.randint(0, V, size=5), max_new_tokens=4)
    c = Request(rng.randint(0, V, size=5), max_new_tokens=4)
    too_big = Request(rng.randint(0, V, size=40), max_new_tokens=40)
    assert eng.submit(a) and eng.submit(b) is False
    assert b.outcome is Outcome.SHED and b.retry_after_s > 0
    assert eng.submit(too_big) is False
    assert too_big.outcome is Outcome.FAILED_UNSERVABLE
    eng.step()                               # a admitted and decoding
    assert eng.submit(c)
    assert eng.cancel(c.request_id) and c.outcome is Outcome.CANCELLED
    assert eng.cancel(a) and a.outcome is Outcome.CANCELLED
    assert 0 < len(a.token_ids) < 30 and eng.cancel(a) is False
    d = Request(rng.randint(0, V, size=5), max_new_tokens=4,
                deadline_s=1e-9)
    eng.run([d])
    assert d.outcome is Outcome.DEADLINE_EXPIRED
    eng.audit_pages()
    assert eng._alloc.free_count == eng.num_pages - 1 - len(eng._prefix)
    terminals = eng.flight.events(etype=EventType.TERMINAL)
    assert len(terminals) == 5


def test_nonfinite_guard_quarantines_the_slot(models):
    _, tm = models
    """Position 9's embedding is NaN: the 10-token prompt is poisoned
    in prefill; the 4-token one never reaches position 9."""
    bad = cpu_gpt(vocab_size=V, max_length=64)
    bad.load_state_dict(tm.state_dict())
    with torch.no_grad():
        bad.position_embed.weight.data()._data[9] = float("nan")
    rng = np.random.RandomState(7)
    poisoned = rng.randint(0, V, size=10)
    healthy = rng.randint(0, V, size=4)
    for mode in (dict(), dict(chunk_pages=1)):
        eng = InferenceEngine(bad, num_slots=2, page_size=8, max_len=64,
                              **mode)
        r1 = Request(poisoned, max_new_tokens=5)
        r2 = Request(healthy, max_new_tokens=5)
        eng.run([r1, r2])
        assert r1.outcome is Outcome.FAILED_NONFINITE and not r1.token_ids
        assert r2.outcome is Outcome.MAX_TOKENS
        assert eng.quarantined == 1
        eng.audit_pages()


def test_latency_tier_preempts_batch_and_resume_is_exact(models):
    _, tm = models
    rng = np.random.RandomState(8)
    p_batch, p_lat = rng.randint(0, V, size=7), rng.randint(0, V, size=5)
    solo = InferenceEngine(tm, num_slots=1, page_size=8, max_len=64)
    ref = Request(p_batch, max_new_tokens=10)
    solo.run([ref])
    eng = InferenceEngine(tm, num_slots=1, page_size=8, max_len=64)
    batch = Request(p_batch, max_new_tokens=10, tier=Tier.BATCH)
    eng.submit(batch)
    for _ in range(4):
        eng.step()
    lat = Request(p_lat, max_new_tokens=3, tier=Tier.LATENCY)
    eng.run([lat])
    assert eng.preemptions == 1 and batch.preemptions == 1
    assert lat.outcome is Outcome.MAX_TOKENS
    eng.run([])
    assert batch.outcome is Outcome.MAX_TOKENS
    assert batch.token_ids == ref.token_ids
    eng.audit_pages()


def test_out_of_scope_options_raise(models, tmp_path):
    """The tp mesh is ported (tests/test_torch_sp_tp.py runs it over two
    tp ranks): a mesh whose tp axis is 1 is the unsharded engine, and
    what is not a mesh raises. The checkpoint manager's entry points run:
    a save, a warm start from it, the SIGTERM hook."""
    _, tm = models
    with pytest.raises(MXNetError, match="build_mesh"):
        InferenceEngine(tm, num_slots=1, page_size=8, max_len=64,
                        mesh=object())
    with mx.cpu():
        one = InferenceEngine(tm, num_slots=1, page_size=8, max_len=64,
                              mesh=mx.parallel.build_mesh())
    assert one._tp is None and one._H == tm.num_heads
    eng = InferenceEngine(tm, num_slots=1, page_size=8, max_len=64)
    mgr = CheckpointManager(str(tmp_path))
    assert eng.save_checkpoint(mgr, step=5, block=True) == 5
    eng.warm_start(manager=mgr)
    assert eng.warm_restarts == 1 and eng.decode_trace_count == 0
    eng.install_preemption(mgr, exit_after=False)
    try:
        os.kill(os.getpid(), signal.SIGTERM)    # final save at step 0
    finally:
        mgr.uninstall_preemption_hook()
    assert mgr.all_steps() == [0, 5]
    mgr.close()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, incubator_mxnet_tpu_torch as mx\n"
            "mx.serve.InferenceEngine; mx.models.gpt_small\n"
            "import incubator_mxnet_tpu_torch.serve.transport\n"
            "import incubator_mxnet_tpu_torch.serve.metrics\n"
            "import incubator_mxnet_tpu_torch.checkpoint.manifest\n"
            "import incubator_mxnet_tpu_torch.checkpoint.manager\n"
            "import incubator_mxnet_tpu_torch.checkpoint.capsule\n"
            "import incubator_mxnet_tpu_torch.train.supervisor\n"
            "import incubator_mxnet_tpu_torch.train.chaos\n"
            "import incubator_mxnet_tpu_torch.train.example_target\n"
            "import incubator_mxnet_tpu_torch.serve.router\n"
            "import incubator_mxnet_tpu_torch.serve.fleet_supervisor\n"
            "import incubator_mxnet_tpu_torch.serve.frontend\n"
            "import incubator_mxnet_tpu_torch.serve.chaos\n"
            "import incubator_mxnet_tpu_torch.models.transformer\n"
            "import incubator_mxnet_tpu_torch.models._remat\n"
            "mx.models.transformer.beam_search_translate_cached\n"
            "mx.sym.FullyConnected; mx.symbol.contrib; mx.mod.Module\n"
            "mx.module.BucketingModule; mx.io.NDArrayIter; mx.kv.create\n"
            "mx.kvstore.KVStore; mx.callback.Speedometer\n"
            "mx.model.load_checkpoint; mx.viz.print_summary\n"
            "mx.executor.Executor; mx.attribute; mx.name.Prefix\n"
            "mx.AttrScope; mx.visualization; mx.symbol.passes\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('ml_dtypes') or "
            "m.startswith('incubator_mxnet_tpu')"
            " and not m.startswith('incubator_mxnet_tpu_torch')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("V_", [16, 50257])
def test_constrain_logits_top_p_equals_jax(V_):
    """The full menu with top-p on (the row-aligned normalizer and
    cumsum) against the JAX ``constrain_logits``: the same tokens kept,
    their values equal, on (S, W, V) rows of one batch."""
    from incubator_mxnet_tpu.serve.sampling import \
        constrain_logits as jax_constrain
    from incubator_mxnet_tpu_torch.serve.sampling import constrain_logits
    rng = np.random.RandomState(3)
    S, W = 3, 2
    logits = (rng.randn(S, W, V_) * 3).astype(np.float32)
    args = dict(
        temps=np.array([[0.7], [1.0], [0.0]], np.float32),
        counts=rng.randint(0, 2, size=(S, W, V_)).astype(np.int32),
        bias=np.zeros((S, W, V_), np.float32),
        mask=rng.rand(S, W, V_) > 0.05,
        top_k=np.array([[0], [40], [5]], np.int32),
        top_p=np.array([[0.9], [0.5], [0.95]], np.float32),
        rep_pen=np.array([[1.2], [1.0], [1.0]], np.float32),
        pres_pen=np.array([[0.0], [0.3], [0.0]], np.float32))
    want = np.asarray(jax_constrain(logits, **args))
    got = constrain_logits(torch.from_numpy(logits),
                           **{k: torch.from_numpy(v) for k, v in
                              args.items()}).numpy()
    kept = want > -1e29
    assert np.array_equal(got > -1e29, kept)
    assert np.allclose(got[kept], want[kept], rtol=1e-6, atol=1e-6)
    assert 0 < kept.sum() < kept.size
