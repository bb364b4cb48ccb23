"""The port's brownout controller and Prometheus renderer against the JAX
package's.

Held here:

  - ``serve.slo.BrownoutController`` and the JAX controller on the same
    pressure-signal sequence: the same level at every update and the same
    transition timeline; the threshold refusal; ``wants_rebalance``;
  - the engine's brownout levels (``gpt_mini`` f32 on the CPU), each with
    a controller pinned at one level: 1 turns speculation off (no verify
    build), 2 clamps the chunked-prefill budget to one chunk (no new
    build), 3 holds BATCH admissions until the level falls; the real
    controller's closed loop escalating under a backlog and recovering
    to level 0; a BATCH-only backlog that cannot hold level 3 (the delay
    signal is the priority tiers'); the snapshot's brownout fields;
  - ``serve.metrics.render_metrics`` / ``render_frontend_metrics`` of the
    port on the JAX engine's and router's snapshot dicts equal the JAX
    renderer's text, and a golden parse of the port engine's own
    snapshot (tiers, int8 pages, brownout) whose keys are the JAX
    engine's.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.models import gpt as jg
from incubator_mxnet_tpu.serve import InferenceEngine as JaxEngine
from incubator_mxnet_tpu.serve import Request as JaxRequest
from incubator_mxnet_tpu.serve import Tier as JaxTier
from incubator_mxnet_tpu.serve import build_fleet
from incubator_mxnet_tpu.serve import metrics as jmetrics
from incubator_mxnet_tpu.serve import slo as jslo

from incubator_mxnet_tpu_torch.models import convert, gpt as tg
from incubator_mxnet_tpu_torch.serve import (BrownoutController,
                                             InferenceEngine, Outcome,
                                             Request, Tier,
                                             render_frontend_metrics,
                                             render_metrics,
                                             wants_rebalance)

V = 64


@pytest.fixture(scope="module")
def models():
    jmx.random.seed(0)
    jm = jg.gpt_mini(vocab_size=V, max_length=64)
    jm.initialize()
    tm = tg.gpt_mini(vocab_size=V, max_length=64, device="cpu")
    tm.load_state_dict(convert.params_from_jax(
        [p.data().asnumpy() for p in jm.collect_params().values()]))
    return jm, tm


def _prompt(rng, n):
    return rng.randint(0, V, size=(n,)).astype(np.int32)


def _drain(eng, reqs, max_steps=3000):
    steps = 0
    while any(r.outcome is None for r in reqs):
        eng.step()
        eng.audit_pages()
        steps += 1
        assert steps < max_steps, "engine failed to reach quiescence"
    return steps


# --------------------------------------------------------------------- #
# the controller
# --------------------------------------------------------------------- #

def _controller_run(Controller):
    """The JAX package's hysteresis unit's signal sequence: levels after
    every update, and the timeline."""
    bo = Controller(enter=(0.5, 0.7, 0.9), exit_margin=0.2, up_steps=2,
                    down_steps=3)
    snaps = {"num_slots": 4, "queue_depth": 0, "free_pages": 10,
             "active_slots": 0, "estimated_queue_delay_s": None}
    eng = SimpleNamespace(num_pages=11, decode_steps=0,
                          health_snapshot=lambda: dict(snaps))
    levels = []
    for pressure, n in ((1.0, 1), (1.0, 1), (1.0, 4), (1.0, 3), (0.0, 2),
                        (0.0, 1), (0.0, 3), (0.0, 2), (1.0, 1), (0.0, 3),
                        (0.6, 3), (0.8, 4), (0.0, 8)):
        snaps.update(queue_depth=40, free_pages=10,
                     active_slots=int(4 * pressure))
        for _ in range(n):
            levels.append(bo.update(eng))
            eng.decode_steps += 1
    return levels, bo.timeline, (bo.escalations, bo.deescalations)


def test_controller_timeline_equals_jax():
    got = _controller_run(BrownoutController)
    assert got == _controller_run(jslo.BrownoutController)
    levels, timeline, (up, down) = got
    assert levels[:2] == [0, 1] and max(levels) == 3 and levels[-1] == 0
    assert up >= 3 and down >= 2 and len(timeline) == up + down
    assert all(abs(e["to"] - e["from"]) == 1 for e in timeline)


def test_controller_refusals_and_rebalance_as_jax():
    for Controller in (BrownoutController, jslo.BrownoutController):
        with pytest.raises(ValueError):
            Controller(enter=(0.9, 0.7, 0.5))
    assert [wants_rebalance(n) for n in range(4)] == \
        [jslo.wants_rebalance(n) for n in range(4)] == [False, False,
                                                        True, True]


# --------------------------------------------------------------------- #
# the engine's levels
# --------------------------------------------------------------------- #

class _FixedBrownout:
    """A controller pinned at one level: the engine's level effects,
    apart from the controller's dynamics."""

    def __init__(self, level):
        self.level = level
        self.escalations = 0
        self.deescalations = 0
        self.timeline = []

    def update(self, engine):
        return self.level


def test_level1_disables_speculation(models):
    _, tm = models
    rng = np.random.RandomState(10)
    eng = InferenceEngine(tm, num_slots=2, page_size=8, max_len=64,
                          spec_k=3, spec_patience=0,
                          brownout=_FixedBrownout(1))
    reqs = [Request(_prompt(rng, 6), max_new_tokens=8) for _ in range(3)]
    for r in reqs:
        eng.submit(r)
    _drain(eng, reqs)
    assert eng.drafted_tokens == 0 and eng.spec_steps == 0
    assert eng.verify_trace_count == 0 and eng.decode_trace_count == 1
    assert eng.health_snapshot()["brownout_level"] == 1


def test_level2_clamps_prefill_budget(models):
    _, tm = models
    rng = np.random.RandomState(11)
    eng = InferenceEngine(tm, num_slots=2, page_size=8, max_len=64,
                          chunk_pages=1, token_budget=32,
                          brownout=_FixedBrownout(2))
    reqs = [Request(_prompt(rng, 30), max_new_tokens=2) for _ in range(2)]
    for r in reqs:
        eng.submit(r)
    _drain(eng, reqs)
    assert eng.max_step_prefill_tokens <= 8       # one chunk, not 32
    assert set(eng.prefill_trace_counts.values()) == {1}


def test_level3_holds_batch_admissions(models):
    _, tm = models
    rng = np.random.RandomState(12)
    bo = _FixedBrownout(3)
    eng = InferenceEngine(tm, num_slots=2, page_size=8, max_len=64,
                          brownout=bo)
    rb = Request(_prompt(rng, 5), max_new_tokens=2, tier=Tier.BATCH)
    rs = Request(_prompt(rng, 5), max_new_tokens=2)
    eng.submit(rb)
    eng.submit(rs)
    for _ in range(60):
        eng.step()
    assert rs.outcome is not None and rs.outcome.ok
    assert rb.outcome is None and len(eng._queue) == 1
    bo.level = 0                                 # pressure clears
    _drain(eng, [rb])
    assert rb.outcome.ok


def test_level3_idle_head_is_shed_not_unservable(models):
    """A head queued only because level 3 holds its tier is SHED (come
    back later), not FAILED_UNSERVABLE, when the idle engine gives up
    on it."""
    _, tm = models
    eng = InferenceEngine(tm, num_slots=1, page_size=8, max_len=64,
                          brownout=_FixedBrownout(3), stall_steps=3)
    rb = Request(_prompt(np.random.RandomState(9), 5), max_new_tokens=2,
                 tier=Tier.BATCH)
    eng.run([rb], poll_sleep=1e-4)
    assert rb.outcome is Outcome.SHED and "brownout level 3" in rb.detail
    eng.audit_pages()


def test_closed_loop_escalates_and_recovers(models):
    """A backlog storm drives the real controller up; draining brings it
    back to level 0; every transition logged; one build a program."""
    _, tm = models
    rng = np.random.RandomState(13)
    bo = BrownoutController(up_steps=1, down_steps=2, delay_ref=0.05)
    eng = InferenceEngine(tm, num_slots=2, page_size=8, max_len=64,
                          num_pages=1 + 2 * 8, chunk_pages=1, brownout=bo,
                          spec_k=2)
    reqs = [Request(_prompt(rng, 12), max_new_tokens=8,
                    tier=[Tier.LATENCY, Tier.STANDARD, Tier.BATCH][i % 3])
            for i in range(9)]
    eng.run(reqs)
    assert all(r.outcome is not None for r in reqs)
    assert bo.escalations >= 1 and bo.deescalations >= 1
    assert bo.level == 0
    assert len(bo.timeline) == bo.escalations + bo.deescalations
    assert eng.decode_trace_count <= 1 and eng.verify_trace_count <= 1
    snap = eng.health_snapshot()
    assert snap["brownout_level"] == 0
    assert snap["brownout_escalations"] == bo.escalations
    assert snap["brownout_deescalations"] == bo.deescalations
    eng.audit_pages()


def test_clamp_cannot_sustain_itself(models):
    """A BATCH-only backlog on an otherwise idle engine does not hold
    level 3: the delay signal is the priority tiers' (the deadlock the
    JAX package found end to end)."""
    _, tm = models
    rng = np.random.RandomState(20)
    bo = BrownoutController(up_steps=1, down_steps=2, delay_ref=0.01)
    eng = InferenceEngine(tm, num_slots=2, page_size=8, max_len=64,
                          brownout=bo)
    eng._ewma_service_s = 50.0
    bo.level = 3
    rb = [Request(_prompt(rng, 5), max_new_tokens=2, tier=Tier.BATCH)
          for _ in range(4)]
    for r in rb:
        eng.submit(r)
    for _ in range(200):
        eng.step()
        if all(r.outcome is not None for r in rb):
            break
    assert all(r.outcome is not None and r.outcome.ok for r in rb)
    for _ in range(3 * bo.down_steps):
        eng.step()
    assert bo.level == 0
    eng.audit_pages()


# --------------------------------------------------------------------- #
# /metrics
# --------------------------------------------------------------------- #

_SAMPLE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)"
                     r"(\{[^}]*\})?\s([-+0-9.eE]+)$")


def _golden_parse(text):
    """Every sample line parses, and its name was declared by a preceding
    # TYPE line (a histogram's declaration covers its _bucket / _sum /
    _count samples)."""
    typed, samples = {}, []
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(" ")
            assert name not in typed, f"duplicate TYPE for {name}"
            typed[name] = mtype
            continue
        m = _SAMPLE.match(line)
        assert m, f"unparseable metrics line: {line!r}"
        name, labels, value = m.groups()
        if name not in typed:
            base = name.rsplit("_", 1)[0]
            assert name.rsplit("_", 1)[-1] in ("bucket", "sum", "count") \
                and typed.get(base) == "histogram", \
                f"sample before TYPE: {line!r}"
        samples.append((name, labels or "", float(value)))
    by = {}
    for name, labels, v in samples:
        by.setdefault(name, {})[labels] = v
    return typed, by


@pytest.fixture(scope="module")
def jax_snapshots(models, tmp_path_factory):
    """A JAX engine's snapshot (tiers, int8 pages, brownout) and a JAX
    two-replica router's, after some traffic."""
    jm, _ = models
    rng = np.random.RandomState(14)
    eng = JaxEngine(jm, num_slots=1, page_size=8, max_len=64, num_pages=7,
                    kv_quant="int8", brownout=True, max_queue=3,
                    kv_tiers={"dram_bytes": 128 << 10,
                              "disk_dir": str(tmp_path_factory.mktemp("m"))})
    heads = [_prompt(rng, 24) for _ in range(3)]
    for p in (0, 1, 2, 0):
        reqs = [JaxRequest(np.concatenate([heads[p], _prompt(rng, 5)]),
                           max_new_tokens=3,
                           tier=[JaxTier.LATENCY, JaxTier.BATCH][p % 2])]
        eng.run(reqs)
    rt = build_fleet(jm, 2, engine_kw=dict(num_slots=1, page_size=8,
                                           max_len=64))
    rt.run([JaxRequest(_prompt(rng, 5), max_new_tokens=3)
            for _ in range(3)])
    return eng.health_snapshot(), rt.health_snapshot()


def test_render_equals_jax_on_jax_snapshots(jax_snapshots):
    eng_snap, rt_snap = jax_snapshots
    assert eng_snap["tier_promotions"] > 0
    for snap in (eng_snap, rt_snap):
        text = render_metrics(snap)
        assert text == jmetrics.render_metrics(snap)
        _golden_parse(text)
    stats = {"http_requests": 7, "http_responses": {"200": 5, "429": 2},
             "disconnects": 1, "slow_reader_cancels": 0, "sse_tokens": 40,
             "open_streams": 1}
    assert render_frontend_metrics(stats) == \
        jmetrics.render_frontend_metrics(stats)


def test_metrics_golden_on_the_port_engine(models, jax_snapshots,
                                           tmp_path):
    """The port engine's own snapshot (tiers, int8 pages, brownout)
    renders, parses back to its numbers, and carries the JAX engine's
    keys."""
    _, tm = models
    rng = np.random.RandomState(14)
    eng = InferenceEngine(tm, num_slots=1, page_size=8, max_len=64,
                          num_pages=7, kv_quant="int8", brownout=True,
                          max_queue=3,
                          kv_tiers={"dram_bytes": 128 << 10,
                                    "disk_dir": str(tmp_path)})
    heads = [_prompt(rng, 24) for _ in range(3)]
    for p in (0, 1, 2, 0):
        reqs = [Request(np.concatenate([heads[p], _prompt(rng, 5)]),
                        max_new_tokens=3,
                        tier=[Tier.LATENCY, Tier.BATCH][p % 2])]
        eng.run(reqs)
        eng.audit_pages()
    snap = eng.health_snapshot()
    assert set(snap) == set(jax_snapshots[0])
    typed, by = _golden_parse(render_metrics(snap))
    assert sum(by["mxtpu_serve_requests_total"].values()) == 4
    assert typed["mxtpu_serve_kv_tier_bytes"] == "gauge"
    for tier in ("dram", "disk"):
        assert by["mxtpu_serve_kv_tier_bytes"][f'{{tier="{tier}"}}'] == \
            snap["kv_tier_bytes"][tier]
    for key, metric in (
            ("tier_demotions", "kv_tier_demotions_total"),
            ("tier_promotions", "kv_tier_promotions_total"),
            ("tier_hits", "kv_tier_hits_total"),
            ("tier_misses", "kv_tier_misses_total"),
            ("tier_crc_fallbacks", "kv_tier_crc_fallbacks_total"),
            ("migrated_out_pages", "kv_migrated_out_pages_total"),
            ("brownout_escalations", "brownout_escalations_total")):
        assert typed[f"mxtpu_serve_{metric}"] == "counter"
        assert by[f"mxtpu_serve_{metric}"][""] == snap[key], metric
    assert snap["tier_promotions"] > 0
    assert by["mxtpu_serve_brownout_level"][""] == snap["brownout_level"]
    assert by["mxtpu_serve_kv_pool_bytes"][""] == snap["kv_pool_bytes"]
    (labels, v), = by["mxtpu_serve_kv_pool_info"].items()
    assert v == 1.0 and 'dtype="int8"' in labels and 'quant="int8"' in labels
    assert "NaN" not in render_metrics(snap)
