"""The serving engine's page programs as CUDA graphs, on the card: the
gather (tier demotion, page capture) and the promotion (tier
re-admission, slot install), and ``warm_start`` under captured graphs.

A small GPT at D = 64 (the ragged kernels' tensor-core bodies), bf16,
on raw bf16, int8 and fp8_e4m3 pools. Each case skips without a CUDA
device. Held here: one capture each for the gather and the promotion
over a tiered workload, whose greedy streams equal an always-resident
engine's (every promoted page is read by the next decode and chunk
replays); a gather right after a decode replay returns the row that
replay wrote; two gathers in a row leave the first payload intact; bf16
and float8 payloads come back bitwise through the DRAM and the disk
tier; a promotion on the card writes the bytes the plain CPU path
writes; ``warm_start`` is seen by the next replays with no new capture.
This file imports no JAX, so ``chip_smoke.py`` runs it with ``pytest
--noconftest -m cuda``."""

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.models.gpt import GPTModel
from incubator_mxnet_tpu_torch.serve import (InferenceEngine, KVTierStore,
                                             Request)
from incubator_mxnet_tpu_torch.serve.paged_kv import _raw

V = 512
PS = 16
QUANTS = [None, "int8", "fp8_e4m3"]


def _model(device, seed=0):
    return GPTModel(vocab_size=V, units=256, hidden_size=1024, num_layers=2,
                    num_heads=4, max_length=256, dtype="bfloat16",
                    device=device, seed=seed)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the ragged kernels)")
    return _model("cuda")


def _personas(n, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, size=(3 * PS,)).astype(np.int32)
            for _ in range(n)]


def _drive(eng, heads, order=(0, 1, 2, 0, 1, 2, 3, 0)):
    srng = np.random.RandomState(11)
    toks = []
    for p in order:
        tail = srng.randint(0, V, size=(5,)).astype(np.int32)
        req = Request(np.concatenate([heads[p], tail]), max_new_tokens=4)
        eng.run([req], poll_sleep=1e-4,
                before_step=lambda e, _i: e.audit_pages())
        assert req.outcome is not None and req.outcome.ok
        toks.append(list(req.token_ids))
    eng.audit_pages()
    return toks


def _engine(model, quant, tiers=None, num_pages=7, **kw):
    return InferenceEngine(model, num_slots=1, page_size=PS,
                           num_pages=num_pages, max_len=256,
                           prefix_cache=True, kv_quant=quant,
                           kv_tiers=tiers, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", QUANTS)
def test_cuda_tiers_promote_through_one_capture_each(model, quant,
                                                     tmp_path):
    """Promoted pages feed the next replays: the tiered streams equal an
    always-resident engine's; the gather and the promotion are captured
    once each and replayed for every page."""
    heads = _personas(4)
    page_bytes = 2 * 2 * 4 * PS * 64 * (2 if quant is None else 1)
    # DRAM holds three pages: the rest of the demotions spill to disk
    eng = _engine(model, quant, {"dram_bytes": 3 * page_bytes,
                                 "disk_dir": str(tmp_path)})
    got = _drive(eng, heads)
    want = _drive(_engine(model, quant, num_pages=64), heads)
    assert got == want
    snap = eng.health_snapshot()
    assert snap["tier_promotions"] > 0 and snap["tier_demotions"] > 0
    assert snap["tier_disk_demotions"] > 0
    assert snap["tier_crc_fallbacks"] == 0 and eng._tiers.crc_failures == 0
    assert eng.promote_trace_count == eng.demote_trace_count == 1
    for prog in (eng._gather_prog, eng._promote_prog):
        assert prog._graph is not None and prog.replays > 0
    assert eng._promote_prog.replays == snap["tier_promotions"]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", QUANTS)
def test_cuda_gather_after_a_decode_replay_sees_its_row(model, quant):
    """A gather replayed right after a decode replay returns the pool as
    that replay left it (the same stream, no stale read), and two
    gathers in a row leave the first payload intact."""
    eng = _engine(model, quant, num_pages=16)
    req = Request(np.arange(40, dtype=np.int32) % V, max_new_tokens=8)
    eng.submit(req)
    while len(req.token_ids) < 4:
        eng.step()
    row = eng.capture_slot(req.request_id)["pages"]
    tail = row[-1]
    k, v, _ka, _va = eng.gather_page(tail)
    torch.cuda.synchronize()
    for arr, pool in zip(k + v, eng._kpools + eng._vpools):
        want = _raw(pool)[tail].cpu().numpy()
        assert np.array_equal(arr.view(np.uint8), want.view(np.uint8))
    kept = [a.copy() for a in k]
    other = eng.gather_page(row[0])
    assert not np.array_equal(other[0][0], kept[0])
    for a, b in zip(k, kept):
        np.testing.assert_array_equal(a, b)
    assert eng.demote_trace_count == 1 and eng._gather_prog.replays == 2


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "fp8_e4m3"])
def test_cuda_payload_bits_through_dram_and_disk(model, quant, tmp_path):
    """A bf16 / fp8 page gathered on the card, put through the DRAM tier
    and through the disk tier (the manifest, under the dtype's name),
    promoted into another page: the page's bytes come back bitwise."""
    eng = _engine(model, quant, num_pages=16)
    req = Request(np.arange(40, dtype=np.int32) % V, max_new_tokens=4)
    eng.run([req])
    page = eng._prefix.held_pages()[0]
    payload = eng.gather_page(page)
    name = str(eng._kpools[0].dtype).replace("torch.", "")
    for dram in (1 << 30, 0):
        store = KVTierStore(PS, dram, disk_dir=str(tmp_path / str(dram)),
                            kv_dtype=name)
        key = b"k"
        assert store.put(key, np.zeros(PS, np.int32), 0, *payload)
        (_k, ent), = store.entries()
        assert ent.tier == ("dram" if dram else "disk")
        back = store.load(key, ent)
        dst = eng._alloc.alloc()
        eng._promote_page(*back, dst)
        for pool in eng._kpools + eng._vpools:
            assert torch.equal(_raw(pool)[dst], _raw(pool)[page])
        for a in eng._kamax + eng._vamax:
            assert a[dst] == a[page]
        eng._alloc.decref(dst)
    assert eng.promote_trace_count == 1
    eng.audit_pages()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", QUANTS)
def test_cuda_promote_equals_the_cpu_path(model, quant):
    """The same payload promoted into the same page by a card engine (a
    graph replay) and by a CPU engine (the body run eagerly) leaves the
    same pool bytes, and gathers back the same payload."""
    cpu_model = _model("cpu")
    cpu_model.load_state_dict(model.state_dict())
    engines = [_engine(m, quant, num_pages=8) for m in (model, cpu_model)]
    rng = np.random.RandomState(3)
    shape = (len(engines[0]._kpools),) + tuple(engines[0]._kpools[0]
                                               .shape[1:])
    if quant is None:       # bf16 bits of finite values
        bits = (rng.randn(*shape).astype(np.float32).view(np.uint32)
                >> 16).astype(np.uint16)
    else:
        bits = rng.randint(0, 256, size=shape).astype(np.uint8).view(
            np.int8 if quant == "int8" else np.uint8)
    k, v = tuple(bits), tuple(bits[::-1].copy())
    amax = (np.full(shape[0], 2.5, np.float32),) * 2 if quant else \
        (None, None)
    got = []
    for eng in engines:
        eng._promote_page(k, v, *amax, 5)
        got.append([_raw(p)[5].cpu() for p in eng._kpools + eng._vpools])
        back = eng.gather_page(5)
        for a, b in zip(back[0] + back[1], k + v):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(*got):
        assert torch.equal(a, b)
    assert engines[0]._promote_prog._graph is not None
    assert engines[1]._promote_prog._graph is None


@pytest.mark.cuda
def test_cuda_warm_start_is_seen_by_the_next_replays(model):
    """Serve (the graphs are captured), warm start another model's
    weights, serve again: the streams equal a fresh engine's on those
    weights, with no new capture."""
    live = _model("cuda")
    live.load_state_dict(model.state_dict())
    other = _model("cuda", seed=1)
    prompt = np.arange(7, 60, dtype=np.int32)
    eng = _engine(live, None, num_pages=32)
    first = Request(prompt, max_new_tokens=12)
    eng.run([first])
    builds = (eng.decode_trace_count, dict(eng.prefill_trace_counts))
    eng.warm_start(params=other.state_dict())
    second = Request(prompt, max_new_tokens=12)
    eng.run([second])
    fresh = Request(prompt, max_new_tokens=12)
    _engine(other, None, num_pages=32).run([fresh])
    assert second.token_ids == fresh.token_ids != first.token_ids
    assert (eng.decode_trace_count, dict(eng.prefill_trace_counts)) == \
        builds
    assert eng._programs[1].replays > 0
    eng.audit_pages()


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 5])
def test_cuda_draw_is_the_same_in_every_slot(model, W):
    """One row of logits (V = 50257, whose rows start at different
    alignments) placed in each row of an (8, W, V) batch, the rest
    random: the inverse-CDF draw and the log-softmax the acceptance reads
    are bitwise the same in every row, so a request's temperature stream
    does not depend on the slot it holds (a transported slot lands in
    another slot)."""
    from incubator_mxnet_tpu_torch.serve.sampling import (row_aligned,
                                                          sample_inverse_cdf)
    V, S = 50257, 8
    gen = torch.Generator(device="cuda").manual_seed(0)
    row = torch.randn(V, device="cuda", generator=gen) * 0.7
    u = torch.rand(64, device="cuda", generator=gen)
    draws, logps = [], []
    for s in range(S):
        x = torch.randn(S, W, V, device="cuda", generator=gen)
        x[s, 0] = row
        draws.append(torch.stack([sample_inverse_cdf(
            x, torch.full((S, W), float(v), device="cuda"))[s, 0]
            for v in u]))
        logps.append(torch.log_softmax(row_aligned(x), dim=-1)[s, 0, :V])
    for d, lp in zip(draws[1:], logps[1:]):
        assert torch.equal(d, draws[0]) and torch.equal(lp, logps[0])


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 5])
def test_cuda_top_p_draw_is_the_same_in_every_slot(model, W):
    """One row with top-p 0.9 and top-k 40 (T = 0.8) placed in each of 8
    slots of an (8, W, 50257) batch, the rest random: the constrained row
    (the top-p normalizer and cumsum run over row-aligned rows) and the
    inverse-CDF draw from it are bitwise the same in every slot."""
    from incubator_mxnet_tpu_torch.serve.sampling import (constrain_logits,
                                                          sample_inverse_cdf)
    V, S = 50257, 8
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    row = torch.randn(V, device=dev, generator=gen) * 2.0
    u = torch.rand(64, device=dev, generator=gen)
    full = lambda v, dt=torch.float32: torch.full(  # noqa: E731
        (S, W), v, dtype=dt, device=dev)
    menu = dict(counts=torch.zeros(S, W, V, dtype=torch.int32, device=dev),
                bias=torch.zeros(S, W, V, device=dev),
                mask=torch.ones(S, W, V, dtype=torch.bool, device=dev),
                top_k=full(40, torch.int32), top_p=full(0.9),
                rep_pen=full(1.0), pres_pen=full(0.0))
    temps = full(0.8)
    rows, draws = [], []
    for s in range(S):
        x = torch.randn(S, W, V, device=dev, generator=gen)
        x[s, 0] = row
        c = constrain_logits(x, temps, **menu)
        rows.append(c[s, 0].clone())
        scaled = c / 0.8
        draws.append(torch.stack([sample_inverse_cdf(
            scaled, torch.full((S, W), float(v), device=dev))[s, 0]
            for v in u]))
    kept = int((rows[0] > -1e29).sum())
    assert 1 < kept <= 40
    for r, d in zip(rows[1:], draws[1:]):
        assert torch.equal(r, rows[0]) and torch.equal(d, draws[0])
