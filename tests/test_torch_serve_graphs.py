"""The serving engine's programs as CUDA graphs, on the card.

A small GPT at D = 64 (the ragged kernels' tensor-core bodies), bf16, on
raw and int8 pools. Each case skips without a CUDA device. Held here,
for the decode / verify step programs and for the prefill chunk
program: a graph replay equals the uncaptured body bitwise (outputs,
amax and every pool byte outside the null page); building a program
(its warm-up and its capture; the dense and chunk prefill programs and
the COW copy included) leaves every pool byte outside page 0 and the
host amax as they were; ``LAUNCHES`` rises per replay by exactly the
graph's launches; a mixed run with stalls, a quarantine, temperature
and speculation captures each width once, and a run with a COW prefix
hit each (kind, bucket) once, every chunked-prefill launch coming from
a replay; the device draw's bits equal the CPU's. This file imports no
JAX, so ``chip_smoke.py`` runs it with ``pytest --noconftest -m
cuda``."""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.models.gpt import GPTModel
from incubator_mxnet_tpu_torch.ops import LAUNCHES
from incubator_mxnet_tpu_torch.serve import InferenceEngine, Outcome, Request
from incubator_mxnet_tpu_torch.serve.sampling import (ACCEPT_STREAM,
                                                      DRAW_STREAM,
                                                      draw_uniform)

V = 512
QUANTS = [None, "int8"]


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the ragged kernels)")
    mx.random.seed(0)
    m = GPTModel(vocab_size=V, units=256, hidden_size=1024, num_layers=2,
                 num_heads=4, max_length=256, dtype="bfloat16")
    m.initialize(ctx="cuda")
    return m


class _Drafter:
    """Proposes ``k`` copies of the last token while ``on``."""

    def __init__(self, on=True):
        self.on = on

    def __call__(self, history, k):
        n = k if self.on else 0
        return np.full((n,), int(history[-1]), np.int32)


def _engine(model, quant, drafter=None, **kw):
    kw = dict(dict(num_slots=4, page_size=16, max_len=256, spec_k=3,
                   kv_quant=quant, draft_fn=drafter or _Drafter()), **kw)
    return InferenceEngine(model, **kw)


def _requests(n=4, seed=0, new=40):
    rng = np.random.RandomState(seed)
    return [Request(rng.randint(0, V, size=int(t)), max_new_tokens=new,
                    temperature=0.0 if i % 2 == 0 else 0.9, seed=i)
            for i, t in enumerate(rng.randint(20, 60, size=n))]


def _submit(eng, n=4, seed=0, new=40):
    reqs = _requests(n, seed, new)
    for r in reqs:
        eng.submit(r)
    return reqs


def _pools(eng):
    return [p.clone() for p in eng._kpools + eng._vpools]


def _bytes(t):
    return t.contiguous().view(torch.uint8)


def _same_outside_null_page(a, b):
    return all(torch.equal(_bytes(x[1:]), _bytes(y[1:]))
               for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", QUANTS)
def test_cuda_replay_equals_the_body_bitwise(model, quant):
    drafter = _Drafter()
    eng = _engine(model, quant, drafter)
    reqs = _submit(eng)
    for i in range(4):                       # both widths built
        drafter.on = i % 2 == 0
        eng.step()
    assert set(eng._programs) == {1, 4}
    live = [s for s, sl in enumerate(eng._slots) if sl is not None]
    assert live
    for W, prog in eng._programs.items():
        toks = np.zeros((eng.num_slots, W), np.int64)
        for s in live:
            toks[s] = eng._slots[s].request.token_ids[-1]
        dl = np.full((eng.num_slots,), W - 1, np.int32)
        eng._stage_step(prog, toks, dl, [])
        before = _pools(eng)
        prog.launch()
        replay = {k: v.copy() for k, v in prog.read().items()}
        after_replay = _pools(eng)
        for p, b in zip(eng._kpools + eng._vpools, before):
            p.copy_(b)
        prog.inp.dev_bytes.copy_(prog.inp.host_bytes)
        prog.run_body()
        torch.cuda.synchronize()
        for k, v in replay.items():
            body = prog.out.dev[k].cpu().numpy()
            assert (body.view(np.uint8) == v.view(np.uint8)).all(), k
        assert _same_outside_null_page(_pools(eng), after_replay)
        assert (replay["n_emit"][live] >= 1).all()
    del reqs


@pytest.mark.cuda
@pytest.mark.parametrize("quant", QUANTS)
def test_cuda_build_leaves_live_pages_and_amax_untouched(model, quant):
    drafter = _Drafter(on=False)
    eng = _engine(model, quant, drafter)
    _submit(eng, seed=1)
    for _ in range(3):
        eng.step()
    assert set(eng._programs) == {1}
    pools = _pools(eng)
    amax = [a.copy() for a in eng._kamax + eng._vamax]
    eng._program(eng.spec_k + 1)
    torch.cuda.synchronize()
    assert eng.verify_trace_count == 1
    assert eng._programs[eng.spec_k + 1].build_ms > 0
    assert _same_outside_null_page(_pools(eng), pools)
    for a, b in zip(eng._kamax + eng._vamax, amax):
        assert (a.view(np.uint32) == b.view(np.uint32)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", QUANTS)
def test_cuda_launches_rise_by_the_graphs_launches(model, quant):
    drafter = _Drafter()
    eng = _engine(model, quant, drafter)
    _submit(eng, seed=2)
    sfx = "_q" if quant else ""
    L = model.num_layers
    for W, kernel in ((4, "ragged_verify"), (1, "ragged_decode")):
        drafter.on = W > 1
        eng.step()                           # builds the width
        prog = eng._programs[W]
        assert prog.launches == {kernel + sfx: L}
        for _ in range(2):
            before = dict(LAUNCHES)
            eng.step()
            delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                     if LAUNCHES[k] != before[k]}
            assert delta == prog.launches
    assert (eng.decode_trace_count, eng.verify_trace_count) == (1, 1)


@pytest.mark.cuda
def test_cuda_mixed_run_with_stalls_and_a_quarantine_captures_once(model):
    drafter = _Drafter()
    eng = _engine(model, "int8", drafter, page_size=8, prefix_cache=False)
    reqs = _requests(n=6, seed=3, new=48)
    victim = reqs[0]
    stalls = []

    def before(e, i):
        drafter.on = i % 3 != 0
        if i == 4:
            e._alloc.hold(e._alloc.free_count)
        if i == 10:
            e._alloc.release_held()
        slot = next((s for s in e._slots
                     if s is not None and s.request is victim), None)
        if i == 2 and slot is not None and not slot.prefilling:
            e._kamax[0][slot.refs[0]] = np.nan   # its page scale goes NaN

    def after(e, i):
        stalls.append(max((s.stall_count for s in e._slots
                           if s is not None), default=0))

    eng.run(reqs, before_step=before, after_step=after)
    eng.audit_pages()
    assert max(stalls) > 0
    assert victim.outcome is Outcome.FAILED_NONFINITE
    assert all(r.outcome.ok for r in reqs[1:])
    assert eng.quarantined == 1 and eng.spec_steps > 0
    assert (eng.decode_trace_count, eng.verify_trace_count) == (1, 1)


def _prefilling(eng):
    return next(s for s, sl in enumerate(eng._slots)
                if sl is not None and sl.prefilling)


def _chunk_engine(model, quant, prompt=150):
    """An engine of 32-token chunks with one 150-token request past its
    first chunk; returns it and the prefilling slot."""
    eng = _engine(model, quant, chunk_pages=2)
    rng = np.random.RandomState(5)
    eng.submit(Request(rng.randint(0, V, size=prompt), max_new_tokens=4,
                       temperature=0.9, seed=7))
    eng.step()                               # admission, the first chunk
    return eng, _prefilling(eng)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", QUANTS)
def test_cuda_chunk_replay_equals_the_body_bitwise(model, quant):
    eng, s = _chunk_engine(model, quant)
    prog = eng._stage_chunk(s, eng._slots[s].prefill_pos, 32)
    assert prog.built and eng.prefill_trace_counts == {("chunk", 32): 1}
    before = _pools(eng)
    prog.launch()
    replay = {k: v.copy() for k, v in prog.read().items()}
    after_replay = _pools(eng)
    for p, b in zip(eng._kpools + eng._vpools, before):
        p.copy_(b)
    prog.inp.dev_bytes.copy_(prog.inp.host_bytes)
    prog.run_body()
    torch.cuda.synchronize()
    for k, v in replay.items():
        body = prog.out.dev[k].cpu().numpy()
        assert (body.view(np.uint8) == v.view(np.uint8)).all(), k
    assert _same_outside_null_page(_pools(eng), after_replay)
    assert 0 <= replay["tok"][0] < V


@pytest.mark.cuda
@pytest.mark.parametrize("quant", QUANTS)
def test_cuda_prefill_builds_leave_live_pages_and_amax_untouched(model,
                                                                 quant):
    eng = _engine(model, quant, _Drafter(on=False), chunk_pages=2)
    _submit(eng, seed=1)
    for _ in range(4):
        eng.step()
    built = dict(eng.prefill_trace_counts)
    assert built and eng.copy_trace_count == 0
    pools = _pools(eng)
    amax = [a.copy() for a in eng._kamax + eng._vamax]
    new = [("chunk", 128), ("dense", 64)]
    assert not set(new) & set(built)
    progs = [eng._prefill_program(kind, T) for kind, T in new]
    progs.append(eng._copy_program())
    torch.cuda.synchronize()
    assert eng.prefill_trace_counts == {**built, **{k: 1 for k in new}}
    assert eng.prefill_trace_count == len(built) + 2
    assert eng.copy_trace_count == 1
    assert all(p.build_ms > 0 and p.replays == 0 for p in progs)
    assert _same_outside_null_page(_pools(eng), pools)
    for a, b in zip(eng._kamax + eng._vamax, amax):
        assert (a.view(np.uint32) == b.view(np.uint32)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", QUANTS)
def test_cuda_prefill_launches_rise_by_the_graphs_launches(model, quant):
    eng, s = _chunk_engine(model, quant)
    sfx = "_q" if quant else ""
    prog = eng._stage_chunk(s, eng._slots[s].prefill_pos, 32)
    assert prog.launches == {"ragged_prefill" + sfx: model.num_layers}
    for _ in range(2):
        before, r0 = dict(LAUNCHES), prog.replays
        prog.run()
        delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                 if LAUNCHES[k] != before[k]}
        assert delta == prog.launches and prog.replays == r0 + 1
    # the dense prompt program attends densely; the copy launches no
    # ragged kernel either
    assert eng._prefill_program("dense", 32).launches == {}
    assert eng._copy_program().launches == {}


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_pages", [2, None])
def test_cuda_mixed_run_with_a_cow_hit_captures_each_bucket_once(
        model, chunk_pages):
    """A prompt of 100 tokens (6 full pages of 16 cached), its first 90
    tokens (a COW copy of the boundary page, then a 1-token suffix
    chunk), itself again (a 4-token suffix chunk) and four others, on
    int8 pools, chunked and monolithic: one build per (kind, bucket),
    one COW copy program, and every chunked-prefill launch from a
    replay."""
    eng = _engine(model, "int8", chunk_pages=chunk_pages)
    rng = np.random.RandomState(9)
    a = rng.randint(0, V, size=100)
    reqs = [Request(a, max_new_tokens=12)] + _requests(n=4, seed=4,
                                                       new=24)
    reqs += [Request(a[:90], max_new_tokens=12, temperature=0.9, seed=3),
             Request(a.copy(), max_new_tokens=12)]
    before = dict(LAUNCHES)
    eng.run(reqs)
    eng.audit_pages()
    assert all(r.outcome.ok for r in reqs)
    assert eng.prefix_hits >= 2 and eng.copy_trace_count == 1
    counts = eng.prefill_trace_counts
    assert set(counts.values()) == {1}
    assert eng.prefill_trace_count == len(counts)
    kinds = {k for k, _ in counts}
    assert kinds == ({"chunk"} if chunk_pages else {"dense", "chunk"})
    assert max(eng.decode_trace_count, eng.verify_trace_count) == 1
    chunk_replays = sum(p.replays for (k, _), p in
                        eng._prefill_programs.items() if k == "chunk")
    assert chunk_replays > 0
    assert LAUNCHES["ragged_prefill_q"] - before["ragged_prefill_q"] == \
        model.num_layers * chunk_replays


@pytest.mark.cuda
def test_cuda_draw_bits_equal_the_cpu(model):
    keys = torch.tensor([0, -1, 2 ** 62 + 12345, -2 ** 63]
                        + list(range(1000, 1060)))[:, None]
    pos = torch.arange(0, 4096, 37)[None, :]
    for stream in (DRAW_STREAM, ACCEPT_STREAM):
        cpu = draw_uniform(keys, pos, stream)
        card = draw_uniform(keys.cuda(), pos.cuda(), stream).cpu()
        assert torch.equal(cpu.view(torch.int32), card.view(torch.int32))
