"""Speculative decoding in the PyTorch port against the JAX package.

``gpt_mini(vocab_size=64, max_length=64)`` is initialized in the JAX
package and its weights go across into the port (the same workloads as
tests/test_spec_decode.py). Held against the JAX engine on the CPU:
greedy speculative streams, outcomes and the speculation counters
(drafted / accepted tokens, speculative and decode steps) — monolithic
and chunked prefill, cold and warm (prefix-cache hits), and the sampling
menu; the n-gram drafter on random histories. Held inside the port:
greedy speculation equals plain decode and ``cached_generate``; oracle
and wrong drafters give the step compression and the 1-token floor with
gating; temperature draws are reproducible and occupancy-independent;
rejection sampling keeps the target distribution (chi-square); a
non-finite verify step records nothing; a draft window across page
boundaries survives a tiny pool. Temperature streams use different
generators in the two frameworks, so only greedy is compared with
JAX."""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.models import gpt as jg
from incubator_mxnet_tpu.serve import InferenceEngine as JaxEngine
from incubator_mxnet_tpu.serve import Request as JaxRequest
from incubator_mxnet_tpu.serve import SamplingParams as JaxSampling
from incubator_mxnet_tpu.serve import choice_grammar as jax_choice
from incubator_mxnet_tpu.serve import ngram_propose as jax_ngram

from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models import gpt as tg
from incubator_mxnet_tpu_torch.serve import (InferenceEngine, Outcome,
                                             Request, SamplingParams,
                                             choice_grammar, ngram_propose)

from test_torch_parity import cpu_gpt, port_gpt

V = 64
COUNTERS = ("drafted_tokens", "accepted_tokens", "spec_steps",
            "spec_gated_steps", "decode_steps", "prefix_hits")


@pytest.fixture(scope="module")
def models():
    jmx.random.seed(0)
    jm = jg.gpt_mini(vocab_size=V, max_length=64)
    jm.initialize()
    tm = port_gpt(jm, vocab_size=V, max_length=64)
    return jm, tm


@pytest.fixture(scope="module")
def engine_pairs(models):
    """One (JAX, port) speculative engine pair per prefill mode, built on
    first use and shared by the tests of this file (a JAX engine
    compiles its programs once)."""
    jm, tm = models
    pairs = {}

    def get(mode):
        if mode not in pairs:
            kw = dict(num_slots=3, page_size=8, max_len=64, num_pages=24,
                      spec_k=3, **MODES[mode])
            pairs[mode] = (JaxEngine(jm, **kw), InferenceEngine(tm, **kw))
        return pairs[mode]

    return get


MODES = {"monolithic": {}, "chunk1": dict(chunk_pages=1),
         "chunk2": dict(chunk_pages=2)}


def _repetitive_prompts(rng):
    """Prompts with recurring n-grams (drafting fires), plain random ones
    (it mostly does not), and one sharing the first's 16-token prefix."""
    base = rng.randint(0, V, size=(6,)).astype(np.int32)
    first = np.concatenate([base, base, base[:3]])
    return [first, rng.randint(0, V, size=(9,)).astype(np.int32),
            np.concatenate([base, base]),
            rng.randint(0, V, size=(17,)).astype(np.int32),
            np.concatenate([first[:16],
                            rng.randint(0, V, size=(4,)).astype(np.int32)])]


def _serve_both(pair, specs):
    """The same request specs through both engines (``sampling`` given
    as the SamplingParams keyword dict)."""
    je, te = pair

    def build(cls, params):
        return [cls(**{k: params(**v) if k == "sampling" else v
                       for k, v in s.items()}) for s in specs]

    jr = build(JaxRequest, JaxSampling)
    tr = build(Request, SamplingParams)
    je.run(jr)
    te.run(tr)
    je.audit_pages()
    te.audit_pages()
    return jr, tr


def _reference(tm, prompt, max_new):
    return tg.cached_generate(tm, torch.tensor(prompt[None]),
                              max_new_tokens=max_new)[0, prompt.size:] \
        .tolist()


def _oracle_drafter(tm, prompts, max_new, wrong=False):
    """Proposes each request's true greedy continuation (or, ``wrong``,
    the true token + 1, always rejected)."""
    table = [(p, _reference(tm, p, mn)) for p, mn in zip(prompts, max_new)]

    def draft(history, k):
        h = np.asarray(history, np.int32)
        for prompt, ref in table:
            t0 = prompt.size
            if h.size < t0 or not np.array_equal(h[:t0], prompt):
                continue
            e = h.size - t0
            if list(h[t0:]) != ref[:e]:
                continue
            d = np.asarray(ref[e:e + k], np.int32)
            return (d + 1) % V if wrong else d
        return np.zeros((0,), np.int32)

    return draft


@pytest.mark.parametrize("mode", list(MODES))
def test_spec_greedy_streams_and_counters_match_jax(models, engine_pairs,
                                                    mode):
    """Cold then warm (prefix hits): equal greedy streams, outcomes and
    speculation counters."""
    rng = np.random.RandomState(7)
    specs = [dict(prompt_ids=p, max_new_tokens=n, eos_id=e)
             for p, n, e in zip(_repetitive_prompts(rng),
                                (14, 10, 12, 8, 9), (-1, 7, -1, -1, 3))]
    pair = engine_pairs(mode)
    for tag in ("cold", "warm"):
        jr, tr = _serve_both(pair, specs)
        for a, b in zip(jr, tr):
            assert b.token_ids == a.token_ids, tag
            assert b.outcome.value == a.outcome.value, tag
            assert (b.drafted_tokens, b.accepted_tokens) == \
                (a.drafted_tokens, a.accepted_tokens), tag
    je, te = pair
    for c in COUNTERS:
        assert getattr(te, c) == getattr(je, c), c
    assert te.prefix_hits > 0 and te.spec_steps > 0
    assert 0 < te.accepted_tokens <= te.drafted_tokens
    assert te.health_snapshot()["accept_rate"] == je.accept_rate


def test_sampling_menu_greedy_under_speculation_matches_jax(engine_pairs):
    """Greedy requests with penalties, bias, top-k and a grammar, served
    speculatively: streams equal the JAX engine's (penalty counts inside
    the window, grammar-truncated drafts and per-column masks)."""
    rng = np.random.RandomState(9)
    base = rng.randint(0, V, size=(5,)).astype(np.int32)
    menus = [dict(top_k=5, repetition_penalty=1.3),
             dict(presence_penalty=0.7, logit_bias={3: 2.0, 9: -5.0}),
             dict(top_k=3)]
    specs = [dict(prompt_ids=np.concatenate([base, base, base]),
                  max_new_tokens=10, sampling=m) for m in menus]
    seqs = [[5, 6, 5, 6, 5, 6], [5, 9, 5, 9]]
    je, te = pair = engine_pairs("chunk2")
    jr, tr = _serve_both(pair, specs)
    jg_req = JaxRequest(np.concatenate([base, base]), max_new_tokens=10,
                        eos_id=1, sampling=JaxSampling(
                            grammar=jax_choice(seqs, V)))
    tg_req = Request(np.concatenate([base, base]), max_new_tokens=10,
                     eos_id=1, sampling=SamplingParams(
                         grammar=choice_grammar(seqs, V)))
    je.run([jg_req])
    te.run([tg_req])
    for a, b in zip(jr + [jg_req], tr + [tg_req]):
        assert b.token_ids == a.token_ids
        assert b.outcome.value == a.outcome.value
        assert b.drafted_tokens == a.drafted_tokens
    assert tg_req.token_ids[:-1] in seqs and tg_req.token_ids[-1] == 1
    te.audit_pages()


def test_spec_equals_plain_engine_and_cached_generate(models):
    """Greedy speculation emits exactly the plain engine's and the
    dense-cache reference's tokens; engine counters are the sums of the
    per-request ones."""
    _, tm = models
    rng = np.random.RandomState(8)
    prompts = _repetitive_prompts(rng)
    news = (14, 10, 12, 8, 9)
    outs = []
    for spec_k in (0, 3):
        eng = InferenceEngine(tm, num_slots=3, page_size=8, max_len=64,
                              num_pages=20, spec_k=spec_k, chunk_pages=1,
                              token_budget=16)
        reqs = [Request(p, max_new_tokens=n) for p, n in zip(prompts, news)]
        eng.run(reqs, after_step=lambda e, i: e.audit_pages())
        outs.append([r.token_ids for r in reqs])
        assert eng.drafted_tokens == sum(r.drafted_tokens for r in reqs)
        assert eng.accepted_tokens == sum(r.accepted_tokens for r in reqs)
    assert outs[0] == outs[1]
    assert eng.accepted_tokens > 0
    for p, n, toks in zip(prompts, news, outs[1]):
        assert toks == _reference(tm, p, n)


def test_oracle_drafter_compresses_steps_and_eos_truncates(models):
    _, tm = models
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, V, size=(8,)).astype(np.int32),
               rng.randint(0, V, size=(11,)).astype(np.int32)]
    news = (12, 12)
    refs = [_reference(tm, p, n) for p, n in zip(prompts, news)]
    K = 3
    eng = InferenceEngine(tm, num_slots=1, page_size=8, max_len=64,
                          num_pages=16, spec_k=K,
                          draft_fn=_oracle_drafter(tm, prompts, news),
                          prefix_cache=False)
    r0 = Request(prompts[0], max_new_tokens=news[0])
    eng.run([r0])
    assert r0.token_ids == refs[0]
    assert eng.accept_rate == 1.0
    assert eng.decode_steps == -(-(news[0] - 1) // (K + 1))   # 4 + 4 + 3
    eos_pos = next(j for j in range(1, len(refs[1]))
                   if refs[1][j] not in refs[1][:j])
    r1 = Request(prompts[1], max_new_tokens=news[1],
                 eos_id=refs[1][eos_pos])
    eng.run([r1])
    assert r1.token_ids == refs[1][:eos_pos + 1]
    assert r1.outcome is Outcome.EOS
    assert 0 < r1.accepted_tokens <= r1.drafted_tokens
    eng.audit_pages()


def test_wrong_drafter_degrades_to_one_token_per_step_and_gates(models):
    _, tm = models
    prompt = np.random.RandomState(10).randint(0, V, size=(8,)) \
        .astype(np.int32)
    eng = InferenceEngine(tm, num_slots=1, page_size=8, max_len=64,
                          num_pages=16, spec_k=3, prefix_cache=False,
                          draft_fn=_oracle_drafter(tm, [prompt], [12],
                                                   wrong=True))
    req = Request(prompt, max_new_tokens=12)
    eng.run([req])
    assert req.token_ids == _reference(tm, prompt, 12)
    assert eng.accepted_tokens == 0 < eng.drafted_tokens
    assert eng.decode_steps == 11                 # 1 token per step
    assert eng.spec_steps == eng.spec_patience    # then gated narrow
    assert eng.spec_gated_steps == eng.decode_steps - eng.spec_steps - 1


def test_equal_seed_temperature_tokens_identical_across_occupancy(models):
    _, tm = models
    rng = np.random.RandomState(11)
    base = rng.randint(0, V, size=(5,)).astype(np.int32)
    prompts = [np.concatenate([base, base]),
               rng.randint(0, V, size=(11,)).astype(np.int32)]

    def serve(eng, seeds):
        reqs = [Request(p, max_new_tokens=10, temperature=t, seed=sd)
                for p, t, sd in zip(prompts, (0.8, 1.1), seeds)]
        eng.run(reqs)
        return [r.token_ids for r in reqs]

    mk = lambda: InferenceEngine(tm, num_slots=2, page_size=8, max_len=64,
                                 num_pages=16, spec_k=2)
    eng_a, eng_b = mk(), mk()
    toks = serve(eng_a, (123, 456))
    assert serve(eng_b, (123, 456)) == toks
    assert serve(eng_a, (124, 456))[0] != toks[0]
    solo = Request(prompts[0], max_new_tokens=10, temperature=0.8,
                   seed=123)
    eng_b.run([solo])
    assert solo.token_ids == toks[0]
    assert eng_a.spec_steps > 0


def test_rejection_sampling_keeps_the_distribution(models):
    """On a 6-token vocabulary, the token emitted at a drafted position
    (draft accepted with p(d), else drawn from the residual) follows
    the same distribution as the plain draw: both histograms over 6000
    seeded draws against the exact softmax pass a chi-square test at
    p = 0.001 (5 degrees of freedom: bound 20.52), deterministically
    (fixed seeds)."""
    _, tm = models
    eng = InferenceEngine(tm, num_slots=1, page_size=8, max_len=64)
    Vs, N, T = 6, 6000, 1.3
    logits = torch.tensor([[1.0, 0.2, -0.5, 0.7, 0.0, -1.2]])
    p = torch.softmax(logits[0] / T, dim=-1).numpy()
    lg = logits[:, None].expand(N, 2, Vs).contiguous()
    keys = torch.arange(1000, 1000 + N)
    pos = torch.tensor([[7, 8]]).expand(N, 2)
    temps = torch.full((N,), T)
    zero = torch.zeros((N, 1), dtype=torch.long)
    plain, _ = eng._accept_emit(lg[:, :1], zero, zero[:, 0], temps, keys,
                                pos[:, :1], None)
    toks = torch.zeros((N, 2), dtype=torch.long)
    toks[:, 1] = 3                                # always draft token 3
    spec, n_emit = eng._accept_emit(lg, toks,
                                    torch.ones((N,), dtype=torch.long),
                                    temps, keys, pos, None)
    for got in (np.asarray(plain)[:, 0], np.asarray(spec)[:, 0]):
        counts = np.bincount(got, minlength=Vs)
        chi2 = (((counts - N * p) ** 2) / (N * p)).sum()
        assert chi2 < 20.52, (counts, N * p)
    accepted = np.asarray(n_emit) == 2
    assert abs(accepted.mean() - p[3]) < 4 * np.sqrt(p[3] / N)
    assert (np.asarray(spec)[accepted, 0] == 3).all()


def test_nonfinite_verify_step_records_no_drafted_token(models):
    _, tm = models
    bad = cpu_gpt(vocab_size=V, max_length=64)
    bad.load_state_dict(tm.state_dict())
    prompt = np.random.RandomState(12).randint(0, V, size=(8,)) \
        .astype(np.int32)
    ref = _reference(bad, prompt, 16)
    eng = InferenceEngine(bad, num_slots=1, page_size=8, max_len=64,
                          num_pages=16, spec_k=3, prefix_cache=False,
                          draft_fn=_oracle_drafter(bad, [prompt], [16]))
    req = Request(prompt, max_new_tokens=16)
    eng.submit(req)
    while len(req.token_ids) < 4:                 # prefill + a verify step
        eng.step()
    before = (list(req.token_ids), eng.drafted_tokens, eng.accepted_tokens,
              eng.spec_steps)
    with torch.no_grad():                         # the tied head goes NaN
        bad.word_embed.weight.data()._data[0, :4] = float("nan")
    eng.step()
    assert req.outcome is Outcome.FAILED_NONFINITE
    assert (list(req.token_ids), eng.drafted_tokens,
            eng.accepted_tokens) == before[:3]
    assert eng.spec_steps == before[3] + 1        # the poisoned step was wide
    assert before[0] == ref[:len(before[0])]
    eng.audit_pages()


def test_draft_window_spans_page_boundary_and_survives_tiny_pool(models):
    _, tm = models
    rng = np.random.RandomState(13)
    prompts = _repetitive_prompts(rng)[:3]
    news = (14, 10, 12)
    refs = [_reference(tm, p, n) for p, n in zip(prompts, news)]
    worst = max(-(-(p.size + n) // 4) for p, n in zip(prompts, news))
    for num_pages in (24, 2 * worst + 1):
        eng = InferenceEngine(tm, num_slots=2, page_size=4, max_len=64,
                              num_pages=num_pages, spec_k=6,
                              prefix_cache=False)
        reqs = [Request(p, max_new_tokens=n) for p, n in zip(prompts, news)]
        eng.run(reqs, after_step=lambda e, i: e.audit_pages())
        assert [r.token_ids for r in reqs] == refs
        assert all(r.outcome.ok for r in reqs)
        assert eng.accepted_tokens > 0


def test_spec_k_validation(models):
    _, tm = models
    for k in (-1, 64):
        with pytest.raises(MXNetError, match="spec_k"):
            InferenceEngine(tm, num_slots=1, max_len=64, spec_k=k)


def test_ngram_propose_matches_jax():
    rng = np.random.RandomState(14)
    for _ in range(300):
        n = int(rng.randint(0, 40))
        h = rng.randint(0, int(rng.choice([2, 4, 16])), size=n) \
            .astype(np.int32)
        k = int(rng.randint(0, 6))
        order = int(rng.randint(1, 5))
        got = ngram_propose(h, k, max_order=order)
        want = jax_ngram(h, k, max_order=order)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
