"""The per-slot sampling menu of the serving engine.

The port of ``incubator_mxnet_tpu/serve/sampling.py``. The host-side
parts are its own copy: ``SamplingParams`` (the per-request knob
bundle a ``Request`` carries), ``match_stop`` (stop sequences) and the
grammar layer (``TokenGrammar`` / ``TokenFsm`` / ``choice_grammar`` /
``grammar_mask``: a host-side DFA over token ids that yields a per-step
vocabulary mask). ``constrain_logits`` is the one transform every
sampling site of the engine shares, in plain PyTorch: logit bias ->
repetition/presence penalties -> vocabulary mask -> top-k -> top-p.
Every stage is gated by a select on its DISABLED value, so a neutral
configuration returns the input logits value-identical.

The draws are on the device and need no generator: ``draw_uniform`` is
a counter-based hash, in int64 tensor ops, of (request key, sequence
position, stream) to a uniform in (0, 1) — the same bits on the CPU
and the card, whichever program asks (prefill, a decode step or a
verify column). ``sample_inverse_cdf`` draws a token with one such
uniform per (slot, position) by inverting the softmax's CDF.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["SamplingParams", "TokenGrammar", "TokenFsm",
           "choice_grammar", "constrain_logits", "grammar_mask",
           "match_stop", "NEUTRAL", "draw_uniform", "sample_inverse_cdf",
           "row_aligned",
           "DRAW_STREAM", "ACCEPT_STREAM"]

_NEG_BIG = -1e30                       # matches serve/engine.py


# --------------------------------------------------------------------- #
# grammars: host-side DFAs over token ids -> per-state vocabulary masks
# --------------------------------------------------------------------- #

class TokenGrammar:
    """Interface a constrained-decoding grammar implements. States are
    small immutable handles (ints): the engine stores one per slot,
    re-derives it from the generated history on preemption/failover
    resume (determinism is part of the contract), and advances COPIES
    along speculative draft chains.

    ``vocab_size`` must equal the serving model's — validated at
    engine admission (mismatch is FAILED_UNSERVABLE, fail-fast)."""

    vocab_size: int

    def start(self):
        raise NotImplementedError

    def advance(self, state, token: int):
        """The state after consuming ``token``, or None when the
        grammar forbids it (callers treat None as 'keep state' for
        robustness — the mask should have made it unreachable)."""
        raise NotImplementedError

    def allowed(self, state) -> np.ndarray:
        """Bool (V,) of tokens with an outgoing transition. Callers
        must NOT mutate the returned array (it may be cached)."""
        raise NotImplementedError

    def accepting(self, state) -> bool:
        """True when the generated text so far is a complete sentence
        of the grammar — EOS becomes legal."""
        raise NotImplementedError


class TokenFsm(TokenGrammar):
    """Explicit DFA over token ids: ``transitions[state][token] ->
    state``; ``accept`` is the set of accepting states. The generic
    carrier every higher-level grammar compiles down to."""

    def __init__(self, vocab_size: int, transitions: Dict[int, Dict[int, int]],
                 start_state: int = 0, accept=()):
        self.vocab_size = int(vocab_size)
        self.transitions = {int(s): {int(t): int(n) for t, n in d.items()}
                            for s, d in transitions.items()}
        self.start_state = int(start_state)
        self.accept = frozenset(int(s) for s in accept)
        for s, d in self.transitions.items():
            for t in d:
                if not (0 <= t < self.vocab_size):
                    raise MXNetError(f"grammar transition on token {t} "
                                     f"outside vocab [0, {vocab_size})")
        self._allowed_cache: Dict[int, np.ndarray] = {}

    def start(self):
        return self.start_state

    def advance(self, state, token: int):
        return self.transitions.get(state, {}).get(int(token))

    def allowed(self, state) -> np.ndarray:
        m = self._allowed_cache.get(state)
        if m is None:
            m = np.zeros((self.vocab_size,), bool)
            for t in self.transitions.get(state, {}):
                m[t] = True
            self._allowed_cache[state] = m
        return m

    def accepting(self, state) -> bool:
        return state in self.accept


def choice_grammar(sequences: Sequence[Sequence[int]],
                   vocab_size: int) -> TokenFsm:
    """A grammar accepting EXACTLY ONE of ``sequences`` (a trie DFA) —
    the constrained agent/tool-call shape: the model must emit one of
    a fixed menu of token templates, then stop. Shared prefixes share
    trie states, so the mask mid-prefix is the union of the surviving
    continuations."""
    if not sequences:
        raise MXNetError("choice_grammar needs at least one sequence")
    transitions: Dict[int, Dict[int, int]] = {0: {}}
    accept = set()
    next_state = 1
    for seq in sequences:
        seq = [int(t) for t in seq]
        if not seq:
            raise MXNetError("choice_grammar sequences must be "
                             "non-empty")
        state = 0
        for tok in seq:
            nxt = transitions.setdefault(state, {}).get(tok)
            if nxt is None:
                nxt = next_state
                next_state += 1
                transitions[state][tok] = nxt
                transitions.setdefault(nxt, {})
            state = nxt
        accept.add(state)
    return TokenFsm(vocab_size, transitions, 0, accept)


def grammar_mask(grammar: TokenGrammar, state, eos_id: int) -> np.ndarray:
    """The (V,) bool mask for the NEXT token at ``state``: every token
    with an outgoing transition, plus EOS when the state accepts. A
    dead end (no outgoing) forces EOS — the only honest move left;
    ``SamplingParams`` validation requires ``eos_id >= 0`` whenever a
    grammar is set, so the forced finish always has a token."""
    m = grammar.allowed(state)
    if eos_id < 0:
        return m
    out = m.copy()
    out[eos_id] = grammar.accepting(state) or not m.any()
    return out


# --------------------------------------------------------------------- #
# the per-request knob bundle
# --------------------------------------------------------------------- #

@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling configuration (``Request.sampling``).

    ``top_k`` 0 disables (full vocab); ``top_p`` 1.0 disables;
    ``repetition_penalty`` (HF convention: seen-token logits divided
    by it when positive, multiplied when negative) 1.0 disables;
    ``presence_penalty`` (flat subtraction from seen tokens) 0.0
    disables. BOTH penalties act on tokens present in the FULL history
    — prompt plus generated. (The OpenAI convention penalizes
    generated tokens only; the full-history definition is what keeps a
    preemption/failover resume — where emitted tokens re-enter as the
    replay attempt's prompt — bit-identical to the unbroken run, which
    this engine guarantees for every knob.)

    ``logit_bias`` maps token id -> additive bias (ban a token with a
    large negative value). ``stop_sequences`` are token-id sequences:
    generation stops with ``Outcome.STOP`` when the generated stream
    ends with one, and the matched sequence is NOT included in the
    output (the common API semantic). ``grammar`` constrains decoding
    to a ``TokenGrammar``'s language via a per-step vocabulary mask;
    it requires the request to have ``eos_id >= 0`` (grammar
    completion is expressed by making EOS legal)."""

    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    logit_bias: Optional[Dict[int, float]] = None
    stop_sequences: Tuple[Tuple[int, ...], ...] = ()
    grammar: Optional[TokenGrammar] = None

    def __post_init__(self):
        self.top_k = int(self.top_k)
        if self.top_k < 0:
            raise MXNetError(f"top_k must be >= 0, got {self.top_k}")
        self.top_p = float(self.top_p)
        if not (0.0 < self.top_p <= 1.0):
            raise MXNetError(f"top_p must be in (0, 1], got "
                             f"{self.top_p}")
        self.repetition_penalty = float(self.repetition_penalty)
        if self.repetition_penalty <= 0.0:
            raise MXNetError(f"repetition_penalty must be > 0, got "
                             f"{self.repetition_penalty}")
        self.presence_penalty = float(self.presence_penalty)
        if self.logit_bias is not None:
            self.logit_bias = {int(t): float(b)
                               for t, b in self.logit_bias.items()}
        seqs = []
        for seq in self.stop_sequences:
            seq = tuple(int(t) for t in seq)
            if not seq:
                raise MXNetError("stop sequences must be non-empty")
            seqs.append(seq)
        self.stop_sequences = tuple(seqs)
        if self.grammar is not None and \
                not isinstance(self.grammar, TokenGrammar):
            raise MXNetError(f"grammar must be a TokenGrammar, got "
                             f"{type(self.grammar).__name__}")

    @property
    def max_stop_len(self) -> int:
        return max((len(s) for s in self.stop_sequences), default=0)

    @property
    def logits_neutral(self) -> bool:
        """True when every LOGIT-touching knob is at its exact-identity
        value — the request samples bit-identically to the plain
        temperature path. Stop sequences are deliberately excluded:
        stop matching is pure host-side bookkeeping after a token
        lands, so a stop-only request stays on the engine's
        zero-copy neutral-operand fast path."""
        return (self.top_k == 0 and self.top_p == 1.0 and
                self.repetition_penalty == 1.0 and
                self.presence_penalty == 0.0 and
                not self.logit_bias and self.grammar is None)

    @property
    def neutral(self) -> bool:
        """True when the request behaves exactly like a plain
        temperature request end to end — ``logits_neutral`` AND no
        stop sequences (stops change the output, just not the
        logits)."""
        return self.logits_neutral and not self.stop_sequences

    def validate_for(self, vocab_size: int,
                     eos_id: int) -> Optional[str]:
        """Fail-fast admission check against a concrete engine: the
        error string (→ FAILED_UNSERVABLE) or None."""
        if self.grammar is not None:
            if eos_id < 0:
                return ("grammar-constrained decoding requires "
                        "eos_id >= 0 (grammar completion is expressed "
                        "through EOS)")
            if self.grammar.vocab_size != vocab_size:
                return (f"grammar vocab_size "
                        f"{self.grammar.vocab_size} != model vocab "
                        f"{vocab_size}")
        if self.logit_bias:
            bad = [t for t in self.logit_bias
                   if not (0 <= t < vocab_size)]
            if bad:
                return f"logit_bias tokens {bad} outside vocab " \
                       f"[0, {vocab_size})"
        return None


NEUTRAL = SamplingParams()


def match_stop(tail: Sequence[int],
               stop_sequences: Sequence[Sequence[int]]) -> int:
    """Length of the longest stop sequence the token ``tail`` ends
    with, or 0. The engine calls this after every recorded token with
    the trailing window of the GENERATED stream (which spans
    preemption resume boundaries — the tail is seeded from the replay
    prompt's generated suffix at admission)."""
    best = 0
    n = len(tail)
    for seq in stop_sequences:
        m = len(seq)
        if m <= n and m > best and tuple(tail[n - m:]) == tuple(seq):
            best = m
    return best


# --------------------------------------------------------------------- #
# the logits transform (plain torch; tensors on the logits' device)
# --------------------------------------------------------------------- #

def constrain_logits(logits, temps, counts, bias, mask, top_k, top_p,
                     rep_pen, pres_pen):
    """Apply the full sampling menu to raw LM-head logits.

    ``logits`` is (..., V); ``temps/top_k/top_p/rep_pen/pres_pen`` are
    tensors shaped like the leading dims, ``counts``/``bias``/``mask``
    are (..., V). Stage order: bias -> penalties (over tokens PRESENT in
    the history, counts > 0) -> mask -> top-k (ties at the k-th value
    kept) -> top-p (nucleus over the temperature-scaled distribution;
    greedy slots use T = 1, top-p cannot change an argmax). The mask
    comes before the truncations, so they act within the legal set.
    Masked tokens sit at -1e30."""
    V = logits.shape[-1]
    l = logits.float() + bias
    pen_on = (rep_pen != 1.0) | (pres_pen != 0.0)
    penalized = torch.where(l > 0, l / rep_pen[..., None],
                            l * rep_pen[..., None]) - pres_pen[..., None]
    l = torch.where(pen_on[..., None] & (counts > 0), penalized, l)
    l = torch.where(mask, l, _NEG_BIG)
    k_on = (top_k > 0) & (top_k < V)
    srt = torch.sort(l, dim=-1).values              # ascending
    kidx = torch.clamp(V - top_k, 0, V - 1).long()[..., None]
    kidx = kidx.expand(l.shape[:-1] + (1,))
    kth = torch.gather(srt, -1, kidx)
    l = torch.where(k_on[..., None] & (l < kth), _NEG_BIG, l)
    p_on = top_p < 1.0
    safe_t = torch.where(temps > 0, torch.clamp(temps, min=1e-6),
                         torch.ones_like(temps))[..., None]
    # sorted probs from the top-k sort already in hand (flooring below
    # the k-th value commutes with sorting; exp is monotone), with ONE
    # shared max / normalizer so they equal a sort of probs exactly. The
    # normalizer's sum and the cumsum run over ``row_aligned`` rows (the
    # -inf pad weighs exactly 0): a row's top-p set does not depend on
    # the row of the batch it sits in
    srt2 = torch.where(k_on[..., None] & (srt < kth), _NEG_BIG, srt)
    m = l.amax(dim=-1, keepdim=True)
    e = torch.exp(row_aligned(l / safe_t - m / safe_t))
    z = e.sum(dim=-1, keepdim=True)
    probs = e[..., :V] / z
    sp = torch.exp(row_aligned((srt2 / safe_t - m / safe_t).flip(-1))) / z
    csum = torch.cumsum(sp, dim=-1)[..., :V]
    sp = sp[..., :V]
    keep_sorted = (csum - sp) < top_p[..., None]
    thr = torch.where(keep_sorted, sp, torch.full_like(sp, float("inf"))
                      ).amin(dim=-1, keepdim=True)
    return torch.where(p_on[..., None] & (probs < thr), _NEG_BIG, l)


# --------------------------------------------------------------------- #
# the device draw: a counter-based hash of (key, position, stream)
# --------------------------------------------------------------------- #

DRAW_STREAM = 0      # the categorical draw of a position's token
ACCEPT_STREAM = 1    # the speculative acceptance test's uniform
_STREAM_SALT = (0x243F6A88, 0x85A308D3)   # pi's first fraction words
_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2**32`` for 32-bit ``x`` and a constant ``c``, as two
    16-bit partial products: every intermediate stays below 2**49, so
    int64 tensors never overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """MurmurHash3's 32-bit finalizer (an avalanche bijection)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def draw_uniform(keys, positions, stream: int):
    """The f32 uniform in (0, 1) of draw ``stream`` at ``positions`` of
    the streams keyed by ``keys`` (int64 tensors that broadcast; a key's
    64 bits are its two's-complement bits). A pure function of those
    three: the low key word, the high key word and the position are
    folded in turn through ``_fmix32``, and the top 23 bits of the hash
    give ``(b + 0.5) / 2**23``, exact in f32."""
    h = _fmix32((keys & _M32) ^ _STREAM_SALT[stream])
    h = _fmix32(h ^ ((keys >> 32) & _M32))
    h = _fmix32(h ^ (positions & _M32))
    return ((h >> 9).to(torch.float32) + 0.5) * 2.0 ** -23


_ROW_ALIGN = 64


def row_aligned(x):
    """``x`` (..., V) f32 with its last dim padded by -inf to a multiple
    of 64. A row-wise softmax or cumsum on the card splits a row by the
    alignment of its start (PyTorch's softmax kernel does), so with V =
    50257 the same row rounds differently in different rows of a batch:
    a request's draws would depend on the slot it holds. Padded, every
    row starts at the same alignment and the -inf entries weigh exactly
    0."""
    pad = -x.shape[-1] % _ROW_ALIGN
    return torch.nn.functional.pad(x, (0, pad), value=float("-inf")) \
        if pad else x


def sample_inverse_cdf(logits, u):
    """One token per row of ``logits`` (..., V) drawn from
    ``softmax(logits)`` with the uniform ``u`` (...): the first index
    whose cumulative probability exceeds ``u`` times the total. A token
    of zero probability is never drawn (where rounding puts ``u`` at the
    total, the last token of nonzero probability is taken). The rows are
    ``row_aligned``: a row draws the same token whatever row of the batch
    it sits in."""
    p = torch.softmax(row_aligned(logits.float()), dim=-1)
    cdf = torch.cumsum(p, dim=-1)
    idx = torch.searchsorted(cdf, (u * cdf[..., -1])[..., None],
                             right=True)[..., 0]
    vocab = torch.arange(p.shape[-1], device=logits.device)
    last = torch.where(p > 0, vocab, 0).amax(dim=-1)
    return torch.minimum(idx, last)
