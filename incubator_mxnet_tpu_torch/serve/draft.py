"""Engine-internal draft proposers for speculative decoding.

Speculative decoding needs a cheap source of candidate next-tokens; the
engine's first drafter is PROMPT-LOOKUP / N-GRAM drafting (no second
model): real generation is full of spans the sequence has already seen
— templated boilerplate, quoted context, code identifiers, repetition —
so the continuation of the most recent earlier occurrence of the
current suffix n-gram is a strong guess at the next tokens. Proposals
are pure host-side DATA (an int32 vector per slot per step); the jitted
verify step scores them and accepts a variable-length prefix, so a
wrong draft costs nothing but the verify FLOPs and a missing draft
degrades to exactly the non-speculative 1 token/step (serve/engine.py).

A drafter is any callable ``draft_fn(history, k) -> np.ndarray`` with
``history`` the slot's prompt + emitted tokens (1-D int32) and ``k``
the maximum number of drafts wanted; it returns 0..k int32 tokens.
``InferenceEngine(draft_fn=...)`` swaps the proposer (the bench uses an
adversarial random drafter to measure the zero-agreement floor; a
draft-MODEL proposer plugs in the same way later).
"""

from __future__ import annotations

import numpy as np

__all__ = ["ngram_propose", "make_ngram_drafter"]

_EMPTY = np.zeros((0,), np.int32)


def ngram_propose(history, k, max_order=3, min_order=1):
    """Propose up to ``k`` draft tokens by prompt lookup: find the most
    recent earlier occurrence of the history's suffix n-gram (longest
    order first, ``max_order`` down to ``min_order``) and return the
    tokens that followed it. Returns a (0..k,) int32 array — empty when
    no suffix n-gram recurs (the engine then runs a plain decode step).

    The scan is vectorized numpy over a <= max_len history — host-side
    noise next to a decode step's device dispatch."""
    h = np.asarray(history, np.int32).reshape(-1)
    n = h.size
    if k <= 0 or n < min_order + 1:
        return _EMPTY
    for order in range(min(max_order, n - 1), min_order - 1, -1):
        pat = h[-order:]
        # candidate starts i < n - order: every one leaves >= 1
        # continuation token (h[i + order] exists), and the suffix's
        # own trivial zero-continuation match at i = n - order is
        # excluded. i = n - order - 1 IS a legal candidate — its
        # continuation is h[n - 1], the period-1 repetition draft
        starts = n - order
        if starts <= 0:
            continue
        hits = np.ones((starts,), bool)
        for j in range(order):                  # order is tiny (<= 3)
            hits &= h[j:j + starts] == pat[j]
        idx = np.nonzero(hits)[0]
        if idx.size == 0:
            continue
        # most recent occurrence, preferring one far enough from the
        # end to supply all k continuation tokens (on periodic text the
        # nearest occurrence abuts the suffix and would yield only a
        # 1-token draft)
        full = idx[idx + order + k <= n]
        i = int(full[-1]) if full.size else int(idx[-1])
        cont = h[i + order:i + order + k]
        if cont.size:
            return cont.astype(np.int32, copy=True)
    return _EMPTY


def make_ngram_drafter(max_order=3, min_order=1):
    """An ``InferenceEngine``-shaped drafter with fixed n-gram orders."""

    def draft(history, k):
        return ngram_propose(history, k, max_order=max_order,
                             min_order=min_order)

    return draft
