"""Speculative decoding: host-side n-gram drafter for the paged engine.

The JAX package's `serving/spec_decode.py`, kept in this package so that
nothing here imports `paddle_tpu`.

Decode is one token per slot per step by construction — the engine feeds
fixed shapes only, so it never feeds a variable number of tokens. Speculative decoding (Leviathan et al., "Fast Inference from
Transformers via Speculative Decoding", arXiv 2211.17192) breaks the
one-token ceiling without breaking the contract: a cheap DRAFTER
proposes k candidate continuation tokens, one batched VERIFY step
scores all k+1 positions through the paged decode graph
(`models/gpt.py:build_spec_verify_step`, a `[max_slots, k+1]`
fixed-shape sibling of the decode step), and the host accepts the
longest prefix the target model agrees with
(`models/sampling.py:accept_draft`). Every accepted token costs zero
extra forward passes; a full rejection degenerates to exactly the
single-token step.

The drafter here is the prompt-lookup / n-gram variant (no second
model, no extra weights, nothing on the device): LLM serving traffic is
full of verbatim repetition — retrieved documents echoed into answers,
code identifiers, templated JSON — so the best guess for what follows
the current context suffix is *what followed it last time it appeared*.
`NgramDrafter.draft` suffix-matches the slot's prompt + generated
tokens against itself (longest n-gram first, most recent occurrence
wins) and proposes the up-to-k tokens that followed.

Drafting is pure host-side Python over the token lists the scheduler
already owns: no flags reach the graph, no shapes change, and a slot
with no match simply rides the verify step with `n_valid = 1`
(semantically identical to the plain decode step). Correctness is
sampling-path identity, not heuristics: verify logits at position j
condition on exactly the tokens a serial decode would have fed, and
`accept_draft` draws through the SAME `sample_token` path with the
slot's own rng, so outputs are token-for-token identical to the serial
reference at any temperature (tests/test_torch_spec_decode.py).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

__all__ = ["NgramDrafter", "update_spec_k"]


def update_spec_k(cur: int, ewma: Optional[float], rate: float,
                  k_max: int, low: float = 0.3, high: float = 0.8,
                  alpha: float = 0.5) -> Tuple[int, float, int]:
    """Acceptance-aware draft-length controller (pure, per slot).

    Folds this iteration's measured acceptance `rate` (accepted /
    proposed, in [0, 1]) into an EWMA and moves the slot's draft budget
    one step: below `low` the budget shrinks (drafting is not paying
    for the verify premium), above `high` it grows back toward `k_max`.
    Returns `(new_k, new_ewma, moved)` with moved in {-1, 0, +1}.

    Only the number of PROPOSED tokens changes — verification and
    acceptance stay sampling-path identical, so adapting k can never
    change emitted tokens, only how much verify compute is wasted.
    """
    rate = min(1.0, max(0.0, float(rate)))
    ewma = rate if ewma is None else alpha * rate + (1 - alpha) * ewma
    moved = 0
    if ewma < low and cur > 1:
        cur -= 1
        moved = -1
    elif ewma > high and cur < k_max:
        cur += 1
        moved = 1
    return cur, ewma, moved


class NgramDrafter:
    """Prompt-lookup drafter: propose what followed this suffix before.

    `max_ngram` bounds the suffix length tried (longest first — a
    longer match is stronger evidence the continuation repeats);
    `k` caps the tokens proposed per call. Stateless and thread-free:
    the engine worker calls `draft` between decode steps with each
    slot's full known context.
    """

    def __init__(self, max_ngram: int = 3, k: int = 4):
        self.max_ngram = int(max_ngram)
        self.k = int(k)

    def draft(self, context: Sequence[int], k: int = 0) -> List[int]:
        """Up to min(k or self.k, ...) draft tokens continuing `context`.

        Tries suffix lengths n = max_ngram..1: find the MOST RECENT
        earlier occurrence of the length-n suffix inside `context`
        itself and return the tokens that followed it. Returns [] when
        nothing matches (unique suffix, context too short, k <= 0) —
        the caller then falls back to the plain decode step.
        """
        k = int(k) if k else self.k
        ctx = [int(t) for t in context]
        L = len(ctx)
        if k <= 0 or self.max_ngram <= 0 or L < 2:
            return []
        for n in range(min(self.max_ngram, L - 1), 0, -1):
            suffix = ctx[L - n:]
            # scan right-to-left so the most recent occurrence wins —
            # recent text is the best predictor of what repeats next
            for i in range(L - n - 1, -1, -1):
                if ctx[i:i + n] == suffix:
                    out = ctx[i + n:i + n + k]
                    if out:
                        return out
        return []
