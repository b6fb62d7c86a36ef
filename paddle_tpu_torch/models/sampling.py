"""Host-side token sampling shared by every autoregressive decoder.

One function, one contract: `sample_token` turns a single position's
logits row into a token id. It is the single source of truth for
`gpt.kv_generate`, `gpt.greedy_generate` and the paged decode loop,
so a request replayed serially and a request decoded inside the
multi-slot batch draw exactly the same host-side sampling path. The
JAX package's module of the same name, kept as this package's own copy:
the same numpy calls draw the same tokens from the same RandomState.

Sampling stays on the host because the decode step is one fixed-shape
program shared by every request: the per-request temperature and top-k
knobs do not enter the graph.
"""
from __future__ import annotations

import numpy as np

__all__ = ["sample_token", "accept_draft"]


def sample_token(step_logits, temperature=0.0, top_k=0, rng=None):
    """Pick the next token id from one position's logits.

    temperature <= 0 is greedy argmax (no rng draw, fully
    deterministic). With temperature > 0, softmax-with-temperature
    sampling via `rng` (a np.random.RandomState; required then).
    top_k > 0 restricts either mode to the k highest logits — the
    classic fan-out cap that keeps sampled generations from wandering
    into the distribution's tail.
    """
    logits = np.asarray(step_logits)
    if logits.ndim != 1:
        raise ValueError(
            f"sample_token expects one position's logits row, got shape "
            f"{logits.shape}")
    if top_k and 0 < int(top_k) < logits.shape[0]:
        k = int(top_k)
        keep = np.argpartition(-logits, k - 1)[:k]
        masked = np.full_like(logits, -np.inf)
        masked[keep] = logits[keep]
        logits = masked
    if temperature and temperature > 0.0:
        if rng is None:
            raise ValueError(
                "sample_token: temperature sampling needs an explicit "
                "rng (np.random.RandomState) for reproducibility")
        p = logits / temperature
        p = np.exp(p - p.max())
        p /= p.sum()
        return int(rng.choice(len(p), p=p))
    return int(logits.argmax())


def accept_draft(step_logits, draft, temperature=0.0, top_k=0,
                 rng=None):
    """Speculative-decoding accept/reject over one slot's verify logits.

    `step_logits` is `[len(draft)+1, vocab]` — row j holds the target
    model's next-token logits AFTER context position j (row 0 continues
    the committed token, row j>0 continues draft token j). Walk the
    rows in order, drawing each position's token through `sample_token`
    (the SAME path, knobs and rng discipline as serial decode): while
    the drawn token equals the draft token at that position the draft
    is accepted and the walk continues; the first disagreement stops
    the walk — the drawn token itself IS the correction (no extra
    forward pass, no distribution shift: every emitted token is a draw
    from the target model's distribution at its position, one rng draw
    per emitted token in serial order). Accepting the whole draft emits
    a bonus token from the final row for free.

    Returns `(emitted, n_accepted)`: `emitted` is the 1..len(draft)+1
    tokens to commit (order matters; a caller honoring eos truncates),
    `n_accepted` how many draft tokens matched. With an empty draft
    this degenerates to exactly the single-token sample — the bit-exact
    fallback the serving engine and tests rely on.
    """
    rows = np.asarray(step_logits)
    if rows.ndim != 2 or rows.shape[0] != len(draft) + 1:
        raise ValueError(
            f"accept_draft expects [len(draft)+1, vocab] logits, got "
            f"shape {rows.shape} for {len(draft)} draft token(s)")
    emitted = []
    n_accepted = 0
    for j in range(len(draft) + 1):
        tok = sample_token(rows[j], temperature=temperature,
                           top_k=top_k, rng=rng)
        emitted.append(tok)
        if j < len(draft) and tok == int(draft[j]):
            n_accepted += 1
            continue
        break
    return emitted, n_accepted
