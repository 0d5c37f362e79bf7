"""Synthetic LM token stream (numpy; the same draws as the reference's).

Deterministic in (step, seed): tokens follow a Zipf-ish marginal with a
bigram rule (even positions predict odd ones), so a replayed step gives
the same batch.
"""

from __future__ import annotations

import numpy as np


def token_batch(step: int, batch: int, seq: int, vocab: int, seed: int = 0) -> dict:
    """{"tokens", "labels"}: (batch, seq) int32 each, labels shifted by one."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    base = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
    toks = (base - 1) % vocab
    toks[:, 1::2] = (toks[:, 0:-1:2] * 31 + 7) % vocab
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }
