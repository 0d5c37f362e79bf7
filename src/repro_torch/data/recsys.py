"""Synthetic click-log batches for DIN (deterministic per step), the
reference's `data/recsys.py` in numpy: the same draws from the same seed.

User histories have category coherence (users stick to a few categories)
so target attention has signal; labels correlate with history/candidate
category overlap. Histories are ragged, padded at the tail with -1.
"""

from __future__ import annotations

import numpy as np


def din_batch(step: int, batch: int, seq_len: int = 100, n_items: int = 1_048_576,
              n_cats: int = 16_384, d_profile: int = 8, seed: int = 0) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    user_cats = rng.integers(0, n_cats, size=(batch, 3))  # 3 interests each
    pick = rng.integers(0, 3, size=(batch, seq_len))
    hist_cats = np.take_along_axis(user_cats, pick, axis=1)
    hist_items = (hist_cats * 64 + rng.integers(0, 64, size=(batch, seq_len))) % n_items
    lens = rng.integers(seq_len // 4, seq_len + 1, size=batch)
    mask = np.arange(seq_len)[None, :] < lens[:, None]
    hist_items = np.where(mask, hist_items, -1)
    hist_cats = np.where(mask, hist_cats, 0)

    pos = rng.random(batch) < 0.5
    cand_cat = np.where(
        pos, user_cats[np.arange(batch), rng.integers(0, 3, batch)],
        rng.integers(0, n_cats, batch),
    )
    cand_item = (cand_cat * 64 + rng.integers(0, 64, size=batch)) % n_items
    label = (pos & (rng.random(batch) < 0.8)) | (~pos & (rng.random(batch) < 0.1))
    return {
        "hist_items": hist_items.astype(np.int32),
        "hist_cats": hist_cats.astype(np.int32),
        "cand_item": cand_item.astype(np.int32),
        "cand_cat": cand_cat.astype(np.int32),
        "profile": rng.standard_normal((batch, d_profile)).astype(np.float32),
        "label": label.astype(np.int32),
    }
