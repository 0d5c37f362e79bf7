"""Hash partitioning (numpy; the port's own copy of ``repro.graph.partition``).

The paper's storage tier uses inexpensive hash partitioning (RAMCloud
MurmurHash3 over node ids). ``splitmix64`` is the MurmurHash-grade avalanche
both the storage placement and ``hash_partition`` use.
"""

from __future__ import annotations

import numpy as np


def splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 avalanche hash (vectorized); MurmurHash3-grade mixing."""
    x = np.asarray(x, dtype=np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return z ^ (z >> np.uint64(31))


def hash_partition(n: int, n_parts: int, seed: int = 0) -> np.ndarray:
    """Paper's storage partitioning: hash(node) mod S. O(n), no graph needed."""
    h = splitmix64(np.arange(n, dtype=np.uint64) + np.uint64(seed * 0x5851F42D4C957F2D))
    return (h % np.uint64(n_parts)).astype(np.int32)
