"""Graph embedding into R^D preserving hop distances (paper Algorithm 3).

Only the container is ported so far, so that the router's `embed` scheme
can take coordinates (built by the reference package and carried across
with `repro_torch.convert.graph_embedding`). Training the embedding
(`embed_landmarks`, `embed_nodes`) is later work.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class EmbedConfig:
    dim: int = 10
    lm_steps: int = 500
    node_steps: int = 200
    lr: float = 0.05
    eps: float = 1e-6
    seed: int = 0


@dataclasses.dataclass
class GraphEmbedding:
    """coords: (n, D) float32; landmarks + their coords kept for incremental
    updates (paper §3.4.2)."""

    coords: np.ndarray
    landmarks: np.ndarray
    lm_coords: np.ndarray
    config: EmbedConfig
