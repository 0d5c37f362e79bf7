"""Graph embedding into R^D preserving hop distances (paper Algorithm 3).

The paper minimises the relative distance error (Eq. 4)

    f_error(v1, v2) = |d(v1,v2) - ||x1 - x2||| / d(v1,v2)

first over all landmark pairs, then per non-landmark node against the
landmarks. As in the reference package, Simplex Downhill becomes Adam on
the same objective (squared relative error), run for all nodes at once:
one loss, the mean over every valid (node, landmark) pair, and one
`torch.autograd.grad` of it a step. The optimisation runs on the device of
its inputs; `build_graph_embedding` returns numpy, as the reference does.

The inits draw Gaussian noise (the reference from `jax.random`, whose bits
torch cannot reproduce). Each function takes its noise as an optional
tensor; without one it draws from an explicit `torch.Generator` on the CPU
and moves the draw to the run's device, so one seed gives the same init on
every device. The tests pass the reference's own draws.

Outputs coordinates (n, D) float32 -- the O(nD) router state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.landmarks import UNREACHED
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import div


@dataclasses.dataclass
class EmbedConfig:
    dim: int = 10
    lm_steps: int = 500
    node_steps: int = 200
    lr: float = 0.05
    eps: float = 1e-6
    seed: int = 0


def _adam_update(p, g, m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step; t is the float32 step count as a tensor (the reference
    scans over float32 steps, so b ** t is a float32 power)."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mh = m / (1 - b1 ** t)
    vh = v / (1 - b2 ** t)
    return p - lr * mh / (torch.sqrt(vh) + eps), m, v


def _rel_err_loss(pred_d: torch.Tensor, true_d: torch.Tensor, eps: float) -> torch.Tensor:
    """Mean squared relative error over valid (reachable, non-self) pairs:
    one mean over all of them, not a mean per node."""
    valid = (true_d > 0) & (true_d < int(UNREACHED))
    td = torch.where(valid, true_d, 1).to(torch.float32)
    err = (pred_d - td) / torch.clamp(td, min=eps)
    total = torch.where(valid, err * err, 0.0).sum()
    return total / torch.clamp(valid.sum(dtype=torch.int32), min=1)


def _noise(shape: Tuple[int, int], noise: Optional[torch.Tensor],
           generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
    """The init's standard normal draw: `noise` if given (checked against
    `shape`), else a draw from `generator` (default: a CPU generator at
    seed 0), moved to `device`."""
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise of shape {tuple(noise.shape)}, expected {tuple(shape)}")
        return noise.to(device=device, dtype=torch.float32)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.randn(shape, generator=generator, device=generator.device).to(device)


def _optimise(x0: torch.Tensor, loss_fn, steps: int, lr: float) -> torch.Tensor:
    """`steps` Adam steps on loss_fn from x0, with no host sync."""
    x, m, v = x0, torch.zeros_like(x0), torch.zeros_like(x0)
    ts = torch.arange(steps, dtype=torch.float32, device=x0.device) + 1.0
    for i in range(steps):
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(x), x)
        with torch.no_grad():
            x, m, v = _adam_update(x, g, m, v, ts[i], lr)
    return x.detach()


def _pair_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, L) Euclidean distances between rows of a (N, D) and b (L, D),
    with the reference's +1e-12 inside the root (a finite gradient at 0)."""
    diff = a[:, None, :] - b[None, :, :]
    return torch.sqrt((diff * diff).sum(-1) + 1e-12)


def embed_landmarks(lm_dists: torch.Tensor, dim: int, steps: int, lr: float,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Embed landmarks: minimise pairwise relative error (Algorithm 3 line 5).

    lm_dists: (L, L) int32 hop distances between landmarks. noise: (L, dim)
    standard normal init draw (else drawn from `generator`). Returns
    (L, dim) float32 coordinates on lm_dists' device.
    """
    L = lm_dists.shape[0]
    dev = lm_dists.device
    # init: a random small ball scaled by the mean distance
    valid = (lm_dists > 0) & (lm_dists < int(UNREACHED))
    scale = torch.where(valid, lm_dists, 0).sum(dtype=torch.int32) / \
        torch.clamp(valid.sum(dtype=torch.int32), min=1)
    x0 = div(_noise((L, dim), noise, generator, dev) * scale, math.sqrt(2.0 * dim))
    return _optimise(x0, lambda x: _rel_err_loss(_pair_dist(x, x), lm_dists, 1e-6),
                     steps, lr)


def embed_nodes(node_lm_dists: torch.Tensor, lm_coords: torch.Tensor, steps: int,
                lr: float, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Embed every node against the fixed landmark coordinates (Algorithm 3
    lines 6-8), all nodes at once.

    node_lm_dists: (n, L) int32; lm_coords: (L, dim); noise: (n, dim)
    standard normal init draw (else drawn from `generator`). Returns
    (n, dim) float32 on node_lm_dists' device.
    """
    n = node_lm_dists.shape[0]
    dim = lm_coords.shape[1]
    dev = node_lm_dists.device
    lm_coords = lm_coords.to(dev)
    # init each node at the weighted centroid of its nearest landmarks
    d = node_lm_dists.to(torch.float32)
    valid = node_lm_dists < int(UNREACHED)
    w = torch.where(valid, torch.reciprocal(1.0 + d), 0.0)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    x0 = w @ lm_coords + 0.01 * _noise((n, dim), noise, generator, dev)
    return _optimise(
        x0, lambda x: _rel_err_loss(_pair_dist(x, lm_coords), node_lm_dists, 1e-6),
        steps, lr)


@dataclasses.dataclass
class GraphEmbedding:
    """coords: (n, D) float32; landmarks + their coords kept for incremental
    updates (paper §3.4.2)."""

    coords: np.ndarray
    landmarks: np.ndarray
    lm_coords: np.ndarray
    config: EmbedConfig

    def rel_error(self, dist_to_lm: np.ndarray, sample: int = 4096, seed: int = 0) -> float:
        """Mean relative distance error node->landmark on a sample (Fig 14a);
        numpy, the reference's sample and arithmetic."""
        rng = np.random.default_rng(seed)
        n = self.coords.shape[0]
        idx = rng.integers(0, n, size=min(sample, n))
        d_true = dist_to_lm[idx].astype(np.float64)  # (s, L)
        diff = self.coords[idx][:, None, :] - self.lm_coords[None, :, :]
        d_pred = np.sqrt((diff * diff).sum(-1))
        valid = (d_true > 0) & (d_true < float(UNREACHED))
        rel = np.abs(d_pred - d_true) / np.maximum(d_true, 1e-9)
        return float(rel[valid].mean())


def build_graph_embedding(
    dist_to_lm: np.ndarray,
    landmarks: np.ndarray,
    config: EmbedConfig = EmbedConfig(),
    device: DeviceLike = None,
    lm_noise: Optional[torch.Tensor] = None,
    node_noise: Optional[torch.Tensor] = None,
) -> GraphEmbedding:
    """Full Algorithm 3 on `device`. The landmark BFS distances are an input
    (the landmark index's: one BFS pass serves both schemes). lm_noise
    (L, dim) and node_noise (n, dim) are the inits' draws; those not given
    come from one CPU generator seeded with `config.seed`, the landmarks'
    draw first, so a seed gives the same init on every device."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(config.seed)
    landmarks = np.asarray(landmarks)
    dist = torch.from_numpy(np.ascontiguousarray(dist_to_lm, dtype=np.int32)).to(dev)
    lm_idx = torch.from_numpy(landmarks.astype(np.int64)).to(dev)
    lm_coords = embed_landmarks(dist[lm_idx], config.dim, config.lm_steps, config.lr,
                                noise=lm_noise, generator=gen)
    coords = embed_nodes(dist, lm_coords, config.node_steps, config.lr,
                         noise=node_noise, generator=gen)
    # landmarks keep their directly optimised coordinates
    coords[lm_idx] = lm_coords
    return GraphEmbedding(coords=coords.cpu().numpy(), landmarks=landmarks,
                          lm_coords=lm_coords.cpu().numpy(), config=config)


def incremental_embed_node(
    emb: GraphEmbedding, d_to_landmarks: np.ndarray, steps: Optional[int] = None,
    device: DeviceLike = None, noise: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """Embed ONE new node against the existing landmark coordinates (graph
    update path, §3.4.2). noise: (1, dim) init draw; without one, a CPU
    generator seeded with 1 (the reference's fixed key 1).
    The loss's mean is over this node's valid pairs."""
    dev = resolve_device(device)
    steps = steps or emb.config.node_steps
    dist = torch.from_numpy(np.asarray(d_to_landmarks)[None, :].astype(np.int32)).to(dev)
    x = embed_nodes(dist, torch.from_numpy(np.asarray(emb.lm_coords, np.float32)).to(dev),
                    steps, emb.config.lr, noise=noise,
                    generator=torch.Generator().manual_seed(1))
    return x.cpu().numpy()[0]
