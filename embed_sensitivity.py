"""How far a rounding-level change moves the trained graph embedding.

    python3 embed_sensitivity.py [--device cpu] [--seeds 4] [--shifts 6]

Trains the embedding (Algorithm 3, `EmbedConfig()` defaults) of the
4,800-node preset with 16 landmarks, the graph of `chip_smoke.py`'s phase
3, from init draws made on a CPU generator for each seed. Each training is
then repeated twice with the same mathematics:

  - `permuted`: the landmarks in another order, so every sum over them
    runs in another order (what another device's reductions do);
  - `lm + 1e-6`: the node stage from the landmark coordinates moved by
    1e-6 each, about what such an order changes in them, for `--shifts`
    draws of the move; the largest of each figure over them.

For each, the largest difference of the coordinates, the rows over 5e-4,
the largest difference of a node's own loss (its terms of the objective,
averaged over its valid pairs) and the difference of `rel_error`. Also
`rel_error` of partly trained embeddings, the floor a broken training
would show. Prints one JSON object a line.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from chip_smoke import node_losses  # noqa: E402
from repro_torch.core import embedding as te  # noqa: E402
from repro_torch.core.landmarks import build_landmark_index  # noqa: E402
from repro_torch.core.workloads import preset_workload  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

ROW_ATOL = 5e-4


def compare(a, b, li, cfg):
    """(coords, lm_coords) pairs a and b: the figures of the module docstring."""
    rows = np.abs(a[0] - b[0]).max(1)
    loss = np.abs(node_losses(*a, li.dist_to_lm) - node_losses(*b, li.dist_to_lm))
    err = [te.GraphEmbedding(x[0], li.landmarks, x[1], cfg).rel_error(li.dist_to_lm)
           for x in (a, b)]
    return dict(coord_max_diff=float(rows.max()), rows_over=int((rows > ROW_ATOL).sum()),
                lm_max_diff=float(np.abs(a[1] - b[1]).max()), node_loss_max_diff=float(loss.max()),
                rel_error_diff=abs(err[0] - err[1]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--shifts", type=int, default=6)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    g, _ = preset_workload("small", n_queries=128, seed=0)
    li = build_landmark_index(g, n_processors=4, n_landmarks=16, device=dev)
    cfg = te.EmbedConfig()
    L, n = len(li.landmarks), g.n
    dist = torch.from_numpy(np.ascontiguousarray(li.dist_to_lm, dtype=np.int32)).to(dev)
    lm_dist = dist[torch.from_numpy(li.landmarks.astype(np.int64)).to(dev)]

    def nodes(dist, lm, noise):
        return te.embed_nodes(dist, lm, cfg.node_steps, cfg.lr, noise=noise).cpu().numpy()

    for seed in range(cfg.seed, cfg.seed + args.seeds):
        gen = torch.Generator().manual_seed(seed)
        lm_noise = torch.randn((L, cfg.dim), generator=gen)
        node_noise = torch.randn((n, cfg.dim), generator=gen)
        lm = te.embed_landmarks(lm_dist, cfg.dim, cfg.lm_steps, cfg.lr, noise=lm_noise)
        base = (nodes(dist, lm, node_noise), lm.cpu().numpy())
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(L)).to(dev)
        inv = torch.argsort(perm)
        lm_p = te.embed_landmarks(lm_dist[perm][:, perm], cfg.dim, cfg.lm_steps, cfg.lr,
                                  noise=lm_noise[perm.cpu()])
        permuted = (nodes(dist[:, perm], lm_p, node_noise), lm_p[inv].cpu().numpy())
        moved = [compare(base, (nodes(dist, lm + 1e-6 * torch.randn(lm.shape, generator=gen)
                                      .to(dev), node_noise), base[1]), li, cfg)
                 for _ in range(args.shifts)]
        print(json.dumps(dict(seed=seed, device=str(dev),
                              rel_error=te.GraphEmbedding(base[0], li.landmarks, base[1], cfg)
                              .rel_error(li.dist_to_lm),
                              permuted=compare(base, permuted, li, cfg),
                              lm_plus_1e_6={k: max(m[k] for m in moved) for k in moved[0]})),
              flush=True)
    partial = {}
    for lm_steps, node_steps in ((0, 0), (cfg.lm_steps, 0), (cfg.lm_steps, 20),
                                 (cfg.lm_steps, cfg.node_steps)):
        c = te.EmbedConfig(lm_steps=lm_steps, node_steps=node_steps)
        emb = te.build_graph_embedding(li.dist_to_lm, li.landmarks, c, device=dev)
        partial[f"{lm_steps}+{node_steps}"] = emb.rel_error(li.dist_to_lm)
    print(json.dumps(dict(device=str(dev), rel_error_by_steps=partial)), flush=True)


if __name__ == "__main__":
    main()
