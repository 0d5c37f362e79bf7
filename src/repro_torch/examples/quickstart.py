"""Quickstart: the paper's full pipeline (the reference's
`examples/quickstart.py`).

Builds a community graph, runs Algorithm 1 (landmarks; the BFS on the
device) and Algorithm 3 (the embedding; Adam on the device), then serves a
hotspot workload through every routing scheme on the decoupled cluster
simulator (`core/serving.py`, on the host) and prints paper-style rows:
throughput, response time, cache hit rate, stolen queries. The qps and
milliseconds are derived from the cost model calibrated to the paper's
RAMCloud cluster (`core/costmodel.py`), not measured on any device; the
hit rate and the stolen count are the simulator's own.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional

import torch

from repro_torch.core.costmodel import DERIVED
from repro_torch.core.embedding import EmbedConfig, build_graph_embedding
from repro_torch.core.landmarks import build_landmark_index
from repro_torch.core.serving import BallCache, ServingSimulator, SimResult, SimRouter, \
    SimRouterConfig
from repro_torch.core.workloads import hotspot_workload
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.generators import community_graph

SCHEMES = ("no_cache", "next_ready", "hash", "landmark", "embed")


def run(n: int = 12000, community_size: int = 60, n_processors: int = 4,
        n_landmarks: int = 32, embed: EmbedConfig = EmbedConfig(dim=10, lm_steps=300,
                                                                node_steps=120),
        n_hotspots: int = 60, queries_per_hotspot: int = 10, cache_entries: int = 400,
        hops: int = 3, device: DeviceLike = None, lm_noise: Optional[torch.Tensor] = None,
        node_noise: Optional[torch.Tensor] = None,
        out: Callable[[str], None] = print) -> List[SimResult]:
    """The quickstart at the given sizes (the defaults are the reference's);
    prints its rows through `out` and returns one `SimResult` a scheme.
    lm_noise / node_noise: the embedding's init draws (`build_graph_embedding`)."""
    dev = resolve_device(device)
    out("== gRouting quickstart ==")
    g = community_graph(n=n, community_size=community_size, intra_degree=6,
                        inter_degree=1.0, seed=0)
    out(f"graph: {g.n} nodes, {g.e} directed edges (bi-directed)")

    # --- preprocessing (Algorithms 1 & 3) on the device -----------------
    li = build_landmark_index(g, n_processors=n_processors, n_landmarks=n_landmarks,
                              min_separation=3, device=dev)
    out(f"landmarks: {len(li.landmarks)}; router table d(u,p): "
        f"{li.dist_to_proc.shape} = O(nP) ints")
    ge = build_graph_embedding(li.dist_to_lm, li.landmarks, embed, device=dev,
                               lm_noise=lm_noise, node_noise=node_noise)
    out(f"embedding: {ge.coords.shape} = O(nD) floats; "
        f"rel. distance error {ge.rel_error(li.dist_to_lm):.3f}")

    # --- serve a 2-hop-hotspot, 3-hop-traversal workload -----------------
    wl = hotspot_workload(g, r=2, n_hotspots=n_hotspots,
                          queries_per_hotspot=queries_per_hotspot, seed=1)
    out(f"workload: {wl.query_nodes.size} queries "
        f"({len(set(wl.hotspot_id.tolist()))} hotspots)")
    out(f"qps and resp_ms {DERIVED}; hit and stolen simulated")
    balls = BallCache(g)
    out(f"{'scheme':>10s}  {'qps':>9s}  {'resp_ms':>8s}  {'hit':>6s}  stolen")
    results = []
    for scheme in SCHEMES:
        rt = SimRouter(n_processors, SimRouterConfig(scheme=scheme),
                       landmark_index=li, embedding=ge)
        sim = ServingSimulator(g, n_processors, rt, cache_entries=cache_entries, h=hops,
                               use_cache=(scheme != "no_cache"), ball_cache=balls)
        r = sim.run(wl)
        out(f"{scheme:>10s}  {r.throughput_qps:9.1f}  {r.mean_response_ms:8.3f}  "
            f"{r.hit_rate:6.3f}  {r.stolen}")
        results.append(r)
    out("\nsmart routing (landmark/embed) should show the highest hit rates"
        "\nand lowest response times -- the paper's core claim.")
    return results


def main(argv: Optional[List[str]] = None) -> List[SimResult]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the landmark BFS and the embedding run")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
