"""gRouting serving launcher: the paper's cluster in the event-driven
simulator.

    PYTHONPATH=src python -m repro_torch.launch.serve [--scheme all|no_cache|next_ready|hash|landmark|embed] \\
        [--nodes 20000] [--degree 8] [--processors 4] [--workload hotspot|concentrated|uniform] \\
        [--hops 3] [--cache-entries 16384] [--landmarks 32] [--device cuda|cpu] [--device-path]

Builds a synthetic power-law graph, preprocesses the landmark index and
the graph embedding on `--device` (the BFS and Algorithm 3's Adam run
there), and serves the workload through the event-driven cluster
(`core.serving`) on the host, one paper-style row per scheme: throughput,
mean response time, hit rate, stolen queries. The qps and milliseconds are
derived from the cost model calibrated to the paper's RAMCloud cluster
(`core.costmodel`), not measured on the device; the hit rate and stolen
counts are the simulator's own.

For the device path (set-associative caches, the sharded multi_read over
torch.distributed) use `python -m repro_torch.launch.serve_graph`;
`--device-path` prints that pointer and serves nothing.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.core.costmodel import DERIVED

SCHEMES = ("no_cache", "next_ready", "hash", "landmark", "embed")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=20000)
    ap.add_argument("--degree", type=int, default=8)
    ap.add_argument("--processors", type=int, default=4)
    ap.add_argument("--scheme", default="all", choices=("all",) + SCHEMES)
    ap.add_argument("--workload", default="hotspot",
                    choices=["hotspot", "concentrated", "uniform"])
    ap.add_argument("--hops", type=int, default=3)
    ap.add_argument("--cache-entries", type=int, default=1 << 14)
    ap.add_argument("--landmarks", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the landmark BFS and the embedding train")
    ap.add_argument("--device-path", action="store_true")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> list:
    """Serve the workload once per scheme; returns the `SimResult`s (none
    with `--device-path`)."""
    args = parse_args(argv)

    from repro_torch.core.embedding import EmbedConfig, build_graph_embedding
    from repro_torch.core.landmarks import build_landmark_index
    from repro_torch.core.serving import (
        BallCache, ServingSimulator, SimRouter, SimRouterConfig,
    )
    from repro_torch.core.workloads import (
        concentrated_workload, hotspot_workload, uniform_workload,
    )
    from repro_torch.device import resolve_device
    from repro_torch.graph.generators import powerlaw_graph

    dev = resolve_device(args.device)
    g = powerlaw_graph(n=args.nodes, m=args.degree, seed=0)
    print(f"[serve] graph n={g.n} e={g.e}")
    li = build_landmark_index(g, n_processors=args.processors,
                              n_landmarks=args.landmarks, device=dev)
    ge = build_graph_embedding(li.dist_to_lm, li.landmarks,
                               EmbedConfig(dim=10, lm_steps=300, node_steps=100), device=dev)
    print(f"[serve] preprocessing done on {dev} "
          f"(embed rel-err {ge.rel_error(li.dist_to_lm):.3f})")

    wl = {
        "hotspot": lambda: hotspot_workload(g, r=2, seed=1),
        "concentrated": lambda: concentrated_workload(g, seed=1),
        "uniform": lambda: uniform_workload(g, seed=1),
    }[args.workload]()

    if args.device_path:
        print("[serve] device path: python -m repro_torch.launch.serve_graph "
              "(the distributed serving step with set-associative caches)")
        return []

    schemes = list(SCHEMES) if args.scheme == "all" else [args.scheme]
    print(f"[serve] qps and resp {DERIVED}; hit and stolen simulated")
    balls = BallCache(g)
    results = []
    for scheme in schemes:
        rt = SimRouter(args.processors, SimRouterConfig(scheme=scheme),
                       landmark_index=li, embedding=ge)
        sim = ServingSimulator(
            g, args.processors, rt, cache_entries=args.cache_entries,
            h=args.hops, use_cache=(scheme != "no_cache"), ball_cache=balls,
        )
        res = sim.run(wl)
        print(res.row())
        results.append(res)
    return results


if __name__ == "__main__":
    main()
