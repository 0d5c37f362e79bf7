"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `src/repro_torch/kernels/csrc`, holds each
against its plain PyTorch version on the card, serves the 262,144-node
power-law preset end to end through `ServingEngine` (hash and landmark
routing, dense and packed visited sets), checks the launch counts and the
results, and replays an oversubscribed run with a colliding cache on the
card and on the CPU, field by field. Any mismatch raises; there is no
fallback to the CPU. The last line is {"ok": true, "device": {...}}.

Needs one CUDA device; exits non-zero without one. Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak memory rate (NVIDIA data sheet)
MAIN_SHAPES = dict(B=16, F=4096, W=64, n=262144)  # one processor's hop at scale
EDGE_SHAPES = [  # word seams, F not a multiple of 128, tiny
    dict(B=3, F=5, W=7, n=33), dict(B=2, F=130, W=9, n=34),
    dict(B=4, F=17, W=3, n=142), dict(B=1, F=1, W=1, n=1),
]
KERNELS = {  # wrapper name -> (plain version, TPU kernel it replaces, device symbol)
    "frontier_expand_batched": ("frontier_expand_batched_ref",
                                "src/repro/kernels/frontier.py:190",
                                "frontier_dense_kernel"),
    "frontier_expand_packed": ("frontier_expand_packed_ref",
                               "src/repro/kernels/frontier.py:260",
                               "frontier_packed_kernel"),
}
KERNELS_BY_LAYOUT = {"dense": "frontier_expand_batched",
                     "packed": "frontier_expand_packed"}
SOURCE = "src/repro_torch/kernels/csrc/frontier.cu"
TIMING_FIELDS = ("wall_s", "throughput_qps")


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_inputs(B, F, W, n, device, seed=0):
    """Random hop inputs: ids in [-1, n + 4) (padding and ids >= n
    included), degrees in [0, W], a quarter of the rows all padding, and a
    visited set about 1/16 full."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = torch.randint(-1, n + 4, (B, F, W), generator=g, dtype=torch.int32)
    deg = torch.randint(0, W + 1, (B, F), generator=g, dtype=torch.int32)
    pad = torch.rand((B, F), generator=g) < 0.25
    rows[pad] = -1
    deg[pad] = 0
    vis = torch.rand((B, n), generator=g) < 1 / 16
    return rows.to(device), deg.to(device), vis.to(device)


def call(kind, fr, ref, rows, deg, vis, n, kernel: bool):
    """Run the kernel or its plain version on a fresh copy of the visited set."""
    if kind == "frontier_expand_batched":
        fn = fr.frontier_expand_batched if kernel else ref.frontier_expand_batched_ref
        return fn(rows, deg, vis.clone())
    words = fr.pack_words(vis)
    fn = fr.frontier_expand_packed if kernel else ref.frontier_expand_packed_ref
    return fn(rows, deg, words, n)


def median_ms(fn, reps: int = 30) -> float:
    """Median over `reps` launches, each timed with CUDA events (after warm-up)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(kind, rows, deg, vis) -> float:
    """Least time at the HBM rate for the in-place update on these inputs:
    deg read once and the row entries below each row's degree read once
    (entries past it need not be read); then the visited state the update
    must touch. Dense writes one byte per distinct in-range target and need
    not read the set; packed reads and writes each distinct word that takes
    a bit (the merge into a word is a read-modify-write)."""
    B, F, W = rows.shape
    n = vis.shape[1]
    live = torch.arange(W, device=rows.device) < deg.unsqueeze(-1)
    ids = rows.long()
    hit = live & (ids >= 0) & (ids < n)
    b = torch.arange(B, device=rows.device).view(B, 1, 1).expand_as(ids)
    if kind == "frontier_expand_batched":
        vis_bytes = torch.unique((b * n + ids)[hit]).numel()
    else:
        nw = -(-n // 32)
        vis_bytes = 2 * 4 * torch.unique((b * nw + (ids >> 5))[hit]).numel()
    return (4 * B * F + 4 * int(live.sum()) + vis_bytes) / HBM_BYTES_PER_S * 1e3


def check_kernels(device):
    from repro_torch.kernels import frontier as fr
    from repro_torch.kernels import ref

    rows_out = {}
    for kind in KERNELS:
        max_err = 0
        for shapes in [MAIN_SHAPES] + EDGE_SHAPES:
            rows, deg, vis = kernel_inputs(**shapes, device=device)
            n = shapes["n"]
            out_k = call(kind, fr, ref, rows, deg, vis, n, kernel=True)
            torch.cuda.synchronize()
            out_p = call(kind, fr, ref, rows, deg, vis, n, kernel=False)
            err = int((out_k.long() - out_p.long()).abs().max()) if out_k.numel() else 0
            if not torch.equal(out_k, out_p):
                raise AssertionError(f"{kind} != plain version at {shapes} (max err {err})")
            max_err = max(max_err, err)
        rows, deg, vis = kernel_inputs(**MAIN_SHAPES, device=device)
        n = MAIN_SHAPES["n"]
        words = fr.pack_words(vis)
        if kind == "frontier_expand_batched":
            k_ms = median_ms(lambda: fr.frontier_expand_batched(rows, deg, vis))
            p_ms = median_ms(lambda: ref.frontier_expand_batched_ref(rows, deg, vis))
        else:
            k_ms = median_ms(lambda: fr.frontier_expand_packed(rows, deg, words, n))
            p_ms = median_ms(lambda: ref.frontier_expand_packed_ref(rows, deg, words, n))
        b_ms = bound_ms(kind, rows, deg, vis)
        rows_out[kind] = dict(name=kind, route="cuda", source=SOURCE,
                              replaces=KERNELS[kind][1], launches=0,
                              max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
                              bound_ms=b_ms, bound_by="bytes", library_ms=None)
        log(f"[kernel] {kind}: exact vs {KERNELS[kind][0]} at {MAIN_SHAPES} and "
            f"{len(EDGE_SHAPES)} edge shapes; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {b_ms * 1e3:.2f} us (bytes / 3.35 TB/s)")
    return rows_out


# ---------------------------------------------------------------------------
# Phases 4 and 5: the serving engine
# ---------------------------------------------------------------------------


def make_engine(tier, li, scheme, cfg, device):
    from repro_torch.core.router import Router, RouterConfig
    from repro_torch.serve.engine import ServingEngine

    router = Router(cfg.n_processors, RouterConfig(scheme=scheme), landmark_index=li,
                    seed=3, device=device)
    return ServingEngine(tier, router, cfg, device=device)


def assert_same_result(a, b, what):
    for f in dataclasses.fields(a):
        if f.name in TIMING_FIELDS:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "per_round":
            bad = [k for k in x if not np.array_equal(x[k], y[k])]
            if bad or set(x) != set(y):
                raise AssertionError(f"{what}: per_round differs in {bad}")
        elif isinstance(x, np.ndarray) or x is None:
            if not (x is None and y is None) and not np.array_equal(x, y):
                raise AssertionError(f"{what}: {f.name} differs")
        elif x != y:
            raise AssertionError(f"{what}: {f.name} {x} != {y}")


def main_path(device, preset="large", n_queries=256, n_landmarks=24):
    """Phase 4: the repo's scale run (benchmarks/bench_engine.py _scale_bench
    settings) with the kernels, against the same runs on the scatter backend."""
    from repro_torch.core.landmarks import build_landmark_index
    from repro_torch.core.storage import build_storage
    from repro_torch.core.workloads import preset_workload
    from repro_torch.graph.csr import to_padded
    from repro_torch.kernels import frontier as fr
    from repro_torch.serve.engine import EngineRunConfig

    t = time.perf_counter()
    g, wl = preset_workload(preset, n_queries=n_queries, seed=0)
    adj = to_padded(g, max_degree=64)
    tier = build_storage(adj, n_shards=4, device=device)
    t_graph = time.perf_counter() - t
    t = time.perf_counter()
    li = build_landmark_index(g, n_processors=4, n_landmarks=n_landmarks, device=device)
    t_lm = time.perf_counter() - t
    log(f"[main] graph {g.n} nodes, {g.e} directed edges, max degree "
        f"{int(g.degree().max())}; {adj.n_rows} padded rows, storage "
        f"{tier.shard_rows.numel() * 4 / 1e6:.1f} MB; built in {t_graph:.1f} s; "
        f"landmark index ({n_landmarks} landmarks) on the card in {t_lm:.1f} s")
    base = EngineRunConfig(
        n_processors=4, round_size=16, capacity=16, hops=2, max_frontier=4096,
        cache_sets=4096, cache_ways=8, chain_depth=64, expand_backend="cuda")
    launches = {k: 0 for k in KERNELS}
    cells = []
    for scheme in ("hash", "landmark"):
        by_layout = {}
        for layout in ("dense", "packed"):
            cfg = dataclasses.replace(base, visited_layout=layout)
            eng = make_engine(tier, li, scheme, cfg, device)
            fr.LAUNCHES.clear()  # counts of this main-path run only
            res, _ = eng.run(wl)
            counted = dict(fr.LAUNCHES)
            kernel = KERNELS_BY_LAYOUT[layout]
            if counted.get(kernel, 0) == 0 or sum(counted.values()) != counted[kernel]:
                raise AssertionError(f"{scheme}/{layout}: launches {counted}")
            for k, v in counted.items():
                launches[k] += v
            if not res.completed.all():
                raise AssertionError(f"{scheme}/{layout}: not every query completed")
            ref_res, _ = make_engine(tier, li, scheme, dataclasses.replace(
                cfg, expand_backend="scatter"), device).run(wl)
            assert_same_result(res, ref_res, f"{scheme}/{layout} cuda vs scatter")
            by_layout[layout] = res
            rounds = len(res.per_round["counts"])
            cell = dict(scheme=scheme, layout=layout, qps=res.throughput_qps,
                        hit_rate=res.hit_rate, reads=res.reads, wall_s=res.wall_s,
                        scatter_wall_s=ref_res.wall_s, truncated=res.truncated,
                        rounds=rounds, launches=counted[kernel],
                        launches_per_round=counted[kernel] / rounds)
            cells.append(cell)
            log(f"[main] {scheme:>8s} {layout:>6s}: qps {res.throughput_qps:.2f} "
                f"hit {res.hit_rate:.4f} reads {res.reads} wall {res.wall_s:.3f} s "
                f"(scatter backend {ref_res.wall_s:.3f} s) truncated {res.truncated} "
                f"{kernel} launches {counted[kernel]} over {rounds} rounds")
        d, p = by_layout["dense"], by_layout["packed"]
        if not (np.array_equal(d.counts, p.counts) and d.reads == p.reads):
            raise AssertionError(f"{scheme}: counts/reads differ across layouts")
    profiles = [profile_cell(tier, li, wl, base, "landmark", layout, device)
                for layout in ("dense", "packed")]
    return launches, cells, profiles


def profile_cell(tier, li, wl, base, scheme, layout, device):
    """One more run of a main-path cell under torch.profiler: the card's busy
    time (sum of kernel times; one stream, so kernels do not overlap) against
    the wall of an unprofiled run, the kernels that take the most, and the
    frontier kernel's own time per launch on the path's real inputs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(base, visited_layout=layout)
    wall = make_engine(tier, li, scheme, cfg, device).run(wl)[0].wall_s
    eng = make_engine(tier, li, scheme, cfg, device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run(wl)
    by_name = {}  # device-side events only: kernels and copies
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    busy_s = sum(us for us, _ in by_name.values()) / 1e6
    log(f"[profile] {scheme}/{layout}: device busy {busy_s:.3f} s of an unprofiled "
        f"wall of {wall:.3f} s (busy share {busy_s / wall:.4f}); top device ops:")
    for name, (us, calls) in top[:12]:
        log(f"[profile]   {us / 1e3:10.3f} ms  {calls:7d} calls  {name[:100]}")
    kernel = KERNELS_BY_LAYOUT[layout]
    symbol = KERNELS[kernel][2]
    k_us = sum(us for name, (us, _) in by_name.items() if symbol in name)
    k_calls = sum(c for name, (_, c) in by_name.items() if symbol in name)
    if k_calls == 0:
        raise AssertionError(f"profile of {scheme}/{layout} shows no {symbol}")
    log(f"[profile] {kernel} on the path: {k_us / 1e3:.3f} ms over {k_calls} "
        f"launches, {k_us / 1e3 / k_calls:.5f} ms per launch")
    return dict(scheme=scheme, layout=layout, wall_s=wall, device_busy_s=busy_s,
                busy_share=busy_s / wall, kernel=kernel, kernel_ms=k_us / 1e3,
                kernel_calls=k_calls, kernel_ms_per_launch=k_us / 1e3 / k_calls,
                top=[dict(name=n[:100], ms=us / 1e3, calls=c) for n, (us, c) in top[:12]])


def oversubscribed(device, cpu="cpu"):
    """Phase 5: 2x oversubscription, colliding cache (64 sets x 2 ways), the
    run on `device` against the port's run on the CPU, field by field."""
    from repro_torch.core.landmarks import build_landmark_index
    from repro_torch.core.storage import build_storage
    from repro_torch.core.workloads import preset_workload
    from repro_torch.graph.csr import to_padded
    from repro_torch.serve.engine import EngineRunConfig

    g, wl = preset_workload("small", n_queries=128, seed=0)
    adj = to_padded(g, max_degree=64)
    li = build_landmark_index(g, n_processors=4, n_landmarks=16, device=device)
    P, B = 4, 16
    for scheme in ("hash", "landmark"):
        for layout in ("dense", "packed"):
            cfg = EngineRunConfig(
                n_processors=P, round_size=B, capacity=B // (2 * P), hops=2,
                max_frontier=4096, cache_sets=64, cache_ways=2, chain_depth=64,
                backlog_capacity=2 * B, track_touched=True, expand_backend="cuda",
                visited_layout=layout)
            results = []
            for dev in (device, cpu):
                tier = build_storage(adj, n_shards=4, device=dev)
                res, _ = make_engine(tier, li, scheme, cfg, dev).run(wl)
                results.append(res)
            assert_same_result(results[0], results[1],
                               f"oversubscribed {scheme}/{layout} {device} vs cpu")
            r = results[0]
            log(f"[oversub] {scheme:>8s} {layout:>6s}: completed "
                f"{int(r.completed.sum())} dropped {r.n_dropped} peak backlog "
                f"{r.peak_backlog} stolen {r.stolen} hit {r.hit_rate:.4f} -- "
                f"equal to the CPU run")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.kernels import build

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {kind}; {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    t = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t:.2f} s")

    kernels = check_kernels(device)
    launches, cells, profiles = main_path(device)
    for k, v in launches.items():
        kernels[k]["launches"] = v
        rounds = sum(c["rounds"] for c in cells if KERNELS_BY_LAYOUT[c["layout"]] == k)
        log(f"[kernel] {k}: {v} launches on the main path, {v / rounds:.1f} per "
            f"engine round of 4 processors")
    oversubscribed(device)

    log(json.dumps({"cells": cells, "profiles": profiles}))
    log(smi)
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
