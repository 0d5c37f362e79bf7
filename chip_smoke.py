"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `src/repro_torch/kernels/csrc`, then:

  1. holds each kernel against its plain PyTorch version on the card
     (the frontier kernels at a synthetic hop of the serving shape, at
     edge shapes and at a hop whose offsets need 64-bit indices, timed
     beside an all-padding hop, their floor; the
     flash-attention kernel at the Qwen3-4B prefill shape, a Gemma2-like
     local layer and small, ragged and fully masked cases in both dtypes,
     each shape profiled to show its route: bf16 on the tensor cores,
     float32 on the CUDA cores), with times and bounds; the single-query
     entry points (`ops.frontier_expand`, `_packed`) at the edge shapes;
  2. trains the graph embedding (Algorithm 3) on the card for the
     262,144-node power-law preset and profiles its two stages; serves the
     preset end to end through `ServingEngine` (hash, landmark, embed and
     next_ready routing, dense and packed visited sets), checks the launch
     counts and the results, and profiles the landmark cells;
     then runs each landmark cell once more with every frontier launch's
     inputs recorded (live rows and entries, targets, bound), sums them
     against the profile, and replays a sample of the launches: bit-equal
     to the plain version and to a second launch, no host sync, timed;
     graph updates (§3.4): `incremental_add_node` for existing nodes and
     a new one, `incremental_embed_node` for them; h-hop reachability
     (cuda against scatter, both layouts) and a random walk (card against
     CPU) over the preset's queries; last, the paper's decoupled cluster
     over torch.distributed (`serve.graph_serving`) at a world of one over
     NCCL: a one-shard tier, the preset's queries admitted by the embed
     router in 1.5x-oversubscribed bursts, then the drain, both layouts,
     each burst bit-equal to the single-host `processor_round` over the
     4-shard tier, its collectives counted and one burst profiled;
  3. trains the embedding of a 4,800-node preset on the card and on the
     CPU from the same draws, for four seeds, and holds the coordinates,
     each node's own loss and rel_error together, with readings after 1,
     10 and 100 steps of each stage; replays an
     oversubscribed run with a colliding cache on the card and on the CPU,
     field by field, for all four routing schemes;
  4. serves Qwen3-4B at full width in bf16 (random weights from a seed):
     4 prompts of 4,096 tokens prefilled, then 64 greedy decode steps;
     checks 36 flash launches per prefill and none in decode, finite
     logits, and that teacher-forced decode of the last prompt token
     gives the prefill's last logits; profiles one prefill; then serves
     the MoE LMs the same way: qwen2-moe-a2.7b whole (24 layers, 60
     experts computed as 64, top-4, a shared expert; 30.30 GB) and
     dbrx-132b at full width cut to 4 of its 40 layers (28.54 GB), each
     at its capacity factor: one flash launch a layer, the share of
     assignments dropped in each layer, a repeat bit-equal, bf16
     teacher-forced decode against a drop-free prefill (printed), a
     profile by kind (expert GEMMs, dispatch, router, flash, the rest),
     one MoE layer with no host sync and held in bf16 against float32;
     then both served models again in float32, drop-free, where
     teacher-forced decode must route as prefill in every layer and give
     its logits within a tolerance;
  5. runs a 2-layer Qwen3-4B at full width in float32 on the card and on
     the CPU and holds the prefill's logits and KV against each other;
     and a 2-layer qwen2-moe-a2.7b likewise, whose routing (top-k, ranks,
     kept assignments) must be equal on every token;
  6. aggregates (sum, mean, max, min, std) width-75 messages over
     synthetic edges at the repo's ogb_products shape (2,449,029 nodes,
     61,859,140 edges, power-law skewed, 2 % padded): 7 segment_sum launches
     a call, checked against float64 with a self-checked tolerance,
     profiled and timed beside index_add_; two launches bit-equal, the
     task table built with no host sync, what the idle chunk teams cost,
     and a hub-only segment of 2^20 edges (read in order and in a random
     order) against its bound;
  7. looks up DIN's histories (serve_bulk, serve_p99) in its full item
     table (1,048,576 x 18) by embedding_bag, sum and mean, weighted and
     not: one launch a call, checked against float64, a second call
     bit-equal to the first, timed on the profile's device clock (and by
     CUDA events) beside F.embedding_bag and three bounds;
  8. holds both on the card against the CPU at a small size, and shows
     that float16 computes on the CPU and raises on the card.

Phase 1 also holds segment_sum and embedding_bag against their plain
versions in float64 over case grids (the test grids and edge cases; for
the bag, every branch of its kernel, each read back from a profile).

Any mismatch raises; there is no fallback to the CPU. The last line is
{"ok": true, "device": {...}}.

Needs one CUDA device; exits non-zero without one. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak memory rate (NVIDIA data sheet)
# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, float32 CUDA cores
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
MAIN_SHAPES = dict(B=16, F=4096, W=64, n=262144)  # one processor's hop at scale
EDGE_SHAPES = [  # word seams, F not a multiple of 128, tiny
    dict(B=3, F=5, W=7, n=33), dict(B=2, F=130, W=9, n=34),
    dict(B=4, F=17, W=3, n=142), dict(B=1, F=1, W=1, n=1),
]
# a hop a layout whose offsets take frontier.cu's 64-bit indices: B*n bytes
# of the dense set (2 GB) or n bits of the packed one past INT_MAX
WIDE_SHAPES = {"frontier_expand_batched": dict(B=2, F=64, W=8, n=2**30 + 3),
               "frontier_expand_packed": dict(B=1, F=64, W=8, n=2**31 + 33)}
CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = {  # wrapper name -> (plain version, TPU kernel it replaces, device symbol, source)
    "frontier_expand_batched": ("frontier_expand_batched_ref",
                                "src/repro/kernels/frontier.py:190",
                                "frontier_dense_kernel", CSRC + "frontier.cu"),
    "frontier_expand_packed": ("frontier_expand_packed_ref",
                               "src/repro/kernels/frontier.py:260",
                               "frontier_packed_kernel", CSRC + "frontier.cu"),
    "flash_attention": ("attention_ref", "src/repro/kernels/flash_attention.py:99",
                        "flash_attention_kernel", CSRC + "flash_attention.cu"),
    "segment_sum": ("segment_sum_ref", "src/repro/kernels/segment_reduce.py:70",
                    "segment_sum_kernel", CSRC + "segment_sum.cu"),
    "embedding_bag": ("embedding_bag_ref", "src/repro/kernels/embedding_bag.py:51",
                      "embedding_bag_kernel", CSRC + "embedding_bag.cu"),
}
KERNELS_BY_LAYOUT = {"dense": "frontier_expand_batched",
                     "packed": "frontier_expand_packed"}
TIMING_FIELDS = ("wall_s", "throughput_qps")
PROFILE_PAD = 64  # spin kernels ahead of a profiled call (see device_ops)
# profiles of one call while the trace lacks the kernel sought (the
# profiler has dropped a short call's events three times in a row)
PROFILE_TRIES = 5

# flash attention against its plain version: (name, B, Hq, Hkv, Sq, Skv, D,
# causal, window, softcap, dtype); the first is the Qwen3-4B prefill shape
# of one request, whose numbers go into the kernel line, then the MoE LMs'
# (qwen2-moe-a2.7b: 16/16 heads, group 1; dbrx-132b: 48/8, group 6); D 77
# takes the bf16 kernel's element-wise fill (D % 8 != 0), every other bf16
# shape cp.async
ATTN_SHAPES = [
    ("qwen3-4b prefill", 1, 32, 8, 4096, 4096, 128, True, None, None, torch.bfloat16),
    ("qwen2-moe prefill", 1, 16, 16, 4096, 4096, 128, True, None, None, torch.bfloat16),
    ("dbrx prefill", 1, 48, 8, 4096, 4096, 128, True, None, None, torch.bfloat16),
    ("gemma2-like local", 1, 32, 16, 8192, 8192, 128, True, 4096, 50.0, torch.bfloat16),
    ("float32 GQA", 1, 8, 2, 1024, 1024, 128, True, None, None, torch.float32),
    ("MQA", 2, 16, 1, 2048, 2048, 128, True, None, None, torch.bfloat16),
    ("bidirectional", 2, 8, 8, 1024, 1024, 64, False, None, None, torch.bfloat16),
    ("ragged, window+softcap", 2, 4, 2, 77, 77, 32, True, 30, 20.0, torch.float32),
    ("ragged Sq != Skv", 1, 4, 2, 100, 300, 16, False, None, None, torch.float32),
    ("fully masked rows", 1, 4, 2, 128, 128, 64, True, 0, None, torch.float32),
    ("ragged, window+softcap", 2, 4, 2, 77, 77, 32, True, 30, 20.0, torch.bfloat16),
    ("ragged Sq != Skv", 1, 4, 2, 100, 300, 16, False, None, None, torch.bfloat16),
    ("fully masked rows", 1, 4, 2, 128, 128, 64, True, 0, None, torch.bfloat16),
    ("D 80", 1, 8, 2, 1000, 1000, 80, True, None, None, torch.bfloat16),
    ("D 77, window+softcap", 1, 4, 2, 200, 333, 77, True, 50, 30.0, torch.bfloat16),
]
# the kernel each dtype must take: bf16 the tensor cores, float32 the CUDA cores
FLASH_ROUTES = {torch.bfloat16: ("tensor cores", "flash_attention_kernel_tc<"),
                torch.float32: ("CUDA cores", "flash_attention_kernel<")}
ROUTE_LAUNCHES = 3  # profiled flash launches a shape for the route check
# (atol, rtol) of the kernel against the plain version on float32 copies of
# its inputs, which is what the kernel computes: the bf16 output rounds by
# at most 2^-8 relative, the float32 one by sums in another order
ATTN_TOL = {torch.bfloat16: (1e-3, 1e-2), torch.float32: (2e-5, 2e-5)}
LEAK_KEYS = 64  # the tolerance self-check: a kernel that leaks one key tile

# segment sum against float64: float32 rounding errors of random sign grow
# like sqrt(L) 2^-24 sum|v| over a segment of L edges, far below 1e-6 sum|v|;
# an edge dropped or counted twice moves a row by |v| (SEG_GRID: name, E,
# D, N, ids, dtype; the first five are tests/test_kernels.py's SEG_CASES)
SEG_REL, SEG_ABS = 1e-6, 1e-6
SEG_GRID = [
    ("64x8 N16", 64, 8, 16, "valid", torch.float32),
    ("128x16 N32", 128, 16, 32, "valid", torch.float32),
    ("300x8 N10 -1", 300, 8, 10, "invalid", torch.float32),
    ("512x128 N64 -1", 512, 128, 64, "invalid", torch.float32),
    ("100x4 N7 -1", 100, 4, 7, "invalid", torch.float32),
    ("sparse ids", 128, 4, 10_000, "sparse", torch.float32),
    ("ids >= N", 2000, 16, 50, "wide", torch.float32),
    ("all -1", 100, 8, 10, "none", torch.float32),
    ("E 1", 1, 5, 3, "valid", torch.float32),
    ("D 1", 5000, 1, 100, "invalid", torch.float32),
    ("D 75 skewed", 200_000, 75, 5000, "skewed", torch.float32),
    ("D 129", 3000, 129, 200, "wide", torch.float32),
    ("bf16 D 75", 4000, 75, 300, "invalid", torch.bfloat16),
    # a hub of >= 10^5 edges, split into tasks; segments of K - 1, K, K + 1,
    # 2K and 2K + 1 edges (K = segment_reduce.TASK_EDGES; E from K)
    ("hub D 75", 120_000, 75, 64, "hub", torch.float32),
    ("hub D 1", 120_000, 1, 64, "hub", torch.float32),
    ("bf16 hub D 75", 120_000, 75, 64, "hub", torch.bfloat16),
    ("K +- 1 edges D 75", None, 75, 9, "k", torch.float32),
    ("K +- 1 edges D 3", None, 3, 9, "k", torch.float32),
]
# embedding bag against float64: BAG_REL sum_l |w row| per element, as for
# the segment sum. BAG_GRID: name, B, L, V, D, combine, weighted, dtype,
# ids drawn below `hi` (V when None), the table's base moved by `shift`
# elements (a contiguous view), and the padding: "25%" of the entries,
# "all", "tail" (each bag's valid entries first, then >= 32 of -1) or
# "past V" (every id >= V, then 25 % padding). The first four are
# tests/test_kernels.py's BAG_CASES. Together the cases take every branch
# of csrc/embedding_bag.cu, <T, VEC> (BAG_BRANCHES), and rows of one to
# seventeen column passes: each case's branch is named in the log and read
# back from a profile of its launch.
BAG_REL = 1e-6
F32, BF16 = torch.float32, torch.bfloat16
BAG_GRID = [
    ("16x4 V64 D8 sum", 16, 4, 64, 8, "sum", False, F32, None, 0, "25%"),
    ("64x12 V256 D16 sum w", 64, 12, 256, 16, "sum", True, F32, None, 0, "25%"),
    ("32x8 V128 D4 mean w", 32, 8, 128, 4, "mean", True, F32, None, 0, "25%"),
    ("130x5 V96 D8 mean", 130, 5, 96, 8, "mean", False, F32, None, 0, "25%"),
    ("ids >= V", 50, 6, 40, 18, "mean", True, F32, 60, 0, "25%"),
    ("all padding", 20, 7, 30, 18, "mean", False, F32, None, 0, "all"),
    ("B 1", 1, 100, 1000, 18, "sum", True, F32, None, 0, "25%"),
    ("D 1", 64, 9, 50, 1, "mean", True, F32, None, 0, "25%"),
    ("D 129", 40, 11, 300, 129, "sum", True, F32, None, 0, "25%"),
    ("bf16", 200, 100, 5000, 18, "mean", True, BF16, None, 0, "25%"),
    ("table[1:] D 18, base 8- not 16-byte aligned", 64, 40, 500, 18, "sum", True, F32, None,
     18, "25%"),
    ("D 18, base 4-byte aligned", 64, 40, 500, 18, "mean", True, F32, None, 1, "25%"),
    ("L 100, >= 32 padding at the tail", 300, 100, 2000, 18, "mean", True, F32, None, 0,
     "tail"),
    ("L 100, every id >= V", 30, 100, 64, 18, "sum", True, F32, None, 0, "past V"),
    ("L 32", 64, 32, 300, 18, "sum", False, F32, None, 0, "25%"),
    ("L 300, ten chunks", 40, 300, 2000, 18, "mean", True, F32, None, 0, "tail"),
    ("D 2", 64, 33, 100, 2, "mean", True, F32, None, 0, "25%"),
    ("D 2, base 4-byte aligned", 64, 33, 100, 2, "sum", True, F32, None, 1, "25%"),
    ("D 3", 64, 31, 100, 3, "sum", True, F32, None, 0, "25%"),
    ("D 7", 64, 65, 100, 7, "mean", False, F32, None, 0, "25%"),
    ("D 5", 64, 50, 100, 5, "sum", True, F32, None, 0, "25%"),
    ("D 33", 64, 50, 300, 33, "mean", True, F32, None, 0, "25%"),
    ("D 40", 32, 64, 300, 40, "mean", False, F32, None, 0, "25%"),
    ("D 66", 32, 64, 300, 66, "sum", True, F32, None, 0, "25%"),
    ("D 200, seventeen column passes", 16, 37, 100, 200, "mean", True, F32, None, 0, "25%"),
    ("bf16 D 1", 64, 40, 100, 1, "sum", True, BF16, None, 0, "25%"),
    ("bf16 D 2", 64, 40, 100, 2, "sum", True, BF16, None, 0, "25%"),
    ("bf16 D 2, base 2-byte aligned", 64, 40, 100, 2, "mean", True, BF16, None, 1, "25%"),
    ("bf16 D 33", 64, 40, 100, 33, "sum", False, BF16, None, 0, "25%"),
    ("bf16 D 4", 64, 40, 100, 4, "mean", True, BF16, None, 0, "25%"),
    ("bf16 D 7", 100, 50, 400, 7, "sum", True, BF16, None, 0, "25%"),
    ("bf16 D 8", 64, 40, 100, 8, "sum", True, BF16, None, 0, "25%"),
    ("bf16 D 5", 64, 40, 100, 5, "mean", True, BF16, None, 0, "25%"),
    ("bf16 D 16", 64, 40, 100, 16, "sum", False, BF16, None, 0, "25%"),
    ("bf16 table[1:] D 18", 64, 100, 500, 18, "sum", True, BF16, None, 18, "tail"),
    ("bf16 D 18, base 2-byte aligned", 64, 100, 500, 18, "mean", True, BF16, None, 1, "25%"),
    ("bf16 D 40", 32, 64, 300, 40, "sum", True, BF16, None, 0, "25%"),
    ("bf16 D 65", 32, 64, 300, 65, "mean", True, BF16, None, 0, "25%"),
    ("bf16 D 66", 32, 64, 300, 66, "sum", False, BF16, None, 0, "25%"),
    ("bf16 D 130", 16, 37, 100, 130, "sum", True, BF16, None, 0, "25%"),
]
BAG_TYPES = {F32: "float", BF16: "__nv_bfloat16"}  # T as the kernel's name spells it
BAG_BRANCHES = {(t, vec) for t in BAG_TYPES.values() for vec in (1, 2)}
CATCH_SHARE = 0.99  # a tolerance must catch a dropped item in this share of rows

# GNN aggregation (phase 6): configs/base.py ogb_products, configs/pna.py width
GNN_SHAPE = (2_449_029, 61_859_140, 75)  # nodes, edges, message width
HUB_EDGES = 1_048_576  # the hub-only shape: one segment of these edges, phase 6's width
AGG_KINDS = ("sum", "mean", "max", "min", "std")
SEG_LAUNCHES_PER_AGGREGATE = 7  # sum 1, mean 2, std 4 (max, min: plain)
PAD_SHARE = 0.02  # share of edge ids padded with -1
DIAG_COLS = 15  # columns held in float64 at a time
# DIN bag lookups (phase 7): configs/din.py item table and serve batches
DIN_TABLE = (1_048_576, 18)
DIN_BATCHES = {"serve_bulk": 262_144, "serve_p99": 512}
# card against CPU (phase 8)
CPU_GNN_SHAPE = (20_000, 400_000, 75)
CPU_DIN_BATCH = 4096

# Qwen3-4B serving (phase 4) and the card-vs-CPU check (phase 5)
LM_BATCH, LM_PROMPT, LM_DECODE, LM_MAX_SEQ = 4, 4096, 64, 4160
TEACHER_FORCED_REL_TOL = 0.1  # relative L2 error, bf16 decode vs prefill (PERF.md)
CARD_VS_CPU_TOL = 1e-3  # max error over max |value|, float32 (PERF.md)
# MoE serving (phase 4) and its card-vs-CPU check (phase 5): DBRX at full
# width keeps MOE_DBRX_LAYERS of its 40 layers (28.54 GB in bf16)
MOE_DBRX_LAYERS = 4
MOE_CPU_PROMPT = 256
# one MoE layer in bf16 against float32, max error over max |output|: the
# CPU tests' BF16_TOL (tests/test_torch_moe.py)
MOE_BF16_TOL = 2.0 ** -5
# relative L2 error, float32 teacher-forced decode vs prefill at the served
# depth (PERF.md): the model's own sensitivity, a prefill whose input moved
# by one ulp, reads 1.0e-3 to 2.8e-3 there, which no tolerance can undercut
TEACHER_FORCED_F32_REL_TOL = 1e-2

# graph routing (phases 2 and 3)
SCHEMES = ("hash", "landmark", "embed", "next_ready")
COORD_ATOL = 5e-4  # embedding coordinates, card vs CPU (tests/test_torch_embedding.py)
REL_ERROR_ATOL = 1e-5  # an embedding's rel_error, card vs CPU (the same tests)
# a trained embedding's rel_error: 0.116 at 262,144 nodes and 0.134 at
# 4,800 on every run; 0.476 untrained and 0.184 after 20 of its 200 node
# steps (embed_sensitivity.py, PERF.md)
EMBED_MAX_REL_ERROR = 0.15
EMBED_SEEDS = 4  # init draws trained on the card and on the CPU (phase 3)
# each node's own loss, card vs CPU: a rounding-level change (another sum
# order, landmarks moved by 1e-6) moves up to 8 of the 4,800 nodes by more
# than COORD_ATOL, one by 0.26 (into another minimum of its loss), but no
# node's loss by more than 7.6e-5, nor rel_error by more than 3.1e-7
# (embed_sensitivity.py on the CPU, PERF.md). COORD_ATOL is held at
# EmbedConfig().seed, where both sides' sums have read 2.3e-4 apart.
NODE_LOSS_ATOL = 1e-3
EMBED_STEP_READINGS = (1, 10, 100)  # steps after which card and CPU are compared
INCREMENTAL_MAX_REL = 0.5  # an incremental node's mean relative error (the reference test's)
NEW_NODE_EDGES = 4  # edges of the node appended to the graph
REACH_HOPS = (2, 3)
REACH_BATCH = 16
WALK_HOPS = 4
WALK_SEED = 11
# the distributed cluster at a world of one (phase 2, last): one query
# processor of DIST_QPP slots, 1.5x-oversubscribed bursts, a ring of
# DIST_BACKLOG; a read budget of every id one read can hold (DIST_QPP x
# max_frontier), so nothing overflows and one round of the exchange serves
DIST_QPP = 16
DIST_BACKLOG = 64
EMA_ATOL = 1e-6  # the EMA, distributed step vs single-host (tests/test_torch_graph_serving.py)
# the EMA vs Eq. 5 written out in float64 on the host, relative to the
# largest coordinate: float32 sums of <= 16 rows and a damped (alpha = 0.5)
# chain of bursts stay within a few ulps; a wrong update is off by O(1)
EMA_F64_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 1: kernels against their plain versions
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


def device_ops(fn, want=None):
    """{device op name: (us, calls)} of one `fn()` under torch.profiler.
    The trace can lose its first device events, so PROFILE_PAD short spin
    kernels go first and are left out of the result; the log says when
    the trace lost some of them. Inside a long run it has also lost every
    event of a profile, so when `want` is given and no op name holds it,
    `fn()` is profiled again, up to PROFILE_TRIES times in all."""
    for tries in range(1, PROFILE_TRIES + 1):
        by_name = {}
        for name, _, us in _device_events(fn):
            t, calls = by_name.get(name, (0.0, 0))
            by_name[name] = (t + us, calls + 1)
        if want is None or any(want in name for name in by_name):
            break
        log(f"[profile] try {tries} of {PROFILE_TRIES}: the trace holds no {want}")
    return by_name


def _device_events(fn):
    """[(name, start us, duration us)] of the device ops of one `fn()`, in
    the order they ran, the leading pad kernels left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()  # nothing queued before the trace starts
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    events, pads = [], 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if "spin_kernel" in e.name:
                pads += 1
                continue
            events.append((e.name, e.time_range.start, e.time_range.elapsed_us()))
    if pads < PROFILE_PAD:
        log(f"[profile] the trace kept {pads} of {PROFILE_PAD} leading pad kernels")
    return sorted(events, key=lambda e: e[1])


def launch_ms(fns, symbol=None, reps=20):
    """The median device time (ms) of one call of each of `fns`: all run
    `reps` times in turn under one profile, and a call's time is the sum of
    its device ops' times, in launch order (the kernel `symbol`'s alone
    when given). A kernel of a few microseconds is below what CUDA events
    around its launch can see (they time the host's launch path), so its
    own device time is read from the trace; a plain version, several ops a
    call, is read the same way. Without `symbol`, every fn must launch as
    many ops a call as the first does in a profile of its own. Profiled
    again, up to PROFILE_TRIES times, while the trace holds another number
    of events."""
    def run():
        for fn in fns:
            for _ in range(reps):
                fn()

    for fn in fns:  # warm-up
        fn()
    for tries in range(1, PROFILE_TRIES + 1):
        per_call = 1 if symbol else len(_device_events(fns[0]))
        times = [us for name, _, us in _device_events(run) if symbol is None or symbol in name]
        if per_call and len(times) == per_call * reps * len(fns):
            calls = np.add.reduceat(times, range(0, len(times), per_call))
            return [float(np.median(calls[i * reps:(i + 1) * reps])) / 1e3
                    for i in range(len(fns))]
        log(f"[profile] try {tries} of {PROFILE_TRIES}: {len(times)} {symbol or 'device'} "
            f"events for {reps * len(fns)} calls of {per_call}")
    raise AssertionError(f"no complete trace of {symbol or fns[0]} in {PROFILE_TRIES} profiles")


def hop_figures(kind, rows, deg, n) -> dict:
    """What one hop's inputs ask of the kernel: live rows (deg > 0), live
    entries (w < deg), the in-range targets among them (0 <= id < n), the
    distinct targets (dense) or words (packed) those touch, and `bound_ms`,
    the least time at the HBM rate for the in-place update: deg read once
    and the live entries read once (entries past a row's degree need not
    be read); then the visited state the update must touch. Dense writes
    one byte per distinct target and need not read the set; packed reads
    and writes each distinct word that takes a bit (the merge into a word
    is a read-modify-write)."""
    B, F, W = rows.shape
    live = torch.arange(W, device=rows.device) < deg.unsqueeze(-1)
    ids = rows.long()
    hit = live & (ids >= 0) & (ids < n)
    b = torch.arange(B, device=rows.device).view(B, 1, 1)
    if kind == "frontier_expand_batched":
        distinct = torch.unique((b * n + ids)[hit]).numel()
        vis_bytes = distinct
    else:
        distinct = torch.unique((b * -(-n // 32) + (ids >> 5))[hit]).numel()
        vis_bytes = 2 * 4 * distinct
    entries = int(live.sum())
    return dict(live_rows=int((deg > 0).sum()), live_entries=entries,
                in_range=int(hit.sum()), distinct=distinct,
                bound_ms=(4 * B * F + 4 * entries + vis_bytes) / HBM_BYTES_PER_S * 1e3)


def in_place(kind, rows, deg, vis, n, kernel=True):
    """A call of the kernel's wrapper, or of its plain version, that
    updates `vis` in place (to time)."""
    from repro_torch.kernels import frontier as fr
    from repro_torch.kernels import ref

    if kind == "frontier_expand_batched":
        fn = fr.frontier_expand_batched if kernel else ref.frontier_expand_batched_ref
        return lambda: fn(rows, deg, vis)
    fn = fr.frontier_expand_packed if kernel else ref.frontier_expand_packed_ref
    return lambda: fn(rows, deg, vis, n)


def max_err(out_k, out_p, what) -> int:
    """0 when two visited sets are bit-equal; else raises with their
    largest difference (as integers)."""
    if torch.equal(out_k, out_p):
        return 0
    diff = out_k != out_p
    err = int((out_k[diff].long() - out_p[diff].long()).abs().max())
    raise AssertionError(f"{what} (max err {err})")


def wide_inputs(kind, B, F, W, n, device, seed=0):
    """A hop at WIDE_SHAPES, made on the card: ids in [-1, n + 4) (int32),
    the first rows full and ending in the highest id in range, and a
    visited set, in the kernel's layout, with every 4,099th node (dense)
    or a bit pattern in every third word (packed) set."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = torch.randint(-1, min(n + 4, 2**31), (B, F, W), generator=g).to(torch.int32)
    deg = torch.randint(0, W + 1, (B, F), generator=g, dtype=torch.int32)
    rows[:, :4, -1] = min(n, 2**31) - 1
    deg[:, :4] = W
    if kind == "frontier_expand_batched":
        vis = torch.zeros((B, n), dtype=torch.bool, device=device)
        vis[:, ::4099] = True
    else:
        vis = torch.zeros((B, -(-n // 32)), dtype=torch.int32, device=device)
        vis[:, ::3] = 0x01010101
    return rows.to(device), deg.to(device), vis


def expand(kind, rows, deg, vis, n, kernel: bool):
    """The kernel or its plain version on a copy of the visited set `vis`,
    already in the kernel's layout."""
    return in_place(kind, rows, deg, vis.clone(), n, kernel)()


def check_kernels(device):
    """Both frontier kernels bit-equal to their plain versions at
    MAIN_SHAPES (a synthetic hop: 75 % live rows), EDGE_SHAPES and
    WIDE_SHAPES (the kernels' 64-bit indices); their device time on the
    synthetic hop and on an all-padding hop at the path's shape (every deg
    0: reading deg and exiting, the kernel's own floor on that shape),
    beside the plain version's device time and the bound."""
    from repro_torch.kernels import frontier as fr

    out = {}
    n = MAIN_SHAPES["n"]
    for layout, kind in KERNELS_BY_LAYOUT.items():
        err = 0
        for shapes in [MAIN_SHAPES] + EDGE_SHAPES:
            rows, deg, vis = kernel_inputs(**shapes, device=device)
            if layout == "packed":
                vis = fr.pack_words(vis)
            out_k = expand(kind, rows, deg, vis, shapes["n"], kernel=True)
            torch.cuda.synchronize()
            err = max(err, max_err(out_k, expand(kind, rows, deg, vis, shapes["n"], kernel=False),
                                   f"{kind} != plain version at {shapes}"))
        check_single_query(layout, device)
        wide = WIDE_SHAPES[kind]
        rows, deg, vis = wide_inputs(kind, **wide, device=device)
        out_k = expand(kind, rows, deg, vis, wide["n"], kernel=True)
        err = max(err, max_err(out_k, expand(kind, rows, deg, vis, wide["n"], kernel=False),
                               f"{kind} != plain version at {wide} (64-bit indices)"))
        del rows, deg, vis, out_k
        torch.cuda.empty_cache()
        rows, deg, vis = kernel_inputs(**MAIN_SHAPES, device=device)
        pad_rows, pad_deg = torch.full_like(rows, -1), torch.zeros_like(deg)
        if layout == "packed":
            vis = fr.pack_words(vis)
        k_ms, floor_ms = launch_ms([in_place(kind, rows, deg, vis, n),
                                    in_place(kind, pad_rows, pad_deg, vis, n)], KERNELS[kind][2])
        p_ms = launch_ms([in_place(kind, rows, deg, vis, n, kernel=False)], reps=10)[0]
        fig = hop_figures(kind, rows, deg, n)
        floor_bound = hop_figures(kind, pad_rows, pad_deg, n)["bound_ms"]
        out[kind] = dict(max_abs_err=err, synthetic_ms=k_ms, synthetic_plain_ms=p_ms,
                         synthetic_bound_ms=fig["bound_ms"], floor_ms=floor_ms,
                         floor_bound_ms=floor_bound)
        log(f"[kernel] {kind}: exact vs {KERNELS[kind][0]} at {MAIN_SHAPES}, "
            f"{len(EDGE_SHAPES)} edge shapes (also through the single-query entry point, "
            f"B = 1) and {wide} (64-bit indices); synthetic hop "
            f"{k_ms * 1e3:.2f} us (device time), plain {p_ms:.4f} ms (device time), bound "
            f"{fig['bound_ms'] * 1e3:.3f} us; all-padding "
            f"hop (the floor) {floor_ms * 1e3:.2f} us, bound {floor_bound * 1e3:.3f} us")
    return out


def check_single_query(layout, device) -> None:
    """`kernels.ops.frontier_expand` / `frontier_expand_packed` (the
    reference's single-query entry points, B = 1 views of the kernels)
    bit-equal to their plain versions at EDGE_SHAPES with B = 1; the kernel
    launched once a call, in place."""
    from repro_torch.kernels import frontier as fr
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import LAUNCHES

    kind = KERNELS_BY_LAYOUT[layout]
    for shapes in EDGE_SHAPES:
        n = shapes["n"]
        rows, deg, vis = (x[0] for x in kernel_inputs(**dict(shapes, B=1), device=device))
        if layout == "dense":
            call = lambda v, k: ops.frontier_expand(rows, deg, v, use_kernel=k)  # noqa: E731
        else:
            vis = fr.pack_words(vis)
            call = lambda v, k: ops.frontier_expand_packed(rows, deg, v, n, use_kernel=k)  # noqa: E731
        before = LAUNCHES.get(kind, 0)
        out_k = vis.clone()
        if call(out_k, "auto") is not out_k or LAUNCHES.get(kind, 0) != before + 1:
            raise AssertionError(f"ops entry point of {kind} at {shapes}: not one launch "
                                 f"in place")
        max_err(out_k, call(vis.clone(), False),
                f"ops entry point of {kind} != plain version at {shapes}, B = 1")


# ---------------------------------------------------------------------------
# Phases 2 and 3: the serving engine
# ---------------------------------------------------------------------------


def make_engine(tier, li, scheme, cfg, device, embedding=None):
    from repro_torch.core.router import Router, RouterConfig
    from repro_torch.serve.engine import ServingEngine

    router = Router(cfg.n_processors, RouterConfig(scheme=scheme), landmark_index=li,
                    embedding=embedding, seed=3, device=device)
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


def path_setup(device, preset="large", n_queries=128, n_landmarks=24):
    """The main path's storage tier, landmark index, workload, engine
    settings and graph: the repo's scale run (benchmarks/bench_engine.py
    _scale_bench settings, cut from 256 to 128 queries to leave the LM
    phases their time)."""
    from repro_torch.core.landmarks import build_landmark_index
    from repro_torch.core.storage import build_storage
    from repro_torch.core.workloads import preset_workload
    from repro_torch.graph.csr import to_padded
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
    return tier, li, wl, base, g


def main_path(device, **setup):
    """Phase 2: the scale run (`path_setup`), its embedding trained on the
    card (`train_embedding`), every routing scheme served with the kernels
    against the same runs on the scatter backend; a profile of each
    landmark cell; then one more run of each landmark cell, recorded
    (`record_path`), whose launches are summed up against the profile and
    replayed (`check_path_launches`). Also returns what the later parts of
    phase 2 run on (the setup and the embedding)."""
    from repro_torch.kernels.build import LAUNCHES

    tier, li, wl, base, g = path_setup(device, **setup)
    emb, training = train_embedding(li, device, profile=True)
    launches = {k: 0 for k in KERNELS_BY_LAYOUT.values()}
    cells = []
    for scheme in SCHEMES:
        by_layout = {}
        for layout in ("dense", "packed"):
            cfg = dataclasses.replace(base, visited_layout=layout)
            eng = make_engine(tier, li, scheme, cfg, device, emb)
            LAUNCHES.clear()  # counts of this main-path run only
            res, _ = eng.run(wl)
            counted = dict(LAUNCHES)
            kernel = KERNELS_BY_LAYOUT[layout]
            if counted.get(kernel, 0) == 0 or sum(counted.values()) != counted[kernel]:
                raise AssertionError(f"{scheme}/{layout}: launches {counted}")
            for k, v in counted.items():
                launches[k] += v
            if not res.completed.all():
                raise AssertionError(f"{scheme}/{layout}: not every query completed")
            ref_res, _ = make_engine(tier, li, scheme, dataclasses.replace(
                cfg, expand_backend="scatter"), device, emb).run(wl)
            assert_same_result(res, ref_res, f"{scheme}/{layout} cuda vs scatter")
            by_layout[layout] = res
            rounds = len(res.per_round["counts"])
            cell = dict(scheme=scheme, layout=layout, qps=res.throughput_qps,
                        hit_rate=res.hit_rate, reads=res.reads, wall_s=res.wall_s,
                        scatter_wall_s=ref_res.wall_s, truncated=res.truncated,
                        rounds=rounds, launches=counted[kernel],
                        launches_per_round=counted[kernel] / rounds)
            cells.append(cell)
            log(f"[main] {scheme:>10s} {layout:>6s}: qps {res.throughput_qps:.2f} "
                f"hit {res.hit_rate:.4f} reads {res.reads} wall {res.wall_s:.3f} s "
                f"(scatter backend {ref_res.wall_s:.3f} s) truncated {res.truncated} "
                f"{kernel} launches {counted[kernel]} over {rounds} rounds")
        d, p = by_layout["dense"], by_layout["packed"]
        if not (np.array_equal(d.counts, p.counts) and d.reads == p.reads):
            raise AssertionError(f"{scheme}: counts/reads differ across layouts")
    profiles = [profile_cell(tier, li, wl, base, "landmark", layout, device)
                for layout in ("dense", "packed")]
    path = {}
    for prof in profiles:
        kind = prof["kernel"]
        cell = next(c for c in cells if c["scheme"] == "landmark" and
                    KERNELS_BY_LAYOUT[c["layout"]] == kind)
        figures, replay = record_path(tier, li, wl, base, "landmark", prof["layout"], device)
        if len(figures) != cell["launches"]:
            raise AssertionError(f"recorded run of landmark/{prof['layout']}: "
                                 f"{len(figures)} launches, the cell {cell['launches']}")
        path[kind] = dict(recorded=summarize_path(kind, figures, prof),
                          replayed=check_path_launches(kind, replay))
    ctx = dict(g=g, tier=tier, li=li, wl=wl, base=base, emb=emb, training=training)
    return launches, cells, profiles, path, ctx


def train_embedding(li, device, noise=None, profile=False):
    """`build_graph_embedding` with the defaults (EmbedConfig()) from the
    landmark index's distances on `device`: its wall (to the host copy) and
    `rel_error`; with `profile`, then each stage alone, timed and profiled
    (device busy time, top ops). `noise` = (lm_noise, node_noise), else the
    seeded generator's draws. Returns (embedding, figures)."""
    from repro_torch.core import embedding as te

    cfg = te.EmbedConfig()
    lm_noise, node_noise = noise or (None, None)
    t = time.perf_counter()
    emb = te.build_graph_embedding(li.dist_to_lm, li.landmarks, cfg, device=device,
                                   lm_noise=lm_noise, node_noise=node_noise)
    wall = time.perf_counter() - t
    if not (np.isfinite(emb.coords).all() and emb.coords.shape == (li.dist_to_lm.shape[0],
                                                                  cfg.dim)):
        raise AssertionError(f"embedding: coordinates of shape {emb.coords.shape}, "
                             f"finite {np.isfinite(emb.coords).all()}")
    err = emb.rel_error(li.dist_to_lm)
    if not err < EMBED_MAX_REL_ERROR:
        raise AssertionError(f"embedding on {device}: rel_error {err} (limit "
                             f"{EMBED_MAX_REL_ERROR})")
    out = dict(n=int(emb.coords.shape[0]), landmarks=int(len(emb.landmarks)), dim=cfg.dim,
               lm_steps=cfg.lm_steps, node_steps=cfg.node_steps, wall_s=wall, rel_error=err)
    log(f"[embed] {out['n']} nodes x {out['landmarks']} landmarks, dim {cfg.dim}, "
        f"{cfg.lm_steps} + {cfg.node_steps} Adam steps on {device}: {wall:.3f} s; "
        f"rel_error {err:.6f}")
    if not profile:
        return emb, out
    dist = torch.from_numpy(li.dist_to_lm).to(device)
    lm_dist = dist[torch.from_numpy(li.landmarks.astype(np.int64)).to(device)]
    lm_coords = torch.from_numpy(emb.lm_coords).to(device)
    stages = {"landmarks": lambda: te.embed_landmarks(lm_dist, cfg.dim, cfg.lm_steps, cfg.lr),
              "nodes": lambda: te.embed_nodes(dist, lm_coords, cfg.node_steps, cfg.lr)}
    for name, fn in stages.items():
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        by_name = device_ops(fn)
        busy = sum(us for us, _ in by_name.values()) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        out[name] = dict(wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
                         device_ops=sum(c for _, c in by_name.values()),
                         top=[dict(name=k[:80], ms=us / 1e3, calls=c) for k, (us, c) in top])
        log(f"[embed] stage {name}: wall {wall:.3f} s, device busy {busy:.3f} s (busy share "
            f"{busy / wall:.4f}), {out[name]['device_ops']} device ops; top: " + "; ".join(
                f"{x['name'][:40]} {x['ms']:.2f} ms x{x['calls']}" for x in out[name]["top"]))
    return emb, out


def graph_updates(ctx, device) -> dict:
    """Graph updates at full size (§3.4). `incremental_add_node` on the card
    for the highest-degree node, a node of the lowest degree (the preset
    has no degree-1 node) and one in the middle of the id range: every
    table bit-equal to `build_landmark_index`'s (the graph is unchanged, so
    the recomputed row is the same). Then two nodes appended, one after
    the other: one with edges to NEW_NODE_EDGES existing nodes, then a
    degree-1 node joined to that first one (a leaf there opens no shortcut
    between old nodes, which the tables would not see). Each new row is 1 + the
    element-wise least of its neighbours' rows, its processor row the
    least over each processor's landmarks, the old rows untouched. For
    each of these nodes `incremental_embed_node` gives finite coordinates
    whose mean relative error against the landmarks is under
    INCREMENTAL_MAX_REL."""
    from repro_torch.core.embedding import incremental_embed_node
    from repro_torch.core.landmarks import UNREACHED, incremental_add_node
    from repro_torch.graph.csr import build_csr, csr_to_edge_index

    g, li, emb = ctx["g"], ctx["li"], ctx["emb"]
    deg = g.degree()
    nodes = {"highest degree": int(np.argmax(deg)), "lowest degree": int(np.argmin(deg)),
             "middle": g.n // 2}
    out = {}
    t = time.perf_counter()
    for what, u in nodes.items():
        new = incremental_add_node(li, g, u, device=device)
        for f in ("landmarks", "dist_to_lm", "lm_processor", "dist_to_proc", "pivots"):
            if not np.array_equal(getattr(new, f), getattr(li, f)):
                raise AssertionError(f"incremental_add_node({what} node {u}): {f} differs "
                                     f"from build_landmark_index's")
        out[what] = dict(node=u, degree=int(deg[u]), row=new.dist_to_lm[u].tolist())
    appended = {f"new, {NEW_NODE_EDGES} edges": np.linspace(0, g.n - 1, NEW_NODE_EDGES)
                .astype(np.int64), "new, 1 edge": np.array([g.n])}
    src, dst = csr_to_edge_index(g)
    news = g.n + np.arange(len(appended))
    src = np.concatenate([src] + [np.full(len(v), u) for u, v in zip(news, appended.values())]
                         + list(appended.values()))
    dst = np.concatenate([dst] + list(appended.values())
                         + [np.full(len(v), u) for u, v in zip(news, appended.values())])
    g_new = build_csr(g.n + len(appended), src, dst)
    new = li
    for u, (what, nbrs) in zip(news, appended.items()):
        new = incremental_add_node(new, g_new, int(u), device=device)
        least = new.dist_to_lm[nbrs].min(0).astype(np.int64)
        expect = np.where(least >= UNREACHED, UNREACHED, least + 1).astype(np.int32)
        expect_proc = np.array([expect[li.lm_processor == p].min()
                                if (li.lm_processor == p).any() else UNREACHED
                                for p in range(li.dist_to_proc.shape[1])], np.int32)
        if not (np.array_equal(new.dist_to_lm[u], expect)
                and np.array_equal(new.dist_to_proc[u], expect_proc)
                and np.array_equal(new.dist_to_lm[:g.n], li.dist_to_lm)
                and np.array_equal(new.dist_to_proc[:g.n], li.dist_to_proc)):
            raise AssertionError(f"incremental_add_node({what} node {u}): row "
                                 f"{new.dist_to_lm[u]}, expected {expect} (1 + the least "
                                 f"of its neighbours' rows)")
        out[what] = dict(node=int(u), degree=len(nbrs), neighbours=nbrs.tolist(),
                         row=new.dist_to_lm[u].tolist())
    t_add = time.perf_counter() - t
    t = time.perf_counter()
    rows = {what: new.dist_to_lm[x["node"]] for what, x in out.items()}
    for what, d in rows.items():
        x = incremental_embed_node(emb, d, device=device)
        d_true = d.astype(np.float64)
        pred = np.sqrt(((emb.lm_coords - x) ** 2).sum(-1))
        ok = (d_true > 0) & (d_true < float(UNREACHED))
        rel = float((np.abs(pred[ok] - d_true[ok]) / d_true[ok]).mean())
        if not (np.isfinite(x).all() and rel < INCREMENTAL_MAX_REL):
            raise AssertionError(f"incremental_embed_node({what}): {x}, mean relative error "
                                 f"{rel} (limit {INCREMENTAL_MAX_REL})")
        out[what]["embed_rel_error"] = rel
    t_embed = time.perf_counter() - t
    out["seconds"] = dict(add_node=t_add, embed_node=t_embed)
    log(f"[update] incremental_add_node on the card, {len(nodes)} existing nodes "
        + ", ".join(f"{w} {x['node']} (degree {x['degree']})" for w, x in out.items()
                    if w in nodes)
        + ": every table bit-equal to build_landmark_index's; appended "
        + ", ".join(f"{w}: node {out[w]['node']} joined to {out[w]['neighbours']}"
                    for w in appended)
        + f": each row = 1 + the least of its neighbours', old rows untouched ({t_add:.2f} s "
        f"with the new graph's CSR)")
    log("[update] incremental_embed_node on the card: mean relative error "
        + ", ".join(f"{w} {x['embed_rel_error']:.4f}" for w, x in out.items() if w != "seconds")
        + f" (limit {INCREMENTAL_MAX_REL}; {t_embed:.2f} s for {len(rows)} nodes)")
    return out


def _on(obj, device):
    """A dataclass of tensors (storage tier, cache) with every tensor moved
    to `device`."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device) for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def _same_fields(a, b, what):
    """Every field of two results (tensors, None or values) equal, on the
    host."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            if not torch.equal(x.cpu(), y.cpu()):
                raise AssertionError(f"{what}: {f.name} differs")
        elif x is not None or y is not None:
            if x != y:
                raise AssertionError(f"{what}: {f.name} {x} != {y}")


def query_types(ctx, device) -> dict:
    """The paper's other query types at full size. h-hop reachability over
    the preset's queries and their targets in batches of REACH_BATCH, one
    cache carried over the batches, at each h of REACH_HOPS and each
    layout: the cuda backend against scatter, the reachable flags, every
    QueryStats field (truncated_fwd / _bwd included) and the final cache
    bit-equal; only the layout's kernel launched. Then a WALK_HOPS-step
    random walk from every query on the card and on the CPU with the same
    draws (`uniform_draw` on a CPU generator): the final nodes, stats and
    cache bit-equal."""
    from repro_torch.core.cache import make_cache
    from repro_torch.core.query_engine import (
        EngineConfig, make_ref_multi_read, run_random_walk, run_reachability, uniform_draw,
    )
    from repro_torch.kernels.build import LAUNCHES

    tier, wl, base = ctx["tier"], ctx["wl"], ctx["base"]
    n = tier.n
    src = torch.from_numpy(wl.query_nodes.astype(np.int32)).to(device)
    dst = torch.from_numpy(wl.targets.astype(np.int32)).to(device)
    out = dict(reachability=[])
    for h in REACH_HOPS:
        for layout, kind in KERNELS_BY_LAYOUT.items():
            runs = {}
            for backend in ("cuda", "scatter"):
                cfg = EngineConfig(max_frontier=base.max_frontier, chain_depth=base.chain_depth,
                                   expand_backend=backend, visited_layout=layout)
                cache = make_cache(base.cache_sets, base.cache_ways, tier.row_width,
                                   device=device)
                LAUNCHES.clear()
                torch.cuda.synchronize()
                t = time.perf_counter()
                batches = []
                for i in range(0, src.shape[0], REACH_BATCH):
                    reach, cache, stats = run_reachability(
                        cache, src[i:i + REACH_BATCH], dst[i:i + REACH_BATCH], h, n, cfg,
                        make_ref_multi_read(tier))
                    batches.append((reach, stats))
                torch.cuda.synchronize()
                runs[backend] = (batches, cache, time.perf_counter() - t, dict(LAUNCHES))
            (kb, kc, k_s, counted), (sb, sc, s_s, s_counted) = runs["cuda"], runs["scatter"]
            what = f"reachability h={h} {layout}"
            if counted.get(kind, 0) == 0 or sum(counted.values()) != counted[kind] \
                    or sum(s_counted.values()) != 0:
                raise AssertionError(f"{what}: launches {counted}, scatter {s_counted}")
            for (r1, st1), (r2, st2) in zip(kb, sb):
                if not torch.equal(r1, r2):
                    raise AssertionError(f"{what}: reachable flags differ, cuda vs scatter")
                _same_fields(st1, st2, f"{what} stats, cuda vs scatter")
            _same_fields(kc, sc, f"{what} cache, cuda vs scatter")
            reach = torch.cat([r for r, _ in kb])
            cell = dict(
                h=h, layout=layout, queries=int(reach.numel()), batches=len(kb),
                reachable=int(reach.sum()),
                truncated=int(sum(int(st.truncated.sum()) for _, st in kb)),
                truncated_fwd=int(sum(int(st.truncated_fwd.sum()) for _, st in kb)),
                truncated_bwd=int(sum(int(st.truncated_bwd.sum()) for _, st in kb)),
                reads=int(sum(int(st.reads) for _, st in kb)),
                touched=int(sum(int(st.touched) for _, st in kb)),
                result_size_mean=float(torch.cat([st.result_sizes for _, st in kb])
                                       .float().mean()),
                launches=counted[kind], kernel=kind, wall_s=k_s, scatter_wall_s=s_s)
            out["reachability"].append(cell)
            log(f"[reach] h={h} {layout:>6s}: {cell['reachable']} of {cell['queries']} "
                f"reachable, truncated {cell['truncated']} (fwd {cell['truncated_fwd']}, "
                f"bwd {cell['truncated_bwd']}), reads {cell['reads']}, touched "
                f"{cell['touched']}; {kind} launches {cell['launches']}; wall {k_s:.3f} s "
                f"(scatter {s_s:.3f} s); cuda == scatter in flags, every stat and the cache")
    cfg = EngineConfig(max_frontier=base.max_frontier, chain_depth=base.chain_depth)
    walks = []
    for dev in (device, torch.device("cpu")):
        t_dev = _on(tier, dev)
        cache = make_cache(base.cache_sets, base.cache_ways, tier.row_width, device=dev)
        t = time.perf_counter()
        final, cache, stats = run_random_walk(
            cache, src.to(dev), WALK_HOPS, n, cfg, make_ref_multi_read(t_dev),
            draw=uniform_draw(torch.Generator().manual_seed(WALK_SEED)))
        final = final.cpu()
        walks.append((final, cache, stats, time.perf_counter() - t))
    (fk, ck, sk, k_s), (fc, cc, sc_, c_s) = walks
    if not torch.equal(fk, fc):
        raise AssertionError("random walk: final nodes differ, card vs CPU")
    _same_fields(sk, sc_, "random walk stats, card vs CPU")
    _same_fields(ck, cc, "random walk cache, card vs CPU")
    moved = int((fk != src.cpu()).sum())
    out["random_walk"] = dict(h=WALK_HOPS, queries=int(fk.numel()), moved=moved,
                              reads=int(sk.reads), touched=int(sk.touched),
                              misses=int(sk.misses), wall_s=k_s, cpu_wall_s=c_s)
    log(f"[walk] {WALK_HOPS}-step random walk from {fk.numel()} queries: {moved} ended off "
        f"their start, reads {int(sk.reads)}, misses {int(sk.misses)}; card {k_s:.3f} s, CPU "
        f"{c_s:.3f} s; final nodes, stats and cache equal card vs CPU")
    return out


class CollectiveCounts:
    """Counts the torch.distributed calls made inside the `with` block, by
    name (the storage read's all_to_all, the chain loop's and the merge's
    all_reduce, the buffer's broadcast)."""

    NAMES = ("all_to_all_single", "all_reduce", "broadcast")

    def __enter__(self):
        import torch.distributed as dist

        self.counts = dict.fromkeys(self.NAMES, 0)
        self._saved = {k: getattr(dist, k) for k in self.NAMES}

        def counted(name, fn):
            def call(*a, **kw):
                self.counts[name] += 1
                return fn(*a, **kw)
            return call

        for k, fn in self._saved.items():
            setattr(dist, k, counted(k, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for k, fn in self._saved.items():
            setattr(dist, k, fn)


def distributed_serving(ctx, device) -> dict:
    """Phase 2, last: the paper's decoupled cluster over torch.distributed
    (`serve.graph_serving`) at a world of one: NCCL with a FileStore, a
    one-shard storage tier from phase 2's padded adjacency, one query
    processor. Phase 2's 128 queries arrive in 1.5x-oversubscribed bursts,
    routed by the embed router on phase 2's embedding (`make_admission_round`,
    the buffer broadcast from rank 0), then the backlog drains; dense and
    packed, backend cuda. Each burst is held to the single-host
    `processor_round` on the same buffer over phase 2's 4-shard tier with
    `multi_read_ref`: counts, every cache leaf and the stats bit-equal, the
    EMA within EMA_ATOL (the same update as the step's, so this holds the
    merge), and within EMA_F64_RTOL of Eq. 5 written out in float64 on the
    host (this holds the update itself). Counted: the
    layout's frontier launches and the collectives of the distributed runs.
    One burst is profiled: the frontier kernel and NCCL's device work."""
    import torch.distributed as dist

    from repro_torch.core.query_engine import EngineConfig, make_ref_multi_read
    from repro_torch.core.router import Router, RouterConfig
    from repro_torch.core.storage import build_storage, make_serving_storage
    from repro_torch.distributed.mesh import init_mesh
    from repro_torch.graph.csr import to_padded
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.serve.engine import ema_round_update, processor_round
    from repro_torch.serve.graph_serving import (
        GServeConfig, make_admission_round, make_distributed_serve_step,
        make_processor_caches,
    )

    g, tier4, wl, emb, base = ctx["g"], ctx["tier"], ctx["wl"], ctx["emb"], ctx["base"]
    t = time.perf_counter()
    adj = to_padded(g, max_degree=64)
    tier1 = build_storage(adj, n_shards=1, device=device)
    t_tier = time.perf_counter() - t
    store = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "dist_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    mesh, dev = init_mesh((1, 1), ("data", "model"), device, store=dist.FileStore(store, 1),
                          rank=0, world_size=1)
    if dist.get_backend() != ("nccl" if dev.type == "cuda" else "gloo"):
        raise AssertionError(f"distributed serving on {dev}: backend {dist.get_backend()}")
    coords = torch.from_numpy(emb.coords).to(dev)
    D = coords.shape[1]
    nodes = wl.query_nodes.astype(np.int32)
    arrivals = DIST_QPP + DIST_QPP // 2
    bursts = -(-nodes.size // arrivals)
    out = dict(world=dist.get_world_size(), backend=dist.get_backend(), queries=int(nodes.size),
               arrivals_per_burst=arrivals, queries_per_proc=DIST_QPP, backlog=DIST_BACKLOG,
               tier_build_s=t_tier, layouts=[])
    for layout, kind in KERNELS_BY_LAYOUT.items():
        cfg = GServeConfig(
            n_nodes=g.n, n_rows=adj.n_rows, row_width=adj.max_degree, n_storage_shards=1,
            queries_per_proc=DIST_QPP, hops=base.hops, max_frontier=base.max_frontier,
            cache_sets=base.cache_sets, cache_ways=base.cache_ways,
            read_capacity=DIST_QPP * base.max_frontier, read_retry=1,
            chain_depth=base.chain_depth, expand_backend="cuda", visited_layout=layout,
            embed_dim=D)
        router = Router(1, RouterConfig(scheme="embed"), embedding=emb, seed=3, device=dev)
        admission, init_backlog = make_admission_round(router, mesh, cfg, DIST_BACKLOG)
        step = make_distributed_serve_step(mesh, cfg)
        inputs = dict(make_serving_storage(tier1, mesh.axis_index("model"), dev),
                      coords=coords, ema=torch.zeros((1, D), dtype=torch.float32, device=dev),
                      cache=make_processor_caches(mesh, cfg, dev))
        rstate, backlog = router.init_state(), init_backlog()
        record, served, dropped, step_s = [], 0, 0, 0.0
        LAUNCHES.clear()  # counts of the distributed runs only
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CollectiveCounts() as calls:
            b = 0
            while b < bursts or int(backlog.depth()) > 0:
                fresh = np.full(arrivals, -1, np.int32)
                chunk = nodes[b * arrivals:(b + 1) * arrivals]
                fresh[:chunk.size] = chunk
                qids = torch.arange(b * arrivals, (b + 1) * arrivals, dtype=torch.int32,
                                    device=dev)
                qbuf, adm = admission(rstate, backlog, torch.from_numpy(fresh).to(dev), qids)
                rstate, backlog = adm.rstate, adm.backlog
                dist.broadcast(qbuf, src=0)  # the router's rank sends every rank its row
                ins = dict(inputs, queries=qbuf[mesh.rank])
                ts, a2a = time.perf_counter(), calls.counts["all_to_all_single"]
                counts, ema, cache, stats = step(ins)
                torch.cuda.synchronize()
                step_s += time.perf_counter() - ts
                links = (calls.counts["all_to_all_single"] - a2a) // (2 * cfg.read_retry)
                record.append((ins, counts, ema, cache, stats, links))
                inputs["cache"], inputs["ema"] = cache, ema
                served += int(adm.placed.sum())
                dropped += int(adm.n_dropped)
                b += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = dict(LAUNCHES)
        what = f"distributed {layout}"
        if counted.get(kind, 0) == 0 or sum(counted.values()) != counted[kind]:
            raise AssertionError(f"{what}: launches {counted}")
        if served + dropped != nodes.size or int(backlog.depth()) != 0:
            raise AssertionError(f"{what}: served {served} + dropped {dropped} of {nodes.size}")
        # the single-host step on the same buffers, over the 4-shard tier
        ecfg = EngineConfig(max_frontier=cfg.max_frontier, chain_depth=cfg.chain_depth,
                            expand_backend="cuda", visited_layout=layout)
        multi_read = make_ref_multi_read(tier4)
        cache_h, ema_h = make_processor_caches(mesh, cfg, dev), record[0][0]["ema"]
        coords64 = emb.coords.astype(np.float64)
        ema64 = record[0][0]["ema"][0].cpu().numpy().astype(np.float64)
        ema64_tol = EMA_F64_RTOL * max(1.0, float(np.abs(coords64).max()))
        ema_err_max = ema64_err_max = 0.0
        touched = reads = 0
        host_s = 0.0
        for i, (ins, counts, ema, cache, stats, _) in enumerate(record):
            q = ins["queries"]
            torch.cuda.synchronize()
            ts = time.perf_counter()
            counts_h, cache_h, st, _ = processor_round(cache_h, q, h=cfg.hops, n=cfg.n_nodes,
                                                       ecfg=ecfg, multi_read=multi_read)
            torch.cuda.synchronize()
            host_s += time.perf_counter() - ts
            delta = torch.zeros_like(ema_h)
            delta[0] = ema_round_update(ema_h, 0, coords, q, cfg.alpha) - ema_h[0]
            ema_h = ema_h + delta
            stats_h = torch.stack([st.touched, st.misses, st.reads]).to(torch.float32)
            if not torch.equal(counts, counts_h):
                raise AssertionError(f"{what} burst {i}: counts differ from the single host's")
            _same_fields(cache, cache_h, f"{what} burst {i} cache, distributed vs single host")
            if not torch.equal(stats, stats_h):
                raise AssertionError(f"{what} burst {i}: stats {stats.tolist()} vs "
                                     f"{stats_h.tolist()}")
            ema_err = float((ema - ema_h).abs().max())
            if not ema_err <= EMA_ATOL:
                raise AssertionError(f"{what} burst {i}: EMA {ema_err} apart")
            qn = q.cpu().numpy()
            ok = qn[qn >= 0]
            mean64 = coords64[ok].mean(0) if ok.size else np.zeros(D)
            ema64 = cfg.alpha * ema64 + (1.0 - cfg.alpha) * mean64
            ema64_err = float(np.abs(ema[0].cpu().numpy() - ema64).max())
            if not ema64_err <= ema64_tol:
                raise AssertionError(f"{what} burst {i}: EMA {ema64_err} from Eq. 5 in float64 "
                                     f"(tolerance {ema64_tol})")
            ema_err_max = max(ema_err_max, ema_err)
            ema64_err_max = max(ema64_err_max, ema64_err)
            touched += int(st.touched)
            reads += int(st.reads)
        links = calls.counts["all_to_all_single"] // (2 * cfg.read_retry)
        # the burst of the fewest chain links profiled (a trace of many
        # links takes long to read): the frontier kernel and NCCL's work
        prof_burst = min((r for r in range(len(record)) if record[r][5] > 0),
                         key=lambda r: record[r][5])
        ins0 = record[prof_burst][0]
        symbol = KERNELS[kind][2]
        for tries in range(1, PROFILE_TRIES + 1):
            by_name = device_ops(lambda: step(ins0))
            nccl = {k: v for k, v in by_name.items() if "nccl" in k.lower()}
            k_calls = sum(c for name, (_, c) in by_name.items() if symbol in name)
            if nccl and k_calls:
                break
            log(f"[profile] try {tries} of {PROFILE_TRIES}: {symbol} {k_calls}, nccl {nccl}")
        else:
            raise AssertionError(f"{what}: no profile shows both {symbol} and NCCL's work")
        cell = dict(
            layout=layout, kernel=kind, launches=counted[kind], rounds=len(record),
            served=served, dropped=dropped, wall_s=wall, qps=served / wall,
            step_s=step_s, step_qps=served / step_s, single_host_s=host_s,
            single_host_qps=served / host_s, touched=touched, reads=reads,
            hit_rate=(touched - reads) / touched, chain_links=links,
            ema_err=ema_err_max, ema_f64_err=ema64_err_max, ema_f64_tol=ema64_tol,
            collectives=dict(calls.counts),
            collectives_per_link=(calls.counts["all_to_all_single"]
                                  + calls.counts["all_reduce"]) / links,
            links_per_burst=[r[5] for r in record],
            profile=dict(burst=prof_burst, links=record[prof_burst][5], kernel_calls=k_calls,
                         nccl={k[:80]: dict(us=us, calls=c) for k, (us, c) in nccl.items()},
                         copies={k[:80]: dict(us=us, calls=c) for k, (us, c) in by_name.items()
                                 if "Memcpy" in k}))
        out["layouts"].append(cell)
        log(f"[dist] {layout:>6s}: {served} served, {dropped} dropped over {len(record)} rounds "
            f"at a world of {out['world']} ({out['backend']}); qps {cell['qps']:.2f} (step "
            f"alone {cell['step_qps']:.2f}, single-host processor_round {cell['single_host_qps']:.2f}); "
            f"hit {cell['hit_rate']:.4f}; EMA {ema_err_max:.3g} from the single host's, "
            f"{ema64_err_max:.3g} from Eq. 5 in float64 (tolerance {ema64_tol:.3g}); "
            f"{kind} launches {counted[kind]}; {links} chain links, "
            f"collectives {calls.counts} ({cell['collectives_per_link']:.2f} a link); every burst "
            f"equal to the single host's over the 4-shard tier; profile of burst {prof_burst} "
            f"({record[prof_burst][5]} links): {k_calls} "
            f"{symbol} launches, NCCL on the card: " + "; ".join(
                f"{k[:40]} {us:.1f} us x{c}" for k, (us, c) in nccl.items())
            + f"; {nvidia_smi()}")
    dist.destroy_process_group()
    return out


# replayed launches of each kind a layout (link 0 of a hop, a later link),
# besides the launch with the most live entries
REPLAY_LAUNCHES = 8
FIGURES = ("live_rows", "live_entries", "in_range", "distinct", "bound_ms")


class Spread:
    """Keeps every `stride`-th item offered; when more than 2 * want are
    kept, every other one goes and the stride doubles. So the kept items
    spread evenly over a run of unknown length, in bounded memory."""

    def __init__(self, want: int):
        self.want, self.stride, self.seen, self.kept = want, 1, 0, []

    def offer(self, make):
        if self.seen % self.stride == 0:
            self.kept.append(make())
            if len(self.kept) > 2 * self.want:
                self.kept, self.stride = self.kept[::2], 2 * self.stride
        self.seen += 1

    def pick(self) -> list:
        idx = np.linspace(0, len(self.kept) - 1, min(self.want, len(self.kept)))
        return [self.kept[i] for i in np.unique(idx.round().astype(int))]


def record_path(tier, li, wl, base, scheme, layout, device):
    """One more run of a main-path cell, unprofiled and untimed, with the
    layout's kernel wrapper in `repro_torch.core.visited` (the seam
    `expander` reads at call time) wrapped: `hop_figures` of every
    launch's inputs, in launch order, and clones of the inputs of
    REPLAY_LAUNCHES launches of each kind spread over the run. Every link
    of a hop updates one visited tensor in place, so a launch whose tensor
    is not the last launch's is the first link of a hop. The launch with
    the most live entries is kept too. The wrapper is restored after the
    run."""
    from repro_torch.core import visited as seam

    kind = KERNELS_BY_LAYOUT[layout]
    wrapped = getattr(seam, kind)
    figures, last, largest = [], [None], [None]
    spread = {True: Spread(REPLAY_LAUNCHES), False: Spread(REPLAY_LAUNCHES)}

    def recorder(rows, deg, vis, *n):
        first = vis is not last[0]
        last[0] = vis
        bits = n[0] if n else vis.shape[1]
        fig = dict(hop_figures(kind, rows, deg, bits), first_link=first, index=len(figures))
        figures.append(fig)

        def clone():
            return dict(fig, rows=rows.clone(), deg=deg.clone(), vis=vis.clone(), n=bits)

        spread[first].offer(clone)
        if largest[0] is None or fig["live_entries"] > largest[0]["live_entries"]:
            largest[0] = clone()
        return wrapped(rows, deg, vis, *n)

    setattr(seam, kind, recorder)
    try:
        res, _ = make_engine(tier, li, scheme, dataclasses.replace(
            base, visited_layout=layout), device).run(wl)
    finally:
        setattr(seam, kind, wrapped)
    if not res.completed.all():
        raise AssertionError(f"recorded run of {scheme}/{layout}: not every query completed")
    replay = spread[True].pick() + spread[False].pick()
    if all(r["index"] != largest[0]["index"] for r in replay):
        replay.append(largest[0])
    return figures, replay


def summarize_path(kind, figures, prof) -> dict:
    """Each figure of the recorded launches summed and per launch (median,
    largest), by kind of link and over all; the bounds' total against the
    kernel's profiled total on the same cell."""
    out = {}
    for what, keep in (("all", None), ("first links", True), ("later links", False)):
        sel = [f for f in figures if keep is None or f["first_link"] == keep]
        out[what] = dict(launches=len(sel), **{
            k: dict(median=float(np.median([f[k] for f in sel])) if sel else None,
                    max=max((f[k] for f in sel), default=None),
                    total=sum(f[k] for f in sel)) for k in FIGURES})
    total = out["all"]["bound_ms"]["total"]
    out["profiled_ms"], out["profiled_per_launch_ms"] = prof["kernel_ms"], prof["kernel_ms_per_launch"]
    log(f"[path] {kind} on landmark/{prof['layout']}: {len(figures)} launches, "
        f"{out['first links']['launches']} first links of a hop; per launch (median / "
        f"largest / total):")
    for what in ("all", "first links", "later links"):
        log(f"[path]   {what:>11s}: " + "; ".join(
            f"{k} {out[what][k]['median']:.6g} / {out[what][k]['max']:.6g} / "
            f"{out[what][k]['total']:.6g}" for k in FIGURES if out[what]["launches"]))
    log(f"[path]   bound {total:.4f} ms in all against the kernel's profiled "
        f"{prof['kernel_ms']:.4f} ms ({prof['kernel_ms'] / total:.1f}x); a launch "
        f"{out['all']['bound_ms']['median'] * 1e3:.3f} us bound (median), "
        f"{prof['kernel_ms_per_launch'] * 1e3:.3f} us profiled (mean)")
    return out


def check_path_launches(kind, replay) -> dict:
    """The recorded launches replayed: the kernel bit-equal to its plain
    version and to a second launch of itself on each; one launch under
    `torch.cuda.set_sync_debug_mode("error")` (no host sync); the kernel's
    device time (median of 20 launches each, one profile) beside the plain
    version's (device time, median of 10 calls each, one profile) and the
    bound."""
    err = 0
    for rec in replay:
        args = (kind, rec["rows"], rec["deg"], rec["vis"], rec["n"])
        out_k = expand(*args, kernel=True)
        err = max(err, max_err(out_k, expand(*args, kernel=False),
                               f"{kind} != plain version on recorded launch {rec['index']}"))
        if not torch.equal(out_k, expand(*args, kernel=True)):
            raise AssertionError(f"{kind}: two launches differ on recorded launch {rec['index']}")
    fns = [in_place(kind, r["rows"], r["deg"], r["vis"].clone(), r["n"]) for r in replay]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fns[0]()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    k_ms = launch_ms(fns, KERNELS[kind][2])
    p_ms = launch_ms([in_place(kind, r["rows"], r["deg"], r["vis"].clone(), r["n"], kernel=False)
                      for r in replay], reps=10)
    launches = [dict(index=r["index"], first_link=r["first_link"], ms=k, plain_ms=p,
                     **{k2: r[k2] for k2 in FIGURES}) for r, k, p in zip(replay, k_ms, p_ms)]
    for x in launches:
        log(f"[path] {kind} launch {x['index']:5d} ({'first' if x['first_link'] else 'later'} "
            f"link): {x['live_rows']} live rows, {x['live_entries']} entries, "
            f"{x['distinct']} distinct; kernel {x['ms'] * 1e3:.2f} us, bound "
            f"{x['bound_ms'] * 1e3:.3f} us, plain {x['plain_ms']:.4f} ms")
    log(f"[path] {kind}: {len(replay)} recorded launches replayed, each bit-equal to the "
        f"plain version and to a second launch; a launch makes no host sync")
    return dict(launches=launches, max_abs_err=err, ms=float(np.median(k_ms)),
                plain_ms=float(np.median(p_ms)),
                bound_ms=float(np.median([r["bound_ms"] for r in replay])))


def profile_cell(tier, li, wl, base, scheme, layout, device):
    """One more run of a main-path cell under torch.profiler: the card's busy
    time (sum of kernel times; one stream, so kernels do not overlap) against
    the wall of an unprofiled run, the kernels that take the most, and the
    frontier kernel's own time per launch on the path's real inputs."""
    cfg = dataclasses.replace(base, visited_layout=layout)
    wall = make_engine(tier, li, scheme, cfg, device).run(wl)[0].wall_s
    eng = make_engine(tier, li, scheme, cfg, device)
    by_name = device_ops(lambda: eng.run(wl))
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


def oversub_run(adj, li, wl, emb, scheme, layout, device):
    """One phase-3 run: 2x oversubscription, a colliding cache (64 sets x 2
    ways), on `device`. A CPU run takes one thread (it runs beside
    others, each in a process of its own)."""
    from repro_torch.core.storage import build_storage
    from repro_torch.serve.engine import EngineRunConfig

    device = torch.device(device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    P, B = 4, 16
    cfg = EngineRunConfig(
        n_processors=P, round_size=B, capacity=B // (2 * P), hops=2,
        max_frontier=4096, cache_sets=64, cache_ways=2, chain_depth=64,
        backlog_capacity=2 * B, track_touched=True, expand_backend="cuda",
        visited_layout=layout)
    tier = build_storage(adj, n_shards=4, device=device)
    return make_engine(tier, li, scheme, cfg, device, emb).run(wl)[0]


def node_losses(coords, lm_coords, dist_to_lm):
    """Each node's own relative-error loss: the training objective's terms
    of that node, averaged over its valid pairs, in float64 on the host."""
    from repro_torch.core.landmarks import UNREACHED

    d = dist_to_lm.astype(np.float64)
    valid = (d > 0) & (d < float(UNREACHED))
    diff = coords[:, None, :].astype(np.float64) - lm_coords[None, :, :]
    err = (np.sqrt((diff * diff).sum(-1)) - d) / np.where(valid, d, 1.0)
    return np.where(valid, err * err, 0.0).sum(1) / np.maximum(valid.sum(1), 1)


def embedding_card_vs_cpu(li, device):
    """The embedding trained on `device` and on the CPU from the same init
    draws, made on a CPU generator, for EMBED_SEEDS seeds from
    EmbedConfig().seed on. Held: at EmbedConfig().seed the coordinates
    within COORD_ATOL; at every seed the landmark coordinates within
    COORD_ATOL, each node's own loss within NODE_LOSS_ATOL and rel_error
    within REL_ERROR_ATOL. Logged: the coordinates' difference at every
    seed and, at the first, after EMBED_STEP_READINGS steps of each stage
    (the node stage from the CPU's trained landmark coordinates on both),
    which shows where the two part. Returns the CPU-trained embedding of
    the first seed and the figures."""
    from repro_torch.core import embedding as te

    cfg = te.EmbedConfig()
    cpu = torch.device("cpu")
    L, n = len(li.landmarks), li.dist_to_lm.shape[0]
    out = dict(seeds=[])
    for seed in range(cfg.seed, cfg.seed + EMBED_SEEDS):
        gen = torch.Generator().manual_seed(seed)
        noise = (torch.randn((L, cfg.dim), generator=gen),
                 torch.randn((n, cfg.dim), generator=gen))
        emb, fig = {}, {}
        for dev in (device, cpu):
            emb[dev.type], fig[dev.type] = train_embedding(li, dev, noise)
        a, b = emb[device.type], emb["cpu"]
        coord = np.abs(a.coords - b.coords).max(1)
        loss = np.abs(node_losses(a.coords, a.lm_coords, li.dist_to_lm)
                      - node_losses(b.coords, b.lm_coords, li.dist_to_lm))
        r = dict(seed=seed, coord_max_diff=float(coord.max()),
                 rows_over_coord_atol=int((coord > COORD_ATOL).sum()),
                 lm_max_diff=float(np.abs(a.lm_coords - b.lm_coords).max()),
                 node_loss_max_diff=float(loss.max()),
                 rel_error=(fig[device.type]["rel_error"], fig["cpu"]["rel_error"]),
                 wall_s=(fig[device.type]["wall_s"], fig["cpu"]["wall_s"]))
        out["seeds"].append(r)
        log(f"[oversub] embedding of {n} nodes, seed {seed}: card vs CPU coordinates "
            f"{r['coord_max_diff']:.3g} apart ({r['rows_over_coord_atol']} rows over "
            f"{COORD_ATOL}), landmarks {r['lm_max_diff']:.3g}, a node's own loss "
            f"{r['node_loss_max_diff']:.3g} (tolerance {NODE_LOSS_ATOL}); rel_error "
            f"{r['rel_error'][0]:.6f} / {r['rel_error'][1]:.6f}")
        held = [("landmark coordinates", r["lm_max_diff"], COORD_ATOL),
                ("a node's own loss", r["node_loss_max_diff"], NODE_LOSS_ATOL),
                ("rel_error", abs(r["rel_error"][0] - r["rel_error"][1]), REL_ERROR_ATOL)]
        if seed == cfg.seed:
            held.append(("coordinates", r["coord_max_diff"], COORD_ATOL))
            first, noise0 = b, noise
        for what, diff, tol in held:
            if not diff <= tol:
                raise AssertionError(f"embedding card vs CPU, seed {seed}: {what} differ by "
                                     f"{diff} (tolerance {tol})")
    dist = torch.from_numpy(np.ascontiguousarray(li.dist_to_lm, dtype=np.int32))
    lm_dist = dist[torch.from_numpy(li.landmarks.astype(np.int64))]
    lm = torch.from_numpy(first.lm_coords)
    steps = []
    for k in EMBED_STEP_READINGS + (cfg.node_steps,):
        x = [te.embed_nodes(dist.to(dev), lm.to(dev), k, cfg.lr, noise=noise0[1]).cpu().numpy()
             for dev in (device, cpu)]
        r = dict(steps=k, coord_max_diff=float(np.abs(x[0] - x[1]).max()))
        if k < cfg.lm_steps:
            y = [te.embed_landmarks(lm_dist.to(dev), cfg.dim, k, cfg.lr, noise=noise0[0]).cpu()
                 for dev in (device, cpu)]
            r["lm_max_diff"] = float((y[0] - y[1]).abs().max())
        steps.append(r)
    out["by_steps"] = steps
    log(f"[oversub] seed {cfg.seed}, card vs CPU after k steps of a stage, the node stage "
        f"from the same landmark coordinates: " + "; ".join(
            f"k = {r['steps']}: nodes {r['coord_max_diff']:.3g}"
            + (f", landmarks {r['lm_max_diff']:.3g}" if "lm_max_diff" in r else "")
            for r in steps))
    return first, out


def oversubscribed(device, cpu="cpu"):
    """Phase 3: the embedding trained on `device` and on the CPU
    (`embedding_card_vs_cpu`); then 2x oversubscription, colliding cache
    (64 sets x 2 ways), every scheme, the run on `device` against the
    port's run on the CPU, field by field (both routers on the CPU-trained
    coordinates of EmbedConfig().seed)."""
    from repro_torch.core.landmarks import build_landmark_index
    from repro_torch.core.workloads import preset_workload
    from repro_torch.graph.csr import to_padded

    g, wl = preset_workload("small", n_queries=128, seed=0)
    adj = to_padded(g, max_degree=64)
    li = build_landmark_index(g, n_processors=4, n_landmarks=16, device=device)
    emb_cpu, embedding = embedding_card_vs_cpu(li, device)
    cells = [(scheme, layout) for scheme in SCHEMES for layout in ("dense", "packed")]
    # a CPU run takes ~20 s (every chain link handles the whole B x F
    # frontier); the runs go side by side in processes of one thread each,
    # on all cores but one, while this process runs the card's (which are
    # bound by its host thread) on that one
    workers = max(1, min(len(cells), len(os.sched_getaffinity(0)) - 1))
    t = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        on_cpu = [pool.submit(oversub_run, adj, li, wl, emb_cpu, scheme, layout, cpu)
                  for scheme, layout in cells]
        on_card = [oversub_run(adj, li, wl, emb_cpu, scheme, layout, device)
                   for scheme, layout in cells]
        t_card = time.perf_counter() - t
        on_cpu = [f.result() for f in on_cpu]
    t_all = time.perf_counter() - t
    for (scheme, layout), r, r_cpu in zip(cells, on_card, on_cpu):
        assert_same_result(r, r_cpu, f"oversubscribed {scheme}/{layout} {device} vs cpu")
        log(f"[oversub] {scheme:>10s} {layout:>6s}: completed "
            f"{int(r.completed.sum())} dropped {r.n_dropped} peak backlog "
            f"{r.peak_backlog} stolen {r.stolen} hit {r.hit_rate:.4f} -- "
            f"equal to the CPU run")
    log(f"[oversub] {len(cells)} cells: the card's runs {t_card:.1f} s; with the CPU's, "
        f"side by side in {workers} processes of one thread, {t_all:.1f} s")
    return dict(embedding=embedding)


# ---------------------------------------------------------------------------
# Phase 1, flash attention: the kernel against its plain version
# ---------------------------------------------------------------------------


def attn_pairs(Sq, Skv, causal, window) -> int:
    """(query, key) pairs the function must weigh: the unmasked ones, and
    every key for a row with none unmasked (its output is the mean of v)."""
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Skv, q + 1) if causal else np.full(Sq, Skv)
    lo = np.maximum(0, q - window + 1) if window is not None else np.zeros(Sq, np.int64)
    n = hi - lo
    return int(np.where(n > 0, n, Skv).sum())


def attn_bound_ms(B, Hq, Hkv, Sq, Skv, D, causal, window, dtype):
    """Least time for these inputs: 4 D flops per pair (two products) at the
    dtype's dense peak, against q, k, v read once and o written once at the
    HBM rate; (the larger, which one it is, the flops)."""
    flops = 4 * D * B * Hq * attn_pairs(Sq, Skv, causal, window)
    nbytes = dtype.itemsize * D * B * (2 * Hq * Sq + 2 * Hkv * Skv)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations", flops) if t_ops >= t_bytes else (t_bytes, "bytes", flops)


def check_flash(device):
    """The flash kernel against `attention_ref` on float32 copies of its
    inputs (the TPU kernel casts to float32; the bf16 route's products are
    exact in float32 and its P @ V carries 16 bits of P) at every
    ATTN_SHAPES entry: |kernel - plain| <= atol + rtol * |plain|, plus the
    mean of v for fully masked rows, and the route (the kernel a profile of
    one launch shows) that the dtype must take. At the first shape, a plain
    version that leaks the key tile above the diagonal must fail that
    tolerance on the second half of the rows, where a typical output is
    small. Kernel, plain and SDPA times (median of CUDA events) beside the
    bound. TF32 is off while it runs, so that float32 products are
    float32."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _check_flash(device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _check_flash(device):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref

    g = torch.Generator(device=device).manual_seed(0)
    results = []
    leak = None
    for name, B, Hq, Hkv, Sq, Skv, D, causal, window, cap, dtype in ATTN_SHAPES:
        q = torch.randn(B, Hq, Sq, D, generator=g, device=device).to(dtype)
        k = torch.randn(B, Hkv, Skv, D, generator=g, device=device).to(dtype)
        v = torch.randn(B, Hkv, Skv, D, generator=g, device=device).to(dtype)
        kw = dict(causal=causal, window=window, softcap=cap)
        out = flash_attention(q, k, v, **kw).float()
        torch.cuda.synchronize()
        qf, kf, vf = q.float(), k.float(), v.float()
        plain = attention_ref(qf, kf, vf, **kw)
        atol, rtol = ATTN_TOL[dtype]
        diff = (out - plain).abs()
        err = float(diff.max())
        tol_used = float((diff / (atol + rtol * plain.abs())).max())
        if not tol_used <= 1:
            raise AssertionError(f"flash_attention != attention_ref at {name}: max err {err}")
        if leak is None and causal and window is None:
            # query i sees keys up to i + LEAK_KEYS: the error of a kernel
            # that does not mask the tile above the diagonal
            wrong = attention_ref(qf, kf, vf, q_offset=LEAK_KEYS, **kw)
            late = (slice(None), slice(None), slice(Sq // 2, None))
            wd, ref_late = (wrong - plain)[late].abs(), plain[late].abs()
            leak = dict(shape=name, keys=LEAK_KEYS, rows=f"{Sq // 2}..{Sq - 1}",
                        max_abs_err=float(wd.max()),
                        median_abs_out=float(ref_late.median()),
                        share_over_tol=float((wd > atol + rtol * ref_late).float().mean()),
                        share_over_2e2=float((wd > 2e-2 + 2e-2 * ref_late).float().mean()))
            log(f"[flash] tolerance self-check at {name}: a kernel leaking {LEAK_KEYS} keys "
                f"errs by up to {leak['max_abs_err']:.4g} on rows {leak['rows']} (median "
                f"|out| {leak['median_abs_out']:.4g}); share of elements over the tolerance "
                f"{leak['share_over_tol']:.4f}, over 2e-2 + 2e-2|out| {leak['share_over_2e2']:.4f}")
            if not leak["share_over_tol"] > 0:
                raise AssertionError("the flash tolerance passes a kernel that leaks a key tile")
            del wrong, wd, ref_late
        if window == 0:  # every key masked: the mean of v, as the reference
            mean_v = vf.mean(dim=2, keepdim=True).repeat_interleave(Hq // Hkv, dim=1)
            if not torch.allclose(out, mean_v.expand_as(out), atol=atol, rtol=rtol):
                raise AssertionError("fully masked rows are not the mean of v")
        del out, plain, diff, qf, kf, vf
        # the trace may drop events: of ROUTE_LAUNCHES, at least one flash
        # event must show, and every one must be the dtype's kernel
        route, symbol = FLASH_ROUTES[dtype]
        seen = device_ops(lambda: [flash_attention(q, k, v, **kw) for _ in range(ROUTE_LAUNCHES)],
                          want=KERNELS["flash_attention"][2])
        ran = {n: c for n, (_, c) in seen.items() if KERNELS["flash_attention"][2] in n}
        if not ran or any(symbol not in n for n in ran):
            raise AssertionError(f"{name} ({dtype}) ran {list(ran)}, not the {route} kernel")
        if sum(ran.values()) < ROUTE_LAUNCHES:
            log(f"[flash] {name}: the trace kept {sum(ran.values())} of {ROUTE_LAUNCHES} "
                f"flash launches")
        big = Sq * Skv >= 2**22
        k_ms = median_ms(lambda: flash_attention(q, k, v, **kw), reps=10 if big else 30)
        p_ms = median_ms(lambda: attention_ref(q, k, v, **kw), reps=3 if big else 10)
        sdpa_ms = None
        if window is None and cap is None:  # SDPA computes the same function
            sdpa_ms = median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), reps=10 if big else 30)
        b_ms, b_by, flops = attn_bound_ms(B, Hq, Hkv, Sq, Skv, D, causal, window, dtype)
        results.append(dict(shape=name, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Skv=Skv, D=D,
                            causal=causal, window=window, softcap=cap,
                            dtype=str(dtype).removeprefix("torch."), route=route,
                            kernel=next(iter(ran))[:100], max_abs_err=err, tol_used=tol_used,
                            atol=atol, rtol=rtol, ms=k_ms, plain_ms=p_ms, sdpa_ms=sdpa_ms,
                            bound_ms=b_ms, bound_by=b_by, tflops=flops / k_ms / 1e9))
        sdpa = f"{sdpa_ms:.4f} ms" if sdpa_ms is not None else "n/a (window/softcap)"
        log(f"[flash] {name:>22s} {str(dtype)[6:]:>8s} B{B} Hq{Hq} Hkv{Hkv} Sq{Sq} Skv{Skv} "
            f"D{D} on the {route}: max err {err:.3g} (atol {atol}, rtol {rtol}; "
            f"{tol_used:.3f} of the tolerance); kernel "
            f"{k_ms:.4f} ms ({flops / k_ms / 1e9:.2f} TFLOP/s), plain {p_ms:.4f} ms, SDPA "
            f"{sdpa}, bound {b_ms:.4f} ms ({b_by})")
        del q, k, v
        torch.cuda.empty_cache()
    main = results[0]
    row = dict(name="flash_attention", route="cuda", source=KERNELS["flash_attention"][3],
               replaces=KERNELS["flash_attention"][1], launches=0,
               max_abs_err=max(r["max_abs_err"] for r in results), ms=main["ms"],
               plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
               bound_by=main["bound_by"], library_ms=main["sdpa_ms"])
    return row, results, leak


# ---------------------------------------------------------------------------
# Phase 4: Qwen3-4B serving at full width; phase 5: card against CPU
# ---------------------------------------------------------------------------


def cache_from_prefill(model, kvs, batch, max_seq, length):
    """A decode cache holding the prefill's KV stack ({pattern index:
    (n_groups, B, Hkv, S, Dh)}): layer li is group li // G, index li % G."""
    cache = model.init_kv_cache(batch, max_seq)
    G = model.cfg.group_size
    for li, layer in enumerate(cache["layers"]):
        for n in ("k", "v"):
            layer[n][:, :, :length] = kvs[str(li % G)][n][li // G]
        layer["pos"] = length
    return cache


def profile_lm(what, fn, wall_ms=None, want=None):
    """`fn()` under torch.profiler: device time split into the flash kernel,
    GEMMs (cuBLAS/CUTLASS kernels) and the rest, the top device ops, and
    the busy share of an unprofiled wall when one is given; `want` as in
    device_ops."""
    by_name = device_ops(fn, want)
    split = {"flash_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for name, (us, _) in by_name.items():
        low = name.lower()
        if KERNELS["flash_attention"][2] in name:
            split["flash_attention"] += us / 1e3
        elif any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass")):
            split["gemm"] += us / 1e3
        else:
            split["other"] += us / 1e3
    total = sum(split.values())
    calls = sum(c for _, c in by_name.values())
    busy = f", busy share {total / wall_ms:.4f} of an unprofiled wall of {wall_ms:.1f} ms" \
        if wall_ms else ""
    log(f"[lm] {what}: device time {total:.1f} ms over {calls} device ops{busy}: flash "
        f"kernel {split['flash_attention']:.1f} ms ({split['flash_attention'] / total:.3f}), "
        f"GEMMs {split['gemm']:.1f} ms ({split['gemm'] / total:.3f}), other "
        f"{split['other']:.1f} ms ({split['other'] / total:.3f}); top device ops:")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, c) in top:
        log(f"[lm]   {us / 1e3:10.3f} ms  {c:6d} calls  {name[:100]}")
    return dict(device_ms=total, device_ops=calls, wall_ms=wall_ms,
                **{f"{k}_ms": v for k, v in split.items()},
                top=[dict(name=n[:100], ms=us / 1e3, calls=c) for n, (us, c) in top])


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def serve_main_path(model, tokens) -> dict:
    """The LM's main path, launch counts from 0: `prefill_forward` over
    `tokens` (B, S), the KV stack copied into a decode cache, LM_DECODE
    greedy `serve_step`s. Checks one flash launch a layer in prefill and
    none in decode, finite logits and the cache's length. Returns the
    prefill's wall and last logits, each step's ms (CUDA events), the peak
    memory and the launches (prefill's flash alone, and all)."""
    from repro_torch.kernels.build import LAUNCHES

    (B, S), cfg = tokens.shape, model.cfg
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t = time.perf_counter()
    last, kvs = model.prefill_forward(tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    prefill_launches = dict(LAUNCHES)
    cache = cache_from_prefill(model, kvs, B, LM_MAX_SEQ, S)
    del kvs
    finite = torch.isfinite(last).all()
    tok = last.argmax(-1, keepdim=True)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(LM_DECODE)]
    for start, end in events:
        start.record()
        logits, cache = model.serve_step(cache, tok)
        end.record()
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    step_ms = [s.elapsed_time(e) for s, e in events]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_prefill = prefill_launches.get("flash_attention", 0)
    if n_prefill != cfg.n_layers or sum(prefill_launches.values()) != n_prefill:
        raise AssertionError(f"prefill launches {prefill_launches}, expected "
                             f"{cfg.n_layers} flash_attention")
    if launches != prefill_launches:
        raise AssertionError(f"decode launched kernels: {launches} after {prefill_launches}")
    if not bool(finite):
        raise AssertionError("non-finite logits in prefill or decode")
    if cache["layers"][0]["pos"] != S + LM_DECODE:
        raise AssertionError(f"cache at {cache['layers'][0]['pos']}")
    return dict(prefill_s=prefill_s, last=last, step_ms=step_ms, peak_gb=peak_gb,
                flash_prefill=n_prefill, launches=launches)


def lm_serving(device):
    """Phase 4: Qwen3-4B (36 layers, d_model 2560, vocab 151,936, bf16) with
    random weights from a seeded generator on the card. The main path: 4
    prompts of 4,096 tokens through `prefill_forward`, the KV stack copied
    into a decode cache, 64 greedy `serve_step`s; launch counts read around
    prefill and decode. Then a teacher-forced check and a profiled prefill."""
    from repro_torch.configs import qwen3_4b
    from repro_torch.data.tokens import token_batch
    from repro_torch.models.param import param_bytes, param_count
    from repro_torch.models.transformer import Transformer, lm_param_specs

    cfg = qwen3_4b.model_cfg()
    t = time.perf_counter()
    model = Transformer(cfg, generator=torch.Generator(device=device).manual_seed(0),
                        device=device)
    torch.cuda.synchronize()
    specs = lm_param_specs(cfg)
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
        f"{param_count(specs)} parameters, {param_bytes(specs) / 1e9:.2f} GB in bf16, "
        f"drawn on the card in {time.perf_counter() - t:.1f} s")
    B, S = LM_BATCH, LM_PROMPT
    tokens = torch.from_numpy(token_batch(0, B, S, cfg.vocab)["tokens"]).to(device)
    main = serve_main_path(model, tokens)
    prefill_s, step_ms, peak_gb = main["prefill_s"], main["step_ms"], main["peak_gb"]
    n_prefill, launches = main["flash_prefill"], main["launches"]
    log(f"[lm] main path: prefill {B} x {S} tokens in {prefill_s:.3f} s "
        f"({B * S / prefill_s:.0f} tokens/s), flash launches {n_prefill}; {LM_DECODE} greedy "
        f"decode steps: median {np.median(step_ms):.3f} ms, mean {np.mean(step_ms):.3f} ms "
        f"per step ({B} sequences), flash launches {launches['flash_attention'] - n_prefill}; "
        f"peak memory {peak_gb:.2f} GB; all logits finite")

    torch.cuda.synchronize()
    t = time.perf_counter()
    last, kvs = model.prefill_forward(tokens)
    torch.cuda.synchronize()
    prefill2_s = time.perf_counter() - t
    del kvs
    # teacher-forced: prefill S-1 tokens (a ragged length), decode the last
    _, kvs = model.prefill_forward(tokens[:, :-1])
    cache = cache_from_prefill(model, kvs, B, LM_MAX_SEQ, S - 1)
    del kvs
    step, cache = model.serve_step(cache, tokens[:, -1:])
    rel = rel_l2(step, last)
    max_err = float((step - last).abs().max())
    same_top = float((step.argmax(-1) == last.argmax(-1)).float().mean())
    log(f"[lm] second prefill {prefill2_s:.3f} s ({B * S / prefill2_s:.0f} tokens/s); "
        f"teacher-forced decode of token {S} vs prefill's last logits: relative L2 error "
        f"{rel:.4g} (tol {TEACHER_FORCED_REL_TOL}), max abs err {max_err:.4g} over logits "
        f"of max |{float(last.abs().max()):.3g}|, same argmax in {same_top:.2f} of requests")
    if not rel <= TEACHER_FORCED_REL_TOL:
        raise AssertionError(f"teacher-forced decode differs from prefill: {rel}")
    prof = profile_lm("prefill", lambda: model.prefill_forward(tokens), prefill2_s * 1e3,
                      want=KERNELS["flash_attention"][2])
    if prof["flash_attention_ms"] == 0:
        raise AssertionError("the prefill profile shows no flash_attention_kernel")

    def decode(n=8):  # greedy steps from the teacher-forced cache
        nonlocal cache, step
        for _ in range(n):
            step, cache = model.serve_step(cache, step.argmax(-1, keepdim=True))

    torch.cuda.synchronize()
    t = time.perf_counter()
    decode()
    torch.cuda.synchronize()
    decode_prof = profile_lm("8 decode steps", decode, (time.perf_counter() - t) * 1e3)
    return dict(model=cfg.name, batch=B, prompt=S, decode_steps=LM_DECODE,
                prefill_s=prefill_s, prefill_tokens_per_s=B * S / prefill_s,
                prefill2_s=prefill2_s, prefill2_tokens_per_s=B * S / prefill2_s,
                decode_ms_median=float(np.median(step_ms)),
                decode_ms_mean=float(np.mean(step_ms)), peak_memory_gb=peak_gb,
                flash_launches_prefill=n_prefill,
                flash_launches_decode=launches["flash_attention"] - n_prefill,
                teacher_forced_rel_l2=rel, teacher_forced_max_abs=max_err,
                profile=prof, decode_profile=decode_prof), n_prefill


def lm_card_vs_cpu(device):
    """Phase 5: a 2-layer Qwen3-4B at full width in float32, TF32 off, one
    prompt of 256 tokens: prefill on the card (through the flash kernel)
    against the CPU (through the plain version), logits and KV."""
    from repro_torch.configs import qwen3_4b
    from repro_torch.data.tokens import token_batch
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(qwen3_4b.model_cfg(), n_layers=2, dtype=torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = Transformer(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
        card = Transformer(cfg, params=cpu.tree(), device=device)
        tokens = torch.from_numpy(token_batch(1, 1, 256, cfg.vocab)["tokens"])
        before = LAUNCHES["flash_attention"]
        last_d, kv_d = card.prefill_forward(tokens.to(device))
        torch.cuda.synchronize()
        if LAUNCHES["flash_attention"] - before != cfg.n_layers:
            raise AssertionError("the card's prefill did not run the flash kernel per layer")
        last_c, kv_c = cpu.prefill_forward(tokens)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    errs = {"logits": (last_d.cpu(), last_c)}
    for n in ("k", "v"):
        errs[n] = (kv_d["0"][n].cpu(), kv_c["0"][n])
    out = {}
    for what, (a, b) in errs.items():
        err = float((a - b).abs().max()) / float(b.abs().max())
        out[what] = err
        if not err <= CARD_VS_CPU_TOL:
            raise AssertionError(f"card vs CPU {what}: max error / max |value| {err}")
    log(f"[lm-cpu] {cfg.name} x{cfg.n_layers} layers, float32, 256 tokens: card (flash "
        f"kernel) vs CPU (plain version), max error over max |value|: logits "
        f"{out['logits']:.3g}, k {out['k']:.3g}, v {out['v']:.3g} (tol {CARD_VS_CPU_TOL})")
    return out


# ---------------------------------------------------------------------------
# Phase 4, MoE: qwen2-moe-a2.7b whole and DBRX at full width, cut in depth;
# phase 5, MoE: the routing on the card against the CPU
# ---------------------------------------------------------------------------


def draw_lm(cfg, device, full_depth=None):
    """A Transformer of `cfg`, random weights drawn on `device` from a
    generator seeded with 0 (as `Transformer(cfg, generator=...)` draws
    them). With `full_depth`, the published depth of a config cut to fewer
    layers, each stacked matrix is drawn at the full model's scale: the
    reference takes a stacked leaf's fan-in from its stack axis (ROADMAP,
    "Stacked fan-in"), so the cut alone would draw it sqrt(full / cut)
    times wider."""
    from repro_torch.models.param import init_params, tree_map
    from repro_torch.models.transformer import Transformer, lm_param_specs, unstack_layers

    specs = lm_param_specs(cfg)
    if full_depth is not None:
        scale = float(1.0 / np.sqrt(full_depth // cfg.group_size))
        specs = tree_map(lambda p: dataclasses.replace(p, scale=scale)
                         if p.axes[0] == "stack" and p.init == "normal" and p.scale is None
                         else p, specs)
    params = init_params(specs, torch.Generator(device=device).manual_seed(0), device)
    return Transformer(cfg, params=unstack_layers(params, cfg), device=device)


class RouteLog:
    """While active, `repro_torch.models.moe.route` (which `moe_ffn` calls
    by name) is wrapped and each call's `Routing` kept, in call order: one a
    layer and a forward. Nothing syncs until the figures are read."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._route = [], moe.route

        def logged(*args, **kwargs):
            self.calls.append(self._route(*args, **kwargs))
            return self.calls[-1]

        moe.route = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._route


class LayerLog:
    """While active, `repro_torch.models.transformer._layer` and `_attention`
    (each called by name) are wrapped, and each call's last position kept,
    (B, d) in call order, one a layer and a forward: the layer's output in
    `x`, its attention's in `attn`."""

    def __enter__(self):
        from repro_torch.models import transformer as T

        self.x, self.attn, self._fns = [], [], (T._layer, T._attention)
        layer, attention = self._fns

        def logged_layer(*args, **kwargs):
            out = layer(*args, **kwargs)
            self.x.append(out[0][:, -1].clone())
            return out

        def logged_attention(*args, **kwargs):
            out = attention(*args, **kwargs)
            self.attn.append(out[0][:, -1].clone())
            return out

        T._layer, T._attention = logged_layer, logged_attention
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as T

        T._layer, T._attention = self._fns


@contextlib.contextmanager
def no_tf32():
    """float32 matrix products in float32 (TF32 off) while active."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def ties(r, k: int):
    """(tokens whose k-th and (k+1)-th probabilities tie, of them those
    tied at 0), as (T,) bool masks: where top-k takes the lower index."""
    top = torch.sort(r.probs, dim=-1, descending=True).values
    tie = top[:, k - 1] == top[:, k]
    return tie, tie & (top[:, k] == 0)


def routing_figures(r, k: int) -> dict:
    """One layer's routing: assignments dropped, the capacity, the busiest
    expert's assignments, and the tokens tied at the k-th probability."""
    tie, tie_0 = ties(r, k)
    load = torch.zeros(r.probs.shape[1], dtype=torch.int64, device=r.probs.device)
    load.scatter_add_(0, r.idx.reshape(-1), torch.ones_like(r.idx.reshape(-1)))
    return dict(assignments=r.keep.numel(), dropped=int((~r.keep).sum()),
                capacity=r.capacity, busiest=int(load.max()), ties=int(tie.sum()),
                ties_at_0=int(tie_0.sum()))


# device time of an MoE prefill by kind: a kernel goes to the first kind
# among whose aten ops is the op that launched it or one of its callers
# (aten::index and index_put_ include the rank's scatter of T k ids)
MOE_KINDS = (("expert GEMMs", ("aten::bmm",)),
             ("router softmax, sort and rank", ("aten::_softmax", "aten::sort",
                                                "aten::searchsorted", "aten::scatter_add_",
                                                "aten::masked_fill_")),
             ("dispatch scatter and gather", ("aten::index", "aten::index_put_")),
             ("other GEMMs", ("aten::mm", "aten::addmm")))


def profile_moe(what, fn, wall_ms=None) -> dict:
    """`fn()` under torch.profiler, its device time by kind: the flash
    kernel by name (it is launched through ctypes, outside any aten op),
    then MOE_KINDS by the aten op that launched each kernel (the CPU op of
    its Kineto event's linked correlation id) and that op's callers, the
    rest "other"; kernels that no aten op launched count as other, and
    their time is logged. Profiled again, up to PROFILE_TRIES, while the
    trace holds no flash kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flash = KERNELS["flash_attention"][2]
    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
        # device events as Kineto gives them: name, us, the correlation id
        # of the CPU op that launched them
        device = [(k.name(), k.duration_ns() / 1e3, k.linked_correlation_id())
                  for k in prof.profiler.kineto_results.events()
                  if k.device_type() == DeviceType.CUDA and "spin_kernel" not in k.name()]
        if any(flash in n for n, _, _ in device):
            break
        log(f"[profile] try {tries} of {PROFILE_TRIES}: the trace holds no {flash}")
    # a CPU op's FunctionEvent id is its correlation id; several nested ops
    # can share one, so the innermost (the longest chain of callers) wins
    launcher = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            chain, p = [], e
            while p is not None:
                chain.append(p.name)
                p = p.cpu_parent
            if len(chain) > len(launcher.get(e.id, ())):
                launcher[e.id] = chain
    split = dict.fromkeys(["flash_attention", *(k for k, _ in MOE_KINDS), "other"], 0.0)
    unclaimed = 0.0
    for name, us, corr in device:
        chain = launcher.get(corr)
        if flash in name:
            kind = "flash_attention"
        elif chain is None:
            kind, unclaimed = "other", unclaimed + us / 1e3
        else:
            kind = next((k for k, ops in MOE_KINDS if set(chain).intersection(ops)), "other")
        split[kind] += us / 1e3
    total = sum(us for _, us, _ in device) / 1e3
    busy = f", busy share {total / wall_ms:.4f} of an unprofiled wall of {wall_ms:.1f} ms" \
        if wall_ms else ""
    log(f"[moe] {what}: device time {total:.1f} ms over {len(device)} device ops{busy}: " +
        ", ".join(f"{k} {v:.1f} ms ({v / total:.3f})" for k, v in split.items()) +
        f"; {unclaimed:.1f} ms of kernels no aten op claims (in other); top device ops:")
    by_name = {}
    for name, us, _ in device:
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, c) in top:
        log(f"[moe]   {us / 1e3:10.3f} ms  {c:6d} calls  {name[:100]}")
    return dict(device_ms=total, device_ops=len(device), wall_ms=wall_ms,
                unclaimed_ms=unclaimed, **{f"{k}_ms": v for k, v in split.items()},
                top=[dict(name=n[:100], ms=us / 1e3, calls=c) for n, (us, c) in top])


def moe_serving(device, cfg, full_depth=None):
    """Phase 4, MoE: an MoE LM at full width in bf16 with random weights
    from a seeded generator on the card (`draw_lm`; a config cut in depth
    draws its layers at the full depth's scale). The main path as
    Qwen3-4B's (`serve_main_path`: 4 prompts of 4,096 tokens, 64 greedy
    decode steps), at the config's own capacity factor. Then a prefill with
    its routing logged, bit-equal to the main path's: the share of
    assignments dropped in each layer, the busiest expert, ties at the
    k-th probability; a second timed prefill; bf16 teacher-forced decode
    against prefill on a drop-free copy (capacity factor E / k: a capacity
    of every token, which no expert can overflow; checked), by layer,
    printed, not held (`moe_teacher_forced_f32` holds it in float32); a
    profiled prefill by kind; one MoE layer at the prefill's shape under
    `torch.cuda.set_sync_debug_mode("error")` (no host sync), and the same
    layer in bf16 against float32 (`moe_layer_bf16`, held)."""
    from repro_torch.data.tokens import token_batch
    from repro_torch.models.moe import expert_capacity
    from repro_torch.models.param import param_bytes, param_count
    from repro_torch.models.transformer import Transformer, lm_param_specs

    torch.cuda.empty_cache()
    mc = cfg.moe_cfg()
    what = cfg.name if full_depth is None else \
        f"{cfg.name} cut to {cfg.n_layers} of {full_depth} layers"
    t = time.perf_counter()
    model = draw_lm(cfg, device, full_depth)
    torch.cuda.synchronize()
    specs = lm_param_specs(cfg)
    log(f"[moe] {what}: d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, {mc.n_experts} experts ({mc.n_experts_padded} computed) of "
        f"{mc.d_ff_expert}, top-{mc.top_k}, shared expert {mc.d_ff_shared}, capacity factor "
        f"{mc.capacity_factor}, vocab {cfg.vocab}; {param_count(specs)} parameters, "
        f"{param_bytes(specs) / 1e9:.2f} GB in bf16, drawn on the card in "
        f"{time.perf_counter() - t:.1f} s")
    B, S = LM_BATCH, LM_PROMPT
    tokens = torch.from_numpy(token_batch(0, B, S, cfg.vocab)["tokens"]).to(device)
    main = serve_main_path(model, tokens)
    step_ms, n_prefill = main["step_ms"], main["flash_prefill"]
    cap, cap_decode = expert_capacity(B * S, mc), expert_capacity(B, mc)
    log(f"[moe] {what} main path: prefill {B} x {S} tokens in {main['prefill_s']:.3f} s "
        f"({B * S / main['prefill_s']:.0f} tokens/s; capacity {cap} an expert), flash "
        f"launches {n_prefill}; {LM_DECODE} greedy decode steps (capacity {cap_decode}): "
        f"median {np.median(step_ms):.3f} ms, mean {np.mean(step_ms):.3f} ms per step "
        f"({B} sequences), flash launches "
        f"{main['launches']['flash_attention'] - n_prefill}; peak memory "
        f"{main['peak_gb']:.2f} GB; all logits finite")

    with RouteLog() as routes:
        last, kvs = model.prefill_forward(tokens)
    del kvs
    if not torch.equal(last, main["last"]):
        raise AssertionError(f"{what}: two prefills of the same tokens differ")
    figs = [routing_figures(r, mc.top_k) for r in routes.calls]
    del routes
    if len(figs) != cfg.n_layers:
        raise AssertionError(f"{len(figs)} routed layers for {cfg.n_layers}")
    shares = [f["dropped"] / f["assignments"] for f in figs]
    log(f"[moe] {what}: a second prefill is bit-equal to the first; share of the "
        f"{figs[0]['assignments']} assignments dropped a layer at capacity {cap}: " +
        " ".join(f"{x:.4f}" for x in shares) + f" (mean {np.mean(shares):.4f}); busiest "
        f"expert a layer: " + " ".join(str(f["busiest"]) for f in figs) +
        f"; tokens whose {mc.top_k}th and {mc.top_k + 1}th probabilities tie: " +
        " ".join(str(f["ties"]) for f in figs) + " (at 0: " +
        " ".join(str(f["ties_at_0"]) for f in figs) + ")")

    torch.cuda.synchronize()
    t = time.perf_counter()
    model.prefill_forward(tokens)
    torch.cuda.synchronize()
    prefill2_s = time.perf_counter() - t

    # teacher-forced decode against a drop-free prefill: a copy at capacity
    # factor E / k (a capacity of every token); by layer from `LayerLog`
    factor = mc.n_experts / mc.top_k
    free = Transformer(dataclasses.replace(cfg, capacity_factor=factor), params=model.tree(),
                       device=device)
    tf = teacher_forced(free, tokens)
    del free
    lay = tf["layers"]
    log(f"[moe] {what}: second prefill {prefill2_s:.3f} s ({B * S / prefill2_s:.0f} "
        f"tokens/s); bf16 teacher-forced decode of token {S} vs a drop-free prefill's last "
        f"logits (capacity factor {factor:g}: capacity {tf['capacity']}, 0 dropped), relative "
        f"L2 error {tf['rel_l2']:.4g} (same argmax {tf['same_argmax']:.2f}; not held: "
        f"moe_teacher_forced_f32 holds it in float32); by layer: the first L layers' logits " +
        by_layer(lay, "logits", ".4g") + "; requests routed alike " +
        by_layer(lay, "routed_alike", "d") + f" of {B}; attention output " +
        by_layer(lay, "attention") + "; hidden state " + by_layer(lay, "hidden"))
    prof = profile_moe(f"{what} prefill", lambda: model.prefill_forward(tokens),
                       prefill2_s * 1e3)
    if prof["flash_attention_ms"] == 0 or prof["expert GEMMs_ms"] == 0:
        raise AssertionError(f"{what}: the prefill profile lacks flash or the expert GEMMs")

    g = torch.Generator(device=device).manual_seed(3)
    h = torch.randn(B * S, cfg.d_model, generator=g, device=device).to(cfg.dtype)
    ffn = model.layers[0].ffn
    ffn(h)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ffn(h)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"[moe] {what}: one MoE layer over {B * S} tokens ran under "
        f"set_sync_debug_mode(\"error\"): no host sync")
    layer = moe_layer_bf16(model, h)
    log(f"[moe] {what}: layer 0's MoE FFN over {B * S} tokens in bf16 vs float32 (TF32 off), "
        f"routed alike, {layer['dropped']} of {layer['assignments']} assignments dropped: "
        f"max error over max |output| {layer['err']:.4g} (tol {MOE_BF16_TOL:.4g}), relative "
        f"L2 error {layer['rel_l2']:.4g}")
    return dict(model=cfg.name, layers=cfg.n_layers, full_depth=full_depth or cfg.n_layers,
                batch=B, prompt=S, decode_steps=LM_DECODE, capacity=cap,
                capacity_decode=cap_decode, prefill_s=main["prefill_s"],
                prefill_tokens_per_s=B * S / main["prefill_s"], prefill2_s=prefill2_s,
                prefill2_tokens_per_s=B * S / prefill2_s,
                decode_ms_median=float(np.median(step_ms)),
                decode_ms_mean=float(np.mean(step_ms)), peak_memory_gb=main["peak_gb"],
                flash_launches_prefill=n_prefill,
                flash_launches_decode=main["launches"]["flash_attention"] - n_prefill,
                dropped_share=shares, routing=figs, drop_free_factor=factor,
                teacher_forced_bf16=tf, bf16_layer=layer, profile=prof), n_prefill


def moe_layer_bf16(model, h) -> dict:
    """The model's first MoE FFN at full width over tokens h (T, d) in bf16,
    against the same FFN in float32 (its weights and h upcast, TF32 off),
    routed alike (the router reads h in float32 on both sides; checked).
    Held: max error over max |output| within MOE_BF16_TOL."""
    from repro_torch.models.moe import moe_routed
    from repro_torch.models.param import tree_map

    ffn = model.layers[0].ffn
    with no_tf32():
        out, r = moe_routed(ffn.tree(), h, ffn.cfg)
        out32, r32 = moe_routed(tree_map(lambda a: a.float(), ffn.tree()), h.float(),
                                dataclasses.replace(ffn.cfg, dtype=torch.float32))
    for name in ("idx", "rank", "keep", "dest_e", "dest_c"):
        if not torch.equal(getattr(r, name), getattr(r32, name)):
            raise AssertionError(f"bf16 vs float32 MoE layer: {name} differs")
    err = float((out.float() - out32).abs().max()) / float(out32.abs().max())
    fig = dict(err=err, rel_l2=rel_l2(out, out32), dropped=int((~r.keep).sum()),
               assignments=r.keep.numel())
    if not err <= MOE_BF16_TOL:
        raise AssertionError(f"bf16 vs float32 MoE layer: max error / max |output| {err}")
    return fig


def teacher_forced(model, tokens) -> dict:
    """Prefill all of `tokens` (B, S), and S - 1 of them then decode the last
    (teacher-forced), with no MoE assignment dropped (checked). The decode's
    last position against the prefill's: the logits (relative L2 error, max
    abs error, same-argmax share), and after each layer (`LayerLog`,
    `RouteLog`): the requests routed alike (the same top-k experts in the
    same order), the largest gate difference, the least gap among the
    prefill's k + 1 largest probabilities, the relative L2 error of the
    attention output, of the hidden state and of the logits of the first L
    layers (the final norm and the unembedding of layer L's output, which
    is what a model cut to L layers computes)."""
    from repro_torch.models import layers as L

    B, S = tokens.shape
    cfg, k = model.cfg, model.cfg.top_k
    with RouteLog() as pre_routes, LayerLog() as pre:
        full_last, kvs = model.prefill_forward(tokens)
    del kvs
    with RouteLog() as cut_routes:
        _, kvs = model.prefill_forward(tokens[:, :-1])
    dropped = sum(int((~r.keep).sum()) for r in pre_routes.calls + cut_routes.calls)
    capacity = pre_routes.calls[0].capacity
    del cut_routes
    if dropped:
        raise AssertionError(f"{cfg.name}: {dropped} assignments dropped at capacity "
                             f"factor {cfg.capacity_factor}")
    cache = cache_from_prefill(model, kvs, B, S + 1, S - 1)
    del kvs
    with RouteLog() as dec_routes, LayerLog() as dec:
        step, _ = model.serve_step(cache, tokens[:, -1:])
    del cache

    def logits(x):
        return model._logits(L.rms_norm(x, model.final_norm, cfg.norm_eps))

    last = torch.arange(B, device=tokens.device) * S + S - 1
    layers = []
    for li, (p, d) in enumerate(zip(pre_routes.calls, dec_routes.calls)):
        probs = p.probs[last]
        top = torch.sort(probs, dim=-1, descending=True).values[:, :k + 1]
        gap = (top[:, :-1] - top[:, 1:]).min(1).values
        alike = (p.idx[last] == d.idx).all(1)
        gates_p = torch.zeros_like(probs).scatter_(1, p.idx[last], p.gates[last])
        gates_d = torch.zeros_like(probs).scatter_(1, d.idx, d.gates)
        layers.append(dict(routed_alike=int(alike.sum()), least_gap=float(gap.min()),
                           least_gap_otherwise=float(gap[~alike].min()) if not alike.all()
                           else None,
                           gate_diff=float((gates_p - gates_d).abs().max()),
                           attention=rel_l2(dec.attn[li], pre.attn[li]),
                           hidden=rel_l2(dec.x[li], pre.x[li]),
                           logits=rel_l2(logits(dec.x[li]), logits(pre.x[li]))))
    return dict(rel_l2=rel_l2(step, full_last), max_abs=float((step - full_last).abs().max()),
                max_abs_logit=float(full_last.abs().max()),
                same_argmax=float((step.argmax(-1) == full_last.argmax(-1)).float().mean()),
                capacity=capacity, requests=B, layers=layers,
                routed_alike=all(x["routed_alike"] == B for x in layers))


def by_layer(layers: list, key: str, fmt: str = ".3g") -> str:
    return " ".join(format(x[key], fmt) for x in layers)


def perturbed_prefill(model, tokens, seed: int) -> dict:
    """The model's own sensitivity to rounding: a prefill of `tokens` whose
    embedded input has every entry moved by one float32 ulp, up or down
    from a seeded draw, against the unmoved prefill. The relative L2 error
    of the last position's logits, and after each layer of its hidden
    state."""
    from repro_torch.models.transformer import Transformer

    with LayerLog() as base:
        base_last, kvs = model.prefill_forward(tokens)
    del kvs
    g = torch.Generator(device=tokens.device).manual_seed(seed)

    def moved(tok):
        x = Transformer._embed(model, tok)
        up = torch.rand(x.shape, generator=g, device=x.device) < 0.5
        return torch.nextafter(x, torch.where(up, torch.inf, -torch.inf).to(x.dtype))

    model._embed = moved
    try:
        with LayerLog() as other:
            last, kvs = model.prefill_forward(tokens)
        del kvs
    finally:
        del model._embed
    return dict(rel_l2=rel_l2(last, base_last),
                hidden=[rel_l2(a, b) for a, b in zip(other.x, base.x)])


def moe_teacher_forced_f32(device, cfg, full_depth):
    """Phase 4, MoE: the served model in float32 with TF32 off (qwen2-moe
    whole, DBRX cut as it is served, drawn at its full depth's scale), one
    prompt of LM_PROMPT tokens, drop-free (capacity factor E / k):
    teacher-forced decode against prefill (`teacher_forced`), then the same
    with the prefill's attention through the plain version (the flash
    kernel left out), and two prefills whose input moved by an ulp
    (`perturbed_prefill`). Held: the decode's token routed as the
    prefill's last in every layer, and the logits within
    TEACHER_FORCED_F32_REL_TOL. The bf16 comparison is not held
    (moe_serving prints it): decode's attention scores are the reference's
    bf16 einsum, rounded to bf16 at |scores| of hundreds without qk_norm,
    where prefill's flash scores are float32; the reference's own decode
    parts from its flash prefill as far (tests/_moe_bf16_witness.py)."""
    from repro_torch.data.tokens import token_batch
    from repro_torch.kernels import ops, ref

    torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg, dtype=torch.float32,
                              capacity_factor=cfg.n_experts / cfg.top_k)
    attention = ops.attention
    with no_tf32():
        model = draw_lm(f32, device, full_depth)
        tokens = torch.from_numpy(token_batch(0, 1, LM_PROMPT, f32.vocab)["tokens"]).to(device)
        tf = teacher_forced(model, tokens)
        moved = [perturbed_prefill(model, tokens, seed) for seed in (1, 2)]
        ops.attention = lambda q, k, v, **kw: ref.attention_chunked_ref(q, k, v, **{
            n: kw[n] for n in ("causal", "window", "softcap")})
        try:
            plain = teacher_forced(model, tokens)
        finally:
            ops.attention = attention
    what = cfg.name if full_depth is None else \
        f"{cfg.name} cut to {cfg.n_layers} of {full_depth} layers"
    lay = tf["layers"]
    log(f"[moe] {what} at full width, float32, TF32 off, 1 x {LM_PROMPT} tokens, drop-free "
        f"(capacity {tf['capacity']}): teacher-forced decode vs prefill, relative L2 error "
        f"{tf['rel_l2']:.4g} (tol {TEACHER_FORCED_F32_REL_TOL}; max abs err "
        f"{tf['max_abs']:.3g} over logits of max |{tf['max_abs_logit']:.3g}|, same argmax "
        f"{tf['same_argmax']:.2f}); with the "
        f"prefill's attention through the plain version {plain['rel_l2']:.4g}; a prefill "
        f"whose input moved by an ulp: " + ", ".join(f"{m['rel_l2']:.4g}" for m in moved) +
        ". By layer: routed alike " + by_layer(lay, "routed_alike", "d") +
        f" of 1; least gap among the {f32.top_k + 1} largest probabilities " +
        by_layer(lay, "least_gap") + "; largest gate difference " +
        by_layer(lay, "gate_diff") + "; relative L2 error of the attention output " +
        by_layer(lay, "attention") + ", of the hidden state " + by_layer(lay, "hidden") +
        " (input moved by an ulp: " + "; ".join(" ".join(f"{x:.3g}" for x in m["hidden"])
                                               for m in moved) +
        "), of the first L layers' logits " + by_layer(lay, "logits"))
    if not tf["routed_alike"]:
        raise AssertionError(f"{what}: float32 decode routes otherwise than prefill: {lay}")
    if not tf["rel_l2"] <= TEACHER_FORCED_F32_REL_TOL:
        raise AssertionError(f"{what}: float32 teacher-forced decode differs from prefill: "
                             f"{tf['rel_l2']}")
    return dict(teacher_forced=tf, plain_attention=plain, input_moved=moved)


def moe_card_vs_cpu(device):
    """Phase 5, MoE: qwen2-moe-a2.7b at full width cut to 2 layers, float32,
    TF32 off, one prompt of MOE_CPU_PROMPT tokens, prefill on the card
    (flash kernel) against the CPU (plain version). Every layer's top-k
    indices, ranks, keep mask and destinations must be equal on every
    token, logits and KV within CARD_VS_CPU_TOL. Counted beside: the
    tokens whose k-th and (k+1)-th probabilities tie, and the tokens the
    card routes otherwise when TF32 is on."""
    from repro_torch.configs import qwen2_moe_a2_7b
    from repro_torch.data.tokens import token_batch
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(qwen2_moe_a2_7b.model_cfg(), n_layers=2, dtype=torch.float32)
    k = cfg.top_k
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = Transformer(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
        card = Transformer(cfg, params=cpu.tree(), device=device)
        tokens = torch.from_numpy(token_batch(1, 1, MOE_CPU_PROMPT, cfg.vocab)["tokens"])
        before = LAUNCHES["flash_attention"]
        with RouteLog() as on_card:
            last_d, kv_d = card.prefill_forward(tokens.to(device))
        torch.cuda.synchronize()
        if LAUNCHES["flash_attention"] - before != cfg.n_layers:
            raise AssertionError("the card's prefill did not run the flash kernel per layer")
        with RouteLog() as on_cpu:
            last_c, kv_c = cpu.prefill_forward(tokens)
        torch.backends.cuda.matmul.allow_tf32 = True
        with RouteLog() as with_tf32:
            card.prefill_forward(tokens.to(device))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    layers, routing_ok = [], True
    for li, (d, c, t32) in enumerate(zip(on_card.calls, on_cpu.calls, with_tf32.calls)):
        by_token = (d.idx.cpu() != c.idx).any(1)
        for name in ("rank", "keep", "dest_e", "dest_c"):
            by_token |= (getattr(d, name).cpu() != getattr(c, name)).view(-1, k).any(1)
        fig = routing_figures(c, k)
        differ = int(by_token.sum())
        layers.append(dict(layer=li, tokens_differ=differ,
                           differ_on_ties=int((by_token & ties(c, k)[0]).sum()),
                           ties=fig["ties"],
                           ties_at_0=fig["ties_at_0"], dropped=fig["dropped"],
                           assignments=fig["assignments"], capacity=fig["capacity"],
                           tf32_tokens_differ=int((t32.idx.cpu() != c.idx).any(1).sum())))
        routing_ok &= differ == 0
    errs = {"logits": (last_d.cpu(), last_c)}
    for n in ("k", "v"):
        errs[n] = (kv_d["0"][n].cpu(), kv_c["0"][n])
    out = {}
    for what, (a, b) in errs.items():
        out[what] = float((a - b).abs().max()) / float(b.abs().max())
    log(f"[moe-cpu] {cfg.name} x{cfg.n_layers} layers, float32, TF32 off, "
        f"{MOE_CPU_PROMPT} tokens: card vs CPU routing, per layer: " + "; ".join(
            f"layer {x['layer']}: {x['tokens_differ']} tokens routed otherwise "
            f"({x['differ_on_ties']} of them on a tie), {x['ties']} tokens with the "
            f"{k}th and {k + 1}th probabilities tied ({x['ties_at_0']} at 0), "
            f"{x['dropped']} of {x['assignments']} assignments dropped at capacity "
            f"{x['capacity']}; with TF32 on {x['tf32_tokens_differ']} tokens routed otherwise"
            for x in layers) +
        f". Max error over max |value|: logits {out['logits']:.3g}, k {out['k']:.3g}, v "
        f"{out['v']:.3g} (tol {CARD_VS_CPU_TOL})")
    if not routing_ok:
        raise AssertionError(f"card vs CPU: routing differs {layers}")
    for what, err in out.items():
        if not err <= CARD_VS_CPU_TOL:
            raise AssertionError(f"card vs CPU {what}: max error / max |value| {err}")
    return dict(errors=out, layers=layers)


# ---------------------------------------------------------------------------
# Phase 1, segment sum and embedding bag: the kernels against their plain
# versions in float64, with tolerances that check themselves
# ---------------------------------------------------------------------------


def seg_tol(abs_sum: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Per element: SEG_REL * sum_e |v_e| + SEG_ABS (times `scale`)."""
    return scale * (SEG_REL * abs_sum + SEG_ABS)


def seg_bound_ms(kept: int, N: int, D: int) -> float:
    """Least time at the HBM rate for the segment-sum kernel: each kept
    edge's row of D float32 and its order entry read once, the N + 1
    offsets read once, the (N, D) output written once."""
    return (kept * (D * 4 + 8) + (N + 1) * 8 + N * D * 4) / HBM_BYTES_PER_S * 1e3


def seg_inputs(E, D, N, ids, dtype, device, seed):
    """Standard normal values and ids: "valid" in [0, N), "invalid" with
    20 % -1 (the test grid's draws), "wide" in [-1, N + 5), "sparse" N
    apart at most E distinct, "none" all -1, "skewed" a power law, "hub"
    nine tenths of the edges in segment 3 and the rest in [-1, N), "k"
    segments 1, 2, 4, 6, 7 of K - 1, K, K + 1, 2K and 2K + 1 edges (E
    from K) and 200 edges in other segments or dropped."""
    from repro_torch.kernels.segment_reduce import TASK_EDGES as K

    rng = np.random.default_rng(seed)
    if ids == "k":
        seg = np.concatenate([np.repeat([1, 2, 4, 6, 7], [K - 1, K, K + 1, 2 * K, 2 * K + 1]),
                              rng.choice([-1, 0, 3, 5, 8, N + 1], size=200)])
        rng.shuffle(seg)
        E = len(seg)
    vals = rng.standard_normal((E, D)).astype(np.float32)
    if ids == "hub":
        seg = rng.integers(-1, N, E)
        seg[rng.permutation(E)[:E * 9 // 10]] = 3
    elif ids == "sparse":
        seg = rng.choice(N, size=E)
    elif ids == "wide":
        seg = rng.integers(-1, N + 5, E)
    elif ids == "none":
        seg = np.full(E, -1)
    elif ids == "skewed":
        seg = (rng.random(E) ** 2 * N).astype(np.int64)
    elif ids in ("valid", "invalid"):
        seg = rng.integers(0, N, E)
        if ids == "invalid":
            seg[rng.random(E) < 0.2] = -1
    return (torch.from_numpy(vals).to(device=device, dtype=dtype),
            torch.from_numpy(seg.astype(np.int32)).to(device))


def check_segment_grid(device):
    """Both segment-sum wrappers (ids in any order; ids sorted, dropped -1
    first) against `segment_sum_ref` on float64 copies of the values at
    every SEG_GRID case, within `seg_tol`."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_reduce import segment_sum, segment_sum_sorted

    max_err, used = 0.0, 0.0
    for i, (what, E, D, N, ids, dtype) in enumerate(SEG_GRID):
        vals, seg = seg_inputs(E, D, N, ids, dtype, device, seed=i)
        keys, order = torch.sort(seg, stable=True)
        outs = {"segment_sum": segment_sum(vals, seg, N),
                "segment_sum_sorted": segment_sum_sorted(vals[order].contiguous(), keys, N)}
        torch.cuda.synchronize()
        v64 = vals.double()
        plain = ref.segment_sum_ref(v64, seg, N)
        tol = seg_tol(ref.segment_sum_ref(v64.abs(), seg, N))
        for name, out in outs.items():
            if out.dtype != torch.float32 or out.shape != (N, D):
                raise AssertionError(f"{name} at {what}: {out.dtype} {tuple(out.shape)}")
            diff = (out.double() - plain).abs()
            if not bool((diff <= tol).all()):
                raise AssertionError(f"{name} != segment_sum_ref at {what}: max err "
                                     f"{float(diff.max())}")
            if diff.numel():
                max_err = max(max_err, float(diff.max()))
                used = max(used, float((diff / tol).max()))
    log(f"[kernel] segment_sum: both wrappers on {len(SEG_GRID)} cases (the test grid, "
        f"sparse ids, ids >= N, all -1, E 1, D 1 / 75 / 129, bf16, hubs of >= 10^5 edges "
        f"at D 75 / 1 and in bf16, segments of K +- 1 and 2K (+ 1) edges) within {SEG_REL} "
        f"sum|v| + {SEG_ABS} of the float64 plain version: max err {max_err:.3g}, "
        f"{used:.4f} of the tolerance")
    return max_err


def bag_check(out, table, idx, w, combine, scale=1.0):
    """|out - plain| against BAG_REL * sum_l |w row| (over the count for a
    mean), plus 2^-8 |plain| for a bf16 output (its rounding); plain and
    the sums of magnitudes on float64 copies. Returns (max err, share of
    the tolerance used, plain, tol)."""
    from repro_torch.kernels import ref

    t64 = table.double()
    w64 = None if w is None else w.double()
    plain = ref.embedding_bag_ref(t64, idx, w64, combine)
    mags = ref.embedding_bag_ref(t64.abs(), idx, None if w is None else w64.abs(), combine)
    tol = scale * BAG_REL * mags
    if out.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * plain.abs()
    diff = (out.double() - plain).abs()
    if not bool((diff <= tol).all()):
        raise AssertionError(f"embedding_bag != embedding_bag_ref: max err {float(diff.max())}")
    used = float((diff / tol.clamp(min=1e-300)).max()) if diff.numel() else 0.0
    return (float(diff.max()) if diff.numel() else 0.0), used, plain, tol


def bag_branch(table) -> tuple:
    """(T, VEC): the branch of csrc/embedding_bag.cu that its host code
    picks for `table`. VEC = 2 for an even D whose base is aligned to two
    elements, else 1."""
    D = table.shape[1]
    vec = 2 if D % 2 == 0 and table.data_ptr() % (2 * table.element_size()) == 0 else 1
    return BAG_TYPES[table.dtype], vec


def bag_grid_inputs(i, B, L, V, D, weighted, dtype, hi, shift, pad, device):
    """A BAG_GRID case's table (a contiguous view `shift` elements into its
    storage), ids and weights, drawn from seed 100 + i."""
    rng = np.random.default_rng(100 + i)
    flat = torch.from_numpy(rng.standard_normal(V * D + shift).astype(np.float32))
    table = flat.to(device=device, dtype=dtype)[shift:].view(V, D)
    lo, top = (V, 2 * V + 5) if pad == "past V" else (0, hi or V)
    idx = rng.integers(lo, top, (B, L))
    if pad == "tail":
        idx[np.arange(L)[None, :] >= rng.integers(1, L - 31, (B, 1))] = -1
    else:
        idx[rng.random((B, L)) < (1.0 if pad == "all" else 0.25)] = -1
    w = torch.from_numpy(rng.random((B, L)).astype(np.float32)).to(device) if weighted else None
    return table, torch.from_numpy(idx.astype(np.int32)).to(device), w


def check_bag_grid(device):
    """The bag kernel against `embedding_bag_ref` on float64 copies at every
    BAG_GRID case, each case's branch read back from a profile of its
    launch (the kernel's name carries <T, VEC>); the cases together
    take every branch."""
    from repro_torch.kernels.embedding_bag import embedding_bag

    symbol = KERNELS["embedding_bag"][2]
    max_err, used, seen = 0.0, {F32: 0.0, BF16: 0.0}, set()
    for i, (what, B, L, V, D, combine, weighted, dtype, hi, shift, pad) in enumerate(BAG_GRID):
        table, idx, w = bag_grid_inputs(i, B, L, V, D, weighted, dtype, hi, shift, pad, device)
        out = embedding_bag(table, idx, w, combine)
        torch.cuda.synchronize()
        if out.dtype != dtype or out.shape != (B, D):
            raise AssertionError(f"embedding_bag at {what}: {out.dtype} {tuple(out.shape)}")
        err, u, _, _ = bag_check(out, table, idx, w, combine)
        max_err, used[dtype] = max(max_err, err), max(used[dtype], u)
        branch = bag_branch(table)
        names = [n for n in device_ops(lambda: embedding_bag(table, idx, w, combine),
                                       want=symbol) if symbol in n]
        if not names or any(f"{symbol}<{branch[0]}, {branch[1]}>" not in n for n in names):
            raise AssertionError(f"embedding_bag at {what}: expected branch {branch}, the "
                                 f"profile shows {names}")
        seen.add(branch)
        log(f"[bag] {what}: branch <{branch[0]}, VEC {branch[1]}> "
            f"({'vector' if branch[1] == 2 else 'scalar'}), base {table.data_ptr() % 16} mod 16 "
            f"bytes, max err {err:.3g}, {u:.4f} of the tolerance")
    if seen != BAG_BRANCHES:
        raise AssertionError(f"BAG_GRID misses branches {sorted(BAG_BRANCHES - seen)}")
    log(f"[kernel] embedding_bag: {len(BAG_GRID)} cases (the test grid, ids >= V clamped, "
        f"all padding, B 1, L 32 / 100, tail padding, D 1 to 200, shifted bases, bf16) over "
        f"all {len(BAG_BRANCHES)} branches within {BAG_REL} sum|w row| (+ 2^-8 |plain| in "
        f"bf16) of the float64 plain version: max err {max_err:.3g}; share of the tolerance "
        f"used {used[F32]:.4f} in float32, {used[BF16]:.4f} in bf16 (whose output rounding "
        f"alone may use all of it)")
    return max_err


# ---------------------------------------------------------------------------
# Phase 6: GNN aggregation at the repo's ogb_products shape
# ---------------------------------------------------------------------------


def synthetic_edges(N, E, g, device):
    """Destination ids of E synthetic edges over N nodes: floor(N u^2) for
    uniform u (a power law: node k draws about E / (2 sqrt(N k)) edges, so
    the hub holds about E / sqrt(N)), relabelled by a random permutation,
    with PAD_SHARE of the ids set to -1 as a sampler pads."""
    u = torch.rand(E, generator=g, device=device)
    dst = (u.square_() * N).long().clamp_(max=N - 1)
    del u
    dst = torch.randperm(N, generator=g, device=device)[dst].int()
    dst[torch.rand(E, generator=g, device=device) < PAD_SHARE] = -1
    return dst


def agg_expect(v64, dst, N, scale=1.0):
    """Float64 sum, mean, max, min and std of `aggregate` with their
    tolerances: sum within seg_tol; mean within seg_tol / count; max and
    min exact; std checked as |sd_k - sd_p| (sd_k + sd_p) = |var_k -
    var_p| <= tol_var, where tol_var carries the means' errors into m2 -
    m1^2, plus 2^-20 (m2 + m1^2 + 1e-6) for its float32 rounding. The
    squares are of one sign, so the rounding errors of their float32 sum
    over L edges add up like 2^-24 sqrt(L) sum v^2 (not below 1e-6 of it
    for a hub): m2's tolerance adds 2^-22 sqrt(L) sum v^2 / L."""
    from repro_torch.kernels import ref

    s = ref.segment_sum_ref(v64, dst, N)
    mx = ref.segment_max_ref(v64, dst, N)
    mn = -ref.segment_max_ref(-v64, dst, N)
    a = ref.segment_sum_ref(v64.abs(), dst, N)
    q = ref.segment_sum_ref(v64.square(), dst, N)
    c = ref.segment_sum_ref(torch.ones_like(v64[:, :1]), dst, N).clamp_(min=1)
    tol_s = seg_tol(a, scale)
    m1, tol_m1 = s / c, tol_s / c
    m2, tol_m2 = q / c, (seg_tol(q, scale) + scale * 2.0 ** -22 * c.sqrt() * q) / c
    var = (m2 - m1 * m1).clamp(min=0)
    tol_var = tol_m2 + (2 * m1.abs() + tol_m1) * tol_m1 + 2.0 ** -20 * (m2 + m1 * m1 + 1e-6)
    return {"sum": (s, tol_s), "mean": (m1, tol_m1), "max": (mx, None), "min": (mn, None),
            "std": ((var + 1e-6).sqrt(), tol_var)}


def agg_errors(outs, expect, cols=slice(None)):
    """{kind: (max err, share of its tolerance used)}; raises on a miss."""
    errs = {}
    for kind, out in zip(AGG_KINDS, outs):
        got = out[:, cols].double()
        want, tol = expect[kind]
        diff = (got - want).abs()
        if tol is None:
            ok, used = bool((diff == 0).all()), 0.0
        elif kind == "std":
            lhs = diff * (got + want)
            ok, used = bool((lhs <= tol).all()), float((lhs / tol).max())
        else:
            ok, used = bool((diff <= tol).all()), float((diff / tol).max())
        if not ok:
            raise AssertionError(f"aggregate {kind}: max err {float(diff.max())}")
        errs[kind] = (float(diff.max()), used)
    return errs


def gnn_aggregation(device):
    """Phase 6: `aggregate(messages, dst, N, AGG_KINDS)` over synthetic
    edges at the repo's ogb_products shape (configs/base.py: 2,449,029
    nodes, 61,859,140 edges) with PNA's message width 75 (configs/pna.py),
    standard normal float32 messages made on the card from a seed. The
    main path is that one call: SEG_LAUNCHES_PER_AGGREGATE segment_sum
    launches. Then a profile of a call, the kernel's own time, the
    wrapper's, the plain version's and index_add_'s beside the bound, and
    the result against the float64 plain version, column block by block,
    with the tolerance's self-check (each segment's last edge dropped)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.kernels.segment_reduce import (TASK_EDGES, _launch_csr, segment_order,
                                                    segment_sum, segment_tasks)
    from repro_torch.models.gnn.message_passing import aggregate

    N, E, D = GNN_SHAPE
    torch.cuda.empty_cache()
    g = torch.Generator(device=device).manual_seed(0)
    t = time.perf_counter()
    dst = synthetic_edges(N, E, g, device)
    msgs = torch.randn((E, D), generator=g, device=device)
    torch.cuda.synchronize()
    order, offsets = segment_order(dst, N)
    lengths = offsets.diff()
    kept, max_len = int(offsets[-1]), int(lengths.max())
    log(f"[gnn] synthetic edges at the repo's ogb_products shape: {N} nodes, {E} edges "
        f"({kept} kept, {E - kept} padded with -1), largest segment {max_len} edges, "
        f"{int((lengths == 0).sum())} empty; messages ({E}, {D}) float32, "
        f"{msgs.numel() * 4 / 1e9:.2f} GB; made and sorted on the card in "
        f"{time.perf_counter() - t:.3f} s")
    if max_len < 10_000:
        raise AssertionError(f"largest segment {max_len} < 10^4: not the skew asked for")

    # the main path, counts from 0
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = aggregate(msgs, dst, N, kinds=AGG_KINDS)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
    launches = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != {"segment_sum": SEG_LAUNCHES_PER_AGGREGATE}:
        raise AssertionError(f"aggregate launched {launches}, expected "
                             f"{SEG_LAUNCHES_PER_AGGREGATE} segment_sum")
    for out in outs:
        if out.shape != (N, D) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"aggregate output {tuple(out.shape)} not finite")
    t = time.perf_counter()
    aggregate(msgs, dst, N, kinds=AGG_KINDS)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t) * 1e3

    by_name = device_ops(lambda: aggregate(msgs, dst, N, kinds=AGG_KINDS),
                         want=KERNELS["segment_sum"][2])
    split = {"segment_sum kernel": 0.0, "sort + offsets": 0.0, "max/min scatter_reduce": 0.0,
             "other": 0.0}
    traced = 0
    for name, (us, calls) in by_name.items():
        low = name.lower()
        if KERNELS["segment_sum"][2] in name:
            split["segment_sum kernel"] += us / 1e3
            traced += calls
        elif "sort" in low:
            split["sort + offsets"] += us / 1e3
        elif "scatter" in low:
            split["max/min scatter_reduce"] += us / 1e3
        else:
            split["other"] += us / 1e3
    total = sum(split.values())
    log(f"[gnn] profiled aggregate: device time {total:.1f} ms over "
        f"{sum(c for _, c in by_name.values())} device ops ({traced} of "
        f"{SEG_LAUNCHES_PER_AGGREGATE} segment_sum launches in the trace), busy share "
        f"{total / warm_ms:.4f} of the unprofiled warm {warm_ms:.1f} ms: " + ", ".join(
            f"{k} {v:.1f} ms ({v / total:.3f})" for k, v in split.items()))
    for name, (us, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[gnn]   {us / 1e3:10.3f} ms  {c:4d} calls  {name[:100]}")

    # one launch alone, at width 75 and at width 1 (the count of a mean)
    ones = torch.ones((E, 1), device=device)
    k_ms = median_ms(lambda: _launch_csr(msgs, order, offsets, N), reps=10)
    k1_ms = median_ms(lambda: _launch_csr(ones, order, offsets, N), reps=10)
    w_ms = median_ms(lambda: segment_sum(msgs, dst, N), reps=10)
    p_ms = median_ms(lambda: ref.segment_sum_ref(msgs, dst, N), reps=5)
    keep = (dst >= 0) & (dst < N)
    ids, vals = dst[keep].long(), msgs[keep]
    lib_ms = median_ms(lambda: torch.zeros((N, D), device=device).index_add_(0, ids, vals), reps=5)
    del ids, vals, keep
    torch.cuda.empty_cache()
    b_ms, b1_ms = seg_bound_ms(kept, N, D), seg_bound_ms(kept, N, 1)
    # the function reads all ids, each kept row once, and writes the output
    fb_ms = (kept * D * 4 + E * 4 + N * D * 4) / HBM_BYTES_PER_S * 1e3
    # not the bound: a gathered 4-byte value moves a whole 32-byte sector
    sector1_ms = (kept * (32 + 8) + (N + 1) * 8 + N * 4) / HBM_BYTES_PER_S * 1e3
    tasks_ms = median_ms(lambda: segment_tasks(offsets), reps=10)
    # what the width-1 launch's gathers alone cost: ones[order], one PyTorch call
    gather1_ms = median_ms(lambda: torch.index_select(ones, 0, order), reps=10)
    log(f"[gnn] segment_sum at width {D}: kernel alone (task table + kernel) {k_ms:.3f} ms, "
        f"bound {b_ms:.3f} ms (bytes / 3.35 TB/s); the task table alone {tasks_ms:.3f} ms; "
        f"wrapper (sort + offsets + table + kernel) {w_ms:.3f} ms, bound of the function "
        f"{fb_ms:.3f} ms; plain {p_ms:.3f} ms; index_add_ over the kept edges {lib_ms:.3f} ms; "
        f"at width 1 (count): kernel {k1_ms:.3f} ms, bound {b1_ms:.3f} ms (4 B a value; "
        f"{sector1_ms:.3f} ms at a 32-byte sector a value), the gather ones[order] alone "
        f"{gather1_ms:.3f} ms")
    # what the chunk teams' host-known bound costs: the kernel's own device
    # time with one empty segment, so that every chunk team is idle, with
    # E edges' worth of teams and with K edges' worth (profiled: events
    # around so short a launch time the host's launch path)
    empty = torch.zeros(2, dtype=torch.int64, device=device)
    n_tasks = int(segment_tasks(offsets)[-1])
    sym = KERNELS["segment_sum"][2]

    def idle_kernel_ms(v):
        ops = device_ops(lambda: [_launch_csr(v, None, empty, 1) for _ in range(10)], want=sym)
        us, calls = (sum(x) for x in zip(*(uc for name, uc in ops.items() if sym in name)))
        return us / calls / 1e3

    idle_ms = {}
    for width, v in ((D, msgs), (1, ones)):
        idle_ms[f"width {width}"] = dict(all_teams=idle_kernel_ms(v),
                                         k_edges_teams=idle_kernel_ms(v[:TASK_EDGES]))
    log(f"[gnn] segment_sum chunk teams: {2 * -(-E // TASK_EDGES)} launched (2 ceil(E / K)), "
        f"{n_tasks} with a task on this graph; the kernel with every chunk team idle (device "
        f"time; against the 2 teams of K edges): " + ", ".join(
            f"{t['all_teams']:.4f} ms ({t['k_edges_teams']:.4f}) at {k}"
            for k, t in idle_ms.items()))

    # the same bits on every launch (width 1: a random column, not the
    # ones, whose sums are exact in any order), and no host sync
    for what, v in ((f"width {D}", msgs), ("width 1", msgs[:, :1].contiguous())):
        if not torch.equal(_launch_csr(v, order, offsets, N), _launch_csr(v, order, offsets, N)):
            raise AssertionError(f"segment_sum at {what}: two launches differ")
    torch.cuda.set_sync_debug_mode("error")
    try:
        _launch_csr(msgs, order, offsets, N)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"[gnn] segment_sum: two launches bit-equal at width {D} and at width 1; the task "
        f"table and the launch make no host sync")
    hub = hub_only(device, D, g)

    # against float64, DIAG_COLS columns at a time; the self-check drops
    # each non-empty segment's last edge from the plain version
    nonempty = lengths > 0
    last = order[offsets[1:][nonempty] - 1]
    dst_drop = dst.clone()
    dst_drop[last] = -1
    caught = torch.zeros(N, dtype=torch.bool, device=device)
    errs = {}
    for c0 in range(0, D, DIAG_COLS):
        cols = slice(c0, min(D, c0 + DIAG_COLS))
        v64 = msgs[:, cols].double()
        expect = agg_expect(v64, dst, N)
        for kind, (err, used) in agg_errors(outs, expect, cols).items():
            e0, u0 = errs.get(kind, (0.0, 0.0))
            errs[kind] = (max(e0, err), max(u0, used))
        s, tol = expect["sum"]
        wrong = ref.segment_sum_ref(v64, dst_drop, N)
        caught |= ((wrong - s).abs() > tol).any(dim=1)
        del v64, expect, wrong, s, tol
    share = float(caught[nonempty].float().mean())
    log(f"[gnn] aggregate vs float64 plain: " + ", ".join(
        f"{k} max err {e:.3g} ({u:.4f} of its tolerance)" for k, (e, u) in errs.items())
        + f"; the plain version with each segment's last edge dropped exceeds the sum's "
        f"tolerance on {share:.6f} of {int(nonempty.sum())} non-empty segments")
    if share < CATCH_SHARE:
        raise AssertionError(f"the segment tolerance catches only {share} of dropped edges")
    log(f"[gnn] main path: aggregate({', '.join(AGG_KINDS)}) first call {first_ms:.1f} ms, "
        f"warm {warm_ms:.1f} ms, {launches['segment_sum']} segment_sum launches, peak memory "
        f"{peak_gb:.2f} GB")
    row = dict(name="segment_sum", route="cuda", source=KERNELS["segment_sum"][3],
               replaces=KERNELS["segment_sum"][1], launches=launches["segment_sum"],
               max_abs_err=errs["sum"][0], ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
               bound_by="bytes", library_ms=lib_ms, wrapper_ms=w_ms)
    info = dict(nodes=N, edges=E, width=D, kept=kept, max_segment=max_len,
                first_ms=first_ms, warm_ms=warm_ms, peak_memory_gb=peak_gb,
                launches=launches["segment_sum"], profile_ms=split,
                profile_launches=traced, kernel_ms=k_ms, task_table_ms=tasks_ms,
                kernel_bound_ms=b_ms, count_kernel_ms=k1_ms, count_bound_ms=b1_ms,
                count_sector_floor_ms=sector1_ms, count_gather_ms=gather1_ms,
                chunk_tasks=n_tasks, idle_chunk_teams_ms=idle_ms, hub_only=hub,
                wrapper_ms=w_ms, function_bound_ms=fb_ms, plain_ms=p_ms, index_add_ms=lib_ms,
                errors={k: dict(max_abs_err=e, share_of_tol=u) for k, (e, u) in errs.items()},
                drop_edge_share=share)
    del msgs, outs, dst, dst_drop, order, offsets, ones
    torch.cuda.empty_cache()
    return row, info


def hub_only(device, D, g):
    """One segment of HUB_EDGES edges, its rows read in order and in a
    random order (as a power-law hub's are on the path), at width D and at
    width 1: the kernel alone against its bound, the result against
    float64."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_reduce import _launch_csr

    ids = torch.zeros(HUB_EDGES, dtype=torch.int32, device=device)
    offsets = torch.tensor([0, HUB_EDGES], dtype=torch.int64, device=device)
    orders = (("in order", torch.arange(HUB_EDGES, device=device)),
              ("random order", torch.randperm(HUB_EDGES, generator=g, device=device)))
    out = {}
    for width in (D, 1):
        v = torch.randn((HUB_EDGES, width), generator=g, device=device)
        v64 = v.double()
        want, tol = ref.segment_sum_ref(v64, ids, 1), seg_tol(v64.abs().sum(0))
        bound = seg_bound_ms(HUB_EDGES, 1, width)
        for how, order in orders:
            diff = (_launch_csr(v, order, offsets, 1).double() - want).abs()
            if not bool((diff <= tol).all()):
                raise AssertionError(f"hub-only segment_sum {how} at width {width}: max err "
                                     f"{float(diff.max())}")
            ms = median_ms(lambda: _launch_csr(v, order, offsets, 1), reps=10)
            out[f"{how}, width {width}"] = dict(ms=ms, bound_ms=bound,
                                               max_abs_err=float(diff.max()))
            log(f"[gnn] hub only, one segment of {HUB_EDGES} edges {how} at width {width}: "
                f"kernel {ms:.4f} ms, bound {bound:.4f} ms; max err {float(diff.max()):.3g}")
        del v, v64, want
    return out


# ---------------------------------------------------------------------------
# Phase 7: bag lookups over DIN's full item table
# ---------------------------------------------------------------------------


def bag_bounds_ms(idx: torch.Tensor, weighted: bool, D: int) -> dict:
    """Times at the HBM rate of a bag lookup of (B, L) ids over a float32
    (V, D) table: the ids (and weights) read once, the output written once,
    and the rows: each distinct row once (`bound_ms`, the least time), each
    lookup's row (`gathered_bound_ms`), or each lookup's 32-byte sectors
    (`sector_hbm_ms`; a 72-byte row spans three wherever it starts, the
    table's base aligned to 256 bytes): an estimate, not a bound, since L2
    serves the sectors of rows read again."""
    B, L = idx.shape
    ids = idx[idx >= 0].long()
    io = 4 * B * L * (2 if weighted else 1) + 4 * B * D
    start = ids * (4 * D)
    sectors = int(((start + 4 * D - 1) // 32 - start // 32 + 1).sum())
    distinct = torch.unique(ids).numel()
    rate = HBM_BYTES_PER_S / 1e3
    return dict(lookups=ids.numel(), distinct_rows=distinct, sectors=sectors,
                bound_ms=(io + 4 * D * distinct) / rate,
                gathered_bound_ms=(io + 4 * D * ids.numel()) / rate,
                sector_hbm_ms=(io + 32 * sectors) / rate)


def din_lookups(device):
    """Phase 7: `ops.embedding_bag` over DIN's item table (configs/din.py:
    1,048,576 x 18 float32, std 0.01 as din.param_specs draws it) with
    `din_batch` histories (L = 100, ragged -1 tails) at serve_bulk and
    serve_p99, sum and mean, unweighted and weighted: one launch a call
    (the main path), the result against float64 with the tolerance's
    self-check (each bag's last valid item dropped), a second call
    bit-equal to the first, and kernel, plain and F.embedding_bag times on
    the profile's device clock (`launch_ms`) beside CUDA events
    (`median_ms`, which at a few microseconds time the host's launch path
    too), beside the bound (each distinct row once), each lookup's row,
    and the estimate of each lookup's 32-byte sectors from HBM."""
    import torch.nn.functional as F

    from repro_torch.data.recsys import din_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.kernels.embedding_bag import embedding_bag

    V, D = DIN_TABLE
    g = torch.Generator(device=device).manual_seed(1)
    table = torch.randn((V, D), generator=g, device=device).mul_(0.01)
    lib_table = torch.cat([table, table.new_zeros((1, D))])  # row V: padding
    symbol = KERNELS["embedding_bag"][2]
    results, launches = [], 0
    for step, (shape, B) in enumerate(DIN_BATCHES.items()):
        idx = torch.from_numpy(din_batch(step, B)["hist_items"]).to(device)
        ok = idx >= 0
        lib_idx = torch.where(ok, idx, V)
        last = torch.where(ok, torch.arange(idx.shape[1], device=device), -1).argmax(1)
        idx_drop = idx.clone()
        idx_drop[torch.arange(B, device=device), last] = -1
        nonempty = ok.any(1)
        w_all = torch.rand(idx.shape, generator=g, device=device)
        for combine in ("sum", "mean"):
            for weighted in (False, True):
                w = w_all if weighted else None
                LAUNCHES.clear()  # the main path: one call, counts from 0
                out = ops.embedding_bag(table, idx, w, combine)
                torch.cuda.synchronize()
                counted = dict(LAUNCHES)
                if counted != {"embedding_bag": 1}:
                    raise AssertionError(f"{shape} {combine}: launches {counted}")
                launches += 1
                again = ops.embedding_bag(table, idx, w, combine)
                if not torch.equal(out.view(torch.int32), again.view(torch.int32)):
                    raise AssertionError(f"{shape} {combine}: two calls differ in "
                                         f"{int((out != again).sum())} elements")
                del again
                err, used, plain, tol = bag_check(out, table, idx, w, combine)
                wrong = ref.embedding_bag_ref(table.double(), idx_drop,
                                              None if w is None else w.double(), combine)
                share = float(((wrong - plain).abs() > tol).any(1)[nonempty].float().mean())
                if share < CATCH_SHARE:
                    raise AssertionError(f"{shape} {combine}: the bag tolerance catches only "
                                         f"{share} of dropped items")
                del wrong, plain, tol
                reps = 30 if B < 10_000 else 10
                kernel = lambda: embedding_bag(table, idx, w, combine)
                plain_fn = lambda: ref.embedding_bag_ref(table, idx, w, combine)
                k_ms, k_ev = launch_ms([kernel], symbol, reps)[0], median_ms(kernel, reps)
                p_ms, p_ev = launch_ms([plain_fn], None, reps)[0], median_ms(plain_fn, reps)
                lib_ms = lib_ev = lib_err = None
                if not (weighted and combine == "mean"):  # no library call computes it
                    lib = lambda: F.embedding_bag(lib_idx, lib_table, mode=combine,
                                                  padding_idx=V, per_sample_weights=w)
                    lib_err, _, _, _ = bag_check(lib(), table, idx, w, combine)
                    lib_ms, lib_ev = launch_ms([lib], None, reps)[0], median_ms(lib, reps)
                bd = bag_bounds_ms(idx, weighted, D)
                lib_txt = (f"{lib_ms:.5f} ms (events {lib_ev:.4f}; its max err {lib_err:.3g})"
                           if lib_ms is not None else "n/a (no weighted mean)")
                log(f"[din] {shape} ({B} x {idx.shape[1]}, {bd['lookups']} lookups, "
                    f"{bd['distinct_rows']} distinct rows, {bd['sectors']} sectors) "
                    f"{combine}{' weighted' if weighted else ''}"
                    f": 1 launch, a second call bit-equal, max err {err:.3g} ({used:.4f} of the "
                    f"tolerance), dropping each bag's last item exceeds it on {share:.6f} of "
                    f"bags; device time (profile): kernel {k_ms:.5f} ms, plain {p_ms:.4f} ms, "
                    f"F.embedding_bag {lib_txt}; CUDA events: kernel {k_ev:.4f} ms, plain "
                    f"{p_ev:.4f} ms; bound {bd['bound_ms']:.5f} ms (distinct rows; "
                    f"{bd['gathered_bound_ms']:.4f} ms if each lookup read its row, "
                    f"{bd['sector_hbm_ms']:.4f} ms all its sectors from HBM, an estimate)")
                results.append(dict(shape=shape, batch=B, combine=combine, weighted=weighted,
                                    launches=1, bit_equal=True, max_abs_err=err,
                                    share_of_tol=used, drop_item_share=share, ms=k_ms,
                                    plain_ms=p_ms, library_ms=lib_ms, events_ms=k_ev,
                                    plain_events_ms=p_ev, library_events_ms=lib_ev,
                                    library_max_abs_err=lib_err, **bd))
    main = results[0]
    row = dict(name="embedding_bag", route="cuda", source=KERNELS["embedding_bag"][3],
               replaces=KERNELS["embedding_bag"][1], launches=launches,
               max_abs_err=max(r["max_abs_err"] for r in results), ms=main["ms"],
               plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by="bytes",
               library_ms=main["library_ms"],
               input=f"serve_bulk sum, unweighted ({main['batch']} din_batch bags of 100 over "
                     f"the {V} x {D} float32 table)",
               clock="device time from torch.profiler")
    return row, results


def gnn_din_card_vs_cpu(device):
    """`aggregate` and `ops.embedding_bag` on the card (the kernels) against
    the CPU (the plain versions) at sizes the CPU runs in seconds. Each side
    is within the float64 tolerance of the exact result, so they are held
    within twice it."""
    from repro_torch.data.recsys import din_batch
    from repro_torch.kernels import ops
    from repro_torch.models.gnn.message_passing import aggregate

    N, E, D = CPU_GNN_SHAPE
    rng = np.random.default_rng(5)
    dst = (rng.random(E) ** 2 * N).astype(np.int64)
    dst[rng.random(E) < PAD_SHARE] = -1
    dst = torch.from_numpy(dst.astype(np.int32))
    msgs = torch.from_numpy(rng.standard_normal((E, D)).astype(np.float32))
    card = [o.cpu() for o in aggregate(msgs.to(device), dst.to(device), N, kinds=AGG_KINDS)]
    cpu = aggregate(msgs, dst, N, kinds=AGG_KINDS, use_kernel=False)
    expect = agg_expect(msgs.double(), dst, N, scale=2.0)
    for kind, c in zip(AGG_KINDS, cpu):  # hold the card to the CPU's result
        expect[kind] = (c.double(), expect[kind][1])
    errs = agg_errors(card, expect)
    V, Dt = DIN_TABLE
    table = torch.from_numpy((0.01 * rng.standard_normal((V, Dt))).astype(np.float32))
    idx = torch.from_numpy(din_batch(9, CPU_DIN_BATCH)["hist_items"])
    w = torch.from_numpy(rng.random(idx.shape).astype(np.float32))
    bag = {}
    for combine in ("sum", "mean"):
        on_card = ops.embedding_bag(table.to(device), idx.to(device), w.to(device), combine).cpu()
        on_cpu = ops.embedding_bag(table, idx, w, combine)
        _, _, _, tol = bag_check(on_cpu, table, idx, w, combine, scale=2.0)
        diff = (on_card.double() - on_cpu.double()).abs()
        if not bool((diff <= tol).all()):
            raise AssertionError(f"embedding_bag {combine}: card vs CPU {float(diff.max())}")
        bag[combine] = float(diff.max())
    # float16: the plain version computes on the CPU, the card has no
    # float16 kernel and raises
    h16, i16, t16, b16 = msgs[:64].half(), dst[:64], table[:64].half(), idx[:4].clamp(max=63)
    ops.segment_sum(h16, i16, N), ops.embedding_bag(t16, b16)
    for what, fn in (("segment_sum", lambda: ops.segment_sum(h16.to(device), i16.to(device), N)),
                     ("embedding_bag", lambda: ops.embedding_bag(t16.to(device), b16.to(device)))):
        try:
            fn()
        except TypeError:
            continue
        raise AssertionError(f"{what} took float16 CUDA tensors")
    log(f"[cpu] aggregate on {N} nodes, {E} synthetic edges, width {D}, card (kernel) vs "
        f"CPU (plain), within twice the float64 tolerances: " + ", ".join(
            f"{k} {e:.3g}" for k, (e, _) in errs.items())
        + f"; embedding_bag over DIN's table, {CPU_DIN_BATCH} weighted bags: sum "
        f"{bag['sum']:.3g}, mean {bag['mean']:.3g}; float16 computes on the CPU and "
        f"raises TypeError on the card")
    return dict(aggregate={k: e for k, (e, _) in errs.items()}, embedding_bag=bag)


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

    t_start = t = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t:.2f} s")

    def phase_done(name):
        log(f"[time] {name} done at {time.perf_counter() - t_start:.1f} s")

    kernels = dict.fromkeys(KERNELS)  # the kernel line's order
    frontier = check_kernels(device)
    kernels["flash_attention"], flash_shapes, flash_leak = check_flash(device)
    seg_err = check_segment_grid(device)
    bag_err = check_bag_grid(device)
    phase_done("kernel checks")
    launches, cells, profiles, path, ctx = main_path(device)
    for k, v in launches.items():
        # the kernel line: the synthetic hop (MAIN_SHAPES), on the profile's
        # clock; the path's replayed launches are on the frontier line
        kernels[k] = dict(name=k, route="cuda", source=KERNELS[k][3], replaces=KERNELS[k][1],
                          launches=v,
                          max_abs_err=max(frontier[k]["max_abs_err"],
                                          path[k]["replayed"]["max_abs_err"]),
                          ms=frontier[k]["synthetic_ms"], plain_ms=frontier[k]["synthetic_plain_ms"],
                          bound_ms=frontier[k]["synthetic_bound_ms"], bound_by="bytes",
                          library_ms=None, input="synthetic hop (MAIN_SHAPES)",
                          clock="device time from torch.profiler")
        frontier[k].update(path[k])
        rounds = sum(c["rounds"] for c in cells if KERNELS_BY_LAYOUT[c["layout"]] == k)
        log(f"[kernel] {k}: {v} launches on the main path, {v / rounds:.1f} per "
            f"engine round of 4 processors")
    phase_done("graph serving")
    routing = dict(embedding=ctx["training"], graph_updates=graph_updates(ctx, device))
    phase_done("graph updates")
    routing["query_types"] = query_types(ctx, device)
    phase_done("reachability and random walk")
    routing["distributed"] = distributed_serving(ctx, device)
    del ctx
    phase_done("distributed serving")
    routing["card_vs_cpu"] = oversubscribed(device)
    phase_done("oversubscribed card vs CPU")
    lm, kernels["flash_attention"]["launches"] = lm_serving(device)
    phase_done("Qwen3-4B serving")
    lm["card_vs_cpu"] = lm_card_vs_cpu(device)
    phase_done("Qwen3-4B card vs CPU")
    from repro_torch.configs import dbrx_132b, qwen2_moe_a2_7b

    moe = {}
    moe["qwen2-moe-a2.7b"], n_qwen_moe = moe_serving(device, qwen2_moe_a2_7b.model_cfg())
    phase_done("qwen2-moe-a2.7b serving")
    dbrx = dbrx_132b.model_cfg()
    moe["dbrx-132b"], n_dbrx = moe_serving(
        device, dataclasses.replace(dbrx, n_layers=MOE_DBRX_LAYERS), full_depth=dbrx.n_layers)
    phase_done(f"dbrx-132b ({MOE_DBRX_LAYERS} of {dbrx.n_layers} layers) serving")
    moe["qwen2-moe-a2.7b"]["teacher_forced_f32"] = moe_teacher_forced_f32(
        device, qwen2_moe_a2_7b.model_cfg(), None)
    moe["dbrx-132b"]["teacher_forced_f32"] = moe_teacher_forced_f32(
        device, dataclasses.replace(dbrx, n_layers=MOE_DBRX_LAYERS), dbrx.n_layers)
    phase_done("MoE teacher-forced in float32")
    moe["card_vs_cpu"] = moe_card_vs_cpu(device)
    phase_done("qwen2-moe-a2.7b card vs CPU")
    # the kernel line counts flash on every LM path: Qwen3-4B's, then the MoE LMs'
    kernels["flash_attention"]["launches"] += n_qwen_moe + n_dbrx
    kernels["segment_sum"], gnn = gnn_aggregation(device)
    kernels["segment_sum"]["max_abs_err"] = max(kernels["segment_sum"]["max_abs_err"], seg_err)
    phase_done("GNN aggregation")
    kernels["embedding_bag"], din = din_lookups(device)
    kernels["embedding_bag"]["max_abs_err"] = max(kernels["embedding_bag"]["max_abs_err"],
                                                  bag_err)
    phase_done("DIN bag lookups")
    cpu = gnn_din_card_vs_cpu(device)
    phase_done("GNN and DIN card vs CPU")

    log(json.dumps({"cells": cells, "profiles": profiles, "frontier": frontier}))
    log(json.dumps({"routing": routing}))
    log(json.dumps({"flash_shapes": flash_shapes, "flash_leak": flash_leak, "lm": lm}))
    log(json.dumps({"gnn": gnn, "din": din, "card_vs_cpu": cpu}))
    log(json.dumps({"moe": moe}))
    log(smi)
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
