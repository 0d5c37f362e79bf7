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

  9. trains: the flash backward kernel against the plain version's
     autograd over a grid of shapes (Qwen3-4B's training attention, GQA
     groups 1 and 6, gemma2's window and softcap, ragged lengths, fully
     masked rows, D 16 to 128, both dtypes; every branch read back from a
     profile, a repeat bit-equal), timed beside SDPA's backward and its
     bound; Qwen3-4B at full width and depth through `Trainer` (4
     microbatches of 4,096 tokens a step, remat), its flash launches a
     step counted, its steps timed and one profiled by kind; a 1-layer
     cut checkpointed into a temporary directory, a failure injected
     mid-run, the restart bit-equal to a run without failure; two train
     steps of a 2-layer float32 cut on the card and on the CPU held
     together;
 10. trains the GNN and recsys zoo at full width through `Trainer`
     (float32, TF32 off, ZOO_STEPS steps a run, each timed on the card
     and, with its batch build and copy, on the host; one more profiled
     by kind): PNA, EGNN and GraphCast at full_graph_sm (Cora's
     shape) and minibatch_lg (a fresh `NeighborSampler` draw of 1,024
     seeds a step over Reddit's 232,965 nodes and ~114.6 M edges),
     EquiformerV2 at full_graph_sm, EGNN and EquiformerV2 at molecule (128
     graphs), DIN at train_batch (65,536), then DIN's `score` at serve_p99
     and serve_bulk and `retrieval_scores` against 1,000,000 candidates;
     every loss finite, no step skipped, no hand-written kernel launched
     (the zoo runs the plain segment ops, as the reference); then two
     steps of each arch's smoke config on the card and on the CPU held
     together;
 11. serves the paper's own system at the grouting configuration
     (`configs/grouting.py`): a 4,194,304-node power-law graph padded to
     32-wide rows, its landmark index and embedding built on the card, the
     three shapes (serve_hot_3hop, serve_1hop, serve_bulk) through the
     distributed serving step at a world of one over NCCL with the 2-hop
     hotspot stream in oversubscribed bursts, then the drain; every burst
     equal across {cuda, scatter} x {dense, packed}, every query that
     `hhop_ball` shows untruncated counting |N_h(q)| - 1, every query
     counting what a numpy search under the step's caps marks, one burst
     of each cuda run profiled; then the serving launcher
     (`launch/serve.py --scheme landmark`), its landmark index on the card
     bit-equal to the CPU's, its row derived from the cost model; last it
     writes the rows hash-placed over two storage shards, the router's
     embedding and the stream for phase 13's ranks;
 12. plans and runs the examples: the reference's three examples at its
     defaults on the card (the quickstart's rows, labelled cost-model
     where they are; DIN trained 80 steps, then served with synced walls;
     GraphCast's weather mode, its MSE falling); the roofline of the steps
     phases 4, 9 and 10 timed (Qwen3-4B's prefill and training step,
     GraphCast at minibatch_lg), counted on meta tensors at the same
     shapes, with the bound, the bottleneck and the measured model-flops
     share; `launch/dryrun.py` for one cell of each family at the 16x16
     mesh, each in a subprocess; and `--list`'s cells and skips.
 13. runs the sharded paths as four gloo ranks on the one card
     (`sharded_paths`; NCCL refuses two ranks on one device): gloo's
     collectives on CUDA tensors checked, float32 and bf16; the LM step on
     a (data, model) (2, 2) mesh under LM_TRAIN_RULES (Qwen3-4B at full
     width cut to 2 of 36 layers, one sequence of 4,096 tokens a data
     rank): in float32 one training step's m and v, loss and grad norm,
     and the prefill's logits against the world of one's, a TF32 control
     above the tolerance, the flash forward and backward on each route
     (wrapper counts and profiles); in bf16 a timed step, its peak memory
     beside the dry run's reckoning of the same local step; the decode
     step on the same mesh under LM_DECODE_RULES (the cache's 32,768
     positions over "model", kv heads whole; batch 4): the world of one's
     float32 prefill of 16,382 tokens fills the cache (its flash launches
     counted), each rank takes its block, and 4 steps, which model ranks
     0 and 1 write two each, hold each rank's logits and cache block
     against the world of one's `serve_step`, a TF32 control above the
     tolerance; then 4 timed bf16 steps, their peak memory beside the dry
     run's reckoning of the same local step; the expert-parallel MoE layer at
     qwen2-moe-a2.7b's full width at meshes (1, 4) and (2, 2), 4,096 and 16
     tokens a data shard (the FSDP and weight-stationary regimes),
     drop-free and at factor 1.25, output and every gradient against the
     single-device path; the expert-parallel prefill of qwen2-moe cut to 2
     of 24 layers, 1 x 4,096 tokens, against the world of one's (its flash
     launches counted and profiled on every rank); PNA's forward over the
     ogb_products graph cut by PRODUCTS_CUT against the world of one's
     loss, its unserved gathers counted; the four GNN archs at full width
     on 1,000-node graphs in float32, loss and gradients against the
     unsharded loss, with TF32 matmuls as a control that must fall outside;
     `compressed_psum` at Qwen3-4B's shapes against the CPU; before the
     ranks, a world of one over NCCL runs the expert-parallel layer and the
     PNA loss (NCCL's branch of each collective). DIN at full width on the
     (2, 2) mesh under DIN_RULES (the tables' rows over "model", read
     through their owners): in float32 score at serve_p99 and serve_bulk
     (cut to 65,536 rows), retrieval of 1,000,000 candidates (split over
     both axes: exchanged by owner) and one train step at train_batch
     (65,536 rows), under set_sync_debug_mode("error") but inside gloo's
     collectives, against the world of one's, a TF32 control above the
     tolerances, the step's peak memory beside the dry run's reckoning.
     Last, the paper's cluster across ranks: the grouting configuration's
     three shapes served from phase 11's graph by the four ranks, a
     processor each, over two storage shards, every served query held to
     the capped search and the world of one's count, the layouts and
     backends equal on every rank, every processor serving, each rank's
     frontier launches counted.

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
import hashlib
import inspect
import io
import json
import os
import subprocess
import sys
import time
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

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
    # the gradient of row 5's function: the reference takes it by jax.grad
    "flash_attention_bwd": ("attention_grads_ref", "src/repro/kernels/flash_attention.py:99",
                            "flash_bwd_", CSRC + "flash_attention_bwd.cu"),
}
KERNELS_BY_LAYOUT = {"dense": "frontier_expand_batched",
                     "packed": "frontier_expand_packed"}
TIMING_FIELDS = ("wall_s", "throughput_qps")
# spin kernels ahead of a profiled call (see device_ops); late in a long run
# a trace has lost its first ~70 events, more than 64 pads
PROFILE_PAD = 512
# profiles of one call while the trace lacks a kernel sought or kept no
# pad kernel (the profiler has dropped a short call's events three times in
# a row, and once the pads and every launch of a backward but its last)
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

# LM training (phase 9). The flash backward kernel against its plain
# version: (name, B, Hq, Hkv, Sq, Skv, D, causal, window, softcap, dtype);
# the first is Qwen3-4B's training attention (one microbatch of 4,096
# tokens), whose times go into the kernel line. Together the shapes take
# every branch of csrc/flash_attention_bwd.cu, each read back from a
# profile: float32 <float, kD>, bf16 _tc<kD, kVec> (kVec: D % 8 == 0, so
# cp.async; else element loads); "masked rows": rows past Skv + window - 1
# see no key.
BWD_SHAPES = [
    ("qwen3-4b training", 1, 32, 8, 4096, 4096, 128, True, None, None, BF16),
    ("GQA group 1 (qwen2-moe)", 1, 16, 16, 2048, 2048, 128, True, None, None, BF16),
    ("GQA group 6 (dbrx)", 1, 48, 8, 2048, 2048, 128, True, None, None, BF16),
    ("gemma2 window 512, softcap 50", 1, 8, 4, 2048, 2048, 128, True, 512, 50.0, BF16),
    ("gemma2 window 512, softcap 50", 1, 4, 2, 2048, 2048, 128, True, 512, 50.0, F32),
    ("ragged 1000", 1, 4, 2, 1000, 1000, 64, True, None, None, F32),
    ("ragged 1000", 1, 4, 2, 1000, 1000, 64, True, None, None, BF16),
    ("Sq 1000 > Skv 300, masked rows", 1, 4, 2, 1000, 300, 32, True, 128, None, F32),
    ("Sq 1000 > Skv 300, masked rows", 1, 4, 2, 1000, 300, 32, True, 128, None, BF16),
    ("bidirectional Sq < Skv, softcap", 2, 4, 2, 300, 1000, 16, False, None, 30.0, F32),
    ("bidirectional window, masked rows", 1, 6, 3, 700, 200, 16, False, 64, None, BF16),
    ("D 80", 1, 4, 2, 500, 500, 80, True, None, None, BF16),
    ("D 77, window, softcap", 1, 4, 2, 333, 333, 77, True, 50, 30.0, F32),
    ("D 77, window, softcap", 1, 4, 2, 333, 333, 77, True, 50, 30.0, BF16),
    ("D 50, Sq 260 > Skv 190, GQA group 3", 1, 6, 2, 260, 190, 50, True, None, None, BF16),
    ("D 20, bidirectional, softcap", 2, 2, 1, 150, 170, 20, False, None, 20.0, BF16),
    ("D 12, masked rows", 1, 2, 2, 300, 100, 12, True, 40, None, BF16),
]
BWD_PASSES = ("flash_bwd_stats_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")
# max |kernel - plain| over max |plain| of dq, dk, dv: the bf16 outputs round
# by at most 2^-8 of their own size; float32 sums in another order
BWD_TOL = {BF16: 2.0 ** -7, F32: 1e-5}
# Qwen3-4B trained at full width: TRAIN_LAYERS of its 36 layers, its
# grad_accum (4) microbatches of TRAIN_MICRO x TRAIN_SEQ tokens a step
# (16,384 tokens; configs/base.py train_4k's 256 x 4,096 needs many cards)
TRAIN_LAYERS, TRAIN_MICRO, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 36, 1, 4096, 5, 2
TRAIN_KINDS = ("GEMMs", "flash forward", "flash backward", "optimizer",
               "elementwise and the rest")
# the restart: 1 layer at full width (8.8 GB a checkpoint, three saves: the
# script keeps its disk writes under 30 GB), checkpoints every 2 steps, a
# failure at the start of step 3 (restored from step 2), 4 steps
TRAIN_RESTART = dict(layers=1, steps=4, ckpt_every=2, fail_at=3)
# training card vs CPU: 2 layers at full width, float32, 2 x 256 tokens;
# relative errors of the loss and grad norm, and of m and v per leaf
TRAIN_CPU_LAYERS, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, TRAIN_CPU_TOL = 2, 2, 256, 1e-3

# the GNN and recsys zoo trained at full width (phase 10): ZOO_STEPS AdamW
# steps a run through `Trainer` (warmup ZOO_WARMUP), float32, TF32 off
ZOO_STEPS, ZOO_WARMUP = 4, 1
# minibatch_lg's host graph: Reddit's 232,965 nodes; erdos_renyi_graph at
# this average degree gives ~114.6 M edges bidirected (GNN_SHAPES' count)
ZOO_LG_AVG_DEGREE = 492
ZOO_KINDS = (("optimizer", ("adamw_update",)),
             ("GEMMs", ("aten::mm", "aten::addmm", "aten::bmm")),
             ("scatters (segment sums, max, gathers' backward)",
              ("aten::index_add_", "aten::scatter_reduce_", "aten::scatter_add_",
               "aten::index_put_", "aten::_index_put_impl_")),
             ("gathers", ("aten::index", "aten::gather", "aten::index_select")))
ZOO_DIN_CALLS = 10  # timed score / retrieval calls a shape
# card vs CPU: two steps at each arch's smoke config; the loss and grad norm
# relative, m and v of each leaf's max; parameters as the CPU tests hold them
# (tests/test_torch_gnn_models.py): within ZOO_STEP_TOL of the leaf's largest
# |entry| plus ZOO_LR_SHARE_TOL of the summed learning rates (an Adam step
# moves an entry by about lr whatever its gradient's size)
ZOO_CPU_TOL, ZOO_STEP_TOL, ZOO_LR_SHARE_TOL = 1e-3, 1e-4, 1e-2

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
    the trace lost some of them, and a trace that kept none of them may
    have lost `fn()`'s first events too, so `fn()` is profiled again. Inside
    a long run it has also lost every event of a profile, and every event
    up to the last kernel of a call, so when `want` is given (a name, or a
    tuple of names that must all show) and an op name holding one of them is
    missing, `fn()` is profiled again; up to PROFILE_TRIES times in all."""
    wants = () if want is None else (want,) if isinstance(want, str) else tuple(want)
    for tries in range(1, PROFILE_TRIES + 1):
        by_name, events = {}, _device_events(fn)
        for name, _, us in events:
            t, calls = by_name.get(name, (0.0, 0))
            by_name[name] = (t + us, calls + 1)
        missing = [w for w in wants if not any(w in name for name in by_name)]
        if not missing and events.pads:
            break
        log(f"[profile] try {tries} of {PROFILE_TRIES}: the trace holds no "
            + (", ".join(missing) if missing else "pad kernel"))
    return by_name


class _Events(list):
    """A trace's device events, and how many leading pad kernels it kept."""
    pads = 0


def _device_events(fn):
    """[(name, start us, duration us)] of the device ops of one `fn()`, in
    the order they ran, the leading pad kernels left out (their number kept
    in `.pads`); starts count from the trace's first device op. Read from
    Kineto's own list: `prof.events()` builds an event tree in Python,
    seconds for a call of ~10^4 device ops; the list holds the same ops
    and durations at a small part of that cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()  # nothing queued before the trace starts
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    device = [k for k in prof.profiler.kineto_results.events()
              if k.device_type() == DeviceType.CUDA]
    t0 = min((k.start_ns() for k in device), default=0)  # epoch ns, past float64's ns
    events, pads = [], 0
    for k in device:
        if "spin_kernel" in k.name():
            pads += 1
            continue
        events.append((k.name(), (k.start_ns() - t0) / 1e3, k.duration_ns() / 1e3))
    if pads < PROFILE_PAD:
        log(f"[profile] the trace kept {pads} of {PROFILE_PAD} leading pad kernels")
    out = _Events(sorted(events, key=lambda e: e[1]))
    out.pads = pads
    return out


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
    from repro_torch.models.transformer import Transformer

    return Transformer(cfg, params=draw_params(cfg, device, full_depth), device=device)


def draw_params(cfg, device, full_depth=None, seed=0):
    """`draw_lm`'s parameters, as the port's tree (one tree a layer)."""
    from repro_torch.models.param import init_params, tree_map
    from repro_torch.models.transformer import lm_param_specs, unstack_layers

    specs = lm_param_specs(cfg)
    if full_depth is not None:
        scale = float(1.0 / np.sqrt(full_depth // cfg.group_size))
        specs = tree_map(lambda p: dataclasses.replace(p, scale=scale)
                         if p.axes[0] == "stack" and p.init == "normal" and p.scale is None
                         else p, specs)
    return unstack_layers(init_params(specs, torch.Generator(device=device).manual_seed(seed),
                                      device), cfg)


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
                                                "aten::masked_fill", "aten::masked_fill_")),
             ("dispatch scatter and gather", ("aten::index", "aten::index_put_")),
             ("other GEMMs", ("aten::mm", "aten::addmm")))


def attributed_events(fn, want):
    """The device ops of one `fn()` under torch.profiler as [(name, us,
    correlation id of the CPU op that launched it, start in integer ns)],
    and {correlation id: the names of that CPU op and of its callers,
    innermost first}. Profiled again, up to PROFILE_TRIES, while no device
    op's name holds `want`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
        # device events as Kineto gives them: name, us, the correlation id
        # of the CPU op that launched them
        kineto = [k for k in prof.profiler.kineto_results.events()
                  if k.device_type() == DeviceType.CUDA]
        device = [(k.name(), k.duration_ns() / 1e3, k.linked_correlation_id(), k.start_ns())
                  for k in kineto if "spin_kernel" not in k.name()]
        pads = len(kineto) - len(device)
        if any(want in n for n, *_ in device) and pads:
            break
        log(f"[profile] try {tries} of {PROFILE_TRIES}: the trace holds no "
            + ("pad kernel" if any(want in n for n, *_ in device) else want))
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
    return device, launcher


def profile_by_kind(tag, what, fn, kinds, rest="other", flash=None, wall_ms=None) -> dict:
    """`fn()` under torch.profiler, its device time by kind: the flash
    kernel by name when `flash` names it (it is launched through ctypes,
    outside any aten op), then `kinds` by the aten op (or profiler range)
    that launched each kernel (the CPU op of its Kineto event's linked
    correlation id) and that op's callers, the rest `rest`; kernels that
    no aten op launched go to `rest`, and their time is logged. Busy share:
    the union of the kernels' intervals over the profiled call's own wall
    (CUDA events around `fn()` inside the profile); the summed durations,
    and by how much they pass the union (intervals the trace overlaps), are
    logged beside it, and `wall_ms`, an unprofiled wall. Profiled again, up
    to PROFILE_TRIES, while the trace holds no `flash` kernel."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed():
        ev[0].record()
        fn()
        ev[1].record()

    device, launcher = attributed_events(timed, flash or "")
    profiled_ms = ev[0].elapsed_time(ev[1])
    split = dict.fromkeys((["flash_attention"] if flash else []) +
                          [k for k, _ in kinds] + [rest], 0.0)
    unclaimed = 0.0
    for name, us, corr, _ in device:
        chain = launcher.get(corr)
        if flash and flash in name:
            kind = "flash_attention"
        elif chain is None:
            kind, unclaimed = rest, unclaimed + us / 1e3
        else:
            kind = next((k for k, ops in kinds if set(chain).intersection(ops)), rest)
        split[kind] += us / 1e3
    total = sum(us for _, us, _, _ in device) / 1e3
    # the union of the [start, end) intervals, in integer ns: the starts
    # are epoch times, past float64's ns resolution
    busy_ns, end = 0, 0
    for start, stop in sorted((t, t + round(us * 1e3)) for _, us, _, t in device):
        busy_ns += max(0, stop - max(start, end))
        end = max(end, stop)
    busy = busy_ns / 1e6
    unprofiled = f"; an unprofiled wall {wall_ms:.2f} ms" if wall_ms else ""
    log(f"[{tag}] {what} profile: device time {total:.2f} ms over {len(device)} device ops "
        f"({total - busy:.3f} ms of it overlapped in the trace), busy {busy:.2f} ms, busy "
        f"share {busy / profiled_ms:.4f} of the profiled call's {profiled_ms:.2f} ms"
        f"{unprofiled}: " +
        ", ".join(f"{k} {v:.2f} ms ({v / max(total, 1e-9):.3f})" for k, v in split.items()) +
        f"; {unclaimed:.2f} ms of kernels no aten op claims (in {rest}); top device ops:")
    by_name = {}
    for name, us, _, _ in device:
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, c) in top:
        log(f"[{tag}]   {us / 1e3:10.3f} ms  {c:6d} calls  {name[:100]}")
    return dict(device_ms=total, device_ops=len(device), busy_ms=busy,
                profiled_ms=profiled_ms, busy_share=busy / profiled_ms, wall_ms=wall_ms,
                unclaimed_ms=unclaimed,
                **{f"{k}_ms": v for k, v in split.items()},
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
    prof = profile_by_kind("moe", f"{what} prefill", lambda: model.prefill_forward(tokens),
                           MOE_KINDS, flash=KERNELS["flash_attention"][2],
                           wall_ms=prefill2_s * 1e3)
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
# Phase 9: LM training. The flash backward kernel against its plain version,
# Qwen3-4B trained at full width through `Trainer`, a restart after an
# injected failure, and a 2-layer training card against CPU
# ---------------------------------------------------------------------------


def bwd_bound_ms(B, Hq, Hkv, Sq, Skv, D, causal, window, dtype):
    """Least time of one backward: 10 D flops per weighed pair (the
    recomputed Q K^T, dV, dP, dQ, dK) at the dtype's dense peak, against q,
    k, v, o, dO read and dq, dk, dv written once at the HBM rate."""
    flops = 10 * D * B * Hq * attn_pairs(Sq, Skv, causal, window)
    nbytes = dtype.itemsize * D * B * (4 * Hq * Sq + 4 * Hkv * Skv)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations", flops) if t_ops >= t_bytes else (t_bytes, "bytes", flops)


def bwd_branch(dtype, D) -> str:
    """The branch a launch of these (aligned) inputs instantiates, as the
    profile spells it after a pass's name: <float, kD> on the CUDA cores,
    _tc<kD, kVec> on the tensor cores."""
    kd = next(b for b in (16, 32, 64, 128) if D <= b)
    if dtype == F32:
        return f"<{BAG_TYPES[dtype]}, {kd}>"
    return f"_tc<{kd}, {'true' if D % 8 == 0 else 'false'}>"


def check_flash_bwd_grid(device):
    """The flash backward kernel against the plain version's autograd
    (`attention_grads_ref`) on float32 copies of its inputs, TF32 off, at
    every BWD_SHAPES entry: max |kernel - plain| within BWD_TOL of max
    |plain| for dq, dk and dv; a second launch bit-equal; each pass's
    <T, kD> read back from a profile, every branch covered. At the masked
    rows' shape, a kernel that drops those rows' dV must fail the tolerance.
    At the first shape (Qwen3-4B's training attention) the kernel's time by
    profile and by CUDA events, the plain version's and SDPA's backward
    beside the bound."""
    with no_tf32():
        return _check_flash_bwd_grid(device)


def _check_flash_bwd_grid(device):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.ref import attention_grads_ref

    g = torch.Generator(device=device).manual_seed(0)
    results, branches, drop_check = [], set(), None
    for name, B, Hq, Hkv, Sq, Skv, D, causal, window, cap, dtype in BWD_SHAPES:
        q, do = (torch.randn(B, Hq, Sq, D, generator=g, device=device).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(B, Hkv, Skv, D, generator=g, device=device).to(dtype)
                for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=cap)
        out = flash_attention(q, k, v, **kw)
        bwd = lambda: flash_attention_bwd(q, k, v, out, do, **kw)
        got, again = bwd(), bwd()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash backward at {name}: a second launch differs")
        want = attention_grads_ref(q.float(), k.float(), v.float(), do.float(), **kw)
        errs = [float((a.float() - w).abs().max()) for a, w in zip(got, want)]
        shares = [e / float(w.abs().max()) for e, w in zip(errs, want)]
        if not max(shares) <= BWD_TOL[dtype]:
            raise AssertionError(f"flash backward != plain at {name}: max error / max |grad| "
                                 f"{shares} (tol {BWD_TOL[dtype]})")
        first_masked = Skv + window - 1 if window is not None else None
        if drop_check is None and first_masked is not None and first_masked < Sq:
            kept = do.float().clone()
            kept[:, :, first_masked:] = 0  # the rows that see no key send no dV
            wrong = attention_grads_ref(q.float(), k.float(), v.float(), kept, **kw)[2]
            drop_check = dict(shape=name, rows=f"{first_masked}..{Sq - 1}",
                              share=float((wrong - want[2]).abs().max() / want[2].abs().max()))
            log(f"[flash-bwd] tolerance self-check at {name}: a kernel that drops the dV of "
                f"rows {drop_check['rows']} (which see no key) errs by "
                f"{drop_check['share']:.4g} of max |dv|")
            if not drop_check["share"] > BWD_TOL[dtype]:
                raise AssertionError("the backward tolerance passes a kernel that drops the "
                                     "fully masked rows' dV")
        branch = bwd_branch(dtype, D)
        passes = tuple(f"{part}{branch}" for part in BWD_PASSES)
        seen = device_ops(bwd, want=passes)
        for part in BWD_PASSES:
            if not any(f"{part}{branch}" in n for n in seen):
                raise AssertionError(f"{name}: the profile shows no {part}{branch}: {list(seen)}")
        branches.add(branch)
        row = dict(shape=name, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Skv=Skv, D=D, causal=causal,
                   window=window, softcap=cap, dtype=str(dtype).removeprefix("torch."),
                   branch=branch, max_abs_err=max(errs), err_share=dict(zip("qkv", shares)),
                   tol=BWD_TOL[dtype], bit_equal=True)
        msg = ""
        if not results:  # the training shape: times
            reps = 5
            prof = device_ops(lambda: [bwd() for _ in range(reps)], want=passes)
            parts = {p: sum(us for n, (us, _) in prof.items() if p in n) / reps / 1e3
                     for p in BWD_PASSES}
            row["ms"] = sum(parts.values())
            row["pass_ms"] = parts
            row["event_ms"] = median_ms(bwd, reps=reps)
            row["plain_ms"] = median_ms(lambda: attention_grads_ref(q, k, v, do, **kw), reps=3)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
            row["sdpa_bwd_ms"] = median_ms(lambda: torch.autograd.grad(
                sdpa_out, leaves, do, retain_graph=True), reps=reps)
            del sdpa_out, leaves
            row["bound_ms"], row["bound_by"], flops = bwd_bound_ms(
                B, Hq, Hkv, Sq, Skv, D, causal, window, dtype)
            row["tflops"] = flops / row["ms"] / 1e9
            msg = (f"; kernel {row['ms']:.3f} ms by profile (" +
                   ", ".join(f"{p.removeprefix('flash_bwd_')} {t:.3f}" for p, t in parts.items())
                   + f"; {row['event_ms']:.3f} ms by CUDA events; {row['tflops']:.2f} TFLOP/s "
                   f"of the 10 D flops a pair), plain {row['plain_ms']:.3f} ms, SDPA backward "
                   f"{row['sdpa_bwd_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                   f"({row['bound_by']})")
        results.append(row)
        log(f"[flash-bwd] {name:>28s} {row['dtype']:>8s} B{B} Hq{Hq} Hkv{Hkv} Sq{Sq} Skv{Skv} "
            f"D{D} {branch}: max error / max |grad| dq {shares[0]:.3g} dk {shares[1]:.3g} dv "
            f"{shares[2]:.3g} (tol {BWD_TOL[dtype]}), a repeat bit-equal{msg}")
        del q, k, v, do, out, got, again, want
        torch.cuda.empty_cache()
    every = {bwd_branch(t, d - odd) for t, odd in ((F32, 0), (BF16, 0), (BF16, 1))
             for d in (16, 32, 64, 128)}  # odd: D % 8 != 0, the bf16 element loads
    if branches != every:
        raise AssertionError(f"the grid ran branches {sorted(branches)}, not {sorted(every)}")
    main = results[0]
    row = dict(name="flash_attention_bwd", route="cuda", source=KERNELS["flash_attention_bwd"][3],
               replaces=KERNELS["flash_attention_bwd"][1], launches=0,
               max_abs_err=max(r["max_abs_err"] for r in results), ms=main["ms"],
               plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
               bound_by=main["bound_by"], library_ms=main["sdpa_bwd_ms"],
               input="Qwen3-4B training attention (BWD_SHAPES[0])",
               clock="device time from torch.profiler")
    return row, results, drop_check


@contextlib.contextmanager
def adamw_ranged():
    """While active, the train step's `adamw_update` runs inside a profiler
    range of that name, so a profile can tell the optimizer's kernels."""
    from repro_torch.train import train_step as TS

    update = TS.adamw_update

    def ranged(*a, **kw):
        with torch.profiler.record_function("adamw_update"):
            return update(*a, **kw)

    TS.adamw_update = ranged
    try:
        yield
    finally:
        TS.adamw_update = update


def profile_train(what, fn) -> dict:
    """`fn()` (one train step) under torch.profiler, its device time by
    kind: flash forward and backward by kernel name, the optimizer by the
    "adamw_update" range that launched its kernels, GEMMs by kernel name,
    the rest (norms, rope, casts, the loss head's softmax) elementwise."""
    with adamw_ranged():
        device, launcher = attributed_events(fn, KERNELS["flash_attention_bwd"][2])
    split = dict.fromkeys(TRAIN_KINDS, 0.0)
    for name, us, corr, _ in device:
        low = name.lower()
        if KERNELS["flash_attention"][2] in name:
            kind = "flash forward"
        elif KERNELS["flash_attention_bwd"][2] in name:
            kind = "flash backward"
        elif "adamw_update" in launcher.get(corr, ()):
            kind = "optimizer"
        elif any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass")):
            kind = "GEMMs"
        else:
            kind = "elementwise and the rest"
        split[kind] += us / 1e3
    total = sum(split.values())
    log(f"[train] {what}: device time {total:.1f} ms over {len(device)} device ops: " +
        ", ".join(f"{k} {v:.1f} ms ({v / total:.3f})" for k, v in split.items()))
    return dict(device_ms=total, device_ops=len(device), **{f"{k}_ms": v for k, v in split.items()})


def _trainer(cfg, device, steps, ckpt_dir, ckpt_every, full_depth=None):
    """A `Trainer` of the LM loss on `cfg`, its grad_accum microbatches of
    TRAIN_MICRO x TRAIN_SEQ tokens of `token_batch`, warmup TRAIN_WARMUP,
    logging every step, random weights drawn on the card from seed 0."""
    from repro_torch.data.tokens import token_batch
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import Trainer, TrainerConfig

    batch = TRAIN_MICRO * cfg.grad_accum
    return Trainer(lambda p, b: T.loss_fn(p, b, cfg),
                   lambda: draw_params(cfg, device, full_depth),
                   lambda step: token_batch(step, batch, TRAIN_SEQ, cfg.vocab),
                   TrainerConfig(total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
                                 log_every=1, warmup=TRAIN_WARMUP, grad_accum=cfg.grad_accum),
                   device=device)


def lm_train(device):
    """Phase 9's main path: Qwen3-4B at full width (TRAIN_LAYERS of its
    layers) trained for TRAIN_STEPS steps through `Trainer`. No checkpoint:
    one of the whole state (params, m, v) is 44 GB, more than the script
    writes to disk in all; `lm_train_restart` checkpoints a cut. Launch
    counts from 0 around the run: each step must launch the
    flash forward twice a layer a microbatch (remat recomputes it) and the
    backward once. Each step timed by CUDA events; the loss of every step
    finite and no step skipped; the peak memory. Then one more step
    profiled by kind."""
    from repro_torch.configs import qwen3_4b
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.models.param import param_bytes, param_count
    from repro_torch.models.transformer import lm_param_specs

    full = qwen3_4b.model_cfg()
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    tokens_per_step = TRAIN_MICRO * cfg.grad_accum * TRAIN_SEQ
    specs = lm_param_specs(cfg)
    trainer = _trainer(cfg, device, TRAIN_STEPS, None, TRAIN_STEPS,
                       full.n_layers if TRAIN_LAYERS < full.n_layers else None)
    inner, step_ms, step_launches = trainer.step_fn, [], []

    def timed(state, batch):
        before = dict(LAUNCHES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        step_launches.append({k: v - before.get(k, 0) for k, v in LAUNCHES.items()})
        return out

    trainer.step_fn = timed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t = time.perf_counter()
    state = trainer.run()
    run_s = time.perf_counter() - t
    launches = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    history = trainer.history
    losses = [h["loss"] for h in history]
    per_step = dict(flash_attention=cfg.n_layers * cfg.grad_accum * (2 if cfg.remat else 1),
                    flash_attention_bwd=cfg.n_layers * cfg.grad_accum)
    for i, sl in enumerate(step_launches):
        if sl != per_step:
            raise AssertionError(f"step {i} launched {sl}, expected {per_step}")
    if launches != {k: v * TRAIN_STEPS for k, v in per_step.items()}:
        raise AssertionError(f"the run launched {launches}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)) or \
            any(h["skipped"] for h in history):
        raise AssertionError(f"history {history}")
    ms = float(np.median(step_ms[1:]))
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    log(f"[train] {cfg.name} x{cfg.n_layers} layers at full width, {param_count(specs)} "
        f"parameters ({param_bytes(specs) / 1e9:.2f} GB bf16), {cfg.grad_accum} microbatches "
        f"of {TRAIN_MICRO} x {TRAIN_SEQ} tokens a step: {TRAIN_STEPS} steps in {run_s:.1f} s; "
        f"steps {step_ms[0]:.0f} ms first, then median {ms:.1f} ms "
        f"({tokens_per_step / ms * 1e3:.0f} tokens/s); peak memory {peak_gb:.2f} GB of "
        f"{total_gb:.2f}; losses {[round(x, 4) for x in losses]}, none skipped; launches a "
        f"step {per_step}")
    batch = {k: torch.as_tensor(v, device=device) for k, v in trainer.batch_fn(TRAIN_STEPS).items()}
    prof = profile_train("one more train step", lambda: inner(state, batch))
    del state, trainer, inner, batch
    torch.cuda.empty_cache()
    out = dict(model=cfg.name, layers=cfg.n_layers, full_layers=full.n_layers,
               grad_accum=cfg.grad_accum, micro_batch=TRAIN_MICRO, seq=TRAIN_SEQ,
               tokens_per_step=tokens_per_step, steps=TRAIN_STEPS, warmup=TRAIN_WARMUP,
               step_ms=step_ms, step_ms_median_after_first=ms,
               tokens_per_s=tokens_per_step / ms * 1e3, run_s=run_s, peak_memory_gb=peak_gb,
               card_memory_gb=total_gb, losses=losses,
               grad_norms=[h["grad_norm"] for h in history], launches_per_step=per_step,
               profile=prof)
    return out, launches


def lm_train_restart(device):
    """A failure injected at step TRAIN_RESTART["fail_at"] of a Qwen3-4B at
    full width cut to TRAIN_RESTART["layers"] layers (drawn at full depth's
    scale), checkpointed every TRAIN_RESTART["ckpt_every"] steps into a
    temporary directory: the trainer restores the last checkpoint, replays
    the steps after it and finishes; every leaf of its final state
    (parameters, m, v, count, step) must be bit-equal to that of a run
    without failure (and without checkpoints: a save changes nothing)."""
    import tempfile

    from repro_torch.configs import qwen3_4b
    from repro_torch.models.param import tree_leaves

    full = qwen3_4b.model_cfg()
    cfg = dataclasses.replace(full, n_layers=TRAIN_RESTART["layers"])
    steps, every, fail_at = TRAIN_RESTART["steps"], TRAIN_RESTART["ckpt_every"], \
        TRAIN_RESTART["fail_at"]
    seen, leaves, secs = [], [], []

    def injector(step):
        seen.append(step)
        if step == fail_at and seen.count(step) == 1:
            raise RuntimeError("injected failure")

    with tempfile.TemporaryDirectory() as d:
        for ckpt_dir, inject in ((None, None), (d, injector)):
            t = time.perf_counter()
            state = _trainer(cfg, device, steps, ckpt_dir, every, full.n_layers).run(inject)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            leaves.append(tree_leaves([state.params, state.opt_state, state.step]))
            del state
        written = sorted(p.name for p in Path(d).iterdir())
        step_gb = sum(f.stat().st_size for f in (Path(d) / written[-1]).iterdir()) / 1e9
    a, b = leaves
    replayed = seen[seen.index(fail_at) + 1:]
    if seen.count(fail_at) != 2 or replayed[0] != fail_at - fail_at % every:
        raise AssertionError(f"the restarted run took steps {seen}")
    equal = sum(torch.equal(x, y) for x, y in zip(a, b))
    log(f"[train] restart: {cfg.name} x{cfg.n_layers} layers at full width, checkpoints every "
        f"{every} steps ({step_gb:.2f} GB a step; {written} kept), a failure injected at step "
        f"{fail_at}: steps taken {seen}; {equal} of {len(a)} leaves bit-equal to the run "
        f"without failure ({secs[0]:.1f} s without, {secs[1]:.1f} s with checkpoints and the "
        f"restart)")
    if equal != len(a):
        raise AssertionError("the restarted run's final state differs from the uninterrupted run's")
    del leaves, a, b
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, steps=steps, ckpt_every=every, fail_at=fail_at,
                steps_taken=seen, checkpoint_gb=step_gb, leaves=equal, bit_equal=True,
                s_uninterrupted=secs[0], s_restarted=secs[1])


def lm_train_card_vs_cpu(device):
    """A 2-layer Qwen3-4B at full width in float32, TF32 off: two
    `make_train_step` steps (warmup 1, so step 0's learning rate is 0 and
    step 1's the base rate) of TRAIN_CPU_BATCH x TRAIN_CPU_SEQ tokens in two
    microbatches on the card (flash kernels) and on the CPU (plain
    versions) from the same parameters. After each step: the loss and grad
    norm within TRAIN_CPU_TOL (relative); m within TRAIN_CPU_TOL of each
    leaf's max |m| (the gradients, as (1 - b1) g at step 0), v likewise;
    the parameters within 2 x lr (an Adam step is lr x m/sqrt(v), which a
    gradient of opposite sign on the two sides moves to the other side),
    and the share of parameters further apart than 1e-6 logged."""
    from repro_torch.configs import qwen3_4b
    from repro_torch.data.tokens import token_batch
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.models import transformer as T
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = dataclasses.replace(qwen3_4b.model_cfg(), n_layers=TRAIN_CPU_LAYERS,
                              dtype=torch.float32, grad_accum=2)
    params = draw_params(cfg, "cpu", qwen3_4b.model_cfg().n_layers, seed=1)
    cpu = init_train_state(params)
    card = init_train_state(tree_map(lambda p: p.to(device, copy=True), params))
    del params
    kw = dict(warmup=1, total_steps=10, grad_accum=cfg.grad_accum)
    step = make_train_step(lambda p, b: T.loss_fn(p, b, cfg), **kw)
    out = []
    with no_tf32():
        for i in range(2):
            batch = token_batch(i, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, cfg.vocab)
            before = dict(LAUNCHES)
            card, m_d = step(card, {k: torch.as_tensor(v, device=device) for k, v in batch.items()})
            torch.cuda.synchronize()
            ran = {k: LAUNCHES[k] - before.get(k, 0) for k in ("flash_attention",
                                                               "flash_attention_bwd")}
            if ran != {"flash_attention": 2 * cfg.n_layers * cfg.grad_accum,
                       "flash_attention_bwd": cfg.n_layers * cfg.grad_accum}:
                raise AssertionError(f"the card's step launched {ran}")
            cpu, m_c = step(cpu, {k: torch.as_tensor(v) for k, v in batch.items()})
            row = dict(step=i, lr=float(m_c["lr"]))
            for k in ("loss", "grad_norm"):
                row[k] = abs(float(m_d[k]) - float(m_c[k])) / abs(float(m_c[k]))
            for name in ("m", "v"):
                row[name] = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30))
                                for a, b in zip(tree_leaves(card.opt_state[name]),
                                                tree_leaves(cpu.opt_state[name])))
            diffs = [(a.detach().cpu() - b.detach()).abs()
                     for a, b in zip(tree_leaves(card.params), tree_leaves(cpu.params))]
            row["params_max_abs"] = max(float(d.max()) for d in diffs)
            row["params_share_over_1e-6"] = sum(int((d > 1e-6).sum()) for d in diffs) / \
                sum(d.numel() for d in diffs)
            row["params_tol"] = 2 * (sum(r["lr"] for r in out) + row["lr"]) + 1e-6
            del diffs
            out.append(row)
            log(f"[train-cpu] step {i} (lr {row['lr']:.3g}): card vs CPU loss {row['loss']:.3g}, "
                f"grad norm {row['grad_norm']:.3g} (relative; tol {TRAIN_CPU_TOL}), m "
                f"{row['m']:.3g}, v {row['v']:.3g} of each leaf's max (tol {TRAIN_CPU_TOL}); "
                f"parameters max |diff| {row['params_max_abs']:.3g} (tol {row['params_tol']:.3g}), "
                f"{row['params_share_over_1e-6']:.3g} of them over 1e-6")
            if not (max(row[k] for k in ("loss", "grad_norm", "m", "v")) <= TRAIN_CPU_TOL
                    and row["params_max_abs"] <= row["params_tol"]):
                raise AssertionError(f"training card vs CPU at step {i}: {row}")
    del card, cpu
    torch.cuda.empty_cache()
    return out


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


# ---------------------------------------------------------------------------
# Phase 10: the GNN and recsys zoo trains at full width
# ---------------------------------------------------------------------------


def zoo_run(name, loss_fn, specs, batch_fn, device, counts):
    """ZOO_STEPS steps of `loss_fn` through `Trainer` from parameters drawn
    on the card (seed 0), each step timed by CUDA events, its batch's host
    build by the clock, and the whole loop iteration (batch build, copy to
    the card, step, the loss read back) by the clock; every loss finite,
    no step skipped, and no hand-written kernel launched (the zoo takes
    the plain segment ops, as the reference). `counts(batch)` gives what a
    batch holds, by name. Then one more step profiled by ZOO_KINDS.
    Returns (figures, final state)."""
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.models.param import init_params, param_count
    from repro_torch.train.trainer import Trainer, TrainerConfig

    step_ms, build_s, sizes, starts = [], [], [], []

    def batches(step):
        t = time.perf_counter()
        starts.append(t)
        b = batch_fn(step)
        build_s.append(time.perf_counter() - t)
        sizes.append(counts(b))
        return b

    trainer = Trainer(loss_fn,
                      lambda: init_params(specs, torch.Generator(device=device).manual_seed(0),
                                          device),
                      batches, TrainerConfig(total_steps=ZOO_STEPS, ckpt_every=ZOO_STEPS,
                                             log_every=1, warmup=ZOO_WARMUP),
                      device=device)
    inner = trainer.step_fn

    def timed(state, batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        return out

    trainer.step_fn = timed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(LAUNCHES)
    t = time.perf_counter()
    state = trainer.run()
    run_s = time.perf_counter() - t
    # a step's wall: from its batch build's start to the next one's (the
    # last to the end of the run)
    wall_ms = [(b - a) * 1e3 for a, b in zip(starts, starts[1:] + [t + run_s])]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launched = {k: v - before.get(k, 0) for k, v in LAUNCHES.items() if v != before.get(k, 0)}
    losses = [h["loss"] for h in trainer.history]
    if launched:
        raise AssertionError(f"{name}: the zoo launched hand-written kernels {launched}")
    if len(losses) != ZOO_STEPS or not all(np.isfinite(losses)) or \
            any(h["skipped"] for h in trainer.history):
        raise AssertionError(f"{name}: history {trainer.history}")
    ms, wall = float(np.median(step_ms[1:])), float(np.median(wall_ms[1:]))
    n_params = param_count(specs)
    log(f"[zoo] {name}: {n_params} parameters; a batch: " +
        ", ".join(f"{k} {v}" for k, v in sizes[-1].items()) +
        f"; {ZOO_STEPS} steps in {run_s:.1f} s, steps {step_ms[0]:.1f} ms first, "
        f"then median {ms:.2f} ms (CUDA events); wall a step, batch build and copy "
        f"included, median after the first {wall:.2f} ms (host clock; batches built in "
        f"{np.median(build_s):.3f} s each); peak memory {peak_gb:.2f} GB; losses "
        f"{[round(x, 5) for x in losses]}, none skipped; no hand-written kernel launched")
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch_fn(ZOO_STEPS).items()}
    with adamw_ranged():
        prof = profile_by_kind("zoo", name, lambda: inner(state, batch), ZOO_KINDS,
                               rest="elementwise and the rest", wall_ms=ms)
    out = dict(run=name, params=n_params, batch=sizes[-1], steps=ZOO_STEPS,
               step_ms=step_ms, step_ms_median_after_first=ms, wall_ms=wall_ms,
               wall_ms_median_after_first=wall, batch_build_s=build_s, run_s=run_s,
               peak_memory_gb=peak_gb, losses=losses,
               grad_norms=[h["grad_norm"] for h in trainer.history], profile=prof)
    return out, state


def _graph_counts(b) -> dict:
    ok = (b["src"] >= 0) & (b["dst"] >= 0)
    return dict(nodes=int(b["node_feat"].shape[0]), edges=int(b["src"].shape[0]),
                valid_edges=int(ok.sum()))


def zoo_gnn_runs(device) -> list:
    """PNA, EGNN and GraphCast at full_graph_sm (Cora's shape through
    `full_graph_batch`, one batch every step) and minibatch_lg (a fresh
    `NeighborSampler` draw of 1,024 seeds a step through `gnn_batch`, over
    Reddit's 232,965 nodes and ~114.6 M edges, `erdos_renyi_graph`),
    EquiformerV2 at full_graph_sm, EGNN and EquiformerV2 at molecule (128
    molecules a step, `molecule_batch`). EquiformerV2 at minibatch_lg is
    left out: one (E, 29, 128) float32 edge tensor is 2.5 GB there and a
    layer keeps about ten for the backward (12 layers), past the card
    without the reference's edge-chunked distributed path."""
    from repro_torch.configs import base, egnn, equiformer_v2, graphcast, pna
    from repro_torch.data.graphs import full_graph_batch, gnn_batch, molecule_batch
    from repro_torch.graph.generators import cora_like_graph, erdos_renyi_graph
    from repro_torch.graph.sampler import NeighborSampler
    from repro_torch.models.gnn import egnn as M_egnn, equiformer_v2 as M_equi
    from repro_torch.models.gnn import graphcast as M_cast, pna as M_pna

    archs = {"pna": (pna, M_pna), "egnn": (egnn, M_egnn), "graphcast": (graphcast, M_cast),
             "equiformer-v2": (equiformer_v2, M_equi)}
    runs = []

    def run(arch, shape, batch_fn):
        conf, model = archs[arch]
        cfg = conf.model_cfg(shape)
        out, state = zoo_run(f"{arch} at {shape}", lambda p, b: model.loss_fn(p, b, cfg),
                             model.param_specs(cfg), batch_fn, device, _graph_counts)
        del state
        runs.append(dict(out, arch=arch, shape=shape))
        torch.cuda.empty_cache()

    sm = base.GNN_SHAPES["full_graph_sm"]
    g, feats, labels = cora_like_graph(n=sm["n_nodes"], e_target=sm["n_edges"],
                                       d_feat=sm["d_feat"], n_classes=sm["n_out"])
    b_sm = full_graph_batch(g, feats, labels)
    for arch in ("pna", "egnn", "graphcast", "equiformer-v2"):
        run(arch, "full_graph_sm", lambda step: b_sm)

    mol = base.GNN_SHAPES["molecule"]
    for arch in ("egnn", "equiformer-v2"):
        run(arch, "molecule", lambda step: molecule_batch(
            step, n_mols=mol["batch"], n_nodes=mol["n_nodes"], n_edges=mol["n_edges"],
            d_feat=mol["d_feat"]))

    lg = base.GNN_SHAPES["minibatch_lg"]
    t = time.perf_counter()
    g = erdos_renyi_graph(lg["n_nodes"], avg_degree=ZOO_LG_AVG_DEGREE)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((lg["n_nodes"], lg["d_feat"]), dtype=np.float32)
    labels = rng.integers(0, lg["n_out"], lg["n_nodes"]).astype(np.int32)
    host_s = time.perf_counter() - t
    log(f"[zoo] minibatch_lg host graph: {g.n} nodes, {g.e} edges (GNN_SHAPES: "
        f"{lg['n_edges']}), features {feats.shape}, built in {host_s:.1f} s")
    for arch in ("pna", "egnn", "graphcast"):
        sampler = NeighborSampler(g, lg["fanout"], seed=0)
        run(arch, "minibatch_lg",
            lambda step: gnn_batch(step, g, feats, labels, sampler,
                                   batch_nodes=lg["batch_nodes"]))
    runs.append(dict(arch="equiformer-v2", shape="minibatch_lg", left_out=True,
                     why="one card's memory: one (E, 29, 128) float32 edge tensor is 2.5 GB at "
                         "168,960 edges, and about ten a layer are kept for the backward over "
                         "12 layers, past 80 GB; the edge-chunked path "
                         "(models/gnn/distributed.py, ported) streams a full graph's edges "
                         "over a mesh, not a sampled batch's on one card"))
    log("[zoo] equiformer-v2 at minibatch_lg: left out (one card's memory: about ten (E, 29, "
        "128) float32 edge tensors of 2.5 GB are kept a layer for the backward, over 12 "
        "layers)")
    runs.append(dict(host_graph=dict(nodes=g.n, edges=g.e, build_s=host_s)))
    del g, feats, labels
    return runs


def zoo_din_runs(device) -> dict:
    """DIN at train_batch (65,536 click logs a step, `din_batch`) through
    `Trainer`; then, under no_grad with the trained parameters, `score` at
    serve_p99 (512) and serve_bulk (262,144) and `retrieval_scores` at
    retrieval_cand (one user against 1,000,000 candidates), each call timed
    by CUDA events (median of ZOO_DIN_CALLS), finite and of its shape."""
    from repro_torch.configs import din
    from repro_torch.data.recsys import din_batch
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.models.recsys import din as M

    cfg = din.model_cfg()
    mk = lambda step, B: din_batch(step, B, seq_len=cfg.seq_len, n_items=cfg.n_items,
                                   n_cats=cfg.n_cats, d_profile=cfg.d_profile)
    B = din.SHAPES["train_batch"]["batch"]
    out, state = zoo_run("din at train_batch", lambda p, b: M.loss_fn(p, b, cfg),
                         M.param_specs(cfg), lambda step: mk(step, B), device,
                         lambda b: dict(examples=int(b["hist_items"].shape[0]),
                                        history_ids=int(b["hist_items"].size),
                                        valid_history_ids=int((b["hist_items"] >= 0).sum())))
    out.update(arch="din", shape="train_batch")
    params = {k: v.detach() for k, v in state.params.items()}
    del state
    serve = {}
    before = dict(LAUNCHES)
    with torch.no_grad():
        for shape in ("serve_p99", "serve_bulk"):
            n = din.SHAPES[shape]["batch"]
            b = {k: torch.as_tensor(v, device=device) for k, v in mk(100, n).items()
                 if k != "label"}
            s = M.score(params, b, cfg)
            if s.shape != (n,) or not bool(torch.isfinite(s).all()):
                raise AssertionError(f"din score at {shape}: {s.shape}")
            serve[shape] = dict(batch=n, ms=median_ms(lambda: M.score(params, b, cfg),
                                                      ZOO_DIN_CALLS))
        nc = din.SHAPES["retrieval_cand"]["n_candidates"]
        user = mk(101, 1)
        rng = np.random.default_rng(0)
        b = {"hist_items": user["hist_items"], "hist_cats": user["hist_cats"],
             "profile": user["profile"],
             "cand_items": rng.integers(0, cfg.n_items, nc).astype(np.int32),
             "cand_cats": rng.integers(0, cfg.n_cats, nc).astype(np.int32)}
        b = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
        s = M.retrieval_scores(params, b, cfg)
        if s.shape != (nc,) or not bool(torch.isfinite(s).all()):
            raise AssertionError(f"din retrieval: {s.shape}")
        serve["retrieval_cand"] = dict(batch=1, candidates=nc, ms=median_ms(
            lambda: M.retrieval_scores(params, b, cfg), ZOO_DIN_CALLS))
    if dict(LAUNCHES) != before:
        raise AssertionError("DIN serving launched a hand-written kernel")
    log("[zoo] din serving (trained parameters, no_grad, CUDA events, median of "
        f"{ZOO_DIN_CALLS}): " + ", ".join(
            f"{k} {v['ms']:.3f} ms a call ({v.get('candidates', v['batch'])} "
            f"{'candidates' if 'candidates' in v else 'examples'})" for k, v in serve.items()))
    del params
    torch.cuda.empty_cache()
    return dict(out, serve=serve)


def zoo_smoke_cases():
    """(name, loss_fn, specs, batch) of each zoo arch's smoke config on the
    batches the CPU tests use (tests/test_torch_gnn_models.py STEP_CASES,
    tests/test_torch_din.py): PNA on a sampled minibatch, EGNN on molecule
    graph regression, GraphCast and EquiformerV2 on a Cora-like graph of
    60 nodes, DIN on 32 click logs."""
    from repro_torch.configs import din, egnn, equiformer_v2, graphcast, pna
    from repro_torch.data.graphs import full_graph_batch, gnn_batch, molecule_batch
    from repro_torch.data.recsys import din_batch
    from repro_torch.graph.generators import cora_like_graph, powerlaw_graph
    from repro_torch.graph.sampler import NeighborSampler
    from repro_torch.models.gnn import egnn as M_egnn, equiformer_v2 as M_equi
    from repro_torch.models.gnn import graphcast as M_cast, pna as M_pna
    from repro_torch.models.recsys import din as M_din

    def full(cfg):
        g, feats, labels = cora_like_graph(n=60, e_target=240, d_feat=cfg.d_in,
                                           n_classes=cfg.n_out, seed=1)
        return full_graph_batch(g, feats, labels)

    def minibatch(cfg):
        g = powerlaw_graph(n=200, m=3, seed=2)
        rng = np.random.default_rng(3)
        feats = rng.standard_normal((g.n, cfg.d_in)).astype(np.float32)
        labels = rng.integers(0, cfg.n_out, g.n).astype(np.int32)
        return gnn_batch(0, g, feats, labels, NeighborSampler(g, (3, 2), seed=4), batch_nodes=8)

    out = []
    cfg = pna.smoke_cfg()
    out.append(("pna/minibatch", cfg, M_pna, minibatch(cfg)))
    cfg = dataclasses.replace(egnn.smoke_cfg(), n_out=1, task="graph_regression", n_graphs=4)
    out.append(("egnn/molecule", cfg, M_egnn,
                molecule_batch(0, n_mols=4, n_nodes=10, n_edges=20, d_feat=cfg.d_in)))
    for name, conf, model in (("graphcast/full", graphcast, M_cast),
                              ("equiformer-v2/full", equiformer_v2, M_equi)):
        cfg = conf.smoke_cfg()
        out.append((name, cfg, model, full(cfg)))
    cfg = din.smoke_cfg()
    out.append(("din", cfg, M_din, din_batch(0, 32, seq_len=cfg.seq_len, n_items=cfg.n_items,
                                             n_cats=cfg.n_cats, d_profile=cfg.d_profile)))
    return [(name, (lambda p, b, c=cfg, m=model: m.loss_fn(p, b, c)),
             model.param_specs(cfg), batch) for name, cfg, model, batch in out]


def zoo_card_vs_cpu(device) -> list:
    """Each zoo arch's smoke config (`zoo_smoke_cases`), TF32 off: the same
    parameters (drawn on the CPU) take two `make_train_step` steps (warmup
    0: both move the parameters) on the card and on the CPU. After each:
    the loss and grad norm within ZOO_CPU_TOL (relative), m and v within
    ZOO_CPU_TOL of each leaf's max |entry|, each parameter leaf within
    ZOO_STEP_TOL of its max |entry| plus ZOO_LR_SHARE_TOL of the summed
    learning rates; the worst leaf's share of its tolerance is logged. The
    card's plain segment sum adds with atomics, so its order is not the
    CPU's."""
    from repro_torch.models.param import init_params, tree_leaves, tree_map
    from repro_torch.train.train_step import init_train_state, make_train_step

    rows = []
    with no_tf32():
        for name, loss_fn, specs, batch in zoo_smoke_cases():
            params = init_params(specs, torch.Generator().manual_seed(0), "cpu")
            cpu = init_train_state(params)
            card = init_train_state(tree_map(lambda p: p.to(device, copy=True), params))
            step = make_train_step(loss_fn, warmup=0, total_steps=10)
            worst, lr_sum = dict.fromkeys(("loss", "grad_norm", "m", "v"), 0.0), 0.0
            p_share, p_diff, p_tol = 0.0, 0.0, 0.0
            for i in range(2):
                card, m_d = step(card, {k: torch.as_tensor(v, device=device)
                                        for k, v in batch.items()})
                cpu, m_c = step(cpu, {k: torch.as_tensor(v) for k, v in batch.items()})
                lr_sum += float(m_c["lr"])
                for k in ("loss", "grad_norm"):
                    worst[k] = max(worst[k], abs(float(m_d[k]) - float(m_c[k])) /
                                   abs(float(m_c[k])))
                for k in ("m", "v"):
                    worst[k] = max([worst[k]] + [
                        float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30))
                        for a, b in zip(tree_leaves(card.opt_state[k]),
                                        tree_leaves(cpu.opt_state[k]))])
                for a, b in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
                    diff = float((a.detach().cpu() - b.detach()).abs().max())
                    tol = ZOO_STEP_TOL * float(b.detach().abs().max()) + ZOO_LR_SHARE_TOL * lr_sum
                    if diff / tol > p_share:
                        p_share, p_diff, p_tol = diff / tol, diff, tol
                if int(m_d["skipped"]) or not np.isfinite(float(m_d["loss"])):
                    raise AssertionError(f"zoo card vs CPU {name}: step {i} {m_d}")
            log(f"[zoo-cpu] {name}: two steps, card vs CPU: loss {worst['loss']:.3g}, grad norm "
                f"{worst['grad_norm']:.3g} (relative; tol {ZOO_CPU_TOL}), m {worst['m']:.3g}, "
                f"v {worst['v']:.3g} of each leaf's max (tol {ZOO_CPU_TOL}); parameters: the "
                f"worst leaf {p_share:.4g} of its tolerance, |diff| {p_diff:.4g} against "
                f"{p_tol:.4g} ({ZOO_STEP_TOL} of its max |entry| + {ZOO_LR_SHARE_TOL} of the "
                f"summed lr {lr_sum:.4g})")
            if max(worst[k] for k in ("loss", "grad_norm", "m", "v")) > ZOO_CPU_TOL or \
                    p_share > 1:
                raise AssertionError(f"zoo card vs CPU {name}: {worst}, parameters {p_share} "
                                     "of their tolerance")
            rows.append(dict(case=name, lr_sum=lr_sum, params_share_of_tol=p_share,
                             params_diff=p_diff, params_tol=p_tol, **worst))
            del card, cpu
    torch.cuda.empty_cache()
    return rows


def zoo_training(device) -> dict:
    """Phase 10 (the zoo): every run under `no_tf32()` (the zoo's
    parameters are float32, so its GEMMs are float32 GEMMs)."""
    with no_tf32():
        gnn = zoo_gnn_runs(device)
        din = zoo_din_runs(device)
    return dict(gnn=gnn, din=din, card_vs_cpu=zoo_card_vs_cpu(device))


# ---------------------------------------------------------------------------
# Phase 11: the paper's own system at the grouting configuration
# ---------------------------------------------------------------------------

# the graph at the serving launcher's degree (launch/serve.py --degree) and
# landmark count (--landmarks): 4,194,304 x 32 int32 distances, 537 MB
GROUTING_DEGREE = 8
GROUTING_LANDMARKS = 32
# the embed router's training steps (launch/serve_graph.py), at the
# configuration's embed_dim
GROUTING_EMBED_STEPS = dict(lm_steps=200, node_steps=80)
# the 2-hop hotspot stream of configs/grouting.py; the bursts wrap around
# its 96 queries, so later bursts revisit hotspots and the caches warm
GROUTING_WORKLOAD = dict(r=2, n_hotspots=8, queries_per_hotspot=12, seed=1)
GROUTING_BURSTS = 6  # arrival bursts a run (1.5x the slots each), then the drain
GROUTING_BACKLOG = 64
GROUTING_WARM = 2  # bursts before the per-burst figures count
GROUTING_PROFILED = 3  # the burst of each cuda run that runs under the profiler
GROUTING_BACKENDS = ("cuda", "scatter")


def profiled_burst(b, fn, kind, prof):
    """`serve_bursts`' on_step hook: burst GROUTING_PROFILED's step runs
    under torch.profiler (again, up to PROFILE_TRIES, while the trace lacks
    the frontier kernel or its pads; the step is a function of its inputs,
    so a try recomputes the same burst, and its launches are set apart in
    `prof["extra_launches"]`). Fills `prof` with the kernel's launches and
    µs a launch, and the device's busy share: the union of the device ops'
    intervals over the profiled call's wall (CUDA events)."""
    if b != GROUTING_PROFILED:
        return fn()
    from repro_torch.kernels.build import LAUNCHES

    symbol = KERNELS[kind][2]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    box = {}

    def timed():
        ev[0].record()
        box["out"] = fn()
        ev[1].record()

    prof["extra_launches"] = 0
    for tries in range(1, PROFILE_TRIES + 1):
        before = LAUNCHES[kind]
        events = _device_events(timed)
        k_us = [us for name, _, us in events if symbol in name]
        if k_us and events.pads:
            break
        prof["extra_launches"] += LAUNCHES[kind] - before
        log(f"[profile] try {tries} of {PROFILE_TRIES}: {len(k_us)} {symbol} events, "
            f"{events.pads} pads")
    else:
        raise AssertionError(f"no profile of burst {b} shows {symbol}")
    busy_us, end = 0.0, -np.inf
    for start, stop in sorted((t, t + us) for _, t, us in events):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    wall_ms = ev[0].elapsed_time(ev[1])
    top = {}
    for name, _, us in events:
        t_us, c = top.get(name, (0.0, 0))
        top[name] = (t_us + us, c + 1)
    prof.update(burst=b, kernel_names=sorted({n[:120] for n, _, _ in events if symbol in n}),
                kernel_calls=len(k_us), kernel_us=float(np.sum(k_us)),
                us_a_launch=float(np.mean(k_us)), device_ops=len(events),
                device_us=float(sum(us for _, _, us in events)), busy_us=busy_us,
                profiled_ms=wall_ms, busy_share=busy_us / 1e3 / wall_ms,
                top=[dict(name=n[:80], us=u, calls=c) for n, (u, c) in
                     sorted(top.items(), key=lambda kv: -kv[1][0])[:6]])
    return box["out"]


def grouting_serving(device):
    """Phase 11: the grouting configuration (`configs/grouting.py`) at full
    size through the port's distributed serving step at a world of one over
    NCCL: `powerlaw_graph(4,194,304, m=8)` padded to 32-wide rows (at most
    N_ROWS), a one-shard storage tier, the landmark index and the embed
    router's embedding built on the card, the 2-hop hotspot stream in
    1.5x-oversubscribed bursts through `launch/serve_graph.py`'s burst loop
    (`serve_bursts`: one embed router, `make_admission_round`, a bounded
    backlog), then the drain. Each shape runs with the config's 16 storage
    shards folded into the mesh's one, the read budget a processor had over
    them kept (`read_capacity` x 16), so B x F <= read_capacity x
    read_retry and no read is lost. Every shape under {cuda, scatter} x
    {dense, packed}: queries, counts and the stats [touched, missed probes,
    reads] of every burst, and the final cache, equal across the four; each
    query that `hhop_ball` shows untruncated counts |N_h(q)| - 1, and every
    query, truncated ones too, what `capped_ball_size` (a numpy search
    under the step's caps, apart from the engine) marks, less one; the cuda
    runs launch the layout's frontier kernel and no other, the scatter runs
    none; burst GROUTING_PROFILED of each cuda run profiled. Then the
    serving launcher (`launch/serve.py --scheme landmark`, its defaults) on
    the card, its landmark index bit-equal to one built on the CPU.
    Last, it writes what phase 13's four ranks serve (`grouting_mesh_inputs`).
    Returns (figures, the frontier launches of the cuda runs by wrapper,
    the hand-off to phase 13: each shape's capped count of every query of
    the stream, this world of one's counts and hit rate, the files)."""
    import torch.distributed as dist

    from repro_torch.configs import grouting
    from repro_torch.core.embedding import EmbedConfig, build_graph_embedding
    from repro_torch.core.landmarks import build_landmark_index
    from repro_torch.core.serving import capped_ball_size, untruncated_size
    from repro_torch.core.storage import build_storage, make_serving_storage
    from repro_torch.core.workloads import hotspot_workload
    from repro_torch.distributed.mesh import init_mesh
    from repro_torch.graph.csr import to_padded
    from repro_torch.graph.generators import powerlaw_graph
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch.serve_graph import serve_bursts

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    setup = {}

    def timed(name, fn):
        t = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        setup[f"{name}_s"] = time.perf_counter() - t
        return value

    g = timed("graph", lambda: powerlaw_graph(n=grouting.N_NODES, m=GROUTING_DEGREE, seed=0))
    adj = timed("padding", lambda: to_padded(g, max_degree=grouting.ROW_WIDTH))
    deg = g.degree()
    if g.n != grouting.N_NODES or adj.max_degree != grouting.ROW_WIDTH or \
            not adj.n_rows <= grouting.N_ROWS:
        raise AssertionError(f"grouting graph: {g.n} nodes, {adj.n_rows} rows of "
                             f"{adj.max_degree} (config: {grouting.N_ROWS} rows)")
    tier = timed("storage", lambda: build_storage(adj, n_shards=1, device=device))
    n_rows = adj.n_rows
    li = timed("landmarks", lambda: build_landmark_index(
        g, n_processors=1, n_landmarks=GROUTING_LANDMARKS, device=device))
    setup["landmarks_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    embed_cfg = EmbedConfig(dim=grouting.model_cfg().embed_dim, **GROUTING_EMBED_STEPS)
    emb = timed("embedding", lambda: build_graph_embedding(li.dist_to_lm, li.landmarks,
                                                           embed_cfg, device=device))
    rel = emb.rel_error(li.dist_to_lm)
    if not 0 <= rel < 1:
        raise AssertionError(f"grouting embedding: rel_error {rel}")
    del li
    wl = timed("workload", lambda: hotspot_workload(g, **GROUTING_WORKLOAD))
    nodes = wl.query_nodes
    out = dict(nodes=g.n, edges=g.e, max_degree=int(deg.max()), rows=n_rows,
               continuation_rows=n_rows - g.n, config_rows=grouting.N_ROWS,
               over_chain=int((deg > grouting.ROW_WIDTH * grouting.model_cfg().chain_depth).sum()),
               queries=int(nodes.size), embed_rel_error=rel, **setup, shapes=[])
    log(f"[grouting] graph {g.n:,} nodes, {g.e:,} edges, max degree {out['max_degree']:,} "
        f"({setup['graph_s']:.1f} s); {n_rows:,} rows of {grouting.ROW_WIDTH} "
        f"({out['continuation_rows']:,} continuation rows, config {grouting.N_ROWS:,}; "
        f"{setup['padding_s']:.1f} s); tier on the card {setup['storage_s']:.1f} s; "
        f"{GROUTING_LANDMARKS} landmarks {setup['landmarks_s']:.1f} s (peak "
        f"{setup['landmarks_peak_gb']:.2f} GB); embedding {setup['embedding_s']:.1f} s "
        f"(rel_error {rel:.4f}); {nodes.size} queries of the 2-hop hotspot stream; "
        f"{out['over_chain']:,} nodes over {grouting.ROW_WIDTH} x chain_depth entries")

    store = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "grouting_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    mesh, dev = init_mesh((1, 1), ("data", "model"), device, store=dist.FileStore(store, 1),
                          rank=0, world_size=1)
    launches = dict.fromkeys(KERNELS_BY_LAYOUT.values(), 0)
    quiet = lambda *_a, **_k: None  # noqa: E731
    handoff = dict(shapes={})  # what phase 13's four ranks are held to
    try:
        if dist.get_backend() != ("nccl" if dev.type == "cuda" else "gloo"):
            raise AssertionError(f"grouting on {dev}: backend {dist.get_backend()}")
        storage = make_serving_storage(tier, mesh.axis_index("model"), dev)
        for shape in grouting.SHAPES:
            base = grouting.model_cfg(shape)
            S = mesh.shape["model"]
            # the 16 shards fold into the mesh's S: a processor keeps the
            # read budget it had over all of them
            cfg = dataclasses.replace(base, n_storage_shards=S,
                                      read_capacity=base.read_capacity * base.n_storage_shards // S)
            B, F = cfg.queries_per_proc, cfg.max_frontier
            # the frontier kernels index in 32 bits below INT_MAX (csrc/frontier.cu)
            branch64 = max(B * g.n, B * F * cfg.row_width) >= 2 ** 31 - 1
            if B * F > cfg.read_capacity * cfg.read_retry:
                raise AssertionError(f"{shape}: B x F = {B * F} over the read budget")
            runs = {}
            for backend in GROUTING_BACKENDS:
                for layout, kind in KERNELS_BY_LAYOUT.items():
                    c = dataclasses.replace(cfg, expand_backend=backend, visited_layout=layout)
                    prof = {}
                    hook = (None if backend != "cuda" else
                            lambda b, fn, kind=kind, prof=prof: profiled_burst(b, fn, kind, prof))
                    LAUNCHES.clear()  # counts of this run only
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = serve_bursts(mesh, dev, c, storage, emb, nodes, bursts=GROUTING_BURSTS,
                                       backlog=GROUTING_BACKLOG, say=quiet, on_step=hook,
                                       record=True)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    counted = {k: v for k, v in LAUNCHES.items() if v}
                    if prof:
                        counted[kind] -= prof["extra_launches"]
                    what = f"grouting {shape} {backend}/{layout}"
                    if backend == "cuda" and (counted.get(kind, 0) == 0 or
                                              sum(counted.values()) != counted[kind]):
                        raise AssertionError(f"{what}: launches {counted}")
                    if backend != "cuda" and sum(counted.values()):
                        raise AssertionError(f"{what}: launches {counted}")
                    if backend == "cuda":
                        # the 64-bit instantiation is the one whose index is
                        # an unsigned long
                        wide = any("unsigned long" in n for n in prof.get("kernel_names", ()))
                        if not prof or wide != branch64:
                            raise AssertionError(f"{what}: profile {prof}")
                    runs[(backend, layout)] = (res, wall, counted, prof)
            # the same answers from both backends and both layouts
            first = runs[("cuda", "dense")][0]
            for (backend, layout), (res, *_rest) in runs.items():
                what = f"grouting {shape} {backend}/{layout} vs cuda/dense"
                if len(res["record"]) != len(first["record"]):
                    raise AssertionError(f"{what}: {len(res['record'])} bursts")
                for i, (a, b) in enumerate(zip(res["record"], first["record"])):
                    for x, y, name in zip(a, b, ("queries", "counts", "stats")):
                        if not np.array_equal(x, y):
                            raise AssertionError(f"{what}: burst {i} {name} differ")
                _same_fields(res["cache"], first["cache"], f"{what}: final cache")
                for k in ("served", "dropped", "touched", "misses", "served_per_burst"):
                    if res[k] != first[k]:
                        raise AssertionError(f"{what}: {k} {res[k]} != {first[k]}")
            # the oracles: every query the balls show untruncated to
            # |N_h(q)| - 1, and every query to the capped numpy search
            t_oracle = time.perf_counter()
            cap = cfg.row_width * cfg.chain_depth
            sizes, capped, held, cut = {}, {}, 0, 0
            for queries, counts, _ in first["record"]:
                for q, c in zip(queries.tolist(), counts.tolist()):
                    if q < 0:
                        continue
                    if q not in sizes:
                        sizes[q] = untruncated_size(g, q, cfg.hops, F, cap)
                        capped[q] = capped_ball_size(g, q, cfg.hops, F, cap)
                    if c != capped[q] - 1:
                        raise AssertionError(f"grouting {shape}: query {q} counts {c}, the "
                                             f"capped search marks {capped[q]} - 1")
                    if sizes[q] is None:
                        cut += 1
                    elif c != sizes[q] - 1:
                        raise AssertionError(f"grouting {shape}: query {q} counts {c}, "
                                             f"|N_{cfg.hops}| - 1 = {sizes[q] - 1}")
                    else:
                        held += 1
            t_oracle = time.perf_counter() - t_oracle
            # for phase 13's mesh: every query of the stream under the caps,
            # and this world of one's counts and hit rate
            for q in np.unique(nodes).tolist():
                if q not in capped:
                    capped[q] = capped_ball_size(g, q, cfg.hops, F, cap)
            one = {}
            for queries, counts, _ in first["record"]:
                one.update((q, c) for q, c in zip(queries.tolist(), counts.tolist()) if q >= 0)
            handoff["shapes"][shape] = dict(
                capped=capped, one_counts=one,
                one_hit=1 - sum(first["misses"]) / max(sum(first["touched"]), 1),
                one_burst_s=float(np.median(first["burst_s"])))
            cell = dict(shape=shape, hops=cfg.hops, queries_per_proc=B, max_frontier=F,
                        chain_depth=cfg.chain_depth, storage_shards=(base.n_storage_shards, S),
                        read_capacity=(base.read_capacity, cfg.read_capacity),
                        read_retry=cfg.read_retry, reads_needed=B * F,
                        read_budget=cfg.read_capacity * cfg.read_retry,
                        index_branch="64-bit" if branch64 else "32-bit",
                        bursts=len(first["record"]), served=first["served"],
                        dropped=first["dropped"], oracle_held=held, oracle_cut=cut,
                        capped_held=held + cut,
                        oracle_distinct=len(sizes), oracle_s=t_oracle, runs=[])
            for (backend, layout), (res, wall, counted, prof) in runs.items():
                kind = KERNELS_BY_LAYOUT[layout]
                qps = [s / t for s, t in zip(res["served_per_burst"], res["burst_s"])]
                hit = [1 - m / max(t, 1) for m, t in zip(res["misses"], res["touched"])]
                # the profiled burst is left out of every run's figures
                warm = [b for b in range(len(qps)) if b >= GROUTING_WARM and b != GROUTING_PROFILED]
                # the run's qps without its profiled burst (the profiler's
                # own time is in that burst's wall)
                kept = [b for b in range(len(qps)) if b != GROUTING_PROFILED]
                run = dict(backend=backend, layout=layout, wall_s=wall,
                           qps=(sum(res["served_per_burst"][b] for b in kept)
                                / sum(res["burst_s"][b] for b in kept)),
                           launches=counted.get(kind, 0),
                           warm_qps_median=float(np.median([qps[b] for b in warm])),
                           warm_hit=(1 - sum(res["misses"][b] for b in warm)
                                     / max(sum(res["touched"][b] for b in warm), 1)),
                           qps_per_burst=qps, hit_per_burst=hit, burst_s=res["burst_s"],
                           profile=prof)
                cell["runs"].append(run)
                if backend == "cuda":
                    launches[kind] += counted[kind]
                log(f"[grouting] {shape} {backend}/{layout}: {res['served']} served, "
                    f"{res['dropped']} dropped in {len(qps)} bursts, {wall:.2f} s ("
                    f"{run['qps']:.1f} qps over the bursts but burst {GROUTING_PROFILED}); "
                    f"after warm-up: median {run['warm_qps_median']:.1f} "
                    f"qps a burst, hit {run['warm_hit']:.4f}; hit by burst "
                    + " ".join(f"{h:.3f}" for h in hit)
                    + (f"; {kind} launches {counted[kind]}, profile of burst {prof['burst']}: "
                       f"{prof['kernel_calls']} launches, {prof['us_a_launch']:.2f} us a launch, "
                       f"busy share {prof['busy_share']:.4f} of {prof['profiled_ms']:.1f} ms"
                       if prof else ""))
            log(f"[grouting] {shape}: B {B} x F {F} = {B * F} reads a link at most, read "
                f"budget {cfg.read_capacity} x {cfg.read_retry} retries = "
                f"{cell['read_budget']} (config: {base.read_capacity} a shard x "
                f"{base.n_storage_shards} shards, folded into {S}); B x n = {B * g.n:,}, the "
                f"kernels' {cell['index_branch']} branch; oracle: {held} queries held to "
                f"|N_{cfg.hops}| - 1, {cut} truncated, all {held + cut} held to the capped "
                f"search ({len(sizes)} distinct, {t_oracle:.1f} s); "
                f"cuda = scatter, dense = packed in every burst's counts and stats and the "
                f"final cache")
            out["shapes"].append(cell)
    finally:
        dist.destroy_process_group()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del tier
    handoff.update(grouting_mesh_inputs(adj, emb, nodes))
    del g, adj, emb, deg
    out["launcher"] = grouting_launcher(device)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[grouting] phase 11 in {out['phase_s']:.1f} s, peak {out['peak_gb']:.2f} GB; "
        f"frontier launches {launches}; {nvidia_smi()}")
    return out, launches, handoff


def grouting_launcher(device) -> dict:
    """The serving launcher at its defaults with `--scheme landmark`, its
    preprocessing on the card, its landmark index held bit-equal to one
    built on the CPU from the same graph."""
    from repro_torch.core import landmarks as landmarks_mod
    from repro_torch.launch import serve as launcher

    build, built = landmarks_mod.build_landmark_index, []

    def capture(g, *a, **k):
        li = build(g, *a, **k)
        built.append((g, a, k, li))
        return li

    landmarks_mod.build_landmark_index = capture
    try:
        t = time.perf_counter()
        (res,) = launcher.main(["--scheme", "landmark", "--device", device.type])
        wall = time.perf_counter() - t
    finally:
        landmarks_mod.build_landmark_index = build
    (g, a, k, li), = built
    if torch.device(k["device"]).type != device.type:
        raise AssertionError(f"the launcher built its landmark index on {k['device']}")
    cpu = build(g, *a, **dict(k, device="cpu"))
    for f in dataclasses.fields(li):
        x, y = getattr(li, f.name), getattr(cpu, f.name)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"launcher landmark index, card vs CPU: {f.name} differs")
    log(f"[grouting] launcher (python -m repro_torch.launch.serve --scheme landmark, its "
        f"defaults, {wall:.1f} s): {res.row().strip()} -- qps and resp derived from the cost "
        f"model calibrated to the paper's RAMCloud cluster, not times of the card; landmark "
        f"index on the card bit-equal to the CPU's")
    return dict(wall_s=wall, row=res.row(), derived_qps=res.throughput_qps,
                derived_mean_response_ms=res.mean_response_ms, hit_rate=res.hit_rate,
                stolen=res.stolen, landmark_index_card_eq_cpu=True)


# The paper's cluster across ranks (phase 13): the grouting configuration's
# three shapes served by four gloo ranks on (data, model) (2, 2), every rank
# a query processor (`graph_serving`: all mesh axes flattened) over two
# storage shards, from the graph phase 11 built (`grouting_mesh_inputs`)
GROUTING_MESH = (2, 2)
GROUTING_MESH_DIR = "build/grouting_mesh"  # phase 11 writes, phase 13's ranks read (git-ignored)
GROUTING_MESH_BURSTS = 3  # arrival bursts a run (1.5x the four processors' slots), then the drain


def grouting_mesh_runs(shape: str) -> tuple:
    """(backend, layout) of each run of a shape on the mesh: the cuda
    backend with both layouts, the scatter backend with the dense layout on
    serve_1hop."""
    runs = (("cuda", "dense"), ("cuda", "packed"))
    return runs + ((("scatter", "dense"),) if shape == "serve_1hop" else ())


def grouting_mesh_cfg(shape: str):
    """The shape's config over the mesh's storage shards: the config's 16
    shards fold into GROUTING_MESH[1], a processor keeping the read budget
    it had over all of them (read_capacity x 16 / S), so B x F <=
    read_capacity x read_retry and no read is lost."""
    from repro_torch.configs import grouting

    base, S = grouting.model_cfg(shape), GROUTING_MESH[1]
    cfg = dataclasses.replace(base, n_storage_shards=S,
                              read_capacity=base.read_capacity * base.n_storage_shards // S)
    if cfg.queries_per_proc * cfg.max_frontier > cfg.read_capacity * cfg.read_retry:
        raise AssertionError(f"grouting mesh {shape}: B x F over the read budget")
    return cfg


def grouting_mesh_inputs(adj, emb, nodes) -> dict:
    """Phase 11's hand-off to the mesh: the padded rows hash-placed over
    GROUTING_MESH[1] shards on the host (`build_storage`), each shard's rows,
    degrees and continuations to a file of its own, the placement tables,
    the embed router's embedding and the query stream, under
    GROUTING_MESH_DIR."""
    import shutil

    from repro_torch.core.storage import build_storage

    t = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), GROUTING_MESH_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    tier = build_storage(adj, n_shards=GROUTING_MESH[1], device="cpu")
    for s in range(tier.n_shards):
        torch.save({k: getattr(tier, f"shard_{k}")[s].clone() for k in ("rows", "deg", "cont")},
                   os.path.join(root, f"shard_{s}.pt"))
    torch.save(dict(owner=tier.owner, loc=tier.loc), os.path.join(root, "tables.pt"))
    torch.save(dict(coords=emb.coords, landmarks=emb.landmarks, lm_coords=emb.lm_coords,
                    config=dataclasses.asdict(emb.config), nodes=nodes),
               os.path.join(root, "router.pt"))
    nbytes = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root))
    log(f"[grouting] mesh inputs: {tier.n_rows:,} rows over {tier.n_shards} shards "
        f"({tier.rows_per_shard:,} a shard), {nbytes / 1e9:.2f} GB under {GROUTING_MESH_DIR} in "
        f"{time.perf_counter() - t:.1f} s")
    return dict(dir=root, shards=tier.n_shards, rows_per_shard=tier.rows_per_shard,
                bytes=nbytes)


def grouting_mesh_rank(mesh, dev, rank, root) -> dict:
    """The grouting configuration on the mesh, this rank's part: its
    storage shard (the model coordinate's) and the placement tables on the
    card, the embed router and the stream on rank 0; each shape's runs
    (`grouting_mesh_runs`) through `serve_bursts` with its record, the
    frontier launches of each counted from 0. Returns by run this rank's
    record (queries, counts, stats a burst), its walls a burst, the mesh's
    touched rows and misses a burst, rank 0's admission totals, and
    whether its record and final cache equal the shape's first run's."""
    from repro_torch.core.cache import CacheState
    from repro_torch.core.embedding import EmbedConfig, GraphEmbedding
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch.serve_graph import serve_bursts

    t0 = time.perf_counter()
    own = torch.load(os.path.join(root, f"shard_{mesh.axis_index('model')}.pt"))
    tables = torch.load(os.path.join(root, "tables.pt"))
    storage = {k: v.to(dev) for k, v in dict(own, **tables).items()}
    del own, tables
    emb = nodes = None
    if rank == 0:
        r = torch.load(os.path.join(root, "router.pt"), weights_only=False)
        emb = GraphEmbedding(coords=r["coords"], landmarks=r["landmarks"],
                             lm_coords=r["lm_coords"], config=EmbedConfig(**r["config"]))
        nodes = r["nodes"]
    quiet = lambda *_a, **_k: None  # noqa: E731
    out = {"load_s": time.perf_counter() - t0, "runs": {}}
    from repro_torch.configs import grouting

    for shape in grouting.SHAPES:
        cfg = grouting_mesh_cfg(shape)
        first = None
        for backend, layout in grouting_mesh_runs(shape):
            c = dataclasses.replace(cfg, expand_backend=backend, visited_layout=layout)
            LAUNCHES.clear()
            _sync(dev)
            t = time.perf_counter()
            res = serve_bursts(mesh, dev, c, storage, emb, nodes, bursts=GROUTING_MESH_BURSTS,
                               backlog=GROUTING_BACKLOG, say=quiet, record=True)
            _sync(dev)
            wall = time.perf_counter() - t
            cache = {f.name: getattr(res["cache"], f.name).cpu().numpy()
                     for f in dataclasses.fields(CacheState)}
            if first is None:
                first = (res["record"], cache)
            same = (len(res["record"]) == len(first[0]) and
                    all(np.array_equal(x, y) for a, b in zip(res["record"], first[0])
                        for x, y in zip(a, b)) and
                    all(np.array_equal(v, first[1][k]) for k, v in cache.items()))
            run = {k: v for k, v in res.items() if k != "cache"}
            run.update(wall_s=wall, launches={k: v for k, v in LAUNCHES.items() if v},
                       same_as_first=same)
            out["runs"][f"{shape}/{backend}/{layout}"] = run
    out["s"] = time.perf_counter() - t0
    return out


def check_grouting_mesh(ranks, handoff) -> tuple:
    """Hold and log the grouting runs of the four ranks: every query served
    on any rank counts what `capped_ball_size` gives, less one, and what
    phase 11's world of one counted for it; each rank's record and final
    cache equal across layouts and backends; every processor serves some
    queries of every run; the ranks served what rank 0 placed; each cuda
    run launched its layout's frontier kernel on every rank and no other,
    the scatter run none. Returns (figures, the frontier launches of the
    cuda runs summed over the ranks, by wrapper)."""
    from repro_torch.configs import grouting

    launches = dict.fromkeys(KERNELS_BY_LAYOUT.values(), 0)
    figures = dict(mesh=GROUTING_MESH, bursts=GROUTING_MESH_BURSTS, shards=handoff["shards"],
                   rows_per_shard=handoff["rows_per_shard"], input_bytes=handoff["bytes"],
                   shapes=[])
    for shape in grouting.SHAPES:
        cfg, h = grouting_mesh_cfg(shape), handoff["shapes"][shape]
        cell = dict(shape=shape, read_capacity=cfg.read_capacity, read_retry=cfg.read_retry,
                    reads_needed=cfg.queries_per_proc * cfg.max_frontier,
                    one_hit=h["one_hit"], one_burst_s=h["one_burst_s"], runs=[])
        for backend, layout in grouting_mesh_runs(shape):
            key = f"{shape}/{backend}/{layout}"
            runs = [r["grouting"]["runs"][key] for r in ranks]
            kind = KERNELS_BY_LAYOUT[layout]
            served, matched = [], 0
            for rank, run in enumerate(runs):
                if not run["same_as_first"]:
                    raise AssertionError(f"grouting mesh {key}: rank {rank}'s record or cache "
                                         f"differs from the shape's first run")
                want = {kind: run["launches"].get(kind, 0)} if backend == "cuda" else {}
                if run["launches"] != want or (backend == "cuda" and not want[kind]):
                    raise AssertionError(f"grouting mesh {key}: rank {rank} launched "
                                         f"{run['launches']}")
                mine = 0
                for queries, counts, _ in run["record"]:
                    for q, c in zip(queries.tolist(), counts.tolist()):
                        if q < 0:
                            continue
                        mine += 1
                        if c != h["capped"][q] - 1:
                            raise AssertionError(f"grouting mesh {key}: rank {rank} query {q} "
                                                 f"counts {c}, the capped search "
                                                 f"{h['capped'][q]} - 1")
                        if q in h["one_counts"]:
                            matched += 1
                            if c != h["one_counts"][q]:
                                raise AssertionError(f"grouting mesh {key}: rank {rank} query "
                                                     f"{q} counts {c}, the world of one "
                                                     f"{h['one_counts'][q]}")
                served.append(mine)
                if backend == "cuda":
                    launches[kind] += run["launches"][kind]
            lead = runs[0]
            for rank, run in enumerate(runs):
                if [x[2].tolist() for x in run["record"]] != \
                        [x[2].tolist() for x in lead["record"]]:
                    raise AssertionError(f"grouting mesh {key}: rank {rank}'s stats differ")
            if min(served) == 0 or sum(served) != lead["served"]:
                raise AssertionError(f"grouting mesh {key}: served by rank {served}, rank 0 "
                                     f"placed {lead['served']}")
            hit = 1 - sum(lead["misses"]) / max(sum(lead["touched"]), 1)
            walls = [float(np.median(run["burst_s"])) for run in runs]
            cell["runs"].append(dict(
                backend=backend, layout=layout, served_by_rank=served, placed=lead["served"],
                dropped=lead["dropped"], bursts=len(lead["record"]), hit=hit,
                burst_s_median_by_rank=walls, wall_s_by_rank=[r["wall_s"] for r in runs],
                launches_by_rank=[r["launches"].get(kind, 0) for r in runs],
                held_to_world_of_one=matched))
            log(f"[grouting-mesh] {key}: {GROUTING_MESH[0]} x {GROUTING_MESH[1]} gloo ranks (a "
                f"processor a rank, {GROUTING_MESH[1]} storage shards), {len(lead['record'])} "
                f"bursts: served by rank {served} of {lead['served']} placed, "
                f"{lead['dropped']} dropped; every count = capped search - 1, {matched} also "
                f"held to the world of one's; hit {hit:.4f} (world of one {h['one_hit']:.4f}); "
                f"median wall a burst by rank " + " ".join(f"{w:.3f}" for w in walls) +
                f" s (world of one over NCCL {h['one_burst_s']:.3f} s; gloo through the host); "
                + (f"{kind} launches by rank {[r['launches'][kind] for r in runs]}"
                   if backend == "cuda" else "no hand-written launch"))
        figures["shapes"].append(cell)
    log(f"[grouting-mesh] every rank's record and final cache equal across layouts and "
        f"backends; frontier launches summed over the four ranks {launches}")
    return figures, launches


# ---------------------------------------------------------------------------
# Phase 12: planning and examples
# ---------------------------------------------------------------------------

# one cell of each family through `python -m repro_torch.launch.dryrun`,
# each in a subprocess of its own (started together, on the host: the dry
# run counts on meta tensors and touches no device)
PLAN_CELLS = (("qwen3-4b", "train_4k"), ("qwen2-moe-a2.7b", "prefill_32k"),
              ("pna", "full_graph_sm"), ("din", "train_batch"), ("grouting", "serve_1hop"))
PLAN_TIMEOUT_S = 240  # a dry-run subprocess, import and count included
PLAN_OUT = "build/dryrun"  # the dry run's JSON records (git-ignored)


def quickstart_graph_digest() -> str:
    """numpy's version and a digest of the quickstart's graph at its
    defaults. The graph's intra-community targets are `Generator.zipf`
    draws, a stream numpy does not hold fixed across versions: hosts with
    other numpy versions build other graphs (the reference's and the
    port's alike), and so print other rows."""
    from repro_torch.examples import quickstart
    from repro_torch.graph.generators import community_graph

    d = {k: p.default for k, p in inspect.signature(quickstart.run).parameters.items()}
    g = community_graph(n=d["n"], community_size=d["community_size"], intra_degree=6,
                        inter_degree=1.0, seed=0)
    return (f"numpy {np.__version__}: graph of {g.e} edges, sha1 of its CSR "
            f"{hashlib.sha1(g.indptr.tobytes() + g.indices.tobytes()).hexdigest()[:12]}")


def examples_on_card(device) -> dict:
    """(a) The reference's three examples at its defaults, on the card:
    the quickstart (landmarks and embedding on the card, the simulator on
    the host: its qps and milliseconds are cost-model derivations), DIN
    (80 training steps, then serve_p99, serve_bulk and retrieval; p50 and
    qps are synced walls on the card) and GraphCast's weather mode (60
    steps; the MSE must fall)."""
    from repro_torch.core.costmodel import DERIVED
    from repro_torch.examples import din_serving, quickstart, weather_graphcast

    out = {}
    t = time.perf_counter()
    rows = quickstart.run(device=device, out=lambda s: log(f"[quickstart] {s}"))
    for r in rows:
        if not (np.isfinite(r.throughput_qps) and np.isfinite(r.mean_response_ms)
                and 0.0 <= r.hit_rate <= 1.0):
            raise AssertionError(f"quickstart row {r}")
    wall = time.perf_counter() - t
    # the same run with the preprocessing on the host's CPU: which rows the
    # card's landmarks and embedding move (printed, not held: the embedding
    # is float arithmetic in another order)
    fields = lambda r: (r.throughput_qps, r.mean_response_ms, r.hit_rate, r.stolen)
    cpu_rows = quickstart.run(device="cpu", out=lambda s: None)
    same = {r.scheme: fields(r) == fields(c) for r, c in zip(rows, cpu_rows)}
    log(f"[quickstart] rows equal to a run with the preprocessing on the CPU: {same}")
    graph = quickstart_graph_digest()
    log(f"[quickstart] {graph}")
    out["quickstart"] = dict(
        clock=f"qps and resp_ms {DERIVED}; hit and stolen simulated", wall_s=wall, graph=graph,
        rows=[dict(scheme=r.scheme, qps=r.throughput_qps, resp_ms=r.mean_response_ms,
                   hit=r.hit_rate, stolen=r.stolen) for r in rows], equal_to_cpu=same)

    t = time.perf_counter()
    d = din_serving.run(device=device, out=lambda s: log(f"[din_serving] {s}"))
    shapes = {name: d[name] for name, _, _ in din_serving.SERVE}
    if not all(np.isfinite(d["losses"])) or not all(
            np.isfinite(v["scores"]).all() and 0.0 <= v["auc"] <= 1.0 for v in shapes.values()) \
            or not np.isfinite(d["retrieval"]["scores"]).all():
        raise AssertionError("din_serving: a loss, score or AUC out of range")
    out["din_serving"] = dict(
        clock="synced walls on the card (host batch build and copy included)",
        wall_s=time.perf_counter() - t, final_bce=d["losses"][-1],
        shapes={k: dict(batch=v["batch"], p50_ms=v["p50_ms"], qps=v["qps"], auc=v["auc"])
                for k, v in shapes.items()},
        retrieval=dict(candidates=d["retrieval"]["candidates"],
                       ms=d["retrieval"]["wall_s"] * 1e3, top5=d["retrieval"]["top5"]))

    t = time.perf_counter()
    w = weather_graphcast.run(device=device, out=lambda s: log(f"[weather_graphcast] {s}"))
    if not all(np.isfinite(w["losses"])) or not w["losses"][-1] < w["losses"][0]:
        raise AssertionError(f"weather_graphcast: losses {w['losses']}")
    out["weather_graphcast"] = dict(wall_s=time.perf_counter() - t, mse_first=w["losses"][0],
                                    mse_last=w["losses"][-1])
    return out


def roofline_rows(lm: dict, train: dict, zoo: dict) -> list:
    """(b) The roofline of the steps phases 4, 9 and 10 timed, counted on
    meta tensors at the same shapes through the dry run's own count and
    report (`launch/dryrun.py` `count_cell`, `report_for`), beside the
    medians measured there: Qwen3-4B's prefill (LM_BATCH x LM_PROMPT), its
    training step (the grad_accum microbatches of TRAIN_MICRO x TRAIN_SEQ
    counted as one batch, as the dry run counts it: the same flops) and
    GraphCast's at minibatch_lg (float32, TF32 off). The model-flops share
    is model_flops / (t x peak): the benchmark's `mfu`."""
    from repro_torch.analysis.roofline import model_flops_share
    from repro_torch.configs import base, graphcast, qwen3_4b
    from repro_torch.launch.dryrun import count_cell, report_for
    from repro_torch.launch.mesh import make_host_mesh

    rows = []
    one = make_host_mesh()  # one card: nothing split

    def row(name, spec, seconds):
        t = time.perf_counter()
        counted = count_cell(spec)
        count = counted[2]
        _, rep = report_for(spec, one, counted, name, "")
        r = rep.row()
        model_flops = spec.meta["model_flops"]
        share = model_flops_share(model_flops, seconds, rep.peak)
        rows.append(dict(step=name, model_flops=model_flops, counted_flops=count.flops,
                         major_bytes=count.major_bytes, score_bytes=count.score_bytes,
                         eager_bytes=count.bytes, state_rw_bytes=rep.peak_state_bytes,
                         peak=rep.peak, bound_s=max(rep.t_compute, rep.t_memory),
                         t_compute_s=rep.t_compute, t_memory_s=rep.t_memory,
                         bottleneck=r["bottleneck"], measured_s=seconds,
                         model_flops_share=share,
                         counted_flops_share=count.flops / (seconds * rep.peak_flops),
                         count_s=time.perf_counter() - t))
        log(f"[roofline] {name}: model flops {model_flops:.4e}, counted {count.flops:.4e} "
            f"({count.ops} ops on meta in {rows[-1]['count_s']:.1f} s); major bytes "
            f"{count.major_bytes:.4e} (attention scores {count.score_bytes:.4e} left out), "
            f"state read and written {rep.peak_state_bytes:.4e}, eager {count.bytes:.4e}; "
            f"at the {rep.peak} peak: compute {rep.t_compute:.4f} s, "
            f"memory {rep.t_memory:.4f} s, bound {rows[-1]['bound_s']:.4f} s "
            f"({r['bottleneck']}); measured {seconds:.4f} s; model-flops share {share:.4f}, "
            f"counted-flops share {rows[-1]['counted_flops_share']:.4f}")

    def at(spec, batch, seq):
        """The LM cell's spec with its token arguments (the last) at batch x seq."""
        toks = lambda: torch.empty((batch, seq), dtype=torch.int32, device="meta")
        last = spec.args[-1]
        new = {k: toks() for k in last} if isinstance(last, dict) else toks()
        kind = spec.meta["kind"]
        meta = dict(spec.meta, seq=seq, tokens=batch * seq,
                    model_flops=base.lm_model_flops(cfg_of[kind], batch * seq, kind))
        return dataclasses.replace(spec, args=spec.args[:-1] + (new,),
                                   state=spec.state[:-1] + (new,), meta=meta)

    cfg = qwen3_4b.model_cfg()
    tcfg = dataclasses.replace(cfg, n_layers=train["layers"])
    cfg_of = {"prefill": cfg, "train": tcfg}
    B, S = lm["batch"], lm["prompt"]
    spec = base.build_lm_dryrun(cfg, "prefill_32k", one, base.Cell("prefill_32k", "prefill"))
    row(f"qwen3-4b prefill {B} x {S}", at(spec, B, S),
        float(np.median([lm["prefill_s"], lm["prefill2_s"]])))

    tokens, seq = train["tokens_per_step"], train["seq"]
    spec = base.build_lm_dryrun(tcfg, "train_4k", one, base.Cell("train_4k", "train"))
    row(f"qwen3-4b train {train['grad_accum']} x {train['micro_batch']} x {seq}",
        at(spec, tokens // seq, seq), train["step_ms_median_after_first"] / 1e3)
    del spec

    gc = next(r for r in zoo["gnn"] if r.get("arch") == "graphcast"
              and r.get("shape") == "minibatch_lg")
    row("graphcast train minibatch_lg", graphcast.ARCH.build_dryrun("minibatch_lg", one),
        gc["step_ms_median_after_first"] / 1e3)
    log("[roofline] GraphCast's model flops are the reference's per-node proxy for GNNs "
        "(6 x params x (E + N) / N): its model-flops share says nothing of the card, its "
        "counted-flops share does")
    return rows


def planning_and_examples(device, lm: dict, train: dict, zoo: dict) -> dict:
    """Phase 12: (a) the examples, timed with nothing else on the host;
    then (c)'s dry-run subprocesses started, (b) the roofline rows and (d)
    `--list` counted beside them, and (c) read."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    out = dict(examples=examples_on_card(device))
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t_plan = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s,
         "--mesh", "single", "--out", str(root / PLAN_OUT)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for a, s in PLAN_CELLS]
    try:
        t = time.perf_counter()
        with no_tf32():
            out["roofline"] = roofline_rows(lm, train, zoo)
        out["roofline_s"] = time.perf_counter() - t

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if dryrun.main(["--list"]) != 0:
                raise AssertionError("dryrun --list failed")
        listed = buf.getvalue().splitlines()
        skips = [ln for ln in listed if "SKIP: " in ln]
        log(f"[plan] --list: {len(listed)} cells, {len(skips)} skipped: " +
            "; ".join(" ".join(ln.split()[:2]) for ln in skips))
        if len(listed) != 43 or len(skips) != 4:
            raise AssertionError(f"dryrun --list: {len(listed)} cells, {len(skips)} skips")
        out["list"] = dict(cells=len(listed), skips=[" ".join(ln.split()[:2]) for ln in skips])

        results = []
        for (arch, shape), p in zip(PLAN_CELLS, procs):
            stdout, stderr = p.communicate(timeout=max(
                PLAN_TIMEOUT_S - (time.perf_counter() - t_plan), 1))
            lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT")]
            if p.returncode or len(lines) != 1:
                raise AssertionError(f"dryrun {arch} {shape}: rc {p.returncode}\n"
                                     f"{stdout[-2000:]}\n{stderr[-3000:]}")
            # grouting's serving step reads the device: state bytes only
            counted = "counted_flops=None" not in lines[0]
            if counted != (arch != "grouting"):
                raise AssertionError(f"dryrun {arch} {shape}: {lines[0]}")
            log(f"[plan] {lines[0]}")
            results.append(lines[0])
        out["dryrun"] = results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out["phase_s"] = time.perf_counter() - t0
    log(f"[plan] phase 12 in {out['phase_s']:.1f} s (roofline counts {out['roofline_s']:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the sharded paths, four gloo ranks on one card
# ---------------------------------------------------------------------------

SHARD_WORLD = 4
SHARD_TIMEOUT_S = 480  # the ranks' whole run, their start included
SHARD_DIR = "build/sharded"  # inputs the parent writes once for the ranks (git-ignored)
MOE_EP_MESHES = ((1, 4), (2, 2))  # (data, model)
MOE_EP_TOKENS = (4096, 16)  # a data shard's: FSDP weight gathers, weight-stationary (T k <= 64)
MOE_EP_TOL = 1e-5  # of each leaf's max |value|, float32, TF32 off
MOE_AUX_WEIGHT = 0.3  # the layer checks' loss: sum(out * W) + this * aux
EP_LAYER_VOCAB = 1024  # distinct token rows of the layer checks' inputs
EP_PREFILL_LAYERS = 2  # qwen2-moe-a2.7b at full width, cut from 24, drawn at 24's scale
EP_PREFILL_TOKENS = 4096
EP_PREFILL_TOL = 1e-3  # relative L2 of the last logits; above the model's own (input moved an ulp)
# the four-rank PNA forward at ogb_products' nodes and edges / this: at full
# size its forward took 153 s a rank and phase 13 346 s, past its ~200 s
PRODUCTS_CUT = 4
DIST_LOSS_RTOL = 1e-5  # a four-rank GNN loss against the world of one's or the unsharded one
# The four archs' gradient check: each at its ogb_products width, in float32
# with TF32 off on both sides (the configs' dtype), four ranks against the
# unsharded loss_fn, at a loss that is finite and ordinary. EGNN and
# GraphCast sum their messages, so a power-law hub (in-degree 601 on
# powerlaw_graph(1000, 3)) takes their losses to 2.0e8 and 2.7e31 at the
# reference's init; they run on an Erdos-Renyi graph of bounded in-degree,
# as a mesh has (EGNN's loss 6.56), and GraphCast, whose 16 residual layers
# still reach 4.5e7 there, with each processor layer's output weights drawn
# at 1 / sqrt(16) of the reference's scale, a deep residual stack's usual
# init (loss 5.50; float32 gradients 1.0e-6 of a leaf's max from float64's).
ZOO_DIST_GRAPH = dict(n=1000, m=3, seed=0)  # powerlaw_graph: PNA, EquiformerV2
ZOO_DIST_ER = dict(n=1000, avg_degree=6.0, seed=0)  # erdos_renyi_graph: the summing archs
ZOO_DIST_ON_ER = ("egnn", "graphcast")
# Of each leaf's max |gradient|, set from two readings on the card: the
# four ranks in float32 (held within) and the same ranks with TF32 matmuls,
# a control in lower precision that must land above. Each is the geometric
# mean of the largest float32 reading and the smallest control reading
# measured, rounded down to a 1-2-5 step (PERF.md). PNA's unsharded
# E[m^2] - E[m]^2 rounds most, and differently from run to run with the
# order of its atomic adds: 8.8e-5 and 6.6e-4, its control 0.163 (ROADMAP,
# the slice's hazards).
ZOO_DIST_TOL = {"pna": 1e-2, "egnn": 1e-4, "graphcast": 5e-5, "equiformer-v2": 1e-4}
GC_LEAVES = {"layers.0.attn.wk": (2560, 1024), "layers.0.attn.k_norm": (128,),
             "layers.0.ffn.w_down": (9728, 2560), "final_norm": (2560,)}  # Qwen3-4B's shapes
GC_STEPS = 2


# The LM step on a mesh: Qwen3-4B at full width cut in depth, its training
# step and prefill on (data, model) (2, 2) under LM_TRAIN_RULES, one
# sequence of 4,096 tokens a data rank (`mesh_lm_rank`).
MESH_LM_SHAPE = (2, 2)
MESH_LM_LAYERS = 2  # of Qwen3-4B's 36, drawn at 36's scale
MESH_LM_BATCH, MESH_LM_SEQ, MESH_LM_SEED = 2, 4096, 5
# m and v of each leaf's max |value| (m is the clipped gradient times 1 -
# b1), the loss and grad norm relative; the prefill's last logits of their
# max: the ranks in float32, TF32 off, against the world of one's step;
# the ranks with TF32 matmuls are a control that must land above. Each is
# the geometric mean of the largest float32 and the smallest control
# reading of the first card run, rounded down to a 1-2-5 step (PERF.md:
# 7.55e-6 / 5.04e-3 and 4.77e-6 / 1.06e-3)
MESH_LM_TOL = 1e-4
MESH_LM_LOGIT_TOL = 5e-5
MESH_LM_PEAK_TOL = 0.25  # the dry run's reckoned peak against max_memory_allocated

# The decode step on a mesh: the same model on (2, 2) under LM_DECODE_RULES
# (the cache's positions over "model", its kv heads whole), the cache of
# decode_32k's length filled by the world of one's float32 prefill
# (`mesh_decode_ref`), MESH_DECODE_STEPS steps a rank (`mesh_decode_rank`).
MESH_DECODE_BATCH = 4  # two rows a data rank
MESH_DECODE_SMAX = 32768  # decode_32k's length: 16,384 positions a model rank
MESH_DECODE_PROMPT = 16382  # the steps write 16,382-16,385: model rank 0 two, rank 1 two
MESH_DECODE_STEPS = 4
# Each rank's vocab block of the logits, of their max; its written cache
# slots, of their max: the ranks in float32, TF32 off, against the world of
# one's `Transformer.serve_step` on the same cache and tokens; the ranks
# with TF32 matmuls are a control that must land above. Each is the
# geometric mean of the largest float32 and the smallest control reading
# of the first card run, rounded down to a 1-2-5 step (PERF.md: 1.16e-6 /
# 1.12e-3 and 9.45e-7 / 8.51e-4)
MESH_DECODE_TOL = 2e-5
MESH_DECODE_SLOT_TOL = 2e-5


def spawn_ranks(fn, world: int, args, timeout: float) -> list:
    """fn(rank, world, *args) in `world` spawned processes; their results
    by rank. A rank's exception, a rank that dies, or no result from every
    rank within `timeout` seconds (a hung collective) stops every rank and
    raises."""
    import queue

    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, args, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, done = [None] * world, False
    deadline = time.monotonic() + timeout
    try:
        for _ in range(world):
            while True:
                try:
                    rank, res, err = out.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"{fn.__name__}: a rank exited with {dead[0]}")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{fn.__name__}: no result from every rank in "
                                           f"{timeout} s")
            if err:
                raise RuntimeError(f"{fn.__name__}, rank {rank}:\n{err}")
            results[rank] = res
        done = True
    finally:
        for p in procs:
            if not done:
                p.kill()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return results


def _rank_main(fn, rank, world, args, out):
    import traceback

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    try:
        out.put((rank, fn(rank, world, *args), None))
    except BaseException:  # reported to the parent, which stops every rank
        out.put((rank, None, traceback.format_exc()))


def _leaf_errors(got: dict, want: dict) -> dict:
    """{leaf: max |got - want| / max |want|}."""
    return {k: float((got[k].double() - want[k].double()).abs().max()
                     / want[k].double().abs().max().clamp(min=1e-30)) for k in want}


def ep_capacity(router, x_blocks, mc) -> int:
    """A drop-free capacity that no larger one is needed for: the busiest
    expert's assignments over the blocks routed apart, rounded up to 8."""
    from repro_torch.models.moe import route

    busiest = 0
    for x in x_blocks:
        counts = torch.bincount(route(router, x, mc, 1).idx.reshape(-1), minlength=mc.n_experts)
        busiest = max(busiest, int(counts.max()))
    return -(-busiest // 8) * 8


def ep_layer_case(full, mc, mesh, shape, T_loc, factor, dev) -> dict:
    """One expert-parallel MoE layer case on this rank: forward and backward
    of sum(out * W) + MOE_AUX_WEIGHT aux at `mesh`, against the
    single-device `moe_routed` of the same full tree over the same routing
    groups (each data shard's tokens, or all of them in the
    weight-stationary regime, whose capacity spans the shards); returns
    the worst error by leaf, the capacity and the dropped share. The
    tokens are Zipf-repeated rows: random normal ones route evenly, and
    at factor 1.25 none drop."""
    from repro_torch.distributed.mesh_utils import local_shard, set_mesh_rules
    from repro_torch.models.moe import (aux_loss, expert_capacity, moe_ffn,
                                        moe_ffn_expert_parallel, moe_local_params, moe_routed,
                                        moe_shard_specs)

    from repro_torch.data.tokens import token_batch

    n_data = shape[0]
    g = torch.Generator(device=dev).manual_seed(T_loc + 7)
    # tokens that repeat as a prompt's do (Zipf ids over EP_LAYER_VOCAB
    # rows, a little noise): repeats route alike, so factor 1.25 drops
    ids = torch.from_numpy(token_batch(0, 1, T_loc * n_data, EP_LAYER_VOCAB)["tokens"])
    rows = torch.randn(EP_LAYER_VOCAB, mc.d_model, generator=g, device=dev)
    x = rows[ids.view(-1).long().to(dev)] + 0.01 * torch.randn(
        T_loc * n_data, mc.d_model, generator=g, device=dev)
    w = torch.randn(T_loc * n_data, mc.d_model, generator=g, device=dev)
    blocks = list(x.chunk(n_data))
    ws = T_loc * mc.top_k <= 64
    groups = [x] if ws else blocks  # what one rank routes together
    if factor is None:  # a weight-stationary rank's capacity spans the data shards
        cap = -(-ep_capacity(full["router"], groups, mc) // (n_data if ws else 1))
    else:
        cap = expert_capacity(T_loc, mc)
    ref_cap = cap * n_data if ws else cap

    # single device over the same routing groups
    leaves = {k: v.detach().clone().requires_grad_() for k, v in _flat_list(full).items()}
    tree = _unflat(leaves, full)
    outs, dxs, dropped, assigned = [], [], 0, 0
    for xi, wi in zip(groups, [w] if ws else list(w.chunk(n_data))):
        xi = xi.clone().requires_grad_()
        o, r = moe_routed(tree, xi, mc, ref_cap)
        (torch.sum(o * wi) + MOE_AUX_WEIGHT * aux_loss(r) / len(groups)).backward()
        outs.append(o.detach())
        dxs.append(xi.grad)
        dropped += int((~r.keep).sum())
        assigned += r.keep.numel()
    out_ref, dx_ref = torch.cat(outs), torch.cat(dxs)
    specs = moe_shard_specs(mc, mesh)
    want = {k: local_shard(v.grad, _spec_of(specs, k), mesh) for k, v in leaves.items()}
    tok = (("data",), None)
    want["out"] = local_shard(out_ref, tok, mesh)
    want["x"] = local_shard(dx_ref, tok, mesh)
    del leaves, tree, outs, dxs, out_ref, dx_ref

    # expert parallel
    local = {k: v.requires_grad_() for k, v in _flat_list(moe_local_params(full, mc, mesh)).items()}
    x_loc = local_shard(x, tok, mesh).requires_grad_()
    if shape[1] > 1:  # through `moe_ffn`'s switch, as a caller reaches it
        with set_mesh_rules(mesh):
            o, aux = moe_ffn(_unflat(local, full), x_loc, mc, capacity=cap)
    else:  # a world of one: the switch needs a model axis above 1, so called directly
        o, r = moe_ffn_expert_parallel(_unflat(local, full), x_loc, mc, mesh, cap)
        aux = r.aux
    (torch.sum(o * local_shard(w, tok, mesh)) + MOE_AUX_WEIGHT * aux).backward()
    got = {k: v.grad for k, v in local.items()}
    got["out"], got["x"] = o.detach(), x_loc.grad
    errs = _leaf_errors(got, want)
    return dict(mesh=list(shape), tokens_a_shard=T_loc, regime="weight-stationary" if ws else
                "FSDP gathers", capacity=cap, capacity_factor=factor,
                dropped_share=dropped / assigned, worst=max(errs.values()),
                worst_leaf=max(errs, key=errs.get), finite=bool(torch.isfinite(o).all()))


def _flat_list(tree, prefix=""):
    """A tree of dicts and lists -> {"a/0/b": leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat_list(v, f"{prefix}{k}/"))
    return out


def _unflat(flat, like, prefix=""):
    return {k: _unflat(flat, v, f"{prefix}{k}/") if isinstance(v, dict) else flat[prefix + k]
            for k, v in like.items()}


def _spec_of(specs, path):
    node = specs
    for part in path.split("/"):
        node = node[part]
    return node


def moe_layer_full(dev):
    """(qwen2-moe-a2.7b's MoE config in float32, one layer's full tree drawn
    on `dev` from a seeded generator: the same on every rank). Drawn as the
    layer is inside the model (`draw_params`): the reference draws a stacked
    leaf with std 1 / sqrt(n_groups), 1 / sqrt(24) here, which routes
    peakedly enough for factor 1.25 to drop (PERF.md, the MoE cells)."""
    from repro_torch.configs import qwen2_moe_a2_7b
    from repro_torch.models.moe import moe_param_specs
    from repro_torch.models.param import init_params, tree_map

    cfg = qwen2_moe_a2_7b.model_cfg()
    mc = dataclasses.replace(cfg.moe_cfg(), dtype=torch.float32)
    scale = float(1.0 / np.sqrt(cfg.n_groups))
    specs = tree_map(lambda p: dataclasses.replace(p, scale=scale)
                     if p.init == "normal" and p.scale is None else p, moe_param_specs(mc))
    return mc, init_params(specs, torch.Generator(device=dev).manual_seed(5), dev)


def ep_prefill_cfg():
    """(qwen2-moe-a2.7b cut to EP_PREFILL_LAYERS in float32, drop-free at
    capacity factor E / k, its full depth)."""
    from repro_torch.configs import qwen2_moe_a2_7b

    cfg = qwen2_moe_a2_7b.model_cfg()
    return dataclasses.replace(cfg, n_layers=EP_PREFILL_LAYERS, dtype=torch.float32,
                               capacity_factor=cfg.n_experts / cfg.top_k), cfg.n_layers


def ep_prefill_tokens(cfg, dev):
    from repro_torch.data.tokens import token_batch

    return torch.from_numpy(token_batch(0, 1, EP_PREFILL_TOKENS, cfg.vocab)["tokens"]).to(dev)


def gc_grads(step: int, rank: int) -> dict:
    """A rank's gradients at Qwen3-4B's shapes (CPU, float32), as data-parallel
    gradients are: a part common to every rank plus the rank's own, a tenth
    its size."""
    out = {}
    for i, (k, shape) in enumerate(GC_LEAVES.items()):
        common = torch.Generator().manual_seed(1000 * step + i)
        own = torch.Generator().manual_seed(1000 * step + i + 100 * (rank + 1))
        out[k] = 0.01 * (torch.randn(shape, generator=common) +
                         0.1 * torch.randn(shape, generator=own))
    return out


def sharded_rank(rank: int, world: int, shard_dir: str, device_type: str,
                 grouting_dir: str) -> dict:
    """One of the phase's four ranks: gloo on `device_type` ("cuda": every
    rank on cuda:0). In order, every rank alike: the gloo route on the
    device's tensors (float32 and bf16), the LM step on the (2, 2) mesh
    (`mesh_lm_rank`), the decode step on it (`mesh_decode_rank`), DIN on it
    (`mesh_din_rank`), the expert-parallel MoE layer cases, the
    expert-parallel prefill, the PNA forward at the cut ogb_products size,
    the four archs' losses and gradients on the cut graph, compressed_psum
    over a "pod" axis, and last the grouting configuration served over the
    mesh from the graph under `grouting_dir` (`grouting_mesh_rank`).
    Returns figures only (no tensor crosses back but the prefill's last
    logits and the grouting records)."""
    import torch.distributed as dist

    from repro_torch.distributed.mesh import ProcessMesh, init_mesh
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if device_type == "cuda":
        build.load_library()  # the parent built it: the same sources, found by hash
    store = dist.FileStore(os.path.join(shard_dir, "store"), world)
    mesh, dev = init_mesh((2, 2), ("data", "model"), device_type, backend="gloo", store=store,
                          rank=rank, world_size=world)
    meshes = {(2, 2): mesh, (1, 4): ProcessMesh((1, 4), ("data", "model")),
              "pod": ProcessMesh((world,), ("pod",))}
    out = {"start_s": time.perf_counter() - t0}

    # gloo on this device's tensors: the collectives the port calls, checked
    x = torch.arange(2 * world, dtype=torch.float32, device=dev) + 100 * rank
    a2a = torch.empty_like(x)
    dist.all_to_all_single(a2a, x)
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    red = x.clone()
    dist.all_reduce(red)
    want_a2a = torch.cat([torch.arange(2 * rank, 2 * rank + 2, dtype=torch.float32) + 100 * s
                          for s in range(world)])
    if not (torch.equal(a2a.cpu(), want_a2a) and
            torch.equal(torch.stack(parts).cpu()[:, 0], 100.0 * torch.arange(world)) and
            torch.equal(red.cpu(), (torch.arange(2 * world) * world + 100 * sum(range(world)))
                        .float())):
        raise AssertionError(f"rank {rank}: gloo on {dev} tensors gave wrong results")
    # and bf16, which the mesh LM's timed step moves: sums, the loss head's max
    xb = (torch.arange(2 * world, device=dev) + rank).to(torch.bfloat16)
    redb, maxb, a2ab = xb.clone(), xb.clone(), torch.empty_like(xb)
    dist.all_reduce(redb)
    dist.all_reduce(maxb, op=dist.ReduceOp.MAX)
    dist.all_to_all_single(a2ab, xb)
    partsb = [torch.empty_like(xb) for _ in range(world)]
    dist.all_gather(partsb, xb)
    ar = torch.arange(2 * world)
    if not (torch.equal(redb.float().cpu(), (ar * world + sum(range(world))).float()) and
            torch.equal(maxb.float().cpu(), (ar + world - 1).float()) and
            torch.equal(torch.stack(partsb).float().cpu()[:, 0], torch.arange(world).float()) and
            torch.equal(a2ab.float().cpu(), torch.cat([torch.arange(2 * rank, 2 * rank + 2) + s
                                                       for s in range(world)]).float())):
        raise AssertionError(f"rank {rank}: gloo on {dev} bf16 tensors gave wrong results")
    out["route"] = dict(backend=dist.get_backend(), tensors=str(dev.type),
                        all_to_all_single="ok", all_gather="ok", all_reduce="ok",
                        bf16="ok (sum, max, all_gather, all_to_all_single)",
                        staged_through_host_by_the_port=False)

    # the LM step on the mesh, first: it needs the most of the card
    out["lm_mesh"] = mesh_lm_rank(mesh, dev, rank, shard_dir)
    _empty_cache(dev)
    out["decode_mesh"] = mesh_decode_rank(mesh, dev, rank, shard_dir)
    _empty_cache(dev)
    out["din_mesh"] = mesh_din_rank(mesh, dev, rank, shard_dir)
    _empty_cache(dev)

    # expert-parallel MoE layer at qwen2-moe's full width
    t = time.perf_counter()
    mc, full = moe_layer_full(dev)
    out["moe_layer"] = [ep_layer_case(full, mc, meshes[shape], shape, T_loc, factor, dev)
                        for shape in MOE_EP_MESHES for T_loc in MOE_EP_TOKENS
                        for factor in (None, mc.capacity_factor)]
    del full
    out["moe_layer_s"] = time.perf_counter() - t
    _empty_cache(dev)

    # the expert-parallel prefill at (1, 4): the main path of the phase
    out["prefill"] = ep_prefill_rank(meshes[(1, 4)], dev, rank)
    _empty_cache(dev)
    out["pna"] = pna_rank(mesh, dev, shard_dir)
    _empty_cache(dev)
    out["zoo"] = zoo_dist_rank(mesh, dev, shard_dir)
    _empty_cache(dev)
    out["compression"] = gc_rank(meshes["pod"], dev, rank)
    _empty_cache(dev)
    out["grouting"] = grouting_mesh_rank(mesh, dev, rank, grouting_dir)
    if dev.type == "cuda":
        out["peak_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["peak_reserved_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
    out["wall_s"] = time.perf_counter() - t0
    dist.barrier()
    dist.destroy_process_group()
    return out


class _RankOf:
    """A (data, model) mesh of `MESH_LM_SHAPE` seen from one rank, enough
    for `local_shard` in a process with no process group."""

    def __init__(self, rank: int):
        self.shape = dict(zip(("data", "model"), MESH_LM_SHAPE))
        self._coords = {"data": rank // MESH_LM_SHAPE[1], "model": rank % MESH_LM_SHAPE[1]}

    def axis_size(self, name):
        names = (name,) if isinstance(name, str) else name
        return int(np.prod([self.shape[a] for a in names]))

    def axis_index(self, name):
        idx = 0
        for a in ((name,) if isinstance(name, str) else name):
            idx = idx * self.shape[a] + self._coords[a]
        return idx


def mesh_lm_cfg(dtype):
    """(Qwen3-4B cut to MESH_LM_LAYERS in `dtype`, its full depth)."""
    from repro_torch.configs import qwen3_4b

    full = qwen3_4b.model_cfg()
    return dataclasses.replace(full, n_layers=MESH_LM_LAYERS, dtype=dtype), full.n_layers


def mesh_lm_layout(cfg, mesh):
    from repro_torch.configs.base import LM_TRAIN_RULES, merged_rules
    from repro_torch.models.transformer import MeshLayout

    return MeshLayout(cfg, mesh, merged_rules(LM_TRAIN_RULES))


def mesh_lm_batch():
    from repro_torch.data.tokens import token_batch

    cfg, _ = mesh_lm_cfg(torch.float32)
    return {k: torch.as_tensor(v) for k, v in
            token_batch(0, MESH_LM_BATCH, MESH_LM_SEQ, cfg.vocab, seed=MESH_LM_SEED).items()}


def mesh_lm_ref(device, shard_dir) -> dict:
    """The world of one's float32 step (TF32 off, warmup 0: the base
    learning rate) of the mesh path's model and batch, and its prefill's
    last logits on the parameters before the step. Each rank's blocks of
    m and of the logits go to a file a rank under `shard_dir`, with the
    loss, grad norm and learning rate."""
    from repro_torch.configs.base import LM_TRAIN_RULES, merged_rules
    from repro_torch.distributed.mesh_utils import LogicalRules, local_shard, resolve_pspec
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import transformer as T
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg, depth = mesh_lm_cfg(torch.float32)
    t0 = time.perf_counter()
    params = draw_params(cfg, device, depth, seed=MESH_LM_SEED)
    batch = {k: v.to(device) for k, v in mesh_lm_batch().items()}
    with torch.no_grad():
        last, kvs = T.Transformer(dataclasses.replace(cfg, remat=False), params=params,
                                  device=device).prefill_forward(batch["tokens"])
        del kvs
    state = init_train_state(params)
    del params
    step = make_train_step(lambda p, b: T.loss_fn(p, b, cfg), warmup=0, total_steps=10)
    _sync(device)
    t = time.perf_counter()
    state, met = step(state, batch)
    _sync(device)
    step_s = time.perf_counter() - t
    lr = LogicalRules(MeshShape(("data", "model"), MESH_LM_SHAPE),
                      merged_rules(LM_TRAIN_RULES))
    specs = _flat_list(T.lm_local_pspecs(cfg, lr))
    m = _flat_list(state.opt_state["m"])
    del state
    head = dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]), lr=float(met["lr"]))
    last_spec = resolve_pspec(("batch", "vocab"), tuple(last.shape), lr)
    for r in range(SHARD_WORLD):
        at = _RankOf(r)
        torch.save(dict(head, m={k: local_shard(v, specs[k], at).cpu() for k, v in m.items()},
                        last=local_shard(last, last_spec, at).cpu()),
                   os.path.join(shard_dir, f"lm_mesh_{r}.pt"))
    del m
    _empty_cache(device)
    return dict(head, step_s=step_s, s=time.perf_counter() - t0,
                params=sum(int(np.prod(s.shape)) for s in _flat_list(
                    T.lm_param_specs(cfg)).values()))


def mesh_lm_reckoned() -> dict:
    """The dry run's rule for the timed bf16 step of a rank (`count_step`
    per rank on meta tensors, as rank 0 of a fake world of 4): the rank's
    state bytes, the temporaries' peak and their sum."""
    from repro_torch.analysis.roofline import count_step
    from repro_torch.distributed.mesh_utils import local_shard, resolve_pspec
    from repro_torch.launch.dryrun import fake_process_mesh, tensors
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import transformer as T
    from repro_torch.models.param import abstract_params, local_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.train_step import TrainState, make_train_step, trainable

    cfg, _ = mesh_lm_cfg(torch.bfloat16)
    t = time.perf_counter()
    with fake_process_mesh(MeshShape(("data", "model"), MESH_LM_SHAPE)) as mesh:
        lay = mesh_lm_layout(cfg, mesh)
        params = trainable(local_params(T.unstack_layers(abstract_params(T.lm_param_specs(cfg)),
                                                         cfg), lay.specs, mesh))
        state = TrainState(params, adamw_init(params),
                           torch.empty((), dtype=torch.int32, device="meta"))
        spec = resolve_pspec(("batch", "seq"), (MESH_LM_BATCH, MESH_LM_SEQ), lay.lr)
        tok = torch.empty((MESH_LM_BATCH, MESH_LM_SEQ), dtype=torch.int32, device="meta")
        batch = {k: local_shard(tok, spec, mesh) for k in ("tokens", "labels")}
        step = make_train_step(lambda p, b: T.loss_fn(p, b, cfg, lay), warmup=0,
                               total_steps=10, mesh=mesh, specs=lay.specs)
        _, count = count_step(step, (state, batch), score_dims=(MESH_LM_SEQ, MESH_LM_SEQ),
                              per_rank=True)
        state_bytes = sum(x.numel() * x.element_size() for x in tensors((state, batch)))
    return dict(state_bytes=state_bytes, temp_bytes=count.temp_bytes,
                peak_bytes=state_bytes + count.temp_bytes, collective_bytes=count.collective_bytes,
                collectives=count.collectives, flops=count.flops, s=time.perf_counter() - t)


def _flash_routes(events) -> dict:
    """Flash launches in a profile by route: forward kernels, and backward
    launches by their dQ pass (one a launch)."""
    names = [n for n, _, _ in events]
    return {"fwd_tc": sum("flash_attention_kernel_tc<" in n for n in names),
            "fwd_f32": sum("flash_attention_kernel<" in n for n in names),
            "bwd_tc": sum("flash_bwd_dq_kernel_tc<" in n for n in names),
            "bwd_f32": sum("flash_bwd_dq_kernel<" in n for n in names)}


def mesh_lm_rank(mesh, dev, rank, shard_dir) -> dict:
    """The LM step on the mesh, this rank's part: Qwen3-4B at full width
    cut to MESH_LM_LAYERS, its shards (`local_params` of the same draw as
    the world of one's) and its sequence of the batch. In float32, TF32
    off: one training step (warmup 0), its m and v against the world of
    one's (`mesh_lm_ref`: v from its m), the parameters against one AdamW
    step of the world of one's m from the same shards (within 2 lr, an
    Adam step's reach on a gradient whose sign rounding turns), the loss
    and grad norm; the prefill's last logits on the shards before the
    step. Then the TF32 control of both, its step profiled (the float32
    route's kernels). In bf16: a warm step, a timed step (the flash
    launches counted from 0 around it, CUDA events and the wall,
    max_memory_allocated after the peak stats are reset) and a profiled
    step (the tensor-core route's kernels)."""
    import torch.distributed as dist

    from repro_torch.distributed.mesh_utils import local_shard, resolve_pspec
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.models import transformer as T
    from repro_torch.models.param import local_params, tree_map
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    t0 = time.perf_counter()
    cfg, depth = mesh_lm_cfg(torch.float32)
    lay = mesh_lm_layout(cfg, mesh)
    ref = torch.load(os.path.join(shard_dir, f"lm_mesh_{rank}.pt"), weights_only=False)
    p0 = local_params(draw_params(cfg, dev, depth, seed=MESH_LM_SEED), lay.specs, mesh)
    _empty_cache(dev)
    tok_spec = resolve_pspec(("batch", "seq"), (MESH_LM_BATCH, MESH_LM_SEQ), lay.lr)
    batch = {k: local_shard(v, tok_spec, mesh).to(dev) for k, v in mesh_lm_batch().items()}
    opt = AdamWConfig()

    def step_once(tf32: bool, profile: bool = False):
        state = init_train_state(tree_map(lambda a: a.clone(), p0))
        step = make_train_step(lambda p, b: T.loss_fn(p, b, cfg, lay), opt, warmup=0,
                               total_steps=10, mesh=mesh, specs=lay.specs)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        LAUNCHES.clear()
        out, events = [], None
        try:
            if profile:
                events = _device_events(lambda: out.append(step(state, batch)))
            else:
                out.append(step(state, batch))
                _sync(dev)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        return out[0][0], out[0][1], dict(LAUNCHES), events

    def held(state, met) -> dict:
        """Each leaf's error against the world of one's: m and v of the
        leaf's max, the parameters in absolute terms."""
        m, v, p = (_flat_list(t) for t in (state.opt_state["m"], state.opt_state["v"],
                                            state.params))
        lr, em, ev, ep, over, n = ref["lr"], {}, {}, 0.0, 0, 0
        start = _flat_list(p0)
        for k, m_ref in ref["m"].items():
            m_ref = m_ref.to(dev)
            g = m_ref / (1 - opt.b1)
            v_ref = (1 - opt.b2) * g * g
            q0 = start[k].float()
            upd = (m_ref / (1 - opt.b1)) / (torch.sqrt(v_ref / (1 - opt.b2)) + opt.eps)
            p_ref = q0 - lr * (upd + opt.weight_decay * q0)
            em[k] = float((m[k] - m_ref).abs().max() / m_ref.abs().max().clamp(min=1e-30))
            ev[k] = float((v[k] - v_ref).abs().max() / v_ref.abs().max().clamp(min=1e-30))
            d = (p[k].detach().float() - p_ref).abs()
            ep, over, n = max(ep, float(d.max())), over + int((d > 1e-6).sum()), n + d.numel()
        return dict(m=max(em.values()), m_leaf=max(em, key=em.get), v=max(ev.values()),
                    loss=abs(float(met["loss"]) - ref["loss"]) / abs(ref["loss"]),
                    grad_norm=abs(float(met["grad_norm"]) - ref["grad_norm"]) / ref["grad_norm"],
                    params_max_abs=ep, params_tol=2 * lr + 1e-6, params_share_over_1e6=over / n)

    t = time.perf_counter()
    state, met, f32_launches, _ = step_once(False)
    f32 = held(state, met)
    f32_s = time.perf_counter() - t
    del state
    state, met, _, events = step_once(True, profile=True)
    control = held(state, met)
    f32_routes = _flash_routes(events)
    del state, events
    icfg = dataclasses.replace(cfg, remat=False)
    ilay = mesh_lm_layout(icfg, mesh)
    ref_last = ref["last"].to(dev)
    logit_err = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            last, kvs = T.prefill_forward(p0, batch["tokens"], icfg, ilay)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        logit_err[tf32] = float((last - ref_last).abs().max() / ref_last.abs().max())
        del last, kvs
    del p0, ref, ref_last
    _empty_cache(dev)

    # the timed step, bf16
    cfg16, _ = mesh_lm_cfg(torch.bfloat16)
    lay16 = mesh_lm_layout(cfg16, mesh)
    state = init_train_state(local_params(draw_params(cfg16, dev, depth, seed=MESH_LM_SEED),
                                          lay16.specs, mesh))
    _empty_cache(dev)
    step = make_train_step(lambda p, b: T.loss_fn(p, b, cfg16, lay16), opt, warmup=0,
                           total_steps=10, mesh=mesh, specs=lay16.specs)
    state, _ = step(state, batch)  # warm
    _sync(dev)
    dist.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    LAUNCHES.clear()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    state, met = step(state, batch)
    stop.record()
    _sync(dev)
    wall_ms = (time.perf_counter() - t) * 1e3
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    loss16 = float(met["loss"])
    dist.barrier()
    events = _device_events(lambda: step(state, batch))
    bf16_routes = _flash_routes(events)
    del state, events
    _empty_cache(dev)
    return dict(f32=f32, control=control, f32_s=f32_s, f32_launches=f32_launches,
                f32_routes=f32_routes, logits=logit_err[False], logits_control=logit_err[True],
                launches=launches, bf16_routes=bf16_routes, step_ms=start.elapsed_time(stop),
                wall_ms=wall_ms, loss_bf16=loss16, peak_allocated=peak, allocated_before=before,
                s=time.perf_counter() - t0)


def mesh_decode_layout(cfg, mesh):
    from repro_torch.configs.base import LM_DECODE_RULES, merged_rules
    from repro_torch.models.transformer import MeshLayout

    return MeshLayout(cfg, mesh, merged_rules(LM_DECODE_RULES))


def mesh_decode_inputs(vocab: int):
    """(the prompt (MESH_DECODE_BATCH, MESH_DECODE_PROMPT), each step's
    tokens (MESH_DECODE_STEPS, MESH_DECODE_BATCH, 1)), int64 on the CPU."""
    from repro_torch.data.tokens import token_batch

    prompt = token_batch(0, MESH_DECODE_BATCH, MESH_DECODE_PROMPT, vocab,
                         seed=MESH_LM_SEED)["tokens"]
    steps = np.random.default_rng(MESH_LM_SEED).integers(
        0, vocab, (MESH_DECODE_STEPS, MESH_DECODE_BATCH, 1))
    return torch.as_tensor(prompt, dtype=torch.int64), torch.as_tensor(steps)


def mesh_decode_ref(device, shard_dir) -> dict:
    """The world of one's side of the decode step on a mesh, in float32:
    `Transformer.prefill_forward` of the prompt (its flash launches
    counted: the path's only kernel launches), `cache_from_prefill` into a
    cache of MESH_DECODE_SMAX positions, each rank's block of it to a file
    a rank under `shard_dir` (`local_shard` by `kv_cache_pspecs`), then
    MESH_DECODE_STEPS steps of `Transformer.serve_step`: each rank's block
    of each step's logits and its rows of each step's written slots go to
    the same file."""
    from repro_torch.configs.base import LM_DECODE_RULES, merged_rules
    from repro_torch.distributed.mesh_utils import LogicalRules, local_shard, resolve_pspec
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import transformer as T

    cfg, depth = mesh_lm_cfg(torch.float32)
    cfg = dataclasses.replace(cfg, remat=False)
    t0 = time.perf_counter()
    model = T.Transformer(cfg, params=draw_params(cfg, device, depth, seed=MESH_LM_SEED),
                          device=device)
    prompt, steps = mesh_decode_inputs(cfg.vocab)
    _sync(device)
    LAUNCHES.clear()
    t = time.perf_counter()
    with torch.no_grad():
        _, kvs = model.prefill_forward(prompt.to(device))
    _sync(device)
    prefill_s = time.perf_counter() - t
    launches = dict(LAUNCHES)
    cache = cache_from_prefill(model, kvs, MESH_DECODE_BATCH, MESH_DECODE_SMAX,
                               MESH_DECODE_PROMPT)
    del kvs
    lr = LogicalRules(MeshShape(("data", "model"), MESH_LM_SHAPE),
                      merged_rules(LM_DECODE_RULES))
    kv_spec = T.kv_cache_pspecs(cfg, MESH_DECODE_BATCH, MESH_DECODE_SMAX, lr)["layers"][0]["k"]
    logit_spec = resolve_pspec(("batch", "vocab"), (MESH_DECODE_BATCH, cfg.vocab), lr)
    slot_spec = (None, kv_spec[0], None, None)  # (layer, B, Hkv, Dh): the rank's rows
    files = [{n: [local_shard(layer[n], kv_spec, _RankOf(r)).cpu() for layer in cache["layers"]]
              for n in ("k", "v")} for r in range(SHARD_WORLD)]
    logits, slots, step_s = [], [], []
    for i in range(MESH_DECODE_STEPS):
        t = time.perf_counter()
        lg, cache = model.serve_step(cache, steps[i].to(device))
        _sync(device)
        step_s.append(time.perf_counter() - t)
        p = MESH_DECODE_PROMPT + i
        logits.append(lg)
        slots.append({n: torch.stack([layer[n][:, :, p] for layer in cache["layers"]])
                      for n in ("k", "v")})
    for r, f in enumerate(files):
        at = _RankOf(r)
        f.update(steps=steps, kv_spec=kv_spec,
                 logits=[local_shard(lg, logit_spec, at).cpu() for lg in logits],
                 slots=[{n: local_shard(x[n], slot_spec, at).cpu() for n in x} for x in slots])
        torch.save(f, os.path.join(shard_dir, f"decode_mesh_{r}.pt"))
    del model, cache, files
    _empty_cache(device)
    return dict(prefill_s=prefill_s, launches=launches, step_s=step_s,
                s=time.perf_counter() - t0)


def mesh_decode_reckoned() -> dict:
    """The dry run's rule for a rank's bf16 decode step (`count_step` per
    rank on meta tensors, as rank 0 of a fake world of 4): the rank's state
    bytes (its shards, its block of the cache, its rows), the temporaries'
    peak and their sum, its collectives."""
    from repro_torch.analysis.roofline import count_step
    from repro_torch.distributed.mesh_utils import local_shard, resolve_pspec
    from repro_torch.launch.dryrun import fake_process_mesh, tensors
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import transformer as T
    from repro_torch.models.param import abstract_params, local_params

    cfg, _ = mesh_lm_cfg(torch.bfloat16)
    cfg = dataclasses.replace(cfg, remat=False)
    t = time.perf_counter()
    with fake_process_mesh(MeshShape(("data", "model"), MESH_LM_SHAPE)) as mesh:
        lay = mesh_decode_layout(cfg, mesh)
        params = local_params(T.unstack_layers(abstract_params(T.lm_param_specs(cfg)), cfg),
                              lay.specs, mesh)
        kv = T.local_kv_cache(cfg, MESH_DECODE_BATCH, MESH_DECODE_SMAX, lay, device="meta")
        for layer in kv["layers"]:
            layer["pos"] = MESH_DECODE_PROMPT
        tok = torch.empty((MESH_DECODE_BATCH, 1), dtype=torch.int64, device="meta")
        tok = local_shard(tok, resolve_pspec(("batch", None), (MESH_DECODE_BATCH, 1), lay.lr),
                          mesh)
        _, count = count_step(lambda: T.serve_step(params, kv, tok, cfg, lay), (),
                              per_rank=True)
        state_bytes = sum(x.numel() * x.element_size() for x in tensors((params, kv, tok)))
    return dict(state_bytes=state_bytes, temp_bytes=count.temp_bytes,
                peak_bytes=state_bytes + count.temp_bytes, collective_bytes=count.collective_bytes,
                collective_bytes_by_kind=dict(count.collective_bytes_by_kind),
                collectives=count.collectives, flops=count.flops, s=time.perf_counter() - t)


def mesh_decode_rank(mesh, dev, rank, shard_dir) -> dict:
    """The decode step on the mesh, this rank's part: its shards of the
    same draw as the world of one's (`local_params` under LM_DECODE_RULES),
    its block of the prefilled cache and its rows of each step's tokens.
    In float32, TF32 off, MESH_DECODE_STEPS steps from the prefilled
    block: each step's logits against the world of one's (their max), its
    written slots against the world of one's (their max), the rest of its
    block unchanged; again with TF32 matmuls (the control). Then bf16: a
    warm step and MESH_DECODE_STEPS timed steps, each step's wall on the
    host's clock (perf_counter, after a sync) and by CUDA events,
    max_memory_allocated after the peak stats are reset."""
    import torch.distributed as dist

    from repro_torch.distributed.mesh_utils import local_shard, resolve_pspec
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.models import transformer as T
    from repro_torch.models.param import local_params

    t0 = time.perf_counter()
    cfg, depth = mesh_lm_cfg(torch.float32)
    cfg = dataclasses.replace(cfg, remat=False)
    lay = mesh_decode_layout(cfg, mesh)
    ref = torch.load(os.path.join(shard_dir, f"decode_mesh_{rank}.pt"), weights_only=False)
    if tuple(ref["kv_spec"]) != T.kv_cache_pspecs(cfg, MESH_DECODE_BATCH, MESH_DECODE_SMAX,
                                                  lay.lr)["layers"][0]["k"]:
        raise AssertionError(f"the world of one cut the cache as {ref['kv_spec']}")
    p0 = local_params(draw_params(cfg, dev, depth, seed=MESH_LM_SEED), lay.specs, mesh)
    _empty_cache(dev)
    tok_spec = resolve_pspec(("batch", None), (MESH_DECODE_BATCH, 1), lay.lr)
    steps = [local_shard(s, tok_spec, mesh).to(dev) for s in ref["steps"]]
    init = [{n: ref[n][li].to(dev) for n in ("k", "v")} for li in range(cfg.n_layers)]
    S_loc = init[0]["k"].shape[2]
    lo = lay.kv_block * S_loc
    # this block's written positions, a run [a, b) of local ones
    mine = [(i, p - lo) for i, p in enumerate(range(MESH_DECODE_PROMPT,
                                                     MESH_DECODE_PROMPT + MESH_DECODE_STEPS))
            if lo <= p < lo + S_loc]
    a, b = (mine[0][1], mine[-1][1] + 1) if mine else (S_loc, S_loc)

    def run(tf32: bool):
        cache = {"layers": [{"k": x["k"].clone(), "v": x["v"].clone(),
                             "pos": MESH_DECODE_PROMPT} for x in init]}
        logits = []
        torch.backends.cuda.matmul.allow_tf32 = tf32
        LAUNCHES.clear()
        try:
            for s in steps:
                lg, cache = T.serve_step(p0, cache, s, cfg, lay)
                logits.append(lg)
            _sync(dev)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        launched = dict(LAUNCHES)
        lerr = max(float((lg - want.to(dev)).abs().max() / want.abs().max())
                   for lg, want in zip(logits, ref["logits"]))
        serr, unchanged = 0.0, True
        for li, (layer, x) in enumerate(zip(cache["layers"], init)):
            for n in ("k", "v"):
                unchanged &= bool(torch.equal(layer[n][:, :, :a], x[n][:, :, :a]) and
                                  torch.equal(layer[n][:, :, b:], x[n][:, :, b:]))
                for i, j in mine:
                    want = ref["slots"][i][n][li].to(dev)
                    serr = max(serr, float((layer[n][:, :, j] - want).abs().max() /
                                           want.abs().max()))
        del cache
        return dict(logits=lerr, slots=serr, unchanged=unchanged, launches=launched,
                    finite=all(bool(torch.isfinite(lg).all()) for lg in logits))

    t = time.perf_counter()
    f32 = run(False)
    f32_s = time.perf_counter() - t
    control = run(True)
    del p0, init
    _empty_cache(dev)

    # the timed steps, bf16, from the same cache cast
    cfg16 = dataclasses.replace(mesh_lm_cfg(torch.bfloat16)[0], remat=False)
    lay16 = mesh_decode_layout(cfg16, mesh)
    p16 = local_params(draw_params(cfg16, dev, depth, seed=MESH_LM_SEED), lay16.specs, mesh)
    cache = {"layers": [{n: ref[n][li].to(dev, torch.bfloat16) for n in ("k", "v")}
                        for li in range(cfg16.n_layers)]}
    for layer in cache["layers"]:
        layer["pos"] = MESH_DECODE_PROMPT
    del ref
    _empty_cache(dev)
    _, cache = T.serve_step(p16, cache, steps[0], cfg16, lay16)  # warm
    _sync(dev)
    dist.barrier()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    wall_ms, event_ms, finite = [], [], True
    for s in steps:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        lg, cache = T.serve_step(p16, cache, s, cfg16, lay16)
        stop.record()
        _sync(dev)
        wall_ms.append((time.perf_counter() - t) * 1e3)
        event_ms.append(start.elapsed_time(stop))
        finite &= bool(torch.isfinite(lg).all())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del p16, cache, lg
    _empty_cache(dev)
    return dict(f32=f32, control=control, f32_s=f32_s, owned=[i for i, _ in mine],
                kv_block=lay.kv_block, wall_ms=wall_ms, event_ms=event_ms, bf16_finite=finite,
                peak_allocated=peak, allocated_before=before, s=time.perf_counter() - t0)


# DIN on a mesh: the reference's DIN cells at full width (`model_cfg()`) on
# (data, model) (2, 2) under DIN_RULES (`mesh_din_rank`): the tables' rows
# and the MLPs' columns that divide over "model", the batch over "data",
# the retrieval candidates over ("data", "model")
MESH_DIN_BATCH = {"train_batch": 65_536, "serve_p99": 512,
                  "serve_bulk": 65_536}  # serve_bulk cut from 262,144 (PERF.md, section 4)
MESH_DIN_BULK_WHOLE = DIN_BATCHES["serve_bulk"]  # its peak is reckoned, as the cut's reason
MESH_DIN_CANDS = 1_000_000
MESH_DIN_SEED = 7
# Each cell's scores (of their max), the loss (relative), m and v (of each
# leaf's max): the ranks in float32, TF32 off, against the world of one's
# step; the ranks with TF32 matmuls are a control that must land above.
# Each is the geometric mean of the largest float32 and the smallest control
# reading of the first card run, rounded down to a 1-2-5 step (PERF.md:
# 5.52e-7 / 4.85e-4, 8.55e-8 / 1.54e-6 and 8.78e-7 / 8.09e-2). The table
# shards' read rows after the step (largest absolute difference) likewise:
# 1.86e-8 / 5.52e-4
MESH_DIN_TOL = 1e-5
MESH_DIN_LOSS_TOL = 2e-7
MESH_DIN_STATE_TOL = 2e-4
MESH_DIN_TABLE_TOL = 2e-6


@contextlib.contextmanager
def sync_checked(dev):
    """`torch.cuda.set_sync_debug_mode("error")` over the block, lifted
    inside torch.distributed's collectives only: gloo stages a CUDA tensor
    through the host and syncs its stream by design (NCCL would not)."""
    if dev.type != "cuda":
        yield
        return
    import torch.distributed as dist

    names = ("all_reduce", "all_gather", "all_to_all_single", "broadcast")
    orig = {n: getattr(dist, n) for n in names}

    def lifted(fn):
        def call(*a, **k):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return call

    for n in names:
        setattr(dist, n, lifted(orig[n]))
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
        for n in names:
            setattr(dist, n, orig[n])


def mesh_din_inputs() -> dict:
    """{cell: its global batch, CPU tensors}: `din_batch` draws of
    MESH_DIN_BATCH rows, and one user's history against MESH_DIN_CANDS
    candidates drawn over the tables."""
    from repro_torch.configs import din as conf
    from repro_torch.data.recsys import din_batch

    cfg = conf.model_cfg()
    kw = dict(seq_len=cfg.seq_len, n_items=cfg.n_items, n_cats=cfg.n_cats,
              d_profile=cfg.d_profile, seed=MESH_DIN_SEED)
    out = {}
    for i, (cell, B) in enumerate(MESH_DIN_BATCH.items()):
        b = din_batch(i, B, **kw)
        if cell != "train_batch":
            b.pop("label")
        out[cell] = {k: torch.from_numpy(v) for k, v in b.items()}
    user = din_batch(len(MESH_DIN_BATCH), 1, **kw)
    rng = np.random.default_rng([MESH_DIN_SEED, len(MESH_DIN_BATCH)])
    out["retrieval_cand"] = {k: torch.from_numpy(v) for k, v in dict(
        hist_items=user["hist_items"], hist_cats=user["hist_cats"], profile=user["profile"],
        cand_items=rng.integers(0, cfg.n_items, MESH_DIN_CANDS).astype(np.int32),
        cand_cats=rng.integers(0, cfg.n_cats, MESH_DIN_CANDS).astype(np.int32)).items()}
    return out


def mesh_din_params(device) -> dict:
    """DIN's parameters at full width, drawn on `device` from MESH_DIN_SEED."""
    from repro_torch.configs import din as conf
    from repro_torch.models.param import init_params
    from repro_torch.models.recsys import din as model

    return init_params(model.param_specs(conf.model_cfg()),
                       torch.Generator(device=device).manual_seed(MESH_DIN_SEED), device)


def mesh_din_step(loss_fn, mesh=None, specs=None):
    """One AdamW step of the dry run's optimizer (weight decay 0) at the base
    rate (warmup 0)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    return make_train_step(loss_fn, AdamWConfig(weight_decay=0.0), warmup=0, total_steps=10,
                           mesh=mesh, specs=specs)


def mesh_din_ref(device, shard_dir) -> dict:
    """The world of one's side of DIN on the mesh, in float32: `score` at
    serve_p99 and serve_bulk, `retrieval_scores` of the MESH_DIN_CANDS
    candidates and one train step at train_batch; each rank's block of the
    scores, of m and v, of the tables after the step, with the loss, to a
    file a rank under `shard_dir`."""
    from repro_torch.configs import din as conf
    from repro_torch.configs.base import merged_rules
    from repro_torch.distributed.mesh_utils import LogicalRules, local_shard, resolve_pspec
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.param import param_pspecs, tree_map
    from repro_torch.models.recsys import din as model
    from repro_torch.train.train_step import init_train_state

    cfg = conf.model_cfg()
    t0 = time.perf_counter()
    params = mesh_din_params(device)
    inputs = mesh_din_inputs()
    lr = LogicalRules(MeshShape(("data", "model"), MESH_LM_SHAPE), merged_rules(conf.DIN_RULES))
    specs = param_pspecs(model.param_specs(cfg), lr)
    scores, walls = {}, {}
    with torch.no_grad():
        for cell in ("serve_p99", "serve_bulk", "retrieval_cand"):
            b = {k: v.to(device) for k, v in inputs[cell].items()}
            _sync(device)
            t = time.perf_counter()
            fn = model.retrieval_scores if cell == "retrieval_cand" else model.score
            scores[cell] = fn(params, b, cfg)
            _sync(device)
            walls[cell] = time.perf_counter() - t
            del b
    state = init_train_state(tree_map(lambda p: p.clone(), params))
    step = mesh_din_step(lambda p, bb: model.loss_fn(p, bb, cfg))
    batch = {k: v.to(device) for k, v in inputs["train_batch"].items()}
    _sync(device)
    t = time.perf_counter()
    state, met = step(state, batch)
    _sync(device)
    walls["train_batch"] = time.perf_counter() - t
    del batch
    head = dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]), lr=float(met["lr"]))
    cand = {cell: resolve_pspec(("cand",) if cell == "retrieval_cand" else ("batch",),
                                tuple(scores[cell].shape), lr) for cell in scores}
    for r in range(SHARD_WORLD):
        at = _RankOf(r)
        blk = lambda x, sp: local_shard(x, sp, at).cpu()  # noqa: E731
        torch.save(dict(head, specs=specs, cand=cand,
                        scores={c: blk(v, cand[c]) for c, v in scores.items()},
                        m={k: blk(v, specs[k]) for k, v in state.opt_state["m"].items()},
                        v={k: blk(v, specs[k]) for k, v in state.opt_state["v"].items()},
                        tables={k: blk(state.params[k].detach(), specs[k])
                                for k in ("item_table", "cat_table")}),
                   os.path.join(shard_dir, f"din_mesh_{r}.pt"))
    del state, params, scores
    _empty_cache(device)
    return dict(head, walls=walls, s=time.perf_counter() - t0)


def mesh_din_reckoned() -> dict:
    """The dry run's rule for a rank's float32 train step at train_batch
    (`count_step` per rank on meta tensors, as rank 0 of a fake world of
    4): its state bytes (shards, m, v, step, its rows), the temporaries'
    peak, their sum and its collectives; and likewise the peak of a rank's
    `score` at the whole serve_bulk batch (MESH_DIN_BULK_WHOLE,
    "bulk_whole_peak_bytes")."""
    from repro_torch.analysis.roofline import count_step
    from repro_torch.configs import din as conf
    from repro_torch.configs.base import merged_rules
    from repro_torch.launch.dryrun import fake_process_mesh, tensors
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.param import abstract_params, local_params
    from repro_torch.models.recsys import din as model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.train_step import TrainState, trainable

    cfg = conf.model_cfg()
    t = time.perf_counter()
    B = MESH_DIN_BATCH["train_batch"]
    with fake_process_mesh(MeshShape(("data", "model"), MESH_LM_SHAPE)) as mesh:
        lay = model.MeshLayout(cfg, mesh, merged_rules(conf.DIN_RULES))
        params = trainable(local_params(abstract_params(model.param_specs(cfg)), lay.specs,
                                        mesh))
        state = TrainState(params, adamw_init(params),
                           torch.empty((), dtype=torch.int32, device="meta"))
        meta = lambda shape, dt=torch.int32: torch.empty(shape, dtype=dt, device="meta")  # noqa
        batch = lay.local_batch(dict(
            hist_items=meta((B, cfg.seq_len)), hist_cats=meta((B, cfg.seq_len)),
            cand_item=meta((B,)), cand_cat=meta((B,)),
            profile=meta((B, cfg.d_profile), torch.float32), label=meta((B,))))
        step = mesh_din_step(lambda p, b: model.loss_fn(p, b, cfg, lay), mesh, lay.specs)
        _, count = count_step(step, (state, batch), per_rank=True)
        state_bytes = sum(x.numel() * x.element_size() for x in tensors((state, batch)))
        Bw = MESH_DIN_BULK_WHOLE
        bulk = lay.local_batch(dict(
            hist_items=meta((Bw, cfg.seq_len)), hist_cats=meta((Bw, cfg.seq_len)),
            cand_item=meta((Bw,)), cand_cat=meta((Bw,)),
            profile=meta((Bw, cfg.d_profile), torch.float32)))
        with torch.no_grad():
            _, served = count_step(lambda p, b: model.score(p, b, cfg, lay),
                                   (state.params, bulk), per_rank=True)
        bulk_peak = served.temp_bytes + sum(x.numel() * x.element_size()
                                            for x in tensors((state.params, bulk)))
    return dict(state_bytes=state_bytes, temp_bytes=count.temp_bytes,
                peak_bytes=state_bytes + count.temp_bytes, collective_bytes=count.collective_bytes,
                collective_bytes_by_kind=dict(count.collective_bytes_by_kind),
                flops=count.flops, bulk_whole_peak_bytes=bulk_peak, s=time.perf_counter() - t)


def mesh_din_rank(mesh, dev, rank, shard_dir) -> dict:
    """DIN on the mesh, this rank's part: its shards of the same draw as the
    world of one's (`local_params` under DIN_RULES) and its block of each
    batch. In float32, TF32 off, under `sync_checked` (no host sync but
    gloo's own): `score` at serve_p99 and serve_bulk, `retrieval_scores`
    (its quarter of the candidates, read from the tables' owners by
    exchange) and one train step at train_batch, each timed (the host's
    clock after a sync; every rank at once on the one card), the step's
    max_memory_allocated after the peak stats are reset; held against the
    world of one's (`mesh_din_ref`): the scores of their max, the loss, m
    and v of each leaf's max, the table shards after the step (rows no id
    read bit-equal to the draw, the rest within 2 lr, an Adam step's reach
    on a gradient whose sign rounding turns). Then the same with TF32
    matmuls, the control. No hand-written kernel launches."""
    import torch.distributed as dist

    from repro_torch.configs import din as conf
    from repro_torch.configs.base import merged_rules
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.models.param import local_params, tree_map
    from repro_torch.models.recsys import din as model
    from repro_torch.train.train_step import init_train_state

    t0 = time.perf_counter()
    cfg, rules = conf.model_cfg(), merged_rules(conf.DIN_RULES)
    ref = torch.load(os.path.join(shard_dir, f"din_mesh_{rank}.pt"), weights_only=False)
    inputs = mesh_din_inputs()
    lay = model.MeshLayout(cfg, mesh, rules)
    rlay = model.MeshLayout(cfg, mesh, rules, n_candidates=MESH_DIN_CANDS)
    if lay.specs != ref["specs"] or rlay.cand_axes != ("data", "model"):
        raise AssertionError(f"DIN on the mesh: specs {lay.specs}, candidates {rlay.cand_axes}")
    p0 = local_params(mesh_din_params(dev), lay.specs, mesh)
    # the rows of this rank's table shards that no id of the whole train
    # batch reads (both data ranks' gradients move a shard)
    unread = {}
    for name, keys in (("item_table", ("hist_items", "cand_item")),
                       ("cat_table", ("hist_cats", "cand_cat"))):
        R = p0[name].shape[0]
        seen = torch.zeros(R * lay.n_model, dtype=torch.bool)
        for k in keys:
            seen[inputs["train_batch"][k].long().clamp(min=0).reshape(-1)] = True
        unread[name] = (~seen[lay.m * R:(lay.m + 1) * R]).to(dev)
    batches = {c: {k: v.to(dev) for k, v in (rlay if c == "retrieval_cand" else lay)
                   .local_batch(b).items()} for c, b in inputs.items()}
    del inputs
    _empty_cache(dev)

    def run(tf32: bool):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        LAUNCHES.clear()
        walls, out = {}, {}
        try:
            with sync_checked(dev) if not tf32 else contextlib.nullcontext():
                with torch.no_grad():
                    for cell in ("serve_p99", "serve_bulk", "retrieval_cand"):
                        fn = model.retrieval_scores if cell == "retrieval_cand" else model.score
                        _sync(dev)
                        t = time.perf_counter()
                        out[cell] = fn(p0, batches[cell], cfg,
                                       rlay if cell == "retrieval_cand" else lay)
                        _sync(dev)
                        walls[cell] = time.perf_counter() - t
                state = init_train_state(tree_map(lambda p: p.clone(), p0))
                step = mesh_din_step(lambda p, b: model.loss_fn(p, b, cfg, lay), mesh,
                                     lay.specs)
                _sync(dev)
                dist.barrier()
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(dev)
                t = time.perf_counter()
                state, met = step(state, batches["train_batch"])
                _sync(dev)
                walls["train_batch"] = time.perf_counter() - t
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        rel = lambda a, b: float((a - b.to(dev)).abs().max() / b.abs().max())  # noqa: E731
        res = dict(walls=walls, peak_allocated=peak, launches={k: v for k, v in LAUNCHES.items()
                                                              if v},
                   scores={c: rel(out[c], ref["scores"][c]) for c in out},
                   loss=abs(float(met["loss"]) - ref["loss"]) / abs(ref["loss"]),
                   grad_norm=abs(float(met["grad_norm"]) - ref["grad_norm"]) / ref["grad_norm"],
                   m=max(rel(v, ref["m"][k]) for k, v in state.opt_state["m"].items()),
                   v=max(rel(v, ref["v"][k]) for k, v in state.opt_state["v"].items()),
                   finite=all(bool(torch.isfinite(x).all()) for x in out.values()))
        tables = {}
        for name in ("item_table", "cat_table"):
            p, want = state.params[name].detach(), ref["tables"][name].to(dev)
            keep = unread[name]
            tables[name] = dict(
                unread_rows=int(keep.sum()),
                unread_equal=bool(torch.equal(p[keep], p0[name][keep])),
                read_max_abs=float((p[~keep] - want[~keep]).abs().max()))
        res["tables"] = tables
        del state, out
        _empty_cache(dev)
        return res

    f32 = run(False)
    control = run(True)
    rows = {c: int(b["hist_items"].shape[0]) for c, b in batches.items() if c != "retrieval_cand"}
    rows["retrieval_cand"] = int(batches["retrieval_cand"]["cand_items"].shape[0])
    del p0, batches
    _empty_cache(dev)
    return dict(f32=f32, control=control, rows=rows, lr=ref["lr"], s=time.perf_counter() - t0)


def _empty_cache(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def ep_prefill_rank(mesh, dev, rank) -> dict:
    """qwen2-moe cut to EP_PREFILL_LAYERS at full width, float32, each rank
    holding its quarter of the experts (`expert_parallel_params`) and every
    other leaf whole, prefilled under the mesh's rules: one request of
    EP_PREFILL_TOKENS. The flash launches counted from 0 around it (the
    wrapper's count) and read from a profile of it."""
    import torch.distributed as dist

    from repro_torch.distributed.mesh_utils import set_mesh_rules
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.models.transformer import Transformer, expert_parallel_params

    cfg, full_depth = ep_prefill_cfg()
    t = time.perf_counter()
    tree = expert_parallel_params(draw_params(cfg, dev, full_depth), cfg, mesh)
    _empty_cache(dev)
    model = Transformer(cfg, params=tree, device=dev)
    del tree
    tokens = ep_prefill_tokens(cfg, dev)
    draw_s = time.perf_counter() - t
    with set_mesh_rules(mesh):
        model.prefill_forward(tokens)  # warm
        _sync(dev)
        LAUNCHES.clear()
        t = time.perf_counter()
        last, kvs = model.prefill_forward(tokens)
        _sync(dev)
        prefill_s = time.perf_counter() - t
        launches = dict(LAUNCHES)
        del kvs
        profiled = None
        if dev.type == "cuda":
            events = _device_events(lambda: model.prefill_forward(tokens))
            profiled = sum(1 for name, _, _ in events if KERNELS["flash_attention"][2] in name)
    mem = None
    dist.barrier()  # every rank holds its model: the card's memory in use, read once
    if dev.type == "cuda" and rank == 0:
        mem = subprocess.run(["nvidia-smi", "--query-gpu=memory.used,memory.total",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip()
    dist.barrier()
    return dict(last=last.float().cpu().numpy(), flash_launches=launches.get("flash_attention", 0),
                launches=launches, flash_profiled=profiled, draw_s=draw_s, prefill_s=prefill_s,
                finite=bool(torch.isfinite(last).all()), memory_used=mem)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pna_rank(mesh, dev, shard_dir) -> dict:
    """PNA at full width over the four ranks, forward only, on the cut
    ogb_products graph the parent wrote (`plan_dist_graph`'s defaults):
    the loss and this rank's unserved gather requests (each layer's: the
    same edges every layer)."""
    from repro_torch.configs import pna as pna_config
    from repro_torch.models.gnn.distributed import (gather_served, local_dist_inputs,
                                                    make_dist_gnn_loss)
    from repro_torch.models.gnn import pna
    from repro_torch.models.param import init_params, tree_map

    t = time.perf_counter()
    dcfg, arrays = _load_graph(os.path.join(shard_dir, "products"))
    cfg = pna_config.model_cfg("ogb_products")
    params = tree_map(lambda a: a.to(dev), init_params(
        pna.param_specs(cfg), torch.Generator().manual_seed(0), "cpu"))
    local = local_dist_inputs(arrays, dcfg, mesh, dev)
    del arrays
    served = gather_served(dcfg, local["e_src"], local["e_dst"])
    real = (local["e_src"] >= 0) & (local["e_dst"] >= 0)
    unserved = int(real.sum()) - int(served.sum())
    load_s = time.perf_counter() - t
    with torch.no_grad():
        _sync(dev)
        t = time.perf_counter()
        loss, _ = make_dist_gnn_loss("pna", mesh, dcfg, cfg)(params, local)
        loss = float(loss)
    return dict(loss=loss, load_s=load_s, forward_s=time.perf_counter() - t,
                unserved_a_layer=unserved, requests_a_layer=int(real.sum()),
                chunks=dcfg.n_chunks, edge_chunk=dcfg.edge_chunk,
                gather_capacity=dcfg.gather_capacity)


def _load_graph(prefix):
    import json as _json

    from repro_torch.models.gnn.distributed import DistGraphConfig

    with open(prefix + ".json") as f:
        dcfg = DistGraphConfig(**{k: tuple(v) if k == "axes" else v
                                  for k, v in _json.load(f).items()})
    arrays = {k: np.load(f"{prefix}.{k}.npy", mmap_mode="r")
              for k in ("feat", "labels", "mask", "e_src", "e_dst", "pos")
              if os.path.exists(f"{prefix}.{k}.npy")}
    return dcfg, arrays


def _save_graph(prefix, dcfg, arrays):
    with open(prefix + ".json", "w") as f:
        json.dump(dataclasses.asdict(dcfg), f)
    for k, v in arrays.items():
        np.save(f"{prefix}.{k}.npy", v)


def zoo_dist_rank(mesh, dev, shard_dir) -> list:
    """Each arch at its ogb_products width on its cut graph: the four-rank
    loss and every gradient in float32, TF32 off, against the unsharded
    `loss_fn` the parent ran on the card; then the control, the same ranks
    with TF32 matmuls, against the same."""
    from repro_torch.models.gnn.distributed import local_dist_inputs, make_dist_gnn_loss
    from repro_torch.models.param import tree_map

    rows = []
    for arch in ("pna", "egnn", "graphcast", "equiformer-v2"):
        t = time.perf_counter()
        ref = torch.load(os.path.join(shard_dir, f"zoo_{arch}.pt"), weights_only=False)
        dcfg, arrays = _load_graph(os.path.join(shard_dir, f"zoo_{arch}"))
        local = local_dist_inputs(arrays, dcfg, mesh, dev)
        want = _flat_list(ref["grads"])

        def run(tf32):
            params = tree_map(lambda a: a.detach().to(dev).requires_grad_(), ref["params"])
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                loss, _ = make_dist_gnn_loss(arch, mesh, dcfg, ref["cfg"])(params, local)
                loss.backward()
                _sync(dev)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            got = {k: (torch.zeros_like(v) if v.grad is None else v.grad).cpu()
                   for k, v in _flat_list(params).items()}
            return float(loss.detach()), _leaf_errors(got, want)

        loss, errs = run(False)
        _, control = run(True)
        rows.append(dict(arch=arch, loss=loss, loss_ref=ref["loss"], worst=max(errs.values()),
                         worst_leaf=max(errs, key=errs.get), control=max(control.values()),
                         tol=ZOO_DIST_TOL[arch], leaves=len(errs), chunks=dcfg.n_chunks,
                         s=time.perf_counter() - t))
        del local
    return rows


def gc_rank(pod, dev, rank) -> dict:
    """`compressed_psum` over the "pod" axis, two steps with error feedback,
    on this device's tensors and on the CPU's (the same gloo group): q and
    the scales bit for bit, the mean and the residual compared, and the
    mean's error against the plain mean of gradient plus residual, in
    quantisation steps (the largest rank's scale)."""
    import torch.distributed as dist

    from repro_torch.optim import compressed_psum, quantize_int8

    group = pod.group("pod")
    ef_dev = ef_cpu = None
    steps = []
    t = time.perf_counter()
    for step in range(GC_STEPS):
        g_cpu = gc_grads(step, rank)
        g_dev = {k: v.to(dev) for k, v in g_cpu.items()}
        res_dev = ef_dev.residual if ef_dev else {k: torch.zeros_like(v) for k, v in g_dev.items()}
        res_cpu = ef_cpu.residual if ef_cpu else {k: torch.zeros_like(v) for k, v in g_cpu.items()}
        row = dict(q_equal=True, scale_equal=True, mean_max_diff=0.0, residual_max_diff=0.0,
                   err_steps=0.0)
        plain = {}
        for k in g_dev:
            x_dev, x_cpu = g_dev[k] + res_dev[k], g_cpu[k] + res_cpu[k]
            q_d, s_d = quantize_int8(x_dev)
            q_c, s_c = quantize_int8(x_cpu)
            row["q_equal"] &= bool(torch.equal(q_d.cpu(), q_c))
            row["scale_equal"] &= bool(torch.equal(s_d.cpu(), s_c))
            s_max = s_d.clone()
            dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
            mean_x = x_dev.clone()
            dist.all_reduce(mean_x, group=group)
            plain[k] = (mean_x / torch.full((), float(dist.get_world_size(group)),
                                            device=dev), s_max)
        synced_dev, ef_dev = compressed_psum(g_dev, group, ef_dev)
        synced_cpu, ef_cpu = compressed_psum(g_cpu, group, ef_cpu)
        for k in g_dev:
            row["mean_max_diff"] = max(row["mean_max_diff"], float(
                (synced_dev[k].cpu() - synced_cpu[k]).abs().max()))
            row["residual_max_diff"] = max(row["residual_max_diff"], float(
                (ef_dev.residual[k].cpu() - ef_cpu.residual[k]).abs().max()))
            mean_x, s_max = plain[k]
            row["err_steps"] = max(row["err_steps"], float(
                (synced_dev[k] - mean_x).abs().max() / s_max))
        steps.append(row)
    return dict(steps=steps, s=time.perf_counter() - t,
                elements=sum(int(np.prod(s)) for s in GC_LEAVES.values()))


def plan_four_ranks(n_nodes, dst, d_feat, n_out):
    """`plan_dist_graph` at the (2, 2) mesh for D times the busiest owner's
    edges, so that every rank's edges fit its padded share (plan_dist_graph
    assumes ceil(E / D) a rank); (the plan, the busiest owner's edges)."""
    from repro_torch.models.gnn.distributed import plan_dist_graph

    busiest = int(np.bincount(dst % SHARD_WORLD, minlength=SHARD_WORLD).max())
    return plan_dist_graph(n_nodes, busiest * SHARD_WORLD, {"data": 2, "model": 2},
                           d_feat=d_feat, n_out=n_out), busiest


def products_graph(device, shard_dir):
    """Phase 6's synthetic ogb_products graph (`synthetic_edges`, seed 0: its
    power-law destinations) cut by PRODUCTS_CUT in nodes and edges, its
    padded edges left out, sources drawn uniformly; features and labels at
    ogb_products' widths. `plan_dist_graph` gives every rank ceil(E / D)
    edges rounded up to a chunk, and `prepare_dist_inputs` refuses a rank
    past that, as the reference's asserts: the hubs put one owner 26,373
    edges past it at full size (numpy). So the four ranks' layout is
    planned for D times the busiest owner's edges. Its inputs go to files
    under `shard_dir` once, for the ranks to map; the world of one's are
    returned."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.models.gnn.distributed import plan_dist_graph, prepare_dist_inputs

    t = time.perf_counter()
    d = GNN_SHAPES["ogb_products"]
    N, E = d["n_nodes"] // PRODUCTS_CUT, d["n_edges"] // PRODUCTS_CUT
    g = torch.Generator(device=device).manual_seed(0)
    dst = synthetic_edges(N, E, g, device)
    src = torch.randint(0, N, (E,), generator=g, device=device, dtype=torch.int32)
    keep = dst >= 0
    src, dst = src[keep].cpu().numpy(), dst[keep].cpu().numpy()
    feats = torch.randn(N, d["d_feat"], generator=g, device=device).cpu().numpy()
    labels = torch.randint(0, d["n_out"], (N,), generator=g, device=device,
                           dtype=torch.int32).cpu().numpy()
    made_s = time.perf_counter() - t
    t = time.perf_counter()
    dcfg4, busiest = plan_four_ranks(N, dst, d["d_feat"], d["n_out"])
    dcfg1 = plan_dist_graph(N, src.size, {"data": 1, "model": 1}, d_feat=d["d_feat"],
                            n_out=d["n_out"])
    _save_graph(os.path.join(shard_dir, "products"), dcfg4,
                prepare_dist_inputs(dcfg4, src, dst, feats, labels))
    one = prepare_dist_inputs(dcfg1, src, dst, feats, labels)
    log(f"[sharded] PNA graph: ogb_products' {d['n_nodes']} nodes and {d['n_edges']} edges / "
        f"{PRODUCTS_CUT}: {N} nodes, {src.size} edges ({E - src.size} padded ones left out; "
        f"the busiest of 4 owners {busiest}, the mean {src.size / SHARD_WORLD:.0f}), "
        f"d_feat {d['d_feat']}, {d['n_out']} classes; made on the card in {made_s:.1f} s, laid "
        f"out for 4 ranks (written once) and for 1 in {time.perf_counter() - t:.1f} s; at 4 "
        f"ranks {dcfg4.n_chunks} chunks of {dcfg4.edge_chunk} edges a rank, gather capacity "
        f"{dcfg4.gather_capacity}")
    return dict(nodes=N, edges=int(src.size), dcfg1=dcfg1, one=one, chunks4=dcfg4.n_chunks,
                edge_chunk=dcfg4.edge_chunk, gather_capacity4=dcfg4.gather_capacity)


ZOO_MODULES = {"pna": "pna", "egnn": "egnn", "graphcast": "graphcast",
               "equiformer-v2": "equiformer_v2"}


def zoo_dist_refs(device, shard_dir) -> list:
    """The four archs at their ogb_products widths (d_feat 100, 47 classes,
    positions for EGNN and EquiformerV2) on their cut graphs (ZOO_DIST_GRAPH;
    ZOO_DIST_ER for ZOO_DIST_ON_ER), parameters drawn on the CPU from seed 0
    by the reference's rule (GraphCast's processor output weights scaled,
    as the note at ZOO_DIST_GRAPH says): the unsharded `loss_fn` and every gradient on
    the card in float32, TF32 off, saved with the four-rank inputs."""
    import importlib

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.graph.csr import csr_to_edge_index
    from repro_torch.graph.generators import erdos_renyi_graph, powerlaw_graph
    from repro_torch.models.gnn.distributed import prepare_dist_inputs
    from repro_torch.models.param import init_params, tree_map

    d = GNN_SHAPES["ogb_products"]
    rows = []
    for arch, name in ZOO_MODULES.items():
        t = time.perf_counter()
        gr = (erdos_renyi_graph(**ZOO_DIST_ER) if arch in ZOO_DIST_ON_ER
              else powerlaw_graph(**ZOO_DIST_GRAPH))
        src, dst = csr_to_edge_index(gr)
        rng = np.random.default_rng(0)
        feats = rng.standard_normal((gr.n, d["d_feat"])).astype(np.float32)
        labels = rng.integers(0, d["n_out"], gr.n).astype(np.int32)
        pos = rng.standard_normal((gr.n, 3)).astype(np.float32)
        mod = importlib.import_module(f"repro_torch.models.gnn.{name}")
        cfg = get_arch(arch).model_cfg("ogb_products")
        params = init_params(mod.param_specs(cfg), torch.Generator().manual_seed(0), "cpu")
        if arch == "graphcast":
            for lp in params["processor"]:
                for mlp in lp.values():
                    mlp["w2"] = mlp["w2"] / np.sqrt(cfg.n_layers)
        p = tree_map(lambda a: a.detach().to(device).requires_grad_(), params)
        batch = {"node_feat": torch.from_numpy(feats).to(device),
                 "src": torch.from_numpy(src).to(device), "dst": torch.from_numpy(dst).to(device),
                 "labels": torch.from_numpy(labels).to(device),
                 "node_pos": torch.from_numpy(pos).to(device)}
        loss, _ = mod.loss_fn(p, batch, cfg)
        loss.backward()
        grads = tree_map(lambda a: (torch.zeros_like(a) if a.grad is None else a.grad).cpu(), p)
        dcfg, _ = plan_four_ranks(gr.n, dst, cfg.d_in, cfg.n_out)
        needs_pos = arch in ("egnn", "equiformer-v2")
        _save_graph(os.path.join(shard_dir, f"zoo_{arch}"), dcfg,
                    prepare_dist_inputs(dcfg, src, dst, feats, labels,
                                        pos=pos if needs_pos else None))
        torch.save(dict(params=params, grads=grads, loss=float(loss.detach()), cfg=cfg),
                   os.path.join(shard_dir, f"zoo_{arch}.pt"))
        rows.append(dict(arch=arch, loss=float(loss.detach()), s=time.perf_counter() - t,
                         nodes=gr.n, edges=int(src.size),
                         graph=("erdos_renyi_graph({n}, {avg_degree})".format(**ZOO_DIST_ER)
                                if arch in ZOO_DIST_ON_ER
                                else "powerlaw_graph({n}, {m})".format(**ZOO_DIST_GRAPH)),
                         params=sum(int(a.numel()) for a in _flat_list(params).values())))
        del p, loss, grads, batch
    return rows


def ep_prefill_ref(device):
    """The world of one's prefill of the expert-parallel prefill's model
    (the same draw), and the model's own sensitivity: two prefills whose
    input moved by an ulp (`perturbed_prefill`)."""
    cfg, full_depth = ep_prefill_cfg()
    model = draw_lm(cfg, device, full_depth)
    tokens = ep_prefill_tokens(cfg, device)
    last, kvs = model.prefill_forward(tokens)
    del kvs
    moved = [perturbed_prefill(model, tokens, seed)["rel_l2"] for seed in (1, 2)]
    del model
    return last.float().cpu(), moved


def world_of_one(device, shard_dir, products) -> dict:
    """A world of one on the device's own backend (NCCL on the card): the
    expert-parallel layer at a (1, 1) mesh in both regimes, forward and
    backward (every collective of `collectives` on NCCL: all_reduce,
    all_gather, all_to_all), and the PNA loss over the cut ogb_products
    graph laid out for one rank (its gathers' all_to_all)."""
    import torch.distributed as dist

    from repro_torch.configs import pna as pna_config
    from repro_torch.distributed.mesh import init_mesh
    from repro_torch.models.gnn import pna
    from repro_torch.models.gnn.distributed import local_dist_inputs, make_dist_gnn_loss
    from repro_torch.models.param import init_params, tree_map

    store = os.path.join(shard_dir, "one_store")
    mesh, dev = init_mesh((1, 1), ("data", "model"), device, store=dist.FileStore(store, 1),
                          rank=0, world_size=1)
    try:
        backend = dist.get_backend()
        mc, full = moe_layer_full(dev)
        layer = [ep_layer_case(full, mc, mesh, (1, 1), T, None, dev) for T in MOE_EP_TOKENS]
        del full
        cfg = pna_config.model_cfg("ogb_products")
        params = tree_map(lambda a: a.to(dev), init_params(
            pna.param_specs(cfg), torch.Generator().manual_seed(0), "cpu"))
        dcfg = products["dcfg1"]
        local = local_dist_inputs(products.pop("one"), dcfg, mesh, dev)
        with torch.no_grad():
            _sync(dev)
            t = time.perf_counter()
            loss = float(make_dist_gnn_loss("pna", mesh, dcfg, cfg)(params, local)[0])
            pna_s = time.perf_counter() - t
        del local
    finally:
        dist.destroy_process_group()
    return dict(backend=backend, moe_layer=layer, pna_loss=loss, pna_s=pna_s,
                pna_chunks=dcfg.n_chunks)


def check_mesh_lm(ranks, ref, reckoned) -> dict:
    """Hold and log the mesh LM path's readings of every rank: float32
    within MESH_LM_TOL (m, v, loss, grad norm) and MESH_LM_LOGIT_TOL (the
    prefill's logits), the TF32 control above each; the parameters within 2 lr; the flash
    launches of each step on its route (wrapper counts and profiles); the
    reckoned peak within MESH_LM_PEAK_TOL of max_memory_allocated."""
    cfg, depth = mesh_lm_cfg(torch.float32)
    L = cfg.n_layers
    lm = [r["lm_mesh"] for r in ranks]
    worst = max(max(x["f32"][k] for k in ("m", "v", "loss", "grad_norm")) for x in lm)
    control = min(max(x["control"]["m"], x["control"]["v"]) for x in lm)
    logits = max(x["logits"] for x in lm)
    logits_control = min(x["logits_control"] for x in lm)
    log(f"[sharded] LM step on a mesh: {cfg.name} at full width cut to {L} of {depth} layers "
        f"(drawn at {depth}'s scale, {ref['params']} parameters), mesh (data, model) "
        f"{MESH_LM_SHAPE}, LM_TRAIN_RULES, {MESH_LM_BATCH} x {MESH_LM_SEQ} tokens (one "
        f"sequence a data rank); float32, TF32 off, one step (lr {ref['lr']:.3g}) against the "
        f"world of one's (loss {ref['loss']:.6f}, grad norm {ref['grad_norm']:.6f}, "
        f"{ref['step_s']:.2f} s): worst of m, v (of each leaf's max), loss and grad norm "
        f"(relative) by rank " + " ".join(f"{max(x['f32'][k] for k in ('m', 'v', 'loss', 'grad_norm')):.3g}"
                                         for x in lm) +
        f" (tol {MESH_LM_TOL}; worst leaf {lm[0]['f32']['m_leaf']}); the TF32 control "
        f"{control:.3g} at least; parameters max |diff| "
        f"{max(x['f32']['params_max_abs'] for x in lm):.3g} (tol {lm[0]['f32']['params_tol']:.3g}), "
        f"{max(x['f32']['params_share_over_1e6'] for x in lm):.3g} of them over 1e-6; prefill's "
        f"last logits {logits:.3g} of their max (tol {MESH_LM_LOGIT_TOL}; control "
        f"{logits_control:.3g}); float32 step "
        + " ".join(f"{x['f32_s']:.1f}" for x in lm) + " s by rank")
    if not (worst <= MESH_LM_TOL < control and logits <= MESH_LM_LOGIT_TOL < logits_control):
        raise AssertionError(f"the LM step on a mesh against the world of one: "
                             f"{[(x['f32'], x['control'], x['logits'], x['logits_control']) for x in lm]}")
    for x in lm:
        if x["f32"]["params_max_abs"] > x["f32"]["params_tol"]:
            raise AssertionError(f"the LM step on a mesh: parameters off {x['f32']}")
    fwd = 2 * L if cfg.remat else L  # remat recomputes each layer's forward
    want = {"flash_attention": fwd, "flash_attention_bwd": L}
    for x in lm:
        if {k: x["f32_launches"].get(k, 0) for k in want} != want or \
                {k: x["launches"].get(k, 0) for k in want} != want:
            raise AssertionError(f"the mesh step launched {x['f32_launches']} (float32) and "
                                 f"{x['launches']} (bf16), expected {want} a rank")
        if x["f32_routes"] != {"fwd_tc": 0, "fwd_f32": fwd, "bwd_tc": 0, "bwd_f32": L} or \
                x["bf16_routes"] != {"fwd_tc": fwd, "fwd_f32": 0, "bwd_tc": L, "bwd_f32": 0}:
            raise AssertionError(f"the mesh step's profiles: {x['f32_routes']} (float32), "
                                 f"{x['bf16_routes']} (bf16)")
    peaks = [x["peak_allocated"] for x in lm]
    off = [abs(reckoned["peak_bytes"] - p) / p for p in peaks]
    log(f"[sharded] LM step on a mesh, bf16 (the timed step, every rank at once on the one "
        f"card): flash launches a rank (wrapper) {lm[0]['launches']}, in profiles "
        f"{lm[0]['bf16_routes']} (bf16) and {lm[0]['f32_routes']} (float32 control); step "
        + " ".join(f"{x['step_ms']:.1f}" for x in lm) + " ms by rank (CUDA events; wall "
        + " ".join(f"{x['wall_ms']:.1f}" for x in lm) + " ms); loss "
        + " ".join(f"{x['loss_bf16']:.4f}" for x in lm) + "; peak allocated by rank "
        + " ".join(f"{p / 1e9:.3f}" for p in peaks) + " GB against the dry run's reckoning "
        f"{reckoned['peak_bytes'] / 1e9:.3f} GB (state {reckoned['state_bytes'] / 1e9:.3f} + "
        f"temporaries {reckoned['temp_bytes'] / 1e9:.3f}; {reckoned['collective_bytes'] / 1e9:.3f}"
        f" GB of collectives {reckoned['collectives']}), off by " +
        " ".join(f"{o:.3f}" for o in off) + f" (tol {MESH_LM_PEAK_TOL}); rank path "
        + " ".join(f"{x['s']:.1f}" for x in lm) + " s")
    if max(off) > MESH_LM_PEAK_TOL:
        raise AssertionError(f"the reckoned peak {reckoned} against {peaks}")
    return dict(ranks=lm, ref=ref, reckoned=reckoned, tol=MESH_LM_TOL,
                logit_tol=MESH_LM_LOGIT_TOL, peak_off=off, layers=L, shape=MESH_LM_SHAPE)


def check_mesh_decode(ranks, ref, reckoned) -> dict:
    """Hold and log the decode step on a mesh of every rank: in float32
    each step's logits within MESH_DECODE_TOL and the written slots within
    MESH_DECODE_SLOT_TOL, the TF32 control above each, the rest of every
    block unchanged, each new position written by its owner alone, no
    hand-written kernel launched; bf16 steps finite; the reckoned peak
    within MESH_LM_PEAK_TOL of max_memory_allocated."""
    cfg, depth = mesh_lm_cfg(torch.float32)
    dec = [r["decode_mesh"] for r in ranks]
    worst = max(x["f32"]["logits"] for x in dec)
    control = min(x["control"]["logits"] for x in dec)
    slots = max(x["f32"]["slots"] for x in dec)
    slots_control = min(x["control"]["slots"] for x in dec)
    log(f"[sharded] decode step on a mesh: {cfg.name} at full width cut to {cfg.n_layers} of "
        f"{depth} layers, mesh (data, model) {MESH_LM_SHAPE}, LM_DECODE_RULES (the cache's "
        f"{MESH_DECODE_SMAX} positions over \"model\", {MESH_DECODE_SMAX // MESH_LM_SHAPE[1]} a "
        f"rank, kv heads whole), batch {MESH_DECODE_BATCH} ({MESH_DECODE_BATCH // MESH_LM_SHAPE[0]}"
        f" rows a data rank), the world of one's float32 prefill of {MESH_DECODE_PROMPT} tokens "
        f"({ref['prefill_s']:.2f} s, flash launches {ref['launches']}) then {MESH_DECODE_STEPS} "
        f"steps; float32, TF32 off, against the world of one's serve_step "
        f"(" + " ".join(f"{v:.3f}" for v in ref["step_s"]) + " s a step): logits of their max "
        "by rank " + " ".join(f"{x['f32']['logits']:.3g}" for x in dec) +
        f" (tol {MESH_DECODE_TOL}; the TF32 control {control:.3g} at least); written slots "
        "by rank " + " ".join(f"{x['f32']['slots']:.3g}" for x in dec) +
        f" (tol {MESH_DECODE_SLOT_TOL}; control {slots_control:.3g}); steps written by rank "
        + " ".join(str(x["owned"]) for x in dec) + "; every block unchanged elsewhere "
        f"{all(x['f32']['unchanged'] and x['control']['unchanged'] for x in dec)}; float32 "
        "run " + " ".join(f"{x['f32_s']:.1f}" for x in dec) + " s by rank")
    if not (worst <= MESH_DECODE_TOL < control and slots <= MESH_DECODE_SLOT_TOL < slots_control):
        raise AssertionError(f"the decode step on a mesh against the world of one: "
                             f"{[(x['f32'], x['control']) for x in dec]}")
    for x in dec:
        if not (x["f32"]["unchanged"] and x["control"]["unchanged"] and x["f32"]["finite"] and
                x["bf16_finite"]):
            raise AssertionError(f"the decode step on a mesh: a block changed outside its "
                                 f"written slots, or a logit not finite: {x}")
        if x["f32"]["launches"] or x["control"]["launches"]:
            raise AssertionError(f"the decode step launched {x['f32']['launches']}: its "
                                 f"attention is the plain einsum and softmax")
    blocks = MESH_DECODE_SMAX // MESH_LM_SHAPE[1]
    want_owned = [[i for i in range(MESH_DECODE_STEPS)
                   if (MESH_DECODE_PROMPT + i) // blocks == x["kv_block"]] for x in dec]
    if [x["owned"] for x in dec] != want_owned or \
            sorted({i for x in dec for i in x["owned"]}) != list(range(MESH_DECODE_STEPS)):
        raise AssertionError(f"the owners of the writes: {[x['owned'] for x in dec]}, expected "
                             f"{want_owned}")
    peaks = [x["peak_allocated"] for x in dec]
    off = [abs(reckoned["peak_bytes"] - p) / p for p in peaks]
    log(f"[sharded] decode step on a mesh, bf16 ({MESH_DECODE_STEPS} steps after a warm one, "
        f"every rank at once on the one card): the wall a step by rank (host perf_counter "
        f"after a sync) " + "; ".join(" ".join(f"{w:.1f}" for w in x["wall_ms"]) for x in dec) +
        " ms (CUDA events " + "; ".join(" ".join(f"{w:.1f}" for w in x["event_ms"])
                                       for x in dec) +
        " ms); peak allocated by rank " + " ".join(f"{p / 1e9:.3f}" for p in peaks) +
        f" GB against the dry run's reckoning {reckoned['peak_bytes'] / 1e9:.3f} GB (state "
        f"{reckoned['state_bytes'] / 1e9:.3f} + temporaries {reckoned['temp_bytes'] / 1e9:.3f}; "
        f"{reckoned['collective_bytes'] / 1e9:.3f} GB of collectives a step "
        f"{reckoned['collective_bytes_by_kind']}), off by " + " ".join(f"{o:.3f}" for o in off) +
        f" (tol {MESH_LM_PEAK_TOL}); rank path " + " ".join(f"{x['s']:.1f}" for x in dec) + " s")
    if max(off) > MESH_LM_PEAK_TOL:
        raise AssertionError(f"the reckoned decode peak {reckoned} against {peaks}")
    return dict(ranks=dec, ref=ref, reckoned=reckoned, tol=MESH_DECODE_TOL,
                slot_tol=MESH_DECODE_SLOT_TOL, peak_off=off, layers=cfg.n_layers,
                shape=MESH_LM_SHAPE, batch=MESH_DECODE_BATCH, max_seq=MESH_DECODE_SMAX,
                prompt=MESH_DECODE_PROMPT, steps=MESH_DECODE_STEPS)


def check_mesh_din(ranks, ref, reckoned, parent_gb: float) -> dict:
    """Hold and log DIN on the mesh, every rank: in float32 each cell's
    scores within MESH_DIN_TOL, the loss within MESH_DIN_LOSS_TOL, m and v
    within MESH_DIN_STATE_TOL, the table shards' read rows within
    MESH_DIN_TABLE_TOL, the TF32 control above each; the table shards'
    unread rows bit-equal to the draw; every score finite; no hand-written
    kernel launched (the lookups are plain row gathers, as the reference's);
    the reckoned peak beside max_memory_allocated; the reckoned peak of
    serve_bulk whole on the four ranks beside the card's memory (the cut's
    reason, PERF.md section 4)."""
    from repro_torch.configs import din as conf

    cfg = conf.model_cfg()
    din = [r["din_mesh"] for r in ranks]
    cells = list(din[0]["f32"]["scores"])
    score = max(max(x["f32"]["scores"].values()) for x in din)
    # each cell's control must land above: the smallest over cells and ranks
    score_c = min(x["control"]["scores"][c] for x in din for c in cells)
    loss = max(x["f32"]["loss"] for x in din)
    loss_c = min(x["control"]["loss"] for x in din)
    state = max(max(x["f32"]["m"], x["f32"]["v"]) for x in din)
    state_c = min(max(x["control"]["m"], x["control"]["v"]) for x in din)
    tab = {n: max(x["f32"]["tables"][n]["read_max_abs"] for x in din)
           for n in ("item_table", "cat_table")}
    tab_c = min(t["read_max_abs"] for x in din for t in x["control"]["tables"].values())
    log(f"[sharded] DIN on a mesh: model_cfg() (tables {cfg.n_items:,} and {cfg.n_cats:,} x "
        f"{cfg.embed_dim}), mesh (data, model) {MESH_LM_SHAPE}, DIN_RULES (the tables' rows "
        f"and the MLPs' columns that divide over \"model\"); rows a rank {din[0]['rows']}; "
        f"float32, TF32 off, against the world of one (loss {ref['loss']:.6f}, grad norm "
        f"{ref['grad_norm']:.6f}; walls " + " ".join(f"{c} {w:.3f}" for c, w in
                                                     ref["walls"].items()) +
        " s): scores of their max by rank " +
        "; ".join(" ".join(f"{c} {e:.3g}" for c, e in x["f32"]["scores"].items()) for x in din) +
        f" (tol {MESH_DIN_TOL}; TF32 control {score_c:.3g} at least); loss by rank " +
        " ".join(f"{x['f32']['loss']:.3g}" for x in din) +
        f" (tol {MESH_DIN_LOSS_TOL}; control {loss_c:.3g}); m, v of "
        "each leaf's max by rank " + " ".join(f"{x['f32']['m']:.3g}/{x['f32']['v']:.3g}"
                                              for x in din) +
        f" (tol {MESH_DIN_STATE_TOL}; control {state_c:.3g}); table shards after the step: "
        "unread rows bit-equal " + str(all(t["unread_equal"] for x in din
                                           for t in x["f32"]["tables"].values())) +
        f", read rows within {tab} (tol {MESH_DIN_TABLE_TOL}; control {tab_c:.3g})")
    if not (score <= MESH_DIN_TOL < score_c and loss <= MESH_DIN_LOSS_TOL < loss_c and
            state <= MESH_DIN_STATE_TOL < state_c and
            max(tab.values()) <= MESH_DIN_TABLE_TOL < tab_c):
        raise AssertionError(f"DIN on a mesh against the world of one: "
                             f"{[(x['f32'], x['control']) for x in din]}")
    for x in din:
        for run in (x["f32"], x["control"]):
            if run["launches"] or not run["finite"]:
                raise AssertionError(f"DIN on a mesh launched {run['launches']} or gave a "
                                     f"score that is not finite")
        for t in x["f32"]["tables"].values():
            if not t["unread_equal"]:
                raise AssertionError(f"DIN on a mesh: table shards off {x['f32']['tables']}")
    peaks = [x["f32"]["peak_allocated"] for x in din]
    log(f"[sharded] DIN on a mesh, walls by rank, every rank at once on the one card, gloo "
        f"through the host (float32, the first calls, under set_sync_debug_mode(\"error\") but "
        f"inside gloo's collectives) " +
        "; ".join(" ".join(f"{c} {w:.3f}" for c, w in x["f32"]["walls"].items()) for x in din) +
        " s; (TF32, the second calls) " +
        "; ".join(" ".join(f"{c} {w:.3f}" for c, w in x["control"]["walls"].items())
                  for x in din) + " s; the train step's peak allocated by rank " + " ".join(f"{p / 1e9:.3f}" for p in peaks)
        + f" GB beside the dry run's reckoning {reckoned['peak_bytes'] / 1e9:.3f} GB (state "
        f"{reckoned['state_bytes'] / 1e9:.3f} + temporaries {reckoned['temp_bytes'] / 1e9:.3f}; "
        f"{reckoned['collective_bytes'] / 1e9:.3f} GB of collectives a step "
        f"{reckoned['collective_bytes_by_kind']}); rank path " +
        " ".join(f"{x['s']:.1f}" for x in din) + " s")
    total = (torch.cuda.get_device_properties(0).total_memory / 1e9
             if torch.cuda.is_available() else 0.0)
    bulk = reckoned["bulk_whole_peak_bytes"] / 1e9
    log(f"[sharded] DIN on a mesh, serve_bulk whole ({MESH_DIN_BULK_WHOLE:,} rows): the dry "
        f"run's reckoned peak {bulk:.3f} GB a rank, {SHARD_WORLD * bulk:.3f} GB for the "
        f"{SHARD_WORLD} ranks, with this process's reserved {parent_gb:.2f} GB "
        f"{SHARD_WORLD * bulk + parent_gb:.3f} GB, before {SHARD_WORLD + 1} CUDA contexts and "
        f"the allocator's slack, against the card's {total:.3f} GB: run at "
        f"{MESH_DIN_BATCH['serve_bulk']:,}")
    return dict(ranks=din, ref=ref, reckoned=reckoned, tol=MESH_DIN_TOL,
                loss_tol=MESH_DIN_LOSS_TOL, state_tol=MESH_DIN_STATE_TOL,
                table_tol=MESH_DIN_TABLE_TOL, batch=MESH_DIN_BATCH, candidates=MESH_DIN_CANDS,
                shape=MESH_LM_SHAPE)


def sharded_paths(device, grouting_handoff: dict):
    """Phase 13: the sharded paths, as four gloo ranks on the one card.

    First, in this process: the cut ogb_products graph for PNA
    (`products_graph`), the four archs' unsharded losses and gradients on
    the cut graph (`zoo_dist_refs`), the world of one's prefill of the
    expert-parallel model (`ep_prefill_ref`), then a world of one over
    NCCL (`world_of_one`: the expert-parallel layer and the PNA loss, so
    that NCCL's branch of each collective runs on the card). Then four
    ranks, spawned once, gloo on cuda:0 (NCCL refuses two ranks on one
    device), run `sharded_rank`. Held: gloo's results on CUDA tensors; each
    expert-parallel layer case's output and every gradient within
    MOE_EP_TOL of the single-device path's (drop-free at the busiest
    expert's capacity, and at the config's factor); the prefill's logits
    on every rank within EP_PREFILL_TOL of the world of one's, with
    EP_PREFILL_LAYERS flash launches a rank; the PNA loss within
    DIST_LOSS_RTOL of the world of one's; each arch's loss and gradients
    against the unsharded loss; compressed_psum's payloads and scales equal
    the CPU's and its mean within one quantisation step of the plain mean.
    A rank that fails or hangs fails the phase. Before the ranks, this
    process also runs the mesh LM's world of one (`mesh_lm_ref`) and the
    dry run's reckoning of its timed step (`mesh_lm_reckoned`), and the
    decode step's world of one (`mesh_decode_ref`: the prefill that fills
    the cache, the steps) and its reckoning (`mesh_decode_reckoned`), and
    DIN's world of one (`mesh_din_ref`) and its reckoning
    (`mesh_din_reckoned`); the ranks' readings are held by
    `check_mesh_lm`, `check_mesh_decode` and `check_mesh_din`, and their
    grouting runs, served from phase 11's graph (`grouting_handoff`), by
    `check_grouting_mesh`. Returns (figures, by wrapper the flash launches
    summed: the ranks' expert-parallel prefill's and the mesh LM's timed
    step's, and the decode's prefill in this process; and the frontier
    launches of the ranks' grouting runs, summed over the ranks)."""
    import shutil

    t0 = time.perf_counter()
    shard_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), SHARD_DIR)
    shutil.rmtree(shard_dir, ignore_errors=True)
    os.makedirs(shard_dir)
    _empty_cache(device)
    with no_tf32():
        products = products_graph(device, shard_dir)
        zoo_ref = zoo_dist_refs(device, shard_dir)
        t = time.perf_counter()
        last_ref, moved = ep_prefill_ref(device)
        prefill_ref_s = time.perf_counter() - t
        one = world_of_one(device, shard_dir, products)
        _empty_cache(device)
        lm_ref = mesh_lm_ref(device, shard_dir)
        _empty_cache(device)
        decode_ref = mesh_decode_ref(device, shard_dir)
        _empty_cache(device)
        din_ref = mesh_din_ref(device, shard_dir)
    lm_reckoned = mesh_lm_reckoned()
    decode_reckoned = mesh_decode_reckoned()
    din_reckoned = mesh_din_reckoned()
    _empty_cache(device)
    parent_gb = torch.cuda.memory_reserved(device) / 1e9 if device.type == "cuda" else 0.0
    setup_s = time.perf_counter() - t0
    t = time.perf_counter()
    ranks = spawn_ranks(sharded_rank, SHARD_WORLD,
                        (shard_dir, device.type, grouting_handoff["dir"]), SHARD_TIMEOUT_S)
    ranks_s = time.perf_counter() - t
    shutil.rmtree(shard_dir, ignore_errors=True)
    shutil.rmtree(grouting_handoff["dir"], ignore_errors=True)

    r0 = ranks[0]
    log(f"[sharded] {SHARD_WORLD} ranks, gloo on {r0['route']['tensors']} tensors: "
        f"all_to_all_single, all_gather and all_reduce taken by gloo as they are, float32 and "
        f"bf16 (sum and max), checked on every rank; the port stages nothing through host "
        f"memory; ranks up in {max(r['start_s'] for r in ranks):.1f} s")
    lm_mesh = check_mesh_lm(ranks, lm_ref, lm_reckoned)
    decode_mesh = check_mesh_decode(ranks, decode_ref, decode_reckoned)
    din_mesh = check_mesh_din(ranks, din_ref, din_reckoned, parent_gb)
    grouting_mesh, frontier_launches = check_grouting_mesh(ranks, grouting_handoff)
    log(f"[sharded] world of one over {one['backend']}: expert-parallel layer " +
        "; ".join(f"{c['tokens_a_shard']} tokens ({c['regime']}, capacity {c['capacity']}) worst "
                  f"{c['worst']:.3g} ({c['worst_leaf']})" for c in one["moe_layer"]) +
        f"; PNA loss {one['pna_loss']:.7f} over {one['pna_chunks']} chunks a layer in "
        f"{one['pna_s']:.1f} s")
    for c in one["moe_layer"]:
        if not (c["worst"] <= MOE_EP_TOL and c["finite"]):
            raise AssertionError(f"world of one: expert-parallel layer off: {c}")

    for i, c in enumerate(r0["moe_layer"]):
        worst = max(r["moe_layer"][i]["worst"] for r in ranks)
        log(f"[sharded] expert-parallel layer, mesh {tuple(c['mesh'])}, {c['tokens_a_shard']} "
            f"tokens a data shard ({c['regime']}), capacity {c['capacity']} "
            f"({'factor ' + str(c['capacity_factor']) if c['capacity_factor'] else 'drop-free'}), "
            f"dropped {c['dropped_share']:.4f}: output and every gradient vs one device, worst "
            f"over ranks {worst:.3g} of a leaf's max (tol {MOE_EP_TOL})")
        for r in ranks:
            rc = r["moe_layer"][i]
            if not (rc["worst"] <= MOE_EP_TOL and rc["finite"]):
                raise AssertionError(f"expert-parallel layer off on a rank: {rc}")

    cfg, full_depth = ep_prefill_cfg()
    errs = [rel_l2(torch.from_numpy(r["prefill"]["last"]), last_ref) for r in ranks]
    pf = [r["prefill"] for r in ranks]
    log(f"[sharded] expert-parallel prefill: {cfg.name} at full width cut to {cfg.n_layers} of "
        f"{full_depth} layers (drawn at {full_depth}'s scale), float32, TF32 off, 1 x "
        f"{EP_PREFILL_TOKENS} tokens, drop-free, mesh (1, 4): {cfg.n_experts_padded // 4} "
        f"experts a rank; last logits vs the world of one's prefill ({prefill_ref_s:.1f} s), "
        f"relative L2 by rank " + " ".join(f"{e:.3g}" for e in errs) + f" (tol "
        f"{EP_PREFILL_TOL}; the model's own, input moved an ulp: " +
        " ".join(f"{m:.3g}" for m in moved) + "); flash launches by rank (wrapper count) " +
        " ".join(str(p["flash_launches"]) for p in pf) + ", in a profile " +
        " ".join(str(p["flash_profiled"]) for p in pf) + "; prefill " +
        " ".join(f"{p['prefill_s']:.3f}" for p in pf) + " s by rank; card memory with every "
        f"rank's model resident: {pf[0]['memory_used']}")
    for e, p in zip(errs, pf):
        if not (p["finite"] and e <= EP_PREFILL_TOL):
            raise AssertionError(f"expert-parallel prefill off: {errs}")
        if p["flash_launches"] != cfg.n_layers or set(p["launches"]) != {"flash_attention"}:
            raise AssertionError(f"expert-parallel prefill launched {p['launches']}, expected "
                                 f"{cfg.n_layers} flash_attention")

    pn = [r["pna"] for r in ranks]
    loss4 = pn[0]["loss"]
    pna_err = abs(loss4 - one["pna_loss"]) / abs(one["pna_loss"])
    log(f"[sharded] PNA (4 layers, d 75) forward over {SHARD_WORLD} ranks on the cut graph "
        f"({products['nodes']} nodes, {products['edges']} edges; {pn[0]['chunks']} chunks of "
        f"{pn[0]['edge_chunk']} edges a rank, capacity {pn[0]['gather_capacity']}): loss "
        f"{loss4:.7f} vs the world of one's {one['pna_loss']:.7f}, relative {pna_err:.3g} (tol "
        f"{DIST_LOSS_RTOL}); forward " + " ".join(f"{p['forward_s']:.1f}" for p in pn) +
        " s by rank; unserved gather requests a layer by rank " +
        " ".join(f"{p['unserved_a_layer']} of {p['requests_a_layer']}" for p in pn) +
        " (the same each of the 4 layers; dropped silently, as the reference drops them)")
    if not (len({p["loss"] for p in pn}) == 1 and pna_err <= DIST_LOSS_RTOL):
        raise AssertionError(f"PNA loss over {SHARD_WORLD} ranks {[p['loss'] for p in pn]} vs "
                             f"{one['pna_loss']}")

    for i, ref in enumerate(zoo_ref):
        rows = [r["zoo"][i] for r in ranks]
        worst = max(x["worst"] for x in rows)
        control = min(x["control"] for x in rows)
        loss_err = max(abs(x["loss"] - x["loss_ref"]) / abs(x["loss_ref"]) for x in rows)
        log(f"[sharded] {ref['arch']} at ogb_products' width ({ref['params']} parameters) on "
            f"{ref['graph']} ({ref['edges']} edges), {SHARD_WORLD} ranks vs the unsharded "
            f"loss_fn on the card, float32 on both, TF32 off: loss {rows[0]['loss']:.7f} "
            f"(unsharded {ref['loss']:.7f}, relative {loss_err:.3g}, tol {DIST_LOSS_RTOL}), every "
            f"gradient within {worst:.3g} of its leaf's max (tol {rows[0]['tol']}; worst "
            f"{rows[0]['worst_leaf']}), {rows[0]['leaves']} leaves; the control, the ranks with "
            f"TF32 matmuls: {control:.3g} at least (must exceed the tol)")
        if not (worst <= rows[0]["tol"] < control and loss_err <= DIST_LOSS_RTOL):
            raise AssertionError(f"{ref['arch']}: sharded vs unsharded off: {rows}")

    gc = [r["compression"] for r in ranks]
    for s in range(GC_STEPS):
        st = [g["steps"][s] for g in gc]
        err = max(x["err_steps"] for x in st)
        log(f"[sharded] compressed_psum over a pod axis of {SHARD_WORLD}, step {s}, "
            f"{gc[0]['elements']} elements at Qwen3-4B's shapes: int8 payloads equal the CPU's "
            f"{all(x['q_equal'] for x in st)}, scales {all(x['scale_equal'] for x in st)}; "
            f"mean vs the CPU's max diff {max(x['mean_max_diff'] for x in st):.3g}, residual "
            f"{max(x['residual_max_diff'] for x in st):.3g}; mean vs the plain mean "
            f"{err:.3f} quantisation steps")
        if not (all(x["q_equal"] and x["scale_equal"] for x in st) and err <= 1.0):
            raise AssertionError(f"compressed_psum off at step {s}: {st}")

    peak = sum(r.get("peak_reserved_gb", 0.0) for r in ranks)
    wall = time.perf_counter() - t0
    log(f"[sharded] phase wall {wall:.1f} s (this process's set-up and world of one "
        f"{setup_s:.1f} s, the ranks {ranks_s:.1f} s: " +
        " ".join(f"{r['wall_s']:.1f}" for r in ranks) + " s by rank); peak memory by rank "
        "(allocated / reserved GB) " +
        " ".join(f"{r.get('peak_allocated_gb', 0):.2f}/{r.get('peak_reserved_gb', 0):.2f}"
                 for r in ranks) + f"; the ranks' reserved summed {peak:.2f} GB, with this "
        f"process's {parent_gb:.2f} GB {peak + parent_gb:.2f} GB, and a CUDA context a process "
        "besides (not counted by torch)")
    n_flash = sum(p["flash_launches"] for p in pf)
    figures = dict(
        route=r0["route"], world_of_one=one, lm_mesh=lm_mesh, decode_mesh=decode_mesh,
        din_mesh=din_mesh, grouting_mesh=grouting_mesh,
        moe_layer=[r["moe_layer"] for r in ranks],
        prefill=dict(rel_l2=errs, tol=EP_PREFILL_TOL, input_moved=moved,
                     flash_launches=[p["flash_launches"] for p in pf],
                     flash_profiled=[p["flash_profiled"] for p in pf],
                     prefill_s=[p["prefill_s"] for p in pf], memory_used=pf[0]["memory_used"]),
        pna=dict(nodes=products["nodes"], edges=products["edges"], cut=PRODUCTS_CUT,
                 loss=loss4, loss_one=one["pna_loss"], rel=pna_err, ranks=pn),
        zoo=[[r["zoo"][i] for r in ranks] for i in range(len(zoo_ref))],
        compression=gc, wall_s=wall, setup_s=setup_s, ranks_s=ranks_s,
        rank_walls=[r["wall_s"] for r in ranks],
        peak_reserved_gb=[r.get("peak_reserved_gb") for r in ranks],
        peak_allocated_gb=[r.get("peak_allocated_gb") for r in ranks],
        parent_reserved_gb=parent_gb)
    # the flash launches of the phase's paths: the expert-parallel prefill's,
    # the mesh LM's timed step, summed over the ranks, and the prefill that
    # fills the cache the decode step on a mesh reads
    launches = {"flash_attention": n_flash + sum(r["lm_mesh"]["launches"].get(
        "flash_attention", 0) for r in ranks) + decode_ref["launches"].get("flash_attention", 0),
        "flash_attention_bwd": sum(r["lm_mesh"]["launches"].get("flash_attention_bwd", 0)
                                   for r in ranks), **frontier_launches}
    return figures, launches


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
    kernels["flash_attention_bwd"], bwd_shapes, bwd_drop = check_flash_bwd_grid(device)
    phase_done("flash backward checks")
    train, train_launches = lm_train(device)
    # and the training path's: forward (remat's recompute included), backward
    kernels["flash_attention"]["launches"] += train_launches["flash_attention"]
    kernels["flash_attention_bwd"]["launches"] = train_launches["flash_attention_bwd"]
    phase_done(f"Qwen3-4B training ({TRAIN_LAYERS} layers)")
    train["restart"] = lm_train_restart(device)
    phase_done("training restart")
    train["card_vs_cpu"] = lm_train_card_vs_cpu(device)
    phase_done("training card vs CPU")
    kernels["segment_sum"], gnn = gnn_aggregation(device)
    kernels["segment_sum"]["max_abs_err"] = max(kernels["segment_sum"]["max_abs_err"], seg_err)
    phase_done("GNN aggregation")
    kernels["embedding_bag"], din = din_lookups(device)
    kernels["embedding_bag"]["max_abs_err"] = max(kernels["embedding_bag"]["max_abs_err"],
                                                  bag_err)
    phase_done("DIN bag lookups")
    cpu = gnn_din_card_vs_cpu(device)
    phase_done("GNN and DIN card vs CPU")
    zoo = zoo_training(device)
    phase_done("zoo training")
    grouting, grouting_launches, grouting_handoff = grouting_serving(device)
    for k, v in grouting_launches.items():
        kernels[k]["launches"] += v
    phase_done("grouting")
    planning = planning_and_examples(device, lm, train, zoo)
    phase_done("planning and examples")
    sharded, sharded_launches = sharded_paths(device, grouting_handoff)
    # and the expert-parallel prefill's, the mesh LM step's and the grouting
    # mesh's frontier launches, summed over the four ranks
    for k, v in sharded_launches.items():
        kernels[k]["launches"] += v
    phase_done("sharded paths")

    log(json.dumps({"cells": cells, "profiles": profiles, "frontier": frontier}))
    log(json.dumps({"routing": routing}))
    log(json.dumps({"flash_shapes": flash_shapes, "flash_leak": flash_leak, "lm": lm}))
    log(json.dumps({"gnn": gnn, "din": din, "card_vs_cpu": cpu}))
    log(json.dumps({"moe": moe}))
    log(json.dumps({"flash_bwd_shapes": bwd_shapes, "flash_bwd_drop_check": bwd_drop,
                    "train": train}))
    log(json.dumps({"zoo": zoo}))
    log(json.dumps({"grouting": grouting}))
    log(json.dumps({"planning": planning}))
    log(json.dumps({"sharded": sharded}))
    log(smi)
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
