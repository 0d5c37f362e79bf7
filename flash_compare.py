"""This tree's flash-attention or segment-sum kernel against other sources
of it, timed on one GPU in turns.

    mkdir -p build/other
    git archive <rev> src/repro_torch/kernels/csrc/flash_attention.cu | tar -x -C build/other
    python3 flash_compare.py build/other/src/repro_torch/kernels/csrc/flash_attention.cu

    git archive <rev> src/repro_torch/kernels/csrc/segment_sum.cu | tar -x -C build/other
    python3 flash_compare.py --segment build/other/src/repro_torch/kernels/csrc/segment_sum.cu

Flash attention: builds the port's kernels twice, as they are and with
the other flash source in place of this one (`kernels.build`, both builds
together), then at every bf16 shape of `chip_smoke.py`'s ATTN_SHAPES and
at one prefill launch of its Qwen3-4B phase (4 requests) times other,
this, this, other (median of CUDA events each), both launched through the
wrapper's own arguments (`flash_attention.fwd_args`), beside SDPA where it
computes the same function and the bound. The other source must export
`flash_attention_fwd` with the C signature `kernels/build.py` declares.

Segment sum (`--segment`, one or more other sources): builds
`segment_sum.cu` alone from each other source (all together) and the
port's kernels as they are, then at phase 6's ogb_products shape
(`chip_smoke.py` GNN_SHAPE, `synthetic_edges` from seed 0) at width 75
and at width 1 (a mean's count: ones), and at the hub-only shape (one
segment of HUB_EDGES edges, widths 75 and 1, its rows read in order and
in a random order), times the others, this, this, the others in reverse
(median of CUDA events each). This tree's kernel runs through
`segment_reduce._launch_csr` (its task table and workspace); the others
must export `segment_sum` with the signature before the task table
(values, order, offsets, out, dtype, N, D, stream; the source at
d96de4d), which takes no workspace.

One JSON line a shape, then the card's name and power limit. Needs a CUDA
device; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
CSRC_SEGMENT = "src/repro_torch/kernels/csrc/segment_sum.cu"
PREFILL_LAUNCH = ("qwen3-4b prefill launch, 4 requests", 4, 32, 8, 4096, 4096, 128, True,
                  None, None, torch.bfloat16)


def load(other: Path) -> dict:
    """{"other": library, "this": library}: the port's sources with `other`
    as the flash source, and as they are."""
    from repro_torch.kernels.build import CSRC, build, load_library

    csrc = ROOT / "build" / "compare" / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(CSRC, csrc)
    shutil.copyfile(other, csrc / "flash_attention.cu")
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(build, (csrc, CSRC)))
    return {"other": load_library(csrc), "this": load_library(CSRC)}


def run(lib, q, k, v, causal, window, cap):
    from repro_torch.kernels.build import launch
    from repro_torch.kernels.flash_attention import fwd_args

    o = torch.empty_like(q)
    launch("flash_compare", lib.flash_attention_fwd, q.device,
           *fwd_args(q, k, v, o, causal, window, cap, None))
    return o


# the segment-sum entry point before the task table: no workspace
EARLIER_SEGMENT_SUM = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                               ctypes.c_void_p]


def load_segment(sources: list) -> list:
    """One library a source, each built from that `segment_sum.cu` alone,
    its entry point declared with the signature before the task table."""
    from repro_torch.kernels.build import build

    dirs = []
    for i, src in enumerate(sources):
        d = ROOT / "build" / "compare" / f"segment{i}"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        shutil.copyfile(src, d / "segment_sum.cu")
        dirs.append(d)
    with ThreadPoolExecutor(len(dirs)) as pool:
        paths = list(pool.map(build, dirs))
    libs = []
    for path in paths:
        lib = ctypes.CDLL(str(path))
        lib.segment_sum.argtypes, lib.segment_sum.restype = EARLIER_SEGMENT_SUM, ctypes.c_int
        libs.append(lib)
    return libs


def run_segment(lib, values, order, offsets, n):
    """This tree's kernel when `lib` is None, else an earlier one."""
    from repro_torch.kernels.build import launch
    from repro_torch.kernels.segment_reduce import _DTYPES, _launch_csr

    if lib is None:
        return _launch_csr(values, order, offsets, n)
    out = torch.empty((n, values.shape[1]), dtype=torch.float32, device=values.device)
    launch("segment_compare", lib.segment_sum, values.device, values.data_ptr(),
           order.data_ptr(), offsets.data_ptr(), out.data_ptr(), _DTYPES[values.dtype], n,
           values.shape[1])
    return out


def compare_segment(others: list, dev) -> None:
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.segment_reduce import segment_order

    names = [str(o) for o in others] + ["this"]
    libs = dict(zip(names, load_segment(others) + [None]))
    load_library()
    N, E, D = cs.GNN_SHAPE
    g = torch.Generator(device=dev).manual_seed(0)
    dst = cs.synthetic_edges(N, E, g, dev)
    msgs = torch.randn((E, D), generator=g, device=dev)
    order, offsets = segment_order(dst, N)
    del dst
    kept = int(offsets[-1])
    hub_offsets = torch.tensor([0, cs.HUB_EDGES], dtype=torch.int64, device=dev)
    hub_orders = (("in order", torch.arange(cs.HUB_EDGES, device=dev)),
                  ("random order", torch.randperm(cs.HUB_EDGES, generator=g, device=dev)))
    shapes = [("ogb_products width 75", msgs, order, offsets, N, kept),
              ("ogb_products width 1 (count)", torch.ones((E, 1), device=dev), order, offsets,
               N, kept)]
    for width in (D, 1):
        v = torch.randn((cs.HUB_EDGES, width), generator=g, device=dev)
        for how, o in hub_orders:
            shapes.append((f"hub only {how} width {width}", v, o, hub_offsets, 1, cs.HUB_EDGES))
    turns = names[:-1] + ["this", "this"] + names[-2::-1]
    for name, values, o, off, n, kept_n in shapes:
        want = run_segment(None, values, o, off, n)
        diff = {k: float((run_segment(lib, values, o, off, n) - want).abs().max())
                for k, lib in libs.items()}
        ms = {k: [] for k in names}
        for k in turns:
            ms[k].append(cs.median_ms(lambda: run_segment(libs[k], values, o, off, n), reps=10))
        print(json.dumps(dict(shape=name, segments=n, kept_edges=kept_n,
                              width=values.shape[1], ms=ms, max_abs_diff_vs_this=diff,
                              bound_ms=cs.seg_bound_ms(kept_n, n, values.shape[1]))),
              flush=True)
        del want


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, nargs="?",
                    help="another flash_attention.cu to time against this tree's")
    ap.add_argument("--segment", type=Path, nargs="+", metavar="SEGMENT_SUM_CU",
                    help="other segment_sum.cu sources to time against this tree's")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    if (args.other is None) == (args.segment is None):
        ap.error("give one flash_attention.cu or --segment with segment_sum.cu sources")
    if not torch.cuda.is_available():
        print("flash_compare: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.segment:
        compare_segment([p.resolve() for p in args.segment], dev)
        print(cs.nvidia_smi())
        return 0
    libs = load(args.other.resolve())
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = [s for s in cs.ATTN_SHAPES if s[-1] == torch.bfloat16] + [PREFILL_LAUNCH]
    for name, B, Hq, Hkv, Sq, Skv, D, causal, window, cap, dtype in shapes:
        q = torch.randn(B, Hq, Sq, D, generator=g, device=dev).to(dtype)
        k = torch.randn(B, Hkv, Skv, D, generator=g, device=dev).to(dtype)
        v = torch.randn(B, Hkv, Skv, D, generator=g, device=dev).to(dtype)
        reps = 10 if Sq * Skv >= 2**22 else 30
        ms = {"other": [], "this": []}
        for n in ("other", "this", "this", "other"):
            ms[n].append(cs.median_ms(lambda: run(libs[n], q, k, v, causal, window, cap), reps))
        sdpa = None
        if window is None and cap is None:
            sdpa = cs.median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), reps)
        bound, by, _ = cs.attn_bound_ms(B, Hq, Hkv, Sq, Skv, D, causal, window, dtype)
        print(json.dumps(dict(shape=name, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Skv=Skv, D=D,
                              other_ms=ms["other"], this_ms=ms["this"], sdpa_ms=sdpa,
                              bound_ms=bound, bound_by=by,
                              speedup=float(np.mean(ms["other"]) / np.mean(ms["this"])))),
              flush=True)
        del q, k, v
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
