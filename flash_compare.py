"""This tree's flash-attention, segment-sum, frontier or embedding-bag
kernels against other sources of them, timed on one GPU in turns.

    mkdir -p build/other
    git archive <rev> src/repro_torch/kernels/csrc/flash_attention.cu | tar -x -C build/other
    python3 flash_compare.py build/other/src/repro_torch/kernels/csrc/flash_attention.cu

    git archive <rev> src/repro_torch/kernels/csrc/segment_sum.cu | tar -x -C build/other
    python3 flash_compare.py --segment build/other/src/repro_torch/kernels/csrc/segment_sum.cu

    git archive <rev> src/repro_torch/kernels/csrc/frontier.cu | tar -x -C build/other
    python3 flash_compare.py --frontier build/other/src/repro_torch/kernels/csrc/frontier.cu

    git archive <rev> src/repro_torch/kernels/csrc/embedding_bag.cu | tar -x -C build/other
    python3 flash_compare.py --bag build/other/src/repro_torch/kernels/csrc/embedding_bag.cu

    git archive <rev> src/repro_torch/kernels/csrc/flash_attention_bwd.cu | tar -x -C build/other
    python3 flash_compare.py --bwd build/other/src/repro_torch/kernels/csrc/flash_attention_bwd.cu

Each other source is built in a copy of the port's sources, in place of
this tree's file of the same name (`kernels.build`, all builds together),
so it must export the C entry points with the signatures `kernels/build.py`
declares. It runs through the same wrapper as this tree's kernel.

Flash attention: at every bf16 shape of `chip_smoke.py`'s ATTN_SHAPES and
at one prefill launch of its Qwen3-4B phase (4 requests), times other,
this, this, other (median of CUDA events each), beside SDPA where it
computes the same function and the bound.

Segment sum (`--segment`, one or more other sources): at phase 6's
ogb_products shape (`chip_smoke.py` GNN_SHAPE, `synthetic_edges` from seed
0) at width 75 and at width 1 (a mean's count: ones), and at the hub-only
shape (one segment of HUB_EDGES edges, widths 75 and 1, its rows read in
order and in a random order), times the others, this, this, the others in
reverse (median of CUDA events each), all through
`segment_reduce._launch_csr`.

Frontier (`--frontier`, one or more other sources): both layouts, on the
main path's own launches (`chip_smoke.py` `record_path`: the landmark cell
of phase 2 run once with its launches recorded, and the recorded launches
replayed), an all-padding hop at the path's shape and the synthetic hop
(MAIN_SHAPES); every source bit-equal to the plain version on each, then
the others, this, this, the others in reverse, each turn one profile of 20
launches an input (`chip_smoke.launch_ms`: the kernels take microseconds,
below what CUDA events see).

Embedding bag (`--bag`, one or more other sources): phase 7 of
`chip_smoke.py` (DIN's 1,048,576 x 18 float32 table, `din_batch` histories
at serve_bulk and serve_p99), sum and mean, unweighted and weighted; every
source within the tolerance of the float64 plain version on each
(`chip_smoke.bag_check`), then the others, this, this, the others in
reverse, each turn one profile of a batch's four calls
(`chip_smoke.launch_ms`), beside the bounds and the all-sectors-from-HBM
estimate (`chip_smoke.bag_bounds_ms`); then this tree's kernel at serve_bulk on
probes that change only where its rows come from (`bag_probes`).

Flash backward (`--bwd`, one or more other sources): at every bf16 shape
of `chip_smoke.py`'s BWD_SHAPES (Qwen3-4B's training attention first),
each source's `flash_attention_bwd` launched directly with the wrapper's
arguments (`flash_attention.bwd_args`) and held within BWD_TOL of the plain
version's autograd on float32 copies (TF32 off); the sources need not be
bit-equal to each other. Then the others, this, this, the others in
reverse, each turn one profile of every shape's backward (the sum of its
three launches, `chip_smoke.launch_ms`) and CUDA events a shape, beside
SDPA's backward where it computes the same function (no window, no cap) and
the bound (`chip_smoke.bwd_bound_ms`).

One JSON line a shape, then the card's name and power limit. Needs a CUDA
device; imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
PREFILL_LAUNCH = ("qwen3-4b prefill launch, 4 requests", 4, 32, 8, 4096, 4096, 128, True,
                  None, None, torch.bfloat16)


def load_variants(name: str, sources: list) -> list:
    """One library a source: the port's sources with that source as `name`,
    all built together."""
    from repro_torch.kernels.build import CSRC, build, load_library

    dirs = []
    for i, src in enumerate(sources):
        d = ROOT / "build" / "compare" / f"{Path(name).stem}{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        shutil.copyfile(src, d / name)
        dirs.append(d)
    with ThreadPoolExecutor(len(dirs) + 1) as pool:
        list(pool.map(build, dirs + [CSRC]))
    return [load_library(d) for d in dirs]


@contextlib.contextmanager
def using(lib):
    """The kernel wrappers launch from `lib` (this tree's when None)."""
    from repro_torch.kernels import embedding_bag, frontier, segment_reduce

    if lib is None:
        yield
        return
    modules = (frontier, segment_reduce, embedding_bag)
    saved = [m.load_library for m in modules]
    for m in modules:
        m.load_library = lambda: lib
    try:
        yield
    finally:
        for m, fn in zip(modules, saved):
            m.load_library = fn


def turns(names: list) -> list:
    """The others, this, this, the others in reverse (`names` ends in this)."""
    return names[:-1] + [names[-1]] * 2 + names[-2::-1]


def run(lib, q, k, v, causal, window, cap):
    from repro_torch.kernels.build import launch
    from repro_torch.kernels.flash_attention import fwd_args

    o = torch.empty_like(q)
    launch("flash_compare", lib.flash_attention_fwd, q.device,
           *fwd_args(q, k, v, o, causal, window, cap, None))
    return o


def compare_flash(other: Path, dev) -> None:
    from repro_torch.kernels.build import load_library

    libs = {"other": load_variants("flash_attention.cu", [other])[0], "this": load_library()}
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = [s for s in cs.ATTN_SHAPES if s[-1] == torch.bfloat16] + [PREFILL_LAUNCH]
    for name, B, Hq, Hkv, Sq, Skv, D, causal, window, cap, dtype in shapes:
        q = torch.randn(B, Hq, Sq, D, generator=g, device=dev).to(dtype)
        k = torch.randn(B, Hkv, Skv, D, generator=g, device=dev).to(dtype)
        v = torch.randn(B, Hkv, Skv, D, generator=g, device=dev).to(dtype)
        reps = 10 if Sq * Skv >= 2**22 else 30
        ms = {"other": [], "this": []}
        for n in turns(["other", "this"]):
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


def run_bwd(lib, q, k, v, out, do, kw):
    """(dq, dk, dv) from `lib`'s `flash_attention_bwd`, launched directly."""
    from repro_torch.kernels.build import launch
    from repro_torch.kernels.flash_attention import bwd_args

    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    work = torch.empty(3 * q.shape[0] * q.shape[1] * q.shape[2], dtype=torch.float32,
                       device=q.device)
    launch("flash_compare", lib.flash_attention_bwd, q.device,
           *bwd_args(q, k, v, out, do, *grads, work, scale=None, **kw))
    return grads


def compare_bwd(others: list, dev) -> None:
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_grads_ref

    names = [str(o) for o in others] + ["this"]
    libs = dict(zip(names, load_variants("flash_attention_bwd.cu", others) + [load_library()]))
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = []
    with cs.no_tf32():
        for shape in (s for s in cs.BWD_SHAPES if s[-1] == cs.BF16):
            name, B, Hq, Hkv, Sq, Skv, D, causal, window, cap, dtype = shape
            q, do = (torch.randn(B, Hq, Sq, D, generator=g, device=dev).to(dtype)
                     for _ in range(2))
            k, v = (torch.randn(B, Hkv, Skv, D, generator=g, device=dev).to(dtype)
                    for _ in range(2))
            kw = dict(causal=causal, window=window, softcap=cap)
            out = flash_attention(q, k, v, **kw)
            want = attention_grads_ref(q.float(), k.float(), v.float(), do.float(), **kw)
            share = {}
            for n, lib in libs.items():
                got = run_bwd(lib, q, k, v, out, do, kw)
                share[n] = max(float((a.float() - w).abs().max() / w.abs().max())
                               for a, w in zip(got, want))
                if not share[n] <= cs.BWD_TOL[dtype]:
                    raise AssertionError(f"{n}: flash backward != plain at {name}: max error / "
                                         f"max |grad| {share[n]} (tol {cs.BWD_TOL[dtype]})")
            print(f"[check] {name}: max error / max |grad| " +
                  ", ".join(f"{n} {x:.4g}" for n, x in share.items()), flush=True)
            shapes.append((shape, (q, k, v, out, do, kw), share))
            del want
    fns = {n: [lambda lib=lib, t=t: run_bwd(lib, *t) for _, t, _ in shapes]
           for n, lib in libs.items()}
    prof, events = {n: [] for n in names}, {n: [] for n in names}
    for n in turns(names):
        prof[n].append(cs.launch_ms(fns[n], reps=10))
        events[n].append([cs.median_ms(fn, reps=10) for fn in fns[n]])
    for i, ((name, B, Hq, Hkv, Sq, Skv, D, causal, window, cap, dtype), t, share) in \
            enumerate(shapes):
        sdpa = None
        if window is None and cap is None:
            leaves = [x.detach().requires_grad_() for x in t[:3]]
            o = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                                 enable_gqa=True)
            sdpa = cs.median_ms(lambda: torch.autograd.grad(o, leaves, t[4], retain_graph=True),
                                reps=10)
            del o, leaves
        bound, by, _ = cs.bwd_bound_ms(B, Hq, Hkv, Sq, Skv, D, causal, window, dtype)
        print(json.dumps(dict(shape=name, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Skv=Skv, D=D,
                              causal=causal, window=window, softcap=cap,
                              profile_ms={n: [x[i] for x in v] for n, v in prof.items()},
                              event_ms={n: [x[i] for x in v] for n, v in events.items()},
                              err_share=share, sdpa_bwd_ms=sdpa, bound_ms=bound, bound_by=by)),
              flush=True)


def run_segment(lib, values, order, offsets, n):
    from repro_torch.kernels.segment_reduce import _launch_csr

    with using(lib):
        return _launch_csr(values, order, offsets, n)


def compare_segment(others: list, dev) -> None:
    from repro_torch.kernels.segment_reduce import segment_order

    names = [str(o) for o in others] + ["this"]
    libs = dict(zip(names, load_variants("segment_sum.cu", others) + [None]))
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
    for name, values, o, off, n, kept_n in shapes:
        want = run_segment(None, values, o, off, n)
        diff = {k: float((run_segment(lib, values, o, off, n) - want).abs().max())
                for k, lib in libs.items()}
        ms = {k: [] for k in names}
        for k in turns(names):
            ms[k].append(cs.median_ms(lambda: run_segment(libs[k], values, o, off, n), reps=10))
        print(json.dumps(dict(shape=name, segments=n, kept_edges=kept_n,
                              width=values.shape[1], ms=ms, max_abs_diff_vs_this=diff,
                              bound_ms=cs.seg_bound_ms(kept_n, n, values.shape[1]))),
              flush=True)
        del want


def frontier_inputs(kind, replay, dev) -> list:
    """(name, rows, deg, visited in the kernel's layout, n, figures) of the
    recorded path launches, the all-padding hop and the synthetic hop."""
    from repro_torch.kernels.frontier import pack_words

    shapes = [(f"path launch {r['index']} ({'first' if r['first_link'] else 'later'} link)",
               r["rows"], r["deg"], r["vis"], r["n"]) for r in replay]
    n = cs.MAIN_SHAPES["n"]
    rows, deg, vis = cs.kernel_inputs(**cs.MAIN_SHAPES, device=dev)
    if kind == "frontier_expand_packed":
        vis = pack_words(vis)
    shapes += [("all-padding hop", torch.full_like(rows, -1), torch.zeros_like(deg), vis, n),
               ("synthetic hop (MAIN_SHAPES)", rows, deg, vis, n)]
    return [(name, r, d, v, n_, cs.hop_figures(kind, r, d, n_)) for name, r, d, v, n_ in shapes]


def compare_frontier(others: list, dev) -> None:
    names = [str(o) for o in others] + ["this"]
    libs = dict(zip(names, load_variants("frontier.cu", others) + [None]))
    tier, li, wl, base, _ = cs.path_setup(dev)
    for layout, kind in cs.KERNELS_BY_LAYOUT.items():
        _, replay = cs.record_path(tier, li, wl, base, "landmark", layout, dev)
        shapes = frontier_inputs(kind, replay, dev)
        for name, rows, deg, vis, n, _ in shapes:
            want = cs.expand(kind, rows, deg, vis, n, kernel=False)
            for k, lib in libs.items():
                with using(lib):
                    if not torch.equal(cs.expand(kind, rows, deg, vis, n, kernel=True), want):
                        raise AssertionError(f"{k}: {kind} != plain version on {name}")
        fns = [cs.in_place(kind, rows, deg, vis.clone(), n)
               for _, rows, deg, vis, n, _ in shapes]
        ms = {k: [] for k in names}
        for k in turns(names):
            with using(libs[k]):
                ms[k].append(cs.launch_ms(fns, cs.KERNELS[kind][2]))
        for i, (name, rows, deg, vis, n, fig) in enumerate(shapes):
            print(json.dumps(dict(kernel=kind, shape=name, ms={k: [t[i] for t in v]
                                                               for k, v in ms.items()},
                                  **fig)), flush=True)
        path = slice(0, len(replay))
        print(json.dumps(dict(kernel=kind, shape=f"median over the {len(replay)} path launches",
                              ms={k: [float(np.median(t[path])) for t in v]
                                  for k, v in ms.items()},
                              bound_ms=float(np.median([s[5]["bound_ms"] for s in shapes[path]])))),
              flush=True)
        del replay, shapes, fns


def compare_bag(others: list, dev) -> None:
    from repro_torch.data.recsys import din_batch
    from repro_torch.kernels.embedding_bag import embedding_bag

    names = [str(o) for o in others] + ["this"]
    libs = dict(zip(names, load_variants("embedding_bag.cu", others) + [None]))
    V, D = cs.DIN_TABLE
    g = torch.Generator(device=dev).manual_seed(1)
    table = torch.randn((V, D), generator=g, device=dev).mul_(0.01)
    for step, (shape, B) in enumerate(cs.DIN_BATCHES.items()):
        idx = torch.from_numpy(din_batch(step, B)["hist_items"]).to(dev)
        w_all = torch.rand(idx.shape, generator=g, device=dev)
        cases = [(combine, w_all if weighted else None)
                 for combine in ("sum", "mean") for weighted in (False, True)]
        for combine, w in cases:
            for k, lib in libs.items():
                with using(lib):
                    err, used, _, _ = cs.bag_check(embedding_bag(table, idx, w, combine), table,
                                                   idx, w, combine)
                print(f"[check] {k} {shape} {combine}{'' if w is None else ' weighted'}: max "
                      f"err {err:.3g}, {used:.4f} of the tolerance", flush=True)
        fns = [lambda c=c, w=w: embedding_bag(table, idx, w, c) for c, w in cases]
        ms = {k: [] for k in names}
        for k in turns(names):
            with using(libs[k]):
                ms[k].append(cs.launch_ms(fns, cs.KERNELS["embedding_bag"][2],
                                          reps=10 if B > 10_000 else 20))
        for i, (combine, w) in enumerate(cases):
            print(json.dumps(dict(kernel="embedding_bag", shape=shape, batch=B, combine=combine,
                                  weighted=w is not None,
                                  ms={k: [t[i] for t in v] for k, v in ms.items()},
                                  **cs.bag_bounds_ms(idx, w is not None, D))), flush=True)
        if B > 10_000:
            bag_probes(table, idx, dev)
        del idx, w_all


def bag_probes(table, idx, dev) -> None:
    """This tree's bag kernel (sum, unweighted) on inputs that change only
    where its rows come from, one profile: what bounds it at serve_bulk."""
    from repro_torch.kernels.embedding_bag import embedding_bag

    ok = idx >= 0
    V = table.shape[0]
    big = torch.randn((2 * V, table.shape[1]), device=dev)
    probes = {
        "as served": (table, idx),
        "ids mod 8192 (0.59 MB of rows: L2-resident)": (table, torch.where(ok, idx % 8192, idx)),
        "bags sorted by their first id": (table, idx[torch.argsort(idx[:, 0], stable=True)]
                                                 .contiguous()),
        "every entry padding (ids read, no rows)": (table, torch.full_like(idx, -1)),
        "table of 2V rows, ids x 2 (151 MB)": (big, torch.where(ok, idx * 2, idx)),
    }
    ms = cs.launch_ms([lambda t=t, i=i: embedding_bag(t, i) for t, i in probes.values()],
                      cs.KERNELS["embedding_bag"][2], reps=10)
    for name, t in zip(probes, ms):
        print(json.dumps(dict(kernel="embedding_bag", probe=name, this_ms=t)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, nargs="?",
                    help="another flash_attention.cu to time against this tree's")
    ap.add_argument("--segment", type=Path, nargs="+", metavar="SEGMENT_SUM_CU",
                    help="other segment_sum.cu sources to time against this tree's")
    ap.add_argument("--frontier", type=Path, nargs="+", metavar="FRONTIER_CU",
                    help="other frontier.cu sources to time against this tree's")
    ap.add_argument("--bag", type=Path, nargs="+", metavar="EMBEDDING_BAG_CU",
                    help="other embedding_bag.cu sources to time against this tree's")
    ap.add_argument("--bwd", type=Path, nargs="+", metavar="FLASH_ATTENTION_BWD_CU",
                    help="other flash_attention_bwd.cu sources to time against this tree's")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    modes = (args.other, args.segment, args.frontier, args.bag, args.bwd)
    if sum(x is not None for x in modes) != 1:
        ap.error("give one flash_attention.cu, or --segment, --frontier, --bag or --bwd with "
                 "other sources")
    if not torch.cuda.is_available():
        print("flash_compare: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.segment:
        compare_segment([p.resolve() for p in args.segment], dev)
    elif args.frontier:
        compare_frontier([p.resolve() for p in args.frontier], dev)
    elif args.bag:
        compare_bag([p.resolve() for p in args.bag], dev)
    elif args.bwd:
        compare_bwd([p.resolve() for p in args.bwd], dev)
    else:
        compare_flash(args.other.resolve(), dev)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
