"""Dry run on the production meshes (the reference's `launch/dryrun.py`,
rebuilt for H100s): plan every (architecture x input shape) on 16x16 or
2x16x16 cards, state the per-device state bytes, count the step and print
its roofline terms at the H100's peaks.

Nothing runs on a device: each cell's step (`configs/base.py`
`build_dryrun`) runs eagerly on `meta` tensors at full depth under the
counters of `analysis/roofline.py`, so any machine can plan any mesh.
The process starts a `fake` process group of the mesh's size as rank 0
(`fake_process_mesh`) and builds the `ProcessMesh` on it: a collective
on a meta tensor then runs no op but keeps its shapes, and every group is
built on every rank, as `ProcessMesh` builds them, for 0.01 s at 512.

  - Per-device state bytes (parameters, optimizer state, KV cache, batch)
    are exact, from the sharding specs (`distributed/mesh_utils.py`).
  - The sharded steps (an LM's training step, prefill and decode step,
    ogb_products' full-graph step, DIN's four cells; `meta["per_rank"]`)
    run as rank 0 runs them, on its shards and over its groups: their flops and bytes are rank 0's own,
    with its collectives' bytes by kind, split within and between nodes,
    and its temporaries. `temp_bytes` is the peak of the live storage the
    step allocates: each output's storage is added when it appears and
    taken away when it is freed, the attention scores left out (the flash
    kernels keep them on chip); the peak per device is that plus the
    arguments' bytes, and the fit (`fits_80gb`) is stated for it.
  - Every other step (the zoo's one-device cells) runs as on one device:
    its flops and bytes are split evenly over the mesh, it has no
    collectives, its temporaries are None and its fit is stated for the
    state alone (`state_fits_80gb`).
  - A cell whose step cannot run on meta tensors (grouting's serving step
    reads the device) gives its state bytes, the reference's model flops
    and the reason; its counted flops are None.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--out DIR]
  python -m repro_torch.launch.dryrun --list

--all spawns one subprocess per cell (a failing cell cannot take the rest
down) and writes one JSON per cell to --out (default artifacts/dryrun).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.analysis.roofline import HBM_BYTES, build_report, count_step
from repro_torch.distributed.mesh_utils import shards
from repro_torch.launch.mesh import make_production_mesh


@contextlib.contextmanager
def fake_process_mesh(mesh):
    """A `ProcessMesh` of `mesh`'s axes and sizes over a `fake` process
    group of its size, this process rank 0; the group is torn down on
    exit. The process must run no other process group meanwhile."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed.mesh import ProcessMesh

    if dist.is_initialized():
        raise RuntimeError(f"the dry run starts its own process group: one "
                           f"({dist.get_backend()}) is running")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    try:
        yield ProcessMesh(mesh.sizes, mesh.axes)
    finally:
        dist.destroy_process_group()


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or
        (isinstance(e, tuple) and all(isinstance(a, str) for a in e)) for e in x)


def _children(tree) -> list:
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    return []


def tensors(tree) -> list:
    """Every tensor in a tree of dicts, lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for c in _children(tree) for t in tensors(c)]


def state_bytes(tree, spec, mesh) -> int:
    """Per-device bytes of a tree of tensors under its spec tree. A spec
    may stand for a whole subtree (a prefix), as a sharding may; a leaf
    split over axes of sizes n1, n2, ... holds 1 / (n1 n2 ...) of its bytes."""
    if _is_spec(spec):
        n = shards(spec, mesh)
        return sum(t.numel() * t.element_size() // n for t in tensors(tree))
    if isinstance(tree, dict):
        return sum(state_bytes(tree[k], spec[k], mesh) for k in tree)
    return sum(state_bytes(t, s, mesh) for t, s in zip(_children(tree), _children(spec)))


def count_cell(spec, mesh=None):
    """(spec, fn's output, its StepCount); the output and the count are
    None where the step cannot run on meta tensors. A per-rank step's
    collectives are split between pods by `mesh`'s "pod" axis."""
    if spec.fn is None:
        return spec, None, None
    seq = spec.meta.get("seq")
    pods = mesh.shape.get("pod", 1) if mesh is not None else 1
    return (spec,) + count_step(spec.fn, spec.args, score_dims=(seq, seq) if seq else None,
                                pod_size=mesh.size // pods if pods > 1 else None,
                                per_rank=bool(spec.meta.get("per_rank")))


def report_for(spec, mesh, counted, arch_name: str, shape: str, tf32: bool = False):
    """(memory, report) of `spec` on `mesh`: its per-device state bytes
    and, where its step was counted (`counted`, from `count_cell`), its
    roofline report with the state read once and written once; the report
    is None where the step was not counted. Written state: the arguments
    updated in place, once more, and every other output: rank 0's own
    for a per-rank step, else split evenly over the mesh."""
    counted_spec, out, count = counted
    layout = spec.state or spec.args
    arg_bytes = [state_bytes(a, s, mesh) for a, s in zip(layout, spec.in_specs)]
    state = sum(arg_bytes)
    memory = {
        "argument_bytes": state,
        "argument_bytes_by_arg": arg_bytes,
        "temp_bytes": None,  # a step run on one device: not a device's
        "per_device_state_gb": round(state / 2**30, 3),
        "state_fits_80gb": bool(state < HBM_BYTES),
    }
    if count is None:
        return memory, None
    if count.per_rank:
        peak = state + count.temp_bytes
        memory.update(temp_bytes=count.temp_bytes, peak_bytes=peak,
                      per_device_peak_gb=round(peak / 2**30, 3), fits_80gb=bool(peak < HBM_BYTES))
    donated = {id(t) for i in spec.donate for t in tensors(counted_spec.args[i])}
    fresh = sum(t.numel() * t.element_size() for t in tensors(out) if id(t) not in donated)
    written = sum(arg_bytes[i] for i in spec.donate) + fresh / (1 if count.per_rank else mesh.size)
    memory["output_bytes"] = written
    return memory, build_report(arch_name, shape, mesh.name, mesh.size, count, state + written,
                                spec.meta.get("model_flops", 0.0), tf32, argument_bytes=state)


def run_cell(arch_name: str, shape: str, mesh_kind: str, out_dir: Optional[str],
             counts: Optional[Dict[tuple, tuple]] = None) -> dict:
    """The cell's record on the mesh. `counts`, kept by a caller that runs
    a cell on several meshes, holds each cell's count where it does not
    depend on the mesh (a step run as on one device)."""
    from repro_torch.configs import get_arch

    arch = get_arch(arch_name)
    cell = arch.cell(shape)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rec = {"arch": arch_name, "shape": shape, "mesh": mesh.name, "kind": cell.kind,
           "status": "?"}
    if cell.skip:
        rec["status"] = "skip"
        rec["reason"] = cell.skip
        return rec

    t0 = time.time()
    # the spec trees depend on the mesh; a one-device step's counts do not
    counts = {} if counts is None else counts
    with fake_process_mesh(mesh) as pmesh:
        spec = arch.build_dryrun(shape, pmesh)
        key = (arch_name, shape) + ((mesh.name,) if spec.meta.get("per_rank") else ())
        if key not in counts:
            counts[key] = count_cell(spec, mesh)
    count = counts[key][2]
    t_count = time.time() - t0
    memory, rep = report_for(spec, mesh, counts[key], arch_name, shape)
    rec.update(t_count_s=round(t_count, 2), n_devices=mesh.size, memory=memory,
               meta=spec.meta)
    if rep is None:
        rec.update(status="state_only", reason=spec.meta["not_counted"], counted_flops=None)
    else:
        rec.update(status="ok", counted_flops=count.flops, ops=count.ops,
                   flops_by_dtype=count.flops_by_dtype, roofline=rep.row(),
                   counted_on=rep.counted_on)
        if count.per_rank:
            rec["collective_bytes_by_kind"] = count.collective_bytes_by_kind
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = f"{arch_name}__{shape}__{mesh.name}.json".replace("/", "_")
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def result_line(rec: dict) -> str:
    m = rec["memory"]
    head = (f"RESULT {rec['arch']} {rec['shape']} {rec['mesh']}: "
            f"state/dev={m['per_device_state_gb']}GB state_fits_80gb={m['state_fits_80gb']} "
            f"model_flops={rec['meta']['model_flops']:.4e} ")
    if rec["status"] != "ok":
        return head + f"counted_flops=None ({rec['reason']})"
    r = rec["roofline"]
    x = "None" if r["t_collective_s"] is None else f"{r['t_collective_s']:.2e}"
    tail = ""
    if rec.get("counted_on") == "rank0":
        tail = (f" collective_bytes={r['collective_bytes']:.4e} "
                f"temp/dev={m['temp_bytes'] / 2**30:.3f}GB peak/dev={m['per_device_peak_gb']}GB "
                f"fits_80gb={m['fits_80gb']}")
    return head + (
        f"counted_flops={rec['counted_flops']:.4e} ({rec.get('counted_on', 'even_split')}) "
        f"peak={r['peak']} bottleneck={r['bottleneck']} "
        f"t=(c {r['t_compute_s']:.2e}, m {r['t_memory_s']:.2e}, x {x})s "
        f"roofline_frac={r['roofline_fraction']:.3f}" + tail)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose artifact already exists")
    args = ap.parse_args(argv)

    from repro_torch.configs import all_cells

    if args.list:
        for name, cell in all_cells():
            print(f"{name:18s} {cell.shape:16s} {cell.kind:10s} "
                  f"{'SKIP: ' + cell.skip if cell.skip else ''}")
        return 0

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        failures = 0
        for name, cell in all_cells():
            tag = f"{name} x {cell.shape} x {args.mesh}"
            if cell.skip:
                print(f"[dryrun] SKIP {tag}: {cell.skip}")
                continue
            names = [make_production_mesh(multi_pod=(mk == "multi")).name for mk in meshes]
            arts = [os.path.join(args.out, f"{name}__{cell.shape}__{n}.json") for n in names]
            if args.resume and all(os.path.exists(a) for a in arts):
                print(f"[dryrun] HAVE {tag}")
                continue
            t0 = time.time()
            p = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", name,
                 "--shape", cell.shape, "--mesh", args.mesh, "--out", args.out],
                capture_output=True, text=True, timeout=args.timeout)
            dt = time.time() - t0
            if p.returncode == 0:
                tail = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT")]
                print(f"[dryrun] OK   {tag} ({dt:.0f}s)")
                for ln in tail:
                    print(f"  {ln}")
            else:
                failures += 1
                print(f"[dryrun] FAIL {tag} ({dt:.0f}s)")
                print(p.stdout[-2000:])
                print(p.stderr[-4000:])
        print(f"[dryrun] done, {failures} failures")
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, --all or --list")
    counts: Dict[tuple, tuple] = {}
    for mk in meshes:
        try:
            rec = run_cell(args.arch, args.shape, mk, args.out, counts)
        except Exception:
            traceback.print_exc()
            return 1
        if rec["status"] == "skip":
            print(f"SKIP: {rec['reason']}")
            continue
        print(json.dumps(rec, indent=1, default=str)[:2000])
        print(result_line(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
