"""GraphCast weather mode at toy scale (the reference's
`examples/weather_graphcast.py`): encoder-processor-decoder over an
icosahedral multimesh (grid2mesh -> 4 interaction layers -> mesh2grid),
trained to predict a synthetic smooth field's next state.

    PYTHONPATH=src python -m repro_torch.examples.weather_graphcast [--steps 60] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.generators import icosahedral_multimesh
from repro_torch.models.gnn import graphcast
from repro_torch.models.param import init_params, param_count
from repro_torch.train.train_step import init_train_state, make_train_step


def run(steps: int = 60, refinement: int = 2, n_vars: int = 8, device: DeviceLike = None,
        params: Optional[dict] = None, out: Callable[[str], None] = print) -> dict:
    """The example at the given sizes (the defaults are the reference's);
    `params` replaces the draw (seed 0 on the device). Returns the losses
    (one a step) and the trained state."""
    dev = resolve_device(device)
    mm = icosahedral_multimesh(refinement=refinement, grid_per_mesh=3)
    out(f"multimesh: {mm.n_mesh} mesh nodes ({mm.mesh_src.size} edges, "
        f"all refinement levels), {mm.n_grid} grid points")

    cfg = graphcast.GraphCastConfig(n_layers=4, d_hidden=64, n_vars=n_vars, d_in=n_vars,
                                    n_out=n_vars, mode="weather")
    specs = graphcast.param_specs(cfg)
    if params is None:
        params = init_params(specs, torch.Generator(device=dev).manual_seed(0), dev)
    out(f"params: {param_count(specs) / 1e6:.2f}M")

    # synthetic dynamics: state rotates through smooth harmonics
    rng = np.random.default_rng(0)
    basis = rng.standard_normal((mm.n_grid, n_vars)).astype(np.float32)
    edges = {k: torch.as_tensor(getattr(mm, k), device=dev)
             for k in ("mesh_src", "mesh_dst", "g2m_src", "g2m_dst", "m2g_src", "m2g_dst")}

    def batch_fn(step: int) -> dict:
        t = step * 0.1
        x = np.sin(t) * basis + 0.5 * np.cos(2 * t) * np.roll(basis, 1, 1)
        y = np.sin(t + 0.1) * basis + 0.5 * np.cos(2 * (t + 0.1)) * np.roll(basis, 1, 1)
        # float64 on the host, float32 on the device (jnp.asarray's cast)
        return dict(edges, grid_feat=torch.as_tensor(x.astype(np.float32), device=dev),
                    grid_target=torch.as_tensor(y.astype(np.float32), device=dev))

    # n_mesh is a static size, not a batch leaf
    def loss(p, b):
        return graphcast.loss_fn(p, dict(b, n_mesh=mm.n_mesh), cfg)

    step_fn = make_train_step(loss, warmup=10, total_steps=steps)
    state = init_train_state(params)
    losses = []
    for step in range(steps):
        state, m = step_fn(state, batch_fn(step))
        losses.append(float(m["loss"]))
        if step % 10 == 0:
            out(f"step {step:4d}  mse {losses[-1]:.4f}")
    out(f"mse {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")
    return dict(losses=losses, state=state)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--refinement", type=int, default=2)
    ap.add_argument("--vars", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return run(args.steps, args.refinement, args.vars, device=args.device)


if __name__ == "__main__":
    main()
