"""DIN recsys serving (the reference's `examples/din_serving.py`): train
briefly on synthetic click logs, then run the three serving shapes
(p99-style small batches, bulk scoring, retrieval against many candidates)
and report AUC and throughput.

The latencies are walls of the device's work: each timed call builds its
batch on the host, copies it to the device, scores it and waits for the
device (`torch.cuda.synchronize`), as the reference's walls include its
batch build and `block_until_ready`. p50 is the median of those walls and
qps the batch over it.

    PYTHONPATH=src python -m repro_torch.examples.din_serving [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import din as din_config
from repro_torch.data.recsys import din_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.param import init_params, tree_map
from repro_torch.models.recsys import din
from repro_torch.train.train_step import init_train_state, make_train_step

SERVE = (("serve_p99", 512, 20), ("serve_bulk", 8192, 3))  # (name, batch, timed calls)


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels == 1
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg: Optional[din.DINConfig] = None, train_steps: int = 80, train_batch: int = 256,
        serve: Sequence[Tuple[str, int, int]] = SERVE, n_candidates: int = 100_000,
        device: DeviceLike = None, params: Optional[dict] = None,
        out: Callable[[str], None] = print) -> dict:
    """The example at the given sizes (the defaults are the reference's, on
    its smoke config); `params` replaces the draw (seed 0 on the device).
    Returns the trained parameters, the losses, and per serving shape its
    walls, p50, qps, scores and AUC, and the retrieval's."""
    dev = resolve_device(device)
    cfg = cfg or din_config.smoke_cfg()
    if params is None:
        params = init_params(din.param_specs(cfg), torch.Generator(device=dev).manual_seed(0),
                             dev)

    def mk(step: int, B: int) -> dict:
        b = din_batch(step, B, seq_len=cfg.seq_len, n_items=cfg.n_items, n_cats=cfg.n_cats,
                      d_profile=cfg.d_profile)
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    # --- brief training ----------------------------------------------------
    step_fn = make_train_step(lambda p, b: din.loss_fn(p, b, cfg), warmup=5,
                              total_steps=train_steps)
    state = init_train_state(params)
    losses = []
    for step in range(train_steps):
        state, m = step_fn(state, mk(step, train_batch))
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    params = tree_map(lambda p: p.detach(), state.params)
    out(f"trained {train_steps} steps, final bce {losses[-1]:.4f}")
    result = dict(params=params, losses=losses)

    # --- serve_p99 / serve_bulk -------------------------------------------
    with torch.no_grad():
        score = lambda b: din.score(params, b, cfg)
        for name, B, reps in serve:
            score(mk(999, B))  # warm-up
            _sync(dev)
            lat = []
            for r in range(reps):
                t0 = time.perf_counter()
                s = score(mk(1000 + r, B))
                _sync(dev)
                lat.append(time.perf_counter() - t0)
            s_np = s.cpu().numpy()
            a = auc(s_np, mk(1000 + reps - 1, B)["label"].cpu().numpy())
            p50 = float(np.median(lat))
            out(f"{name:10s} B={B:6d}  p50 {p50 * 1e3:7.2f} ms  qps {B / p50:10.0f}  "
                f"auc {a:.3f}")
            result[name] = dict(batch=B, walls_s=lat, p50_ms=p50 * 1e3, qps=B / p50,
                                scores=s_np, auc=float(a))

        # --- retrieval_cand --------------------------------------------------
        rng = np.random.default_rng(7)
        nc = n_candidates
        b = {
            "hist_items": rng.integers(0, cfg.n_items, (1, cfg.seq_len)).astype(np.int32),
            "hist_cats": rng.integers(0, cfg.n_cats, (1, cfg.seq_len)).astype(np.int32),
            "profile": rng.standard_normal((1, cfg.d_profile)).astype(np.float32),
            "cand_items": rng.integers(0, cfg.n_items, nc).astype(np.int32),
            "cand_cats": rng.integers(0, cfg.n_cats, nc).astype(np.int32),
        }
        b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        din.retrieval_scores(params, b, cfg)
        _sync(dev)
        t0 = time.perf_counter()
        s = din.retrieval_scores(params, b, cfg)
        _sync(dev)
        dt = time.perf_counter() - t0
    s_np = s.cpu().numpy()
    top = np.argsort(s_np)[-5:][::-1]
    out(f"retrieval  1x{nc} candidates in {dt * 1e3:.1f} ms "
        f"({nc / dt / 1e6:.1f}M cand/s); top-5 ids {top.tolist()}")
    result["retrieval"] = dict(candidates=nc, wall_s=dt, scores=s_np, top5=top.tolist())
    return result


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
