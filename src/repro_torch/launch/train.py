"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs an LM's smoke config end to end through `train.Trainer`, as the
reference's `launch/train.py` does: the deterministic token pipeline
(`data.tokens.token_batch`, one batch per step), checkpoint/restart,
non-finite-gradient skipping. On CUDA unless `--device cpu`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        [--steps 50] [--batch 8] [--seq 128] [--ckpt-dir DIR] [--ckpt-every 20] \\
        [--device cuda|cpu]

Only the LM family is ported: the recsys (din) and GNN archs (pna, egnn,
graphcast, equiformer-v2) wait for the GNN and recsys model zoo (ROADMAP,
Queue 1 item 6) and raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import dbrx_132b, gemma2_27b, qwen2_5_14b, qwen2_moe_a2_7b, qwen3_4b
from repro_torch.device import DeviceLike, resolve_device

LM_ARCHS = {"qwen3-4b": qwen3_4b, "qwen2.5-14b": qwen2_5_14b, "gemma2-27b": gemma2_27b,
            "qwen2-moe-a2.7b": qwen2_moe_a2_7b, "dbrx-132b": dbrx_132b}
ZOO_ARCHS = ("din", "pna", "egnn", "graphcast", "equiformer-v2")


def build_smoke_training(arch_name: str, batch: int, seq: int, device: DeviceLike = None):
    """(loss_fn, init_params_fn, batch_fn) of an arch's smoke config; the
    parameters are drawn on `device` from a generator seeded with 0."""
    if arch_name in ZOO_ARCHS:
        raise NotImplementedError(
            f"{arch_name}: the GNN and recsys models are not ported yet (ROADMAP, Queue 1 "
            "item 6, the GNN and recsys zoo)")
    if arch_name not in LM_ARCHS:
        raise ValueError(f"unknown arch {arch_name!r}")
    from repro_torch.data.tokens import token_batch
    from repro_torch.models import transformer as T
    from repro_torch.models.param import init_params

    cfg = LM_ARCHS[arch_name].smoke_cfg()
    dev = resolve_device(device)
    specs = T.lm_param_specs(cfg)
    return (
        lambda p, b: T.loss_fn(p, b, cfg),
        lambda: T.unstack_layers(
            init_params(specs, torch.Generator(device=dev).manual_seed(0), dev), cfg),
        lambda step: token_batch(step, batch, seq, cfg.vocab),
    )


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = resolve_device(args.device)
    loss_fn, init_fn, batch_fn = build_smoke_training(args.arch, args.batch, args.seq, dev)
    trainer = Trainer(loss_fn, init_fn, batch_fn,
                      TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                                    ckpt_dir=args.ckpt_dir, log_every=max(1, args.steps // 10)),
                      device=dev)
    state = trainer.run()
    print(f"[train] finished at step {int(state.step)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
