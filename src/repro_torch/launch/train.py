"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs an arch's smoke config end to end through `train.Trainer`, as the
reference's `launch/train.py` does, with checkpoint/restart and
non-finite-gradient skipping. Each family has its deterministic data:

  - LMs (qwen3-4b, qwen2.5-14b, gemma2-27b, qwen2-moe-a2.7b, dbrx-132b):
    `data.tokens.token_batch`, a (batch, seq) batch per step;
  - recsys (din): `data.recsys.din_batch`, `batch` click logs per step
    (`--seq` is unused: the config's history length holds);
  - GNNs (pna, egnn, graphcast, equiformer-v2): one Cora-like graph of 400
    nodes and ~1,600 edges (`graph.generators.cora_like_graph`) through
    `data.graphs.full_graph_batch`, the same batch every step.

On CUDA unless `--device cpu`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        [--steps 50] [--batch 8] [--seq 128] [--ckpt-dir DIR] [--ckpt-every 20] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import (dbrx_132b, din, egnn, equiformer_v2, gemma2_27b, graphcast,
                                 pna, qwen2_5_14b, qwen2_moe_a2_7b, qwen3_4b)
from repro_torch.data.graphs import full_graph_batch
from repro_torch.data.recsys import din_batch
from repro_torch.data.tokens import token_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.generators import cora_like_graph
from repro_torch.models import transformer as T
from repro_torch.models.gnn import egnn as gnn_egnn
from repro_torch.models.gnn import equiformer_v2 as gnn_equiformer_v2
from repro_torch.models.gnn import graphcast as gnn_graphcast
from repro_torch.models.gnn import pna as gnn_pna
from repro_torch.models.param import init_params
from repro_torch.models.recsys import din as din_model

LM_ARCHS = {"qwen3-4b": qwen3_4b, "qwen2.5-14b": qwen2_5_14b, "gemma2-27b": gemma2_27b,
            "qwen2-moe-a2.7b": qwen2_moe_a2_7b, "dbrx-132b": dbrx_132b}
GNN_ARCHS = {"pna": (pna, gnn_pna), "egnn": (egnn, gnn_egnn),
             "graphcast": (graphcast, gnn_graphcast),
             "equiformer-v2": (equiformer_v2, gnn_equiformer_v2)}


def build_smoke_training(arch_name: str, batch: int, seq: int, device: DeviceLike = None):
    """(loss_fn, init_params_fn, batch_fn) of an arch's smoke config; the
    parameters are drawn on `device` from a generator seeded with 0."""
    dev = resolve_device(device)
    draw = lambda specs: init_params(specs, torch.Generator(device=dev).manual_seed(0), dev)
    if arch_name in LM_ARCHS:
        cfg = LM_ARCHS[arch_name].smoke_cfg()
        return (
            lambda p, b: T.loss_fn(p, b, cfg),
            lambda: T.unstack_layers(draw(T.lm_param_specs(cfg)), cfg),
            lambda step: token_batch(step, batch, seq, cfg.vocab),
        )
    if arch_name == "din":
        cfg = din.smoke_cfg()
        return (
            lambda p, b: din_model.loss_fn(p, b, cfg),
            lambda: draw(din_model.param_specs(cfg)),
            lambda step: din_batch(step, batch, seq_len=cfg.seq_len, n_items=cfg.n_items,
                                   n_cats=cfg.n_cats, d_profile=cfg.d_profile),
        )
    if arch_name in GNN_ARCHS:
        conf, model = GNN_ARCHS[arch_name]
        cfg = conf.smoke_cfg()
        g, feats, labels = cora_like_graph(n=400, e_target=1600, d_feat=cfg.d_in,
                                           n_classes=cfg.n_out)
        b = full_graph_batch(g, feats, labels)
        return (
            lambda p, bb: model.loss_fn(p, bb, cfg),
            lambda: draw(model.param_specs(cfg)),
            lambda step: b,
        )
    raise ValueError(f"unknown arch {arch_name!r}")


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
