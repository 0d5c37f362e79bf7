"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d_model=2048 16H
(GQA kv=16) d_ff=1408 vocab=151936, MoE 60 routed experts top-4 + 4 shared
(shared_expert_intermediate = 4 x 1408 = 5632). head_dim=128 (HF config)."""

from __future__ import annotations

import torch

from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig


def model_cfg() -> LMConfig:
    return LMConfig(name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
                    n_kv_heads=16, head_dim=128, d_ff=1408, vocab=151936, n_experts=60,
                    n_experts_padded=64,  # the reference pads for its 16-way model axis
                    top_k=4, d_ff_expert=1408, d_ff_shared=5632, qkv_bias=True,
                    rope_theta=1_000_000.0, grad_accum=4)


def smoke_cfg() -> LMConfig:
    return LMConfig(name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                    head_dim=16, d_ff=128, vocab=256, n_experts=4, n_experts_padded=4,
                    top_k=2, d_ff_expert=64, d_ff_shared=128,
                    capacity_factor=8.0,  # drop-free at smoke scale
                    qkv_bias=True, dtype=torch.float32, remat=False)


ARCH = base.ArchDef(
    name="qwen2-moe-a2.7b",
    family="lm",
    cells=base.lm_cells(long_ok=False),
    model_cfg=model_cfg,
    smoke_cfg=smoke_cfg,
    build_dryrun=lambda shape, mesh: base.build_lm_dryrun(
        model_cfg(), shape, mesh, ARCH.cell(shape)
    ),
)
