"""dbrx-132b [hf:databricks/dbrx-base]: 40L d_model=6144 48H (GQA kv=8)
d_ff=10752 vocab=100352, MoE 16 experts top-4 (fine-grained). head_dim=128."""

from __future__ import annotations

import torch

from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig


def model_cfg() -> LMConfig:
    return LMConfig(name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
                    head_dim=128, d_ff=10752, vocab=100352, n_experts=16,
                    n_experts_padded=16, top_k=4, d_ff_expert=10752, d_ff_shared=0,
                    rope_theta=500_000.0, grad_accum=16)


def smoke_cfg() -> LMConfig:
    return LMConfig(name="dbrx-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                    head_dim=16, d_ff=128, vocab=256, n_experts=4, n_experts_padded=4,
                    top_k=2, d_ff_expert=128,
                    capacity_factor=8.0,  # drop-free at smoke scale
                    dtype=torch.float32, remat=False)


ARCH = base.ArchDef(
    name="dbrx-132b",
    family="lm",
    cells=base.lm_cells(long_ok=False),
    model_cfg=model_cfg,
    smoke_cfg=smoke_cfg,
    build_dryrun=lambda shape, mesh: base.build_lm_dryrun(
        model_cfg(), shape, mesh, ARCH.cell(shape)
    ),
)
