"""qwen2.5-14b [hf:Qwen/Qwen2.5 family]: 48L d_model=5120 40H (GQA kv=8)
d_ff=13824 vocab=152064, QKV bias. head_dim=128."""

from __future__ import annotations

import torch

from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig


def model_cfg() -> LMConfig:
    return LMConfig(name="qwen2.5-14b", n_layers=48, d_model=5120, n_heads=40,
                    n_kv_heads=8, head_dim=128, d_ff=13824, vocab=152064, qkv_bias=True,
                    rope_theta=1_000_000.0, grad_accum=8)


def smoke_cfg() -> LMConfig:
    return LMConfig(name="qwen2.5-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                    head_dim=16, d_ff=128, vocab=256, qkv_bias=True,
                    dtype=torch.float32, remat=False)


ARCH = base.ArchDef(
    name="qwen2.5-14b",
    family="lm",
    cells=base.lm_cells(long_ok=False),
    model_cfg=model_cfg,
    smoke_cfg=smoke_cfg,
    build_dryrun=lambda shape, mesh: base.build_lm_dryrun(
        model_cfg(), shape, mesh, ARCH.cell(shape)
    ),
)
