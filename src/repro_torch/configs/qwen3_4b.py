"""qwen3-4b [hf:Qwen/Qwen3 family]: 36L d_model=2560 32H (GQA kv=8)
d_ff=9728 vocab=151936, per-head qk RMS-norm, no QKV bias. head_dim=128."""

from __future__ import annotations

import torch

from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig


def model_cfg() -> LMConfig:
    return LMConfig(name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
                    head_dim=128, d_ff=9728, vocab=151936, qk_norm=True,
                    rope_theta=1_000_000.0, grad_accum=4)


def smoke_cfg() -> LMConfig:
    return LMConfig(name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                    head_dim=16, d_ff=128, vocab=256, qk_norm=True,
                    dtype=torch.float32, remat=False)


ARCH = base.ArchDef(
    name="qwen3-4b",
    family="lm",
    cells=base.lm_cells(long_ok=False),
    model_cfg=model_cfg,
    smoke_cfg=smoke_cfg,
    build_dryrun=lambda shape, mesh: base.build_lm_dryrun(
        model_cfg(), shape, mesh, ARCH.cell(shape)
    ),
)
