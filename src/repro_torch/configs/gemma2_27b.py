"""gemma2-27b [arXiv:2408.00118]: 46L d_model=4608 32H (GQA kv=16)
d_ff=36864 vocab=256000. Alternating local (window=4096) / global
attention, attention logit softcap 50, final logit softcap 30, post-norms,
embedding scaling. head_dim=128."""

from __future__ import annotations

import torch

from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig


def model_cfg() -> LMConfig:
    return LMConfig(name="gemma2-27b", n_layers=46, d_model=4608, n_heads=32,
                    n_kv_heads=16, head_dim=128, d_ff=36864, vocab=256000, window=4096,
                    pattern=("local", "global"), attn_softcap=50.0, final_softcap=30.0,
                    embed_scale=True, post_norms=True, grad_accum=8)


def smoke_cfg() -> LMConfig:
    return LMConfig(name="gemma2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                    head_dim=16, d_ff=128, vocab=256, window=16, pattern=("local", "global"),
                    attn_softcap=50.0, final_softcap=30.0, embed_scale=True,
                    post_norms=True, dtype=torch.float32, remat=False)


ARCH = base.ArchDef(
    name="gemma2-27b",
    family="lm",
    cells=base.lm_cells(long_ok=True),
    model_cfg=model_cfg,
    smoke_cfg=smoke_cfg,
    build_dryrun=lambda shape, mesh: base.build_lm_dryrun(
        model_cfg(), shape, mesh, ARCH.cell(shape)
    ),
)
