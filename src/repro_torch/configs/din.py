"""din [arXiv:1706.06978]: embed_dim=18 seq_len=100 attn_mlp=80-40
mlp=200-80, interaction = target attention.

Shapes: train_batch (B=65,536), serve_p99 (B=512), serve_bulk (B=262,144),
retrieval_cand (batch=1 x 1,000,000 candidates, batched-dot scoring)."""

from __future__ import annotations

from repro_torch.models.recsys import din as model

SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}


def model_cfg() -> model.DINConfig:
    return model.DINConfig(
        embed_dim=18, seq_len=100, n_items=1_048_576, n_cats=16_384,
        attn_hidden=(80, 40), mlp_hidden=(200, 80), d_profile=8,
    )


def smoke_cfg() -> model.DINConfig:
    return model.DINConfig(
        embed_dim=8, seq_len=12, n_items=1024, n_cats=64,
        attn_hidden=(16, 8), mlp_hidden=(24, 12), d_profile=4,
    )
