"""Learning-rate schedules (the reference's `optim/schedule.py`)."""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import div


def warmup_cosine(step, base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to `base_lr` over `warmup` steps, then a cosine down to
    `min_frac * base_lr` at `total`; () float32 on `step`'s device. The
    divisions by the step counts are true divisions (`layers.div`)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = div(base_lr * s, float(max(warmup, 1)))
    prog = torch.clamp(div(s - warmup, float(max(total - warmup, 1))), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
