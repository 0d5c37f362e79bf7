"""Shared layers of the LM, as functions over tensors (the reference's
`models/layers.py`, same ops in the same order). The loss heads wait for
the training slice.

Float division by a constant goes through `div`: PyTorch's CUDA kernels
divide by a Python float as a multiply by its reciprocal, which can be an
ulp off the true quotient the CPU gives.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def div(x: torch.Tensor, value: float) -> torch.Tensor:
    """x / value as a true division on every device, the divisor in x's
    dtype (as a Python scalar divides in JAX)."""
    return x / torch.full((1,), value, dtype=x.dtype, device=x.device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with the (1 + weight) gain; output in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on the last dim, split-half convention; frequencies
    and angles in float32. x: (..., S, D); positions: (..., S) int."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** div(torch.arange(0, half, dtype=torch.float32,
                                             device=x.device), half))
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """(silu(x @ w_gate) * (x @ w_up)) @ w_down; weights (in, out)."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """cap * tanh(logits / cap); None leaves the logits as they are."""
    if cap is None:
        return logits
    return cap * torch.tanh(div(logits, cap))
