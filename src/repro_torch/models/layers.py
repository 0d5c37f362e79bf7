"""Shared layers of the LM and the GNN / recsys zoo, as functions over
tensors (the reference's `models/layers.py`, same ops in the same order),
with its loss heads.

Float division by a constant goes through `div`: PyTorch's CUDA kernels
divide by a Python float as a multiply by its reciprocal, which can be an
ulp off the true quotient the CPU gives.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def div(x: torch.Tensor, value: float) -> torch.Tensor:
    """x / value as a true division on every device, the divisor in x's
    dtype (as a Python scalar divides in JAX). A 0-dim x stays 0-dim (its
    divisor is a 0-dim tensor on x's device, which CUDA divides truly too)."""
    return x / torch.full((1,) if x.dim() else (), value, dtype=x.dtype, device=x.device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with the (1 + weight) gain; output in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last dim in float32 (the biased variance, as
    `jnp.var`); output in x's dtype."""
    xf = x.float()
    c = xf - torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(c * c, dim=-1, keepdim=True)
    return (c * torch.rsqrt(var + eps) * weight.float() + bias.float()).to(x.dtype)


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


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: Optional[torch.Tensor],
             w_out: torch.Tensor, b_out: Optional[torch.Tensor]) -> torch.Tensor:
    """gelu(x @ w_in + b_in) @ w_out + b_out, biases optional. gelu is the
    tanh approximation, `jax.nn.gelu`'s default (`F.gelu`'s is the exact
    erf form)."""
    h = x @ w_in
    if b_in is not None:
        h = h + b_in
    o = F.gelu(h, approximate="tanh") @ w_out
    return o if b_out is None else o + b_out


def mlp_stack(x: torch.Tensor, weights, biases, act=F.relu,
              final_act: bool = False) -> torch.Tensor:
    """x through the layers (w, b) (b may be None), `act` after each but the
    last (and after the last too with final_act)."""
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = x @ w
        if b is not None:
            x = x + b
        if i < n - 1 or final_act:
            x = act(x)
    return x


def softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """cap * tanh(logits / cap); None leaves the logits as they are."""
    if cap is None:
        return logits
    return cap * torch.tanh(div(logits, cap))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean NLL of `labels` (int) under `logits` (..., V), in float32; with a
    mask, the masked mean over at least one."""
    lf = logits.float()
    nll = torch.logsumexp(lf, dim=-1) - torch.gather(lf, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return div(torch.sum(nll), float(nll.numel()))


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over every entry, the mean a true division."""
    d = pred - target
    return div(torch.sum(d * d), float(d.numel()))


def _chunk_nll(x: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor,
               cap: Optional[float]) -> torch.Tensor:
    logits = softcap((x @ unembed).float(), cap)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


def _chunk_nll_vocab_parallel(x: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor,
                              cap: Optional[float], group, vocab_lo: int) -> torch.Tensor:
    """The summed NLL of a chunk whose vocab is split over `group`: this
    rank's logits are columns [vocab_lo, vocab_lo + V_loc). The shift is
    the row max over the group (no gradient: it cancels), the sum of exps
    a psum, and the label's logit is taken on the rank that owns it and
    psum'd."""
    from repro_torch.distributed import collectives as C

    logits = softcap((x @ unembed).float(), cap)  # (..., V_loc)
    v_loc = logits.shape[-1]
    shift = C.pmax(logits.amax(-1), group)
    lse = shift + torch.log(C.psum(torch.sum(torch.exp(logits - shift[..., None]), -1), group))
    lab = labels.long() - vocab_lo
    mine = (lab >= 0) & (lab < v_loc)
    own = torch.gather(logits, -1, lab.clamp(0, v_loc - 1)[..., None])[..., 0]
    gold = C.psum(torch.where(mine, own, torch.zeros((), device=own.device)), group)
    return torch.sum(lse - gold)


def chunked_unembed_xent(x: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor,
                         cap: Optional[float] = None, chunk: int = 512, group=None,
                         vocab_lo: int = 0, mean: bool = True) -> torch.Tensor:
    """Unembed + cross-entropy (mean NLL) of x (B, S, d) against labels
    (B, S), chunked over the sequence so that the (B, S, V) float32 logits
    never exist at once: each chunk's summed NLL runs under
    `torch.utils.checkpoint` (its backward recomputes the chunk's logits),
    and the sum over chunks is divided by B * S. One whole-logits pass when
    S % chunk != 0 or S <= chunk, as the reference.

    Vocab-parallel with a `group`: `unembed` is this rank's columns of the
    vocab, starting at `vocab_lo`, and the logits are (B, chunk, V_loc);
    the chunks are the same. mean=False returns the summed NLL (a sharded
    step divides the psum of sums over the batch axes itself)."""
    B, S, _ = x.shape
    if group is None and (S % chunk != 0 or S <= chunk):
        if mean:
            return cross_entropy_loss(softcap((x @ unembed).float(), cap), labels)
        return _chunk_nll(x, unembed, labels, cap)
    step = S if (S % chunk != 0 or S <= chunk) else chunk
    total = None
    for i in range(0, S, step):
        args = (x[:, i:i + step], unembed, labels[:, i:i + step], cap)
        if group is None:
            part = checkpoint(_chunk_nll, *args, use_reentrant=False)
        elif step == S:
            part = _chunk_nll_vocab_parallel(*args, group, vocab_lo)
        else:
            part = checkpoint(_chunk_nll_vocab_parallel, *args, group, vocab_lo,
                              use_reentrant=False)
        total = part if total is None else total + part
    return div(total, float(B * S)) if mean else total
