"""Flash attention on Hopper: the LM's attention, forward and backward.

The CUDA kernels are in `csrc/flash_attention.cu` (forward) and
`csrc/flash_attention_bwd.cu` (backward); see their headers for what they
replace, their design and what bounds them. The forward's route is chosen
by dtype alone: bfloat16 runs on the tensor cores (bf16 MMAs, P @ V in two
bf16 halves of P), float32 on the CUDA cores (float32 FMAs). So is the
backward's (three launches: statistics, dK / dV, dQ): bfloat16 runs all
five products on the tensor cores (bf16 MMAs, P rounded once, dU in two
bf16 halves), float32 runs float32 FMAs on the CUDA cores.

`flash_attention` is differentiable: on CUDA tensors it is an autograd
`Function` whose forward launches the forward kernel and whose backward
launches the backward kernel (`flash_attention_bwd`). Each wrapper checks
its inputs, launches on the current stream and counts launches in
`kernels.build.LAUNCHES`. For tensors on the CPU both run the kernels'
plain versions instead (`kernels.ref.attention_ref`, differentiated by
autograd; `attention_grads_ref`) and count nothing; on a CUDA tensor they
launch their kernel or raise.

q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), contiguous, one dtype
(float32 or bfloat16), 1 <= D <= 128, Hq % Hkv == 0; any Sq and Skv.
Output (B, Hq, Sq, D) in q's dtype. Queries and keys both count positions
from 0 (the reference kernel takes no offset).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import launch, load_library
from repro_torch.kernels.ref import attention_grads_ref, attention_ref

MAX_HEAD_DIM = 128
BLOCK_Q = 64  # query rows per CUDA block, both routes (csrc f32::kBQ, tc::kBQ)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           softcap: Optional[float]) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Hq, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[1] < 1 or Hq % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not pair "
                         "(same batch and head dim, Hq % Hkv == 0)")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} not in [1, {MAX_HEAD_DIM}]")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention with an online softmax; see the module docstring."""
    _check(q, k, v, softcap)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                             scale=scale)
    return _Flash.apply(q, k, v, causal, window, softcap, scale)


class _Flash(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        out = _forward(q, k, v, causal, window, softcap, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.opts = (causal, window, softcap, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do.contiguous(), *ctx.opts)
        return dq, dk, dv, None, None, None, None


def _forward(q, k, v, causal, window, softcap, scale) -> torch.Tensor:
    B, Hq, Sq, _ = q.shape
    if B * Hq * -(-Sq // BLOCK_Q) >= 2**31:
        raise ValueError(f"grid of {B * Hq * -(-Sq // BLOCK_Q)} blocks is too large")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    launch("flash_attention", load_library().flash_attention_fwd, q.device,
           *fwd_args(q, k, v, out, causal, window, softcap, scale))
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, do: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None, softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> tuple:
    """(dq, dk, dv) of `flash_attention(q, k, v, ...)` for the output
    gradient `do`, given its output `out`; dk and dv sum over each kv
    head's q heads. Same dtype and layout rules as the forward; `out` and
    `do` are shaped like q."""
    _check(q, k, v, softcap)
    for name, t in (("out", out), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor shaped, typed and placed "
                             f"as q {tuple(q.shape)}, got {tuple(t.shape)} {t.dtype}")
    if q.device.type == "cpu":
        return attention_grads_ref(q, k, v, do, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if max(B * Hq * -(-Sq // BLOCK_Q), B * Hkv * -(-Skv // BLOCK_Q)) >= 2**31:
        raise ValueError("grid too large for the backward kernel")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    work = torch.empty(3 * B * Hq * Sq, dtype=torch.float32, device=q.device)  # statistics
    launch("flash_attention_bwd", load_library().flash_attention_bwd, q.device,
           *bwd_args(q, k, v, out, do, dq, dk, dv, work, causal, window, softcap, scale))
    return dq, dk, dv


def fwd_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
             causal: bool, window: Optional[int], softcap: Optional[float],
             scale: Optional[float]) -> tuple:
    """`flash_attention_fwd`'s arguments before the stream, for checked
    CUDA tensors; `flash_compare.py` launches an older kernel with them."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    scale_v = scale if scale is not None else 1.0 / (D ** 0.5)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            B, Hq, Hkv, Sq, Skv, D, int(causal), int(window is not None),
            0 if window is None else int(window), float(softcap or 0.0), float(scale_v))


def bwd_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
             do: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
             work: torch.Tensor, causal: bool, window: Optional[int],
             softcap: Optional[float], scale: Optional[float]) -> tuple:
    """`flash_attention_bwd`'s C arguments before the stream, for checked
    CUDA tensors, the gradients and a float32 workspace of 3 * B * Hq * Sq;
    `flash_compare.py --bwd` launches an older kernel with them."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    scale_v = scale if scale is not None else 1.0 / (D ** 0.5)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(), _DTYPES[q.dtype],
            B, Hq, Hkv, Sq, Skv, D, int(causal), int(window is not None),
            0 if window is None else int(window), float(softcap or 0.0), float(scale_v))
