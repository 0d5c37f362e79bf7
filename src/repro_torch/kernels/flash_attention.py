"""Flash attention forward on Hopper: the prefill attention of the LM.

The CUDA kernels are in `csrc/flash_attention.cu` (see its header for the
TPU kernel they replace, their design and what bounds them). The route is
chosen by dtype alone: bfloat16 runs on the tensor cores (bf16 MMAs, P @ V
in two bf16 halves of P), float32 on the CUDA cores (float32 FMAs). The
wrapper here checks its inputs, launches the kernel on the current stream
and counts launches in `kernels.build.LAUNCHES`. For tensors on the CPU it
runs the kernels' plain version (`kernels.ref.attention_ref`) instead and
counts nothing; on a CUDA tensor it launches the kernel of its dtype or
raises.

q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), contiguous, one dtype
(float32 or bfloat16), 1 <= D <= 128, Hq % Hkv == 0; any Sq and Skv.
Output (B, Hq, Sq, D) in q's dtype. Queries and keys both count positions
from 0 (the reference kernel takes no offset).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import launch, load_library
from repro_torch.kernels.ref import attention_ref

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
    B, Hq, Sq, _ = q.shape
    if B * Hq * -(-Sq // BLOCK_Q) >= 2**31:
        raise ValueError(f"grid of {B * Hq * -(-Sq // BLOCK_Q)} blocks is too large")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    launch("flash_attention", load_library().flash_attention_fwd, q.device,
           *fwd_args(q, k, v, out, causal, window, softcap, scale))
    return out


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
