"""Dispatch between the kernels and their plain versions (the reference's
`kernels/ops.py`).

The reference picks its Pallas kernel on a TPU and the jnp version
elsewhere; here the kernel runs where the tensors lie on a CUDA device.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention

CHUNK_ABOVE = 2048 * 2048  # Sq * Skv above which the plain path goes by q chunks


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
              window: Optional[int] = None, softcap: Optional[float] = None,
              scale: Optional[float] = None, q_offset: int = 0,
              allow_chunk: bool = True) -> torch.Tensor:
    """GQA attention, q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D). On CUDA tensors
    with Sq > 1 and q_offset == 0 it is the flash kernel (the reference's
    TPU branch); otherwise the plain version, by q chunks when allow_chunk
    and Sq * Skv > 2048**2."""
    if q.is_cuda and q.shape[2] > 1 and q_offset == 0:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window, softcap=softcap,
                               scale=scale)
    if allow_chunk and q.shape[2] * k.shape[2] > CHUNK_ABOVE:
        return ref.attention_chunked_ref(q, k, v, causal=causal, window=window,
                                         softcap=softcap, scale=scale, q_offset=q_offset)
    return ref.attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                             scale=scale, q_offset=q_offset)
