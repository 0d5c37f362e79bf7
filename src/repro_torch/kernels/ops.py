"""Dispatch between the kernels and their plain versions (the reference's
`kernels/ops.py`).

The reference picks its Pallas kernel on a TPU and the jnp version
elsewhere; here the kernel runs where the tensors lie on a CUDA device.
The reference's `use_pallas` is `use_kernel` here, with the same default:
"auto" or True take the kernel wrapper (the kernel for CUDA tensors, its
plain version for CPU tensors), False the plain version on any device.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import frontier as _frontier
from repro_torch.kernels import ref
from repro_torch.kernels.embedding_bag import embedding_bag as _bag_kernel
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.segment_reduce import segment_sum as _segsum_kernel

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


def _pick(use_kernel) -> bool:
    if use_kernel not in ("auto", True, False):
        raise ValueError(f"use_kernel must be 'auto', True or False, got {use_kernel!r}")
    return use_kernel is not False


def segment_sum(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                use_kernel="auto") -> torch.Tensor:
    """(num_segments, D) float32 sums of values' rows by segment id; ids
    outside [0, num_segments) are dropped (`kernels.segment_reduce`)."""
    if _pick(use_kernel):
        return _segsum_kernel(values.contiguous(), seg_ids.contiguous(), num_segments)
    return ref.segment_sum_ref(values, seg_ids, num_segments)


def segment_mean(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                 use_kernel="auto") -> torch.Tensor:
    """`segment_sum` over max(count, 1), the count being the segment sum of
    a column of ones (two `segment_sum` calls, as the reference)."""
    s = segment_sum(values, seg_ids, num_segments, use_kernel)
    ones = torch.ones((values.shape[0], 1), dtype=values.dtype, device=values.device)
    cnt = segment_sum(ones, seg_ids, num_segments, use_kernel)
    return s / cnt.clamp_(min=1)


def segment_max(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                **_) -> torch.Tensor:
    """Per-segment max, empty segments 0; plain on every device (the
    reference keeps max and min off its kernel)."""
    return ref.segment_max_ref(values, seg_ids, num_segments)


def segment_min(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                **_) -> torch.Tensor:
    return -ref.segment_max_ref(-values, seg_ids, num_segments)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, combine: str = "sum",
                  use_kernel="auto") -> torch.Tensor:
    """(B, D) weighted sum or mean of each bag's table rows, ids < 0 as
    padding (`kernels.embedding_bag`); weights go in as float32."""
    if _pick(use_kernel):
        w = None if weights is None else weights.to(torch.float32).contiguous()
        return _bag_kernel(table.contiguous(), indices.contiguous(), w, combine)
    return ref.embedding_bag_ref(table, indices, weights, combine)


def frontier_expand(rows: torch.Tensor, deg: torch.Tensor, visited: torch.Tensor,
                    use_kernel="auto") -> torch.Tensor:
    """Single-query BFS hop on the dense layout: rows (F, W) int32, deg (F,)
    int32, visited (n,) bool. Marks every rows[f, w] with w < deg[f] and
    0 <= id < n IN PLACE and returns `visited` (the reference's form is
    functional; its result equals the returned tensor). The B = 1 view of
    the batched kernel, or of its plain version when use_kernel is False."""
    if _pick(use_kernel):
        return _frontier.frontier_expand(rows.contiguous(), deg.contiguous(), visited)
    ref.frontier_expand_batched_ref(rows[None], deg[None], visited[None])
    return visited


def frontier_expand_packed(rows: torch.Tensor, deg: torch.Tensor, words: torch.Tensor,
                           n: int, use_kernel="auto") -> torch.Tensor:
    """Single-query BFS hop on the packed layout: words (ceil(n/32),) int32
    holding the reference's uint32 bits, updated IN PLACE and returned (the
    reference's form is functional). Ids >= n mark nothing, on both paths,
    as the reference's plain path masks them, so padding bits stay zero."""
    if _pick(use_kernel):
        _frontier.frontier_expand_packed(rows.contiguous()[None], deg.contiguous()[None],
                                         words[None], n)
    else:
        ref.frontier_expand_packed_ref(rows[None], deg[None], words[None], n)
    return words
