"""Segment sum on Hopper: the GNN message-aggregation primitive.

The CUDA kernel is in `csrc/segment_sum.cu` (one warp per output row,
walking that segment's edges in sorted order; see its header for the TPU
kernel it replaces and what bounds it). The wrappers here check their
inputs, group the edges by segment with PyTorch (a stable sort, then
segment offsets by `searchsorted`, as the reference sorts outside its
kernel), launch the kernel on the current stream and count launches in
`kernels.build.LAUNCHES`. For tensors on the CPU they run the kernel's plain
version (`kernels.ref.segment_sum_ref`) instead and count nothing; on a
CUDA tensor they launch the kernel or raise.

values (E, D) float32 or bfloat16, contiguous (on CPU tensors float16
too: the plain version takes it, as the reference's jnp path does);
seg_ids (E,) int32 or int64. Output (num_segments, D) float32 (the Pallas
kernel's out_dtype): out[s] = sum of the rows e with seg_ids[e] == s; ids
< 0 and ids >= num_segments are dropped, and an empty segment is 0.

  - `segment_sum`        -- any order of ids.
  - `segment_sum_sorted` -- ids sorted ascending (dropped ids < 0 first,
                            ids >= num_segments last); it reads the values
                            in place, with no sort and no permutation.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import launch, load_library
from repro_torch.kernels.ref import PLAIN_DTYPES, segment_sum_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WARPS = 8  # segments a CUDA block (csrc kWarps)


def _check(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> None:
    if values.dim() != 2 or seg_ids.dim() != 1 or seg_ids.shape[0] != values.shape[0]:
        raise ValueError(f"shapes values {tuple(values.shape)}, seg_ids "
                         f"{tuple(seg_ids.shape)}: want (E, D) and (E,)")
    if values.dtype not in (_DTYPES if values.is_cuda else PLAIN_DTYPES):
        raise TypeError(f"values must be float32 or bfloat16 (or float16 on the CPU), "
                        f"got {values.dtype} on {values.device}")
    if seg_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"seg_ids must be int32 or int64, got {seg_ids.dtype}")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")
    if values.device != seg_ids.device:
        raise ValueError("values and seg_ids must be on one device")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {values.device}")
    if not (values.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("values and seg_ids must be contiguous")


def _offsets(keys_sorted: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(num_segments + 1,) int64: segment s owns sorted positions
    [offsets[s], offsets[s + 1]); keys outside [0, num_segments) lie
    outside every segment."""
    bounds = torch.arange(num_segments + 1, dtype=keys_sorted.dtype,
                          device=keys_sorted.device)
    return torch.searchsorted(keys_sorted, bounds)


def _launch_csr(values: torch.Tensor, order: Optional[torch.Tensor],
                offsets: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The kernel alone, on CUDA tensors: out[s] = sum of values[order[e]]
    (values[e] when order is None) over e in [offsets[s], offsets[s + 1])."""
    out = torch.empty((num_segments, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    if out.numel() == 0:
        return out
    if -(-num_segments // _WARPS) >= 2**31:
        raise ValueError(f"{num_segments} segments is too many for one grid")
    launch("segment_sum", load_library().segment_sum, values.device,
           values.data_ptr(), None if order is None else order.data_ptr(),
           offsets.data_ptr(), out.data_ptr(), _DTYPES[values.dtype],
           num_segments, values.shape[1])
    return out


def segment_order(seg_ids: torch.Tensor, num_segments: int):
    """(order, offsets) of the kernel for ids in any order: a stable sort of
    the ids with the dropped ones moved past the last segment."""
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    keys = torch.where(ok, seg_ids, num_segments)
    keys_sorted, order = torch.sort(keys, stable=True)
    return order, _offsets(keys_sorted, num_segments)


def segment_sum(values: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Segment sum for ids in any order; see the module docstring."""
    _check(values, seg_ids, num_segments)
    if values.device.type == "cpu":
        return segment_sum_ref(values, seg_ids, num_segments)
    order, offsets = segment_order(seg_ids, num_segments)
    return _launch_csr(values, order, offsets, num_segments)


def segment_sum_sorted(values: torch.Tensor, seg_ids_sorted: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment sum for ids sorted ascending; raises if they are not (one
    pass over the ids and one host sync)."""
    _check(values, seg_ids_sorted, num_segments)
    if bool((seg_ids_sorted[1:] < seg_ids_sorted[:-1]).any()):
        raise ValueError("seg_ids_sorted is not sorted ascending")
    if values.device.type == "cpu":
        return segment_sum_ref(values, seg_ids_sorted, num_segments)
    return _launch_csr(values, None, _offsets(seg_ids_sorted, num_segments), num_segments)
