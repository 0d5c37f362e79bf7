"""Segment sum on Hopper: the GNN message-aggregation primitive.

The CUDA kernel is in `csrc/segment_sum.cu` (see its header for the TPU
kernel it replaces, what bounds it, and its registers and occupancy). The
wrappers here check their inputs, group the edges by segment with PyTorch
(a stable sort, then segment offsets by `searchsorted`, as the reference
sorts outside its kernel), build the kernel's task table
(`segment_tasks`), launch the kernel on the current stream and count
launches in `kernels.build.LAUNCHES`. For tensors on the CPU they run the
kernel's plain version (`kernels.ref.segment_sum_ref`) instead and count
nothing; on a CUDA tensor they launch the kernel or raise.

values (E, D) float32 or bfloat16, contiguous (on CPU tensors float16
too: the plain version takes it, as the reference's jnp path does);
seg_ids (E,) int32 or int64. Output (num_segments, D) float32 (the Pallas
kernel's out_dtype): out[s] = sum of the rows e with seg_ids[e] == s; ids
< 0 and ids >= num_segments are dropped, and an empty segment is 0.

  - `segment_sum`        -- any order of ids.
  - `segment_sum_sorted` -- ids sorted ascending (dropped ids < 0 first,
                            ids >= num_segments last); it reads the values
                            in place, with no sort and no permutation.

Tasks. The kernel's unit of work is a task of at most K = TASK_EDGES
sorted edges, so that no segment's edges wait on one warp: a segment of L
<= K edges is one task, which writes the output row; a segment of L > K
edges (a power-law hub) is ceil(L / K) tasks, edges [j K, (j + 1) K) for
task j, each writing a float32 partial row into a workspace, and the last
of them to finish sums the partial rows in task order and writes the
output row. The boundaries depend on the offsets and K alone, and every
sum is taken in a fixed order, so the same inputs give the same bits on
every run; there are no atomics on float data (one int counter a long
segment). The task table (`segment_tasks`) is one prefix sum over the
segments, built on the device with no host sync; the grid is sized by a
bound known on the host, 2 ceil(E / K) chunk teams for the long segments'
tasks (ceil(L / K) < 2 L / K each) and one team per segment. The wrapper
allocates the workspace, 2 ceil(E / K) rows of D float32, and the
counters.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import launch, load_library
from repro_torch.kernels.ref import PLAIN_DTYPES, segment_sum_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TASK_EDGES = 1024  # K: edges a task at most (passed to the kernel)


def segment_tasks(offsets: torch.Tensor, k: int = TASK_EDGES) -> torch.Tensor:
    """The kernel's task table for segments [offsets[s], offsets[s + 1]):
    (N,) int64, task_end[s] = the number of tasks of the segments up to s
    that have more than k edges (ceil(L / k) each). The tasks of such a
    segment s are task_end[s] - ceil(L / k), ..., task_end[s] - 1, in
    order: the chunk teams that run them and the partial rows they write.
    One prefix sum on the device, with no host sync."""
    lengths = offsets.diff()
    return torch.where(lengths > k, (lengths + k - 1) // k, 0).cumsum(0)


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
    """The task table and the kernel, on CUDA tensors: out[s] = sum of
    values[order[e]] (values[e] when order is None) over e in [offsets[s],
    offsets[s + 1])."""
    E, D = values.shape
    out = torch.empty((num_segments, D), dtype=torch.float32, device=values.device)
    if out.numel() == 0:
        return out
    k = TASK_EDGES
    task_end = segment_tasks(offsets, k)
    n_chunks = 2 * -(-E // k)  # the long segments' tasks: ceil(L / k) < 2 L / k each
    partial = torch.empty((n_chunks, D), dtype=torch.float32, device=values.device)
    arrivals = torch.zeros(n_chunks, dtype=torch.int32, device=values.device)
    launch("segment_sum", load_library().segment_sum, values.device,
           values.data_ptr(), None if order is None else order.data_ptr(),
           offsets.data_ptr(), task_end.data_ptr(), k, n_chunks, partial.data_ptr(),
           arrivals.data_ptr(), out.data_ptr(), _DTYPES[values.dtype], num_segments, D)
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
