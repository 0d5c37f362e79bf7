"""Embedding bag on Hopper: the recsys lookup of a bag of table rows.

The CUDA kernel is in `csrc/embedding_bag.cu` (one warp a bag; see its
header for the TPU kernel it replaces and what bounds it). The wrapper
here checks its inputs, launches it on the current stream and counts
launches in `kernels.build.LAUNCHES`. For tensors on the CPU it
runs the kernel's plain version (`kernels.ref.embedding_bag_ref`) instead
and counts nothing; on a CUDA tensor it launches the kernel or raises.

table (V, D) float32 or bfloat16 (on CPU tensors float16 too: the plain
version takes it, as the reference's jnp path does), V >= 1; indices
(B, L) int32, ids < 0 are padding; weights (B, L) float32 or None (ones);
all contiguous.
Output (B, D) in the table's dtype: out[b] = sum over valid l of
w[b, l] * table[idx[b, l]], divided by max(#valid, 1) for "mean"; ids >= V
read the last row (the reference's gather clamps). Sums and the division
in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import launch, load_library
from repro_torch.kernels.ref import PLAIN_DTYPES, embedding_bag_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BAGS = 4  # csrc kBags: bags a block, one warp each


def _check(table: torch.Tensor, indices: torch.Tensor, weights: Optional[torch.Tensor],
           combine: str) -> None:
    if table.dim() != 2 or table.shape[0] < 1 or indices.dim() != 2:
        raise ValueError(f"shapes table {tuple(table.shape)}, indices "
                         f"{tuple(indices.shape)}: want (V >= 1, D) and (B, L)")
    if table.dtype not in (_DTYPES if table.is_cuda else PLAIN_DTYPES):
        raise TypeError(f"table must be float32 or bfloat16 (or float16 on the CPU), "
                        f"got {table.dtype} on {table.device}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if combine not in ("sum", "mean"):
        raise ValueError(f"combine must be 'sum' or 'mean', got {combine!r}")
    tensors = [table, indices]
    if weights is not None:
        if weights.shape != indices.shape or weights.dtype != torch.float32:
            raise ValueError(f"weights must be float32 of shape {tuple(indices.shape)}, "
                             f"got {weights.dtype} {tuple(weights.shape)}")
        tensors.append(weights)
    if any(x.device != table.device for x in tensors):
        raise ValueError("table, indices and weights must be on one device")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("table, indices and weights must be contiguous")


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  combine: str = "sum") -> torch.Tensor:
    """Weighted sum or mean of each bag's rows; see the module docstring."""
    _check(table, indices, weights, combine)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, indices, weights, combine)
    (V, D), (B, L) = table.shape, indices.shape
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    if -(-B // _BAGS) >= 2**31:
        raise ValueError(f"{B} bags is too many for one grid")
    launch("embedding_bag", load_library().embedding_bag, table.device,
           table.data_ptr(), indices.data_ptr(),
           None if weights is None else weights.data_ptr(), out.data_ptr(),
           _DTYPES[table.dtype], B, V, L, D, int(combine == "mean"))
    return out
