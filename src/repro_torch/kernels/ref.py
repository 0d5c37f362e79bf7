"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes exactly what its kernel computes, with ordinary
tensor ops, on any device. A kernel wrapper takes its plain version for
tensors that lie on the CPU (the tests), and `chip_smoke.py` holds each
kernel against its plain version on the card. They are also the `scatter`
expansion backend of `core.visited`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.frontier import pack_words


def mark(idx: torch.Tensor, ok: torch.Tensor, size: int) -> torch.Tensor:
    """(size,) bool with True at idx[ok]. Every store writes the same value,
    and entries not ok go to a dump slot past the end, so the result does
    not depend on the order in which duplicate stores land."""
    slot = torch.where(ok, idx.long(), size).reshape(-1)
    out = torch.zeros(size + 1, dtype=torch.bool, device=idx.device)
    return out.index_fill_(0, slot, True)[:size]


def _delta(rows: torch.Tensor, deg: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) bool: the candidates one hop marks (w < deg, 0 <= id < n)."""
    B, F, W = rows.shape
    width_ok = torch.arange(W, device=rows.device)[None, None, :] < deg[:, :, None]
    ok = width_ok & (rows >= 0) & (rows < n)
    flat = torch.arange(B, device=rows.device)[:, None, None] * n + rows
    return mark(flat, ok, B * n).view(B, n)


def frontier_expand_batched_ref(rows: torch.Tensor, deg: torch.Tensor,
                                visited: torch.Tensor) -> torch.Tensor:
    """visited[b] |= {rows[b,f,w] : w < deg[b,f], 0 <= id < n}, in place."""
    return visited.logical_or_(_delta(rows, deg, visited.shape[1]))


def frontier_expand_packed_ref(rows: torch.Tensor, deg: torch.Tensor,
                               words: torch.Tensor, n: int) -> torch.Tensor:
    """The same update on int32-held packed words (bit id%32 of word id//32),
    in place: the hop's delta is scattered densely, packed once, ORed in."""
    return words.bitwise_or_(pack_words(_delta(rows, deg, n)))
