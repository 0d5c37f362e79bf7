"""Visited-set layouts and expansion backends: the seam under the BFS hot loop.

The per-query visited set (Algorithm 5's resultSet) has two layouts:

  - `dense`  -- (B, n) bool, one byte per node: the reference layout;
  - `packed` -- (B, ceil(n/32)) words, one BIT per node, 8x smaller. The
    words are held in int32 tensors with the bit patterns of the reference
    package's uint32 words (node id = word * 32 + bit, little-endian;
    padding bits past n always zero); counts are SWAR popcounts.

Layouts are interchangeable in meaning: `to_dense(packed_op(...)) ==
dense_op(...)` for every operation, so a layout must not move a single
cache touch, storage read or backlog slot.

An expansion backend is how one hop's marks reach the mask, per layout
(`layout.expander(name, n)`), protocol fn(rows (B, F, W) int32, deg (B, F)
int32, mask) -> mask with every valid neighbour (w < deg, 0 <= id < n)
marked. The mask is updated IN PLACE.

  - `scatter` -- plain PyTorch (`kernels.ref`), the reference backend;
  - `cuda`    -- the hand-written kernels (`kernels.frontier`): one launch
    per hop for the whole batch; on CPU tensors the wrappers run the plain
    versions;
  - `auto`    -- an alias of `cuda`, kept so the reference's backend names
    carry over. The reference's `auto` picks per hop between a
    compare-reduce kernel and a scatter by frontier density; on Hopper the
    kernel is itself a scatter, so there is no trade to make.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.frontier import (
    WORD_BITS, frontier_expand_batched, frontier_expand_packed, n_words,
    pack_words, popcount, to_int32_bits, unpack_words,
)

VISITED_LAYOUTS = ("dense", "packed")
EXPAND_BACKENDS = ("scatter", "cuda", "auto")


def _resolve_backend(backend: str) -> str:
    """Checks the name; `auto` is an alias of `cuda` (module docstring)."""
    if backend not in EXPAND_BACKENDS:
        raise ValueError(
            f"unknown expand_backend {backend!r}; one of {EXPAND_BACKENDS}")
    return "cuda" if backend == "auto" else backend


def _init_search(layout, queries: torch.Tensor, n: int, F: int):
    """Returns (visited, frontier, valid): visited holds each valid query's
    own node in the layout's representation; frontier is (B, F) int32 with
    the query in slot 0 (-1 padded)."""
    B = queries.shape[0]
    valid = queries >= 0
    visited = layout.seed(queries, n)
    frontier = torch.full((B, F), -1, dtype=torch.int32, device=queries.device)
    frontier[:, 0] = torch.where(valid, queries, -1)
    return visited, frontier, valid


class DenseVisited:
    """(B, n) bool -- the reference layout (one byte per node)."""

    name = "dense"

    def empty(self, B: int, n: int, device) -> torch.Tensor:
        return torch.zeros((B, n), dtype=torch.bool, device=device)

    def seed(self, queries: torch.Tensor, n: int) -> torch.Tensor:
        """Visited set holding each valid query's own node (-1 pad -> empty)."""
        B = queries.shape[0]
        vis = self.empty(B, n, queries.device)
        vis[torch.arange(B, device=queries.device), queries.clamp(min=0).long()] = queries >= 0
        return vis

    def count(self, vis: torch.Tensor) -> torch.Tensor:
        return vis.sum(dim=1, dtype=torch.int32)

    def to_dense(self, vis: torch.Tensor, n: int) -> torch.Tensor:
        return vis

    def from_dense(self, dense: torch.Tensor) -> torch.Tensor:
        return dense

    def union(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a | b

    def minus(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a & ~b

    def overlap_any(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (a & b).any(dim=1)

    def nbytes_per_query(self, n: int) -> int:
        return n  # torch stores bool as one byte per element

    def expander(self, backend: str, n: int) -> Callable:
        if _resolve_backend(backend) == "scatter":
            return ref.frontier_expand_batched_ref
        return frontier_expand_batched

    def init_search(self, queries: torch.Tensor, n: int, F: int):
        return _init_search(self, queries, n, F)


class PackedVisited:
    """(B, ceil(n/32)) int32 words -- one bit per node, 8x below dense."""

    name = "packed"

    def empty(self, B: int, n: int, device) -> torch.Tensor:
        return torch.zeros((B, n_words(n)), dtype=torch.int32, device=device)

    def seed(self, queries: torch.Tensor, n: int) -> torch.Tensor:
        B = queries.shape[0]
        q = queries.clamp(min=0).long()
        bit = to_int32_bits(torch.ones_like(q) << (q % WORD_BITS))
        vis = self.empty(B, n, queries.device)
        vis[torch.arange(B, device=queries.device), q // WORD_BITS] = \
            torch.where(queries >= 0, bit, 0)
        return vis

    def count(self, vis: torch.Tensor) -> torch.Tensor:
        return popcount(vis).sum(dim=1).to(torch.int32)

    def to_dense(self, vis: torch.Tensor, n: int) -> torch.Tensor:
        return unpack_words(vis, n)

    def from_dense(self, dense: torch.Tensor) -> torch.Tensor:
        return pack_words(dense)

    def union(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a | b

    def minus(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a & ~b

    def overlap_any(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return ((a & b) != 0).any(dim=1)

    def nbytes_per_query(self, n: int) -> int:
        return n_words(n) * 4

    def expander(self, backend: str, n: int) -> Callable:
        expand = (ref.frontier_expand_packed_ref
                  if _resolve_backend(backend) == "scatter"
                  else frontier_expand_packed)
        return lambda rows, deg, mask: expand(rows, deg, mask, n)

    def init_search(self, queries: torch.Tensor, n: int, F: int):
        return _init_search(self, queries, n, F)


_LAYOUTS = {"dense": DenseVisited(), "packed": PackedVisited()}


def get_visited_layout(name: str):
    """Resolve a layout name to its strategy singleton."""
    try:
        return _LAYOUTS[name]
    except KeyError:
        raise ValueError(
            f"unknown visited_layout {name!r}; one of {VISITED_LAYOUTS}"
        ) from None


def get_expand_backend(name: str, n: int, layout: str = "dense") -> Callable:
    """Resolve (backend, layout) to the protocol callable."""
    return get_visited_layout(layout).expander(name, n)


def visited_nbytes(layout: str, B: int, n: int) -> int:
    """Bytes of one (B, n)-query visited set under `layout`."""
    return B * get_visited_layout(layout).nbytes_per_query(n)
