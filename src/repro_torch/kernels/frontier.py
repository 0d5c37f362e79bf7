"""BFS frontier expansion: the per-hop visited-set update, on Hopper.

One hop of Algorithm 5: given the adjacency rows of every query's frontier
and the visited sets, mark all valid neighbours visited. The CUDA kernels
are in `csrc/frontier.cu`. Their grid is over frontier rows: each warp loads
the degrees of 32 rows, takes a ballot of the live ones (deg > 0) and serves
only those, its lanes over a row's entries. On the serving path most
launches carry a few dozen live rows out of 65,536, so a launch costs little
more than reading deg; the header gives the TPU kernels they replace, the
path's bound and the launch's floor. The wrappers here check their inputs,
launch one kernel on the current stream (no host sync) and count launches in
`kernels.build.LAUNCHES`. For tensors on the CPU a wrapper runs the kernel's plain
version (`kernels.ref`) instead and counts nothing; on a CUDA tensor it
launches the kernel or raises.

Both wrappers update the visited set IN PLACE and return it: the caller
clones first if it still needs the old set.

  - `frontier_expand_batched` -- dense layout: rows (B, F, W) int32 (-1
    padded), deg (B, F) int32, visited (B, n) bool.
  - `frontier_expand_packed`  -- packed layout: visited as (B, ceil(n/32))
    words, bit id % 32 of word id // 32 (little-endian), held in int32
    tensors with the bits of the uint32 words (torch has no uint32 shifts).
  - `frontier_expand`         -- one query: the batched kernel at B=1.

Both ignore ids < 0, ids >= n and entries past a row's degree, so the
padding bits of a packed row stay zero.

The word-layout math (`n_words`, `pack_words`, `unpack_words`, `popcount`)
and the density predicates of the reference's `auto` backend live here too.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import launch, load_library

WORD_BITS = 32  # packed layout: node id = word * 32 + bit (little-endian)
DENSE_RATIO = 8
_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Packed-word layout math (int64 arithmetic on the uint32 bit patterns)
# ---------------------------------------------------------------------------


def n_words(n: int) -> int:
    """32-bit words needed for an n-bit visited row."""
    return -(-n // WORD_BITS)


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def as_uint32_value(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 holding the unsigned value of the same bits."""
    return words.to(torch.int64) & _MASK32


def pack_words(dense: torch.Tensor) -> torch.Tensor:
    """(..., n) bool -> (..., ceil(n/32)) int32 words; bit b of word w = node
    w*32+b. Padding bits (>= n) are zero, so popcounts stay exact."""
    n = dense.shape[-1]
    nw = n_words(n)
    x = torch.zeros(dense.shape[:-1] + (nw * WORD_BITS,), dtype=torch.int64,
                    device=dense.device)
    x[..., :n] = dense
    x = x.view(dense.shape[:-1] + (nw, WORD_BITS))
    bits = torch.arange(WORD_BITS, device=dense.device)
    return to_int32_bits((x << bits).sum(-1))


def unpack_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """(..., ceil(n/32)) int32 words -> (..., n) bool (inverse of pack_words)."""
    bits = torch.arange(WORD_BITS, device=words.device)
    x = (as_uint32_value(words)[..., None] >> bits) & 1
    x = x.reshape(words.shape[:-1] + (words.shape[-1] * WORD_BITS,))
    return x[..., :n].to(torch.bool)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits per 32-bit word (int64), by the SWAR bit trick."""
    x = as_uint32_value(words)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _MASK32) >> 24


# ---------------------------------------------------------------------------
# Density predicates of the reference's `auto` backend. On Hopper the kernel
# is itself a scatter, so `auto` needs no density trade (core.visited); the
# predicates are kept so the same decision can be read and tested.
# ---------------------------------------------------------------------------


def dense_frontier(deg: torch.Tensor, n: int, ratio: int = DENSE_RATIO) -> torch.Tensor:
    """() bool: candidate neighbours across the batch >= bitmap bits / ratio."""
    bits = n
    for d in deg.shape[:-1]:
        bits *= d
    return deg.sum() * ratio >= bits


def dense_frontier_packed(deg: torch.Tensor, visited_words: torch.Tensor, n: int,
                          ratio: int = DENSE_RATIO) -> torch.Tensor:
    """`dense_frontier` weighed against the UNVISITED bits (popcount)."""
    bits = n
    for d in deg.shape[:-1]:
        bits *= d
    unvisited = torch.clamp(bits - popcount(visited_words).sum(), min=0)
    return deg.sum() * ratio >= unvisited


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(rows: torch.Tensor, deg: torch.Tensor, vis: torch.Tensor,
           vis_dtype: torch.dtype) -> None:
    if rows.dtype != torch.int32 or deg.dtype != torch.int32:
        raise TypeError(f"rows/deg must be int32, got {rows.dtype}/{deg.dtype}")
    if vis.dtype != vis_dtype:
        raise TypeError(f"visited must be {vis_dtype}, got {vis.dtype}")
    if rows.dim() != 3 or deg.shape != rows.shape[:2] or vis.dim() != 2 \
            or vis.shape[0] != rows.shape[0]:
        raise ValueError(f"shapes rows {tuple(rows.shape)}, deg "
                         f"{tuple(deg.shape)}, visited {tuple(vis.shape)}")
    if not (rows.device == deg.device == vis.device):
        raise ValueError("rows, deg and visited must be on one device")
    if not (rows.is_contiguous() and deg.is_contiguous() and vis.is_contiguous()):
        raise ValueError("rows, deg and visited must be contiguous")
    if vis.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {vis.device}")


def frontier_expand_batched(rows: torch.Tensor, deg: torch.Tensor,
                            visited: torch.Tensor) -> torch.Tensor:
    """One BFS hop for a whole query batch, dense layout, in place."""
    _check(rows, deg, visited, torch.bool)
    if visited.device.type == "cpu":
        from repro_torch.kernels.ref import frontier_expand_batched_ref  # imports this module
        return frontier_expand_batched_ref(rows, deg, visited)
    if rows.numel() == 0:
        return visited
    B, F, W = rows.shape
    launch("frontier_expand_batched", load_library().frontier_expand_dense,
           visited.device, rows.data_ptr(), deg.data_ptr(), visited.data_ptr(),
           B, F, W, visited.shape[1])
    return visited


def frontier_expand(rows: torch.Tensor, deg: torch.Tensor,
                    visited: torch.Tensor) -> torch.Tensor:
    """One BFS hop for a single query: rows (F, W), deg (F,), visited (n,)."""
    frontier_expand_batched(rows[None], deg[None], visited[None])
    return visited


def frontier_expand_packed(rows: torch.Tensor, deg: torch.Tensor,
                           words: torch.Tensor, n: int) -> torch.Tensor:
    """One BFS hop over the packed layout, in place. `n` is the bitmap width
    in bits: ids in [n, words*32) are ignored so padding bits stay zero."""
    _check(rows, deg, words, torch.int32)
    if words.shape[1] * WORD_BITS < n:
        raise ValueError(f"{words.shape[1]} words cannot hold {n} bits")
    if words.device.type == "cpu":
        from repro_torch.kernels.ref import frontier_expand_packed_ref  # imports this module
        return frontier_expand_packed_ref(rows, deg, words, n)
    if rows.numel() == 0:
        return words
    B, F, W = rows.shape
    launch("frontier_expand_packed", load_library().frontier_expand_packed,
           words.device, rows.data_ptr(), deg.data_ptr(), words.data_ptr(),
           B, F, W, n, words.shape[1])
    return words
