"""Landmark selection and multi-source BFS distances (paper Algorithm 1).

  1. take the |L| * oversample highest-degree nodes as candidates (line 1)
  2. BFS from each to get d(u, l) for every node u                (line 3)
  3. discard the lower-degree one of any landmark pair closer than
     `min_separation`                                             (lines 4-5)
  4. pick P far-apart pivot landmarks, one per processor          (lines 8-11)
  5. assign the other landmarks to their closest pivot's processor (12-13)
  6. d(u, p) = min over landmarks assigned to p of d(u, l)        (14-15)

and, on a graph update (§3.4.1), one more BFS from the new node extends
the tables (`incremental_add_node`).

The BFS runs on the device and advances the distances to ALL candidates
at once: one min-relaxation per level over the edge list (a
`scatter_reduce(..., "amin")`), until no distance changes. Steps 3-6 are
small host-side numpy work on the resulting table, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.csr import CSRGraph, csr_to_edge_index

UNREACHED = np.int32(0x3FFFFFFF)  # "infinity" that survives +1 without overflow
# messages a BFS level holds at most: (e, L) int32, 8 GB
BFS_BLOCK_ENTRIES = 1 << 31


def bfs_distances(
    src: torch.Tensor, dst: torch.Tensor, sources: torch.Tensor, n: int,
    max_iters: int = 64,
) -> torch.Tensor:
    """Multi-source BFS levels via edge-list min relaxation.

    src/dst: (e,) int32 edge list (bi-directed for the paper's semantics).
    sources: (L,) int32 source nodes. Returns dist (n, L) int32, UNREACHED
    where not reached within max_iters levels. One host sync per level.
    A level's messages are (e, L): the sources go through in blocks of at
    most BFS_BLOCK_ENTRIES messages (each source's BFS is its own, so the
    blocks give the same table).
    """
    L = sources.shape[0]
    block = max(1, BFS_BLOCK_ENTRIES // max(int(src.shape[0]), 1))
    if L > block:
        return torch.cat([bfs_distances(src, dst, sources[i:i + block], n, max_iters)
                          for i in range(0, L, block)], dim=1)
    dev = src.device
    dist = torch.full((n, L), int(UNREACHED), dtype=torch.int32, device=dev)
    dist[sources.long(), torch.arange(L, device=dev)] = 0
    src_l = src.long()
    dst_idx = dst.long()[:, None].expand(-1, L)
    for _ in range(max_iters):
        msg = dist[src_l] + 1  # (e, L)
        new = dist.scatter_reduce(0, dst_idx, msg, "amin")
        if not bool((new != dist).any()):
            break
        dist = new
    return dist


@dataclasses.dataclass
class LandmarkIndex:
    """Preprocessed router state for landmark routing (host numpy).

    landmarks:      (L,) node ids
    dist_to_lm:     (n, L) int32 BFS distances
    lm_processor:   (L,) int32 processor id of each landmark
    dist_to_proc:   (n, P) int32 -- d(u, p), the routing table the router keeps
    pivots:         (P,) landmark indices (into landmarks) chosen as pivots
    """

    landmarks: np.ndarray
    dist_to_lm: np.ndarray
    lm_processor: np.ndarray
    dist_to_proc: np.ndarray
    pivots: np.ndarray

    @property
    def n_processors(self) -> int:
        return int(self.dist_to_proc.shape[1])


def select_landmarks(
    g: CSRGraph,
    n_landmarks: int,
    min_separation: int = 3,
    oversample: int = 3,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Algorithm 1 lines 1-7. Returns (landmarks, dist_to_lm (n, L))."""
    dev = resolve_device(device)
    deg = g.degree()
    n_cand = min(g.n, n_landmarks * oversample)
    cand = np.argsort(-deg, kind="stable")[:n_cand].astype(np.int32)
    src, dst = csr_to_edge_index(g)
    dist = bfs_distances(
        torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev),
        torch.from_numpy(cand).to(dev), g.n,
    ).cpu().numpy()  # (n, n_cand)

    # greedy separation filter in candidate (degree-descending) order
    kept: list[int] = []
    for i in range(n_cand):
        if all(dist[cand[i], j] >= min_separation for j in kept):
            kept.append(i)
            if len(kept) == n_landmarks:
                break
    # if the separation filter starved us, fill with remaining highest degree
    for i in range(n_cand):
        if len(kept) >= n_landmarks:
            break
        if i not in kept:
            kept.append(i)
    kept_arr = np.array(kept[:n_landmarks], dtype=np.int64)
    return cand[kept_arr], dist[:, kept_arr]


def assign_pivots(
    landmarks: np.ndarray, dist_to_lm: np.ndarray, n_processors: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Algorithm 1 lines 8-13: pick P pivots (farthest pair, then greedy
    farthest point), map each landmark to its closest pivot's processor.

    Returns (pivots (P,) indices into landmarks, lm_processor (L,)).
    """
    L = landmarks.shape[0]
    P = min(n_processors, L)
    dmat = dist_to_lm[landmarks, :].astype(np.int64)  # (L, L)
    dmat = np.minimum(dmat, dmat.T)
    capped = np.where(dmat >= UNREACHED, -1, dmat)
    i, j = np.unravel_index(np.argmax(capped), capped.shape)
    pivots = [int(i), int(j)] if P >= 2 else [int(i)]
    while len(pivots) < P:
        dmin = np.min(dmat[:, pivots], axis=1)
        dmin[pivots] = -1
        pivots.append(int(np.argmax(dmin)))  # unreachable counts as farthest
    pivots_arr = np.array(pivots, dtype=np.int32)
    lm_processor = np.argmin(dmat[:, pivots_arr], axis=1).astype(np.int32)
    lm_processor[pivots_arr] = np.arange(len(pivots_arr), dtype=np.int32)
    return pivots_arr, lm_processor


def build_landmark_index(
    g: CSRGraph,
    n_processors: int,
    n_landmarks: int = 96,
    min_separation: int = 3,
    device: DeviceLike = None,
) -> LandmarkIndex:
    """Full Algorithm 1 preprocessing (the BFS on `device`)."""
    landmarks, dist_to_lm = select_landmarks(g, n_landmarks, min_separation,
                                             device=device)
    pivots, lm_processor = assign_pivots(landmarks, dist_to_lm, n_processors)
    P = int(lm_processor.max()) + 1 if lm_processor.size else 1
    P = max(P, min(n_processors, landmarks.shape[0]))
    dist_to_proc = np.full((g.n, n_processors), UNREACHED, dtype=np.int32)
    for p in range(min(P, n_processors)):
        mask = lm_processor == p
        if mask.any():
            dist_to_proc[:, p] = dist_to_lm[:, mask].min(axis=1)
    return LandmarkIndex(
        landmarks=landmarks.astype(np.int32),
        dist_to_lm=dist_to_lm.astype(np.int32),
        lm_processor=lm_processor,
        dist_to_proc=dist_to_proc,
        pivots=pivots,
    )


def _proc_row(index: LandmarkIndex, d_lm: np.ndarray) -> np.ndarray:
    """(P,) d(u, p) of one node from its (L,) landmark distances."""
    P = index.dist_to_proc.shape[1]
    row = np.full((P,), UNREACHED, np.int32)
    for p in range(P):
        mask = index.lm_processor == p
        if mask.any():
            row[p] = d_lm[mask].min()
    return row


def _set_row(table: np.ndarray, node: int, row: np.ndarray) -> np.ndarray:
    """A copy of table with row `node` set, padded with UNREACHED rows when
    node is past its end."""
    if node < table.shape[0]:
        out = table.copy()
    else:
        pad = np.full((node + 1 - table.shape[0], table.shape[1]), UNREACHED, np.int32)
        out = np.concatenate([table, pad], 0)
    out[node] = row
    return out


def incremental_add_node(
    index: LandmarkIndex, g_new: CSRGraph, new_node: int, device: DeviceLike = None,
) -> LandmarkIndex:
    """Graph-update handling (paper §3.4.1): on node addition, compute the new
    node's distance to every landmark (one BFS from the node over the updated
    graph, on `device`) and extend the routing tables; existing entries are
    untouched. A node past the tables' end pads them with UNREACHED rows."""
    dev = resolve_device(device)
    src, dst = csr_to_edge_index(g_new)
    d_new = bfs_distances(
        torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev),
        torch.tensor([new_node], dtype=torch.int32, device=dev), g_new.n,
    )[:, 0]  # (n,) distance from the new node to every node
    d_lm = d_new[torch.from_numpy(index.landmarks.astype(np.int64)).to(dev)].cpu().numpy()
    return LandmarkIndex(
        landmarks=index.landmarks,
        dist_to_lm=_set_row(index.dist_to_lm, new_node, d_lm),
        lm_processor=index.lm_processor,
        dist_to_proc=_set_row(index.dist_to_proc, new_node, _proc_row(index, d_lm)),
        pivots=index.pivots,
    )
