"""Capacity-aware dispatch with hard stealing, and the carry-over backlog.

`capacity_dispatch` runs iterative best-choice passes: pass r assigns every
still-unassigned item to its best remaining destination; items whose
arrival rank within the destination exceeds its remaining capacity stay
unassigned and see that destination masked out in later passes.

A round is not guaranteed to drain: under sustained overload dispatch
returns -1 rows, and the serving loop parks them in a bounded FIFO backlog
ring (`BacklogState`, `backlog_offer`, `backlog_admit`) to be re-offered
ahead of fresh arrivals in later rounds. Admission control is drop-oldest.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


class DispatchResult(NamedTuple):
    assignment: torch.Tensor  # (T,) int32 destination, -1 if dropped
    position: torch.Tensor  # (T,) int32 slot within destination, -1 if dropped
    counts: torch.Tensor  # (P,) int32 items per destination


def _rank_within(dest: torch.Tensor) -> torch.Tensor:
    """Arrival rank of each item within its destination (stable order)."""
    T = dest.shape[0]
    sorted_dest, order = torch.sort(dest, stable=True)
    first = torch.searchsorted(sorted_dest, sorted_dest, side="left")
    rank = torch.empty(T, dtype=torch.int64, device=dest.device)
    rank[order] = torch.arange(T, device=dest.device) - first
    return rank


def _bincount(x: torch.Tensor, P: int) -> torch.Tensor:
    """Counts of 0..P-1 in x (entries equal to P are ignored), int32."""
    return torch.bincount(x.long(), minlength=P + 1)[:P].to(torch.int32)


def capacity_dispatch(
    scores: torch.Tensor, capacity: int, n_rounds: int = 2
) -> DispatchResult:
    """Assign each item to the lowest-score destination with free capacity.

    scores: (T, P) float32, lower = better. Rows of +inf are never assigned.
    Items that fail all `n_rounds` passes get -1.
    """
    T, P = scores.shape
    dev = scores.device
    assignment = torch.full((T,), -1, dtype=torch.int64, device=dev)
    position = torch.full((T,), -1, dtype=torch.int64, device=dev)
    used = torch.zeros(P, dtype=torch.int64, device=dev)
    masked = scores
    cols = torch.arange(P, device=dev)

    for _ in range(n_rounds):
        unassigned = assignment < 0
        choice = masked.argmin(dim=1)  # first minimum
        # rows with no finite destination left never request
        has_choice = torch.isfinite(masked.min(dim=1).values)
        cand = torch.where(unassigned & has_choice, choice, P)  # P = no request
        rank = _rank_within(cand)
        cand_safe = cand.clamp(max=P - 1)
        ok = unassigned & (rank < (capacity - used)[cand_safe]) & (cand < P)
        assignment = torch.where(ok, cand, assignment)
        position = torch.where(ok, used[cand_safe] + rank, position)
        used = used + _bincount(torch.where(ok, cand, P), P)
        # mask the chosen-but-full destination for the next pass
        full = (unassigned & ~ok)[:, None] & (cols[None, :] == cand_safe[:, None])
        masked = torch.where(full, torch.inf, masked)

    counts = _bincount(torch.where(assignment >= 0, assignment, P), P)
    return DispatchResult(assignment=assignment.to(torch.int32),
                          position=position.to(torch.int32), counts=counts)


def gather_by_dispatch(
    x: torch.Tensor, d: DispatchResult, P: int, capacity: int, fill_value=0
) -> torch.Tensor:
    """Scatter items (T, ...) into a (P, capacity, ...) buffer by assignment;
    unfilled slots hold `fill_value`. Placed items have distinct slots."""
    ok = d.assignment >= 0
    dest = torch.where(ok, d.assignment, P).long()
    pos = torch.where(ok, d.position, 0).long()
    buf = torch.full((P + 1, capacity) + tuple(x.shape[1:]), fill_value,
                     dtype=x.dtype, device=x.device)
    buf[dest, pos] = x  # unplaced items land in the dropped row P
    return buf[:P]


def scatter_back(buf: torch.Tensor, d: DispatchResult, T: int) -> torch.Tensor:
    """Inverse of gather_by_dispatch: (P, capacity, ...) -> (T, ...);
    unplaced items get zeros."""
    ok = d.assignment >= 0
    out = buf[torch.where(ok, d.assignment, 0).long(),
              torch.where(ok, d.position, 0).long()]
    return torch.where(ok.reshape((T,) + (1,) * (out.dim() - 1)), out, 0)


# ---------------------------------------------------------------------------
# Carry-over admission queue (bounded FIFO backlog between serving rounds)
# ---------------------------------------------------------------------------


class BacklogState(NamedTuple):
    """Bounded FIFO ring of queries that dispatch could not place.

    Entries are front-packed oldest-first; -1 marks empty slots. `qid` is
    the query's global index in the workload (its arrival round is qid // B);
    `node` is the query node id.
    """

    qid: torch.Tensor  # (K,) int32, -1 = empty
    node: torch.Tensor  # (K,) int32, -1 = empty

    @property
    def capacity(self) -> int:
        return self.qid.shape[0]

    def depth(self) -> torch.Tensor:
        return (self.qid >= 0).sum(dtype=torch.int32)


def make_backlog(capacity: int, device: DeviceLike = None) -> BacklogState:
    dev = resolve_device(device)
    return BacklogState(
        qid=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        node=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
    )


def backlog_offer(
    backlog: BacklogState, fresh_node: torch.Tensor, fresh_qid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The round's offered buffer: backlog (oldest first) AHEAD of fresh
    arrivals. Returns (offered_node, offered_qid), both (K + B,), -1 where
    invalid."""
    off_node = torch.cat([backlog.node, fresh_node])
    off_qid = torch.cat([backlog.qid, torch.where(fresh_node >= 0, fresh_qid, -1)])
    return off_node, off_qid


def backlog_admit(
    offered_node: torch.Tensor,
    offered_qid: torch.Tensor,
    leftover: torch.Tensor,
    capacity: int,
) -> Tuple[BacklogState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Admission control after a dispatch round (drop-oldest).

    leftover: (M,) bool -- offered entries that were valid but not placed,
    in FIFO order. The newest `capacity` are re-queued front-packed; older
    ones are dropped. Returns (backlog', dropped (M,), depth (), n_dropped ()).
    """
    rank = torch.cumsum(leftover.to(torch.int32), dim=0) - 1  # FIFO rank
    total = leftover.sum(dtype=torch.int32)
    n_dropped = torch.clamp(total - capacity, min=0)
    keep = leftover & (rank >= n_dropped)
    dropped = leftover & (rank < n_dropped)
    # kept entry with FIFO rank r lands at slot r - n_dropped; the rest go
    # to the dump slot `capacity`
    pos = torch.where(keep, rank - n_dropped, capacity).long()
    dev = offered_node.device
    new_qid = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    new_node = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    new_qid[pos] = torch.where(keep, offered_qid, -1)
    new_node[pos] = torch.where(keep, offered_node, -1)
    return (
        BacklogState(qid=new_qid[:capacity], node=new_node[:capacity]),
        dropped,
        keep.sum(dtype=torch.int32),
        n_dropped.to(torch.int32),
    )
