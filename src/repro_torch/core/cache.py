"""Query-processor cache: k-way set-associative, LRU-within-set.

The paper keeps an LRU cache of adjacency lists at each query processor
(§2.3). As in the reference package, it is the hardware cache design:

  set   = hash(key) mod n_sets
  probe = compare `tags[set, :]` against the key across all ways
  hit   -> refresh the way's age to the current clock (LRU recency)
  miss  -> evict the way with the smallest age (least recently used in set)

All state is dense tensors; every operation is batched over a vector of
keys and returns a new `CacheState` (the old one is left as it was). Rows
are padded adjacency rows: data[set, way, :] = neighbour ids, deg = valid
count, cont = continuation row id.

Two scatter-order rules of the reference are made explicit here, because
CUDA scatters with duplicate indices land in no defined order:
  - the age refresh on a hit is a max, which is order-free;
  - an insert batch can name one (set, way) twice (more than n_ways new keys
    on one set); the reference's last batch index wins, so the winner per
    slot is picked by an `amax` of the batch index and only winners write.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class CacheState:
    tags: torch.Tensor  # (n_sets, n_ways) int32, -1 = empty
    age: torch.Tensor  # (n_sets, n_ways) int32
    data: torch.Tensor  # (n_sets, n_ways, row_width) int32
    deg: torch.Tensor  # (n_sets, n_ways) int32
    cont: torch.Tensor  # (n_sets, n_ways) int32
    clock: torch.Tensor  # () int32
    hits: torch.Tensor  # () int32 cumulative
    misses: torch.Tensor  # () int32 cumulative

    @property
    def n_sets(self) -> int:
        return self.tags.shape[-2]

    @property
    def n_ways(self) -> int:
        return self.tags.shape[-1]

    @property
    def row_width(self) -> int:
        return self.data.shape[-1]

    @property
    def capacity(self) -> int:
        return self.n_sets * self.n_ways


def make_cache(n_sets: int, n_ways: int, row_width: int,
               device: DeviceLike = None) -> CacheState:
    dev = resolve_device(device)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.int32, device=dev)

    return CacheState(
        tags=full((n_sets, n_ways), -1),
        age=full((n_sets, n_ways), 0),
        data=full((n_sets, n_ways, row_width), -1),
        deg=full((n_sets, n_ways), 0),
        cont=full((n_sets, n_ways), -1),
        clock=full((), 0),
        hits=full((), 0),
        misses=full((), 0),
    )


def cache_bytes(state: CacheState) -> int:
    """Cache storage footprint in bytes."""
    per_entry = 4 * (1 + 1 + state.row_width + 1 + 1)
    return state.capacity * per_entry


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) held in int64, without overflow:
    the constant is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & 0xFFFFFFFF


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """The reference's splitmix32-style avalanche on uint32 values (int64)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _hash_keys(keys: torch.Tensor, n_sets: int) -> torch.Tensor:
    """Set index of each key (int64)."""
    return splitmix32(keys) % n_sets


def cache_lookup(
    state: CacheState, keys: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, CacheState]:
    """Batched probe.

    keys: (B,) int32 node ids (may contain -1 / invalid entries).
    valid: optional (B,) bool mask; invalid keys never hit and don't count.

    Returns (found (B,) bool, rows (B, W) int32, degs (B,), conts (B,),
    new_state with refreshed ages + stats).
    """
    if valid is None:
        valid = keys >= 0
    sets = _hash_keys(keys.clamp(min=0), state.n_sets)
    match = (state.tags[sets] == keys[:, None]) & valid[:, None]  # (B, ways)
    found = match.any(dim=1)
    way = match.to(torch.int8).argmax(dim=1)  # first matching way
    rows = torch.where(found[:, None], state.data[sets, way], -1)
    degs = torch.where(found, state.deg[sets, way], 0)
    conts = torch.where(found, state.cont[sets, way], -1)

    # refresh age on hit (a max, so the order of duplicate stores is moot)
    slot = torch.where(found, sets * state.n_ways + way, 0)
    stamp = torch.where(found, state.clock + 1, -1)
    age = state.age.reshape(-1).scatter_reduce(0, slot, stamp, "amax")
    n_hit = (found & valid).sum(dtype=torch.int32)
    n_miss = valid.sum(dtype=torch.int32) - n_hit
    new_state = dataclasses.replace(
        state,
        age=age.view(state.age.shape),
        clock=state.clock + 1,
        hits=state.hits + n_hit,
        misses=state.misses + n_miss,
    )
    return found, rows, degs, conts, new_state


def cache_insert(
    state: CacheState,
    keys: torch.Tensor,
    rows: torch.Tensor,
    degs: torch.Tensor,
    conts: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> CacheState:
    """Batched insert with LRU-within-set eviction.

    A present key reuses its way; a new key takes the set's LRU way offset
    by its arrival rank among the batch's new keys on that set, so distinct
    colliding keys land in distinct ways up to n_ways of them. Beyond that,
    (set, way) repeats and the last batch index wins, as in the reference.
    Duplicate keys should be deduped by the caller.
    """
    if valid is None:
        valid = keys >= 0
    B = keys.shape[0]
    n_sets, n_ways = state.n_sets, state.n_ways
    dev = keys.device
    sets = _hash_keys(keys.clamp(min=0), n_sets)
    match = state.tags[sets] == keys[:, None]
    present = match.any(dim=1)
    match_way = match.to(torch.int8).argmax(dim=1)
    lru_way = state.age[sets].argmin(dim=1)  # first least-recent way
    # arrival rank of each new key within its set (stable)
    grp = torch.where(valid & ~present, sets, n_sets)
    sorted_grp, order = torch.sort(grp, stable=True)
    first = torch.searchsorted(sorted_grp, sorted_grp, side="left")
    rank = torch.empty(B, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(B, device=dev) - first
    way = torch.where(present, match_way, (lru_way + rank) % n_ways)

    # one writer per slot: the last valid batch index naming it
    n_slots = n_sets * n_ways
    slot = torch.where(valid, sets * n_ways + way, n_slots)
    idx = torch.arange(B, device=dev)
    winner = torch.full((n_slots + 1,), -1, dtype=torch.int64, device=dev)
    winner = winner.scatter_reduce(0, slot, idx, "amax")
    win = valid & (winner[slot] == idx)
    dst = torch.where(win, slot, n_slots)  # losers write the dump slot

    def put(field: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        flat = field.reshape((n_slots,) + field.shape[2:])
        out = torch.cat([flat, flat[:1]], dim=0)  # + dump slot
        out[dst] = values.to(field.dtype)
        return out[:n_slots].reshape(field.shape)

    age_val = (state.clock + 1).expand(B)
    return dataclasses.replace(
        state,
        tags=put(state.tags, keys),
        age=put(state.age, age_val),
        deg=put(state.deg, degs),
        cont=put(state.cont, conts),
        data=put(state.data, rows),
        clock=state.clock + 1,
    )


def hit_rate(state: CacheState) -> torch.Tensor:
    total = state.hits + state.misses
    return torch.where(total > 0, state.hits / total.clamp(min=1), 0.0)
