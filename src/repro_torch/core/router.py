"""Query routers (paper §3): next-ready, hash, landmark, embed.

All four share one interface: given a batch of query nodes and the current
per-processor load, assign each query a processor and update the router
state. Routing is sequential: decision i sees the load (and, for embed,
the EMA, Eq. 5) left by decisions < i. Here that is a Python loop over the
batch whose state stays on the device (no host sync per decision); a
routing kernel that scans the batch in one launch is later work.

Load-balanced distance (Eq. 3 / Eq. 7):

    d_LB(u, p) = d(u, p) + load(p) / load_factor

Ties in every argmin go to the first processor, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cache import splitmix32
from repro_torch.core.embedding import GraphEmbedding
from repro_torch.core.landmarks import UNREACHED, LandmarkIndex
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class RouterState:
    """Dynamic router state; static tables live in the Router object."""

    load: torch.Tensor  # (P,) float32 -- queue length per processor
    ema: torch.Tensor  # (P, D) float32 -- embed routing mean coordinates (Eq. 5)
    rr: torch.Tensor  # () int32 -- round-robin pointer (next_ready tie-break)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    scheme: str = "embed"  # next_ready | hash | landmark | embed
    load_factor: float = 20.0  # paper default
    alpha: float = 0.5  # EMA smoothing (Eq. 5), paper default
    steal_margin: float = 4.0  # hard-steal when load gap exceeds this


SCHEMES = ("next_ready", "hash", "landmark", "embed")


def _select(ok: torch.Tensor, new: RouterState, old: RouterState) -> RouterState:
    return RouterState(torch.where(ok, new.load, old.load),
                       torch.where(ok, new.ema, old.ema),
                       torch.where(ok, new.rr, old.rr))


class Router:
    """Static routing tables (on `device`) + routing step functions."""

    def __init__(
        self,
        n_processors: int,
        config: RouterConfig,
        landmark_index: Optional[LandmarkIndex] = None,
        embedding: Optional[GraphEmbedding] = None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        if config.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {config.scheme!r}; one of {SCHEMES}")
        self.device = resolve_device(device)
        self.P = n_processors
        self.config = config
        self.scheme = config.scheme
        self.dist_to_proc = None
        self.coords = None
        if self.scheme == "landmark":
            if landmark_index is None:
                raise ValueError("landmark routing needs a LandmarkIndex")
            dtp = landmark_index.dist_to_proc.astype(np.float32)
            dtp = np.where(dtp >= float(UNREACHED), 1e6, dtp).astype(np.float32)
            self.dist_to_proc = torch.from_numpy(dtp).to(self.device)  # (n, P)
        elif self.scheme == "embed":
            if embedding is None:
                raise ValueError("embed routing needs a GraphEmbedding")
            coords = np.asarray(embedding.coords, dtype=np.float32)
            self.coords = torch.from_numpy(coords).to(self.device)  # (n, D)
        self.dim = int(embedding.coords.shape[1]) if embedding is not None else 1
        self._seed = seed
        # a (1,) tensor, not a Python float: CUDA divides by a scalar as a
        # multiply by its reciprocal, which is off by an ulp at times and
        # then flips argmin ties against the CPU and the reference
        self._load_factor = torch.full((1,), float(config.load_factor),
                                       dtype=torch.float32, device=self.device)

    def load_term(self, load: torch.Tensor) -> torch.Tensor:
        """load / load_factor, rounded exactly as a true division."""
        return load / self._load_factor

    # -- state ---------------------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None) -> RouterState:
        """Zero load; for embed, EMA rows drawn uniformly inside the bounding
        box of the coordinates (paper: EMA initialized at random). The draw
        comes from `generator` (default: a CPU generator seeded with the
        router's seed); it does not reproduce the reference's jax.random
        bits, so parity tests carry the reference state across instead."""
        if self.coords is not None:
            if generator is None:
                generator = torch.Generator().manual_seed(self._seed)
            u = torch.rand((self.P, self.dim), generator=generator,
                           device=generator.device).to(self.device)
            lo = self.coords.min(dim=0).values
            hi = self.coords.max(dim=0).values
            ema = u * (hi - lo) + lo
        else:
            ema = torch.zeros((self.P, self.dim), dtype=torch.float32,
                              device=self.device)
        return RouterState(
            load=torch.zeros(self.P, dtype=torch.float32, device=self.device),
            ema=ema,
            rr=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    # -- per-query decision ----------------------------------------------------

    def _decide_one(self, state: RouterState, q: torch.Tensor
                    ) -> Tuple[RouterState, torch.Tensor]:
        """q: () int node id >= 0. Returns (state', processor () int64)."""
        cfg = self.config
        procs = torch.arange(self.P, device=self.device)
        load_term = self.load_term(state.load)
        if self.scheme == "next_ready":
            # pure load balance; round-robin among minima
            score = state.load + (procs == state.rr % self.P) * (-1e-3)
            p = score.argmin()
            load = state.load + (procs == p).to(torch.float32)
            return RouterState(load, state.ema, state.rr + 1), p
        if self.scheme == "hash":
            p0 = splitmix32(q) % self.P
            # hard steal: if the hashed processor is overloaded vs the idlest
            idle = state.load.argmin()
            steal = state.load[p0] - state.load[idle] > cfg.steal_margin
            p = torch.where(steal, idle, p0)
        elif self.scheme == "landmark":
            p = (self.dist_to_proc[q] + load_term).argmin()  # Algorithm 2
        else:  # embed, Algorithm 4
            x = self.coords[q]  # (D,)
            d1 = torch.sqrt(((state.ema - x[None, :]) ** 2).sum(-1) + 1e-12)
            p = (d1 + load_term).argmin()
            a = cfg.alpha
            row = procs[:, None] == p
            ema = torch.where(row, a * state.ema[p] + (1.0 - a) * x, state.ema)
            state = RouterState(state.load, ema, state.rr)  # Eq. 5
        load = state.load + (procs == p).to(torch.float32)
        return RouterState(load, state.ema, state.rr), p

    # -- batched routing ---------------------------------------------------------

    def route_batch(self, state: RouterState, queries: torch.Tensor
                    ) -> Tuple[RouterState, torch.Tensor]:
        """Assign a batch of queries one at a time. queries: (B,) int32;
        negative entries are padding -- they get assignment -1 and leave the
        state (load, EMA, rr) untouched. Returns (state', assignment (B,) int32)."""
        assign = []
        for q in queries:
            ok = q >= 0
            new, p = self._decide_one(state, q.clamp(min=0))
            state = _select(ok, new, state)
            assign.append(torch.where(ok, p, -1))
        if not assign:
            return state, torch.zeros(0, dtype=torch.int32, device=queries.device)
        return state, torch.stack(assign).to(torch.int32)

    def complete(self, state: RouterState, processor: torch.Tensor,
                 k: float = 1.0) -> RouterState:
        """Processor(s) acknowledged completion of k queries each (paper: the
        router decrements that connection's queue)."""
        idx = torch.as_tensor(processor, device=self.device).reshape(-1).long()
        dec = torch.full(idx.shape, -float(k), dtype=torch.float32, device=self.device)
        return dataclasses.replace(state, load=state.load.index_add(0, idx, dec))
