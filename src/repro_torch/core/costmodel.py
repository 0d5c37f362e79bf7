"""Analytic service-time cost model of the event-driven simulator (the
port's own copy of ``repro.core.costmodel``).

Its constants are calibrated to the paper's RAMCloud cluster, from the
paper's own measurements on WebGraph (2-hop hotspot, 3-hop traversal;
Figures 11 and 17). They are not times of a GPU, and not of any device
this package runs on: a qps or a millisecond figure that the simulator
prints is a cost-model derivation from execution counts.

    no-cache: 86 ms   at |N_3| ~= 367K nodes, all missed
    hash:     48 ms   (~58% hit rate)
    embed:    34 ms   (~80% hit rate)

    t_query = t_router + touched * t_node + misses * t_miss + rounds * t_rtt

Solved with the paper's numbers: t_node ~= 57 ns (local compute + cache
lookup per touched node), t_miss ~= 177 ns (amortized multi_read transfer
per missed adjacency row), t_rtt = 10 us (RAMCloud get latency; one batched
round trip per hop), t_router = 5 us. The Ethernet variant scales t_miss
and t_rtt (the paper's gRouting-E is the same design over Ethernet).
"""

from __future__ import annotations

import dataclasses

DERIVED = "derived from the cost model calibrated to the paper's RAMCloud cluster"


@dataclasses.dataclass(frozen=True)
class CostModel:
    t_node_ns: float = 57.0  # per touched node: compute + cache lookup
    t_miss_ns: float = 177.0  # per cache miss: storage fetch amortized
    t_rtt_us: float = 10.0  # per storage round trip (batched multi_read)
    t_router_us: float = 5.0  # routing decision + dispatch
    t_cache_maintain_ns: float = 8.0  # insert/evict overhead per miss

    def service_time_s(self, touched: float, misses: float, rounds: float) -> float:
        return (
            self.t_router_us * 1e-6
            + touched * self.t_node_ns * 1e-9
            + misses * (self.t_miss_ns + self.t_cache_maintain_ns) * 1e-9
            + rounds * self.t_rtt_us * 1e-6
        )

    def no_cache_time_s(self, touched: float, rounds: float) -> float:
        """No cache: every touched row is a miss, with no cache maintenance."""
        return (
            self.t_router_us * 1e-6
            + touched * (self.t_node_ns + self.t_miss_ns) * 1e-9
            + rounds * self.t_rtt_us * 1e-6
        )


ETHERNET = CostModel(t_miss_ns=177.0 * 4.0, t_rtt_us=50.0)  # gRouting-E
INFINIBAND = CostModel()


@dataclasses.dataclass(frozen=True)
class CoupledSystemModel:
    """Analytic stand-in for SEDGE/Giraph and PowerGraph (Fig. 8):
    partition-coupled execution where every hop crossing a partition
    boundary costs a synchronized superstep over the network.

    t_query ~= hops * t_superstep + touched * t_node + cut_fraction *
    touched * t_remote. BSP supersteps dominate (Giraph), calibrated to the
    paper's 5-10x gap against gRouting-E.
    """

    t_node_ns: float = 57.0
    t_superstep_ms: float = 18.0  # BSP barrier + scheduling per hop (Giraph-style)
    t_remote_ns: float = 700.0  # per remote neighbour access

    def service_time_s(self, touched: float, hops: int, cut_fraction: float) -> float:
        return (
            hops * self.t_superstep_ms * 1e-3
            + touched * self.t_node_ns * 1e-9
            + touched * cut_fraction * self.t_remote_ns * 1e-9
        )
