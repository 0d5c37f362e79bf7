"""The whole slice: the port's `ServingEngine` on the CPU against the
reference `ServingEngine`, for every routing scheme and visited layout,
with touch tracking on.

Every `EngineResult` field but the two timing ones must be equal, the
per-round logs included, and so must the final caches, backlog ring and
queue counters (router float state within 1e-6). Cases:

  - drained rounds (capacity = round size) on a graph with continuation
    rows, a colliding cache and a chain cap that cuts chains;
  - warm-state reuse under oversubscription: a second workload served from
    the first run's state;
  - 2x oversubscription over the whole grid is in
    tests/test_torch_engine_oversubscribed.py;
  - the embed scheme on coordinates the port trained itself (from the
    reference's init draws), drained and oversubscribed, against the
    reference on its own coordinates: the same results, the EMA within
    the coordinates' tolerance.

The reference runs its `scatter` backend (its own tests hold its backends
equal); the port runs `cuda`, whose wrappers take the plain versions on
CPU tensors. Routers start from the reference's `init_state`, carried
across by `repro_torch.convert` (the embed EMA is a jax.random draw).
"""

import dataclasses

import pytest

from _torch_parity import (
    DRAINED, LAYOUTS, OVERSUBSCRIBED, P, SCHEMES, engine_cluster, engines, serve,
)
from repro.core.workloads import hotspot_workload, uniform_workload
from repro_torch.serve.engine import ServingEngine as TEngine

cluster = pytest.fixture(scope="module")(engine_cluster)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_drained_rounds_match_reference(cluster, scheme, layout):
    wl = hotspot_workload(cluster["g"], r=1, n_hotspots=8, queries_per_hotspot=8, seed=2)
    (res,) = serve(cluster, scheme, layout, DRAINED, [wl])
    assert res.completed.all() and res.truncated


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("cfg", ["drained", "oversubscribed"])
def test_embed_on_port_trained_coordinates_matches_reference(cluster, layout, cfg):
    g = cluster["g"]
    if cfg == "drained":
        wl = hotspot_workload(g, r=1, n_hotspots=8, queries_per_hotspot=8, seed=2)
        (res,) = serve(cluster, "embed", layout, DRAINED, [wl], port_trained=True)
        assert res.completed.all()
    else:
        wl = uniform_workload(g, n_queries=96, seed=3)
        (res,) = serve(cluster, "embed", layout, OVERSUBSCRIBED, [wl], port_trained=True)
        assert res.n_dropped > 0 and res.stolen > 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_warm_state_reuse_matches_reference(cluster, layout):
    g = cluster["g"]
    first = hotspot_workload(g, r=1, n_hotspots=6, queries_per_hotspot=8, seed=4)
    second = hotspot_workload(g, r=1, n_hotspots=6, queries_per_hotspot=8, seed=4)
    cold, warm = serve(cluster, "landmark", layout, OVERSUBSCRIBED, [first, second])
    assert warm.hit_rate > cold.hit_rate


def test_undrained_state_is_refused(cluster):
    _, te, _, tstate = engines(cluster, "hash", "dense", OVERSUBSCRIBED)
    wl = uniform_workload(cluster["g"], n_queries=64, seed=5)
    _, state = te.run(wl, tstate, drain=False)
    assert int(state[3].backlog.depth()) > 0
    with pytest.raises(ValueError):
        te.run(wl, state)
    bad = dataclasses.replace(te.cfg, n_processors=P + 1)
    with pytest.raises(ValueError):
        TEngine(te.tier, te.router, bad, device="cpu")
