"""The whole slice under 2x oversubscription: the port's `ServingEngine`
on the CPU against the reference's, every routing scheme x visited layout,
with capacity = B // (2P) and a backlog of 2B, so hard stealing,
carry-over admission, drop-oldest and drain rounds all run. Every
`EngineResult` field but timing, and the final state, must be equal (see
tests/test_torch_engine.py for the comparison rules)."""

import pytest

from _torch_parity import LAYOUTS, OVERSUBSCRIBED, SCHEMES, engine_cluster, serve
from repro.core.workloads import uniform_workload

cluster = pytest.fixture(scope="module")(engine_cluster)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_oversubscribed_rounds_match_reference(cluster, scheme, layout):
    wl = uniform_workload(cluster["g"], n_queries=96, seed=3)
    (res,) = serve(cluster, scheme, layout, OVERSUBSCRIBED, [wl])
    assert res.n_dropped > 0 and res.peak_backlog > 0
    assert scheme == "next_ready" or res.stolen > 0  # next_ready never overfills
    assert res.final_backlog == 0
