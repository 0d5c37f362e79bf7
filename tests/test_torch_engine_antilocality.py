"""The port's `ServingEngine` on the CPU against the reference's on the
antilocality workload (distinct query nodes, each window spread over the
id space, as tests/test_engine_parity.py draws it): every routing scheme x
visited layout, drained (capacity = round size) and under 2x
oversubscription (capacity = B // (2P), a backlog of 2B). Every
`EngineResult` field but timing, and the final state, must be equal (see
tests/test_torch_engine.py for the comparison rules). The drifting-hotspot
workload is in tests/test_torch_engine_drifting.py."""

import pytest

from _torch_parity import DRAINED, LAYOUTS, OVERSUBSCRIBED, SCHEMES, engine_cluster, serve
from _torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from repro.core.workloads import antilocality_workload

cluster = pytest.fixture(scope="module")(engine_cluster)
CONFIGS = {"drained": DRAINED, "oversubscribed": OVERSUBSCRIBED}


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_antilocality_matches_reference(cluster, scheme, layout, cfg):
    wl = antilocality_workload(cluster["g"], n_queries=96, seed=2)
    (res,) = serve(cluster, scheme, layout, CONFIGS[cfg], [wl])
    if cfg == "drained":
        assert res.completed.all()
    else:
        assert res.final_backlog == 0
