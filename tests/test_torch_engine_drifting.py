"""The port's `ServingEngine` on the CPU against the reference's on the
drifting-hotspot workload (hotspot centres random-walk between phases, as
tests/test_engine_parity.py draws it at this cluster's size): every routing
scheme x visited layout, drained (capacity = round size) and under 2x
oversubscription (capacity = B // (2P), a backlog of 2B). Every
`EngineResult` field but timing, and the final state, must be equal (see
tests/test_torch_engine.py for the comparison rules). The antilocality
workload is in tests/test_torch_engine_antilocality.py."""

import pytest

from _torch_parity import DRAINED, LAYOUTS, OVERSUBSCRIBED, SCHEMES, engine_cluster, serve
from _torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from repro.core.workloads import drifting_hotspot_workload

cluster = pytest.fixture(scope="module")(engine_cluster)
CONFIGS = {"drained": DRAINED, "oversubscribed": OVERSUBSCRIBED}


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_drifting_hotspots_match_reference(cluster, scheme, layout, cfg):
    wl = drifting_hotspot_workload(cluster["g"], n_phases=4, n_hotspots=10,
                                   queries_per_hotspot=4, r=1, seed=2)
    (res,) = serve(cluster, scheme, layout, CONFIGS[cfg], [wl])
    if cfg == "drained":
        assert res.completed.all()
    else:
        assert res.final_backlog == 0
