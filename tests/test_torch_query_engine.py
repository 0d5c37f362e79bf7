"""The port's query engine (`repro_torch.core.query_engine`) against the
reference's: read combining (`_dedup_first`), one hop (`expand_hop`) and
h-hop aggregation (`run_neighbor_aggregation`, with the touch map), per
visited layout x port backend {scatter, cuda (plain versions on the CPU),
auto}, against the reference's `scatter` and `pallas-interpret` backends.

Rows are padded narrow (max_degree 3) so continuation chains run, and the
chain cap cuts some of them (`chain_depth=1`), which must set the same
truncation flags. The cache is small, so lookups, evictions and colliding
inserts all happen."""

import numpy as np
import pytest
import jax.numpy as jnp
from _hypothesis_compat import given, settings, strategies as st

from _torch_parity import assert_fields_equal, n as np_of, t
from repro.core import cache as jc
from repro.core import query_engine as jq
from repro.core.storage import build_storage
from repro.core.visited import get_visited_layout as jlayout
from repro.graph.csr import to_padded
from repro.graph.generators import community_graph
from repro_torch import convert
from repro_torch.core import cache as tc
from repro_torch.core import query_engine as tq
from repro_torch.core.visited import get_visited_layout as tlayout

LAYOUTS = ("dense", "packed")
PORT_BACKENDS = ("scatter", "cuda", "auto")
REF_BACKENDS = ("scatter", "pallas-interpret")
B, F, H = 6, 32, 2


@pytest.fixture(scope="module")
def setup():
    g = community_graph(n=360, community_size=30, intra_degree=5, inter_degree=1.0, seed=4)
    tier = build_storage(to_padded(g, max_degree=3), n_shards=3)
    assert tier.n_rows > g.n  # continuation rows exist
    queries = np.array([0, 17, -1, 200, 17, 359], np.int32)
    return dict(g=g, tier=tier, ttier=convert.storage_tier(tier, "cpu"), queries=queries,
                ref={})


def _ref_run(setup, layout, backend, chain_depth):
    """The reference's run, once per (layout, backend, chain_depth)."""
    key = (layout, backend, chain_depth)
    if key not in setup["ref"]:
        tier = setup["tier"]
        cfg = jq.EngineConfig(max_frontier=F, chain_depth=chain_depth,
                              expand_backend=backend, visited_layout=layout)
        setup["ref"][key] = jq.run_neighbor_aggregation(
            None, jc.make_cache(8, 2, tier.row_width), jnp.asarray(setup["queries"]),
            H, tier.n, cfg, jq.make_ref_multi_read(tier),
            touched_map=jnp.zeros((tier.n,), bool))
    return setup["ref"][key]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("ref_backend", REF_BACKENDS)
@pytest.mark.parametrize("chain_depth", [1, 64])
def test_neighbor_aggregation_matches_reference(setup, layout, backend, ref_backend,
                                                chain_depth):
    jcounts, jcache, jstats, jtmap = _ref_run(setup, layout, ref_backend, chain_depth)
    ttier = setup["ttier"]
    cfg = tq.EngineConfig(max_frontier=F, chain_depth=chain_depth,
                          expand_backend=backend, visited_layout=layout)
    counts, cache, stats, tmap = tq.run_neighbor_aggregation(
        tc.make_cache(8, 2, ttier.row_width, device="cpu"), t(setup["queries"]), H,
        ttier.n, cfg, tq.make_ref_multi_read(ttier),
        touched_map=t(np.zeros(ttier.n, bool)))
    np.testing.assert_array_equal(np_of(counts), np.asarray(jcounts))
    np.testing.assert_array_equal(np_of(tmap), np.asarray(jtmap))
    assert_fields_equal(jcache, cache, what="cache")
    for f in ("touched", "misses", "result_sizes", "truncated", "reads"):
        np.testing.assert_array_equal(np_of(getattr(stats, f)),
                                      np.asarray(getattr(jstats, f)), err_msg=f)
    if chain_depth == 1:
        assert np_of(stats.truncated).any()  # the cap really cut a chain


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("use_cache", [True, False])
def test_expand_hop_matches_reference(setup, layout, use_cache):
    """One hop from a mid-search state: a warm cache, a visited set with
    earlier marks and a frontier with padding; every HopResult field."""
    tier, ttier = setup["tier"], setup["ttier"]
    n = tier.n
    rng = np.random.default_rng(3)
    frontier = np.full((B, F), -1, np.int32)
    frontier[:, :5] = rng.integers(0, n, (B, 5))
    frontier[2] = -1
    dense = rng.random((B, n)) < 0.05
    jl_cfg = jq.EngineConfig(max_frontier=F, chain_depth=4, use_cache=use_cache,
                             expand_backend="scatter", visited_layout=layout)
    tl_cfg = tq.EngineConfig(max_frontier=F, chain_depth=4, use_cache=use_cache,
                             expand_backend="cuda", visited_layout=layout)
    jcache = jc.make_cache(4, 2, tier.row_width)
    warm = jnp.asarray(rng.integers(0, n, 12).astype(np.int32))
    jcache = jc.cache_insert(jcache, warm, *jq.make_ref_multi_read(tier)(warm))
    jvis = jlayout(layout).from_dense(jnp.asarray(dense))
    tvis = tlayout(layout).from_dense(t(dense))
    jres = jq.expand_hop(None, jcache, jvis, jnp.asarray(frontier), jl_cfg,
                         jq.make_ref_multi_read(tier), n)
    tres = tq.expand_hop(convert.cache_state(jcache, "cpu"), tvis, t(frontier), tl_cfg,
                         tq.make_ref_multi_read(ttier), n)
    # the input visited set is left as it was
    np.testing.assert_array_equal(np_of(tlayout(layout).to_dense(tvis, n)), dense)
    for f in ("visited", "frontier", "truncated", "reads", "touched", "probe_misses"):
        a, b = np.asarray(getattr(jres, f)), np_of(getattr(tres, f))
        if f == "visited" and layout == "packed":
            b = b.view(np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert_fields_equal(jres.cache, tres.cache, what="cache")


def test_next_frontier_overflow_truncates(setup):
    """More newly visited nodes than F: the first F ascending ids, flagged."""
    tier, ttier = setup["tier"], setup["ttier"]
    q = np.full((2, 2), -1, np.int32)
    q[:, 0] = [3, 120]
    q[0, 1] = 4
    for layout in LAYOUTS:
        jcfg = jq.EngineConfig(max_frontier=2, chain_depth=8, visited_layout=layout)
        tcfg = tq.EngineConfig(max_frontier=2, chain_depth=8, visited_layout=layout)
        jvis = jlayout(layout).seed(jnp.asarray(q[:, 0]), tier.n)
        jres = jq.expand_hop(None, jc.make_cache(4, 2, tier.row_width), jvis,
                             jnp.asarray(q), jcfg, jq.make_ref_multi_read(tier), tier.n)
        tres = tq.expand_hop(tc.make_cache(4, 2, ttier.row_width, device="cpu"),
                             tlayout(layout).seed(t(q[:, 0]), tier.n), t(q), tcfg,
                             tq.make_ref_multi_read(ttier), tier.n)
        np.testing.assert_array_equal(np_of(tres.frontier), np.asarray(jres.frontier))
        np.testing.assert_array_equal(np_of(tres.truncated), np.asarray(jres.truncated))
        assert np_of(tres.truncated).all()


@settings(max_examples=30, deadline=None, database=None)
@given(st.lists(st.integers(-1, 12), min_size=0, max_size=40))
def test_dedup_first_matches_reference(vals):
    ids = np.array(vals, np.int32)
    jfirst, jsrc = jq._dedup_first(jnp.asarray(ids))
    tfirst, tsrc = tq._dedup_first(t(ids))
    np.testing.assert_array_equal(np_of(tfirst), np.asarray(jfirst))
    np.testing.assert_array_equal(np_of(tsrc), np.asarray(jsrc))


def test_touch_map_filter_past_int32(monkeypatch):
    """`run_neighbor_aggregation`'s touch-map filter at n = 2^31 + 33 on int32
    frontier ids: every id >= 0 is in range. Compared raw, n wraps in torch
    and no id would be. The n-sized pieces (the layout's search state,
    `expand_hop`, `mark`) are stubbed, so nothing n-sized is allocated; the
    stub of `mark` keeps the mask it is handed."""
    import torch

    n = 2**31 + 33
    frontier = torch.tensor([[5, -1, 2**31 - 1], [0, -7, 7]], dtype=torch.int32)
    masks = []

    class Layout:
        def init_search(self, queries, n_, max_frontier):
            return torch.zeros(2, 1), frontier, torch.ones(2, dtype=torch.bool)

        def count(self, visited):
            return torch.zeros(2, dtype=torch.int32)

    def expand_hop(cache_state, visited, frontier_, cfg, multi_read, n_):
        zero = torch.zeros((), dtype=torch.int32)
        return tq.HopResult(visited, frontier_, cache_state, torch.zeros(2, dtype=torch.bool),
                            zero, zero, zero)

    def mark(ids, ok, size):
        assert size == n
        masks.append((ids.clone(), ok.clone()))
        return torch.zeros(4, dtype=torch.bool)

    monkeypatch.setattr(tq, "get_visited_layout", lambda name: Layout())
    monkeypatch.setattr(tq, "expand_hop", expand_hop)
    monkeypatch.setattr(tq, "mark", mark)
    *_, tmap = tq.run_neighbor_aggregation(None, frontier[:, 0], 2, n, tq.EngineConfig(),
                                           None, touched_map=torch.zeros(4, dtype=torch.bool))
    assert len(masks) == 2 and tmap.shape == (4,)
    for ids, ok in masks:
        assert torch.equal(ids, frontier.reshape(-1))
        assert ok.tolist() == [True, False, True, True, False, True]
