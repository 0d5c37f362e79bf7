"""The paper's other two query types (§2.2) and the single-query frontier
entry points, the port against the reference on the CPU:

  - `run_random_walk`, the port given a `draw` that replays the reference's
    `jax.random.split(key, 3)` chain on the port's own degrees: final
    nodes, the cache and every `QueryStats` field bit-equal; the port's
    own default draw stays on edges (the reference test's oracle);
  - `run_reachability` (bi-directional BFS through `expand_hop`): the
    reachable flags, the cache and every `QueryStats` field,
    `truncated_fwd` / `_bwd` included, bit-equal per visited layout x port
    backend; the BFS oracle; per-direction truncation; the detail fields
    None for the other query types;
  - `kernels.ops.frontier_expand` / `frontier_expand_packed` against the
    reference's `ops` (plain and Pallas in interpret mode) at
    tests/test_frontier_interpret.py's padding seams, ids >= n included.

Mirrors tests/test_query_engine.py's engine: `tiny_graph` padded to
width 8 (continuation chains), 3 shards, a 256 x 4 cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_fields_equal, n as np_of, t
from conftest import bfs_oracle
from test_frontier_interpret import PAD_CASES
from repro.core import cache as jc
from repro.core import query_engine as jq
from repro.core.storage import build_storage
from repro.graph.csr import to_padded
from repro.kernels import ops as jops
from repro.kernels.frontier import pack_words as jpack
from repro_torch import convert
from repro_torch.core import cache as tc
from repro_torch.core import query_engine as tq
from repro_torch.kernels import ops as tops
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.frontier import pack_words as tpack

LAYOUTS = ("dense", "packed")
PORT_BACKENDS = ("scatter", "cuda")
STATS = ("touched", "misses", "result_sizes", "truncated", "reads", "truncated_fwd",
         "truncated_bwd")


@pytest.fixture(scope="module")
def engine(tiny_graph):
    adj = to_padded(tiny_graph, max_degree=8)  # forces continuation chains
    tier = build_storage(adj, n_shards=3)
    return dict(g=tiny_graph, tier=tier, ttier=convert.storage_tier(tier, "cpu"),
                width=adj.max_degree)


def _caches(engine, n_sets=256):
    return (jc.make_cache(n_sets=n_sets, n_ways=4, row_width=engine["width"]),
            tc.make_cache(n_sets, 4, engine["width"], device="cpu"))


def _cfgs(layout, backend="cuda", max_frontier=320, chain_depth=32, use_cache=True):
    return (jq.EngineConfig(max_frontier=max_frontier, chain_depth=chain_depth,
                            use_cache=use_cache, visited_layout=layout),
            tq.EngineConfig(max_frontier=max_frontier, chain_depth=chain_depth,
                            use_cache=use_cache, visited_layout=layout,
                            expand_backend=backend))


def assert_stats_equal(jstats, tstats):
    for f in STATS:
        a, b = getattr(jstats, f), getattr(tstats, f)
        if a is None:
            assert b is None, f
        else:
            np.testing.assert_array_equal(np_of(b), np.asarray(a), err_msg=f)


# ---------------------------------------------------------------------------
# random walk with restart
# ---------------------------------------------------------------------------


def replay_draw(key, restart_prob):
    """A port `draw` replaying the reference's per-step draws: split the key
    three ways, a randint below max(deg, 1) and a uniform < restart_prob."""
    state = [key]

    def draw(step, deg):
        state[0], k1, k2 = jax.random.split(state[0], 3)
        B = deg.shape[0]
        pick = jax.random.randint(k1, (B,), 0, jnp.maximum(jnp.asarray(np_of(deg)), 1))
        restart = jax.random.uniform(k2, (B,)) < restart_prob
        return t(pick), t(restart)

    return draw


@pytest.mark.parametrize("restart_prob", [0.0, 0.15, 0.6])
@pytest.mark.parametrize("use_cache", [True, False])
def test_random_walk_matches_reference(engine, restart_prob, use_cache):
    g, tier, ttier = engine["g"], engine["tier"], engine["ttier"]
    q = np.arange(20, dtype=np.int32) * 13 % g.n
    q[[3, 11]] = -1  # padding stays -1
    jcache, tcache = _caches(engine, n_sets=8)  # small: evictions happen
    jcfg, tcfg = _cfgs("dense", use_cache=use_cache)
    key = jax.random.PRNGKey(7)
    jfinal, jcache, jstats = jq.run_random_walk(
        None, jcache, jnp.asarray(q), 5, g.n, jcfg, jq.make_ref_multi_read(tier), key,
        restart_prob=restart_prob)
    tfinal, tcache, tstats = tq.run_random_walk(
        tcache, t(q), 5, g.n, tcfg, tq.make_ref_multi_read(ttier),
        draw=replay_draw(key, restart_prob))
    np.testing.assert_array_equal(np_of(tfinal), np.asarray(jfinal))
    assert_fields_equal(jcache, tcache, what="cache")
    assert_stats_equal(jstats, tstats)
    assert (np_of(tfinal)[[3, 11]] == -1).all()


def test_random_walk_default_draw_stays_on_edges(engine):
    """The port's own draw (`uniform_draw`), no restart: every final node is
    within 4 hops of its start (the reference test's oracle); a seeded
    generator gives the same walk twice."""
    g, ttier = engine["g"], engine["ttier"]
    B = 16
    q = t(np.arange(B, dtype=np.int32))
    _, tcfg = _cfgs("dense")

    def walk(draw):
        return tq.run_random_walk(tc.make_cache(256, 4, engine["width"], device="cpu"), q, 4,
                                  g.n, tcfg, tq.make_ref_multi_read(ttier), draw=draw)[0]

    final = np_of(walk(tq.uniform_draw(torch.Generator().manual_seed(0), 0.0)))
    for i in range(B):
        assert int(final[i]) in bfs_oracle(g, i, max_hops=4)
    gen = lambda: tq.uniform_draw(torch.Generator().manual_seed(5), 0.3)  # noqa: E731
    np.testing.assert_array_equal(np_of(walk(gen())), np_of(walk(gen())))


def test_uniform_draw_picks_below_the_degree():
    draw = tq.uniform_draw(torch.Generator().manual_seed(0), restart_prob=0.25)
    deg = torch.tensor([0, 1, 2, 7, 64] * 4000, dtype=torch.int32)
    pick, restart = draw(0, deg)
    assert pick.dtype == torch.int64 and restart.dtype == torch.bool
    assert ((pick >= 0) & (pick < deg.clamp(min=1))).all()
    for d in (2, 7, 64):  # every neighbour slot is reachable
        assert set(pick[deg == d].tolist()) == set(range(d))
    assert 0.15 < restart.float().mean().item() < 0.35


# ---------------------------------------------------------------------------
# reachability
# ---------------------------------------------------------------------------


def _reach(engine, layout, backend, src, dst, h, **cfg):
    g, tier, ttier = engine["g"], engine["tier"], engine["ttier"]
    jcache, tcache = _caches(engine)
    jcfg, tcfg = _cfgs(layout, backend, **cfg)
    ref = jq.run_reachability(None, jcache, jnp.asarray(src), jnp.asarray(dst), h, g.n, jcfg,
                              jq.make_ref_multi_read(tier))
    out = tq.run_reachability(tcache, t(src), t(dst), h, g.n, tcfg,
                              tq.make_ref_multi_read(ttier))
    np.testing.assert_array_equal(np_of(out[0]), np.asarray(ref[0]))
    assert_fields_equal(ref[1], out[1], what="cache")
    assert_stats_equal(ref[2], out[2])
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_reachability_matches_reference_and_oracle(engine, layout, backend, h):
    g = engine["g"]
    rng = np.random.default_rng(h)
    src = rng.integers(0, g.n, 12).astype(np.int32)
    dst = rng.integers(0, g.n, 12).astype(np.int32)
    dst[0] = src[0]
    src[5] = -1  # padding: never reachable
    reach, _, stats = _reach(engine, layout, backend, src, dst, h)
    reach = np_of(reach)
    for i in range(12):
        if src[i] < 0:
            assert not reach[i]
            continue
        expect = bfs_oracle(g, int(src[i]), max_hops=h).get(int(dst[i]), 10**9) <= h
        assert bool(reach[i]) == expect, (src[i], dst[i])
    np.testing.assert_array_equal(np_of(stats.truncated),
                                  np_of(stats.truncated_fwd) | np_of(stats.truncated_bwd))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_reachability_per_direction_truncation(engine, layout):
    """A roomy config flags neither direction; F = 4 on hub node 0 at h = 3
    (2 hops forward, 1 back) flags both; a chain cap of 1 cuts chains."""
    g = engine["g"]
    _, _, stats = _reach(engine, layout, "cuda", np.array([0, 5], np.int32),
                         np.array([9, 2], np.int32), 3)
    assert not np_of(stats.truncated).any()
    hub = np.array([0], np.int32)
    _, _, tight = _reach(engine, layout, "cuda", hub, hub, 3, max_frontier=4)
    assert np_of(tight.truncated_fwd)[0] and np_of(tight.truncated_bwd)[0]
    deg = np.diff(g.indptr)
    hubs = np.argsort(-deg)[:3].astype(np.int32)
    _, _, cut = _reach(engine, layout, "cuda", hubs, hubs[::-1].copy(), 2, chain_depth=1)
    assert np_of(cut.truncated).all()


def test_query_stats_truncation_detail_default_none(engine):
    g, ttier = engine["g"], engine["ttier"]
    _, tcfg = _cfgs("dense")
    q = t(np.array([1], np.int32))
    _, _, stats, _ = tq.run_neighbor_aggregation(
        tc.make_cache(256, 4, engine["width"], device="cpu"), q, 1, g.n, tcfg,
        tq.make_ref_multi_read(ttier))
    assert stats.truncated_fwd is None and stats.truncated_bwd is None
    _, _, wstats = tq.run_random_walk(tc.make_cache(256, 4, engine["width"], device="cpu"), q,
                                      2, g.n, tcfg, tq.make_ref_multi_read(ttier),
                                      tq.uniform_draw(torch.Generator().manual_seed(0)))
    assert wstats.truncated_fwd is None and wstats.truncated_bwd is None


# ---------------------------------------------------------------------------
# single-query frontier entry points
# ---------------------------------------------------------------------------

def _case(F, W, n, seed):
    """test_frontier_interpret.py's `_case`, plus ids >= n (past the last
    word's padding bits too), which mark nothing."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, (F, W)).astype(np.int32)
    deg = rng.integers(0, W + 1, F).astype(np.int32)
    rows[rng.random((F, W)) < 0.1] = -1
    rows[rng.random((F, W)) < 0.05] = n + rng.integers(0, 70)
    visited = rng.random(n) < 0.3
    return rows, deg, visited


@pytest.mark.parametrize("F,W,n,label", PAD_CASES)
@pytest.mark.parametrize("use_kernel", ["auto", False])
def test_frontier_expand_entry_points_match_reference(F, W, n, label, use_kernel):
    rows, deg, visited = _case(F, W, n, seed=F * 1000 + n)
    args = (jnp.asarray(rows), jnp.asarray(deg))
    expect = np.asarray(jops.frontier_expand(*args, jnp.asarray(visited), use_pallas=False))
    pallas = np.asarray(jops.frontier_expand(*args, jnp.asarray(visited), use_pallas=True,
                                             interpret=True))
    np.testing.assert_array_equal(pallas, expect)
    jwords = jpack(jnp.asarray(visited))
    expect_w = np.asarray(jops.frontier_expand_packed(*args, jwords, n, use_pallas=False))
    before = dict(LAUNCHES)
    vis = t(visited)
    out = tops.frontier_expand(t(rows), t(deg), vis, use_kernel=use_kernel)
    assert out is vis  # in place
    np.testing.assert_array_equal(np_of(out), expect)
    words = tpack(t(visited))
    out_w = tops.frontier_expand_packed(t(rows), t(deg), words, n, use_kernel=use_kernel)
    assert out_w is words
    np.testing.assert_array_equal(convert.words_to_numpy(out_w), expect_w)
    assert dict(LAUNCHES) == before  # CPU tensors: the plain versions, no launch
