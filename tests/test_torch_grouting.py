"""The grouting configuration and what its card run rests on, on the CPU:

  - `configs/grouting.py`: `model_cfg(shape)` for the three shapes and
    `smoke_cfg()` equal the reference's field by field (every field both
    `GServeConfig`s have, but `expand_backend`, whose default names each
    package's own backend);
  - `smoke_cfg()` through the port's distributed step at a world of one over
    gloo, with `launch/serve_graph.py`'s burst loop: every query that the
    balls show untruncated counts `|N_h(q)| - 1`, as the reference's
    tests/test_distributed.py requires of its step, every query, truncated
    ones too, counts what `capped_ball_size` marks under the step's caps,
    and a second pass over the same queries hits the warm cache;
  - `powerlaw_graph` bit-equal to the reference's at 4,800 and 70,000 nodes
    and at sizes whose last batch is cut short, and `to_padded` bit-equal at
    several row widths.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from repro.configs import grouting as rgrouting
from repro.graph.csr import to_padded as r_to_padded
from repro.graph.generators import powerlaw_graph as r_powerlaw_graph
from repro_torch.configs import grouting
from repro_torch.core.embedding import EmbedConfig, GraphEmbedding
from repro_torch.core.serving import capped_ball_size, untruncated_size
from repro_torch.core.storage import build_storage, make_serving_storage
from repro_torch.distributed.mesh import init_mesh
from repro_torch.graph.csr import to_padded
from repro_torch.graph.generators import community_graph, powerlaw_graph
from repro_torch.launch.serve_graph import serve_bursts


BACKEND_DEFAULTS = {"expand_backend"}


def _shared_fields(ours, ref):
    names = {f.name for f in dataclasses.fields(ours)}
    r_names = {f.name for f in dataclasses.fields(ref)}
    assert names <= r_names, names - r_names  # the reference's load_factor is its router's
    return sorted(names - BACKEND_DEFAULTS)


@pytest.mark.parametrize("shape", [*grouting.SHAPES, "smoke"])
def test_config_matches_reference(shape):
    if shape == "smoke":
        ours, ref = grouting.smoke_cfg(), rgrouting.smoke_cfg()
    else:
        ours, ref = grouting.model_cfg(shape), rgrouting.model_cfg(shape)
        assert grouting.SHAPES[shape] == rgrouting.SHAPES[shape]
    for name in _shared_fields(ours, ref):
        assert getattr(ours, name) == getattr(ref, name), (shape, name)
    assert (grouting.N_NODES, grouting.ROW_WIDTH, grouting.N_ROWS) == (
        rgrouting.N_NODES, rgrouting.ROW_WIDTH, rgrouting.N_ROWS) == (4_194_304, 32, 5_242_880)


def _serve_smoke(cfg, nodes_seed=1):
    """`cfg` (a smoke config) through `serve_bursts` at a world of one over
    gloo on a community graph, 24 queries served twice; (graph, result)."""
    # hubs of degree up to 42: some queries read rows past chain_depth
    g = community_graph(n=cfg.n_nodes, community_size=64, intra_degree=4, seed=0)
    assert g.n == cfg.n_nodes
    adj = to_padded(g, max_degree=cfg.row_width)
    assert adj.n_rows <= cfg.n_rows
    tier = build_storage(adj, n_shards=1, device="cpu")
    rng = np.random.default_rng(nodes_seed)
    emb = GraphEmbedding(coords=rng.standard_normal((g.n, 4)).astype(np.float32),
                         landmarks=np.arange(4), lm_coords=np.zeros((4, 4), np.float32),
                         config=EmbedConfig(dim=4))
    nodes = rng.integers(0, g.n, 24).astype(np.int32)
    mesh, dev = init_mesh((1, 1), ("data", "model"), "cpu", store=dist.HashStore(),
                          rank=0, world_size=1)
    try:
        out = serve_bursts(mesh, dev, cfg, make_serving_storage(tier, 0, dev), emb,
                           np.concatenate([nodes, nodes]), bursts=8, backlog=16, say=lambda *a, **k: None, record=True)
    finally:
        dist.destroy_process_group()
    assert out["served"] == 48 and out["dropped"] == 0 and out["backlog"] == 0
    return g, out


def _hold_to_oracles(g, cfg, out):
    """Every served count against `capped_ball_size`, and against
    `hhop_ball` where `untruncated_size` holds; (held, cut)."""
    cap = cfg.row_width * cfg.chain_depth
    held = cut = 0
    for queries, counts, stats in out["record"]:
        for q, c in zip(queries.tolist(), counts.tolist()):
            if q < 0:
                continue
            # every query, truncated or not, to the caps' own numpy search
            assert c == capped_ball_size(g, q, cfg.hops, cfg.max_frontier, cap) - 1, (q, c)
            size = untruncated_size(g, q, cfg.hops, cfg.max_frontier, cap)
            if size is not None:
                assert c == size - 1, (q, c, size - 1)
                held += 1
            else:
                cut += 1
        assert stats.dtype == np.float32 and stats[0] >= stats[1]
    return held, cut


@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_smoke_config_distributed_step_counts_equal_balls(layout):
    cfg = dataclasses.replace(grouting.smoke_cfg(), visited_layout=layout, embed_dim=4)
    g, out = _serve_smoke(cfg)
    held, cut = _hold_to_oracles(g, cfg, out)
    assert held >= 12 and cut > 0, (held, cut)
    # the second pass over the same 24 queries finds their rows cached
    half = np.cumsum(out["served_per_burst"]) <= 24
    first = sum(m for m, h in zip(out["misses"], half) if h)
    second = sum(m for m, h in zip(out["misses"], half) if not h)
    assert second < first


@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_capped_search_matches_step_when_frontier_overflows(layout):
    """Three hops with a frontier of 16: levels overflow max_frontier (the
    next frontier keeps the lowest ids), and hubs still pass chain_depth;
    `capped_ball_size` counts what the step counts, truncated or not."""
    cfg = dataclasses.replace(grouting.smoke_cfg(), visited_layout=layout, embed_dim=4,
                              hops=3, max_frontier=16)
    g, out = _serve_smoke(cfg, nodes_seed=2)
    held, cut = _hold_to_oracles(g, cfg, out)
    cap = cfg.row_width * cfg.chain_depth
    served = {int(q) for queries, _c, _s in out["record"] for q in queries if q >= 0}
    # queries whose count the frontier's cap changed
    narrowed = [q for q in served if capped_ball_size(g, q, cfg.hops, cfg.max_frontier, cap)
                != capped_ball_size(g, q, cfg.hops, g.n, cap)]
    assert cut > 0 and len(narrowed) >= 4, (held, cut, narrowed)


@pytest.mark.parametrize("n,m,seed", [(4_800, 6, 0), (70_000, 8, 3), (5_000, 3, 1),
                                      (1_030, 8, 2), (2, 8, 0)])
def test_powerlaw_graph_matches_reference(n, m, seed):
    ours, ref = powerlaw_graph(n, m, seed), r_powerlaw_graph(n, m, seed)
    assert ours.n == ref.n
    for a, b in ((ours.indptr, ref.indptr), (ours.indices, ref.indices)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("width", [None, 2, 3, 8, 32])
def test_to_padded_matches_reference(width):
    for g in (powerlaw_graph(4_800, 6, 0), community_graph(1_200, seed=9)):
        ours, ref = to_padded(g, width), r_to_padded(g, width)
        for name in ("rows", "degree", "cont"):
            a, b = getattr(ours, name), getattr(ref, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("max_iters", [3, 64])
def test_bfs_distances_in_source_blocks_equal_one_block(max_iters, monkeypatch):
    """The landmark BFS bounds its (e, L) messages by taking the sources in
    blocks (4,194,304 nodes x 96 candidates would be 24 GiB a message
    tensor); each source's BFS is its own, so the table is the same."""
    from repro_torch.core import landmarks
    from repro_torch.core.landmarks import bfs_distances
    from repro_torch.graph.csr import csr_to_edge_index

    g = powerlaw_graph(2_000, 4, seed=0)
    src, dst = (torch.from_numpy(x) for x in csr_to_edge_index(g))
    sources = torch.from_numpy(np.argsort(-g.degree(), kind="stable")[:10].astype(np.int32))
    whole = bfs_distances(src, dst, sources, g.n, max_iters)
    monkeypatch.setattr(landmarks, "BFS_BLOCK_ENTRIES", 3 * g.e)
    blocks = bfs_distances(src, dst, sources, g.n, max_iters)
    assert torch.equal(whole, blocks)
