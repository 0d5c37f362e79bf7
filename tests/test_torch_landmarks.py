"""The port's preprocessing and numpy copies against the reference's:
`bfs_distances`, `build_landmark_index` and the graph-update path
`incremental_add_node` (an existing node, and new nodes past n) bit-equal
on `small_graph`, and the copied graph generators, CSR layouts, hash
placement and workloads giving arrays equal to `repro`'s."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp

from _torch_parity import n as np_of, t
from repro.core import landmarks as jl
from repro.core import storage as js
from repro.core import workloads as jw
from repro.graph import csr as jcsr
from repro.graph import generators as jgen
from repro.graph import partition as jpart
from repro_torch.core import landmarks as tl
from repro_torch.core import storage as ts
from repro_torch.core import workloads as tw
from repro_torch.graph import csr as tcsr
from repro_torch.graph import generators as tgen
from repro_torch.graph import partition as tpart


def test_bfs_distances_match_reference(small_graph):
    src, dst = jcsr.csr_to_edge_index(small_graph)
    sources = np.array([0, 5, 4799, 1234, 77], np.int32)
    ref = jl.bfs_distances(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(sources),
                           small_graph.n)
    out = tl.bfs_distances(t(src), t(dst), t(sources), small_graph.n)
    np.testing.assert_array_equal(np_of(out), np.asarray(ref))
    # a level cap leaves far nodes UNREACHED, as in the reference
    ref3 = jl.bfs_distances(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(sources),
                            small_graph.n, max_iters=3)
    out3 = tl.bfs_distances(t(src), t(dst), t(sources), small_graph.n, max_iters=3)
    np.testing.assert_array_equal(np_of(out3), np.asarray(ref3))
    assert (np_of(out3) == tl.UNREACHED).any()


def test_build_landmark_index_matches_reference(small_graph, landmark_index):
    out = tl.build_landmark_index(small_graph, n_processors=4, n_landmarks=24,
                                  min_separation=2, device="cpu")
    for f in dataclasses.fields(jl.LandmarkIndex):
        np.testing.assert_array_equal(getattr(out, f.name), getattr(landmark_index, f.name),
                                      err_msg=f.name)
    assert out.n_processors == landmark_index.n_processors


def _assert_index_equal(ref, out):
    for f in dataclasses.fields(jl.LandmarkIndex):
        a, b = getattr(ref, f.name), getattr(out, f.name)
        np.testing.assert_array_equal(b, a, err_msg=f.name)
        assert a.dtype == b.dtype, f.name


@pytest.mark.parametrize("u", [42, 0, 4799])
def test_incremental_add_node_existing_matches_reference(small_graph, landmark_index, u):
    ref = jl.incremental_add_node(landmark_index, small_graph, u)
    out = tl.incremental_add_node(landmark_index, small_graph, u, device="cpu")
    _assert_index_equal(ref, out)
    # the recomputed row is the full preprocessing's row
    np.testing.assert_array_equal(out.dist_to_lm[u], landmark_index.dist_to_lm[u])
    np.testing.assert_array_equal(out.dist_to_proc[u], landmark_index.dist_to_proc[u])


def _grown(g, csr, extra, nbrs):
    """g plus `extra` new nodes; the last one joined to `nbrs` both ways."""
    src, dst = csr.csr_to_edge_index(g)
    new = g.n + extra - 1
    src = np.concatenate([src, np.full(len(nbrs), new), nbrs])
    dst = np.concatenate([dst, nbrs, np.full(len(nbrs), new)])
    return csr.build_csr(g.n + extra, src, dst)


@pytest.mark.parametrize("extra", [1, 3])
def test_incremental_add_node_new_matches_reference(small_graph, landmark_index, extra):
    """A node past n joined to three nodes: the tables grow (UNREACHED rows
    for the nodes between), its row is 1 + the least of its neighbours'."""
    nbrs = np.array([5, 1000, 4321])
    u = small_graph.n + extra - 1
    ref = jl.incremental_add_node(landmark_index, _grown(small_graph, jcsr, extra, nbrs), u)
    out = tl.incremental_add_node(landmark_index, _grown(small_graph, tcsr, extra, nbrs), u,
                                  device="cpu")
    _assert_index_equal(ref, out)
    assert out.dist_to_lm.shape == (u + 1, landmark_index.landmarks.shape[0])
    np.testing.assert_array_equal(out.dist_to_lm[u],
                                  landmark_index.dist_to_lm[nbrs].min(0) + 1)
    assert (out.dist_to_lm[small_graph.n:u] == tl.UNREACHED).all()
    np.testing.assert_array_equal(out.dist_to_lm[:small_graph.n], landmark_index.dist_to_lm)


def _assert_dataclass_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            assert x.dtype == y.dtype, f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("make", [
    lambda m: m.powerlaw_graph(2000, m=5, seed=3),
    lambda m: m.powerlaw_preset("small", seed=1),
    lambda m: m.community_graph(1800, community_size=60, seed=2),
])
def test_generators_match_reference(make):
    _assert_dataclass_equal(make(jgen), make(tgen))


def test_csr_padding_and_placement_match_reference(small_graph):
    for md in (None, 4):
        _assert_dataclass_equal(jcsr.to_padded(small_graph, md), tcsr.to_padded(small_graph, md))
    np.testing.assert_array_equal(tpart.hash_partition(5000, 7, seed=2),
                                  jpart.hash_partition(5000, 7, seed=2))
    adj = jcsr.to_padded(small_graph, 8)
    ref = js.build_storage(adj, n_shards=3, seed=1)
    out = ts.build_storage(adj, n_shards=3, seed=1, device="cpu")
    for f in dataclasses.fields(js.StorageTier):
        np.testing.assert_array_equal(np_of(getattr(out, f.name)), getattr(ref, f.name),
                                      err_msg=f.name)
    ids = np.array([0, -1, adj.n_rows - 1, 17, 17], np.int32)
    for a, b in zip(js.multi_read_ref(ref, jnp.asarray(ids)), ts.multi_read_ref(out, t(ids))):
        np.testing.assert_array_equal(np_of(b), np.asarray(a))


@pytest.mark.parametrize("make", [
    lambda m, g: m.hotspot_workload(g, r=1, n_hotspots=12, queries_per_hotspot=5, seed=4),
    lambda m, g: m.uniform_workload(g, n_queries=300, seed=5),
    lambda m, g: m.drifting_hotspot_workload(g, n_phases=3, n_hotspots=6, seed=6),
    lambda m, g: m.antilocality_workload(g, n_queries=200, seed=7),
    lambda m, g: m.preset_workload("small", n_queries=96, seed=8, graph=g)[1],
])
def test_workloads_match_reference(small_graph, make):
    _assert_dataclass_equal(make(jw, small_graph), make(tw, small_graph))
