"""The port's preprocessing and numpy copies against the reference's:
`bfs_distances` and `build_landmark_index` bit-equal on `small_graph`, and
the copied graph generators, CSR layouts, hash placement and workloads
giving arrays equal to `repro`'s."""

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
