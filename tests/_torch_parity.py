"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

The same numpy inputs go through a function of the reference package and
its counterpart in the port on the CPU; results are compared as numpy.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from repro.core.embedding import EmbedConfig, build_graph_embedding
from repro.core.landmarks import build_landmark_index
from repro.core.router import Router as JRouter, RouterConfig as JConfig
from repro.core.storage import build_storage
from repro.graph.csr import to_padded
from repro.graph.generators import community_graph
from repro.serve.engine import EngineRunConfig as JRunConfig, ServingEngine as JEngine
from repro_torch import convert
from repro_torch.core import embedding as tembedding
from repro_torch.core.router import Router as TRouter, RouterConfig as TConfig
from repro_torch.serve.engine import EngineRunConfig as TRunConfig, ServingEngine as TEngine

TIMING_FIELDS = ("wall_s", "throughput_qps")


def t(x, dtype=None) -> torch.Tensor:
    """numpy / reference array -> CPU tensor (a copy)."""
    out = torch.from_numpy(np.array(np.asarray(x)))
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """tensor or reference array -> numpy."""
    return convert.to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_fields_equal(ref_obj, port_obj, what=""):
    """Every field of a reference dataclass equal, as numpy, to the port's
    (read back with `repro_torch.convert.fields_to_numpy`)."""
    port = convert.fields_to_numpy(port_obj)
    for f in dataclasses.fields(ref_obj):
        np.testing.assert_array_equal(n(getattr(ref_obj, f.name)), port[f.name],
                                      err_msg=f"{what}: {f.name}")


def assert_results_equal(ref_res, port_res, what=""):
    """Two EngineResults equal in every field but timing, per_round included."""
    for f in dataclasses.fields(ref_res):
        if f.name in TIMING_FIELDS:
            continue
        a, b = getattr(ref_res, f.name), getattr(port_res, f.name)
        if f.name == "per_round":
            assert set(a) == set(b), (what, set(a) ^ set(b))
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: per_round[{k}]")
                assert a[k].dtype == b[k].dtype, (what, k, a[k].dtype, b[k].dtype)
        elif a is None or b is None:
            assert a is None and b is None, (what, f.name)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {f.name}")
        else:
            assert a == b, (what, f.name, a, b)


# ---------------------------------------------------------------------------
# The whole slice: both ServingEngines on one cluster (test_torch_engine*.py)
# ---------------------------------------------------------------------------

P, B = 4, 16
SCHEMES = ("next_ready", "hash", "landmark", "embed")
LAYOUTS = ("dense", "packed")
BASE = dict(n_processors=P, round_size=B, hops=2, max_frontier=64, cache_sets=32,
            cache_ways=4, chain_depth=2, track_touched=True)
DRAINED = dict(BASE, capacity=B)
OVERSUBSCRIBED = dict(BASE, capacity=B // (2 * P), backlog_capacity=2 * B)


# coordinates the port trains from the reference's draws are within this of
# the reference's (tests/test_torch_embedding.py states how it was set)
COORD_ATOL = 5e-4
EMBED = EmbedConfig(dim=6, lm_steps=80, node_steps=30, seed=0)


def engine_cluster():
    """A 1200-node community graph with continuation rows, its storage,
    landmark index and embedding, in both packages: `tge` carries the
    reference's coordinates across, `pge` is the port's own training from
    the reference's init draws."""
    g = community_graph(n=1200, community_size=60, intra_degree=6, inter_degree=1.0, seed=9)
    tier = build_storage(to_padded(g, max_degree=8), n_shards=4)
    assert tier.n_rows > g.n  # continuation rows exist
    li = build_landmark_index(g, n_processors=P, n_landmarks=12, min_separation=2)
    ge = build_graph_embedding(li.dist_to_lm, li.landmarks, EMBED)
    k1, k2 = jax.random.split(jax.random.PRNGKey(EMBED.seed))
    pge = tembedding.build_graph_embedding(
        li.dist_to_lm, li.landmarks, tembedding.EmbedConfig(**dataclasses.asdict(EMBED)),
        device="cpu", lm_noise=t(jax.random.normal(k1, (len(li.landmarks), EMBED.dim))),
        node_noise=t(jax.random.normal(k2, (g.n, EMBED.dim))))
    return dict(g=g, tier=tier, ttier=convert.storage_tier(tier, "cpu"), li=li, ge=ge,
                tli=convert.landmark_index(li), tge=convert.graph_embedding(ge), pge=pge)


def engines(cluster, scheme, layout, cfg, port_trained=False):
    """Both engines and their initial states; with port_trained the port's
    router takes the port-trained coordinates (`pge`), the reference's its
    own, and both start from the reference's router state."""
    jr = JRouter(P, JConfig(scheme=scheme), landmark_index=cluster["li"],
                 embedding=cluster["ge"], seed=3)
    tr = TRouter(P, TConfig(scheme=scheme), landmark_index=cluster["tli"],
                 embedding=cluster["pge" if port_trained else "tge"], seed=3, device="cpu")
    je = JEngine(cluster["tier"], jr, JRunConfig(**cfg, visited_layout=layout,
                                                 expand_backend="scatter"))
    te = TEngine(cluster["ttier"], tr, TRunConfig(**cfg, visited_layout=layout,
                                                  expand_backend="cuda"), device="cpu")
    jstate = (jr.init_state(), je.init_caches(), je.init_touched(), je.init_queue())
    tstate = (convert.router_state(jstate[0], "cpu"), te.init_caches(), te.init_touched(),
              te.init_queue())
    return je, te, jstate, tstate


def assert_states_equal(jstate, tstate, what, ema_atol=1e-6):
    """Every state equal; the router's floats within 1e-6 (the EMA within
    `ema_atol`: COORD_ATOL where the two routers' coordinates differ)."""
    jr, jc, jt, jq = jstate
    tr, tc, tt, tq = tstate
    np.testing.assert_allclose(n(tr.load), np.asarray(jr.load), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(n(tr.ema), np.asarray(jr.ema), atol=ema_atol, rtol=1e-6)
    np.testing.assert_array_equal(n(tr.rr), np.asarray(jr.rr))
    assert_fields_equal(jc, tc, what=f"{what} caches")
    np.testing.assert_array_equal(n(tt), np.asarray(jt))
    for a, b in zip(jq, tq):
        if hasattr(a, "qid"):
            np.testing.assert_array_equal(n(b.qid), np.asarray(a.qid))
            np.testing.assert_array_equal(n(b.node), np.asarray(a.node))
        else:
            np.testing.assert_array_equal(n(b), np.asarray(a))


def serve(cluster, scheme, layout, cfg, workloads, port_trained=False):
    je, te, jstate, tstate = engines(cluster, scheme, layout, cfg, port_trained)
    results = []
    for i, wl in enumerate(workloads):  # later workloads reuse the warm state
        jres, jstate = je.run(wl, jstate)
        tres, tstate = te.run(wl, tstate)
        what = f"{scheme}/{layout} workload {i}"
        assert_results_equal(jres, tres, what)
        assert_states_equal(jstate, tstate, what,
                            ema_atol=COORD_ATOL if port_trained else 1e-6)
        results.append(tres)
    return results
