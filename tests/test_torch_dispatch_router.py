"""The port's dispatch, backlog and routers against the reference's.

Integer results (assignments, positions, counts, backlog rings) must be
bit-identical. Router float state (`load`, `ema`) is compared with
atol = rtol = 1e-6: XLA and torch may sum the embed distance in another
order. The embed router takes the `graph_embedding` fixture's coordinates
and the reference's `init_state` (its EMA is drawn with jax.random, which
torch does not reproduce), both carried across by `repro_torch.convert`.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from _hypothesis_compat import given, settings, strategies as st

from _torch_parity import n as np_of, t
from repro.core import dispatch as jd
from repro.core.router import Router as JRouter, RouterConfig as JConfig
from repro_torch import convert
from repro_torch.core import dispatch as td
from repro_torch.core.router import Router as TRouter, RouterConfig as TConfig

SCHEMES = ("next_ready", "hash", "landmark", "embed")


def _scores(rng, T, P, p_inf=0.15, ties=False):
    s = rng.integers(0, 4, (T, P)).astype(np.float32) if ties else \
        rng.random((T, P)).astype(np.float32)
    s[rng.random((T, P)) < p_inf] = np.inf
    s[rng.random(T) < 0.1] = np.inf  # rows with no destination at all
    return s


@settings(max_examples=30, deadline=None, database=None)
@given(st.integers(1, 40), st.integers(1, 6), st.integers(1, 8), st.integers(1, 4),
       st.integers(0, 10**6))
def test_capacity_dispatch_matches_reference(T, P, capacity, n_rounds, seed):
    rng = np.random.default_rng(seed)
    scores = _scores(rng, T, P, ties=seed % 2 == 0)
    jres = jd.capacity_dispatch(jnp.asarray(scores), capacity=capacity, n_rounds=n_rounds)
    tres = td.capacity_dispatch(t(scores), capacity=capacity, n_rounds=n_rounds)
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(np_of(b), np.asarray(a))
    x = rng.integers(-5, 100, (T, 3)).astype(np.int32)
    buf_j = jd.gather_by_dispatch(jnp.asarray(x), jres, P, capacity, fill_value=-1)
    buf_t = td.gather_by_dispatch(t(x), tres, P, capacity, fill_value=-1)
    np.testing.assert_array_equal(np_of(buf_t), np.asarray(buf_j))
    np.testing.assert_array_equal(np_of(td.scatter_back(buf_t, tres, T)),
                                  np.asarray(jd.scatter_back(buf_j, jres, T)))


@settings(max_examples=30, deadline=None, database=None)
@given(st.integers(0, 12), st.integers(1, 12), st.integers(0, 10**6))
def test_backlog_offer_admit_match_reference(K, B, seed):
    rng = np.random.default_rng(seed)
    jb = jd.make_backlog(K)
    tb = convert.backlog_state(jb, "cpu")
    for a, b in zip(tb, td.make_backlog(K, device="cpu")):
        np.testing.assert_array_equal(np_of(a), np_of(b))
    qid0 = 0
    for _ in range(5):
        fresh = rng.integers(-1, 50, B).astype(np.int32)
        qids = np.arange(qid0, qid0 + B, dtype=np.int32)
        qid0 += B
        joff = jd.backlog_offer(jb, jnp.asarray(fresh), jnp.asarray(qids))
        toff = td.backlog_offer(tb, t(fresh), t(qids))
        for a, b in zip(joff, toff):
            np.testing.assert_array_equal(np_of(b), np.asarray(a))
        leftover = (np.asarray(joff[0]) >= 0) & (rng.random(K + B) < 0.6)
        jout = jd.backlog_admit(*joff, jnp.asarray(leftover), K)
        tout = td.backlog_admit(*toff, t(leftover), K)
        np.testing.assert_array_equal(np_of(tout[0].qid), np.asarray(jout[0].qid))
        np.testing.assert_array_equal(np_of(tout[0].node), np.asarray(jout[0].node))
        for a, b in zip(jout[1:], tout[1:]):
            np.testing.assert_array_equal(np_of(b), np.asarray(a))
        assert int(tout[0].depth()) == int(jout[0].depth())
        jb, tb = jout[0], tout[0]


@pytest.fixture(scope="module")
def routers(landmark_index, graph_embedding):
    out = {}
    for scheme in SCHEMES:
        jr = JRouter(4, JConfig(scheme=scheme), landmark_index=landmark_index,
                     embedding=graph_embedding, seed=3)
        tr = TRouter(4, TConfig(scheme=scheme),
                     landmark_index=convert.landmark_index(landmark_index),
                     embedding=convert.graph_embedding(graph_embedding), seed=3,
                     device="cpu")
        out[scheme] = (jr, tr)
    return out


def _assert_state_close(jst, tst):
    np.testing.assert_allclose(np_of(tst.load), np.asarray(jst.load), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(np_of(tst.ema), np.asarray(jst.ema), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(np_of(tst.rr), np.asarray(jst.rr))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_route_batch_matches_reference(routers, small_graph, scheme):
    jr, tr = routers[scheme]
    rng = np.random.default_rng(11)
    jst = jr.init_state()
    tst = convert.router_state(jst, "cpu")
    for batch in range(4):
        q = rng.integers(0, small_graph.n, 48).astype(np.int32)
        q[rng.random(48) < 0.2] = -1  # padding leaves state untouched
        if batch == 0:  # a local run: topology-aware schemes see locality
            q[:16] = rng.integers(0, 60, 16)
        jst, jassign = jr.route_batch(jst, jnp.asarray(q))
        tst, tassign = tr.route_batch(tst, t(q))
        np.testing.assert_array_equal(np_of(tassign), np.asarray(jassign))
        _assert_state_close(jst, tst)
        done = np.asarray(jassign)[:8]
        done = done[done >= 0]
        jst = jr.complete(jst, jnp.asarray(done))
        tst = tr.complete(tst, t(done))
        _assert_state_close(jst, tst)
    assert len(set(np_of(tassign[tassign >= 0]).tolist())) >= 2


def test_all_padding_batch_leaves_state(routers):
    jr, tr = routers["embed"]
    tst = convert.router_state(jr.init_state(), "cpu")
    new, assign = tr.route_batch(tst, t(np.full(5, -1, np.int32)))
    assert (np_of(assign) == -1).all()
    for a, b in ((new.load, tst.load), (new.ema, tst.ema), (new.rr, tst.rr)):
        np.testing.assert_array_equal(np_of(a), np_of(b))


def test_init_state_draws_inside_coordinate_box(routers, graph_embedding):
    _, tr = routers["embed"]
    st_ = tr.init_state(torch.Generator().manual_seed(0))
    lo, hi = graph_embedding.coords.min(0), graph_embedding.coords.max(0)
    ema = np_of(st_.ema)
    assert ema.shape == (4, graph_embedding.coords.shape[1])
    assert (ema >= lo - 1e-6).all() and (ema <= hi + 1e-6).all()
    assert (np_of(st_.load) == 0).all() and int(st_.rr) == 0
    with pytest.raises(ValueError):
        TRouter(4, TConfig(scheme="landmark"), device="cpu")
