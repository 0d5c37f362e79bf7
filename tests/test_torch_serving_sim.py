"""The paper's own system on the host: the port's event-driven simulator
(`core/serving.py`), cost model, concentrated workload, partitioners and
serving launcher against the reference's, bit for bit, on the same numpy
inputs; the reference's simulator contracts on the port's simulator; and
the port's own oracle, its `ServingEngine` on the CPU against its
simulator.

  - `hhop_ball` (the touched order too), `LRUCache`, `mirror_capacity_dispatch`
    (against the reference's mirror and the port's `capacity_dispatch`),
    `SimRouter.route` sequences for all five schemes;
  - `ServingSimulator.run` with and without `assignments`, `run_rounds` with
    and without `route_fn`: every field of the results; `run_coupled_baseline`,
    the cost model's constants and times, `concentrated_workload`,
    `label_propagation_partition` and `edge_cut`;
  - the contracts of tests/test_serving_sim.py, one parametrised case each;
  - the engine oracle in tests/test_engine_parity.py's exact-parity
    configuration (caches far larger than any working set, rows wide enough
    for no continuation, stealing off, the simulator replaying the engine's
    placement): touch sets, per-processor loads and reads equal, counts equal
    to the balls, for the four schemes and both visited layouts; and the
    queue parity of 2x-oversubscribed rounds with hash routing, the
    simulator routing for itself;
  - `python -m repro_torch.launch.serve --nodes 1500 --device cpu`: the rows
    of no_cache, next_ready, hash and landmark equal the reference
    launcher's (the embed row rests on `jax.random` draws: a finite qps);
    the reference launcher runs as it is, with its own scalar BFS.
"""

import dataclasses
import math
import sys

import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from repro.core import costmodel as rcost
from repro.core import serving as rsim
from repro.core import workloads as rwl
from repro.graph import partition as rpart
from repro_torch.core import costmodel as tcost
from repro_torch.core import serving as tsim
from repro_torch.core import workloads as twl
from repro_torch.core.dispatch import capacity_dispatch
from repro_torch.core.embedding import EmbedConfig, build_graph_embedding
from repro_torch.core.landmarks import build_landmark_index
from repro_torch.core.router import Router, RouterConfig
from repro_torch.core.storage import build_storage
from repro_torch.graph import partition as tpart
from repro_torch.graph.csr import CSRGraph, to_padded
from repro_torch.graph.generators import community_graph, powerlaw_graph
from repro_torch.serve.engine import EngineRunConfig, ServingEngine


SIM_SCHEMES = ("no_cache", "next_ready", "hash", "landmark", "embed")


def assert_same(a, b, what=""):
    """Two simulator results (or any dataclasses) equal field by field:
    arrays in value and dtype, floats exactly, sets and lists as they are."""
    assert type(a).__name__ == type(b).__name__, what
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert isinstance(y, np.ndarray) and x.dtype == y.dtype, (what, f.name)
            np.testing.assert_array_equal(x, y, err_msg=f"{what}: {f.name}")
        else:
            assert x == y, (what, f.name, x, y)


@pytest.fixture(scope="module")
def routed():
    """A 1,200-node community graph with the port's landmark index and
    embedding (CPU); both simulators read the same numpy fields."""
    g = community_graph(n=1200, community_size=60, intra_degree=6, inter_degree=1.0, seed=9)
    li = build_landmark_index(g, n_processors=4, n_landmarks=12, min_separation=2, device="cpu")
    ge = build_graph_embedding(li.dist_to_lm, li.landmarks,
                               EmbedConfig(dim=6, lm_steps=60, node_steps=20), device="cpu")
    return dict(g=g, li=li, ge=ge)


# ---------------------------------------------------------------------------
# function by function against the reference
# ---------------------------------------------------------------------------


def _graphs():
    return {
        "powerlaw": powerlaw_graph(3000, 4, seed=0),
        "community": community_graph(1200, seed=9),
        "selfloop": CSRGraph(3, np.array([0, 2, 2, 3]), np.array([0, 2, 0], np.int32)),
    }


@pytest.mark.parametrize("name", ["powerlaw", "community", "selfloop"])
def test_hhop_ball_matches_reference(name):
    g = _graphs()[name]
    rng = np.random.default_rng(0)
    for q in rng.integers(0, g.n, 12):
        for h in range(4):
            touched, size = tsim.hhop_ball(g, int(q), h)
            r_touched, r_size = rsim.hhop_ball(g, int(q), h)
            assert size == r_size and touched.dtype == r_touched.dtype, (q, h)
            np.testing.assert_array_equal(touched, r_touched)  # BFS level order
    balls, r_balls = tsim.BallCache(g), rsim.BallCache(g)
    assert balls.get(1, 2)[1] == r_balls.get(1, 2)[1]
    assert balls.get(1, 2) is balls.get(1, 2)  # memoised


@pytest.mark.parametrize("capacity", [0, 1, 3, 16])
def test_lru_cache_matches_reference(capacity):
    rng = np.random.default_rng(capacity)
    ours, ref = tsim.LRUCache(capacity), rsim.LRUCache(capacity)
    for key in rng.integers(0, 12, 300).tolist():
        assert ours.access(key) == ref.access(key)
    assert list(ours.d) == list(ref.d)  # the recency order too


@pytest.mark.parametrize("seed", range(4))
def test_mirror_capacity_dispatch_matches_reference_and_port_dispatch(seed):
    rng = np.random.default_rng(seed)
    T, P = int(rng.integers(0, 40)), int(rng.integers(1, 6))
    pref = rng.integers(-1, P, T).astype(np.int32)
    load = rng.integers(0, 30, P).astype(np.float64)
    capacity, n_rounds, lf = int(rng.integers(1, 10)), int(rng.integers(1, P + 2)), 20.0
    assign, pos = tsim.mirror_capacity_dispatch(pref, load.copy(), capacity, n_rounds, lf)
    r_assign, r_pos = rsim.mirror_capacity_dispatch(pref, load.copy(), capacity, n_rounds, lf)
    np.testing.assert_array_equal(assign, r_assign)
    np.testing.assert_array_equal(pos, r_pos)
    # the engine's scores in float32 through the port's dispatch
    onehot = torch.arange(P)[None, :] == torch.from_numpy(pref).long()[:, None]
    term = torch.from_numpy(load).to(torch.float32) / torch.tensor([lf])
    scores = torch.where(onehot, 0.0, 1.0 + term[None, :])
    scores = torch.where(torch.from_numpy(pref >= 0)[:, None], scores, torch.inf)
    d = capacity_dispatch(scores, capacity=capacity, n_rounds=n_rounds)
    np.testing.assert_array_equal(d.assignment.numpy(), assign)
    np.testing.assert_array_equal(d.position.numpy(), pos)


@pytest.mark.parametrize("scheme", SIM_SCHEMES)
def test_sim_router_sequence_matches_reference(routed, scheme):
    g, li, ge = routed["g"], routed["li"], routed["ge"]
    cfg = dict(scheme=scheme, steal_margin=2.0)
    ours = tsim.SimRouter(4, tsim.SimRouterConfig(**cfg), landmark_index=li, embedding=ge, seed=5)
    ref = rsim.SimRouter(4, rsim.SimRouterConfig(**cfg), landmark_index=li, embedding=ge, seed=5)
    load, r_load = np.zeros(4), np.zeros(4)
    rng = np.random.default_rng(1)
    for q in rng.integers(0, g.n, 200).tolist():
        p, rp = ours.route(q, load), ref.route(q, r_load)
        assert p == rp, (scheme, q)
        load[p] += 1.0
        r_load[rp] += 1.0
        if rng.random() < 0.3:  # a processor frees a slot
            k = int(rng.integers(4))
            load[k] = r_load[k] = max(load[k] - 1.0, 0.0)
    assert ours.rr == ref.rr
    if scheme == "embed":
        np.testing.assert_array_equal(ours.ema, ref.ema)
    with pytest.raises(ValueError):
        tsim.SimRouter(2, tsim.SimRouterConfig(scheme="nope")).route(0, np.zeros(2))


def _sims(routed, scheme, **kw):
    g, li, ge = routed["g"], routed["li"], routed["ge"]
    out = []
    for m in (tsim, rsim):
        rt = m.SimRouter(4, m.SimRouterConfig(scheme=scheme), landmark_index=li, embedding=ge)
        out.append(m.ServingSimulator(g, 4, rt, use_cache=scheme != "no_cache", **kw))
    return out


@pytest.mark.parametrize("scheme", SIM_SCHEMES)
@pytest.mark.parametrize("steal", [True, False])
def test_simulator_run_matches_reference(routed, scheme, steal):
    g = routed["g"]
    wl = twl.hotspot_workload(g, r=2, n_hotspots=12, seed=2)
    cost = tcost.ETHERNET if steal else tcost.INFINIBAND
    r_cost = rcost.ETHERNET if steal else rcost.INFINIBAND
    ours, _ = _sims(routed, scheme, cache_entries=300, h=3, steal=steal, cost=cost)
    _, ref = _sims(routed, scheme, cache_entries=300, h=3, steal=steal, cost=r_cost)
    res, r_res = ours.run(wl), ref.run(wl)
    assert_same(res, r_res, f"run {scheme}")
    assert res.row() == r_res.row()
    # the oracle's hook: a given placement, replayed verbatim
    place = np.random.default_rng(3).integers(0, 4, wl.query_nodes.size)
    res, r_res = ours.run(wl, h=2, assignments=place), ref.run(wl, h=2, assignments=place)
    assert_same(res, r_res, f"run {scheme} with assignments")
    np.testing.assert_array_equal(res.per_proc_queries, np.bincount(place, minlength=4))
    assert res.stolen == 0


@pytest.mark.parametrize("scheme", SIM_SCHEMES)
@pytest.mark.parametrize("replayed", [False, True])
def test_simulator_run_rounds_matches_reference(routed, scheme, replayed):
    g = routed["g"]
    wl = twl.uniform_workload(g, n_queries=90, seed=4)
    ours, ref = _sims(routed, scheme, cache_entries=200, h=2)

    def route_fn(r, qids, nodes, load):
        assert (load == 0).all()
        return (nodes * 7 + r) % 4

    kw = dict(round_size=16, capacity=3, backlog_capacity=10,
              route_fn=route_fn if replayed else None)
    res, r_res = ours.run_rounds(wl, **kw), ref.run_rounds(wl, **kw)
    assert_same(res, r_res, f"run_rounds {scheme}")
    assert res.drop_set() == r_res.drop_set() and res.dropped.any()
    res = ours.run_rounds(wl, round_size=16, capacity=16, backlog_capacity=0,
                          dispatch_rounds=1, h=1)
    assert_same(res, ref.run_rounds(wl, round_size=16, capacity=16, backlog_capacity=0,
                                    dispatch_rounds=1, h=1))


@pytest.mark.parametrize("n_workers", [2, 5])
def test_coupled_baseline_and_partitions_match_reference(routed, n_workers):
    g = routed["g"]
    labels = tpart.label_propagation_partition(g, n_workers, n_iters=6, seed=1)
    np.testing.assert_array_equal(
        labels, rpart.label_propagation_partition(g, n_workers, n_iters=6, seed=1))
    assert tpart.edge_cut(g, labels) == rpart.edge_cut(g, labels)
    assert tpart.edge_cut(g, labels) < tpart.edge_cut(g, tpart.hash_partition(g.n, n_workers))
    empty = CSRGraph(4, np.zeros(5, np.int64), np.zeros(0, np.int32))
    assert tpart.edge_cut(empty, np.zeros(4, np.int32)) == 0.0
    wl = twl.concentrated_workload(g, n_hotspots=7, reps=3, seed=2)
    r_wl = rwl.concentrated_workload(g, n_hotspots=7, reps=3, seed=2)
    assert_same(wl, r_wl, "concentrated_workload")
    assert wl.name == "concentrated" and (wl.query_nodes.reshape(7, 3) == wl.query_nodes[::3, None]).all()
    kw = dict(n_workers=n_workers, h=2, t_superstep_ms=11.0)
    assert_same(tsim.run_coupled_baseline(g, wl, labels, **kw),
                rsim.run_coupled_baseline(g, r_wl, labels, **kw), "coupled")


def test_cost_model_matches_reference():
    for ours, ref in ((tcost.INFINIBAND, rcost.INFINIBAND), (tcost.ETHERNET, rcost.ETHERNET),
                      (tcost.CoupledSystemModel(), rcost.CoupledSystemModel())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for args in ((367_000, 0.42 * 367_000, 3), (10, 0, 1), (0, 0, 0)):
        assert tcost.INFINIBAND.service_time_s(*args) == rcost.INFINIBAND.service_time_s(*args)
        assert tcost.ETHERNET.no_cache_time_s(*args[::2]) == rcost.ETHERNET.no_cache_time_s(
            *args[::2])
    assert tcost.CoupledSystemModel(t_superstep_ms=5.0).service_time_s(1000, 3, 0.25) == \
        rcost.CoupledSystemModel(t_superstep_ms=5.0).service_time_s(1000, 3, 0.25)
    # the paper's no-cache calibration point: 86 ms at |N_3| ~= 367K
    assert abs(tcost.INFINIBAND.no_cache_time_s(367_000, 3) - 0.086) < 0.001
    assert "RAMCloud" in tcost.DERIVED and "RAMCloud" in tcost.__doc__


# ---------------------------------------------------------------------------
# the reference's simulator contracts (tests/test_serving_sim.py), case for
# case, on the port's simulator with the port's own routing state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def contract():
    g = community_graph(n=4800, community_size=60, intra_degree=6, inter_degree=1.0, seed=1)
    li = build_landmark_index(g, n_processors=4, n_landmarks=24, min_separation=2, device="cpu")
    ge = build_graph_embedding(li.dist_to_lm, li.landmarks,
                               EmbedConfig(dim=8, lm_steps=200, node_steps=80), device="cpu")
    balls = tsim.BallCache(g)

    def run(scheme, wl, P=4, cache_entries=400, h=3, steal=True, margin=4.0, cost=None):
        rt = tsim.SimRouter(P, tsim.SimRouterConfig(scheme=scheme, steal_margin=margin),
                            landmark_index=li, embedding=ge)
        sim = tsim.ServingSimulator(g, P, rt, cache_entries=cache_entries, h=h,
                                    use_cache=(scheme != "no_cache"), ball_cache=balls,
                                    steal=steal, **({} if cost is None else dict(cost=cost)))
        return sim.run(wl)

    return g, run


def _caching_beats_no_cache(g, run):
    wl = twl.hotspot_workload(g, r=2, n_hotspots=30, seed=2)
    base, hsh = run("no_cache", wl), run("hash", wl)
    assert hsh.mean_response_ms < base.mean_response_ms
    assert hsh.hit_rate > 0.2


def _smart_routing_beats_baselines(g, run):
    wl = twl.hotspot_workload(g, r=2, n_hotspots=30, seed=3)
    res = {s: run(s, wl) for s in ("next_ready", "hash", "landmark", "embed")}
    smart = max(res["landmark"].hit_rate, res["embed"].hit_rate)
    naive = max(res["next_ready"].hit_rate, res["hash"].hit_rate)
    assert smart > naive, {k: v.hit_rate for k, v in res.items()}


def _uniform_cache_neutral(g, run):
    uni = run("embed", twl.uniform_workload(g, n_queries=300, seed=4))
    hsp = run("embed", twl.hotspot_workload(g, r=1, n_hotspots=30, seed=4))
    assert uni.hit_rate < 0.6 and uni.hit_rate < hsp.hit_rate


def _concentrated_all_cache_well(g, run):
    assert run("hash", twl.concentrated_workload(g, n_hotspots=25, reps=10, seed=5)).hit_rate > 0.7


def _stealing_balances_skew(g, run):
    wl = twl.concentrated_workload(g, n_hotspots=1, reps=60, seed=6)
    steal = run("hash", wl, steal=True, margin=1e9)
    no_steal = run("hash", wl, steal=False, margin=1e9)
    assert steal.per_proc_queries.max() < 60
    assert no_steal.per_proc_queries.max() == 60
    assert steal.makespan_s <= no_steal.makespan_s + 1e-9


def _linear_scaling(g, run):
    wl = twl.hotspot_workload(g, r=2, n_hotspots=40, seed=7)
    t2, t6 = run("embed", wl, P=2).throughput_qps, run("embed", wl, P=6).throughput_qps
    assert t6 > 1.5 * t2, (t2, t6)


def _coupled_slower(g, run):
    wl = twl.hotspot_workload(g, r=2, n_hotspots=30, seed=8)
    coupled = tsim.run_coupled_baseline(g, wl, tpart.hash_partition(g.n, 4), n_workers=4)
    assert run("embed", wl).throughput_qps > 3 * coupled.throughput_qps


def _ethernet_slower(g, run):
    wl = twl.hotspot_workload(g, r=2, n_hotspots=20, seed=9)
    ib, eth = run("embed", wl, cost=tcost.INFINIBAND), run("embed", wl, cost=tcost.ETHERNET)
    assert eth.mean_response_ms > ib.mean_response_ms


def _lru_reference(g, run):
    c = tsim.LRUCache(2)
    assert not c.access(1) and not c.access(2)
    assert c.access(1)  # 1 most recent
    assert not c.access(3)  # evicts 2
    assert not c.access(2) and c.access(3)


CONTRACTS = {f.__name__[1:]: f for f in (
    _caching_beats_no_cache, _smart_routing_beats_baselines, _uniform_cache_neutral,
    _concentrated_all_cache_well, _stealing_balances_skew, _linear_scaling, _coupled_slower,
    _ethernet_slower, _lru_reference)}


@pytest.mark.parametrize("case", list(CONTRACTS))
def test_reference_simulator_contracts(contract, case):
    CONTRACTS[case](*contract)


# ---------------------------------------------------------------------------
# the port's own oracle: ServingEngine (CPU) against the port's simulator
# ---------------------------------------------------------------------------

P, HOPS, ROUND = 4, 2, 32
SETS, WAYS = 1024, 16  # 16K rows a processor: cold misses only
ENGINE_SCHEMES = ("next_ready", "hash", "landmark", "embed")


@pytest.fixture(scope="module")
def oracle():
    g = community_graph(n=2400, community_size=60, intra_degree=6, inter_degree=1.0, seed=1)
    adj = to_padded(g, max_degree=int(g.degree().max()))  # no continuation rows
    assert adj.n_rows == g.n
    li = build_landmark_index(g, n_processors=P, n_landmarks=16, min_separation=2, device="cpu")
    ge = build_graph_embedding(li.dist_to_lm, li.landmarks,
                               EmbedConfig(dim=8, lm_steps=100, node_steps=40), device="cpu")
    return dict(g=g, tier=build_storage(adj, n_shards=4, device="cpu"), li=li, ge=ge,
                balls=tsim.BallCache(g))


def _engine(oracle, scheme, layout, **kw):
    cfg = EngineRunConfig(n_processors=P, round_size=ROUND, hops=HOPS, max_frontier=256,
                          cache_sets=SETS, cache_ways=WAYS, chain_depth=2, track_touched=True,
                          visited_layout=layout, expand_backend="cuda", **kw)
    router = Router(P, RouterConfig(scheme=scheme), landmark_index=oracle["li"],
                    embedding=oracle["ge"], seed=3, device="cpu")
    return ServingEngine(oracle["tier"], router, cfg, device="cpu")


def _oracle_sim(oracle, scheme):
    rt = tsim.SimRouter(P, tsim.SimRouterConfig(scheme=scheme), landmark_index=oracle["li"],
                        embedding=oracle["ge"])
    return tsim.ServingSimulator(oracle["g"], P, rt, cache_entries=SETS * WAYS, h=HOPS,
                                 ball_cache=oracle["balls"], steal=False)


def _touch_sets(res):
    return [set(np.flatnonzero(row).tolist()) for row in res.touched_bitmap]


@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("scheme", ENGINE_SCHEMES)
def test_engine_matches_port_simulator_exact_parity(oracle, scheme, layout):
    g = oracle["g"]
    wl = twl.uniform_workload(g, n_queries=96, seed=2)
    res, _ = _engine(oracle, scheme, layout, capacity=ROUND).run(wl)
    assert res.unplaced == 0 and res.stolen == 0 and not res.truncated
    assert res.completed.all() and (res.wait_rounds == 0).all()
    for i, q in enumerate(wl.query_nodes):
        assert res.counts[i] == oracle["balls"].get(int(q), HOPS)[1] - 1, (i, int(q))
    sres = _oracle_sim(oracle, scheme).run(wl, assignments=res.assignment)
    np.testing.assert_array_equal(sres.per_proc_queries, res.per_proc_queries)
    etouch = _touch_sets(res)
    for p in range(P):
        assert etouch[p] == sres.touched_sets[p], (scheme, layout, p)
    np.testing.assert_array_equal(res.per_proc_reads, sres.per_proc_misses)
    assert res.reads == sres.cache_misses
    assert res.touched == sres.cache_hits + sres.cache_misses


@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_engine_matches_port_simulator_queue_parity_hash(oracle, layout):
    """2x-oversubscribed rounds with a bounded backlog; hash routing is
    integer arithmetic, so the simulator routes for itself."""
    g = oracle["g"]
    wl = twl.uniform_workload(g, n_queries=160, seed=2)
    cap, backlog = ROUND // (2 * P), 48
    res, _ = _engine(oracle, "hash", layout, capacity=cap, backlog_capacity=backlog).run(wl)
    assert res.n_dropped > 0 and res.peak_backlog > 0 and res.final_backlog == 0
    q = _oracle_sim(oracle, "hash").run_rounds(wl, round_size=ROUND, capacity=cap,
                                               backlog_capacity=backlog)
    R = q.n_rounds
    np.testing.assert_array_equal(q.backlog_depth, res.per_round["backlog_depth"][:R])
    assert (res.per_round["backlog_depth"][R:] == 0).all()
    np.testing.assert_array_equal(q.drops_per_round, res.per_round["n_dropped"][:R])
    for name in ("completed", "dropped", "completion_round", "wait_rounds", "assignment",
                 "per_proc_queries"):
        np.testing.assert_array_equal(getattr(q, name), getattr(res, name), err_msg=name)
    np.testing.assert_array_equal(q.per_proc_misses, res.per_proc_reads)
    assert q.drop_set() == set(np.flatnonzero(res.dropped).tolist())
    etouch = _touch_sets(res)
    for p in range(P):
        assert etouch[p] == q.touched_sets[p], p


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_rows_match_reference(monkeypatch, capsys):
    from repro.launch import serve as rserve
    from repro_torch.launch import serve as tserve

    argv = ["--nodes", "1500", "--scheme", "all"]
    results = tserve.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    assert rserve.main() == 0
    ref = capsys.readouterr().out.splitlines()

    def rows(lines):
        return {ln.split()[0]: ln for ln in lines if ln.split()[0] in SIM_SCHEMES}

    assert [r.scheme for r in results] == list(SIM_SCHEMES)
    assert ours[0] == ref[0]  # the graph
    assert any("cost model" in ln and "RAMCloud" in ln for ln in ours)
    mine, theirs = rows(ours), rows(ref)
    for scheme in ("no_cache", "next_ready", "hash", "landmark"):
        assert mine[scheme] == theirs[scheme], scheme
    assert math.isfinite(results[-1].throughput_qps) and results[-1].throughput_qps > 0
    assert mine["embed"] == results[-1].row()


def test_launcher_needs_cuda_unless_cpu_is_asked_for(capsys):
    from repro_torch.launch import serve as tserve

    assert tserve.main(["--nodes", "300", "--device", "cpu", "--device-path"]) == []
    assert "repro_torch.launch.serve_graph" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.main(["--nodes", "300"])
