"""The distributed serving step of the port (`repro_torch.serve.graph_serving`
over gloo on the CPU) against the reference's (`repro.serve.graph_serving`
under shard_map on 4 host devices).

The reference runs once for the module, in subprocesses with
XLA_FLAGS=--xla_force_host_platform_device_count=4 (`_graph_serving_ref.py`;
the test process keeps one JAX device). The port runs once, in 4 spawned
gloo ranks that take the meshes one after another (`_torch_dist.py`). The
cases (`_graph_serving_cases.py`): `powerlaw_graph(256, 3)` padded to rows
of 8, 8 queries a processor, meshes (data, model) of (1,1), (2,2), (1,4)
and (4,1), two steps of the same queries:

  - roomy: a read budget nothing can overflow, one round;
  - retry: a budget of 16 that four rounds serve in full;
  - exhausted: a budget of 4 and one round, the reference's silent loss:
    what overflows comes back as an empty row and is cached, so counts
    are wrong; the port gives the same wrong counts;
  - sync: a hub query on one rank of a storage group and none on the other,
    whose cache clock then advances with the synced chain loop;
  - admission: 1.5x-oversubscribed bursts routed by one router on rank 0.

Counts, the eight cache leaves and the stats are bit-equal to the
reference's, the EMA within 1e-6, for both layouts and both backends
("cuda" runs the kernels' plain versions on CPU tensors).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _graph_serving_cases as C
import _torch_dist as D
from _torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from repro.core.storage import bucket_by_owner as j_bucket, stripe_rows as j_stripe
from repro_torch import convert
from repro_torch.core.storage import bucket_by_owner, build_storage, make_serving_storage, \
    stripe_rows
from repro_torch.distributed.mesh import ProcessMesh, init_mesh
from repro_torch.graph.csr import to_padded
from repro_torch.graph.generators import powerlaw_graph
from repro_torch.serve.graph_serving import GServeConfig, abstract_serve_inputs

HERE = Path(__file__).resolve().parent
REF_PARTS = 4
EMA_ATOL = 1e-6
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def ref_paths(tmp_path_factory):
    """The reference's outputs: REF_PARTS processes share its jobs."""
    out = tmp_path_factory.mktemp("graph_serving_ref")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(HERE.parent / "src"), str(HERE)]))
    paths = [out / f"part{i}.npz" for i in range(REF_PARTS)]
    procs = [subprocess.Popen([sys.executable, str(HERE / "_graph_serving_ref.py"), str(p),
                               str(i), str(REF_PARTS)], env=env, cwd=HERE,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i, p in enumerate(paths)]
    errors = []
    for proc in procs:
        try:
            _, err = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        if proc.returncode:
            errors.append(err[-3000:])
    assert not errors, "\n".join(errors)
    return [str(p) for p in paths]


@pytest.fixture(scope="module")
def ref(ref_paths):
    out = {}
    for path in ref_paths:
        with np.load(path) as z:
            out.update({k: z[k] for k in z.files})
    return out


@pytest.fixture(scope="module")
def port(ref_paths, tmp_path_factory):
    """{case key: [rank 0's outputs, rank 1's, ...]} of the port."""
    store_dir = str(tmp_path_factory.mktemp("gloo"))
    by_rank = D.spawn(D.serve_all, 4, store_dir, ref_paths, timeout=TIMEOUT_S)
    return {k: [r[k] for r in by_rank if k in r] for k in by_rank[0]}


def _assert_step(ref, prefix, ranks, what):
    """One step of every rank against the reference's outputs under prefix."""
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["counts"], ref[f"{prefix}/counts"][r],
                                      err_msg=f"{what}: rank {r} counts")
        for leaf in D.LEAVES:
            np.testing.assert_array_equal(got[f"cache/{leaf}"], ref[f"{prefix}/cache/{leaf}"][r],
                                          err_msg=f"{what}: rank {r} cache {leaf}")
        np.testing.assert_array_equal(got["stats"], ref[f"{prefix}/stats"],
                                      err_msg=f"{what}: rank {r} stats")
        np.testing.assert_allclose(got["ema"], ref[f"{prefix}/ema"], atol=EMA_ATOL, rtol=0,
                                   err_msg=f"{what}: rank {r} ema")


GRID = [(case, mesh, layout, backend) for case in C.CASES for mesh in C.MESHES
        for layout in D.LAYOUTS for backend in D.BACKENDS]


@pytest.mark.parametrize("case,mesh,layout,backend", GRID,
                         ids=[f"{c}-{C.mesh_name(m)}-{l}-{b}" for c, m, l, b in GRID])
def test_serve_step_matches_reference(ref, port, case, mesh, layout, backend):
    name = C.mesh_name(mesh)
    steps = port[f"{case}/{name}/{layout}/{backend}"]
    assert len(steps) == mesh[0] * mesh[1]
    for s in range(C.STEPS):
        _assert_step(ref, f"{case}/{name}/step{s}", [r[s] for r in steps],
                     f"{case} {name} {layout} {backend} step {s}")
    # the second step over the same queries misses less
    assert steps[0][1]["stats"][1] < steps[0][0]["stats"][1]
    counts = np.stack([r[0]["counts"] for r in steps])
    oracle = ref[f"{case}/{name}/oracle"]
    if case == "exhausted":
        # the reference's silent loss: the port's counts are its wrong ones
        lost = {"1x1": 4, "2x2": 6, "1x4": 0, "4x1": 16}[name]
        assert int((counts != oracle).sum()) == lost
    else:
        np.testing.assert_array_equal(counts, oracle)  # |N_h(q)| - 1


SYNC_GRID = [(layout, backend) for layout in D.LAYOUTS for backend in D.BACKENDS]


@pytest.mark.parametrize("layout,backend", SYNC_GRID, ids=[f"{l}-{b}" for l, b in SYNC_GRID])
def test_synced_chain_loop_ages_the_idle_rank_cache(ref, port, layout, backend):
    """Rank 1 has no query, rank 0 a hub whose rows continue for links: the
    loop runs rank 0's links on both (as in the reference), so rank 1's
    cache clock advances though it reads nothing. Ranks 2 and 3 likewise
    with a leaf."""
    name = C.mesh_name(C.SYNC_MESH)
    steps = port[f"sync/{name}/{layout}/{backend}"]
    for s in range(C.STEPS):
        _assert_step(ref, f"sync/{name}/step{s}", [r[s] for r in steps], f"sync {layout} step {s}")
    clock = [int(r[0]["cache/clock"]) for r in steps]
    queries = ref[f"sync/{name}/queries"]
    assert (queries[1] < 0).all() and (queries[3] < 0).all()
    assert clock[1] == clock[0] > clock[3] == clock[2] > 0, clock
    assert int(steps[1][0]["cache/hits"]) == int(steps[1][0]["cache/misses"]) == 0


ADMISSION_GRID = [(scheme, mesh, layout) for mesh, schemes in C.ADMISSION.items()
                  for scheme in schemes for layout in D.LAYOUTS]


@pytest.mark.parametrize("scheme,mesh,layout", ADMISSION_GRID,
                         ids=[f"{s}-{C.mesh_name(m)}-{l}" for s, m, l in ADMISSION_GRID])
def test_admission_round_matches_reference(ref, port, scheme, mesh, layout):
    """Rank 0's admission round, field by field, and every rank's step on
    its row of the broadcast buffer, round by round through the drain."""
    name = C.mesh_name(mesh)
    prefix = f"admission/{scheme}/{name}"
    runs = port[f"{prefix}/{layout}"]
    rounds = int(ref[f"{prefix}/rounds"])
    assert all(len(r["rounds"]) == rounds for r in runs)
    for i in range(rounds):
        lead = runs[0]["rounds"][i]
        np.testing.assert_array_equal(lead["qbuf"], ref[f"{prefix}/round{i}/qbuf"])
        fields = sorted(k for k in ref if k.startswith(f"{prefix}/round{i}/adm/"))
        assert {f"adm/{k.rsplit('/adm/', 1)[1]}" for k in fields} == \
            {k for k in lead if k.startswith("adm/")}
        for k in fields:
            got = lead["adm/" + k.rsplit("/adm/", 1)[1]]
            if got.dtype.kind == "f":
                np.testing.assert_allclose(got, ref[k], atol=EMA_ATOL, rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(got, ref[k], err_msg=k)
        _assert_step(ref, f"{prefix}/round{i}", [r["rounds"][i] for r in runs],
                     f"{prefix} {layout} round {i}")


def test_admission_fifo_and_drop_oldest_on_one_processor(ref, port):
    """`test_grouting_admission_round_oversubscribed`'s contract on the port:
    with one processor the first slots of the offer (ring first, then
    fresh) are placed, the rest re-queue and the oldest drop; the buffer
    holds the placed nodes in slot order; nothing is lost."""
    prefix = "admission/next_ready/1x1"
    lead = port[f"{prefix}/dense"][0]["rounds"]
    stream = ref[f"{prefix}/stream"]
    arrivals, ring = C.arrivals((1, 1)), C.RING[(1, 1)]
    expect_ring, served, dropped = [], 0, 0
    for r, got in enumerate(lead):
        fresh = stream[r * arrivals:(r + 1) * arrivals] if r < C.BURSTS else []
        qids = range(r * arrivals, r * arrivals + len(fresh))
        offer = expect_ring + list(zip(qids, np.asarray(fresh).tolist()))
        placed_exp, rest = offer[:C.QPP], offer[C.QPP:]
        expect_ring = rest[max(len(rest) - ring, 0):]
        placed = got["adm/placed"]
        np.testing.assert_array_equal(got["adm/offered_qid"][placed], [q for q, _ in placed_exp])
        live = got["adm/backlog.qid"] >= 0
        np.testing.assert_array_equal(got["adm/backlog.qid"][live], [q for q, _ in expect_ring])
        assert int(got["adm/n_dropped"]) == len(rest) - len(expect_ring)
        np.testing.assert_array_equal(got["qbuf"][0][:len(placed_exp)],
                                      [nd for _, nd in placed_exp])
        served += int(placed.sum())
        dropped += int(got["adm/n_dropped"])
    assert not expect_ring and dropped > 0
    assert served + dropped == C.BURSTS * arrivals


@pytest.mark.parametrize("mesh", C.MESHES, ids=[C.mesh_name(m) for m in C.MESHES])
def test_mesh_coordinates_and_groups(port, mesh):
    """Rank r sits at the row-major coordinates of r; an axis's group is the
    ranks that share the other coordinate, in ascending order."""
    d, m = mesh
    for r, got in enumerate(port[f"mesh/{C.mesh_name(mesh)}"]):
        assert got["coords"] == {"data": r // m, "model": r % m}
        assert got["groups"]["model"] == [r // m * m + j for j in range(m)]
        assert got["groups"]["data"] == [i * m + r % m for i in range(d)]


@pytest.mark.parametrize("mesh", [m for m in C.MESHES if m[1] > 1],
                         ids=[C.mesh_name(m) for m in C.MESHES if m[1] > 1])
def test_sharded_feature_gather(port, mesh):
    """Striped float rows gathered over the storage group: served requests
    read their row exactly, the rest read zeros; what is served is what
    `bucket_by_owner` keeps under the budget."""
    for got in port[f"gather/{C.mesh_name(mesh)}"]:
        ids, served = got["ids"], got["served"]
        owners = np.where(ids >= 0, ids % mesh[1], 0).astype(np.int32)
        _, slot = j_bucket(ids, owners, mesh[1], 4)
        np.testing.assert_array_equal(served, np.asarray(slot) >= 0)
        assert served.any() and (~served & (ids >= 0)).any()
        expect = np.where(served[:, None], got["x"][np.maximum(ids, 0)], 0)
        np.testing.assert_array_equal(got["feat"], expect)


# ---------------------------------------------------------------------------
# In this process: the pure functions, the storage carried across, the mesh
# ---------------------------------------------------------------------------

BUCKET_CASES = [  # (B, S, capacity, owner low, owner high, share of -1 ids)
    (64, 4, 32, 0, 4, 0.2),  # roomy
    (64, 4, 8, 0, 4, 0.2),  # over capacity
    (40, 3, 16, 0, 3, 1.0),  # all padding
    (50, 2, 64, 0, 2, 0.0),  # none padded
    (48, 4, 6, 4, 9, 0.3),  # owners past S: kept slots, dropped from the buckets
    (48, 4, 6, -4, 0, 0.3),  # owners in [-S, 0): taken modulo S
]


@pytest.mark.parametrize("case", range(len(BUCKET_CASES)))
def test_bucket_by_owner_matches_reference(case):
    B, S, cap, lo, hi, pad = BUCKET_CASES[case]
    rng = np.random.default_rng(case)
    ids = rng.integers(0, 1000, B).astype(np.int32)
    ids[rng.random(B) < pad] = -1
    owners = rng.integers(lo, hi, B).astype(np.int32)
    owners[ids < 0] = rng.integers(-50, 50, int((ids < 0).sum()))  # ignored for -1 ids
    jb, js = j_bucket(ids, owners, S, cap)
    tb, ts = bucket_by_owner(torch.from_numpy(ids), torch.from_numpy(owners), S, cap)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tb.dtype == ts.dtype == torch.int32
    if lo == 0 and hi == S and pad < 1:
        assert (tb >= 0).any()


@pytest.mark.parametrize("n,f,shards", [(50, 3, 4), (7, 2, 3), (12, 5, 1)])
def test_stripe_rows_matches_reference(n, f, shards):
    x = np.random.default_rng(n).standard_normal((n, f)).astype(np.float32)
    np.testing.assert_array_equal(stripe_rows(x, shards), j_stripe(x, shards))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_serving_storage_carried_across_equals_the_port_own(ref, shards):
    """convert.serve_inputs of the reference's `make_serving_storage` dict
    equals the port's `make_serving_storage` of its own tier, shard by
    shard."""
    adj = to_padded(powerlaw_graph(**C.GRAPH), max_degree=C.MAX_DEGREE)
    tier = build_storage(adj, n_shards=shards, device="cpu")
    store = {k: ref[f"storage/{shards}/{k}"] for k in ("rows", "deg", "cont", "owner", "loc")}
    for s in range(shards):
        got = convert.serve_inputs(store, proc=0, shard=s, device="cpu")
        own = make_serving_storage(tier, s, device="cpu")
        assert got.keys() == own.keys()
        for k in own:
            assert torch.equal(got[k], own[k]), (shards, s, k)


def test_processor_caches_carried_across(ref, port):
    """convert.processor_cache of the reference's stacked caches: its empty
    `make_processor_caches` on a (1,1) mesh equals the port's, and rank r's
    slice of a step's caches is what rank r of the port holds."""
    from repro.launch.mesh import make_auto_mesh
    from repro.serve.graph_serving import GServeConfig as JConfig, \
        make_processor_caches as j_caches
    from repro_torch.serve.graph_serving import make_processor_caches

    fields = C.config((1, 1), "roomy", ref["degree"].size, ref["storage/1/owner"].size)
    empty = convert.processor_cache(j_caches(make_auto_mesh((1, 1), ("data", "model")),
                                             JConfig(**fields)), 0, "cpu")
    own = make_processor_caches(None, GServeConfig(**fields), "cpu")
    for leaf in D.LEAVES:
        assert torch.equal(getattr(empty, leaf), getattr(own, leaf)), leaf
    prefix = "roomy/2x2/step0/cache"
    for r, steps in enumerate(port["roomy/2x2/dense/cuda"]):
        got = convert.processor_cache({k: ref[f"{prefix}/{k}"] for k in D.LEAVES}, r, "cpu")
        for leaf in D.LEAVES:
            np.testing.assert_array_equal(getattr(got, leaf).numpy(), steps[0][f"cache/{leaf}"])


@pytest.fixture
def world_of_one():
    """The default process group as a world of one (gloo), torn down after."""
    mesh, dev = init_mesh((1, 1), ("data", "model"), "cpu")
    try:
        yield mesh, dev
    finally:
        dist.destroy_process_group()


def test_mesh_refuses_a_wrong_world_size(world_of_one):
    with pytest.raises(ValueError, match="world size 1"):
        ProcessMesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="subsequence"):
        ProcessMesh((1, 1), ("model", "data"))


def test_init_mesh_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_mesh((1, 1), ("data", "model"))
    assert not dist.is_initialized()


def test_abstract_serve_inputs_match_a_rank_inputs(world_of_one):
    mesh, _ = world_of_one
    adj = to_padded(powerlaw_graph(**C.GRAPH), max_degree=C.MAX_DEGREE)
    tier = build_storage(adj, n_shards=1, device="cpu")
    cfg = GServeConfig(**C.config((1, 1), "roomy", adj.n, adj.n_rows))
    meta = abstract_serve_inputs(mesh, cfg, tier.rows_per_shard)
    real = dict(make_serving_storage(tier, 0, "cpu"),
                queries=torch.zeros(C.QPP, dtype=torch.int32),
                coords=torch.zeros((adj.n, cfg.embed_dim)),
                ema=torch.zeros((1, cfg.embed_dim)))
    for k, v in real.items():
        assert meta[k].is_meta and (meta[k].shape, meta[k].dtype) == (v.shape, v.dtype), k
    from repro_torch.serve.graph_serving import make_processor_caches

    cache = make_processor_caches(mesh, cfg, "cpu")
    for leaf in D.LEAVES:
        m, c = getattr(meta["cache"], leaf), getattr(cache, leaf)
        assert (m.shape, m.dtype) == (c.shape, c.dtype), leaf


def test_serve_graph_entry_point_world_of_one():
    """`python -m repro_torch.launch.serve_graph` at a world of one on the
    CPU: every arrival is served or dropped, the backlog drains, the hit
    rate climbs after the first burst."""
    from repro_torch.launch import serve_graph

    out = serve_graph.main(["--device", "cpu", "--nodes", "300", "--bursts", "3",
                            "--backlog", "16", "--visited-layout", "packed"])
    assert not dist.is_initialized()
    assert out["arrivals"] == 3 * (serve_graph.QUERIES_PER_PROC * 3 // 2)
    assert out["served"] + out["dropped"] + out["backlog"] == out["arrivals"]
    assert out["backlog"] == 0 and out["dropped"] > 0
    assert out["misses"][-1] < out["misses"][0] <= out["touched"][0]


@pytest.fixture(scope="module")
def bursts(tmp_path_factory):
    """Each rank's `serve_bursts` figures on (2, 2) (`_torch_dist.serve_bursts_all`)."""
    return D.spawn(D.serve_bursts_all, 4, str(tmp_path_factory.mktemp("bursts")),
                   timeout=TIMEOUT_S)


def test_serve_bursts_records_every_rank(bursts):
    """Every rank of a (2, 2) mesh returns its own record of `serve_bursts`:
    the queries it served, burst by burst, their counts (each what
    `capped_ball_size` marks less one, whichever processor served it) and
    the mesh's stats, the same on every rank; together the ranks served
    what rank 0 placed, every processor some."""
    from repro_torch.configs import grouting
    from repro_torch.core.serving import capped_ball_size

    cfg = grouting.smoke_cfg()
    g = D.bursts_graph(cfg.n_nodes)
    cap = cfg.row_width * cfg.chain_depth
    lead = bursts[0]
    n_bursts = len(lead["record"])
    assert lead["served"] + lead["dropped"] == lead["arrivals"] and lead["backlog"] == 0
    served = []
    for r, run in enumerate(bursts):
        assert len(run["record"]) == len(run["burst_s"]) == n_bursts
        assert ("served" in run) == (r == 0)
        mine = 0
        for b, (queries, counts, stats) in enumerate(run["record"]):
            np.testing.assert_array_equal(stats, lead["record"][b][2])
            assert run["touched"][b] == lead["touched"][b]
            for q, c in zip(queries.tolist(), counts.tolist()):
                if q >= 0:
                    assert c == capped_ball_size(g, q, cfg.hops, cfg.max_frontier, cap) - 1
                    mine += 1
        served.append(mine)
    assert sum(served) == lead["served"] and min(served) > 0, served
