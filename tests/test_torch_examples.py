"""The port's examples (`repro_torch.examples`) against the reference's
functions composed the same way as its `examples/`, on the CPU, at small
sizes.

  - quickstart: every row (qps, resp_ms, hit, stolen) bit-equal, the
    embedding's init draws being the reference's own (`jax.random`);
    qps and resp_ms are cost-model derivations, and the output says so;
  - din_serving: `auc` bit-equal on the same scores; three training steps
    from the reference's parameters (`repro_torch.convert`) within
    STEP_TOL, as `tests/test_torch_din.py` holds them, then `score` on a
    serving batch within STEP_TOL of the largest |score|;
  - weather_graphcast: three steps from the reference's parameters, the
    losses within STEP_TOL.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import torch

from _torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from repro.core import embedding as r_embedding
from repro.core.landmarks import build_landmark_index as r_landmarks
from repro.core.serving import BallCache, ServingSimulator, SimRouter, SimRouterConfig
from repro.core.workloads import hotspot_workload
from repro.data.recsys import din_batch
from repro.graph.generators import community_graph, icosahedral_multimesh
from repro.models.gnn import graphcast as r_graphcast
from repro.models.param import init_params
from repro.models.recsys import din as r_din
from repro.train import train_step as r_train
from repro_torch import convert
from repro_torch.configs import din as din_config
from repro_torch.core.costmodel import DERIVED
from repro_torch.core.embedding import EmbedConfig
from repro_torch.examples import din_serving, quickstart, weather_graphcast
from repro_torch.models.param import tree_leaves

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
STEP_TOL = 1e-4  # tests/test_torch_din.py's, of a leaf's largest |entry|
LR_SHARE_TOL = 1e-2  # of the summed learning rates, the same file's

QUICK = dict(n=1200, community_size=60, n_processors=4, n_landmarks=8,
             embed=dict(dim=10, lm_steps=40, node_steps=20), n_hotspots=10,
             queries_per_hotspot=5, cache_entries=100, hops=3)


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_rows_equal_the_reference():
    q = QUICK
    g = community_graph(n=q["n"], community_size=q["community_size"], intra_degree=6,
                        inter_degree=1.0, seed=0)
    li = r_landmarks(g, n_processors=q["n_processors"], n_landmarks=q["n_landmarks"],
                     min_separation=3)
    cfg = r_embedding.EmbedConfig(**q["embed"])
    ge = r_embedding.build_graph_embedding(li.dist_to_lm, li.landmarks, cfg)
    wl = hotspot_workload(g, r=2, n_hotspots=q["n_hotspots"],
                          queries_per_hotspot=q["queries_per_hotspot"], seed=1)
    balls = BallCache(g)
    want = []
    for scheme in quickstart.SCHEMES:
        rt = SimRouter(q["n_processors"], SimRouterConfig(scheme=scheme), landmark_index=li,
                       embedding=ge)
        sim = ServingSimulator(g, q["n_processors"], rt, cache_entries=q["cache_entries"],
                               h=q["hops"], use_cache=(scheme != "no_cache"), ball_cache=balls)
        want.append(sim.run(wl))

    k1, k2 = jax.random.split(jax.random.PRNGKey(cfg.seed))
    noise = dict(lm_noise=torch.from_numpy(np.array(
                     jax.random.normal(k1, (len(li.landmarks), cfg.dim)))),
                 node_noise=torch.from_numpy(np.array(
                     jax.random.normal(k2, (g.n, cfg.dim)))))
    lines = []
    got = quickstart.run(**dict(q, embed=EmbedConfig(**q["embed"])), device="cpu",
                         out=lines.append, **noise)
    assert [r.scheme for r in got] == list(quickstart.SCHEMES)
    for ours, ref in zip(got, want):
        assert (ours.throughput_qps, ours.mean_response_ms, ours.hit_rate, ours.stolen) == \
            (ref.throughput_qps, ref.mean_response_ms, ref.hit_rate, ref.stolen), ours.scheme
    assert lines[1] == f"graph: {g.n} nodes, {g.e} directed edges (bi-directed)"
    assert any(DERIVED in ln for ln in lines)
    rows = [ln.split() for ln in lines if ln.split() and ln.split()[0] in quickstart.SCHEMES]
    assert [r[0] for r in rows] == list(quickstart.SCHEMES)
    assert [float(r[3]) for r in rows] == [round(w.hit_rate, 3) for w in want]


def test_din_auc_steps_and_score_match_the_reference():
    ref_ex = _reference_example("din_serving")
    rng = np.random.default_rng(3)
    scores, labels = rng.standard_normal(257), rng.integers(0, 2, 257)
    assert din_serving.auc(scores, labels) == ref_ex.auc(scores, labels)
    assert din_serving.auc(scores, np.ones(257, int)) == ref_ex.auc(scores, np.ones(257, int))

    cfg = r_din.DINConfig(**dataclasses.asdict(din_config.smoke_cfg()))
    params = init_params(r_din.param_specs(cfg), jax.random.PRNGKey(0))
    steps, B, serve_B = 3, 64, 48
    mk = lambda step, n: din_batch(step, n, seq_len=cfg.seq_len, n_items=cfg.n_items,
                                   n_cats=cfg.n_cats, d_profile=cfg.d_profile)
    step_fn = r_train.make_train_step(lambda p, b: r_din.loss_fn(p, b, cfg), warmup=5,
                                      total_steps=steps, donate=False)
    state, losses, lr_sum = r_train.init_train_state(params), [], 0.0
    for step in range(steps):
        state, m = step_fn(state, mk(step, B))
        losses.append(float(m["loss"]))
        lr_sum += float(m["lr"])

    got = din_serving.run(din_config.smoke_cfg(), train_steps=steps, train_batch=B,
                          serve=(("serve_p99", serve_B, 2),), n_candidates=300, device="cpu",
                          params=convert.params_from_reference(params, "cpu"),
                          out=lambda s: None)
    np.testing.assert_allclose(got["losses"], losses, rtol=STEP_TOL)
    for i, (a, b) in enumerate(zip(tree_leaves(convert.params_to_reference(got["params"])),
                                   jax.tree.leaves(state.params))):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, err_msg=f"parameter leaf {i}",
                                   atol=STEP_TOL * np.abs(b).max() + LR_SHARE_TOL * lr_sum)
    want = np.asarray(r_din.score(state.params, mk(1001, serve_B), cfg))
    serve = got["serve_p99"]
    np.testing.assert_allclose(serve["scores"], want, rtol=0,
                               atol=STEP_TOL * np.abs(want).max())
    assert serve["auc"] == din_serving.auc(serve["scores"], mk(1001, serve_B)["label"])
    assert len(serve["walls_s"]) == 2 and serve["qps"] > 0
    assert len(got["retrieval"]["top5"]) == 5


def test_weather_graphcast_steps_match_the_reference():
    steps, refinement, n_vars = 3, 2, 8
    mm = icosahedral_multimesh(refinement=refinement, grid_per_mesh=3)
    cfg = r_graphcast.GraphCastConfig(n_layers=4, d_hidden=64, n_vars=n_vars, d_in=n_vars,
                                      n_out=n_vars, mode="weather")
    params = init_params(r_graphcast.param_specs(cfg), jax.random.PRNGKey(0))
    basis = np.random.default_rng(0).standard_normal((mm.n_grid, n_vars)).astype(np.float32)

    def batch_fn(step):
        t = step * 0.1
        x = np.sin(t) * basis + 0.5 * np.cos(2 * t) * np.roll(basis, 1, 1)
        y = np.sin(t + 0.1) * basis + 0.5 * np.cos(2 * (t + 0.1)) * np.roll(basis, 1, 1)
        return {"grid_feat": x, "grid_target": y, "mesh_src": mm.mesh_src,
                "mesh_dst": mm.mesh_dst, "g2m_src": mm.g2m_src, "g2m_dst": mm.g2m_dst,
                "m2g_src": mm.m2g_src, "m2g_dst": mm.m2g_dst}

    step_fn = r_train.make_train_step(
        lambda p, b: r_graphcast.loss_fn(p, dict(b, n_mesh=mm.n_mesh), cfg), warmup=10,
        total_steps=steps, donate=False)
    state, losses = r_train.init_train_state(params), []
    for step in range(steps):
        state, m = step_fn(state, {k: jax.numpy.asarray(v) for k, v in batch_fn(step).items()})
        losses.append(float(m["loss"]))

    lines = []
    got = weather_graphcast.run(steps, refinement, n_vars, device="cpu",
                                params=convert.params_from_reference(params, "cpu"),
                                out=lines.append)
    np.testing.assert_allclose(got["losses"], losses, rtol=STEP_TOL)
    assert lines[0].startswith(f"multimesh: {mm.n_mesh} mesh nodes")
    assert lines[-1].startswith(f"mse {got['losses'][0]:.4f} -> ")
