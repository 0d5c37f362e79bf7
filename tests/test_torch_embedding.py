"""The port's graph embedding (`repro_torch.core.embedding`, paper Algorithm
3) against the reference's `repro.core.embedding` on the CPU.

The reference draws its inits from `jax.random`; the port takes them as
tensors, so each test passes the reference's own draws (`_ref_noise`
replays its keys: `PRNGKey(seed)` split in two for the landmarks and the
nodes, `PRNGKey(1)` for an incremental node). Both then run the same Adam
steps on the same loss; only float rounding differs (the gradient's
order of operations, `pow` of the step count).

Tolerances, each set from what was measured on this CPU build before the
test was written:

  - `_rel_err_loss`, its gradient and one Adam step: rtol 1e-5 (float32
    arithmetic over a few hundred terms);
  - coordinates: atol 5e-4, about 7x the worst difference measured
    (coordinates reach 12-14 in magnitude): 2.6e-5 (landmarks 1.9e-6) at
    conftest's config (dim 8, 200 / 80 steps) and 5.2e-6 at the defaults
    (dim 10, 500 / 200) on `small_graph` (4,800 nodes, 24 landmarks);
    7.0e-5 at `tests/_torch_parity.py`'s `engine_cluster` (1,200 nodes,
    12 landmarks, dim 6, 80 / 30 steps);
  - `rel_error`: 1e-5 absolute (a mean of relative errors of 0.20-0.41;
    the two packages' differ by 1e-8 at most at these configs);
  - the reference `Router` routes 512 queries on the port's coordinates
    exactly as on its own (0 of 512 differed at both graphs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import COORD_ATOL, P, engine_cluster, t
from repro.core import embedding as je
from repro.core.router import Router as JRouter, RouterConfig as JConfig
from repro_torch import convert
from repro_torch.core import embedding as te

REL_ERROR_ATOL = 1e-5
LOSS_RTOL = 1e-5


def _ref_noise(seed: int, L: int, n: int, dim: int):
    """The reference's init draws of `build_graph_embedding`, as tensors."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return (t(jax.random.normal(k1, (L, dim))), t(jax.random.normal(k2, (n, dim))))


def _port_embedding(dist_to_lm, landmarks, cfg):
    lm_noise, node_noise = _ref_noise(cfg.seed, len(landmarks), dist_to_lm.shape[0], cfg.dim)
    return te.build_graph_embedding(dist_to_lm, landmarks, te.EmbedConfig(
        **dataclasses.asdict(cfg)), device="cpu", lm_noise=lm_noise, node_noise=node_noise)


def assert_embeddings_close(ref, port, dist_to_lm):
    np.testing.assert_array_equal(port.landmarks, np.asarray(ref.landmarks))
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    assert port.coords.dtype == np.float32 and port.coords.shape == ref.coords.shape
    np.testing.assert_allclose(port.lm_coords, np.asarray(ref.lm_coords), rtol=0,
                               atol=COORD_ATOL)
    np.testing.assert_allclose(port.coords, np.asarray(ref.coords), rtol=0, atol=COORD_ATOL)
    assert abs(port.rel_error(dist_to_lm) - ref.rel_error(dist_to_lm)) < REL_ERROR_ATOL


@pytest.fixture(scope="module")
def cluster():
    return engine_cluster()


def _loss_inputs(seed=0, n=64, L=12, dim=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)).astype(np.float32) * 3
    lm = rng.standard_normal((L, dim)).astype(np.float32) * 3
    d = rng.integers(0, 9, (n, L)).astype(np.int32)
    d[rng.random((n, L)) < 0.1] = int(te.UNREACHED)
    return x, lm, d


def test_rel_err_loss_and_gradient_match_reference():
    x, lm, d = _loss_inputs()

    def jloss(x_):
        diff = x_[:, None, :] - jnp.asarray(lm)[None]
        return je._rel_err_loss(jnp.sqrt(jnp.sum(diff * diff, -1) + 1e-12), jnp.asarray(d), 1e-6)

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(x))
    tx = t(x).requires_grad_(True)
    tl = te._rel_err_loss(te._pair_dist(tx, t(lm)), t(d), 1e-6)
    (tg,) = torch.autograd.grad(tl, tx)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=LOSS_RTOL, atol=1e-9)
    # no valid pair: the count is clamped to 1, the loss is 0
    none = np.zeros_like(d)
    assert te._rel_err_loss(te._pair_dist(t(x), t(lm)), t(none), 1e-6).item() == 0.0


@pytest.mark.parametrize("step", [1.0, 2.0, 37.0])
def test_adam_step_matches_reference(step):
    rng = np.random.default_rng(int(step))
    p, g, m, v = (rng.standard_normal((40, 6)).astype(np.float32) for _ in range(4))
    v = np.abs(v)
    ref = je._adam_update(*(jnp.asarray(a) for a in (p, g, m, v)), jnp.float32(step), 0.05)
    out = te._adam_update(*(t(a) for a in (p, g, m, v)),
                          torch.tensor(step, dtype=torch.float32), 0.05)
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=LOSS_RTOL, atol=1e-7)


def test_embed_landmarks_and_nodes_match_reference(landmark_index, graph_embedding):
    """conftest's config (dim 8, 200 / 80 steps) on `small_graph`, each
    stage alone: the landmarks from the reference's draw, then the nodes
    against the reference's own landmark coordinates."""
    li, cfg = landmark_index, graph_embedding.config
    lm_noise, node_noise = _ref_noise(cfg.seed, len(li.landmarks), li.dist_to_lm.shape[0],
                                      cfg.dim)
    lm = te.embed_landmarks(t(li.dist_to_lm[li.landmarks]), cfg.dim, cfg.lm_steps, cfg.lr,
                            noise=lm_noise)
    np.testing.assert_allclose(lm.numpy(), graph_embedding.lm_coords, rtol=0, atol=COORD_ATOL)
    nodes = te.embed_nodes(t(li.dist_to_lm), t(graph_embedding.lm_coords), cfg.node_steps,
                           cfg.lr, noise=node_noise)
    expect = np.asarray(graph_embedding.coords).copy()
    not_lm = np.setdiff1d(np.arange(expect.shape[0]), li.landmarks)
    np.testing.assert_allclose(nodes.numpy()[not_lm], expect[not_lm], rtol=0, atol=COORD_ATOL)


@pytest.mark.parametrize("config", ["conftest", "defaults"])
def test_build_graph_embedding_matches_reference(landmark_index, graph_embedding, config):
    li = landmark_index
    if config == "conftest":
        ref = graph_embedding
    else:
        ref = je.build_graph_embedding(li.dist_to_lm, li.landmarks, je.EmbedConfig())
    port = _port_embedding(li.dist_to_lm, li.landmarks, ref.config)
    assert_embeddings_close(ref, port, li.dist_to_lm)
    # landmarks keep their directly optimised coordinates
    np.testing.assert_array_equal(port.coords[li.landmarks], port.lm_coords)


def test_build_graph_embedding_matches_reference_on_engine_cluster(cluster):
    li, ref = cluster["li"], cluster["ge"]
    assert_embeddings_close(ref, cluster["pge"], li.dist_to_lm)


@pytest.mark.parametrize("u", [7, 1234])
def test_incremental_embed_node_matches_reference(landmark_index, graph_embedding, u):
    d = landmark_index.dist_to_lm[u]
    ref = je.incremental_embed_node(graph_embedding, d)
    port_emb = convert.graph_embedding(graph_embedding)
    noise = t(jax.random.normal(jax.random.PRNGKey(1), (1, port_emb.config.dim)))
    x = te.incremental_embed_node(port_emb, d, device="cpu", noise=noise)
    assert x.shape == (port_emb.coords.shape[1],) and x.dtype == np.float32
    np.testing.assert_allclose(x, np.asarray(ref), rtol=0, atol=COORD_ATOL)
    # fewer steps, as the reference's `steps` argument
    x5 = te.incremental_embed_node(port_emb, d, steps=5, device="cpu", noise=noise)
    np.testing.assert_allclose(x5, np.asarray(je.incremental_embed_node(graph_embedding, d, 5)),
                               rtol=0, atol=COORD_ATOL)


def test_incremental_embed_node_default_draw_lands_near(landmark_index, graph_embedding):
    """The port's own draw (no noise given): the reference test's criterion,
    relative error against the landmarks under 0.5."""
    u = 7
    port_emb = convert.graph_embedding(graph_embedding)
    x = te.incremental_embed_node(port_emb, landmark_index.dist_to_lm[u], device="cpu")
    d_true = landmark_index.dist_to_lm[u].astype(np.float64)
    pred = np.sqrt(((port_emb.lm_coords - x) ** 2).sum(-1))
    valid = d_true < 1e8
    assert np.isfinite(x).all()
    assert (np.abs(pred[valid] - d_true[valid]) / np.maximum(d_true[valid], 1e-9)).mean() < 0.5


def test_default_draws_are_seeded(cluster):
    """Without noise the draws come from a generator seeded with
    config.seed: the same seed gives the same coordinates, another seed
    others, and the result embeds as well as the reference's."""
    li = cluster["li"]
    cfg = te.EmbedConfig(dim=6, lm_steps=80, node_steps=30, seed=0)
    a = te.build_graph_embedding(li.dist_to_lm, li.landmarks, cfg, device="cpu")
    b = te.build_graph_embedding(li.dist_to_lm, li.landmarks, cfg, device="cpu")
    c = te.build_graph_embedding(li.dist_to_lm, li.landmarks,
                                 dataclasses.replace(cfg, seed=1), device="cpu")
    np.testing.assert_array_equal(a.coords, b.coords)
    assert not np.array_equal(a.coords, c.coords)
    assert np.isfinite(a.coords).all()
    assert a.rel_error(li.dist_to_lm) < 1.5 * cluster["ge"].rel_error(li.dist_to_lm)
    with pytest.raises(ValueError, match="noise"):
        te.build_graph_embedding(li.dist_to_lm, li.landmarks, cfg, device="cpu",
                                 lm_noise=torch.zeros(3, 6))


def test_default_draw_does_not_depend_on_the_device(cluster, monkeypatch):
    """Without noise the inits draw on a CPU generator and move the draw to
    the run's device, so one seed gives the same init on every device: a
    device with no generator of its own ("meta") still gets the draw, and
    every default draw is the CPU generator's (the explicit draws that
    `chip_smoke.py` phase 3 passes to the card and the CPU)."""
    drawn_on = []
    randn = torch.randn

    def spy(*args, generator=None, **kw):
        drawn_on.append(generator.device)
        return randn(*args, generator=generator, **kw)

    meta = te._noise((5, 3), None, None, torch.device("meta"))
    assert meta.is_meta and meta.shape == (5, 3)
    np.testing.assert_array_equal(
        te._noise((5, 3), None, None, torch.device("cpu")).numpy(),
        torch.randn((5, 3), generator=torch.Generator().manual_seed(0)).numpy())
    li = cluster["li"]
    cfg = te.EmbedConfig(dim=6, lm_steps=20, node_steps=10, seed=3)
    monkeypatch.setattr(torch, "randn", spy)
    default = te.build_graph_embedding(li.dist_to_lm, li.landmarks, cfg, device="cpu")
    monkeypatch.undo()
    assert drawn_on == [torch.device("cpu")] * 2
    gen = torch.Generator().manual_seed(cfg.seed)
    lm_noise = torch.randn((len(li.landmarks), cfg.dim), generator=gen)
    node_noise = torch.randn((li.dist_to_lm.shape[0], cfg.dim), generator=gen)
    given = te.build_graph_embedding(li.dist_to_lm, li.landmarks, cfg, device="cpu",
                                     lm_noise=lm_noise, node_noise=node_noise)
    np.testing.assert_array_equal(default.coords, given.coords)


def test_rel_error_is_the_references(cluster):
    """`rel_error` is numpy on both sides: bit-equal on the same coordinates."""
    ref, li = cluster["ge"], cluster["li"]
    port = convert.graph_embedding(ref)
    for sample, seed in ((4096, 0), (100, 3)):
        assert port.rel_error(li.dist_to_lm, sample, seed) == \
            ref.rel_error(li.dist_to_lm, sample, seed)


def _assignments(emb, queries):
    router = JRouter(P, JConfig(scheme="embed"), embedding=emb, seed=3)
    _, assign = router.route_batch(router.init_state(), jnp.asarray(queries))
    return np.asarray(assign)


@pytest.mark.parametrize("graph", ["small_graph", "engine_cluster"])
def test_reference_router_on_port_coordinates(graph, landmark_index, graph_embedding,
                                              cluster, small_graph):
    """The reference's embed router assigns 512 queries on the port-trained
    coordinates exactly as on its own."""
    if graph == "small_graph":
        li, ref, n = landmark_index, graph_embedding, small_graph.n
        port = _port_embedding(li.dist_to_lm, li.landmarks, ref.config)
    else:
        ref, port, n = cluster["ge"], cluster["pge"], cluster["g"].n
    queries = np.random.default_rng(5).integers(0, n, 512).astype(np.int32)
    port_as_ref = je.GraphEmbedding(coords=port.coords, landmarks=port.landmarks,
                                    lm_coords=port.lm_coords, config=ref.config)
    np.testing.assert_array_equal(_assignments(port_as_ref, queries),
                                  _assignments(ref, queries))
