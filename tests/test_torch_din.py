"""The port's DIN against the reference, on the CPU.

At DIN's `smoke_cfg()` the reference's parameters are carried across with
`repro_torch.convert.params_from_reference`, and the same `din_batch`
goes through both packages:

  - `user_vector` and `score` within OUT_TOL of their largest |entry|;
  - `loss_fn`: the loss within LOSS_TOL (relative) and every gradient leaf
    (the embedding tables' sparse rows included) within GRAD_TOL of its
    own largest |entry|;
  - `retrieval_scores` (one user against a set of candidates, -1 history
    entries among them) within OUT_TOL;
  - padded history entries (-1) change nothing: other categories behind
    them leave the user vector, the score and the gradients as they were;
  - three train steps through `make_train_step` against the reference's;
  - the config and `SHAPES` equal the reference's.

All float32: the packages differ in the order of float32 sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import din as jconf
from repro.data.recsys import din_batch
from repro.models.param import init_params as jinit
from repro.models.recsys import din as JD
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.configs import din as tconf
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.models.recsys import din as TD
from repro_torch.train.train_step import init_train_state, make_train_step

OUT_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
STEP_TOL = 1e-4
LR_SHARE_TOL = 1e-2  # as tests/test_torch_gnn_models.py states it
B = 32


@pytest.fixture(scope="module")
def setup():
    cfg = jconf.smoke_cfg()
    params = jinit(JD.param_specs(cfg), jax.random.PRNGKey(0))
    batch = din_batch(0, B, seq_len=cfg.seq_len, n_items=cfg.n_items, n_cats=cfg.n_cats,
                      d_profile=cfg.d_profile)
    assert (batch["hist_items"] < 0).any()  # ragged histories
    return cfg, TD.DINConfig(**dataclasses.asdict(cfg)), params, batch


def tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(a, b, tol, what=""):
    b = np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def _port_grads(cfg, params, batch):
    state = init_train_state(convert.params_from_reference(params, "cpu"))
    loss, m = TD.loss_fn(state.params, tb(batch), cfg)
    loss.backward()
    return loss, m, tree_map(lambda p: p.grad, state.params)


def test_user_vector_and_score_match_the_reference(setup):
    cfg, tcfg, params, batch = setup
    tp = convert.params_from_reference(params, "cpu")
    _close(TD.user_vector(tp, tb(batch), tcfg).numpy(),
           JD.user_vector(params, batch, cfg), OUT_TOL, "user_vector")
    _close(TD.score(tp, tb(batch), tcfg).numpy(), JD.score(params, batch, cfg), OUT_TOL,
           "score")


def test_loss_and_every_gradient_match_the_reference(setup):
    cfg, tcfg, params, batch = setup
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JD.loss_fn(p, b, cfg), has_aux=True))(params, batch)
    loss, m, grads = _port_grads(tcfg, params, batch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL)
    np.testing.assert_allclose(m["bce"].item(), float(jm["bce"]), rtol=LOSS_TOL)
    jleaves, leaves = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(jleaves) == len(leaves)
    for i, (j, g) in enumerate(zip(jleaves, leaves)):
        _close(g.numpy(), j, GRAD_TOL, f"gradient leaf {i}")
    # the tables' gradients are sparse: rows no id reads get exactly 0
    rows = np.unique(np.maximum(np.concatenate([batch["hist_items"].ravel(),
                                                batch["cand_item"]]), 0))
    unread = np.setdiff1d(np.arange(cfg.n_items), rows)
    assert not grads["item_table"][unread].any()


def test_retrieval_scores_match_the_reference(setup):
    cfg, tcfg, params, _ = setup
    rng = np.random.default_rng(0)
    hist = rng.integers(0, cfg.n_items, (1, cfg.seq_len)).astype(np.int32)
    hist[0, -3:] = -1
    b = {"hist_items": hist,
         "hist_cats": rng.integers(0, cfg.n_cats, (1, cfg.seq_len)).astype(np.int32),
         "profile": rng.standard_normal((1, cfg.d_profile)).astype(np.float32),
         "cand_items": rng.integers(0, cfg.n_items, 500).astype(np.int32),
         "cand_cats": rng.integers(0, cfg.n_cats, 500).astype(np.int32)}
    got = TD.retrieval_scores(convert.params_from_reference(params, "cpu"), tb(b), tcfg)
    assert got.shape == (500,)
    _close(got.numpy(), JD.retrieval_scores(params, b, cfg), OUT_TOL, "retrieval")


def test_padded_history_entries_change_nothing(setup):
    cfg, tcfg, params, batch = setup
    pad = batch["hist_items"] < 0
    cats = batch["hist_cats"].copy()
    cats[pad] = (cats[pad] + 7) % cfg.n_cats
    other = dict(batch, hist_cats=cats)
    tp = convert.params_from_reference(params, "cpu")
    for fn in (TD.user_vector, TD.score):
        assert torch.equal(fn(tp, tb(batch), tcfg), fn(tp, tb(other), tcfg))
    g1, g2 = _port_grads(tcfg, params, batch)[2], _port_grads(tcfg, params, other)[2]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g2)))


def test_three_train_steps_match_the_reference(setup):
    cfg, tcfg, params, _ = setup
    kw = dict(warmup=2, total_steps=10)
    jstate = JTS.init_train_state(params)
    state = convert.train_state_from_reference(jstate, None, "cpu")
    jstep = JTS.make_train_step(lambda p, b: JD.loss_fn(p, b, cfg), donate=False, **kw)
    step = make_train_step(lambda p, b: TD.loss_fn(p, b, tcfg), **kw)
    lr_sum = 0.0
    for i in range(3):
        batch = din_batch(i, B, seq_len=cfg.seq_len, n_items=cfg.n_items, n_cats=cfg.n_cats,
                          d_profile=cfg.d_profile)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, tb(batch))
        assert int(m["skipped"]) == int(jm["skipped"]) == 0
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=STEP_TOL, err_msg=k)
        lr_sum += float(jm["lr"])
    got = convert.train_state_to_reference(state)
    for name in ("m", "v"):
        for i, (a, b) in enumerate(zip(tree_leaves(got["opt_state"][name]),
                                       jax.tree.leaves(jstate.opt_state[name]))):
            _close(np.asarray(a), b, STEP_TOL, f"{name} leaf {i}")
    for i, (a, b) in enumerate(zip(tree_leaves(got["params"]), jax.tree.leaves(jstate.params))):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, err_msg=f"parameter leaf {i}",
                                   atol=STEP_TOL * np.abs(b).max() + LR_SHARE_TOL * lr_sum)


def test_config_and_shapes_equal_the_reference():
    assert dataclasses.asdict(tconf.model_cfg()) == dataclasses.asdict(jconf.model_cfg())
    assert dataclasses.asdict(tconf.smoke_cfg()) == dataclasses.asdict(jconf.smoke_cfg())
    assert tconf.SHAPES == jconf.SHAPES
