"""The port's checkpointer, train step and trainer, on the CPU: the
reference's `tests/test_trainer_checkpoint.py` case for case (round trip,
garbage collection, a restart after an injected failure equal to an
uninterrupted run, non-finite skip, accumulation equal to the full batch,
the async checkpointer), and against the reference itself:

  - the port restores a float32 `TrainState` that the reference's
    `save_checkpoint` wrote, leaf for leaf;
  - bfloat16 leaves round-trip bit for bit (stored as their uint16 bits);
  - three `make_train_step` steps of the qwen3 smoke config (float32) from
    the same state and batches equal the reference's: `step`, `count` and
    `skipped` exactly, the loss and grad norm within STEP_TOL (relative),
    every parameter, m and v within STEP_TOL of the leaf's largest |entry|
    (float32 sums in another order; measured up to 3.4e-6, the metrics within
    2.2e-7).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import save_checkpoint as jsave_checkpoint
from repro.configs import get_arch
from repro.models import transformer as JT
from repro.models.param import init_params as jinit_params
from repro.train import train_step as JS
from repro_torch import convert
from repro_torch.checkpoint import Checkpointer, latest_step, restore_checkpoint, \
    save_checkpoint
from repro_torch.data.tokens import token_batch
from repro_torch.models import transformer as T
from repro_torch.models.param import tree_leaves
from repro_torch.train.train_step import TrainState, accum_value_and_grad, \
    init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

STEP_TOL = 2e-5


def _toy_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = torch.mean((pred - batch["y"]) ** 2)
    return loss, {"mse": loss}


def _toy_params(key=0):
    """The reference test's draws, carried across."""
    k = jax.random.PRNGKey(key)
    return {"w": convert.tensor(jax.random.normal(k, (8, 4)) * 0.1, "cpu"),
            "b": torch.zeros((4,))}


def _toy_batch(step):
    rng = np.random.default_rng(step)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    w_true = np.arange(32, dtype=np.float32).reshape(8, 4) / 32
    return {"x": x, "y": x @ w_true}


def _leaves(state: TrainState) -> list:
    return tree_leaves([state.params, state.opt_state, state.step])


def test_checkpoint_roundtrip(tmp_path):
    state = init_train_state(_toy_params())
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 7, state)
    assert latest_step(d) == 7
    like = init_train_state(_toy_params(key=1))
    restored, step = restore_checkpoint(d, None, like)
    assert step == 7 and restored is like
    for a, b in zip(_leaves(restored), _leaves(state)):
        assert torch.equal(a, b)
    assert isinstance(restored.params["w"], torch.nn.Parameter)


def test_checkpoint_gc_keeps_last(tmp_path):
    d = str(tmp_path / "ckpt")
    state = init_train_state(_toy_params())
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, state, keep_last=2)
    assert sorted(int(x.split("_")[1]) for x in os.listdir(d)) == [4, 5]


def _trainer(tmp_path, name, **kw):
    cfg = TrainerConfig(total_steps=20, ckpt_every=5, log_every=100,
                        ckpt_dir=str(tmp_path / name), warmup=2, **kw)
    return Trainer(_toy_loss, _toy_params, _toy_batch, cfg, device="cpu")


def test_restart_is_deterministic(tmp_path):
    """Uninterrupted run == run that fails at step 12 and restarts from the
    step-10 checkpoint (the data pipeline replays each step's batch)."""
    s1 = _trainer(tmp_path, "a").run()
    boom = {"done": False}

    def injector(step):
        if step == 12 and not boom["done"]:
            boom["done"] = True
            raise RuntimeError("injected node failure")

    s2 = _trainer(tmp_path, "b").run(failure_injector=injector)
    assert boom["done"]
    assert int(s1.step) == int(s2.step) == 20
    for a, b in zip(_leaves(s1), _leaves(s2)):
        assert torch.equal(a, b)


def test_failure_restores_the_last_checkpoint(tmp_path):
    """A failure at step 7 goes back to step 5; the trainer restarted from the
    directory starts at the final step and takes none."""
    seen = []

    def injector(step):
        seen.append(step)
        if len(seen) == 8:  # steps 0..6, then the failure at 7
            raise RuntimeError("injected")

    t = _trainer(tmp_path, "c")
    t.run(failure_injector=injector)
    assert seen[:10] == [0, 1, 2, 3, 4, 5, 6, 7, 5, 6]
    assert latest_step(str(tmp_path / "c")) == 20
    again = _trainer(tmp_path, "c").run()
    assert int(again.step) == 20


def test_nonfinite_grad_skipped():
    def nan_loss(params, batch):
        return torch.sum(params["w"]) * batch["scale"], {}

    step_fn = make_train_step(nan_loss)
    state = init_train_state({"w": torch.ones((4,))})
    before = state.params["w"].detach().clone()
    new_state, metrics = step_fn(state, {"scale": torch.tensor(float("nan"))})
    assert int(metrics["skipped"]) == 1
    assert torch.equal(new_state.params["w"], before)
    assert int(new_state.opt_state["count"]) == 0 and int(new_state.step) == 1


@pytest.mark.parametrize("accum", [2, 4])
def test_accum_grad_equals_full_batch(accum):
    """Accumulated microbatch gradients (float32) == one big batch's, for a
    loss that is a mean over examples."""
    state = init_train_state(_toy_params())
    batch = {k: torch.from_numpy(v) for k, v in _toy_batch(0).items()}
    (l1, _), g1 = accum_value_and_grad(_toy_loss, 1)(state.params, batch)
    (l4, m4), g4 = accum_value_and_grad(_toy_loss, accum)(state.params, batch)
    np.testing.assert_allclose(l1.item(), l4.item(), rtol=1e-6)
    np.testing.assert_allclose(m4["mse"].item(), l4.item(), rtol=1e-6)
    for a, b in zip(tree_leaves(g1), tree_leaves(g4)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert all(p.grad is None for p in tree_leaves(state.params))


def test_async_checkpointer(tmp_path):
    ck = Checkpointer(str(tmp_path / "c"), keep_last=2)
    state = init_train_state(_toy_params())
    ck.save(1, state)
    first = state.params["w"].detach().clone()
    with torch.no_grad():  # the snapshot was taken at save: later updates miss it
        state.params["w"].add_(1.0)
    ck.save(2, state)
    ck.wait()
    assert latest_step(ck.directory) == 2
    like = init_train_state(_toy_params(key=3))
    restored, step = ck.restore_latest(like)
    assert step == 2 and torch.equal(restored.params["w"], state.params["w"])
    restore_checkpoint(ck.directory, 1, like)
    assert torch.equal(like.params["w"], first)


def test_restores_a_reference_checkpoint(tmp_path):
    """A float32 TrainState written by the reference's save_checkpoint comes
    back leaf for leaf under the same keys."""
    jstate = JS.init_train_state({"w": jnp.arange(32, dtype=jnp.float32).reshape(8, 4),
                                  "b": jnp.ones((4,))})
    jstate = JS.TrainState(params=jstate.params,
                           opt_state=dict(jstate.opt_state, count=jnp.int32(3),
                                          m={"w": jnp.full((8, 4), 0.5), "b": jnp.ones((4,))}),
                           step=jnp.int32(9))
    d = str(tmp_path / "ref")
    jsave_checkpoint(d, 9, jstate)
    like = init_train_state(_toy_params())
    restored, step = restore_checkpoint(d, None, like)
    assert step == 9 and int(restored.step) == 9 and int(restored.opt_state["count"]) == 3
    want = convert.train_state_to_reference(convert.train_state_from_reference(jstate, None, "cpu"))
    got = convert.train_state_to_reference(restored)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_bf16_leaves_round_trip_bit_exact(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn((7, 5), generator=g).to(torch.bfloat16),
            "b": [torch.randn((3,), generator=g), torch.tensor(5, dtype=torch.int32)]}
    save_checkpoint(str(tmp_path), 1, tree)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        dtypes = {m["key"]: m["dtype"] for m in json.load(f)["leaves"]}
    assert dtypes == {"a": "bfloat16", "b/0": "float32", "b/1": "int32"}
    like = {"a": torch.zeros((7, 5), dtype=torch.bfloat16),
            "b": [torch.zeros((3,)), torch.tensor(0, dtype=torch.int32)]}
    restore_checkpoint(str(tmp_path), 1, like)
    assert torch.equal(like["a"].view(torch.int16), tree["a"].view(torch.int16))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(like), tree_leaves(tree)))


def test_three_train_steps_match_the_reference():
    cfg = get_arch("qwen3-4b").smoke_cfg()
    tcfg = convert.lm_config_from_reference(cfg)
    jstate = JS.init_train_state(jinit_params(JT.lm_param_specs(cfg), jax.random.PRNGKey(0)))
    state = convert.train_state_from_reference(jstate, tcfg, "cpu")
    kw = dict(warmup=2, total_steps=10, grad_accum=2)
    jstep = JS.make_train_step(lambda p, b: JT.loss_fn(p, b, cfg), donate=False, **kw)
    step = make_train_step(lambda p, b: T.loss_fn(p, b, tcfg), **kw)
    for i in range(3):
        batch = token_batch(i, 4, 32, cfg.vocab)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert int(state.step) == int(jstate.step) == i + 1
        assert int(m["skipped"]) == int(jm["skipped"]) == 0
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=STEP_TOL, err_msg=k)
    got = convert.train_state_to_reference(state, tcfg)
    assert int(got["opt_state"]["count"]) == int(jstate.opt_state["count"]) == 3
    want = {"params": jstate.params, "opt_state": jstate.opt_state}
    for a, b in zip(tree_leaves({k: got[k] for k in want}), jax.tree.leaves(want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=STEP_TOL * max(np.abs(b).max(), 1e-12))
