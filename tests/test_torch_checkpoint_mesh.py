"""A sharded training state's checkpoint (`checkpoint/checkpointer.py` with a
mesh and specs): saved on one mesh, restored on another and on one device,
the counterpart of the reference's `restore_checkpoint(..., shardings=)`
(tests/test_trainer_checkpoint.py `test_elastic_restore_with_shardings`).

Four gloo ranks on the CPU train the Qwen3-4B smoke config two steps at
(data, model) (2, 2) under `LM_TRAIN_RULES` and save the state: every rank
gathers each leaf whole, rank 0 writes. The same ranks then restore it at
(1, 4) into a state of zeros. Here, on one device, the checkpoint restores
whole. Held bit for bit: each rank's (2, 2) shards and its (1, 4) shards
are its blocks of the whole leaves; the manifest holds the keys, shapes
and dtypes a one-device save of the same state writes, so a world of one
restores it as its own.
"""

import json
import os

import numpy as np
import pytest
import torch

import _sharded_cases as C
import _torch_dist as D
import _torch_sharded as S
from _torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from repro_torch.checkpoint.checkpointer import restore_checkpoint, save_checkpoint
from repro_torch.configs.base import LM_TRAIN_RULES, merged_rules
from repro_torch.distributed.mesh_utils import LogicalRules
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.param import tree_map
from repro_torch.models.transformer import lm_local_pspecs
from repro_torch.train.train_step import init_train_state

TIMEOUT_S = 300
NAME = C.LM_CKPT_CASE


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(the checkpoint's directory, [rank 0's, ...] of the ranks)."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    ranks = D.spawn(S.lm_checkpoint_all, C.WORLD, str(tmp_path_factory.mktemp("gloo")), ckpt,
                    timeout=TIMEOUT_S)
    return ckpt, ranks


def _whole(ckpt):
    """The checkpoint restored on one device: {"p/...", "m/...", "v/...":
    numpy}, the step and the state."""
    cfg, tree, _, _ = S.lm_case(NAME)
    like = init_train_state(tree_map(torch.zeros_like, tree))
    state, step = restore_checkpoint(ckpt, None, like)
    out = {}
    for part, t in (("p", state.params), ("m", state.opt_state["m"]),
                    ("v", state.opt_state["v"])):
        out.update({f"{part}/{k}": v.detach().numpy() for k, v in C.flatten(t).items()})
    return out, step, state


def _specs(shape):
    cfg, _, _, _ = S.lm_case(NAME)
    lr = LogicalRules(MeshShape(C.AXES, shape), merged_rules(LM_TRAIN_RULES))
    return C.flatten_specs(lm_local_pspecs(cfg, lr))


@pytest.mark.parametrize("mesh,which", [((2, 2), "saved"), ((1, 4), "restored")])
def test_shards_are_blocks_of_the_saved_leaves(saved, mesh, which):
    ckpt, ranks = saved
    whole, step, _ = _whole(ckpt)
    assert step == C.LM_STEPS and all(r["step"] == C.LM_STEPS for r in ranks)
    specs = _specs(mesh)
    for r, got in enumerate(ranks):
        got = got[which]
        keys = [k for k in got if k[:2] in ("p/", "m/", "v/")]
        assert sorted(keys) == sorted(whole), set(keys) ^ set(whole)
        for k in keys:
            want = C.block(whole[k], specs[k.split("/", 1)[1]], r, mesh)
            np.testing.assert_array_equal(got[k], want, err_msg=f"rank {r} {which} {k}")


def test_restored_counters(saved):
    ckpt, ranks = saved
    _, _, state = _whole(ckpt)
    for r in ranks:
        assert int(r["restored"]["step"]) == C.LM_STEPS
        assert int(r["restored"]["count"]) == C.LM_STEPS
    assert int(state.step) == C.LM_STEPS and int(state.opt_state["count"]) == C.LM_STEPS


def test_manifest_is_one_devices(saved, tmp_path):
    """The sharded save's manifest lists what a one-device save of the same
    state lists (keys, files, shapes, dtypes, step), and its leaves
    restore a one-device state bit for bit once more."""
    ckpt, _ = saved
    _, step, state = _whole(ckpt)
    one = str(tmp_path / "one")
    save_checkpoint(one, step, state)
    read = lambda d: json.load(open(os.path.join(d, f"step_{step:08d}", "manifest.json")))
    assert read(ckpt) == read(one)
    again, _, _ = _whole(one)
    whole, _, _ = _whole(ckpt)
    for k, v in whole.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
