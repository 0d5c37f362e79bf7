"""The port's expert-parallel MoE (`repro_torch.models.moe.moe_ffn` under a
mesh with a "model" axis: `moe_ffn_expert_parallel`) in 4 gloo ranks on the
CPU, against the reference's shard_map path (`_moe_ffn_shard_map`) on 4
host devices, and against the port's single-device `moe_ffn`.

tests/test_moe_distributed.py's config (d 16, 6 experts padded to 8,
top-2, d_ff 32, a shared expert of 24, float32) at meshes (data, model) of
(2, 2) and (1, 4), in both regimes: 16 tokens (T_loc k <= 64, the
weight-stationary regime) and 256 (FSDP weight gathers). The loss is
sum(out * W) + 0.3 aux with a random W, so every output's cotangent
differs. Each rank's output rows, its aux loss and the gradient of every
leaf it holds (its shard of the router, the experts and the shared expert,
and its tokens) agree with the reference's within 1e-5 of the leaf's max
(at least 1e-5). Drop-free cases agree likewise with the single-device
path, whose ranking is the same (where the data axis splits the tokens,
the aux loss is a mean of per-shard losses, so the router's and the
tokens' gradients are held to the reference only); the cases with drops
(capacity 2 or 24 a data shard) only with the reference, since a data
shard ranks its own tokens. Last, the qwen2-moe smoke LM at (1, 4) through the `MoE` module:
prefill logits, loss and every gradient against one device.
"""

import numpy as np
import pytest
import torch

import _sharded_cases as C
import _torch_dist as D
import _torch_sharded as S
from _torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from repro_torch.models.moe import MoEConfig, moe_ffn, moe_shard_specs, route

TOL = 1e-5
TIMEOUT_S = 300
LEAVES = tuple(C.MOE_SHAPES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, [rank 0's, rank 1's, ...] of the port)."""
    finish = C.start_reference(["moe"], tmp_path_factory.mktemp("moe_ref"))
    port = D.spawn(S.moe_all, C.WORLD, str(tmp_path_factory.mktemp("gloo")), timeout=TIMEOUT_S)
    return finish()["moe"], port


def _spec(specs: dict, leaf: str):
    return specs["shared"][leaf.split("/")[1]] if leaf.startswith("shared/") else specs[leaf]


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=what)


def _cfg(case) -> MoEConfig:
    return MoEConfig(**dict(C.MOE, capacity_factor=C.MOE_CASES[case][3]), dtype=torch.float32)


def _single_device(case):
    """The port's single-device `moe_ffn` over all T tokens: (out, aux,
    {leaf: gradient}, dx), the same loss."""
    _, _, cap, _ = C.MOE_CASES[case]
    flat, x, w = C.moe_inputs(case)
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in flat.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe_ffn(C.unflatten(leaves, S.MOE_TREE), xt, _cfg(case), capacity=cap)
    (torch.sum(out * torch.from_numpy(w)) + C.AUX_WEIGHT * aux).backward()
    return out.detach().numpy(), aux.item(), {k: v.grad.numpy() for k, v in leaves.items()}, \
        xt.grad.numpy()


@pytest.mark.parametrize("case", list(C.MOE_CASES))
def test_expert_parallel_matches_reference(runs, case):
    ref, port = runs
    shape = C.MOE_CASES[case][0]
    specs = moe_shard_specs(_cfg(case), dict(zip(C.AXES, shape)))
    for r, got in enumerate(port):
        got = got[case]
        _close(got["out"], C.block(ref[f"{case}/out"], ("data", None), r, shape),
               f"{case} rank {r}: out")
        _close(got["aux"], ref[f"{case}/aux"], f"{case} rank {r}: aux")
        _close(got["grad/x"], C.block(ref[f"{case}/grad/x"], ("data", None), r, shape),
               f"{case} rank {r}: d x")
        for leaf in LEAVES:
            _close(got[f"grad/{leaf}"],
                   C.block(ref[f"{case}/grad/{leaf}"], _spec(specs, leaf), r, shape),
                   f"{case} rank {r}: d {leaf}")


@pytest.mark.parametrize("case", C.DROP_FREE)
def test_expert_parallel_matches_single_device(runs, case):
    _, port = runs
    shape = C.MOE_CASES[case][0]
    specs = moe_shard_specs(_cfg(case), dict(zip(C.AXES, shape)))
    out, aux, grads, dx = _single_device(case)
    for r, got in enumerate(port):
        got = got[case]
        _close(got["out"], C.block(out, ("data", None), r, shape), f"{case} rank {r}: out")
        if shape[0] == 1:  # one data shard: the same tokens, the same aux
            _close(got["aux"], aux, f"{case} rank {r}: aux")
            _close(got["grad/x"], dx, f"{case} rank {r}: d x")
        for leaf in LEAVES:
            if leaf == "router" and shape[0] > 1:
                continue  # the aux loss is a mean of per-shard losses: one device's differs
            _close(got[f"grad/{leaf}"], C.block(grads[leaf], _spec(specs, leaf), r, shape),
                   f"{case} rank {r}: d {leaf}")


@pytest.mark.parametrize("case", ["drops-ws-2x2", "drops-gather-2x2"])
def test_drop_cases_drop(case):
    """The capacities of the drop cases do drop assignments (the ranks a data
    shard computes, or all tokens' in the weight-stationary regime)."""
    shape, T, cap, _ = C.MOE_CASES[case]
    flat, x, _ = C.moe_inputs(case)
    router, xt = torch.from_numpy(flat["router"]), torch.from_numpy(x)
    k = C.MOE["top_k"]
    if (T // shape[0]) * k <= 64:
        dropped = int((~route(router, xt, _cfg(case), cap * shape[0]).keep).sum())
    else:
        dropped = sum(int((~route(router, part, _cfg(case), cap).keep).sum())
                      for part in xt.chunk(shape[0]))
    assert dropped > 0


def test_lm_under_expert_parallelism_matches_one_device(runs):
    """The qwen2-moe smoke LM at (1, 4): each rank's prefill logits, loss and
    gradients (its shards of the MoE leaves, every other leaf whole) equal
    one device's."""
    from repro_torch.models.param import tree_map
    from repro_torch.models.transformer import Transformer, loss_fn

    _, port = runs
    cfg, tree, tokens, labels = S.moe_lm_inputs()
    params = tree_map(lambda a: torch.nn.Parameter(a.clone()), tree)
    with torch.no_grad():
        last, _ = Transformer(cfg, params, device="cpu").prefill_forward(tokens)
    loss, parts = loss_fn(params, {"tokens": tokens, "labels": labels}, cfg)
    loss.backward()
    specs = moe_shard_specs(cfg.moe_cfg(), {"data": 1, "model": 4})
    grads = C.flatten(tree_map(lambda p: p.grad.numpy(), params))
    for r, got in enumerate(port):
        got = got["lm"]
        _close(got["last"], last.numpy(), f"rank {r}: prefill logits")
        _close(got["loss"], loss.item(), f"rank {r}: loss")
        _close(got["aux"], parts["aux"].item(), f"rank {r}: aux")
        for path, g in grads.items():
            parts_ = path.split("/")
            spec = None
            if parts_[0] == "layers" and parts_[2] == "ffn":
                spec = _spec(specs, "/".join(parts_[3:]))
            want = g if spec is None else C.block(g, spec, r, (1, 4))
            _close(got[f"grad/{path}"], want, f"rank {r}: d {path}")
