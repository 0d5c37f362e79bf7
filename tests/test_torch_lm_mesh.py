"""The LM step on a mesh: the port's per-rank training step and prefill
(`models/transformer.py` `MeshLayout`, `loss_fn` and `prefill_forward` with
a layout; `train/train_step.py` `make_train_step` with a mesh and specs) in
4 gloo ranks on the CPU, against the reference.

The smoke configs of Qwen3-4B (qk-norm), Gemma2-27B (local / global
layers, both softcaps, post-norms, embedding scale) and Qwen2.5-14B (qkv
bias) in float32, under `LM_TRAIN_RULES` on meshes (data, model) (2, 2)
and (1, 4) and (pod, data, model) (2, 1, 2); Qwen3-4B once more with its
loss head in 3 chunks; qwen2-moe's smoke config at (2, 2), its FFN
`moe_ffn_expert_parallel` inside the step. At (1, 4) the smoke configs'
2 kv heads are fewer than the 4 model ranks: each rank reads the one kv
head its q head needs; with 12 q and 6 kv heads a rank's 3 q heads span
two groups and its kv heads repeat; with d_ff 130 the FFN stays whole
along "model". Parameters and the batch are drawn with numpy
(`_sharded_cases.py`), the same on both sides.

Against the reference's unsharded step (`jax.value_and_grad` of its
`loss_fn`, then its train step at warmup 1, twice, then its
`prefill_forward`), each rank's block of: the loss (relative) and every
leaf's gradient within GRAD_TOL of the leaf's max; each step's loss and
grad norm (relative, GRAD_TOL); m and v after the two steps within
GRAD_TOL of the leaf's max; the parameters within PARAM_TOL of the
leaf's max (an Adam step moves a parameter by lr times m / sqrt(v), which
a gradient near 0 turns by rounding: the first steps are the least
conditioned); the prefill's last logits (its vocab block) within
GRAD_TOL of their max. The largest readings against the reference's
unsharded step were 3.6e-6 (gradients, m), 7.2e-6 (v), 2.5e-6 (logits)
and 8.8e-5 (parameters: Qwen2.5-14B's embedding); port against port,
sharded against one device, 2.4e-6 and 4.4e-5.

Against the reference's own sharded step (`_sharded_ref.py lm`: jitted on
4 host devices at (2, 2) with `bind_rules` and `NamedSharding`s, as its
dry run binds it): each rank's shards of the parameters, m and v equal to
the device's `addressable_shards` within the same tolerances (largest
readings 2.2e-6 m, 3.3e-6 v, 8.8e-6 parameters).
"""

import dataclasses

import numpy as np
import pytest
import torch

import _sharded_cases as C
import _torch_dist as D
import _torch_sharded as S
from _torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)

GRAD_TOL = 1e-5
PARAM_TOL = 3e-4
TIMEOUT_S = 300


def _unsharded(ref: dict, name: str) -> dict:
    """The reference's unsharded values of case `name`, as the port's tree:
    {"loss", "grad/...", "step{i}/loss", "step{i}/grad_norm", "p/...",
    "m/...", "v/...", "last"} (its stacked layer leaves split a layer)."""
    cfg, _, _, _ = S.lm_case(name)
    G, pre = cfg.group_size, C.lm_variant(name) + "/"
    out = {}
    for key, v in ref.items():
        if not key.startswith(pre):
            continue
        key = key[len(pre):]
        parts = key.split("/")
        if len(parts) > 2 and parts[1] == "layers":
            tag, i, rest = parts[0], int(parts[2]), "/".join(parts[3:])
            for g in range(cfg.n_groups):
                out[f"{tag}/layers/{g * G + i}/{rest}"] = v[g]
        else:
            out[key] = v
    assert out, name
    return out


def _specs(name: str) -> dict:
    """{port path: spec} of case `name`'s leaves, and "last": its logits'."""
    from repro_torch.configs.base import LM_TRAIN_RULES, merged_rules
    from repro_torch.distributed.mesh_utils import LogicalRules, resolve_pspec
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.transformer import lm_local_pspecs

    cfg, _, _, _ = S.lm_case(name)
    _, shape, axes, _ = C.LM_CASES[name]
    lr = LogicalRules(MeshShape(axes, shape), merged_rules(LM_TRAIN_RULES))
    out = C.flatten_specs(lm_local_pspecs(cfg, lr))
    out["last"] = (resolve_pspec(("batch", None), (C.LM_BATCH, 1), lr)[0], out["unembed"][1])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's sharded step's shards, {case: its unsharded
    values}, [rank 0's, rank 1's, ...] of the port)."""
    whats = ["lm"] + [f"lm-unsharded:{i}" for i in range(C.LM_REF_PROCS)]
    finish = C.start_reference(whats, tmp_path_factory.mktemp("lm_ref"))
    port = D.spawn(S.lm_mesh_all, C.WORLD, str(tmp_path_factory.mktemp("gloo")),
                   timeout=TIMEOUT_S)
    ref = finish()
    merged = {k: v for w in whats[1:] for k, v in ref[w].items()}
    return ref["lm"], {name: _unsharded(merged, name) for name in C.LM_CASES}, port


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of the max (tol {tol})"


@pytest.mark.parametrize("name", list(C.LM_CASES))
def test_mesh_step_matches_reference_unsharded(runs, name):
    _, unsharded, port = runs
    want, specs = unsharded[name], _specs(name)
    _, shape, axes, _ = C.LM_CASES[name]
    for r, got in enumerate(port):
        got = got[name]
        for key, w in want.items():
            kind, _, path = key.partition("/")
            spec = specs.get(path or key, ())
            tol = PARAM_TOL if kind == "p" else GRAD_TOL
            _close(got[key], C.block(w, spec, r, shape, axes), tol, f"{name} rank {r} {key}")
        assert set(got) == set(want) | {"aux"}, set(got) ^ set(want)


def test_mesh_step_matches_reference_sharded_step(runs):
    """Each rank's shards after the two steps against the device's
    `addressable_shards` of the reference's step jitted on (2, 2)."""
    ref, _, port = runs
    name = C.LM_REF_SHARDED_CASE
    cfg, _, _, _ = S.lm_case(name)
    G = cfg.group_size
    for r, got in enumerate(port):
        got = got[name]
        for i in range(C.LM_STEPS):
            for k in ("loss", "grad_norm"):
                _close(got[f"step{i}/{k}"], ref[f"step{i}/{k}"], GRAD_TOL, f"rank {r} step {i} {k}")
        n = 0
        for key, g in got.items():
            kind, _, path = key.partition("/")
            if kind not in ("p", "m", "v"):
                continue
            parts = path.split("/")
            if parts[0] == "layers":  # the reference stacks layer li as [li // G] of li % G
                li = int(parts[1])
                want = ref[f"{kind}/layers/{li % G}/{'/'.join(parts[2:])}/{r}"][li // G]
            else:
                want = ref[f"{kind}/{path}/{r}"]
            assert want.shape == g.shape, (key, want.shape, g.shape)
            _close(g, want, PARAM_TOL if kind == "p" else GRAD_TOL, f"rank {r} {key}")
            n += 1
        assert n == 3 * len([k for k in got if k.startswith("p/")])


@pytest.mark.parametrize("arch,heads,kv_heads,n_model,want", [
    # (H, Hk, n): each rank's q heads, then the kv heads they read
    ("qwen3-4b", 4, 2, 4, [(0, 1, [0]), (1, 1, [0]), (2, 1, [1]), (3, 1, [1])]),
    ("qwen3-4b", 4, 2, 2, [(0, 2, [0]), (2, 2, [1])]),
    ("qwen3-4b", 32, 8, 16, [(2 * m, 2, [m // 2]) for m in range(16)]),
    ("qwen3-4b", 12, 2, 4, [(3 * m, 3, [m // 2]) for m in range(4)]),
    ("qwen3-4b", 12, 6, 4, [(0, 3, [0, 0, 1]), (3, 3, [1, 2, 2]), (6, 3, [3, 3, 4]),
                            (9, 3, [4, 5, 5])]),
])
def test_kv_heads_a_rank_reads(arch, heads, kv_heads, n_model, want):
    """The kv heads are the slice a rank's q heads read: whole groups, one
    head shared by several ranks (Qwen3-4B's 32 / 8 heads at 16: two q
    heads a rank, half a group), or one a q head where neither divides
    (the case `qwen3-4b/1x4-12x6-heads` runs end to end)."""
    from types import SimpleNamespace

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import _head_plan

    cfg = dataclasses.replace(get_arch(arch).smoke_cfg(), n_heads=heads, n_kv_heads=kv_heads)
    got = [_head_plan(cfg, SimpleNamespace(m=m, n_model=n_model), True)
           for m in range(n_model)]
    assert [(h0, n, kv) for h0, n, kv in got] == want
