"""The port's AdamW and learning-rate schedule against the reference's, on
the CPU.

`adamw_update` from the same parameters, gradients and state (count > 0)
through both packages: with the clip biting and not, with weight decay, on
float32 and bfloat16 parameters, for three steps; the count must be equal
and the float32 parameters, m and v within TOL (relative, plus TOL times
the leaf's largest |entry|); bf16 parameters within one bf16 ulp. Also
`global_norm`, `warmup_cosine` over its whole range, and the in-place
update's `ok` mask (False keeps every leaf and the count).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim.schedule import warmup_cosine as jwarmup_cosine
from repro_torch.models.param import tree_leaves
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm, warmup_cosine

TOL = 2e-6


def _tree(rng):
    return {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "layers": [{"a": rng.standard_normal((5,)).astype(np.float32)}],
            "b": (rng.standard_normal((3, 2)) * 0.01).astype(np.float32)}


def _torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v, dtype) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32)).to(dtype)


def _jax(tree, dtype=jnp.float32):
    if isinstance(tree, dict):
        return {k: _jax(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax(v, dtype) for v in tree]
    return jnp.asarray(tree, dtype)


def _flat(tree):
    """Every leaf as float32 numpy, dict keys sorted (both packages' order)."""
    return [np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))
            for x in tree_leaves(tree)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 100.0, None])
def test_adamw_update_matches_the_reference(dtype, clip):
    rng = np.random.default_rng(0)
    cfg = dict(lr=3e-3, weight_decay=0.1, grad_clip=clip)
    jcfg, tcfg = JA.AdamWConfig(**cfg), AdamWConfig(**cfg)
    p0 = _tree(rng)
    jp, tp = _jax(p0, getattr(jnp, dtype)), _torch(p0, getattr(torch, dtype))
    jstate, tstate = JA.adamw_init(jp), adamw_init(tp)
    for step in range(3):
        g = _tree(rng)
        lr = 1e-3 * (step + 1)
        jp, jstate, jm = JA.adamw_update(_jax(g, getattr(jnp, dtype)), jstate, jp, jcfg,
                                         lr=jnp.float32(lr))
        tp, tstate, tm = adamw_update(_torch(g, getattr(torch, dtype)), tstate, tp, tcfg,
                                      lr=torch.tensor(lr))
        assert int(tstate["count"]) == int(jstate["count"]) == step + 1
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=TOL)
        for name in ("m", "v"):
            for a, b in zip(_flat(tstate[name]), _flat(jstate[name])):
                np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL * np.abs(b).max())
        for a, b in zip(_flat(tp), _flat(jp)):
            if dtype == "float32":
                np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL * np.abs(b).max())
            else:  # one bf16 ulp: 2^-7 of the value
                np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=0)


def test_not_ok_keeps_every_leaf_and_the_count():
    rng = np.random.default_rng(1)
    p = _torch(_tree(rng))
    state = adamw_init(p)
    state["m"]["w"] += 0.5
    before = [t.clone() for t in tree_leaves(p) + tree_leaves(state["m"]) + tree_leaves(state["v"])]
    g = _torch(_tree(rng))
    adamw_update(g, state, p, AdamWConfig(), lr=torch.tensor(1e-2), ok=torch.tensor(False))
    after = tree_leaves(p) + tree_leaves(state["m"]) + tree_leaves(state["v"])
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(state["count"]) == 0


def test_global_norm_matches_the_reference():
    tree = _tree(np.random.default_rng(2))
    np.testing.assert_allclose(global_norm(_torch(tree)).item(),
                               float(JA.global_norm(_jax(tree))), rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(20, 200), (0, 10), (2, 4), (5, 5)])
def test_warmup_cosine_matches_the_reference(warmup, total):
    for step in range(0, total + 3):
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = warmup_cosine(s, 3e-4, warmup, total)
            want = float(jwarmup_cosine(jnp.int32(step), 3e-4, warmup, total))
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=0)
