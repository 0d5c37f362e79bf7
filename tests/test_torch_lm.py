"""The port's LM against the reference's, on the CPU.

For the smoke configs of qwen3-4b, qwen2.5-14b, gemma2-27b and the MoE LMs
qwen2-moe-a2.7b and dbrx-132b (drop-free at capacity_factor 8), the
reference's parameters (`init_params` from a JAX key) are carried across
with `repro_torch.convert` and the same token batches go through both
packages: `forward` logits, `prefill_forward`'s last logits and KV stack,
and teacher-forced `serve_step`s must agree, and `forward`'s aux (the
MoE load-balance loss summed over layers) within AUX_TOL. All in float32, within
TOL = 2e-4 absolute and relative: a tenth of the reference's own 2e-3
between its prefill and decode paths (`tests/test_models_lm.py`); the two
packages differ only in the order of float32 sums (measured up to 8e-5 on
the KV stack).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.data.tokens import token_batch as jtoken_batch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.param import init_params as jinit_params
from repro.models.param import param_bytes as jparam_bytes
from repro.models.param import param_count as jparam_count
from repro_torch import convert
from repro_torch.configs import dbrx_132b, gemma2_27b, qwen2_5_14b, qwen2_moe_a2_7b, qwen3_4b
from repro_torch.data.tokens import token_batch
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, init_params, param_bytes, param_count, \
    tree_leaves
from repro_torch.models.transformer import Transformer, lm_param_specs

TOL = 2e-4
AUX_TOL = 1e-6
CONFIGS = {"qwen3-4b": qwen3_4b, "qwen2.5-14b": qwen2_5_14b, "gemma2-27b": gemma2_27b,
           "qwen2-moe-a2.7b": qwen2_moe_a2_7b, "dbrx-132b": dbrx_132b}


def close(a, b, tol=TOL, what=""):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=what)


@pytest.fixture(scope="module", params=list(CONFIGS))
def lm(request):
    """(reference cfg, reference params, port cfg, port model) of one smoke config."""
    cfg = get_arch(request.param).smoke_cfg()
    params = jinit_params(JT.lm_param_specs(cfg), jax.random.PRNGKey(0))
    tcfg = convert.lm_config_from_reference(cfg)
    model = Transformer(tcfg, convert.lm_params_from_reference(params, tcfg, "cpu"),
                        device="cpu")
    return cfg, params, tcfg, model


def _tokens(step, B, S, vocab):
    toks = token_batch(step, B, S, vocab)["tokens"]
    return jnp.asarray(toks), torch.from_numpy(toks)


# ---------------------------------------------------------------------------
# configurations, specs, data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_configs_equal_the_reference(name):
    arch = get_arch(name)
    assert CONFIGS[name].model_cfg() == convert.lm_config_from_reference(arch.model_cfg())
    assert CONFIGS[name].smoke_cfg() == convert.lm_config_from_reference(arch.smoke_cfg())


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("size", ["model_cfg", "smoke_cfg"])
def test_param_specs_equal_the_reference(name, size):
    cfg = getattr(get_arch(name), size)()
    specs = lm_param_specs(convert.lm_config_from_reference(cfg))
    jspecs = jax.tree.leaves(JT.lm_param_specs(cfg), is_leaf=lambda x: hasattr(x, "axes"))
    for s, j in zip(tree_leaves(specs), jspecs, strict=True):
        assert (s.shape, s.axes, s.init, s.scale) == (j.shape, j.axes, j.init, j.scale)
        assert s.dtype.itemsize == np.dtype(j.dtype).itemsize
    assert param_count(specs) == jparam_count(JT.lm_param_specs(cfg))
    assert param_bytes(specs) == jparam_bytes(JT.lm_param_specs(cfg))


def test_qwen3_4b_full_width_size():
    specs = lm_param_specs(qwen3_4b.model_cfg())
    assert param_count(specs) == 4_411_424_256  # ~4.41 B, 8.8 GB in bf16


@pytest.mark.parametrize("name,n_layers,count", [
    ("qwen2-moe-a2.7b", 24, 15_146_207_232),  # 30.30 GB in bf16: whole on one card
    ("dbrx-132b", 40, 131_596_523_520),
    ("dbrx-132b", 4, 14_269_470_720),  # the card's cut: 28.54 GB in bf16
])
def test_moe_full_width_sizes(name, n_layers, count):
    cfg = dataclasses.replace(CONFIGS[name].model_cfg(), n_layers=n_layers)
    assert param_count(lm_param_specs(cfg)) == count
    jcfg = dataclasses.replace(get_arch(name).model_cfg(), n_layers=n_layers)
    assert jparam_count(JT.lm_param_specs(jcfg)) == count
    assert cfg.moe_cfg().n_experts_padded == (64 if name == "qwen2-moe-a2.7b" else 16)


def test_token_batch_equals_the_reference():
    for step, seed in [(0, 0), (3, 7)]:
        a, b = token_batch(step, 4, 33, 151936, seed), jtoken_batch(step, 4, 33, 151936, seed)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype


# ---------------------------------------------------------------------------
# parameters: init rules and conversion
# ---------------------------------------------------------------------------


def test_init_params_rules():
    specs = {"w": ParamSpec((400, 300), ("a", "b"), dtype=torch.float32),
             "stacked": ParamSpec((4, 400, 300), ("stack", "a", "b"), dtype=torch.float32),
             "e": ParamSpec((500, 200), ("a", "b"), scale=1.0, dtype=torch.bfloat16),
             "z": ParamSpec((7,), ("a",), init="zeros", dtype=torch.float32),
             "o": [ParamSpec((3, 2), ("a", "b"), init="ones")]}
    g = torch.Generator().manual_seed(0)
    p = init_params(specs, g, device="cpu")
    # normal x 1/sqrt(first dim): the stacked leaf takes its fan-in from the
    # stack axis, as the reference's does
    assert abs(p["w"].std().item() * np.sqrt(400) - 1) < 0.02
    assert abs(p["stacked"].std().item() * np.sqrt(4) - 1) < 0.02
    assert p["e"].dtype == torch.bfloat16 and abs(p["e"].float().std().item() - 1) < 0.02
    assert torch.equal(p["z"], torch.zeros(7)) and torch.equal(p["o"][0], torch.ones(3, 2,
                                                                                 dtype=torch.bfloat16))
    again = init_params(specs, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(again)))


def test_transformer_draws_its_own_parameters():
    cfg = qwen3_4b.smoke_cfg()
    a = Transformer(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    b = Transformer(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    assert len(a.layers) == cfg.n_layers
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.tree()), tree_leaves(b.tree())))
    assert sum(p.numel() for p in a.parameters()) == param_count(lm_param_specs(cfg))
    logits, _ = a(_tokens(0, 2, 8, cfg.vocab)[1])
    assert logits.shape == (2, 8, cfg.vocab) and torch.isfinite(logits).all()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_parameters_round_trip_bit_exact(name):
    cfg = dataclasses.replace(get_arch(name).smoke_cfg(), dtype=jnp.bfloat16)
    params = jinit_params(JT.lm_param_specs(cfg), jax.random.PRNGKey(1))
    tcfg = convert.lm_config_from_reference(cfg)
    assert tcfg.dtype == torch.bfloat16
    ported = convert.lm_params_from_reference(params, tcfg, "cpu")
    assert ported["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    # straight back, and through the model's own tree (an MoE layer nests
    # its FFN in an `MoE` module)
    model_tree = Transformer(tcfg, ported, device="cpu").tree()
    for back in (convert.lm_params_to_reference(ported, tcfg),
                 convert.lm_params_to_reference(model_tree, tcfg)):
        flat_back = jax.tree.leaves(back)
        for orig, got in zip(jax.tree.leaves(params), flat_back, strict=True):
            orig = np.asarray(orig)
            if orig.dtype.name == "bfloat16":
                assert got.dtype == np.uint16
                np.testing.assert_array_equal(orig.view(np.uint16), got)
            else:
                np.testing.assert_array_equal(orig, got)


def test_layer_order_interleaves_the_pattern(lm):
    """Layer li is group li // G at pattern index li % G (serve_step's order)."""
    cfg, params, tcfg, model = lm
    G = tcfg.group_size
    for li, layer in enumerate(model.layers):
        assert layer.kind == tcfg.pattern[li % G]
        ref = np.asarray(params["layers"][str(li % G)]["attn"]["wq"][li // G])
        np.testing.assert_array_equal(layer.attn["wq"].numpy(), ref)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_functions_equal_the_reference(dtype):
    rng = np.random.default_rng(0)
    tol = TOL if dtype == "float32" else 2e-2
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32) * 3
    w = rng.standard_normal(16).astype(np.float32) * 0.1
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    close(L.rms_norm(tx, torch.from_numpy(w)), JL.rms_norm(jx, jnp.asarray(w)), tol, "rms_norm")
    pos = np.array([[0, 1, 2, 3, 4], [7, 9, 100, 4095, 70000]])
    close(L.rope(tx, torch.from_numpy(pos)[:, None, :], 1e6),
          JL.rope(jx, jnp.asarray(pos)[:, None, :], 1e6), tol, "rope")
    wg, wu, wd = (rng.standard_normal(s).astype(np.float32) * 0.3
                  for s in ((16, 24), (16, 24), (24, 16)))
    close(L.swiglu(tx, *(torch.from_numpy(a).to(tx.dtype) for a in (wg, wu, wd))),
          JL.swiglu(jx, *(jnp.asarray(a, jx.dtype) for a in (wg, wu, wd))), tol * 10, "swiglu")
    logits = x * 40
    close(L.softcap(torch.from_numpy(logits), 30.0), JL.softcap(jnp.asarray(logits), 30.0),
          TOL, "softcap")
    assert L.softcap(tx, None) is tx


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------


def test_forward_equals_the_reference(lm):
    cfg, params, _, model = lm
    jt, tt = _tokens(0, 2, 32, cfg.vocab)
    jl, jaux = JT.forward(params, jt, cfg)
    tl, taux = model.forward(tt)
    assert tl.dtype == torch.float32 and tl.shape == (2, 32, cfg.vocab)
    close(tl, jl, what="forward logits")
    assert taux.dtype == torch.float32 and taux.shape == ()
    if cfg.n_experts:
        assert float(jaux) > 0 and abs(float(taux) - float(jaux)) <= AUX_TOL
    else:
        assert float(taux) == float(jaux) == 0.0


def test_prefill_forward_equals_the_reference(lm):
    cfg, params, tcfg, model = lm
    jt, tt = _tokens(3, 2, 24, cfg.vocab)
    jlast, jkv = JT.prefill_forward(params, jt, cfg)
    tlast, tkv = model.prefill_forward(tt)
    close(tlast, jlast, what="last logits")
    assert set(tkv) == set(jkv) == {str(i) for i in range(tcfg.group_size)}
    for i in jkv:
        for n in ("k", "v"):
            assert tuple(tkv[i][n].shape) == (tcfg.n_groups, 2, tcfg.n_kv_heads, 24,
                                              tcfg.head_dim)
            close(tkv[i][n], jkv[i][n], what=f"kv {i}/{n}")


def test_teacher_forced_serve_steps_equal_the_reference(lm):
    cfg, params, _, model = lm
    B, S = 2, 20
    jt, tt = _tokens(2, B, S, cfg.vocab)
    jcache = JT.init_kv_cache(cfg, B, max_seq=S + 4)
    tcache = model.init_kv_cache(B, max_seq=S + 4)
    for t in range(S):
        jl, jcache = JT.serve_step(params, jcache, jt[:, t:t + 1], cfg)
        tl, tcache = model.serve_step(tcache, tt[:, t:t + 1])
        close(tl, jl, what=f"step {t} logits")
    for jc, tc in zip(jcache["layers"], tcache["layers"], strict=True):
        assert tc["pos"] == int(jc["pos"]) == S
        close(tc["k"], jc["k"], what="cache k")
        close(tc["v"], jc["v"], what="cache v")


def test_prefill_then_decode_equals_forward(lm):
    """The serving glue of chip_smoke.py: prefill S-1 tokens, copy the KV
    stack into a decode cache, decode the last token teacher-forced; its
    logits equal prefill_forward's last logits over all S tokens (the
    check the card runs at full width)."""
    cfg, params, tcfg, model = lm
    B, S = 2, 20
    _, tt = _tokens(4, B, S, cfg.vocab)
    full_last, _ = model.prefill_forward(tt)
    _, kvs = model.prefill_forward(tt[:, :-1])
    cache = model.init_kv_cache(B, max_seq=S + 3)
    G = tcfg.group_size
    for li, layer_cache in enumerate(cache["layers"]):
        for n in ("k", "v"):
            layer_cache[n][:, :, :S - 1] = kvs[str(li % G)][n][li // G]
        layer_cache["pos"] = S - 1
    step_logits, cache = model.serve_step(cache, tt[:, -1:])
    close(step_logits, full_last, what="decode vs prefill")
    jlogits, _ = JT.forward(params, jnp.asarray(tt.numpy()), cfg)
    close(step_logits, np.asarray(jlogits)[:, -1], what="decode vs reference forward")
