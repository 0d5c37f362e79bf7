"""The port's MoE FFN (`repro_torch.models.moe`) against the reference's
single-device path (`repro.models.moe.moe_ffn`), on the CPU.

Parameters are the reference's `init_params` from a JAX key, carried across
with `repro_torch.convert`; tokens are numpy draws from a seed. The routing
state (top-k indices, ranks, keep masks, destination rows and slots) must
be bit-equal to the reference's, which `ref_routing` computes step by step
as `moe_ffn` does (`src/repro/models/moe.py:97-113`) with the reference's
own `_rank_within`. Outputs agree within TOL = 2e-4 absolute and relative
in float32 (the packages differ only in the order of float32 sums;
measured up to 8e-6), and in bfloat16 within BF16_TOL = 2^-5 x max
|output|, four bf16 ulps of the largest output (measured up to two,
0.0097 x max |output|: a product's last bit, or silu rounded once in the
port and per op in XLA, moves a bf16 output by an ulp). The aux loss
agrees within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.param import init_params as jinit_params
from repro_torch import convert
from repro_torch.models import moe as M
from repro_torch.models.param import tree_map
from repro_torch.models.transformer import Transformer

TOL = 2e-4
BF16_TOL = 2.0 ** -5
AUX_TOL = 1e-6

# name: (n_experts, padded, top_k, d_ff_shared, capacity_factor, capacity, dtype, drops)
CASES = {
    "f32 drop-free, shared": (4, 4, 2, 48, 8.0, None, "float32", False),
    "f32 cf 1.0": (4, 4, 2, 0, 1.0, None, "float32", True),
    "f32 capacity 8, shared": (4, 4, 2, 48, 1.25, 8, "float32", True),
    "f32 padded 3 -> 4, shared": (3, 4, 2, 48, 1.0, None, "float32", None),
    "f32 padded 3 -> 4, capacity 16": (3, 4, 2, 0, 1.25, 16, "float32", True),
    "f32 top-4 of 8": (8, 8, 4, 0, 1.25, None, "float32", None),
    "bf16 drop-free, shared": (4, 4, 2, 48, 8.0, None, "bfloat16", False),
    "bf16 cf 1.0, shared": (4, 4, 2, 48, 1.0, None, "bfloat16", True),
    "bf16 capacity 8": (4, 4, 2, 0, 1.25, 8, "bfloat16", True),
    "bf16 padded 3 -> 4, shared": (3, 4, 2, 48, 1.25, None, "bfloat16", None),
}
D_MODEL, D_FF, T = 16, 32, 64


def port_cfg(cfg: JM.MoEConfig) -> M.MoEConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}
    return M.MoEConfig(**kw, dtype=getattr(torch, np.dtype(cfg.dtype).name))


def port_params(params) -> dict:
    return tree_map(lambda a: convert.tensor(a, "cpu"), params)


def ref_routing(params, x, cfg: JM.MoEConfig, capacity=None) -> dict:
    """The reference's routing state, its `moe_ffn` steps 1-2 as written."""
    n_tok = x.shape[0]
    E, Ep, k = cfg.n_experts, cfg.n_experts_padded, cfg.top_k
    if capacity is None:
        capacity = int(np.ceil(n_tok * k / E * cfg.capacity_factor))
        capacity = max(8, -(-capacity // 8) * 8)
    probs = jax.nn.softmax(x.astype(jnp.float32) @ params["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    flat_e = idx.reshape(-1).astype(jnp.int32)
    rank = JM._rank_within(flat_e, E)
    keep = rank < capacity
    return dict(idx=np.asarray(idx), rank=np.asarray(rank), keep=np.asarray(keep),
                dest_e=np.asarray(jnp.where(keep, flat_e, Ep)),
                dest_c=np.asarray(jnp.where(keep, rank, 0)), capacity=capacity)


def assert_routing_equal(r: M.Routing, ref: dict) -> None:
    assert r.capacity == ref["capacity"]
    for name in ("idx", "rank", "keep", "dest_e", "dest_c"):
        np.testing.assert_array_equal(getattr(r, name).numpy(), ref[name], err_msg=name)


def close(a, b, dtype, what=""):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=what)
    else:
        err = np.abs(a - b).max()
        assert err <= BF16_TOL * np.abs(b).max(), (what, err, np.abs(b).max())


def _case(name):
    E, Ep, k, fs, cf, capacity, dtype, drops = CASES[name]
    cfg = JM.MoEConfig(d_model=D_MODEL, n_experts=E, n_experts_padded=Ep, top_k=k,
                       d_ff_expert=D_FF, d_ff_shared=fs, capacity_factor=cf,
                       dtype=getattr(jnp, dtype))
    params = jinit_params(JM.moe_param_specs(cfg), jax.random.PRNGKey(1))
    x = np.random.default_rng(0).standard_normal((T, D_MODEL)).astype(np.float32)
    return cfg, params, x, capacity, dtype, drops


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_equals_the_reference(name):
    cfg, params, x, capacity, dtype, drops = _case(name)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jout, jaux = JM.moe_ffn(params, jx, cfg, capacity=capacity)
    tcfg, tp = port_cfg(cfg), port_params(params)
    tx = convert.tensor(jx, "cpu")
    out, aux = M.moe_ffn(tp, tx, tcfg, capacity=capacity)
    r = M.route(tp["router"], tx, tcfg, capacity)
    assert_routing_equal(r, ref_routing(params, jx, cfg, capacity))
    if drops is not None:  # the case drops what its name says
        assert bool((~r.keep).any()) == drops
    assert out.dtype == tx.dtype and out.shape == tx.shape
    close(out, jout, dtype, "out")
    assert abs(float(aux) - float(jaux)) <= AUX_TOL
    # the module holds the same tree under the reference's names
    mod = M.MoE(tp, tcfg)
    names = {n for n, _ in mod.named_parameters()}
    want = {"router", "w_gate", "w_up", "w_down"} | \
        ({"shared.w_gate", "shared.w_up", "shared.w_down"} if cfg.d_ff_shared else set())
    assert names == want
    assert all(not p.requires_grad for p in mod.parameters())
    m_out, m_routing = mod(tx)
    d_out, d_aux = M.moe_ffn(tp, tx, tcfg)
    assert torch.equal(m_out, d_out) and torch.equal(M.aux_loss(m_routing), d_aux)


def test_top_k_ties_go_to_the_lower_index():
    """Forced ties: duplicated router columns give equal probabilities, and
    logits 95 or 300 below the top give probabilities that underflow (95:
    subnormal in PyTorch, flushed to 0 by XLA; 300: 0 in both). Each tie
    must go to the lower expert index, as jax.lax.top_k puts it."""
    E, k, d = 8, 4, 8
    cfg = JM.MoEConfig(d_model=d, n_experts=E, n_experts_padded=E, top_k=k, d_ff_expert=8,
                       capacity_factor=8.0, dtype=jnp.float32)
    params = jinit_params(JM.moe_param_specs(cfg), jax.random.PRNGKey(2))
    router = np.zeros((d, E), np.float32)
    router[0] = [0, -95, -300, -95, 0, -300, -95, -95]  # ties at 1 / 2 and at 0
    router[1] = [-300, -95, 3, 3, -95, 3, -95, -300]  # equal columns 2, 3, 5
    router[2] = [5, 5, 5, 5, 5, 5, 5, 5]  # all equal
    router[3] = [-95, -95, -95, -95, -95, 0, -95, -95]  # one finite, seven subnormal
    x = np.zeros((5, d), np.float32)
    for i in range(4):
        x[i, i] = 1.0
    x[4, 1] = x[4, 3] = 1.0  # 5 wins; 2 and 3 tie at a subnormal, flushed to 0
    params = {**params, "router": jnp.asarray(router)}
    ref = ref_routing(params, jnp.asarray(x), cfg)
    tcfg, tp = port_cfg(cfg), port_params(params)
    r = M.route(tp["router"], torch.from_numpy(x), tcfg)
    with torch.no_grad():  # the subnormals PyTorch would have kept
        raw = torch.softmax(torch.from_numpy(x) @ tp["router"], -1)
    assert bool(((raw > 0) & (raw < M.FLT_MIN)).any())
    assert_routing_equal(r, ref)
    np.testing.assert_array_equal(r.idx.numpy(), [[0, 4, 1, 2], [2, 3, 5, 0], [0, 1, 2, 3],
                                                  [5, 0, 1, 2], [5, 0, 1, 2]])
    out, aux = M.moe_ffn(tp, torch.from_numpy(x), tcfg)
    jout, jaux = JM.moe_ffn(params, jnp.asarray(x), cfg)
    close(out, jout, "float32", "out")
    assert abs(float(aux) - float(jaux)) <= AUX_TOL


@pytest.mark.parametrize("n_tok,k,E,cf", [(2048, 4, 60, 1.25), (16384, 4, 60, 1.25),
                                          (16384, 4, 16, 1.25), (256, 4, 60, 1.25),
                                          (4, 4, 60, 1.25), (64, 2, 4, 1.0),
                                          (100, 2, 3, 1.3), (16384, 4, 60, 15.0)])
def test_capacity_rule(n_tok, k, E, cf):
    cfg = M.MoEConfig(d_model=8, n_experts=E, n_experts_padded=E, top_k=k, d_ff_expert=8,
                      capacity_factor=cf)
    want = int(np.ceil(n_tok * k / E * cf))
    assert M.expert_capacity(n_tok, cfg) == max(8, -(-want // 8) * 8)
    assert M.expert_capacity(2048, dataclasses.replace(cfg, n_experts=60, top_k=4,
                                                       capacity_factor=1.25)) == 176


class _Ops(TorchDispatchMode):
    """Every aten op called, with whether an index argument was boolean."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = [a for a in args if isinstance(a, (list, tuple))]
        bool_index = any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                         for lst in flat for t in lst)
        self.calls.append((func.__name__, bool_index))
        return func(*args, **kwargs)


def test_dispatch_makes_no_host_sync_op():
    """The path has no nonzero, masked select, boolean-mask index or item:
    dropped assignments go to the dump row (each such op would be a host
    sync a layer on the card)."""
    cfg, params, x, capacity, dtype, _ = _case("f32 cf 1.0")
    tcfg, tp = port_cfg(cfg), port_params(params)
    with _Ops() as ops:
        M.moe_ffn(tp, torch.from_numpy(x), tcfg)
    names = [n for n, _ in ops.calls]
    assert not any(n.split(".")[0] in ("nonzero", "masked_select", "_local_scalar_dense",
                                       "item") for n in names), names
    assert not any(b for _, b in ops.calls)
    assert any(n.startswith("bmm") for n in names)


def _lm(name, **replace):
    cfg = dataclasses.replace(get_arch(name).smoke_cfg(), **replace)
    params = jinit_params(JT.lm_param_specs(cfg), jax.random.PRNGKey(0))
    tcfg = convert.lm_config_from_reference(cfg)
    return cfg, params, Transformer(tcfg, convert.lm_params_from_reference(params, tcfg, "cpu"),
                                    device="cpu")


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "dbrx-132b"])
def test_capacity_ranks_favour_earlier_rows(name):
    """Tokens flatten row-major before dispatch: at capacity_factor 1.0 the
    smoke LM drops, its forward still equals the reference's, and row 0's
    logits do not depend on row 1 (it ranks first for every expert), while
    row 1's do depend on row 0."""
    cfg, params, model = _lm(name, capacity_factor=1.0)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 24), dtype=np.int32)
    other = toks.copy()
    other[1] = rng.integers(0, cfg.vocab, 24)
    jl, jaux = JT.forward(params, jnp.asarray(toks), cfg)
    tl, taux = model.forward(torch.from_numpy(toks))
    close(tl, jl, "float32", "forward logits")
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    routes = []
    orig = M.route
    try:
        M.route = lambda *a, **kw: routes.append(orig(*a, **kw)) or routes[-1]
        model.forward(torch.from_numpy(toks))
    finally:
        M.route = orig
    assert any(bool((~r.keep).any()) for r in routes), "no assignment dropped"
    t2, _ = model.forward(torch.from_numpy(other))
    np.testing.assert_allclose(t2[0].numpy(), tl[0].numpy(), atol=TOL, rtol=TOL)
    first = toks.copy()
    first[0] = other[1]
    t3, _ = model.forward(torch.from_numpy(first))
    assert not np.allclose(t3[1].numpy(), tl[1].numpy(), atol=TOL, rtol=TOL)
