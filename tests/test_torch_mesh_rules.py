"""The port's logical sharding rules (`repro_torch.distributed.mesh_utils`)
against the reference's (`repro.distributed.mesh_utils`), on the CPU.

The reference's `LogicalRules` reads only `mesh.shape`, so a stand-in with
a `shape` dict resolves specs on the production meshes (16x16 and 2x16x16)
without 512 devices. Every leaf of every arch's parameters, optimizer
state, decode KV cache and batch is resolved by both packages under every
cell's merged rules, and the port's spec tuples must equal the reference's
`PartitionSpec`s entry for entry.
"""

import importlib
import types

import pytest
from jax.sharding import PartitionSpec as P

import repro.configs as rconfigs
from repro.configs import base as rbase
from repro.distributed import mesh_utils as rmu
from repro.models import param as rparam
from repro.models import transformer as rT
from repro.optim import adamw as radamw
import repro_torch.configs as configs
from repro_torch.configs import ASSIGNED, base, get_arch
from repro_torch.distributed import mesh_utils as mu
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import param
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

MESHES = {"16x16": make_production_mesh(), "2x16x16": make_production_mesh(multi_pod=True)}


def _flat(tree, path=""):
    """{path: spec tuple} of a spec tree (dicts, lists, dataclasses)."""
    if isinstance(tree, P):
        return {path: tuple(tree)}
    if isinstance(tree, tuple):
        return {path: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        items = vars(tree).items()
    return {k: v for key, sub in items for k, v in _flat(sub, f"{path}/{key}").items()}


def _both(mesh, rules):
    return (rmu.LogicalRules(types.SimpleNamespace(shape=mesh.shape), dict(rules)),
            mu.LogicalRules(mesh, dict(rules)))


def _mods(name):
    """(the reference's config module, the port's) of an arch."""
    return (importlib.import_module(rconfigs._MODULES[name]),
            importlib.import_module(configs._MODULES[name]))


def _trees(name, shape, lr, ref: bool):
    """{what: spec tree} of every leaf a cell's dry run shards, by one package."""
    mod = _mods(name)[0 if ref else 1]
    pkg_base, pkg_param, pkg_T, pkg_adamw, res = (
        (rbase, rparam, rT, radamw, rmu.resolve_pspec) if ref
        else (base, param, T, adamw, mu.resolve_pspec))
    family = mod.ARCH.family
    if family == "lm":
        cfg = mod.model_cfg()
        d = pkg_base.LM_SHAPES[shape]
        B, S = d["batch"], d["seq"]
        ps = pkg_param.param_pspecs(pkg_T.lm_param_specs(cfg), lr)
        tree = {"params": ps, "opt_state": pkg_adamw.opt_state_pspecs(ps),
                "tokens": res(("batch", "seq"), (B, S), lr),
                "decode_tokens": res(("batch", None), (B, 1), lr)}
        if d["kind"] == "decode":
            tree["kv"] = pkg_T.kv_cache_pspecs(cfg, B, S, lr)
        return tree
    if family == "gnn":
        cfg = mod.model_cfg(shape)
        d = pkg_base.GNN_SHAPES[shape]
        batch = {} if d.get("distributed") else \
            {"batch": pkg_base._gnn_batch_abstract(shape, d, True, lr)[1]}
    else:  # din
        cfg = mod.model_cfg()
        batch = {"batch": mod._batch_abstract(shape, cfg, lr)[1]}
    ps = pkg_param.param_pspecs(mod.model.param_specs(cfg), lr)
    return dict(batch, params=ps, opt_state=pkg_adamw.opt_state_pspecs(ps))


def _cases():
    for name in ASSIGNED:
        for cell in get_arch(name).cells:
            for mesh in MESHES:
                yield pytest.param(name, cell.shape, mesh, id=f"{name}-{cell.shape}-{mesh}")


@pytest.mark.parametrize("name,shape,mesh_name", list(_cases()))
def test_every_leaf_resolves_as_the_reference(name, shape, mesh_name):
    mesh = MESHES[mesh_name]
    cell = get_arch(name).cell(shape)
    r, p = _both(mesh, base.merged_rules(cell.rules))
    want, got = _flat(_trees(name, shape, r, ref=True)), _flat(_trees(name, shape, p, ref=False))
    assert want.keys() == got.keys()
    assert got == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_qwen2_5_heads_fall_back_to_replication(mesh_name):
    """qwen2.5's 40 q heads on the 16-way "model" axis: a dimension of 40
    heads does not divide, so the fallback replicates it (the reference's
    own example); the 40 x 128 = 5,120 projection columns do divide."""
    mesh = MESHES[mesh_name]
    lrs = _both(mesh, base.LM_TRAIN_RULES)
    for lr, res in ((lrs[0], rmu.resolve_pspec), (lrs[1], mu.resolve_pspec)):
        assert tuple(res(("batch", "heads", None, None), (256, 40, 4096, 128), lr)) == \
            (("pod", "data") if "pod" in mesh.shape else "data", None, None, None)
        assert tuple(res(("heads",), (40 * 128,), lr)) == ("model",)


@pytest.mark.parametrize("dims,axes", [
    ((48, 7), ("batch", "nodes")),  # 48 = 3 x 16: "pod" (2) stays, then "data"
    ((2, 512), ("batch", "nodes")),  # batch 2: only "pod" divides it
    ((96, 96), ("nodes", "edges")),  # a mesh axis appears once in a spec
    ((32, 32), ("fsdp", "batch")),  # "data" taken by fsdp: batch keeps "pod"
    ((5, 7), (None, "unknown")),  # no rule: replicated
])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_prefix_fallback_and_axis_reuse(dims, axes, mesh_name):
    mesh = MESHES[mesh_name]
    r, p = _both(mesh, rmu.DEFAULT_RULES)
    assert mu.resolve_pspec(axes, dims, p) == tuple(rmu.resolve_pspec(axes, dims, r))


def test_rules_context_and_meshes():
    """`set_mesh_rules` / `current_rules` as the reference's: a spec needs a
    rules context (without one every spec is replicated), and the port's
    meshes give their shape as a mapping."""
    assert mu.resolve_pspec(("batch",), (64,)) == ()
    with mu.set_mesh_rules(MESHES["2x16x16"]) as lr:
        assert mu.current_rules() is lr and lr.rules == mu.DEFAULT_RULES
        assert mu.resolve_pspec(("batch", "vocab"), (64, 32)) == (("pod", "data"), "model")
        assert lr.mesh_axis_size(("pod", "data")) == 32 and lr.mesh_axis_size(None) == 1
    assert mu.current_rules() is None
    assert MESHES["16x16"].shape == {"data": 16, "model": 16}
    assert MESHES["2x16x16"].size == 512 and MESHES["2x16x16"].name == "2x16x16"
    assert make_host_mesh().shape == {"data": 1, "model": 1}
    assert mu.shards((("pod", "data"), None, "model"), MESHES["2x16x16"]) == 512
    assert mu.shards((), MESHES["16x16"]) == 1
