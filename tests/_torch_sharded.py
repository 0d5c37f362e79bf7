"""The port's side of the sharded-path tests: workers that `_torch_dist.spawn`
runs in 4 gloo ranks on the CPU, one a test file, over the cases of
`_sharded_cases`. Spawned children import this module by name, so it
imports torch and the port only (no JAX), and its workers are module-level
functions. Each returns numpy arrays.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

import _sharded_cases as C
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.mesh import ProcessMesh, init_mesh
from repro_torch.distributed.mesh_utils import local_shard, set_mesh_rules

MOE_TREE = {"router": 0, "w_gate": 0, "w_up": 0, "w_down": 0,
            "shared": {"w_gate": 0, "w_up": 0, "w_down": 0}}


def _init(store_dir: str, name: str, rank: int, shape, axes, backend=None):
    store = dist.FileStore(os.path.join(store_dir, name), int(np.prod(shape)))
    mesh, _ = init_mesh(shape, axes, "cpu", backend=backend, store=store, rank=rank,
                        world_size=int(np.prod(shape)))
    return mesh


def _leaves(flat: dict, like) -> dict:
    """{path: numpy} -> the tree of leaf tensors that require grad."""
    return C.unflatten({k: torch.from_numpy(v).requires_grad_() for k, v in flat.items()}, like)


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------


def moe_all(rank: int, world: int, store_dir: str) -> dict:
    """Every MoE case on this rank: {case: {"out", "aux", "grad/..."}}, the
    outputs and gradients of this rank's blocks; then the LM smoke config's
    prefill and loss under expert parallelism at (1, 4)."""
    from repro_torch.models.moe import MoEConfig, moe_ffn, moe_local_params

    mesh0 = _init(store_dir, "moe", rank, (2, 2), C.AXES)
    meshes = {(2, 2): mesh0, (1, 4): ProcessMesh((1, 4), C.AXES)}
    out = {}
    for case, (shape, T, cap, factor) in C.MOE_CASES.items():
        mesh = meshes[shape]
        cfg = MoEConfig(**dict(C.MOE, capacity_factor=factor), dtype=torch.float32)
        flat, x, w = C.moe_inputs(case)
        full = C.unflatten({k: torch.from_numpy(v) for k, v in flat.items()}, MOE_TREE)
        local = {k: v.requires_grad_() for k, v in C.flatten(
            moe_local_params(full, cfg, mesh)).items()}
        params = C.unflatten(local, MOE_TREE)
        tok = (("data",), None)
        x_loc = local_shard(torch.from_numpy(x), tok, mesh).requires_grad_()
        w_loc = local_shard(torch.from_numpy(w), tok, mesh)
        with set_mesh_rules(mesh):
            o, aux = moe_ffn(params, x_loc, cfg, capacity=cap)
        (torch.sum(o * w_loc) + C.AUX_WEIGHT * aux).backward()
        res = {"out": o.detach().numpy(), "aux": aux.detach().numpy(),
               "grad/x": x_loc.grad.numpy()}
        res.update({f"grad/{k}": v.grad.numpy() for k, v in local.items()})
        out[case] = res
    out["lm"] = _moe_lm(meshes[(1, 4)])
    dist.destroy_process_group()
    return out


def moe_lm_inputs():
    """The qwen2-moe smoke config, its parameters (port tree, drawn on the
    CPU from seed 0) and a batch."""
    from repro_torch.configs import qwen2_moe_a2_7b
    from repro_torch.models.param import init_params
    from repro_torch.models.transformer import lm_param_specs, unstack_layers

    cfg = qwen2_moe_a2_7b.smoke_cfg()
    tree = unstack_layers(init_params(lm_param_specs(cfg), torch.Generator().manual_seed(0),
                                      "cpu"), cfg)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32))
    return cfg, tree, tokens, labels


def _moe_lm(mesh) -> dict:
    """The smoke LM with its MoE FFNs cut to this rank's shards, under the
    mesh's rules: the prefill's logits, the loss and every leaf's gradient
    (MoE leaves: this rank's shards)."""
    from repro_torch.models.param import tree_map
    from repro_torch.models.transformer import Transformer, expert_parallel_params, loss_fn

    cfg, tree, tokens, labels = moe_lm_inputs()
    local = tree_map(lambda a: torch.nn.Parameter(a.clone()),
                     expert_parallel_params(tree, cfg, mesh))
    with set_mesh_rules(mesh):
        with torch.no_grad():
            last, _ = Transformer(cfg, local, device="cpu").prefill_forward(tokens)
        loss, parts = loss_fn(local, {"tokens": tokens, "labels": labels}, cfg)
        loss.backward()
    res = {"last": last.numpy(), "loss": loss.detach().numpy(),
           "aux": parts["aux"].detach().numpy()}
    res.update({f"grad/{k}": v.grad.numpy() for k, v in C.flatten(local).items()})
    return res


# ---------------------------------------------------------------------------
# distributed GNN
# ---------------------------------------------------------------------------


def gnn_params(arch: str):
    """(the port's model config, the parameter tree of leaves requiring
    grad, drawn as `_sharded_ref.py` draws them)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.gnn import egnn, equiformer_v2, graphcast, pna

    mod = {"egnn": egnn, "pna": pna, "graphcast": graphcast, "equiformer-v2": equiformer_v2}[arch]
    cfg = get_arch(arch).smoke_cfg()
    specs = mod.param_specs(cfg)
    flat = C.draw_tree({k: s.shape for k, s in C.flatten(specs).items()}, 0)
    return cfg, _leaves(flat, specs)


def gnn_all(rank: int, world: int, store_dir: str) -> dict:
    """Every distributed-GNN case on this rank: the loss, every gradient,
    the gather's served masks, and (rank 0) the prepared host arrays."""
    from repro_torch.graph.csr import csr_to_edge_index
    from repro_torch.graph.generators import powerlaw_graph
    from repro_torch.models.gnn.distributed import (
        gather_served, local_dist_inputs, make_dist_gnn_loss, plan_dist_graph,
        prepare_dist_inputs,
    )

    mesh = _init(store_dir, "gnn", rank, C.GNN_MESH, C.AXES)
    g = powerlaw_graph(**C.GNN_GRAPH)
    src, dst = csr_to_edge_index(g)
    out = {}
    for name, (arch, chunk, slack) in C.GNN_CASES.items():
        cfg, params = gnn_params(arch)
        feats, labels, pos = C.gnn_graph_inputs(cfg.d_in, cfg.n_out, g.n)
        dcfg = plan_dist_graph(g.n, src.size, mesh.shape, d_feat=cfg.d_in, n_out=cfg.n_out,
                               edge_chunk=chunk, capacity_slack=slack)
        inputs = prepare_dist_inputs(dcfg, src, dst, feats, labels,
                                     pos=pos if C.gnn_needs_pos(arch) else None)
        local = local_dist_inputs(inputs, dcfg, mesh, "cpu")
        loss, _ = make_dist_gnn_loss(arch, mesh, dcfg, cfg)(params, local)
        loss.backward()
        res = {"loss": loss.detach().numpy(),
               "served": gather_served(dcfg, local["e_src"], local["e_dst"]).numpy(),
               "plan": np.array([dcfg.rows_per_shard, dcfg.edges_per_shard, dcfg.edge_chunk,
                                 dcfg.gather_capacity])}
        # a leaf no loss reads (EGNN's last phi_x) has no gradient: the reference's is 0
        res.update({f"grad/{k}": (torch.zeros_like(v) if v.grad is None else v.grad).numpy()
                    for k, v in C.flatten(params).items()})
        if rank == 0:
            res.update({f"inputs/{k}": v for k, v in inputs.items()})
        out[name] = res
    dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


def gc_all(rank: int, world: int, store_dir: str) -> dict:
    """`compressed_psum` over a "pod" axis of 4, two steps: this rank's q,
    scale (of its gradients plus the carried residual), mean and residual."""
    from repro_torch.optim import compressed_psum, quantize_int8

    mesh = _init(store_dir, "gc", rank, (C.WORLD,), ("pod",))
    group = mesh.group("pod")
    ef, out = None, {}
    for t in range(C.GC_STEPS):
        grads = {k: torch.from_numpy(v[rank]) for k, v in C.gc_grads(t).items()}
        resid = ef.residual if ef is not None else {k: torch.zeros_like(v)
                                                   for k, v in grads.items()}
        for k, g in grads.items():
            q, s = quantize_int8(g.float() + resid[k])
            out[f"{t}/q/{k}"], out[f"{t}/scale/{k}"] = q.numpy(), s.numpy()
        synced, ef = compressed_psum(grads, group, ef)
        for k in grads:
            out[f"{t}/mean/{k}"] = synced[k].numpy()
            out[f"{t}/residual/{k}"] = ef.residual[k].numpy()
    dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# collectives, meshes and shards
# ---------------------------------------------------------------------------


DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.int64, torch.uint8, torch.bool)


def collectives_all(rank: int, world: int, store_dir: str) -> dict:
    """On a (2, 2) mesh: every collective of `collectives` over each axis and
    the flattened pair, forward and backward, with a loss that differs by
    rank; the raw gloo calls on every dtype the port exchanges; the axis
    groups' ranks; `local_shard` of one tensor under several specs."""
    mesh = _init(store_dir, "coll", rank, (2, 2), C.AXES, backend="gloo")
    out = {"coords": np.array([mesh.axis_index("data"), mesh.axis_index("model"),
                               mesh.axis_index(("data", "model"))]),
           "backend": dist.get_backend()}
    for name in ("data", "model", ("data", "model")):
        key = name if isinstance(name, str) else "+".join(name)
        group = mesh.group(name)
        out[f"ranks/{key}"] = np.array(dist.get_process_group_ranks(group))
        x = torch.arange(6, dtype=torch.float32).view(2, 3) + 10 * rank
        w = torch.arange(6, dtype=torch.float32).view(2, 3) * (rank + 1)
        for op, fn in (("psum", lambda t: coll.psum(t, group)),
                       ("enter", lambda t: coll.enter(t, group)),
                       ("pmean", lambda t: coll.pmean(t, group)),
                       ("invariant", lambda t: coll.invariant(t, group)),
                       ("all_gather0", lambda t: coll.all_gather(t, group, 0)),
                       ("all_gather1", lambda t: coll.all_gather(t, group, 1)),
                       ("gather_invariant0", lambda t: coll.gather_invariant(t, group, 0)),
                       ("gather_invariant1", lambda t: coll.gather_invariant(t, group, 1))):
            xi = x.clone().requires_grad_()
            y = fn(xi)
            wy = torch.arange(y.numel(), dtype=torch.float32).view(y.shape) * (rank + 1)
            (y * wy).sum().backward()
            out[f"{op}/{key}/y"], out[f"{op}/{key}/dx"] = y.detach().numpy(), xi.grad.numpy()
        n = coll.group_size(group)
        xa = (torch.arange(n * 2, dtype=torch.float32).view(n, 2) + 100 * rank).requires_grad_()
        ya = coll.all_to_all(xa, group)
        (ya * (torch.arange(n * 2, dtype=torch.float32).view(n, 2) + rank)).sum().backward()
        out[f"all_to_all/{key}/y"], out[f"all_to_all/{key}/dx"] = ya.detach().numpy(), \
            xa.grad.numpy()
    for dt in DTYPES:  # gloo refuses none of them on CPU tensors
        name = str(dt).split(".")[1]
        t = (torch.arange(8) + rank).to(dt)
        a2a = torch.empty_like(t)
        dist.all_to_all_single(a2a, t)
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        red = t.clone()
        if dt != torch.bool:
            dist.all_reduce(red)
        bc = t.clone()
        dist.broadcast(bc, src=1)
        out[f"raw/{name}"] = np.stack([a2a.float().numpy(), torch.cat(parts).float().numpy()[:8],
                                       red.float().numpy(), bc.float().numpy()])
    x = torch.arange(4 * 8 * 2, dtype=torch.float32).view(4, 8, 2)
    for i, spec in enumerate([("data", None), (None, "model"), (("data", "model"),),
                              ("model", "data"), (None, ("data", "model"), None)]):
        out[f"shard/{i}"] = local_shard(x, spec, mesh).numpy()
    dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# the LM step on a mesh
# ---------------------------------------------------------------------------


def lm_case(name: str):
    """(the port's config of case `name`, its parameters as the port's
    per-layer tree of CPU tensors, tokens, labels)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import lm_param_specs, unstack_layers

    arch, _, _, over = C.LM_CASES[name]
    cfg = dataclasses.replace(get_arch(arch).smoke_cfg(), **over)
    specs = lm_param_specs(cfg)
    flat = C.lm_params({k: s.shape for k, s in C.flatten(specs).items()})
    tree = unstack_layers(C.unflatten({k: torch.from_numpy(v) for k, v in flat.items()}, specs),
                          cfg)
    tokens, labels = C.lm_tokens(cfg.vocab)
    return cfg, tree, torch.from_numpy(tokens), torch.from_numpy(labels)


def _lm_meshes(store_dir: str, name: str, rank: int) -> dict:
    mesh = _init(store_dir, name, rank, (2, 2), C.AXES)
    return {((2, 2), C.AXES): mesh, ((1, 4), C.AXES): ProcessMesh((1, 4), C.AXES),
            ((2, 1, 2), C.POD): ProcessMesh((2, 1, 2), C.POD)}


def _lm_rank_batch(lay, tokens, labels):
    """This rank's rows of the batch (its block over the batch axes)."""
    from repro_torch.distributed.mesh_utils import local_shard, resolve_pspec

    spec = resolve_pspec(("batch", "seq"), tuple(tokens.shape), lay.lr)
    return {"tokens": local_shard(tokens, spec, lay.mesh),
            "labels": local_shard(labels, spec, lay.mesh)}


def lm_mesh_run(name: str, mesh, ckpt_dir=None) -> dict:
    """Case `name` on this rank: the loss and every leaf's gradient (its
    shards), then LM_STEPS train steps (warmup 1) with each step's loss and
    grad norm and the updated shards of the parameters, m and v, then the
    prefill's last logits (its vocab block). With ckpt_dir, the trained
    state is saved there (whole leaves, rank 0 writing)."""
    from repro_torch.checkpoint.checkpointer import save_checkpoint
    from repro_torch.configs.base import LM_TRAIN_RULES, merged_rules
    from repro_torch.models.param import local_params, tree_map
    from repro_torch.models.transformer import MeshLayout, loss_fn, prefill_forward
    from repro_torch.optim.adamw import opt_state_pspecs
    from repro_torch.train.train_step import (
        TrainState, accum_value_and_grad, init_train_state, make_train_step,
    )

    cfg, tree, tokens, labels = lm_case(name)
    lay = MeshLayout(cfg, mesh, merged_rules(LM_TRAIN_RULES))
    batch = _lm_rank_batch(lay, tokens, labels)
    local = local_params(tree, lay.specs, mesh)
    loss_of = lambda p, b: loss_fn(p, b, cfg, lay)
    state = init_train_state(local)
    (loss, parts), grads = accum_value_and_grad(loss_of, 1)(state.params, batch)
    out = {"loss": loss.detach().numpy(), "aux": parts["aux"].detach().numpy()}
    out.update({f"grad/{k}": v.numpy() for k, v in C.flatten(grads).items()})
    step = make_train_step(loss_of, warmup=1, total_steps=10, mesh=mesh, specs=lay.specs)
    for i in range(C.LM_STEPS):
        state, m = step(state, batch)
        out[f"step{i}/loss"] = m["loss"].detach().numpy()
        out[f"step{i}/grad_norm"] = m["grad_norm"].numpy()
    for part, t in (("p", state.params), ("m", state.opt_state["m"]),
                    ("v", state.opt_state["v"])):
        out.update({f"{part}/{k}": v.detach().numpy() for k, v in C.flatten(t).items()})
    icfg = dataclasses.replace(cfg, remat=False)
    last, _ = prefill_forward(tree_map(lambda p: p.detach(), state.params), batch["tokens"],
                              icfg, MeshLayout(icfg, mesh, merged_rules(LM_TRAIN_RULES)))
    out["last"] = last.numpy()
    if ckpt_dir is not None:
        specs = TrainState(lay.specs, opt_state_pspecs(lay.specs), ())
        save_checkpoint(ckpt_dir, C.LM_STEPS, state, mesh=mesh, specs=specs)
    return out


def lm_mesh_all(rank: int, world: int, store_dir: str) -> dict:
    """Every case of `C.LM_CASES` on this rank: {case: `lm_mesh_run`'s}."""
    meshes = _lm_meshes(store_dir, "lm", rank)
    out = {name: lm_mesh_run(name, meshes[shape, axes])
           for name, (_, shape, axes, _) in C.LM_CASES.items()}
    dist.destroy_process_group()
    return out


def lm_checkpoint_all(rank: int, world: int, store_dir: str, ckpt_dir: str) -> dict:
    """`C.LM_CKPT_CASE` trained on (2, 2) and saved to ckpt_dir; then
    restored on (1, 4) into a state of zeros: {"saved": the (2, 2) shards
    this rank saved, "restored": its (1, 4) shards}."""
    from repro_torch.checkpoint.checkpointer import restore_checkpoint
    from repro_torch.configs.base import LM_TRAIN_RULES, merged_rules
    from repro_torch.models.param import local_params, tree_map
    from repro_torch.models.transformer import MeshLayout
    from repro_torch.optim.adamw import opt_state_pspecs
    from repro_torch.train.train_step import TrainState, init_train_state

    meshes = _lm_meshes(store_dir, "ckpt", rank)
    name = C.LM_CKPT_CASE
    saved = lm_mesh_run(name, meshes[(2, 2), C.AXES], ckpt_dir)
    cfg, tree, _, _ = lm_case(name)
    mesh = meshes[(1, 4), C.AXES]
    lay = MeshLayout(cfg, mesh, merged_rules(LM_TRAIN_RULES))
    like = init_train_state(tree_map(torch.zeros_like, local_params(tree, lay.specs, mesh)))
    specs = TrainState(lay.specs, opt_state_pspecs(lay.specs), ())
    state, step = restore_checkpoint(ckpt_dir, None, like, mesh=mesh, specs=specs)
    restored = {"step": state.step.numpy(), "count": state.opt_state["count"].numpy()}
    for part, t in (("p", state.params), ("m", state.opt_state["m"]),
                    ("v", state.opt_state["v"])):
        restored.update({f"{part}/{k}": v.detach().numpy() for k, v in C.flatten(t).items()})
    dist.destroy_process_group()
    return {"saved": {k: v for k, v in saved.items() if k[:2] in ("p/", "m/", "v/")},
            "restored": restored, "step": step}


# ---------------------------------------------------------------------------
# the decode step on a mesh
# ---------------------------------------------------------------------------


class _OpNames(TorchDispatchMode):
    """The aten ops run under it, by name."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.__name__.split(".")[0])
        return func(*args, **(kwargs or {}))


def decode_rules(kind: str) -> dict:
    from repro_torch.configs.base import LM_DECODE_RULES, LM_LONG_DECODE_RULES, merged_rules

    return merged_rules({"decode": LM_DECODE_RULES, "long": LM_LONG_DECODE_RULES}[kind])


def decode_case(name: str):
    """(the port's config of decode case `name`, its parameters as the
    port's per-layer tree of CPU tensors, the cache {path: array} and the
    tokens of each step, `C.decode_inputs`')."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import lm_param_specs, unstack_layers

    arch, _, _, rules = C.DECODE_CASES[name]
    cfg = get_arch(arch).smoke_cfg()
    specs = lm_param_specs(cfg)
    flat = C.lm_params({k: s.shape for k, s in C.flatten(specs).items()})
    tree = unstack_layers(C.unflatten({k: torch.from_numpy(v) for k, v in flat.items()}, specs),
                          cfg)
    cache, tokens = C.decode_inputs(cfg, rules)
    return cfg, tree, cache, tokens


def decode_mesh_run(name: str, mesh) -> dict:
    """Case `name` on this rank: its block of the drawn cache at
    `C.DECODE_POS`, then `C.DECODE_STEPS` steps of `serve_step` on its
    shards and rows: each step's logits (its vocab block) and cache blocks
    {"step{i}/logits", "step{i}/layers/{li}/k|v", "step{i}/pos"}; then one
    more step under a dispatch mode, whose aten op names are "ops"."""
    from repro_torch.distributed.mesh_utils import resolve_pspec
    from repro_torch.models.param import local_params
    from repro_torch.models.transformer import (
        MeshLayout, kv_cache_pspecs, local_kv_cache, serve_step,
    )

    cfg, tree, cache, tokens = decode_case(name)
    lay = MeshLayout(cfg, mesh, decode_rules(C.DECODE_CASES[name][3]))
    params = local_params(tree, lay.specs, mesh)
    B = tokens.shape[1]
    kv = local_kv_cache(cfg, B, C.DECODE_SMAX, lay, device="cpu")
    spec = kv_cache_pspecs(cfg, B, C.DECODE_SMAX, lay.lr)["layers"][0]["k"]
    for li, layer in enumerate(kv["layers"]):
        for n in ("k", "v"):
            layer[n].copy_(local_shard(torch.from_numpy(cache[f"layers/{li}/{n}"]), spec, mesh))
        layer["pos"] = C.DECODE_POS
    tok_spec = resolve_pspec(("batch", None), (B, 1), lay.lr)
    rows = lambda i: local_shard(torch.from_numpy(tokens[i % len(tokens)]), tok_spec, mesh)
    out = {}
    for i in range(C.DECODE_STEPS):
        logits, kv = serve_step(params, kv, rows(i), cfg, lay)
        out[f"step{i}/logits"] = logits.numpy()
        out[f"step{i}/pos"] = np.asarray(kv["layers"][0]["pos"])
        for li, layer in enumerate(kv["layers"]):
            for n in ("k", "v"):
                out[f"step{i}/layers/{li}/{n}"] = layer[n].numpy().copy()
    with _OpNames() as ops:
        serve_step(params, kv, rows(0), cfg, lay)
    out["ops"] = sorted(ops.names)
    return out


def decode_mesh_all(rank: int, world: int, store_dir: str) -> dict:
    """Every case of `C.DECODE_CASES` on this rank: {case: `decode_mesh_run`'s}."""
    meshes = _lm_meshes(store_dir, "decode", rank)
    out = {name: decode_mesh_run(name, meshes[shape, axes])
           for name, (_, shape, axes, _) in C.DECODE_CASES.items()}
    dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# DIN on a mesh
# ---------------------------------------------------------------------------


def din_case(name: str):
    """(the port's DIN config of case `name`, its parameters {leaf: CPU
    tensor}, the batch and the retrieval batches {n: batch} as tensors)."""
    from repro_torch.configs import din as conf
    from repro_torch.models.recsys.din import param_specs

    cfg = dataclasses.replace(conf.smoke_cfg(), **C.DIN_CASES[name][2])
    flat = C.din_params({k: s.shape for k, s in param_specs(cfg).items()})
    batch, retrieval = C.din_batches(cfg.seq_len, cfg.n_items, cfg.n_cats, cfg.d_profile)
    t = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}  # noqa: E731
    return cfg, t(flat), t(batch), {n: t(b) for n, b in retrieval.items()}


def din_mesh_run(name: str, mesh) -> dict:
    """Case `name` on this rank, under `DIN_RULES`: its block of the scores,
    the loss and every leaf's gradient (its shards), one train step (warmup
    0: the base rate) with its loss and grad norm and the updated shards
    of the parameters, m and v, then its block of each retrieval batch's
    scores; the aten ops of all of it ("ops"), and each layout's candidate
    spec ("cand/N")."""
    from repro_torch.configs.base import merged_rules
    from repro_torch.configs.din import DIN_RULES
    from repro_torch.models.param import local_params
    from repro_torch.models.recsys import din as D
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import accum_value_and_grad, init_train_state, \
        make_train_step

    cfg, flat, batch, retrieval = din_case(name)
    rules = merged_rules(DIN_RULES)
    lay = D.MeshLayout(cfg, mesh, rules)
    rows = lay.local_batch(batch)
    out = {}
    with _OpNames() as ops:
        out["score"] = D.score(local_params(flat, lay.specs, mesh), rows, cfg, lay).numpy()
        loss_of = lambda p, b: D.loss_fn(p, b, cfg, lay)  # noqa: E731
        state = init_train_state(local_params(flat, lay.specs, mesh))
        (loss, _), grads = accum_value_and_grad(loss_of, 1)(state.params, rows)
        out["loss"] = loss.detach().numpy()
        out.update({f"grad/{k}": v.numpy() for k, v in grads.items()})
        step = make_train_step(loss_of, AdamWConfig(weight_decay=0.0), warmup=0,
                               total_steps=10, mesh=mesh, specs=lay.specs)
        state, m = step(state, rows)
        out["step/loss"], out["step/grad_norm"] = m["loss"].numpy(), m["grad_norm"].numpy()
        for tag, t in (("p", state.params), ("m", state.opt_state["m"]),
                       ("v", state.opt_state["v"])):
            out.update({f"{tag}/{k}": v.detach().numpy() for k, v in t.items()})
        for n, rb in retrieval.items():
            rl = D.MeshLayout(cfg, mesh, rules, n_candidates=n)
            out[f"retrieval/{n}"] = D.retrieval_scores(local_params(flat, rl.specs, mesh),
                                                       rl.local_batch(rb), cfg, rl).numpy()
            out[f"cand/{n}"] = np.asarray(str(rl.cand_axes))
    out["ops"] = sorted(ops.names)
    return out


def din_mesh_all(rank: int, world: int, store_dir: str) -> dict:
    """Every case of `C.DIN_CASES` on this rank: {case: `din_mesh_run`'s};
    and "gather": DIN's `block_gather` on the (2, 2) mesh's model groups,
    each rank asking for ids of its own."""
    from repro_torch.models.recsys import din as D

    meshes = _lm_meshes(store_dir, "din", rank)
    meshes[(4, 1), C.AXES] = ProcessMesh((4, 1), C.AXES)
    out = {name: din_mesh_run(name, meshes[shape, axes])
           for name, (shape, axes, _) in C.DIN_CASES.items()}
    mesh = meshes[(2, 2), C.AXES]
    table = np.arange(40 * 3, dtype=np.float32).reshape(40, 3)
    ids = np.random.default_rng([23, rank]).integers(-1, 40, 30).astype(np.int32)
    ids[:4] = (0, 19, 20, 39)  # the blocks' edges
    local = local_shard(torch.from_numpy(table), ("model", None), mesh).requires_grad_()
    feat, served = D.block_gather(torch.from_numpy(ids), local, mesh.group("model"), 2)
    feat.sum().backward()
    out["gather"] = {"ids": ids, "feat": feat.detach().numpy(), "served": served.numpy(),
                     "grad": local.grad.numpy()}
    dist.destroy_process_group()
    return out
