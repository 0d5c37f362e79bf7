"""The reference's sharded paths on 4 host devices, for the port's tests of
them: run as a program, it computes one group of `_sharded_cases` through
the JAX package and writes the inputs it made and the outputs to one .npz.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_sharded_ref.py WHAT OUT.npz

WHAT: "moe" (`moe_ffn` under a mesh: `_moe_ffn_shard_map`), "gnn:ARCH" or
"gnn:pna-tight" (`make_dist_gnn_loss`, `prepare_dist_inputs`, the gather's
served masks), "compression" (`compressed_psum` over a "pod" axis), "lm"
(the LM training step jitted on a (2, 2) mesh under `LM_TRAIN_RULES`,
bound as the reference's dry run binds it: `bind_rules`, `NamedSharding`s
from the logical specs; each device's shards after `C.LM_STEPS` steps),
"lm-collectives" (the same step, remat off, compiled: the reference's
`parse_collectives` of its HLO, count and bytes by kind), "lm-unsharded:I"
(the unsharded steps of every I-th of `C.lm_variants()`:
the loss and gradients, `C.LM_STEPS` steps of `make_train_step`, then the
prefill's last logits), "decode" (`serve_step` jitted on a (2, 2) mesh
under `LM_DECODE_RULES` or `LM_LONG_DECODE_RULES`, bound as its dry run
binds it, for each case of `C.DECODE_REF_SHARDED`: each device's shards of
the logits and the cache at each step), "decode-unsharded" (the unsharded
`serve_step` of every `C.decode_variant`), "din" (DIN's unsharded
`score`, loss and gradients, one train step and `retrieval_scores` of every
`C.din_variant`; then its training step and `retrieval_scores` jitted on a
(2, 2) mesh under `DIN_RULES`, bound as its dry run binds them: each
device's shards after the step, and of the scores).
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _sharded_cases as C


def mesh_of(shape, axes=C.AXES) -> Mesh:
    k = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:k]).reshape(shape), axes)


def moe(out: dict) -> None:
    from repro.distributed.mesh_utils import set_mesh_rules
    from repro.models.moe import MoEConfig, moe_ffn

    for case, (shape, T, cap, factor) in C.MOE_CASES.items():
        cfg = MoEConfig(**dict(C.MOE, capacity_factor=factor), dtype=jnp.float32)
        flat, x, w = C.moe_inputs(case)
        params = C.unflatten({k: jnp.asarray(v) for k, v in flat.items()},
                             {"router": 0, "w_gate": 0, "w_up": 0, "w_down": 0,
                              "shared": {"w_gate": 0, "w_up": 0, "w_down": 0}})
        mesh = mesh_of(shape)

        def loss(p, xx):
            with set_mesh_rules(mesh):
                o, aux = moe_ffn(p, xx, cfg, capacity=cap)
            return jnp.sum(o * w) + C.AUX_WEIGHT * aux, (o, aux)

        with mesh:
            (_, (o, aux)), (gp, gx) = jax.jit(
                jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
        out[f"{case}/out"] = np.asarray(o)
        out[f"{case}/aux"] = np.asarray(aux)
        out[f"{case}/grad/x"] = np.asarray(gx)
        for k, v in C.flatten(gp).items():
            out[f"{case}/grad/{k}"] = np.asarray(v)


def gnn(out: dict, name: str) -> None:
    from repro.configs import get_arch
    from repro.core.storage import bucket_by_owner
    from repro.graph.csr import csr_to_edge_index
    from repro.graph.generators import powerlaw_graph
    from repro.models.gnn import egnn, equiformer_v2, graphcast, pna
    from repro.models.gnn.distributed import (
        make_dist_gnn_loss, plan_dist_graph, prepare_dist_inputs,
    )

    arch, chunk, slack = C.GNN_CASES[name]
    mod = {"egnn": egnn, "pna": pna, "graphcast": graphcast, "equiformer-v2": equiformer_v2}[arch]
    cfg = get_arch(arch).smoke_cfg()
    g = powerlaw_graph(**C.GNN_GRAPH)
    src, dst = csr_to_edge_index(g)
    feats, labels, pos = C.gnn_graph_inputs(cfg.d_in, cfg.n_out, g.n)
    specs = C.flatten(mod.param_specs(cfg))
    like = mod.param_specs(cfg)
    flat = C.draw_tree({k: s.shape for k, s in specs.items()}, 0)
    params = C.unflatten({k: jnp.asarray(v) for k, v in flat.items()}, like)

    mesh = mesh_of(C.GNN_MESH)
    dcfg = plan_dist_graph(g.n, src.size, dict(mesh.shape), d_feat=cfg.d_in, n_out=cfg.n_out,
                           edge_chunk=chunk, capacity_slack=slack)
    inputs = prepare_dist_inputs(dcfg, src, dst, feats, labels,
                                 pos=pos if C.gnn_needs_pos(arch) else None)
    loss_fn = make_dist_gnn_loss(arch, mesh, dcfg, cfg)
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(lambda p, i: loss_fn(p, i)[0]))(
            params, {k: jnp.asarray(v) for k, v in inputs.items()})
    out["loss"] = np.asarray(loss)
    for k, v in C.flatten(grads).items():
        out[f"grad/{k}"] = np.asarray(v)
    for k, v in inputs.items():
        out[f"inputs/{k}"] = v
    # the gather's served masks, chunk by chunk, as `edge_stream` computes them
    D, E = dcfg.n_devices, dcfg.edge_chunk
    e_src = inputs["e_src"].reshape(D, dcfg.n_chunks, E)
    e_dst = inputs["e_dst"].reshape(D, dcfg.n_chunks, E)
    served = np.zeros(e_src.shape, bool)
    for d in range(D):
        for c in range(dcfg.n_chunks):
            ok = (e_src[d, c] >= 0) & (e_dst[d, c] >= 0)
            ids = jnp.where(ok, e_src[d, c], -1)
            owners = jnp.where(ids >= 0, ids % D, 0).astype(jnp.int32)
            _, slot = bucket_by_owner(ids, owners, D, dcfg.gather_capacity)
            served[d, c] = ok & (np.asarray(slot) >= 0)
    out["served"] = served
    out["plan"] = np.array([dcfg.rows_per_shard, dcfg.edges_per_shard, dcfg.edge_chunk,
                            dcfg.gather_capacity])


def compression(out: dict) -> None:
    from repro.optim.grad_compression import compressed_psum, init_error_feedback, quantize_int8

    mesh = mesh_of((C.WORLD,), ("pod",))
    spec = {k: P("pod", *([None] * (len(s) - 1))) for k, s in C.GC_SHAPES.items()}

    def body(grads, residual):
        ef = init_error_feedback(grads)._replace(residual=residual)
        x = {k: grads[k].astype(jnp.float32) + residual[k] for k in grads}
        qs = {k: quantize_int8(v) for k, v in x.items()}
        synced, ef = compressed_psum(grads, "pod", ef)
        return (synced, ef.residual, {k: q for k, (q, _) in qs.items()},
                {k: s[None] for k, (_, s) in qs.items()})

    step = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec),
                             out_specs=(spec, spec, spec, {k: P("pod") for k in spec}),
                             check_rep=False))
    residual = {k: jnp.zeros((C.WORLD * s[0],) + s[1:], jnp.float32)
                for k, s in C.GC_SHAPES.items()}
    for t in range(C.GC_STEPS):
        grads = {k: jnp.asarray(v.reshape((-1,) + v.shape[2:])) for k, v in C.gc_grads(t).items()}
        with mesh:
            synced, residual, q, scale = step(grads, residual)
        for k in C.GC_SHAPES:
            out[f"{t}/mean/{k}"] = np.asarray(synced[k])
            out[f"{t}/residual/{k}"] = np.asarray(residual[k])
            out[f"{t}/q/{k}"] = np.asarray(q[k])
            out[f"{t}/scale/{k}"] = np.asarray(scale[k])


def lm(out: dict, collectives: bool = False) -> None:
    import dataclasses

    from repro.configs import get_arch
    from repro.configs.base import LM_TRAIN_RULES, bind_rules, merged_rules, named
    from repro.distributed.mesh_utils import resolve_pspec, set_mesh_rules
    from repro.models import transformer as T
    from repro.models.param import param_pspecs
    from repro.optim.adamw import AdamWConfig, adamw_update, opt_state_pspecs
    from repro.optim.schedule import warmup_cosine
    from repro.train.train_step import TrainState, accum_value_and_grad, init_train_state

    arch, shape, axes, over = C.LM_CASES[C.LM_REF_SHARDED_CASE]
    cfg = dataclasses.replace(get_arch(arch).smoke_cfg(), **over)
    if collectives:  # the step `_lm_collectives.py` sets beside the port's count
        cfg = dataclasses.replace(cfg, remat=False)
    specs = T.lm_param_specs(cfg)
    flat = C.lm_params({k: s.shape for k, s in C.flatten(specs).items()})
    params = C.unflatten({k: jnp.asarray(v) for k, v in flat.items()}, specs)
    tokens, labels = C.lm_tokens(cfg.vocab)
    mesh = mesh_of(shape, axes)
    rules = merged_rules(LM_TRAIN_RULES)
    with set_mesh_rules(mesh, rules) as lr:
        pspecs = param_pspecs(specs, lr)
        tok = resolve_pspec(("batch", "seq"), tokens.shape, lr)
    state_sh = TrainState(params=pspecs, opt_state=opt_state_pspecs(pspecs), step=P())
    batch_sh = {"tokens": tok, "labels": tok}
    opt = AdamWConfig()
    vg = accum_value_and_grad(lambda p, b: T.loss_fn(p, b, cfg), 1)

    def train_step(st, b):  # make_train_step's body at warmup 1, total 10
        (loss, metrics), grads = vg(st.params, b)
        lr_now = warmup_cosine(st.step, opt.lr, 1, 10)
        new_p, new_o, om = adamw_update(grads, st.opt_state, st.params, opt, lr=lr_now)
        return TrainState(params=new_p, opt_state=new_o, step=st.step + 1), dict(
            metrics, loss=loss, **om)

    step = jax.jit(bind_rules(train_step, mesh, rules),
                   in_shardings=(named(mesh, state_sh), named(mesh, batch_sh)),
                   out_shardings=(named(mesh, state_sh), None))
    state = jax.device_put(init_train_state(params), named(mesh, state_sh))
    batch = jax.device_put({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
                           named(mesh, batch_sh))
    if collectives:
        from repro.analysis.roofline import parse_collectives

        stats = parse_collectives(step.lower(state, batch).compile().as_text(), n_devices=4)
        for kind, n in stats.counts.items():
            out[f"count/{kind}"] = np.asarray(n)
            out[f"bytes/{kind}"] = np.asarray(stats.bytes_by_kind[kind])
        return
    for i in range(C.LM_STEPS):
        state, m = step(state, batch)
        out[f"step{i}/loss"] = np.asarray(m["loss"])
        out[f"step{i}/grad_norm"] = np.asarray(m["grad_norm"])
    devices = list(mesh.devices.flat)
    for part, tree in (("p", state.params), ("m", state.opt_state["m"]),
                       ("v", state.opt_state["v"])):
        for k, a in C.flatten(tree).items():
            for sh in a.addressable_shards:
                out[f"{part}/{k}/{devices.index(sh.device)}"] = np.asarray(sh.data)


def lm_unsharded(out: dict, part: int) -> None:
    import dataclasses

    from repro.configs import get_arch
    from repro.models import transformer as T
    from repro.train.train_step import init_train_state, make_train_step

    for variant in C.lm_variants()[part::C.LM_REF_PROCS]:
        name = next(n for n in C.LM_CASES if C.lm_variant(n) == variant)
        arch, _, _, over = C.LM_CASES[name]
        cfg = dataclasses.replace(get_arch(arch).smoke_cfg(), **over)
        specs = T.lm_param_specs(cfg)
        flat = C.lm_params({k: s.shape for k, s in C.flatten(specs).items()})
        params = C.unflatten({k: jnp.asarray(v) for k, v in flat.items()}, specs)
        tokens, labels = C.lm_tokens(cfg.vocab)
        batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: T.loss_fn(p, b, cfg), has_aux=True))(params, batch)
        out[f"{variant}/loss"] = np.asarray(loss)
        out.update({f"{variant}/grad/{k}": np.asarray(v) for k, v in C.flatten(grads).items()})
        step = make_train_step(lambda p, b: T.loss_fn(p, b, cfg), warmup=1, total_steps=10,
                               donate=False)
        state = init_train_state(params)
        for i in range(C.LM_STEPS):
            state, m = step(state, batch)
            out[f"{variant}/step{i}/loss"] = np.asarray(m["loss"])
            out[f"{variant}/step{i}/grad_norm"] = np.asarray(m["grad_norm"])
        for tag, tree in (("p", state.params), ("m", state.opt_state["m"]),
                          ("v", state.opt_state["v"])):
            out.update({f"{variant}/{tag}/{k}": np.asarray(v)
                        for k, v in C.flatten(tree).items()})
        icfg = dataclasses.replace(cfg, remat=False)
        last, _ = jax.jit(lambda p, t: T.prefill_forward(p, t, icfg))(state.params,
                                                                       batch["tokens"])
        out[f"{variant}/last"] = np.asarray(last)


def _decode_inputs(name: str):
    """(the reference's config, its stacked parameters, its cache at
    `C.DECODE_POS`, the tokens of each step) of decode case `name`."""
    from repro.configs import get_arch
    from repro.models import transformer as T

    arch, _, _, rules = C.DECODE_CASES[name]
    cfg = get_arch(arch).smoke_cfg()
    specs = T.lm_param_specs(cfg)
    flat = C.lm_params({k: s.shape for k, s in C.flatten(specs).items()})
    params = C.unflatten({k: jnp.asarray(v) for k, v in flat.items()}, specs)
    drawn, tokens = C.decode_inputs(cfg, rules)
    cache = {"layers": [{"k": jnp.asarray(drawn[f"layers/{li}/k"]),
                         "v": jnp.asarray(drawn[f"layers/{li}/v"]),
                         "pos": jnp.asarray(C.DECODE_POS, jnp.int32)}
                        for li in range(cfg.n_layers)]}
    return cfg, params, cache, tokens


def _decode_steps(out: dict, prefix: str, step, params, cache, tokens, n_layers: int,
                  shards=None) -> None:
    """`C.DECODE_STEPS` steps: each step's logits and cache under `prefix`,
    whole, or with `shards` (a device list) each device's shard."""
    for i in range(C.DECODE_STEPS):
        logits, cache = step(params, cache, tokens[i])
        leaves = {"logits": logits}
        leaves.update({f"layers/{li}/{n}": cache["layers"][li][n]
                       for li in range(n_layers) for n in ("k", "v")})
        out[f"{prefix}step{i}/pos"] = np.asarray(cache["layers"][0]["pos"])
        for k, a in leaves.items():
            if shards is None:
                out[f"{prefix}step{i}/{k}"] = np.asarray(a)
                continue
            for sh in a.addressable_shards:
                out[f"{prefix}step{i}/{k}/{shards.index(sh.device)}"] = np.asarray(sh.data)


def decode_unsharded(out: dict) -> None:
    """The unsharded `serve_step` of every `C.decode_variant`."""
    from repro.models import transformer as T

    for variant in sorted({C.decode_variant(n) for n in C.DECODE_CASES}):
        name = next(n for n in C.DECODE_CASES if C.decode_variant(n) == variant)
        cfg, params, cache, tokens = _decode_inputs(name)
        step = jax.jit(lambda p, c, t: T.serve_step(p, c, t, cfg))
        _decode_steps(out, f"{variant}/", step, params, cache, jnp.asarray(tokens), cfg.n_layers)


def decode(out: dict) -> None:
    """The reference's decode bound to a (2, 2) mesh as its dry run binds
    it (`bind_rules`, `NamedSharding`s from `param_pspecs` and
    `kv_cache_pspecs`), for each of `C.DECODE_REF_SHARDED`: each device's
    shards of the logits and the cache at each step."""
    from repro.configs.base import (
        LM_DECODE_RULES, LM_LONG_DECODE_RULES, bind_rules, merged_rules, named,
    )
    from repro.distributed.mesh_utils import resolve_pspec, set_mesh_rules
    from repro.models import transformer as T
    from repro.models.param import param_pspecs

    for name in C.DECODE_REF_SHARDED:
        _, shape, axes, kind = C.DECODE_CASES[name]
        cfg, params, cache, tokens = _decode_inputs(name)
        mesh = mesh_of(shape, axes)
        rules = merged_rules(LM_DECODE_RULES if kind == "decode" else LM_LONG_DECODE_RULES)
        B = tokens.shape[1]
        with set_mesh_rules(mesh, rules) as lr:
            psp = param_pspecs(T.lm_param_specs(cfg), lr)
            ksp = T.kv_cache_pspecs(cfg, B, C.DECODE_SMAX, lr)
            tsp = resolve_pspec(("batch", None), (B, 1), lr)
            lsp = resolve_pspec(("batch", "vocab"), (B, cfg.vocab), lr)
        step = jax.jit(bind_rules(lambda p, c, t: T.serve_step(p, c, t, cfg), mesh, rules),
                       in_shardings=(named(mesh, psp), named(mesh, ksp), named(mesh, tsp)),
                       out_shardings=(named(mesh, lsp), named(mesh, ksp)))
        params = jax.device_put(params, named(mesh, psp))
        cache = jax.device_put(cache, named(mesh, ksp))
        _decode_steps(out, f"{name}/", step, params, cache,
                      [jax.device_put(jnp.asarray(t), named(mesh, tsp)) for t in tokens],
                      cfg.n_layers, shards=list(mesh.devices.flat))
        out[f"{name}/spec/k"] = np.asarray(str(ksp["layers"][0]["k"]))


def _din_inputs(name: str):
    """(the reference's config, parameters, batch and retrieval batches) of
    DIN case `name`."""
    import dataclasses

    from repro.configs import din as jconf
    from repro.models.recsys import din as JD

    cfg = dataclasses.replace(jconf.smoke_cfg(), **C.DIN_CASES[name][2])
    shapes = {k: s.shape for k, s in JD.param_specs(cfg).items()}
    params = {k: jnp.asarray(v) for k, v in C.din_params(shapes).items()}
    batch, retrieval = C.din_batches(cfg.seq_len, cfg.n_items, cfg.n_cats, cfg.d_profile)
    return cfg, params, batch, retrieval


def din(out: dict) -> None:
    from repro.configs.base import bind_rules, merged_rules, named
    from repro.configs.din import DIN_RULES
    from repro.distributed.mesh_utils import resolve_pspec, set_mesh_rules
    from repro.models.param import param_pspecs
    from repro.models.recsys import din as JD
    from repro.optim.adamw import AdamWConfig, adamw_update, opt_state_pspecs
    from repro.train.train_step import TrainState, init_train_state, make_train_step

    opt = AdamWConfig(weight_decay=0.0)
    for variant in sorted({C.din_variant(n) for n in C.DIN_CASES}):
        name = next(n for n in C.DIN_CASES if C.din_variant(n) == variant)
        cfg, params, batch, retrieval = _din_inputs(name)
        loss_of = lambda p, b: JD.loss_fn(p, b, cfg)  # noqa: E731
        out[f"{variant}/score"] = np.asarray(jax.jit(lambda p, b: JD.score(p, b, cfg))(
            params, batch))
        (loss, _), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params, batch)
        out[f"{variant}/loss"] = np.asarray(loss)
        out.update({f"{variant}/grad/{k}": np.asarray(v) for k, v in grads.items()})
        step = make_train_step(loss_of, opt, warmup=0, total_steps=10, donate=False)
        state, m = step(init_train_state(params), batch)
        out[f"{variant}/step/loss"] = np.asarray(m["loss"])
        out[f"{variant}/step/grad_norm"] = np.asarray(m["grad_norm"])
        for tag, tree in (("p", state.params), ("m", state.opt_state["m"]),
                          ("v", state.opt_state["v"])):
            out.update({f"{variant}/{tag}/{k}": np.asarray(v) for k, v in tree.items()})
        for n, rb in retrieval.items():
            out[f"{variant}/retrieval/{n}"] = np.asarray(jax.jit(
                lambda p, b: JD.retrieval_scores(p, b, cfg))(params, rb))

    # the training step and retrieval as the reference's dry run binds them
    name = C.DIN_REF_SHARDED
    shape, axes, _ = C.DIN_CASES[name]
    cfg, params, batch, retrieval = _din_inputs(name)
    mesh, rules = mesh_of(shape, axes), merged_rules(DIN_RULES)
    ax = {"hist_items": ("batch", None), "hist_cats": ("batch", None), "cand_item": ("batch",),
          "cand_cat": ("batch",), "profile": ("batch", None), "label": ("batch",),
          "cand_items": ("cand",), "cand_cats": ("cand",)}
    with set_mesh_rules(mesh, rules) as lr:
        pspecs = param_pspecs(JD.param_specs(cfg), lr)
        bsh = {k: resolve_pspec(ax[k], v.shape, lr) for k, v in batch.items()}
        rsh = {n: {k: resolve_pspec(ax.get(k, (None, None)), v.shape, lr)
                   for k, v in rb.items()} for n, rb in retrieval.items()}
    state_sh = TrainState(params=pspecs, opt_state=opt_state_pspecs(pspecs), step=P())

    def train_step(st, b):  # the dry run's: one step at the base rate
        (loss, metrics), grads = jax.value_and_grad(
            lambda p, bb: JD.loss_fn(p, bb, cfg), has_aux=True)(st.params, b)
        new_p, new_o, om = adamw_update(grads, st.opt_state, st.params, opt)
        return TrainState(new_p, new_o, st.step + 1), dict(metrics, loss=loss, **om)

    step = jax.jit(bind_rules(train_step, mesh, rules),
                   in_shardings=(named(mesh, state_sh), named(mesh, bsh)),
                   out_shardings=(named(mesh, state_sh), None))
    state, m = step(jax.device_put(init_train_state(params), named(mesh, state_sh)),
                    jax.device_put(batch, named(mesh, bsh)))
    out["sharded/loss"], out["sharded/grad_norm"] = np.asarray(m["loss"]), \
        np.asarray(m["grad_norm"])
    devices = list(mesh.devices.flat)
    for tag, tree in (("p", state.params), ("m", state.opt_state["m"]),
                      ("v", state.opt_state["v"])):
        for k, a in tree.items():
            for sh in a.addressable_shards:
                out[f"sharded/{tag}/{k}/{devices.index(sh.device)}"] = np.asarray(sh.data)
    for n, rb in retrieval.items():
        fn = jax.jit(bind_rules(lambda p, b: JD.retrieval_scores(p, b, cfg), mesh, rules),
                     in_shardings=(named(mesh, pspecs), named(mesh, rsh[n])),
                     out_shardings=named(mesh, rsh[n]["cand_items"]))
        scores = fn(jax.device_put(params, named(mesh, pspecs)),
                    jax.device_put(rb, named(mesh, rsh[n])))
        for sh in scores.addressable_shards:
            out[f"sharded/retrieval/{n}/{devices.index(sh.device)}"] = np.asarray(sh.data)
        out[f"sharded/retrieval/{n}/spec"] = np.asarray(str(rsh[n]["cand_items"]))


def main(what: str, path: str) -> None:
    out: dict = {}
    if what == "moe":
        moe(out)
    elif what.startswith("gnn:"):
        gnn(out, what[4:])
    elif what == "compression":
        compression(out)
    elif what == "lm":
        lm(out)
    elif what == "lm-collectives":
        lm(out, collectives=True)
    elif what.startswith("lm-unsharded:"):
        lm_unsharded(out, int(what.split(":")[1]))
    elif what == "decode":
        decode(out)
    elif what == "decode-unsharded":
        decode_unsharded(out)
    elif what == "din":
        din(out)
    else:
        raise SystemExit(f"unknown group {what!r}")
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
