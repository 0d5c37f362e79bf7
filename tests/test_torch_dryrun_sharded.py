"""The dry run's sharded counts: a per-rank step run on meta tensors as
rank 0 of a `fake` process group (`launch/dryrun.py` `fake_process_mesh`,
`analysis/roofline.py` `count_step(per_rank=True)`).

  - The Qwen3-4B smoke config's training step on (data, model) (2, 2)
    under `LM_TRAIN_RULES`, remat off, on rank 0's meta shards: each c10d
    kind's output bytes equal a reckoning by hand from the leaves' shapes
    and specs (every FSDP gather and its reduce-scatter's all-to-all, the
    psums that close each block, the entered activations' and leaves'
    backward psums, the vocab-parallel loss's max and sums, the loss's
    psums over the batch axis, the global norm's one psum a set of axes).
  - The reckoned peak (`temp_bytes`: the live storage the step allocates)
    grows with the local batch, and the peak per device exceeds the state.
  - A production cell, Qwen3-4B train_4k on 16x16, as rank 0 of a fake
    world of 256: non-null collective bytes, temporaries and a collective
    term; the sharded ogb_products step and the decode cells (Qwen3-4B
    decode_32k under `LM_DECODE_RULES`, Gemma2-27B long_500k under
    `LM_LONG_DECODE_RULES`) likewise, each decode cell's cache bytes per
    device equal to a reckoning by hand.
  - The Qwen3-4B smoke config's decode step on (2, 2) under
    `LM_DECODE_RULES` on rank 0's shards and its block of the cache: each
    kind's output bytes equal a reckoning by hand (the FSDP gathers, the q
    activation's gather over "model", the psums that close each block, the
    softmax's max and sum and the partial outputs over `kv_seq`).
  - A collective over a group rank 0 is not in runs no op, so the dry run
    counts rank 0's own collectives only.
  - DIN's four cells under `DIN_RULES` as rank 0 of fake worlds of 256
    (16x16) and 512 (2x16x16): counted per rank, the tables split over
    "model" in the per-device state bytes; train_batch's and
    retrieval_cand's collective bytes equal a reckoning by hand (the
    lookups' psums over "model", the split layers' activation gathers, the
    entered inputs' and leaves' backward psums, the loss's and the global
    norm's psums).
"""

import dataclasses
import functools
import math

import pytest
import torch
import torch.distributed as dist

from _torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from repro_torch.analysis.roofline import count_step
from repro_torch.configs import get_arch
from repro_torch.configs.base import LM_DECODE_RULES, LM_TRAIN_RULES, merged_rules, \
    train_step_fn
from repro_torch.distributed.mesh_utils import layout, local_shard, resolve_pspec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.param import abstract_params, local_params, tree_leaves
from repro_torch.models.transformer import MeshLayout, lm_param_specs, local_kv_cache, \
    loss_fn, serve_step, unstack_layers
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.train_step import TrainState, trainable

MESH = MeshShape(("data", "model"), (2, 2))
SEQ = 24


def _step(batch: int):
    """(the smoke step's StepCount at a global batch, the config, its
    layout's specs, rank 0's state bytes)."""
    cfg = dataclasses.replace(get_arch("qwen3-4b").smoke_cfg(), remat=False)
    rules = merged_rules(LM_TRAIN_RULES)
    with dryrun.fake_process_mesh(MESH) as mesh:
        lay = MeshLayout(cfg, mesh, rules)
        params = trainable(local_params(unstack_layers(abstract_params(lm_param_specs(cfg)),
                                                       cfg), lay.specs, mesh))
        state = TrainState(params, adamw_init(params), torch.empty((), dtype=torch.int32,
                                                                   device="meta"))
        spec = resolve_pspec(("batch", "seq"), (batch, SEQ), lay.lr)
        tok = torch.empty((batch, SEQ), dtype=torch.int32, device="meta")
        b = {"tokens": local_shard(tok, spec, mesh), "labels": local_shard(tok, spec, mesh)}
        fn = train_step_fn(lambda p, bb: loss_fn(p, bb, cfg, lay), AdamWConfig(), mesh=mesh,
                           specs=lay.specs)
        _, count = count_step(fn, (state, b), per_rank=True)
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params)) * 3 + 4 + 4
    return count, cfg, lay.specs, nbytes


def _reckoned(cfg, specs, batch: int) -> dict:
    """Each kind's output bytes of the step, by hand (float32 smoke config,
    rank 0 of (2, 2), B_loc = batch / 2 rows of SEQ)."""
    sizes = dict(zip(MESH.axes, MESH.sizes))
    rows = batch // sizes["data"] * SEQ  # tokens a rank
    d, V, Dh = cfg.d_model, cfg.vocab, cfg.head_dim
    f32 = 4

    def local(shape, spec):
        n = math.prod(sizes[a] for axes in layout(spec).values() for a in axes)
        return math.prod(shape) * f32 // n

    gathered = 0  # each leaf gathered over "data" once in the forward
    leaves = [("embed", (V, d), specs["embed"]), ("unembed", (d, V), specs["unembed"]),
              ("final_norm", (d,), specs["final_norm"])]
    shapes = {"wq": (d, cfg.n_heads * Dh), "wk": (d, cfg.n_kv_heads * Dh),
              "wv": (d, cfg.n_kv_heads * Dh), "wo": (cfg.n_heads * Dh, d),
              "w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d),
              "input_norm": (d,), "post_attn_norm": (d,), "q_norm": (Dh,), "k_norm": (Dh,)}
    for sp in specs["layers"]:
        flat = dict(sp["attn"], **sp["ffn"], input_norm=sp["input_norm"],
                    post_attn_norm=sp["post_attn_norm"])
        leaves += [(k, shapes[k], s) for k, s in flat.items()]
    for _, shape, spec in leaves:
        if "data" in layout(spec).get(0, ()) + layout(spec).get(1, ()):
            gathered += local(shape, spec) * sizes["data"]
    act = rows * d * f32  # one (B_loc, S, d) activation
    n_layers = cfg.n_layers
    reduce = (act  # the embedding's psum
              + n_layers * 2 * act  # attention's and the FFN's psums
              + 3 * rows * f32  # the loss head: max, sum of exps, the label's logit
              + 2 * f32  # the loss's psums over "data": summed NLL, token count
              # the backward: the entered activations (attention, FFN, loss head)
              + n_layers * 2 * act + act
              # q_norm and k_norm enter "data" (not split on it) and "model"
              + n_layers * 2 * 2 * Dh * f32
              + 2 * f32)  # the global norm: the ("data",) and ("data", "model") sets
    return {"all-gather": gathered, "all-to-all": gathered, "all-reduce": reduce}


def test_collective_bytes_equal_a_reckoning_by_hand():
    count, cfg, specs, _ = _step(2)
    want = _reckoned(cfg, specs, 2)
    assert count.collective_bytes_by_kind == {k: float(v) for k, v in want.items()}
    assert count.collective_bytes == sum(want.values())
    assert count.inter_node_bytes == 0.0  # four ranks: one node


def test_reckoned_peak_grows_with_the_local_batch():
    small, _, _, state = _step(2)
    large, _, _, _ = _step(4)
    assert 0 < small.temp_bytes < large.temp_bytes
    assert small.temp_bytes + state > state


@functools.lru_cache(maxsize=None)
def _record(arch: str, shape: str) -> dict:
    return dryrun.run_cell(arch, shape, "single", None)


@pytest.mark.parametrize("arch,shape", [("qwen3-4b", "train_4k"), ("pna", "ogb_products"),
                                        ("qwen3-4b", "decode_32k"), ("gemma2-27b", "long_500k")])
def test_production_cell_counted_as_rank_zero_of_256(arch, shape):
    rec = _record(arch, shape)
    r, m = rec["roofline"], rec["memory"]
    assert rec["status"] == "ok" and rec["counted_on"] == "rank0" and rec["meta"]["per_rank"]
    assert r["collective_bytes"] > 0 and r["t_collective_s"] > 0
    # a decode step has no backward: FSDP gathers, no reduce-scatter's all-to-all
    kinds = {"all-reduce", "all-gather"} if rec["kind"] == "decode" else \
        {"all-reduce", "all-to-all"}
    assert set(r["collectives"]) >= kinds
    assert m["temp_bytes"] > 0 and m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert "collective" in r["bottleneck_over"]
    assert "x None" not in dryrun.result_line(rec)


@pytest.mark.parametrize("arch,shape,want", [
    # layers x (k, v) x (B_loc, Hkv, S_loc, Dh) x bf16: the batch of 128 over
    # "data" (8 rows) and 32,768 positions over "model" (2,048), kv heads whole
    ("qwen3-4b", "decode_32k", 36 * 2 * (8 * 8 * 2048 * 128) * 2),
    # the batch of 1 whole, 524,288 positions over ("data", "model") (2,048)
    ("gemma2-27b", "long_500k", 46 * 2 * (1 * 16 * 2048 * 128) * 2),
])
def test_decode_cache_bytes_per_device(arch, shape, want):
    rec = _record(arch, shape)
    assert rec["memory"]["argument_bytes_by_arg"][1] == want


DECODE_B, DECODE_SMAX = 4, 48


def _decode_step():
    """(the smoke decode step's StepCount on rank 0 of (2, 2), the config,
    its layout's specs)."""
    cfg = get_arch("qwen3-4b").smoke_cfg()
    rules = merged_rules(LM_DECODE_RULES)
    with dryrun.fake_process_mesh(MESH) as mesh:
        lay = MeshLayout(cfg, mesh, rules)
        params = local_params(unstack_layers(abstract_params(lm_param_specs(cfg)), cfg),
                              lay.specs, mesh)
        kv = local_kv_cache(cfg, DECODE_B, DECODE_SMAX, lay, device="meta")
        tok = torch.empty((DECODE_B, 1), dtype=torch.int32, device="meta")
        tok = local_shard(tok, resolve_pspec(("batch", None), (DECODE_B, 1), lay.lr), mesh)
        _, count = count_step(lambda: serve_step(params, kv, tok, cfg, lay), (), per_rank=True)
    return count, cfg, lay.specs


def test_decode_collective_bytes_equal_a_reckoning_by_hand():
    count, cfg, specs = _decode_step()
    sizes = dict(zip(MESH.axes, MESH.sizes))
    rows = DECODE_B // sizes["data"]  # one token a row
    d, V, H, Hk, Dh, f = cfg.d_model, cfg.vocab, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.d_ff
    f32 = 4

    def local(shape, spec):
        n = math.prod(sizes[a] for axes in layout(spec).values() for a in axes)
        return math.prod(shape) * f32 // n

    shapes = {"wq": (d, H * Dh), "wk": (d, Hk * Dh), "wv": (d, Hk * Dh), "wo": (H * Dh, d),
              "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d), "input_norm": (d,),
              "post_attn_norm": (d,), "q_norm": (Dh,), "k_norm": (Dh,)}
    leaves = [((V, d), specs["embed"]), ((d, V), specs["unembed"]),
              ((d,), specs["final_norm"])]
    for sp in specs["layers"]:
        flat = dict(sp["attn"], **sp["ffn"], input_norm=sp["input_norm"],
                    post_attn_norm=sp["post_attn_norm"])
        leaves += [(shapes[k], s) for k, s in flat.items()]
    # each leaf split over "data" gathered whole along it (FSDP), once
    gathered = sum(local(shape, spec) * sizes["data"] for shape, spec in leaves
                   if "data" in sum(layout(spec).values(), ()))
    # and every layer's q activation, its heads gathered over "model"
    gathered += cfg.n_layers * rows * H * Dh * f32
    act = rows * d * f32  # one (B_loc, 1, d) activation
    stat = rows * H * f32  # the softmax's max or sum, a q head
    reduce = (act  # the embedding's psum over "model"
              # each layer: the max and the sum over kv_seq, the partial
              # outputs (float32), attention's and the FFN's psums
              + cfg.n_layers * (2 * stat + rows * H * Dh * f32 + 2 * act))
    assert count.collective_bytes_by_kind == {"all-gather": float(gathered),
                                              "all-reduce": float(reduce)}
    assert count.collective_bytes == gathered + reduce


def test_a_group_without_rank_zero_runs_no_op():
    with dryrun.fake_process_mesh(MESH) as mesh:
        others = dist.new_group([1, 2, 3])
        x = torch.empty(8, device="meta")
        _, none = count_step(lambda: dist.all_reduce(x, group=others), (), per_rank=True)
        _, one = count_step(lambda: dist.all_reduce(x, group=mesh.group("model")), (),
                            per_rank=True)
    assert none.collectives == {} and none.collective_bytes == 0
    assert one.collectives == {"all-reduce": 1} and one.collective_bytes == 8 * 4


def _din_reckoned(shape: str, mesh_kind: str) -> dict:
    """Each kind's output bytes of rank 0's DIN step, by hand: float32 at
    full width under DIN_RULES, the tables' rows and every width that
    divides over "model" split, the batch over ("pod", "data"), the
    retrieval candidates over "data" (10^6 does not divide by 256)."""
    from repro_torch.configs import din as conf
    from repro_torch.launch.mesh import make_production_mesh

    cfg, d = conf.model_cfg(), conf.SHAPES[shape]
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    sizes = dict(zip(mesh.axes, mesh.sizes))
    n, rows_ways, f32 = sizes["model"], sizes.get("pod", 1) * sizes["data"], 4
    e2, L = 2 * cfg.embed_dim, cfg.seq_len
    attn = (4 * e2,) + tuple(cfg.attn_hidden) + (1,)
    mlp = (2 * e2 + cfg.d_profile,) + tuple(cfg.mlp_hidden) + (1,)
    split = lambda dims: [i for i in range(len(dims) - 1) if dims[i + 1] % n == 0]  # noqa: E731
    if shape == "retrieval_cand":
        nc = d["n_candidates"] // sizes["data"]
        return {"all-reduce": (L + nc) * e2 * f32,  # the lookups: history, candidates
                "all-gather": sum(nc * mlp[i + 1] * f32 for i in split(mlp))}
    B = d["batch"] // rows_ways
    gather = sum(B * L * attn[i + 1] * f32 for i in split(attn)) + \
        sum(B * mlp[i + 1] * f32 for i in split(mlp))
    leaves = (cfg.n_items // n + cfg.n_cats // n) * cfg.embed_dim  # the tables' shards
    for dims in (attn, mlp):
        for i in range(len(dims) - 1):
            out = dims[i + 1] // n if i in split(dims) else dims[i + 1]
            leaves += dims[i] * out + out
    reduce = ((B * L + B) * e2 * f32  # the lookups' psums over "model"
              + 2 * f32  # the loss's psums over the batch axes
              # the backward: each split layer's entered input, every leaf
              # entering the batch axes, the global norm's "model" set
              + sum(B * L * attn[i] * f32 for i in split(attn))
              + sum(B * mlp[i] * f32 for i in split(mlp))
              + leaves * f32 + f32)
    return {"all-reduce": reduce, "all-gather": gather}


@functools.lru_cache(maxsize=None)
def _din_record(shape: str, mesh_kind: str) -> dict:
    return dryrun.run_cell("din", shape, mesh_kind, None)


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("shape", ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"])
def test_din_cell_counted_as_rank_zero(shape, mesh_kind):
    rec = _din_record(shape, mesh_kind)
    r, m = rec["roofline"], rec["memory"]
    assert rec["status"] == "ok" and rec["counted_on"] == "rank0" and rec["meta"]["per_rank"]
    assert rec["n_devices"] == (256 if mesh_kind == "single" else 512)
    assert r["collective_bytes"] > 0 and m["temp_bytes"] > 0
    assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    # the state a device holds: its shards of the tables, the MLPs whole or
    # split by column, its rows of the batch
    assert m["argument_bytes_by_arg"][0] < 18_000_000 and "x None" not in dryrun.result_line(rec)
    if shape in ("train_batch", "retrieval_cand"):
        want = _din_reckoned(shape, mesh_kind)
        assert rec["collective_bytes_by_kind"] == {k: float(v) for k, v in want.items()}
