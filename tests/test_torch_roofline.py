"""The port's roofline counters (`repro_torch.analysis.roofline`) and dry
run (`repro_torch.launch.dryrun`), on the CPU.

The counters run a step eagerly on `meta` tensors; here they are held
against counts written out by hand: the smoke LM's prefill and train step
(every product's flops and bytes), a module of gathers, scatters and a
sort, and the attention scores of the plain path, whole and by q chunks.
`RooflineReport`'s arithmetic is held against the reference's class with
the reference module's constants set to the H100's, for inputs without
collectives. The dry run's per-device state bytes are held against the
reference's own sharding specs.
"""

import math
import types

import pytest
import torch
import torch.nn.functional as F

from repro.analysis import roofline as rroof
from repro.configs import all_cells as r_all_cells
from repro.configs import din as rdin
from repro.distributed import mesh_utils as rmu
from repro.models import param as rparam
from repro_torch.analysis import roofline as roof
from repro_torch.configs import base, get_arch, qwen3_4b
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.param import abstract_params, param_pspecs
from repro_torch.optim.adamw import AdamWConfig

F32, I64 = 4, 8


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _mm_bytes(m, k, n, b=1):
    """Operand and output bytes of a float32 (b x) (m, k) @ (k, n)."""
    return b * (m * k + k * n + m * n) * F32


def _smoke_lm(B, S):
    """The smoke config's products: [(m, k, n, batch)] of one forward with
    the loss head over every position, and the attention's two bmm."""
    c = qwen3_4b.smoke_cfg()
    T_, d, H, Hk, Dh, f = B * S, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim, c.d_ff
    layer = [(T_, d, H * Dh, 1), (T_, d, Hk * Dh, 1), (T_, d, Hk * Dh, 1), (T_, H * Dh, d, 1),
             (T_, d, f, 1), (T_, d, f, 1), (T_, f, d, 1)]
    attn = [(S, Dh, S, B * H), (S, S, Dh, B * H)]  # q k^T, then p v
    return c, layer, attn


def test_smoke_prefill_counts():
    B, S = 2, 8
    c, layer, attn = _smoke_lm(B, S)
    ap = abstract_params(T.lm_param_specs(c))
    model = T.Transformer(c, T.unstack_layers(ap, c), device="meta")
    _, got = roof.count_step(model.prefill_forward, (_meta((B, S), torch.int32),), (S, S))
    head = (1, c.d_model, c.vocab, B)  # the last position's logits
    prods = c.n_layers * (layer + attn) + [head]
    assert got.flops == sum(2 * m * k * n * b for m, k, n, b in prods)
    assert got.flops_by_dtype == {"float32": got.flops}
    embed = c.vocab * c.d_model * F32 + B * S * I64 + B * S * c.d_model * F32
    assert got.major_bytes == embed + sum(_mm_bytes(*p) for p in prods)
    # q k^T's output and p v's p, (B H, S, S), in every layer
    assert got.score_bytes == c.n_layers * 2 * B * c.n_heads * S * S * F32
    assert got.bytes > got.major_bytes and got.peak() == "fp32"


def test_smoke_train_step_counts():
    """Forward, backward (each product's two gradients) and AdamW: the
    flops are three forwards with the loss head over every position; the
    backward adds each product's bytes twice, the cross entropy's scatter
    and the embedding's gradient."""
    B, S = 2, 8
    c, layer, attn = _smoke_lm(B, S)
    T_, V, d = B * S, c.vocab, c.d_model
    ap = abstract_params(T.lm_param_specs(c))
    state, _, _ = base.abstract_train_state(ap, param_pspecs(T.lm_param_specs(c)),
                                            lambda t: T.unstack_layers(t, c))
    fn = base.train_step_fn(lambda p, b: T.loss_fn(p, b, c), AdamWConfig(), schedule=True)
    batch = {"tokens": _meta((B, S), torch.int32), "labels": _meta((B, S), torch.int32)}
    _, got = roof.count_step(fn, (state, batch), (S, S))
    prods = c.n_layers * (layer + attn) + [(T_, d, V, 1)]
    assert got.flops == 3 * sum(2 * m * k * n * b for m, k, n, b in prods)
    embed = V * d * F32 + T_ * I64 + T_ * d * F32  # its gather, and its gradient's scatter
    pick = T_ * V * F32 + T_ * I64 + T_ * F32  # the label logits' gather
    unpick = 2 * T_ * V * F32 + T_ * I64 + T_ * F32  # its gradient's scatter_add
    assert got.major_bytes == 2 * embed + pick + unpick + 3 * sum(_mm_bytes(*p) for p in prods)
    # forward: two score tensors a layer; backward: dP out, P^T in (dV),
    # dS in (dQ) and dS^T in (dK)
    assert got.score_bytes == c.n_layers * 6 * B * c.n_heads * S * S * F32


def test_gathers_scatters_and_sorts():
    N, E, D, S = 50, 300, 6, 20

    def module(x, idx, seg):
        rows = x.index_select(0, idx)
        summed = torch.zeros(S, D, device=x.device).index_add_(0, seg, rows)
        top = torch.zeros(S, D, device=x.device).scatter_reduce_(
            0, seg[:, None].expand(E, D), rows, "amax", include_self=False)
        order = torch.sort(seg).indices
        return summed + top, F.embedding(idx, x), order

    args = (_meta((N, D)), _meta((E,), torch.int64), _meta((E,), torch.int64))
    _, got = roof.count_step(module, args)
    gather = N * D * F32 + E * I64 + E * D * F32
    index_add = 2 * S * D * F32 + E * I64 + E * D * F32
    scatter_reduce = 2 * S * D * F32 + E * D * I64 + E * D * F32
    sort = E * I64 + 2 * E * I64
    assert got.major_bytes == 2 * gather + index_add + scatter_reduce + sort
    assert got.flops == 0 and got.flops_by_dtype == {} and got.score_bytes == 0


def test_views_move_nothing_and_elementwise_is_eager_only():
    x = _meta((30, 40))
    _, got = roof.count_step(lambda a: (a.t() * 2).sum(), (x,))
    assert got.bytes == 2 * 30 * 40 * F32 + 30 * 40 * F32 + F32  # mul in, out; sum in, out
    assert got.major_bytes == 0


@pytest.mark.parametrize("S", [1024, 4096])  # 4096 x 4096 > 2048^2: by q chunks of 512
def test_attention_scores_whole_and_chunked(S):
    B, H, Hk, D = 1, 4, 2, 16
    q, k, v = _meta((B, H, S, D)), _meta((B, Hk, S, D)), _meta((B, Hk, S, D))
    _, got = roof.count_step(lambda a, b, c: ops.attention(a, b, c), (q, k, v), (S, S))
    assert got.flops == 2 * (2 * B * H * S * S * D)
    assert got.score_bytes == 2 * B * H * S * S * F32
    chunks = S // 512 if S * S > ops.CHUNK_ABOVE else 1
    rows = S // chunks
    # per chunk: q rows and k^T in, scores out; p in, v in, out
    per_chunk = B * H * (rows * D + D * S + rows * S + rows * S + S * D + rows * D) * F32
    assert got.major_bytes == chunks * per_chunk
    # a (4096, 4096) product that is no attention score is not tallied
    _, plain = roof.count_step(lambda a, b: a @ b, (_meta((S, S)), _meta((S, S))), (S, S))
    assert plain.score_bytes == 0


@pytest.fixture
def h100_reference(monkeypatch):
    """The reference's report class at the H100's constants, at a peak."""
    def use(peak):
        monkeypatch.setattr(rroof, "PEAK_FLOPS", roof.PEAK_FLOPS[peak])
        monkeypatch.setattr(rroof, "HBM_BW", roof.HBM_BW)
        monkeypatch.setattr(rroof, "ICI_BW", roof.NVLINK_BW)
        monkeypatch.setattr(rroof, "DCN_BW", roof.NODE_LINK_BW)
    return use


@pytest.mark.parametrize("peak", ["bf16", "fp32", "tf32"])
@pytest.mark.parametrize("flops,adj,score,state", [
    (4.1e16 / 256, 1.2e14 / 256, 7.9e13 / 256, 1.6e8),  # compute-bound
    (3.5e12 / 256, 6.5e11 / 256, 0.0, 5.0e8),  # memory-bound
    (0.0, 0.0, 0.0, 0.0),  # nothing counted
])
def test_report_arithmetic_equals_the_reference(h100_reference, peak, flops, adj, score,
                                                state):
    h100_reference(peak)
    kw = dict(arch="a", shape="s", mesh="16x16", n_devices=256, flops_per_device=flops,
              bytes_per_device=3 * adj, adj_bytes_per_device=adj,
              score_bytes_per_device=score, model_flops=0.67 * flops * 256,
              peak_state_bytes=state)
    ref = rroof.RooflineReport(**kw, collective_bytes=0.0, inter_pod_bytes=0.0,
                               peak_memory_bytes=0.0, collectives={})
    ours = roof.RooflineReport(**kw, collective_bytes=None, inter_pod_bytes=None,
                               peak_memory_bytes=None, collectives=None, peak=peak)
    assert ours.t_compute == ref.t_compute and ours.t_memory == ref.t_memory
    assert ours.t_memory_eager == ref.t_memory_hlo
    assert ours.useful_flops_fraction == ref.useful_flops_fraction
    assert ours.roofline_fraction == ref.roofline_fraction
    if flops or state:
        assert ours.bottleneck == ref.bottleneck
    row = ours.row()
    assert row["t_collective_s"] is None and row["bottleneck_over"] == ["compute", "memory"]
    assert row["flops_per_dev_even_split"] == flops and row["peak_flops"] == rroof.PEAK_FLOPS


def test_report_with_collectives_counts_both_links():
    r = roof.RooflineReport("a", "s", "2x16x16", 512, 1e12, 0.0, 0.0, 0.0, 9e9, 1e9, 1e15,
                            None, 0.0, {"all-reduce": 1}, peak="bf16")
    assert r.t_collective == 8e9 / roof.NVLINK_BW + 1e9 / roof.NODE_LINK_BW
    assert r.bottleneck == "collective"
    assert math.isclose(roof.model_flops_share(4.335e14, 3.44, "bf16"),
                        4.335e14 / (3.44 * 989e12))


def _ref_state_bytes(shapes_dtypes_specs, mesh):
    total = 0
    for shape, itemsize, spec in shapes_dtypes_specs:
        n = 1
        for entry in tuple(spec):
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                n *= mesh.shape[a]
        total += math.prod(shape) * itemsize // n
    return total


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_dryrun_state_bytes_follow_the_reference_specs(mesh_kind):
    """DIN at train_batch: parameters, AdamW's m and v (float32) and its
    int32 count, the int32 step and the batch, each leaf under the
    reference's spec; the step counted as rank 0's (its shards, its rows:
    above the even split of the model flops, since the whole layers repeat
    on every model rank), with its collectives and temporaries."""
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    rec = dryrun.run_cell("din", "train_batch", mesh_kind, None)
    cfg = rdin.model_cfg()
    lr = rmu.LogicalRules(types.SimpleNamespace(shape=mesh.shape),
                          base.merged_rules(rdin.DIN_RULES))
    specs = rdin.model.param_specs(cfg)
    pspecs = rparam.param_pspecs(specs, lr)
    leaves = [(s.shape, 4, p) for s, p in zip(
        [specs[k] for k in sorted(specs)], [pspecs[k] for k in sorted(pspecs)])]
    batch, bspecs = rdin._batch_abstract("train_batch", cfg, lr)
    want = 3 * _ref_state_bytes(leaves, mesh) + 4 + 4 + _ref_state_bytes(
        [(batch[k].shape, batch[k].dtype.itemsize, bspecs[k]) for k in batch], mesh)
    assert rec["status"] == "ok" and rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["state_fits_80gb"] and rec["memory"]["temp_bytes"] > 0
    assert rec["roofline"]["peak"] == "fp32" and rec["roofline"]["t_collective_s"] > 0
    assert rec["counted_on"] == "rank0"
    assert rec["counted_flops"] > rec["meta"]["model_flops"] / mesh.size > 0
    line = dryrun.result_line(rec)
    assert line.startswith(f"RESULT din train_batch {mesh.name}: state/dev=")
    assert "counted_flops=" in line and "t=(c " in line and "x None" not in line


def test_dryrun_cells_it_cannot_count_give_state_and_reason():
    rec = dryrun.run_cell("grouting", "serve_1hop", "single", None)
    rows = -(-int((1 << 22) * 1.25) // 16)
    want = (rows * 32 + 2 * rows + 2 * int((1 << 22) * 1.25)) * 4 + (1 << 22) * 10 * 4 \
        + 256 * 10 * 4 + 64 * 4 + (4 * 2048 * 4 + 2048 * 4 * 32 + 3) * 4
    assert rec["status"] == "state_only" and rec["counted_flops"] is None
    assert rec["memory"]["argument_bytes"] == want
    assert rec["meta"]["model_flops"] == 256 * 64 * 256 * 1 * 32
    assert "counted_flops=None (the serving step reads" in dryrun.result_line(rec)
    # ogb_products' sharded step runs over a process group: on a mesh that is
    # only a shape it is planned, not counted (the dry run counts it as rank 0
    # of a fake process group: tests/test_torch_dryrun_sharded.py)
    spec = get_arch("pna").build_dryrun("ogb_products", make_production_mesh())
    assert spec.fn is None and spec.meta["not_counted"] == base.NEEDS_PROCESS_MESH
    assert dryrun.run_cell("qwen3-4b", "long_500k", "single", None)["status"] == "skip"


def test_list_prints_the_reference_cells(capsys):
    assert dryrun.main(["--list"]) == 0
    want = [f"{name:18s} {cell.shape:16s} {cell.kind:10s} "
            f"{'SKIP: ' + cell.skip if cell.skip else ''}" for name, cell in r_all_cells()]
    assert capsys.readouterr().out.splitlines() == want
