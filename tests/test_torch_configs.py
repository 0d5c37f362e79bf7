"""The port's registry (`repro_torch.configs`) against the reference's
(`repro.configs`), on the CPU: the reference's `tests/test_configs.py`
case for case (10 assigned archs, 40 cells plus grouting's 3, the four
long_500k skips and their reasons, the exact config numbers), every cell's
merged logical rules, and the `meta` of every dry-run builder against the
reference's `build_dryrun(shape, make_host_mesh()).meta` (which builds its
shardings on the 1x1 host mesh and lowers nothing).
"""

import math

import pytest

from repro.configs import all_cells as r_all_cells
from repro.configs import get_arch as r_get_arch
from repro.configs.base import merged_rules as r_merged_rules
from repro.launch.mesh import make_host_mesh as r_make_host_mesh
from repro_torch.configs import ASSIGNED, all_cells, base, get_arch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.param import param_count
from repro_torch.models.transformer import lm_param_specs

META_KEYS = ("params", "tokens", "seq", "n_groups", "kind", "edges", "distributed")
FLOPS_RTOL = 1e-12


def test_ten_assigned_archs():
    assert len(ASSIGNED) == 10
    assert set(ASSIGNED) == {
        "qwen2-moe-a2.7b", "dbrx-132b", "qwen2.5-14b", "qwen3-4b", "gemma2-27b",
        "egnn", "pna", "equiformer-v2", "graphcast", "din",
    }


def test_forty_cells():
    cells = [(n, c) for n, c in all_cells(include_grouting=False)]
    assert len(cells) == 40
    skipped = [(n, c) for n, c in cells if c.skip]
    # long_500k skipped for the 4 pure full-attention LMs, runs for gemma2
    assert len(skipped) == 4
    assert all(c.shape == "long_500k" for _, c in skipped)
    assert {n for n, _ in skipped} == {
        "qwen2-moe-a2.7b", "dbrx-132b", "qwen2.5-14b", "qwen3-4b"}


def test_cells_are_the_references_in_order():
    """Every cell, grouting's included: name, shape, kind, skip reason and
    merged rules, in the reference's order (what `--list` prints)."""
    ours = [(n, c.shape, c.kind, c.skip, base.merged_rules(c.rules)) for n, c in all_cells()]
    ref = [(n, c.shape, c.kind, c.skip, r_merged_rules(c.rules)) for n, c in r_all_cells()]
    assert len(ours) == 43
    assert ours == ref


@pytest.mark.parametrize("spec", [
    ("qwen2-moe-a2.7b", dict(n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
                             d_ff=1408, vocab=151936, n_experts=60, top_k=4)),
    ("dbrx-132b", dict(n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
                       d_ff=10752, vocab=100352, n_experts=16, top_k=4)),
    ("qwen2.5-14b", dict(n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
                         d_ff=13824, vocab=152064, qkv_bias=True)),
    ("qwen3-4b", dict(n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
                      d_ff=9728, vocab=151936, qk_norm=True)),
    ("gemma2-27b", dict(n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
                        d_ff=36864, vocab=256000, window=4096,
                        attn_softcap=50.0)),
])
def test_lm_exact_numbers(spec):
    name, expect = spec
    cfg = get_arch(name).model_cfg()
    for k, v in expect.items():
        assert getattr(cfg, k) == v, (name, k, getattr(cfg, k), v)


def test_gnn_exact_numbers():
    egnn = get_arch("egnn").model_cfg("full_graph_sm")
    assert (egnn.n_layers, egnn.d_hidden) == (4, 64)
    pna = get_arch("pna").model_cfg("full_graph_sm")
    assert (pna.n_layers, pna.d_hidden) == (4, 75)
    eq = get_arch("equiformer-v2").model_cfg("full_graph_sm")
    assert (eq.n_layers, eq.d_hidden, eq.l_max, eq.m_max, eq.n_heads) == (12, 128, 6, 2, 8)
    gc = get_arch("graphcast").model_cfg("full_graph_sm")
    assert (gc.n_layers, gc.d_hidden, gc.n_vars, gc.mesh_refinement) == (16, 512, 227, 6)


def test_din_exact_numbers():
    cfg = get_arch("din").model_cfg()
    assert cfg.embed_dim == 18 and cfg.seq_len == 100
    assert cfg.attn_hidden == (80, 40) and cfg.mlp_hidden == (200, 80)


def test_gnn_shape_numbers():
    from repro_torch.configs.base import GNN_SHAPES

    assert GNN_SHAPES["full_graph_sm"]["n_nodes"] == 2708
    assert GNN_SHAPES["full_graph_sm"]["n_edges"] == 10556
    assert GNN_SHAPES["full_graph_sm"]["d_feat"] == 1433
    assert GNN_SHAPES["minibatch_lg"]["n_nodes"] == 232_965
    assert GNN_SHAPES["minibatch_lg"]["n_edges"] == 114_615_892
    assert GNN_SHAPES["minibatch_lg"]["batch_nodes"] == 1024
    assert GNN_SHAPES["minibatch_lg"]["fanout"] == (15, 10)
    assert GNN_SHAPES["ogb_products"]["n_nodes"] == 2_449_029
    assert GNN_SHAPES["ogb_products"]["n_edges"] == 61_859_140
    assert GNN_SHAPES["ogb_products"]["d_feat"] == 100
    assert GNN_SHAPES["molecule"] == dict(kind="train", n_nodes=30, n_edges=64,
                                          batch=128, d_feat=16)


def test_lm_shape_numbers():
    from repro_torch.configs.base import LM_SHAPES

    assert (LM_SHAPES["train_4k"]["seq"], LM_SHAPES["train_4k"]["batch"]) == (4096, 256)
    assert (LM_SHAPES["prefill_32k"]["seq"], LM_SHAPES["prefill_32k"]["batch"]) == (32768, 32)
    assert (LM_SHAPES["decode_32k"]["seq"], LM_SHAPES["decode_32k"]["batch"]) == (32768, 128)
    assert (LM_SHAPES["long_500k"]["seq"], LM_SHAPES["long_500k"]["batch"]) == (524288, 1)


def test_din_shape_numbers():
    from repro_torch.configs.din import SHAPES

    assert SHAPES["train_batch"]["batch"] == 65_536
    assert SHAPES["serve_p99"]["batch"] == 512
    assert SHAPES["serve_bulk"]["batch"] == 262_144
    assert SHAPES["retrieval_cand"]["n_candidates"] == 1_000_000


def test_smoke_cfgs_instantiate():
    for name in ASSIGNED + ["grouting"]:
        cfg = get_arch(name).smoke_cfg()
        assert cfg is not None


def test_param_counts_plausible():
    """Sanity: full configs land near their nameplate sizes."""
    dbrx = param_count(lm_param_specs(get_arch("dbrx-132b").model_cfg()))
    assert 115e9 < dbrx < 145e9, dbrx
    q3 = param_count(lm_param_specs(get_arch("qwen3-4b").model_cfg()))
    assert 3e9 < q3 < 5.5e9, q3
    g2 = param_count(lm_param_specs(get_arch("gemma2-27b").model_cfg()))
    assert 24e9 < g2 < 32e9, g2
    moe = param_count(lm_param_specs(get_arch("qwen2-moe-a2.7b").model_cfg()))
    assert 12e9 < moe < 17e9, moe  # 14.3B total (2.7B active)


@pytest.fixture(scope="module")
def ref_meshes():
    return r_make_host_mesh()


@pytest.mark.parametrize("name,shape", [(n, c.shape) for n, c in all_cells() if not c.skip])
def test_dryrun_meta_matches_the_reference(name, shape, ref_meshes):
    """Every runnable cell's builder: the reference's meta keys equal, the
    model flops within 1e-12 relative. ogb_products's step is not counted
    (the sharded full-graph step: four cards) and says so."""
    ours = get_arch(name).build_dryrun(shape, make_host_mesh()).meta
    ref = r_get_arch(name).build_dryrun(shape, ref_meshes).meta
    for k in META_KEYS:
        assert ours.get(k) == ref.get(k), (k, ours.get(k), ref.get(k))
    assert math.isclose(ours["model_flops"], ref["model_flops"], rel_tol=FLOPS_RTOL, abs_tol=0)
    assert ("not_counted" in ours) == (name == "grouting" or bool(ref.get("distributed")))
