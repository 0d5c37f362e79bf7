"""The port's distributed full-graph GNN (`repro_torch.models.gnn.distributed`)
in 4 gloo ranks on the CPU at a (data, model) mesh of (2, 2), against the
reference's (`repro.models.gnn.distributed`, shard_map on 4 host devices)
and against the port's unsharded `loss_fn`.

tests/test_distributed.py's graph (`powerlaw_graph(120, 3)`, its features,
labels and positions), each arch's smoke config, parameters drawn with
numpy (`_sharded_cases.draw`), edge chunks of 128 and a roomy gather budget
(capacity_slack 256); and PNA at a budget of one request in four
(capacity_slack 1), which drops some. Held:

  - `prepare_dist_inputs`' arrays and `plan_dist_graph`'s shapes, bit for
    bit;
  - the gather's served masks, chunk by chunk, bit for bit (the tight case
    does drop requests);
  - the loss within 5e-5, every rank's gradients equal to each other and
    within 1e-4 of each leaf's max of the reference's for PNA, 2.5e-5 for
    the others (PNA's std view amplifies rounding: ROADMAP's zoo hazards);
  - at the roomy budget, the loss and gradients of the port's unsharded
    `loss_fn` on the same graph, to the same tolerances; PNA's in float64
    (the exact sums: in float32 the unsharded PNA's E[m^2] - E[m]^2, the
    reference's formula, stands 1.7e-4 of a leaf's max from them, the
    sharded one's shifted moments 3.8e-7).
"""

import numpy as np
import pytest
import torch

import _sharded_cases as C
import _torch_dist as D
import _torch_sharded as S
from _torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)

LOSS_TOL = 5e-5
GRAD_TOL = {"pna": 1e-4}  # of each leaf's max |gradient|
GRAD_TOL_DEFAULT = 2.5e-5
TIMEOUT_S = 300
CASES = list(C.GNN_CASES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({case: the reference's outputs}, {case: [rank 0's, ...] of the port})."""
    finish = C.start_reference([f"gnn:{c}" for c in CASES], tmp_path_factory.mktemp("gnn_ref"))
    by_rank = D.spawn(S.gnn_all, C.WORLD, str(tmp_path_factory.mktemp("gloo")),
                      timeout=TIMEOUT_S)
    ref = finish()
    return {c: ref[f"gnn:{c}"] for c in CASES}, {c: [r[c] for r in by_rank] for c in CASES}


def _hold_grads(got: dict, want: dict, arch: str, what: str):
    tol = GRAD_TOL.get(arch, GRAD_TOL_DEFAULT)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol * scale, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("case", CASES)
def test_dist_gnn_matches_reference(runs, case):
    ref, port = runs
    arch = C.GNN_CASES[case][0]
    want = {k: v for k, v in ref[case].items() if k.startswith("grad/")}
    for r, got in enumerate(port[case]):
        assert abs(float(got["loss"]) - float(ref[case]["loss"])) < LOSS_TOL, (case, r)
        _hold_grads(got, want, arch, f"{case} rank {r}")
        for k in want:  # replicated: every rank's gradient is the same
            np.testing.assert_array_equal(got[k], port[case][0][k], err_msg=f"{case} {k}")


@pytest.mark.parametrize("case", CASES)
def test_prepare_dist_inputs_and_plan_bit_for_bit(runs, case):
    ref, port = runs
    np.testing.assert_array_equal(port[case][0]["plan"], ref[case]["plan"])
    keys = {k for k in ref[case] if k.startswith("inputs/")}
    assert keys and keys == {k for k in port[case][0] if k.startswith("inputs/")}
    for k in keys:
        got, want = port[case][0][k], ref[case][k]
        assert got.dtype == want.dtype, (k, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_gather_served_masks_bit_for_bit(runs, case):
    ref, port = runs
    for r, got in enumerate(port[case]):
        np.testing.assert_array_equal(got["served"], ref[case]["served"][r],
                                      err_msg=f"{case} rank {r}")
    e_src = ref[case]["inputs/e_src"].reshape(ref[case]["served"].shape)
    e_dst = ref[case]["inputs/e_dst"].reshape(ref[case]["served"].shape)
    dropped = int(((e_src >= 0) & (e_dst >= 0) & ~ref[case]["served"]).sum())
    assert (dropped > 0) == (case == "pna-tight"), (case, dropped)


@pytest.mark.parametrize("arch", C.GNN_ARCHS)
def test_dist_gnn_matches_unsharded_loss(runs, arch):
    """The sharded loss at the roomy budget is the unsharded model's on the
    same graph, and so are its gradients (PNA's in float64)."""
    from repro_torch.graph.csr import csr_to_edge_index
    from repro_torch.graph.generators import powerlaw_graph
    from repro_torch.models.gnn import egnn, equiformer_v2, graphcast, pna
    from repro_torch.models.param import tree_map

    _, port = runs
    mod = {"egnn": egnn, "pna": pna, "graphcast": graphcast, "equiformer-v2": equiformer_v2}[arch]
    dtype = torch.float64 if arch == "pna" else torch.float32
    cfg, params = S.gnn_params(arch)
    params = tree_map(lambda p: p.detach().to(dtype).requires_grad_(), params)
    g = powerlaw_graph(**C.GNN_GRAPH)
    src, dst = csr_to_edge_index(g)
    feats, labels, pos = C.gnn_graph_inputs(cfg.d_in, cfg.n_out, g.n)
    batch = {"node_feat": torch.from_numpy(feats).to(dtype), "src": torch.from_numpy(src),
             "dst": torch.from_numpy(dst), "labels": torch.from_numpy(labels)}
    if C.gnn_needs_pos(arch):
        batch["node_pos"] = torch.from_numpy(pos)
    loss, _ = mod.loss_fn(params, batch, cfg)
    loss.backward()
    want = {f"grad/{k}": (np.zeros(v.shape) if v.grad is None else v.grad.numpy())
            for k, v in C.flatten(params).items()}
    got = port[arch][0]
    assert abs(float(got["loss"]) - loss.item()) < LOSS_TOL
    _hold_grads(got, want, arch, f"{arch} vs unsharded")


@pytest.mark.parametrize("with_pos", [False, True])
def test_plan_abstract_inputs_and_specs_match_the_reference(with_pos):
    """`plan_dist_graph`, `abstract_dist_inputs` and `dist_input_pspecs`
    field for field, shape for shape and spec for spec, at shapes where
    the edge chunk, the padding and the capacity floor each take effect."""
    import dataclasses

    from repro.models.gnn import distributed as ref
    from repro_torch.models.gnn import distributed as port

    for n, e, mesh, chunk, slack in ((120, 714, {"data": 2, "model": 2}, 128, 256),
                                     (2_449_029, 61_859_140, {"data": 2, "model": 2}, 32768, 4),
                                     (1000, 50, {"data": 1, "model": 4}, 32768, 1),
                                     (5000, 90_001, {"pod": 2, "data": 2, "model": 2}, 4096, 4)):
        axes = tuple(mesh)
        want = ref.plan_dist_graph(n, e, mesh, 100, 47, edge_chunk=chunk, capacity_slack=slack,
                                   axes=axes)
        got = port.plan_dist_graph(n, e, mesh, 100, 47, edge_chunk=chunk, capacity_slack=slack,
                                   axes=axes)
        # the reference's `unroll` sets its scan's unroll for dry-run counting;
        # the port streams the chunks in a Python loop and has no such knob
        want_fields = {k: v for k, v in dataclasses.asdict(want).items() if k != "unroll"}
        assert dataclasses.asdict(got) == want_fields
        a_ref = ref.abstract_dist_inputs(want, with_pos)
        a_port = port.abstract_dist_inputs(got, with_pos)
        assert a_port.keys() == a_ref.keys()
        for k, v in a_ref.items():
            assert tuple(a_port[k].shape) == tuple(v.shape), k
            assert str(a_port[k].dtype) == f"torch.{np.dtype(v.dtype).name}", k
        s_ref = ref.dist_input_pspecs(want, with_pos)
        s_port = port.dist_input_pspecs(got, with_pos)
        assert s_port == {k: tuple(v) for k, v in s_ref.items()}
