"""DIN on a mesh: the port's per-rank `score`, `loss_fn`, train step and
`retrieval_scores` (`models/recsys/din.py` `MeshLayout`; `make_train_step`
with a mesh and specs) in 4 gloo ranks on the CPU, against the reference.

The smoke config under `DIN_RULES` on meshes (data, model) (2, 2), (1, 4),
(4, 1) and (pod, data, model) (2, 1, 2): the tables split by rows over
"model" (the decoupled storage tier, read through each row's owner), the
MLPs' columns over "model", the batch over ("pod", "data"), the retrieval
candidates over ("data", "model"). Case "1x4-whole" has widths that do not
split 4 ways (attention 80 / 42, main MLP 30 / 12), so some layers stay
whole on every model rank, as 200 and 40 do at full size on 16. The
retrieval batch has 64 candidates (split over "model" wherever it is over
1: ids that differ along "model", exchanged by owner) and 66 (on (2, 2)
they fall back to ("data",)). The ids include each block's first and last
row on 1, 2 and 4 model ranks, padding ids -1 in the histories and one -1
candidate. Parameters and batches are drawn with numpy
(`_sharded_cases.py`), the same on both sides.

Against the reference's unsharded functions (`_sharded_ref.py din`), each
rank's block of: the scores, the loss and every leaf's gradient (the
tables' shards: each row's gradient on its owner), after one AdamW step
(weight decay 0, the base rate) the loss and grad norm, m and v within
TOL of each leaf's max and the parameters within PARAM_TOL of it; the
retrieval scores within TOL. Against the reference's own sharded step and
retrieval jitted on (2, 2) as its dry run binds them: each rank's shards
of the parameters, m and v, and its block of the scores, within the same
tolerances; v, the squared gradient, within V_TOL. The largest readings
were 6.4e-6 (gradients, m), 1.3e-5 (v: a bias summed over every row),
2.7e-7 (scores, loss, retrieval) and 3.1e-7 of a leaf's max (parameters).
No step records an op that syncs with the host.
"""

import dataclasses

import numpy as np
import pytest

import _sharded_cases as C
import _torch_dist as D
import _torch_sharded as S
from _torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)

TOL = 1e-5
V_TOL = 2 * TOL  # v = (1 - b2) g^2: twice the gradient's relative error
PARAM_TOL = 1e-5
TIMEOUT_S = 300
SYNC_OPS = ("item", "_local_scalar_dense", "nonzero", "masked_select")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's values, [rank 0's, rank 1's, ...] of the port)."""
    finish = C.start_reference(["din"], tmp_path_factory.mktemp("din_ref"))
    port = D.spawn(S.din_mesh_all, C.WORLD, str(tmp_path_factory.mktemp("gloo")),
                   timeout=TIMEOUT_S)
    return finish()["din"], port


def _specs(name: str, n_candidates=None) -> dict:
    """{leaf: spec} of case `name`, "rows": the batch rows', "cand": the
    candidates'."""
    from repro_torch.configs.base import merged_rules
    from repro_torch.configs.din import DIN_RULES
    from repro_torch.distributed.mesh_utils import LogicalRules, resolve_pspec
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.param import param_pspecs
    from repro_torch.models.recsys.din import param_specs

    cfg, _, _, _ = S.din_case(name)
    shape, axes, _ = C.DIN_CASES[name]
    lr = LogicalRules(MeshShape(axes, shape), merged_rules(DIN_RULES))
    out = dict(param_pspecs(param_specs(cfg), lr))
    out["rows"] = resolve_pspec(("batch",), (C.DIN_B,), lr)
    if n_candidates:
        out["cand"] = resolve_pspec(("cand",), (n_candidates,), lr)
    return out


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of the max (tol {tol})"


@pytest.mark.parametrize("name", list(C.DIN_CASES))
def test_din_mesh_matches_reference_unsharded(runs, name):
    ref, port = runs
    shape, axes, _ = C.DIN_CASES[name]
    pre, specs = C.din_variant(name) + "/", _specs(name)
    blk = lambda x, spec, r: C.block(x, spec, r, shape, axes)  # noqa: E731
    for r, got in enumerate(port):
        got = got[name]
        _close(got["score"], blk(ref[pre + "score"], specs["rows"], r), TOL, f"{name} {r} score")
        for k in ("loss", "step/loss", "step/grad_norm"):
            _close(got[k], ref[pre + k], TOL, f"{name} rank {r} {k}")
        n = 0
        for key, want in ref.items():
            if not key.startswith(pre) or key.count("/") < 2 or "retrieval" in key:
                continue
            kind, leaf = key[len(pre):].split("/")
            if kind == "step":
                continue
            tol = {"p": PARAM_TOL, "v": V_TOL}.get(kind, TOL)
            _close(got[f"{kind}/{leaf}"], blk(want, specs[leaf], r), tol, f"{name} {r} {kind}/{leaf}")
            n += 1
        assert n == 4 * len(specs) - 4  # grad, p, m, v of every leaf
        for nc in C.DIN_CANDS:
            cand = _specs(name, nc)["cand"]
            _close(got[f"retrieval/{nc}"], blk(ref[f"{pre}retrieval/{nc}"], cand, r), TOL,
                   f"{name} rank {r} retrieval of {nc}")


def test_din_mesh_matches_reference_sharded_step(runs):
    """Each rank's shards after the step, and its block of the retrieval
    scores, against the devices' `addressable_shards` of the reference's
    step and retrieval jitted on (2, 2) under DIN_RULES."""
    ref, port = runs
    name = C.DIN_REF_SHARDED
    for r, got in enumerate(port):
        got = got[name]
        for k in ("loss", "grad_norm"):
            _close(got["step/" + k], ref["sharded/" + k], TOL, f"rank {r} {k}")
        n = 0
        for key, g in got.items():
            kind, _, leaf = key.partition("/")
            if kind not in ("p", "m", "v"):
                continue
            want = ref[f"sharded/{kind}/{leaf}/{r}"]
            assert want.shape == g.shape, (key, want.shape, g.shape)
            _close(g, want, {"p": PARAM_TOL, "v": V_TOL}.get(kind, TOL), f"rank {r} {key}")
            n += 1
        assert n == 3 * 14  # 14 leaves
        for nc in C.DIN_CANDS:
            want = ref[f"sharded/retrieval/{nc}/{r}"]
            assert want.shape == got[f"retrieval/{nc}"].shape
            _close(got[f"retrieval/{nc}"], want, TOL, f"rank {r} retrieval of {nc}")
    # candidates that split 4 ways over both axes; 66 over "data" alone
    assert str(ref["sharded/retrieval/64/spec"]) == "PartitionSpec(('data', 'model'),)"
    assert str(ref["sharded/retrieval/66/spec"]) == "PartitionSpec('data',)"
    assert str(port[0][name]["cand/64"]) == "('data', 'model')"
    assert str(port[0][name]["cand/66"]) == "('data',)"


@pytest.mark.parametrize("name,whole,split", [
    ("1x4-whole", ("attn_w1", "attn_b1", "attn_w2", "mlp_w0", "mlp_b0", "mlp_w2"),
     ("attn_w0", "attn_b0", "mlp_w1", "mlp_b1")),
    ("1x4", ("attn_w2", "attn_b2", "mlp_w2", "mlp_b2"),
     ("attn_w0", "attn_w1", "mlp_w0", "mlp_w1")),
])
def test_din_mesh_whole_and_split_layers(runs, name, whole, split):
    """The case's widths give both branches: whole layers (every model rank
    runs them alike) and layers split by column over "model"; the tables
    split by rows."""
    specs = _specs(name)
    assert all("model" not in str(specs[k]) for k in whole), {k: specs[k] for k in whole}
    assert all(specs[k][-1] == "model" for k in split), {k: specs[k] for k in split}
    assert specs["item_table"] == specs["cat_table"] == ("model", None)


def test_din_mesh_makes_no_host_sync_op(runs):
    _, port = runs
    for r, got in enumerate(port):
        for name in C.DIN_CASES:
            ops = set(got[name]["ops"])
            assert not ops.intersection(SYNC_OPS), (name, r, ops.intersection(SYNC_OPS))
            assert "embedding" in ops


def test_blocked_feature_gather_serves_every_request(runs):
    """DIN's `block_gather`, the table's blocks (rows 0-19 on model rank 0,
    20-39 on rank 1) read through the striped `sharded_feature_gather`, each
    rank asking for ids of its own at the
    budget of its whole request count: every request served with its row,
    -1 a zero row; each row's gradient (the sum of the features) lands on
    its owner, counting the requests for it on both ranks of the group."""
    _, port = runs
    table = np.arange(40 * 3, dtype=np.float32).reshape(40, 3)
    for r, got in enumerate(port):
        g = got["gather"]
        np.testing.assert_array_equal(g["served"], g["ids"] >= 0)
        want = np.where((g["ids"] >= 0)[:, None], table[np.maximum(g["ids"], 0)], 0)
        np.testing.assert_array_equal(g["feat"], want)
        group = [r - r % 2, r - r % 2 + 1]  # the ranks of r's model group
        asks = np.concatenate([port[q]["gather"]["ids"] for q in group])
        rows = np.arange(20 * (r % 2), 20 * (r % 2) + 20)
        counts = np.array([(asks == i).sum() for i in rows], np.float32)
        np.testing.assert_array_equal(g["grad"], np.repeat(counts[:, None], 3, 1))
