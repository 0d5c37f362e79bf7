"""The decode step on a mesh: the port's per-rank `serve_step`
(`models/transformer.py`, `MeshLayout`, `local_kv_cache`,
`_mesh_decode_attention`) in 4 gloo ranks on the CPU, against the
reference.

The smoke configs in float32 (`_sharded_cases.DECODE_CASES`): Qwen3-4B
(qk-norm) under `LM_DECODE_RULES` at (data, model) (2, 2) and (1, 4) and
(pod, data, model) (2, 1, 2); Gemma2-27B (a window of 16 over blocks of 12,
both softcaps, post-norms) at (1, 4); Qwen2.5-14B (qkv bias) and
qwen2-moe's smoke config (`moe_ffn_expert_parallel` on the decode rows) at
(2, 2); Gemma2-27B under `LM_LONG_DECODE_RULES` at (2, 2): the batch of 1
whole, `kv_seq` over ("data", "model"). A cache of 48 positions drawn with
numpy at pos 22, then 4 steps, so the write crosses the block boundary at
24; the parameters, cache and tokens are the same on both sides.

Against the reference's unsharded `serve_step` (`_sharded_ref.py
decode-unsharded`), at each step, each rank's block of: the logits within
TOL of their max; the cache bit-equal outside the slots written so far and
the written slots within TOL of the leaf's max; pos. Against the
reference's own sharded decode (`_sharded_ref.py decode`: jitted on 4 host
devices with `bind_rules` and `NamedSharding`s, as its dry run binds it),
for Qwen3-4B (2, 2) and Gemma2 long (2, 2): each rank's logits and cache
against the device's `addressable_shards`, within TOL, and the cache's
spec equal. The largest readings were 2.1e-6 (logits) and 1.1e-6
(written cache slots, of the leaf's max) against the unsharded step, 1.5e-6
(logits) and 7.6e-7 (cache) against the sharded one. One more step a rank runs under a dispatch mode: no item, no
nonzero, no masked select (each a host sync on the card).
"""

import numpy as np
import pytest

import _sharded_cases as C
import _torch_dist as D
import _torch_sharded as S
from _torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)

TOL = 1e-5
TIMEOUT_S = 300
SYNC_OPS = ("item", "_local_scalar_dense", "nonzero", "masked_select")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's sharded decode's shards, its unsharded steps by
    variant, [rank 0's, rank 1's, ...] of the port)."""
    finish = C.start_reference(["decode", "decode-unsharded"],
                               tmp_path_factory.mktemp("decode_ref"))
    port = D.spawn(S.decode_mesh_all, C.WORLD, str(tmp_path_factory.mktemp("gloo")),
                   timeout=TIMEOUT_S)
    ref = finish()
    return ref["decode"], ref["decode-unsharded"], port


def _specs(name: str):
    """(the cache's spec, the logits' spec) of case `name`."""
    from repro_torch.distributed.mesh_utils import LogicalRules, resolve_pspec
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.transformer import kv_cache_pspecs, lm_local_pspecs

    arch, shape, axes, rules = C.DECODE_CASES[name]
    cfg = S.decode_case(name)[0]
    lr = LogicalRules(MeshShape(axes, shape), S.decode_rules(rules))
    B = C.DECODE_BATCH[rules]
    kv = kv_cache_pspecs(cfg, B, C.DECODE_SMAX, lr)["layers"][0]["k"]
    return kv, (resolve_pspec(("batch", None), (B, 1), lr)[0],
                lm_local_pspecs(cfg, lr)["unembed"][1])


def _err(got, want, scale=None) -> float:
    """The largest |got - want| over `scale` (default: want's max)."""
    scale = max(float(np.abs(want).max() if scale is None else scale), 1e-30)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = _err(got, want)
    assert err <= TOL, f"{what}: {err:.3g} of the max (tol {TOL})"


@pytest.mark.parametrize("name", list(C.DECODE_CASES))
def test_decode_matches_reference_unsharded(runs, name):
    _, unsharded, port = runs
    _, shape, axes, _ = C.DECODE_CASES[name]
    kv_spec, logit_spec = _specs(name)
    pre = C.decode_variant(name) + "/"
    seq_dim = 2
    for r, got in enumerate(port):
        got = got[name]
        for i in range(C.DECODE_STEPS):
            assert int(got[f"step{i}/pos"]) == int(unsharded[f"{pre}step{i}/pos"]) == \
                C.DECODE_POS + i + 1
            want = C.block(unsharded[f"{pre}step{i}/logits"], logit_spec, r, shape, axes)
            _close(got[f"step{i}/logits"], want, f"{name} rank {r} step {i} logits")
            # the global positions written so far, in this rank's block
            written = np.zeros(C.DECODE_SMAX, bool)
            written[C.DECODE_POS:C.DECODE_POS + i + 1] = True
            mine = C.block(written, (kv_spec[seq_dim],), r, shape, axes)
            for li in range(S.decode_case(name)[0].n_layers):
                for n in ("k", "v"):
                    key = f"step{i}/layers/{li}/{n}"
                    w = C.block(unsharded[pre + key], kv_spec, r, shape, axes)
                    g = got[key]
                    assert g.shape == w.shape, (key, g.shape, w.shape)
                    assert np.array_equal(g[:, :, ~mine], w[:, :, ~mine]), \
                        f"{name} rank {r} {key}: changed outside the written slots"
                    if mine.any():
                        err = _err(g[:, :, mine], w[:, :, mine], np.abs(w).max())
                        assert err <= TOL, f"{name} rank {r} {key}: written slots off by " \
                                           f"{err:.3g} of the leaf's max (tol {TOL})"


@pytest.mark.parametrize("name", C.DECODE_REF_SHARDED)
def test_decode_matches_reference_sharded_decode(runs, name):
    """Each rank's shards against the device's `addressable_shards` of the
    reference's decode jitted on (2, 2); the cache's spec equal."""
    ref, _, port = runs
    kv_spec, _ = _specs(name)
    spec = "PartitionSpec(" + ", ".join(repr(e) for e in kv_spec) + ")"
    assert str(ref[f"{name}/spec/k"]) == spec
    cfg = S.decode_case(name)[0]
    for r, got in enumerate(port):
        got = got[name]
        for i in range(C.DECODE_STEPS):
            keys = ["logits"] + [f"layers/{li}/{n}" for li in range(cfg.n_layers)
                                 for n in ("k", "v")]
            for k in keys:
                _close(got[f"step{i}/{k}"], ref[f"{name}/step{i}/{k}/{r}"],
                       f"{name} rank {r} step {i} {k}")
            assert int(ref[f"{name}/step{i}/pos"]) == C.DECODE_POS + i + 1


@pytest.mark.parametrize("name", list(C.DECODE_CASES))
def test_decode_step_makes_no_host_sync(runs, name):
    """pos is a host int: the owner of the write, the masks and the slices
    need no read of the device."""
    _, _, port = runs
    for r, got in enumerate(port):
        ops = set(got[name]["ops"])
        assert not ops.intersection(SYNC_OPS), (name, r, ops.intersection(SYNC_OPS))
        assert "bmm" in ops, ops  # the step ran under the mode


@pytest.mark.parametrize("kind,arch,seq,batch,axes,want", [
    ("decode", "qwen3-4b", 32768, 128, ("model",), (8, 8, 2048, 128)),
    ("long", "gemma2-27b", 524288, 1, ("data", "model"), (1, 16, 2048, 128)),
])
def test_cache_block_of_a_production_cell(kind, arch, seq, batch, axes, want):
    """`MeshLayout` resolves the `kv_seq` axes from the rules, rank 0's
    block index along them is 0, and `local_kv_cache` gives the block
    `kv_cache_pspecs` resolves on 16 x 16; a length the axes do not split
    raises."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.transformer import MeshLayout, local_kv_cache

    cfg = get_arch(arch).model_cfg()
    with dryrun.fake_process_mesh(make_production_mesh()) as mesh:
        lay = MeshLayout(cfg, mesh, S.decode_rules(kind))
        assert (lay.kv_seq_axes, lay.n_seq, lay.kv_block) == (axes, mesh.axis_size(axes), 0)
        kv = local_kv_cache(cfg, batch, seq, lay, device="meta")
        assert len(kv["layers"]) == cfg.n_layers
        assert all(tuple(layer[n].shape) == want and layer["pos"] == 0
                   for layer in kv["layers"] for n in ("k", "v"))
        with pytest.raises(ValueError, match="resolves to"):
            local_kv_cache(cfg, batch, seq + 8, lay, device="meta")
