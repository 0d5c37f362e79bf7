"""The port's embedding bag (`repro_torch.kernels.embedding_bag`,
`kernels.ops.embedding_bag`) against the reference's Pallas kernel in
interpret mode and its `embedding_bag_ref`, on identical numpy inputs, on
the CPU (where the wrapper runs its plain version); and the port's
`din_batch` against the reference's.

float32 tolerance 1e-5: both sum in float32, in another order. Ids >= V
are held against `embedding_bag_ref` only: its gather clamps them to the
last row, where the Pallas kernel in interpret mode gives NaN.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.configs import din as jdin_cfg
from repro.data.recsys import din_batch as jdin_batch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag as jbag
from repro_torch.data.recsys import din_batch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.embedding_bag import embedding_bag
from test_kernels import BAG_CASES

TOL = 1e-5


def _inputs(B, L, V, D, weighted, seed):
    """The draws of `test_kernels.test_embedding_bag_vs_ref`."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, L))
    idx[rng.random((B, L)) < 0.25] = -1
    w = rng.random((B, L)).astype(np.float32) if weighted else None
    return table, idx.astype(np.int32), w


def _port_all(table, idx, w, combine):
    """Every way the port computes the bag, on the same inputs."""
    tt, ti = torch.from_numpy(table), torch.from_numpy(idx)
    tw = None if w is None else torch.from_numpy(w)
    return {
        "wrapper": embedding_bag(tt, ti, tw, combine),
        "ops auto": ops.embedding_bag(tt, ti, tw, combine),
        "ops use_kernel=False": ops.embedding_bag(tt, ti, tw, combine, use_kernel=False),
        "plain": ref.embedding_bag_ref(tt, ti, tw, combine),
    }


def _reference(table, idx, w, combine, pallas=True):
    args = (jnp.asarray(table), jnp.asarray(idx), None if w is None else jnp.asarray(w))
    out = {"embedding_bag_ref": jref.embedding_bag_ref(*args, combine=combine),
           "ops use_pallas=False": jops.embedding_bag(*args, combine=combine, use_pallas=False)}
    if pallas:
        out["pallas interpret"] = jbag(*args, combine=combine, bb=32, interpret=True)
    return {k: np.asarray(v) for k, v in out.items()}


def _check(table, idx, w, combine, pallas=True, tol=TOL):
    refs = _reference(table, idx, w, combine, pallas)
    for what, out in _port_all(table, idx, w, combine).items():
        assert out.dtype == torch.float32 and out.shape == (idx.shape[0], table.shape[1]), what
        for name, expect in refs.items():
            np.testing.assert_allclose(out.numpy(), expect, atol=tol, rtol=tol,
                                       err_msg=f"{what} vs {name}")


@pytest.mark.parametrize("B,L,V,D,combine,weighted", BAG_CASES)
def test_embedding_bag_vs_pallas_interpret_and_ref(B, L, V, D, combine, weighted):
    _check(*_inputs(B, L, V, D, weighted, B * L), combine)


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_din_smoke_histories(combine, weighted):
    """DIN's smoke config (1024 items x 8) over `din_batch` histories
    (ragged, -1 tails), the lookup DIN's user vector makes."""
    cfg = jdin_cfg.smoke_cfg()
    hist = din_batch(0, 32, cfg.seq_len, cfg.n_items, cfg.n_cats, cfg.d_profile)["hist_items"]
    rng = np.random.default_rng(7)
    table = (0.01 * rng.standard_normal((cfg.n_items, cfg.embed_dim))).astype(np.float32)
    w = rng.random(hist.shape).astype(np.float32) if weighted else None
    assert (hist < 0).any() and (hist >= 0).any()
    _check(table, hist, w, combine)


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_all_padding_bags_are_zero(combine):
    table, idx, w = _inputs(6, 5, 20, 3, True, 1)
    idx[[0, 3]] = -1
    _check(table, idx, w, combine)
    out = embedding_bag(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w),
                        combine)
    assert not out[[0, 3]].any()


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_ids_past_the_table_read_the_last_row(combine):
    """[[0, -1, 7]] with V = 6: (row 0 + row 5) / 2 under "mean"."""
    table, idx, w = _inputs(5, 4, 6, 3, False, 2)
    idx[:, 2] = [7, 6, 100, -1, 6]
    _check(table, idx, None, combine, pallas=False)
    out = embedding_bag(torch.from_numpy(table), torch.tensor([[0, -1, 7]], dtype=torch.int32),
                        combine="mean")
    np.testing.assert_allclose(out[0].numpy(), (table[0] + table[5]) / 2, rtol=1e-6)


def test_one_bag_and_one_column():
    _check(*_inputs(1, 3, 9, 1, True, 3), "mean")


def test_bf16_table_keeps_its_dtype_within_one_ulp_of_pallas():
    table, idx, w = _inputs(40, 6, 50, 16, True, 4)
    bf = torch.from_numpy(table).to(torch.bfloat16)
    jtable = jnp.asarray(table).astype(jnp.bfloat16)
    for combine in ("sum", "mean"):
        pallas = np.asarray(jbag(jtable, jnp.asarray(idx), jnp.asarray(w), combine=combine,
                                 bb=8, interpret=True).astype(jnp.float32))
        for out in (embedding_bag(bf, torch.from_numpy(idx), torch.from_numpy(w), combine),
                    ops.embedding_bag(bf, torch.from_numpy(idx), torch.from_numpy(w), combine)):
            assert out.dtype == torch.bfloat16
            # one bf16 ulp of x is at most 2^-7 |x|
            np.testing.assert_allclose(out.float().numpy(), pallas, rtol=2**-7, atol=1e-30)


U16 = 2.0 ** -11  # float16 unit roundoff


@pytest.mark.parametrize("B,L,V,D,combine,weighted", BAG_CASES)
def test_float16_cpu_table_vs_reference(B, L, V, D, combine, weighted):
    """A float16 table on the CPU: the wrapper runs its plain version, which
    sums in float32 and rounds once to float16, so it is within U16 |x| of
    the exact bag x. The reference's plain path rounds the weights, each
    product and each partial sum to float16: within (L + 2) U16 sum_l
    |w row| of it, over the count for "mean", plus the division's and
    the output's rounding."""
    table, idx, w = _inputs(B, L, V, D, weighted, B * L + 16)
    t16 = table.astype(np.float16)
    expect = jops.embedding_bag(jnp.asarray(t16), jnp.asarray(idx),
                                None if w is None else jnp.asarray(w), combine=combine,
                                use_pallas=False)
    assert expect.dtype == jnp.float16
    ok = idx >= 0
    rows = t16[np.where(ok, idx, 0)].astype(np.float64)
    wl = np.where(ok, 1.0 if w is None else w.astype(np.float64), 0.0)[..., None]
    exact, absum = (wl * rows).sum(1), np.abs(wl * rows).sum(1)
    cnt = np.maximum(ok.sum(1), 1)[:, None] if combine == "mean" else 1
    exact, absum = exact / cnt, absum / cnt
    tol = (L + 2) * U16 * absum + 3 * U16 * np.abs(exact)
    tt, ti = torch.from_numpy(t16), torch.from_numpy(idx)
    tw = None if w is None else torch.from_numpy(w)
    for out in (embedding_bag(tt, ti, tw, combine), ops.embedding_bag(tt, ti, tw, combine),
                ops.embedding_bag(tt, ti, tw, combine, use_kernel=True)):
        assert out.dtype == torch.float16 and out.shape == (B, D)
        port = out.numpy().astype(np.float64)
        assert (np.abs(port - exact) <= U16 * np.abs(exact) + 1e-6 * absum).all()
        assert (np.abs(port - np.asarray(expect, np.float64)) <= tol).all()


@pytest.mark.parametrize("bad", ["int64 ids", "float64 table", "weights shape",
                                 "float64 weights", "combine", "empty table", "strided"])
def test_wrapper_input_checks(bad):
    table, idx, w = torch.zeros((5, 3)), torch.zeros((2, 4), dtype=torch.int32), None
    combine, err = "sum", ValueError
    if bad == "int64 ids":
        idx, err = idx.long(), TypeError
    elif bad == "float64 table":
        table, err = table.double(), TypeError
    elif bad == "weights shape":
        w = torch.ones((2, 3))
    elif bad == "float64 weights":
        w = torch.ones((2, 4), dtype=torch.float64)
    elif bad == "combine":
        combine = "max"
    elif bad == "empty table":
        table = torch.zeros((0, 3))
    else:
        table = torch.zeros((3, 5)).t()
    with pytest.raises(err):
        embedding_bag(table, idx, w, combine)


@pytest.mark.parametrize("step,batch,seed", [(0, 16, 0), (3, 7, 1), (11, 64, 5)])
def test_din_batch_equals_the_reference(step, batch, seed):
    kw = dict(seq_len=20, n_items=4096, n_cats=128, d_profile=4, seed=seed)
    port, expect = din_batch(step, batch, **kw), jdin_batch(step, batch, **kw)
    assert port.keys() == expect.keys()
    for k in expect:
        assert port[k].dtype == expect[k].dtype, k
        np.testing.assert_array_equal(port[k], expect[k], err_msg=k)


# The CUDA kernel (csrc/embedding_bag.cu) sums a bag in another order than
# the plain version: entry slot s of a warp takes the entries l = s mod S in
# ascending l, S = 32 / kLanes slots of kLanes lanes, and the slots are
# combined by a shuffle tree over lane offsets 16, 8, ..., kLanes. The test
# below holds a float32 emulation of that order, not the kernel (which
# runs only on the card, where chip_smoke.py holds it to the float64 plain
# version), within chip_smoke.py's bag tolerance, on DIN's histories. S is
# read from the kernel's source, so the emulation follows its lane count.
BAG_REL = 1e-6  # chip_smoke.py BAG_REL: the tolerance is BAG_REL * sum_l |w row|
BAG_CU = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/embedding_bag.cu"


def _slots() -> int:
    """S = 32 / kLanes: the kernel's entry slots a warp."""
    return 32 // int(re.search(r"constexpr int kLanes = (\d+);", BAG_CU.read_text()).group(1))


def _kernel_order(table, idx, w, combine):
    """float32, as the kernel: each product w * row rounded, each slot's sum
    in ascending l (padding adds 0 * 0), the slots' tree, then the mean's
    division."""
    B, L = idx.shape
    S = _slots()
    ok = idx >= 0
    x = torch.where(ok[..., None], table[idx.long().clamp(0, table.shape[0] - 1)], 0.0)
    wl = ok.float() if w is None else torch.where(ok, w, 0.0)
    prod = wl[..., None] * x  # (B, L, D), float32
    prod = torch.cat([prod, prod.new_zeros((B, -L % S, prod.shape[2]))], 1)
    prod = prod.view(B, -1, S, prod.shape[2])
    acc = torch.zeros((B, S, prod.shape[3]))
    for t in range(prod.shape[1]):
        acc = acc + prod[:, t]
    off = S // 2
    while off:
        acc = acc[:, :off] + acc[:, off:2 * off]
        off //= 2
    out = acc[:, 0]
    if combine == "mean":
        out = out / ok.sum(1, keepdim=True).clamp(min=1).float()
    return out


@pytest.mark.parametrize("D", [18, 1])
@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_kernel_summation_order_within_the_bag_tolerance(D, combine, weighted):
    """DIN's histories (L = 100, ragged -1 tails) over a table of std 0.01
    (din.param_specs), in the emulated order: at D = 18 (the serving width)
    and D = 1."""
    hist = din_batch(0, 512, n_items=1 << 16, n_cats=1024)["hist_items"]
    rng = np.random.default_rng(11)
    table = torch.from_numpy((0.01 * rng.standard_normal((1 << 16, D))).astype(np.float32))
    idx = torch.from_numpy(hist)
    w = torch.from_numpy(rng.random(hist.shape).astype(np.float32)) if weighted else None
    got = _kernel_order(table, idx, w, combine).double()
    w64 = None if w is None else w.double()
    exact = ref.embedding_bag_ref(table.double(), idx, w64, combine)
    tol = BAG_REL * ref.embedding_bag_ref(table.double().abs(), idx,
                                          None if w is None else w64.abs(), combine)
    share = float(((got - exact).abs() / tol.clamp(min=1e-300)).max())
    print(f"S = {_slots()}, D = {D}, {combine}{' weighted' if weighted else ''}: {share:.4f} of the "
          f"tolerance")
    assert share < 1
