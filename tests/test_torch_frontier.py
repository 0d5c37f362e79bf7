"""The frontier kernels' plain versions and word-layout math against the
reference Pallas kernels (run in interpret mode on the CPU).

On CPU tensors the port's kernel wrappers run the plain versions
(`repro_torch.kernels.ref`), so these tests pin the plain versions, and
through `chip_smoke.py` on the card the kernels, to the reference: visited
sets and words must be bit-identical.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from _hypothesis_compat import given, settings, strategies as st

from _torch_parity import n as np_of, t
from repro.kernels import frontier as jfr
from repro_torch import convert
from repro_torch.kernels import frontier as tfr
from repro_torch.kernels import ref as tref

SHAPES = [  # (B, F, W, n): word seams, F not a multiple of 128, F > 128
    (2, 5, 7, 33), (3, 130, 9, 34), (1, 17, 3, 142), (4, 40, 16, 300),
    (2, 1, 1, 1),
]
# (B, F, W, n, rows): what a launch on the serving path looks like (the
# query engine's chain loop, one launch a link, rows (16, 4096, 64) at
# scale), cut to interpret-mode sizes: "sparse" (nearly every row padding,
# a few live rows of sorted ids: a hop's first link or a hub's continuation
# link), "beyond_n" (live rows whose ids are all >= n, beside sorted ones),
# "full" (deg == W in every live row); W = 1 and W = 64 across word seams
PATH_CASES = [
    (4, 256, 64, 1000, "sparse"), (2, 130, 64, 97, "sparse"), (3, 64, 9, 70, "beyond_n"),
    (2, 96, 64, 161, "beyond_n"), (3, 50, 16, 300, "full"), (2, 40, 1, 33, "full"),
    (2, 24, 64, 65, "full"), (4, 33, 1, 95, "sparse"),
]
CASES = [(*s, "random") for s in SHAPES] + PATH_CASES
CASE_IDS = ["-".join(map(str, c if c[-1] != "random" else c[:-1])) for c in CASES]


def _inputs(rng, B, F, W, n, rows_kind="random", frac_pad=0.25, p_vis=0.1):
    """"random": ids in [-1, n + 8): padding and ids >= n included; deg in
    [0, W] with stale entries past deg; some all-padding rows with deg 0 and
    some deg-0 rows that still hold ids (stale rows). The path kinds are
    described at PATH_CASES; their live rows hold sorted ids, as CSR rows do."""
    rows = rng.integers(-1, n + 8, (B, F, W)).astype(np.int32)
    deg = rng.integers(0, W + 1, (B, F)).astype(np.int32)
    if rows_kind == "random":
        pad = rng.random((B, F)) < frac_pad
        rows[pad] = -1
        deg[pad] = 0
        deg[rng.random((B, F)) < 0.1] = 0
        return rows, deg, rng.random((B, n)) < p_vis
    vis = rng.random((B, n)) < p_vis
    rows = np.sort(rng.integers(0, n, (B, F, W)), axis=-1).astype(np.int32)
    deg = rng.integers(1, W + 1, (B, F)).astype(np.int32)
    if rows_kind == "beyond_n":
        beyond = rng.random((B, F)) < 0.5
        rows[beyond] = np.sort(rng.integers(n, n + 64, (int(beyond.sum()), W)), axis=-1)
    if rows_kind == "full":
        deg[:] = W
    rows[np.arange(W) >= deg[..., None]] = -1  # -1 tails past deg
    pad = rng.random((B, F)) < (0.97 if rows_kind == "sparse" else 0.25)
    pad.flat[rng.integers(0, B * F)] = False  # at least one live row
    rows[pad] = -1
    deg[pad] = 0
    return rows, deg, vis


@pytest.mark.parametrize("B,F,W,n,rows_kind", CASES, ids=CASE_IDS)
def test_dense_plain_matches_pallas(B, F, W, n, rows_kind):
    rng = np.random.default_rng(B * 1000 + n)
    rows, deg, vis = _inputs(rng, B, F, W, n, rows_kind)
    # the reference caller masks ids >= n before its kernel (core/visited.py)
    ref = jfr.frontier_expand_batched(
        jnp.asarray(np.where(rows < n, rows, -1)), jnp.asarray(deg),
        jnp.asarray(vis), interpret=True)
    out = tfr.frontier_expand_batched(t(rows), t(deg), t(vis))
    np.testing.assert_array_equal(np_of(out), np.asarray(ref))
    # plain version called directly: the same, and in place
    vis_t = t(vis)
    assert tref.frontier_expand_batched_ref(t(rows), t(deg), vis_t) is vis_t
    np.testing.assert_array_equal(np_of(vis_t), np.asarray(ref))


@pytest.mark.parametrize("B,F,W,n,rows_kind", CASES, ids=CASE_IDS)
def test_packed_plain_matches_pallas(B, F, W, n, rows_kind):
    rng = np.random.default_rng(B * 1000 + n + 1)
    rows, deg, vis = _inputs(rng, B, F, W, n, rows_kind)
    words = np.asarray(jfr.pack_words(jnp.asarray(vis)))
    ref = jfr.frontier_expand_packed(jnp.asarray(rows), jnp.asarray(deg),
                                     jnp.asarray(words), n, interpret=True)
    out = tfr.frontier_expand_packed(t(rows), t(deg), convert.words_to_torch(words, "cpu"), n)
    np.testing.assert_array_equal(convert.words_to_numpy(out), np.asarray(ref))


def test_all_padded_frontier_is_noop():
    rng = np.random.default_rng(5)
    B, F, W, n = 3, 20, 8, 70
    rows = np.full((B, F, W), -1, np.int32)
    deg = np.zeros((B, F), np.int32)
    stale = rng.integers(0, n, (B, F, W)).astype(np.int32)  # ids, but deg 0
    vis = rng.random((B, n)) < 0.3
    for r in (rows, stale):
        out = tfr.frontier_expand_batched(t(r), t(deg), t(vis))
        np.testing.assert_array_equal(np_of(out), vis)
        words = tfr.pack_words(t(vis))
        out_w = tfr.frontier_expand_packed(t(r), t(deg), words.clone(), n)
        np.testing.assert_array_equal(np_of(out_w), np_of(words))


def test_single_query_view_matches_reference():
    rng = np.random.default_rng(7)
    rows, deg, vis = _inputs(rng, 1, 9, 5, 45)
    ref = jfr.frontier_expand(jnp.asarray(np.where(rows[0] < 45, rows[0], -1)),
                              jnp.asarray(deg[0]), jnp.asarray(vis[0]), interpret=True)
    out = tfr.frontier_expand(t(rows[0]), t(deg[0]), t(vis[0]))
    np.testing.assert_array_equal(np_of(out), np.asarray(ref))


def test_wrappers_reject_bad_inputs():
    rows = t(np.zeros((2, 3, 4), np.int32))
    deg = t(np.zeros((2, 3), np.int32))
    with pytest.raises(TypeError):
        tfr.frontier_expand_batched(rows.long(), deg, t(np.zeros((2, 8), bool)))
    with pytest.raises(TypeError):
        tfr.frontier_expand_packed(rows, deg, t(np.zeros((2, 1), np.int64)), 8)
    with pytest.raises(ValueError):
        tfr.frontier_expand_batched(rows, deg, t(np.zeros((3, 8), bool)))
    with pytest.raises(ValueError):
        tfr.frontier_expand_packed(rows, deg, t(np.zeros((2, 1), np.int32)), 33)
    with pytest.raises(ValueError):
        tfr.frontier_expand_batched(rows.transpose(1, 2).contiguous().transpose(1, 2),
                                    deg, t(np.zeros((2, 8), bool)))


@pytest.mark.parametrize("n", [0, 1, 70, 2**31 - 1, 2**31, 2**31 + 33])
def test_plain_in_range_past_int32(n):
    # the plain versions' id filter, at the widths where the CUDA kernels take
    # 64-bit indices (n >= 2**31 bits of a packed row)
    ids = np.array([-2**31, -1, 0, 1, 69, 70, 2**31 - 2, 2**31 - 1], np.int32)
    want = (ids.astype(np.int64) >= 0) & (ids.astype(np.int64) < n)
    np.testing.assert_array_equal(np_of(tref.in_range(t(ids), n)), want)


@settings(max_examples=25, deadline=None, database=None)
@given(st.integers(1, 4), st.integers(1, 200), st.integers(0, 10**6))
def test_pack_unpack_match_reference(B, n, seed):
    rng = np.random.default_rng(seed)
    dense = rng.random((B, n)) < 0.4
    ref_words = np.asarray(jfr.pack_words(jnp.asarray(dense)))
    words = tfr.pack_words(t(dense))
    assert words.dtype == torch.int32 and tuple(words.shape) == (B, tfr.n_words(n))
    np.testing.assert_array_equal(convert.words_to_numpy(words), ref_words)
    np.testing.assert_array_equal(
        np_of(tfr.unpack_words(convert.words_to_torch(ref_words, "cpu"), n)),
        np.asarray(jfr.unpack_words(jnp.asarray(ref_words), n)))
    np.testing.assert_array_equal(
        np_of(tfr.popcount(words)),
        np.array([bin(int(w)).count("1") for w in ref_words.reshape(-1)]).reshape(ref_words.shape))


@pytest.mark.parametrize("B,F,n", [(2, 16, 64), (4, 32, 300), (1, 8, 33)])
def test_density_predicates_match_reference(B, F, n):
    rng = np.random.default_rng(F + n)
    for hi in (1, 3, 12, 40):
        deg = rng.integers(0, hi, (B, F)).astype(np.int32)
        assert bool(tfr.dense_frontier(t(deg), n)) == bool(jfr.dense_frontier(jnp.asarray(deg), n))
        for p in (0.0, 0.5, 0.97):
            words = np.asarray(jfr.pack_words(jnp.asarray(rng.random((B, n)) < p)))
            assert bool(tfr.dense_frontier_packed(t(deg), convert.words_to_torch(words, "cpu"), n)) \
                == bool(jfr.dense_frontier_packed(jnp.asarray(deg), jnp.asarray(words), n))
