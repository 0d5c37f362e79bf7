"""The port's visited-set layouts (`repro_torch.core.visited`) against the
reference's (`repro.core.visited`): every layout op, `init_search`, and
each expansion backend, on identical numpy inputs. Packed words compare by
bits (uint32 in the reference, int32 in the port)."""

import numpy as np
import pytest
import jax.numpy as jnp
from _hypothesis_compat import given, settings, strategies as st

from _torch_parity import n as np_of, t
from repro.core import visited as jv
from repro_torch import convert
from repro_torch.core import visited as tv

LAYOUTS = ("dense", "packed")


def _to_port(layout, x):
    return convert.words_to_torch(x, "cpu") if layout == "packed" else t(x)


def _from_port(layout, x):
    return convert.words_to_numpy(x) if layout == "packed" else np_of(x)


def _pair(rng, B, n):
    a, b = rng.random((B, n)) < 0.3, rng.random((B, n)) < 0.3
    return a, b


@settings(max_examples=20, deadline=None, database=None)
@given(st.integers(1, 5), st.integers(1, 150), st.integers(0, 10**6))
def test_layout_ops_match_reference(B, n, seed):
    rng = np.random.default_rng(seed)
    a, b = _pair(rng, B, n)
    queries = rng.integers(-1, n, B).astype(np.int32)
    for name in LAYOUTS:
        jl, tl = jv.get_visited_layout(name), tv.get_visited_layout(name)
        ja, jb = jl.from_dense(jnp.asarray(a)), jl.from_dense(jnp.asarray(b))
        ta, tb = tl.from_dense(t(a)), tl.from_dense(t(b))
        np.testing.assert_array_equal(_from_port(name, ta), np.asarray(ja))
        np.testing.assert_array_equal(np_of(tl.to_dense(ta, n)), a)
        np.testing.assert_array_equal(np_of(tl.count(ta)), np.asarray(jl.count(ja)))
        np.testing.assert_array_equal(_from_port(name, tl.union(ta, tb)), np.asarray(jl.union(ja, jb)))
        np.testing.assert_array_equal(_from_port(name, tl.minus(ta, tb)), np.asarray(jl.minus(ja, jb)))
        np.testing.assert_array_equal(np_of(tl.overlap_any(ta, tb)), np.asarray(jl.overlap_any(ja, jb)))
        np.testing.assert_array_equal(_from_port(name, tl.empty(B, n, "cpu")),
                                      np.asarray(jl.empty(B, n)))
        np.testing.assert_array_equal(_from_port(name, tl.seed(t(queries), n)),
                                      np.asarray(jl.seed(jnp.asarray(queries), n)))
        assert tl.nbytes_per_query(n) == jl.nbytes_per_query(n)
        assert tv.visited_nbytes(name, B, n) == jv.visited_nbytes(name, B, n)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n,F", [(33, 4), (142, 16), (64, 1)])
def test_init_search_matches_reference(layout, n, F):
    rng = np.random.default_rng(n + F)
    queries = rng.integers(-1, n, 6).astype(np.int32)
    queries[1] = n - 1  # the last id: the top bit of a word at n = 64
    jvis, jfront, jvalid = jv.get_visited_layout(layout).init_search(jnp.asarray(queries), n, F)
    tvis, tfront, tvalid = tv.get_visited_layout(layout).init_search(t(queries), n, F)
    np.testing.assert_array_equal(_from_port(layout, tvis), np.asarray(jvis))
    np.testing.assert_array_equal(np_of(tfront), np.asarray(jfront))
    np.testing.assert_array_equal(np_of(tvalid), np.asarray(jvalid))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("backend", ["scatter", "cuda", "auto"])
@pytest.mark.parametrize("B,F,W,n", [(2, 6, 5, 33), (3, 20, 8, 142), (1, 130, 4, 300)])
def test_expanders_match_reference_scatter(layout, backend, B, F, W, n):
    """Every port backend (on CPU tensors) == the reference scatter backend,
    including continuation-row ids >= n, stale entries past deg and
    all-padding rows. The port's expanders update in place."""
    rng = np.random.default_rng(B + F + W + n)
    rows = rng.integers(-1, n + 10, (B, F, W)).astype(np.int32)
    deg = rng.integers(0, W + 1, (B, F)).astype(np.int32)
    rows[:, 0] = -1
    deg[:, 0] = 0
    jl = jv.get_visited_layout(layout)
    mask = jl.from_dense(jnp.asarray(rng.random((B, n)) < 0.2))
    ref = jv.get_expand_backend("scatter", n, layout)(jnp.asarray(rows), jnp.asarray(deg), mask)
    tmask = _to_port(layout, np.asarray(mask))
    out = tv.get_expand_backend(backend, n, layout)(t(rows), t(deg), tmask)
    assert out is tmask
    np.testing.assert_array_equal(_from_port(layout, out), np.asarray(ref))


def test_unknown_names_raise():
    with pytest.raises(ValueError):
        tv.get_visited_layout("sparse")
    with pytest.raises(ValueError):
        tv.get_expand_backend("pallas", 10)
