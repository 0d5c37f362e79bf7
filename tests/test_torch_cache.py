"""The port's set-associative cache (`repro_torch.core.cache`) against the
reference's: the key hash over the full int32 range, and mixed
lookup/insert sequences -- including batches where more than n_ways new
keys land on one set, so (set, way) slots repeat and the reference's last
batch index wins -- must leave bit-identical tags, ages, rows, degrees,
continuations, clock and hit/miss counters."""

import numpy as np
import pytest
import jax.numpy as jnp
from _hypothesis_compat import given, settings, strategies as st

from _torch_parity import assert_fields_equal, n as np_of, t
from repro.core import cache as jc
from repro_torch import convert
from repro_torch.core import cache as tc


def test_hash_keys_full_int32_range():
    rng = np.random.default_rng(0)
    keys = np.concatenate([
        np.arange(0, 64), rng.integers(0, 2**31 - 1, 4000),
        np.array([2**31 - 1, 2**31 - 2, 2**30, 2**16, 2**16 - 1, 0x7FEB352D]),
    ]).astype(np.int32)
    for n_sets in (1, 3, 64, 4096, 1 << 20, 2**31 - 1):
        np.testing.assert_array_equal(
            np_of(tc._hash_keys(t(keys), n_sets)),
            np.asarray(jc._hash_keys(jnp.asarray(keys), n_sets)).astype(np.int64))


def _batch(rng, B, W, key_hi):
    keys = rng.integers(-1, key_hi, B).astype(np.int32)
    rows = rng.integers(-1, 500, (B, W)).astype(np.int32)
    degs = rng.integers(0, W + 1, B).astype(np.int32)
    conts = rng.integers(-1, 900, B).astype(np.int32)
    return keys, rows, degs, conts


def _run_sequence(seed, n_sets, n_ways, W, steps, B, key_hi, dedup):
    rng = np.random.default_rng(seed)
    js = jc.make_cache(n_sets, n_ways, W)
    ts = tc.make_cache(n_sets, n_ways, W, device="cpu")
    for step in range(steps):
        keys, rows, degs, conts = _batch(rng, B, W, key_hi)
        if dedup:  # the engine inserts deduped keys only
            _, first = np.unique(keys, return_index=True)
            keep = np.zeros(B, bool)
            keep[first] = True
            keys = np.where(keep, keys, -1)
        if step % 2 == 0:
            valid = keys >= 0
            if step % 4 == 0:
                valid &= rng.random(B) < 0.8
            jout = jc.cache_lookup(js, jnp.asarray(keys), jnp.asarray(valid))
            tout = tc.cache_lookup(ts, t(keys), t(valid))
            for a, b in zip(jout[:4], tout[:4]):
                np.testing.assert_array_equal(np.asarray(a), np_of(b))
            js, ts = jout[4], tout[4]
        else:
            js = jc.cache_insert(js, jnp.asarray(keys), jnp.asarray(rows),
                                 jnp.asarray(degs), jnp.asarray(conts))
            ts = tc.cache_insert(ts, t(keys), t(rows), t(degs), t(conts))
        assert_fields_equal(js, ts, what=f"step {step}")
    np.testing.assert_allclose(float(np_of(tc.hit_rate(ts))), float(jc.hit_rate(js)),
                               rtol=1e-6)
    return ts


@pytest.mark.parametrize("n_sets,n_ways,B,key_hi", [
    (4, 2, 32, 40),     # ~8 new keys per set per batch: slots repeat
    (1, 4, 16, 30),     # everything on one set
    (16, 4, 24, 200),
    (64, 8, 64, 100000),
])
def test_mixed_sequences_match_reference(n_sets, n_ways, B, key_hi):
    _run_sequence(n_sets * 7 + B, n_sets, n_ways, 5, 12, B, key_hi, dedup=True)


def test_colliding_batch_last_index_wins():
    """More than n_ways distinct new keys on one set in one batch."""
    js = jc.make_cache(1, 2, 3)
    ts = tc.make_cache(1, 2, 3, device="cpu")
    keys = np.array([10, 11, 12, 13, 14], np.int32)
    rows = np.arange(15, dtype=np.int32).reshape(5, 3)
    degs = np.full(5, 3, np.int32)
    conts = np.full(5, -1, np.int32)
    js = jc.cache_insert(js, *map(jnp.asarray, (keys, rows, degs, conts)))
    ts = tc.cache_insert(ts, *map(t, (keys, rows, degs, conts)))
    assert_fields_equal(js, ts)
    assert sorted(np_of(ts.tags).reshape(-1).tolist()) == [13, 14]


@settings(max_examples=15, deadline=None, database=None)
@given(st.integers(1, 8), st.integers(1, 4), st.integers(1, 40), st.integers(0, 10**6))
def test_random_sequences_match_reference(n_sets, n_ways, B, seed):
    _run_sequence(seed, n_sets, n_ways, 4, 6, B, 60, dedup=seed % 2 == 0)


def test_stacked_state_converts_bit_for_bit():
    js = jc.make_cache(8, 2, 4)
    js = jc.cache_insert(js, *map(jnp.asarray, (
        np.array([3, 9, -1], np.int32), np.ones((3, 4), np.int32),
        np.array([1, 2, 0], np.int32), np.array([-1, 40, -1], np.int32))))
    ts = convert.cache_state(js, "cpu")
    assert_fields_equal(js, ts)
    assert tc.cache_bytes(ts) == jc.cache_bytes(js)
