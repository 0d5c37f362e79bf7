"""The port's segment reductions (`repro_torch.kernels.segment_reduce`,
`kernels.ops`, `models.gnn.message_passing`) against the reference's, on
identical numpy inputs, on the CPU (where the wrappers run their plain
versions).

The reference's Pallas `segment_sum` does not run under jax 0.9.0 (it
calls `pl.load`, which that version lacks), so the port is held against
`repro.kernels.ref.segment_sum_ref` and `repro.kernels.ops.*(use_pallas=
False)`, the reference's own plain path. Sums are float32 in both, in
another order, hence the 1e-5 tolerance.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from _hypothesis_compat import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.gnn import message_passing as jmp
from repro_torch.kernels import ops, ref
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.segment_reduce import (TASK_EDGES, segment_order, segment_sum,
                                                segment_sum_sorted, segment_tasks)
from repro_torch.models.gnn import message_passing as tmp
from test_kernels import SEG_CASES

TOL = 1e-5
KINDS = ("sum", "mean", "max", "min", "std")


def _inputs(E, D, N, with_invalid, seed):
    """The draws of `test_kernels.test_segment_sum_vs_ref`."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((E, D)).astype(np.float32)
    seg = rng.integers(0, N, E)
    if with_invalid:
        seg[rng.random(E) < 0.2] = -1
    return vals, seg.astype(np.int32)


def _sorted(vals, seg):
    order = np.argsort(seg, kind="stable")
    return vals[order], seg[order]


def _close(port, expect, tol=TOL):
    assert port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), np.asarray(expect, np.float32), atol=tol, rtol=tol)


def _all_sums(vals, seg, N):
    """Every way the port computes a segment sum, on the same inputs."""
    tv, ts = torch.from_numpy(vals), torch.from_numpy(seg)
    sv, ss = _sorted(vals, seg)
    return {
        "segment_sum": segment_sum(tv, ts, N),
        "segment_sum int64 ids": segment_sum(tv, ts.long(), N),
        "segment_sum_sorted": segment_sum_sorted(torch.from_numpy(sv), torch.from_numpy(ss), N),
        "ops auto": ops.segment_sum(tv, ts, N),
        "ops use_kernel=False": ops.segment_sum(tv, ts, N, use_kernel=False),
        "plain": ref.segment_sum_ref(tv, ts, N),
    }


@pytest.mark.parametrize("E,D,N,with_invalid", SEG_CASES)
def test_segment_sum_vs_reference(E, D, N, with_invalid):
    vals, seg = _inputs(E, D, N, with_invalid, E + D)
    expect = np.asarray(jref.segment_sum_ref(jnp.asarray(vals), jnp.asarray(seg), N))
    np.testing.assert_array_equal(
        expect, np.asarray(jops.segment_sum(jnp.asarray(vals), jnp.asarray(seg), N,
                                            use_pallas=False)))
    for what, out in _all_sums(vals, seg, N).items():
        assert out.shape == (N, D), what
        _close(out, expect)


@pytest.mark.parametrize("E,D,N,with_invalid", SEG_CASES)
def test_segment_mean_max_min_vs_reference(E, D, N, with_invalid):
    vals, seg = _inputs(E, D, N, with_invalid, E * D)
    jv, js, tv, ts = jnp.asarray(vals), jnp.asarray(seg), torch.from_numpy(vals), torch.from_numpy(seg)
    expect = np.asarray(jref.segment_mean_ref(jv, js, N))
    np.testing.assert_allclose(np.asarray(jops.segment_mean(jv, js, N, use_pallas=False)),
                               expect, atol=TOL, rtol=TOL)
    for use_kernel in ("auto", True, False):
        _close(ops.segment_mean(tv, ts, N, use_kernel=use_kernel), expect)
    _close(ref.segment_mean_ref(tv, ts, N), expect)
    for name in ("segment_max", "segment_min"):
        out = getattr(ops, name)(tv, ts, N)
        np.testing.assert_array_equal(out.numpy(), np.asarray(getattr(jops, name)(jv, js, N)))


EDGE_CASES = {  # name -> (E, D, N, ids)
    "ids >= N dropped": (6, 3, 4, [0, 3, 4, -1, 7, 3]),
    "all -1": (5, 2, 3, [-1] * 5),
    "E = 1": (1, 4, 3, [2]),
    "D = 1": (40, 1, 6, None),
    "D = 129": (50, 129, 9, None),
    "sparse ids": (128, 4, 10_000, "sparse"),
    "E = 0": (0, 3, 4, []),
}


@pytest.mark.parametrize("name", EDGE_CASES)
def test_segment_sum_edge_cases(name):
    E, D, N, ids = EDGE_CASES[name]
    rng = np.random.default_rng(len(name))
    vals = rng.standard_normal((E, D)).astype(np.float32)
    if ids is None:
        ids = rng.integers(-1, N + 2, E)
    elif ids == "sparse":
        ids = rng.choice(N, size=E)
    seg = np.asarray(ids, np.int64).astype(np.int32)
    expect = np.asarray(jref.segment_sum_ref(jnp.asarray(vals), jnp.asarray(seg), N))
    for what, out in _all_sums(vals, seg, N).items():
        assert out.shape == (N, D), what
        _close(out, expect)
    mean = np.asarray(jops.segment_mean(jnp.asarray(vals), jnp.asarray(seg), N, use_pallas=False))
    _close(ops.segment_mean(torch.from_numpy(vals), torch.from_numpy(seg), N), mean)


def test_dropped_ids_and_empty_segments():
    """Ids [0, 3, 4, -1] with N = 4 count rows [1, 0, 0, 1]."""
    ones = torch.ones((4, 1))
    out = segment_sum(ones, torch.tensor([0, 3, 4, -1], dtype=torch.int32), 4)
    assert out[:, 0].tolist() == [1.0, 0.0, 0.0, 1.0]


def test_bf16_values_sum_in_float32():
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((200, 16)).astype(np.float32)
    seg = rng.integers(-1, 12, 200).astype(np.int32)
    bf = torch.from_numpy(vals).to(torch.bfloat16)
    expect = np.asarray(jref.segment_sum_ref(jnp.asarray(bf.float().numpy()), jnp.asarray(seg), 12))
    for out in (segment_sum(bf, torch.from_numpy(seg), 12),
                ops.segment_sum(bf, torch.from_numpy(seg), 12, use_kernel=False)):
        _close(out, expect)
    assert ops.segment_mean(bf, torch.from_numpy(seg), 12).dtype == torch.float32


def test_sorted_entry_point_takes_leading_minus_one_and_rejects_unsorted():
    vals = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    seg = torch.tensor([-1, -1, 0, 0, 2, 5], dtype=torch.int32)  # 5 >= N: dropped
    out = segment_sum_sorted(vals, seg, 3)
    assert out.tolist() == [[4.0 + 6.0, 5.0 + 7.0], [0.0, 0.0], [8.0, 9.0]]
    with pytest.raises(ValueError, match="sorted"):
        segment_sum_sorted(vals, seg.flip(0), 3)


def test_float64_plain_version_sums_in_float64():
    vals = torch.tensor([[1.0], [1e-10]], dtype=torch.float64)
    ids = torch.zeros(2, dtype=torch.int32)
    out = ref.segment_sum_ref(vals, ids, 1)
    assert out.dtype == torch.float64 and out.item() == 1.0 + 1e-10
    assert ref.segment_sum_ref(vals.float(), ids, 1).item() == 1.0  # float32 loses it


@settings(max_examples=25, deadline=None, database=None)
@given(st.integers(0, 60), st.integers(1, 6), st.integers(1, 20), st.integers(0, 10**6))
def test_segment_sum_matches_a_loop(E, D, N, seed):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((E, D)).astype(np.float32)
    seg = rng.integers(-2, N + 2, E).astype(np.int32)
    expect = np.zeros((N, D))
    for e in range(E):
        if 0 <= seg[e] < N:
            expect[seg[e]] += vals[e]
    for what, out in _all_sums(vals, seg, N).items():
        _close(out, expect)


@pytest.mark.parametrize("bad", ["values 1-D", "float64 values", "float ids", "length",
                                 "negative N", "strided"])
def test_wrapper_input_checks(bad):
    vals, seg, N = torch.zeros((4, 3)), torch.zeros(4, dtype=torch.int32), 2
    err = ValueError
    if bad == "values 1-D":
        vals = vals[:, 0]
    elif bad == "float64 values":
        vals, err = vals.double(), TypeError
    elif bad == "float ids":
        seg, err = seg.float(), TypeError
    elif bad == "length":
        seg = seg[:3]
    elif bad == "negative N":
        N = -1
    else:
        vals = torch.zeros((3, 4)).t()
    for fn in (segment_sum, segment_sum_sorted):
        with pytest.raises(err):
            fn(vals, seg, N)


# ---------------------------------------------------------------------------
# the kernel's task table and its two passes
# ---------------------------------------------------------------------------

# The CUDA kernel cannot run here, so its schedule is held here: the task
# table `segment_tasks` builds, decoded as the kernel decodes it, and a
# plain emulation of its two passes over that table.
SEG_REL, SEG_ABS = 1e-6, 1e-6  # chip_smoke.py seg_tol, against float64


def _lengths(picks, k, seed):
    """Segment lengths from picks: 0, k - 1, k, k + 1, 10 k, or small."""
    rng = np.random.default_rng(seed)
    named = (0, k - 1, k, k + 1, 10 * k)
    return [named[p] if p < len(named) else int(rng.integers(0, 3 * k)) for p in picks]


def _teams(offsets, n_edges, k):
    """The kernel's teams that run a task, in grid order, decoded from
    `segment_tasks` as the kernel decodes them: (segment, task j, begin,
    end, partial row), the row None where the segment is one task and its
    team writes the output row."""
    task_end = segment_tasks(offsets, k).numpy()
    offsets = offsets.numpy()
    n_chunks, n = 2 * -(-n_edges // k), len(offsets) - 1
    teams = []
    for team in range(n_chunks + n if n else 0):  # no segments: no launch
        if team >= n_chunks:  # a segment: its one task, unless it is long
            seg = team - n_chunks
            if offsets[seg + 1] - offsets[seg] <= k:
                teams.append((seg, 0, int(offsets[seg]), int(offsets[seg + 1]), None))
            continue
        if team >= task_end[-1]:  # a chunk team past the last task
            continue
        seg = int(np.searchsorted(task_end, team, side="right"))  # the kernel's binary search
        b, e = int(offsets[seg]), int(offsets[seg + 1])
        j = team - (int(task_end[seg]) - -(-(e - b) // k))
        begin = b + j * k
        teams.append((seg, j, begin, min(begin + k, e), team))
    return teams


def _two_passes(vals, order, offsets, k):
    """The kernel's schedule in float32: every team sums its edges (a partial
    row when its segment has several tasks), then each such segment sums its
    partial rows in task order. Rows never written stay NaN."""
    n, D = offsets.numel() - 1, vals.shape[1]
    out = np.full((n, D), np.nan, np.float32)
    partial = np.full((2 * -(-vals.shape[0] // k), D), np.nan, np.float32)
    rows = {}
    for seg, j, begin, end, row in _teams(offsets, vals.shape[0], k):
        s = np.add.reduce(vals[order[begin:end]], axis=0, dtype=np.float32)
        if row is None:
            out[seg] = s
        else:
            partial[row] = s
            rows.setdefault(seg, {})[j] = row
    for seg, by_task in rows.items():
        acc = np.zeros(D, np.float32)
        for j in range(len(by_task)):
            acc = acc + partial[by_task[j]]
        out[seg] = acc
    return out


@settings(max_examples=30, deadline=None, database=None)
@given(st.lists(st.integers(0, 7), min_size=0, max_size=12), st.integers(0, 2),
       st.integers(0, 3000), st.integers(0, 10**6))
def test_task_table_covers_every_kept_edge_once(picks, k_pick, n_dropped, seed):
    """Each kept edge in exactly one task; a segment's tasks contiguous and in
    order; no task over k edges; an empty segment one task of no edges (its
    zero row); at most N + ceil(E / k) tasks; partial rows distinct, within
    the workspace's 2 ceil(E / k)."""
    k = (TASK_EDGES, 7, 1)[k_pick]
    lengths = _lengths(picks, k, seed)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)]))
    n, kept = len(lengths), int(offsets[-1])
    E = kept + n_dropped
    teams = _teams(offsets, E, k)
    assert len(teams) <= n + -(-E // k)
    hits = np.zeros(E, np.int64)
    by_seg = {}
    for seg, j, begin, end, row in teams:
        assert 0 <= end - begin <= k
        hits[begin:end] += 1
        by_seg.setdefault(seg, []).append((j, begin, end, row))
    assert (hits[:kept] == 1).all() and (hits[kept:] == 0).all()
    partial_rows = [row for *_, row in teams if row is not None]
    assert len(set(partial_rows)) == len(partial_rows)
    assert all(0 <= r < 2 * -(-E // k) for r in partial_rows)
    assert sorted(by_seg) == list(range(n))
    for seg, tasks in by_seg.items():
        tasks.sort()
        L = lengths[seg]
        assert [j for j, *_ in tasks] == list(range(max(1, -(-L // k))))
        assert tasks[0][1] == offsets[seg] and tasks[-1][2] == offsets[seg + 1]
        assert all(a[2] == b[1] for a, b in zip(tasks, tasks[1:]))
        if L <= k:  # one task, which writes the output row (zeros if empty)
            assert tasks[0][3] is None
        else:       # partial rows in task order, one after another
            assert [r for *_, r in tasks] == list(range(tasks[0][3], tasks[0][3] + len(tasks)))


@settings(max_examples=20, deadline=None, database=None)
@given(st.lists(st.integers(0, 7), min_size=1, max_size=8), st.integers(0, 1),
       st.integers(1, 4), st.integers(0, 10**6))
def test_two_passes_over_the_task_table_match_the_plain_sum(picks, k_pick, D, seed):
    """The emulated schedule, on ids in any order with some dropped, is
    within chip_smoke.py's seg_tol of the float64 plain sum, writes every
    output row, and gives the same bits on a second call."""
    k = (TASK_EDGES, 7)[k_pick]
    lengths = _lengths(picks, k, seed)
    rng = np.random.default_rng(seed)
    n = len(lengths)
    ids = np.concatenate([np.repeat(np.arange(n), lengths),
                          rng.choice([-1, n, n + 3], size=int(rng.integers(0, 50)))])
    rng.shuffle(ids)
    vals = rng.standard_normal((len(ids), D)).astype(np.float32)
    seg = torch.from_numpy(ids.astype(np.int32))
    order, offsets = segment_order(seg, n)
    got = _two_passes(vals, order.numpy(), offsets, k)
    v64 = torch.from_numpy(vals).double()
    exact = ref.segment_sum_ref(v64, seg, n).numpy()
    tol = SEG_REL * ref.segment_sum_ref(v64.abs(), seg, n).numpy() + SEG_ABS
    assert not np.isnan(got).any()
    assert (np.abs(got - exact) <= tol).all()
    np.testing.assert_array_equal(got, _two_passes(vals, order.numpy(), offsets, k))


def test_task_table_of_one_segment_per_length():
    """Segments of 0, k - 1, k, k + 1, 2k, 2k + 1 and 10k edges: only those
    over k edges have tasks in the table, ceil(L / k) each."""
    k = TASK_EDGES
    lengths = [0, k - 1, k, k + 1, 2 * k, 2 * k + 1, 10 * k]
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(lengths)]))
    assert segment_tasks(offsets).tolist() == np.cumsum([0, 0, 0, 2, 2, 3, 10]).tolist()
    assert segment_tasks(torch.zeros(1, dtype=torch.int64)).numel() == 0


# ---------------------------------------------------------------------------
# message passing
# ---------------------------------------------------------------------------


def _graph(E=400, D=6, N=37, seed=0):
    rng = np.random.default_rng(seed)
    msgs = rng.standard_normal((E, D)).astype(np.float32)
    dst = rng.integers(0, N, E)
    dst[rng.random(E) < 0.1] = -1
    return msgs, dst.astype(np.int32), N


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("use_kernel", ["auto", False])
def test_aggregate_vs_reference(kind, use_kernel):
    msgs, dst, N = _graph()
    expect = jmp.aggregate(jnp.asarray(msgs), jnp.asarray(dst), N, kinds=(kind,),
                           use_pallas=False)[0]
    (out,) = tmp.aggregate(torch.from_numpy(msgs), torch.from_numpy(dst), N, kinds=(kind,),
                           use_kernel=use_kernel)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=TOL, rtol=TOL)


def test_aggregate_all_kinds_at_once_and_unknown_kind():
    msgs, dst, N = _graph(seed=1)
    expect = jmp.aggregate(jnp.asarray(msgs), jnp.asarray(dst), N, kinds=KINDS, use_pallas=False)
    out = tmp.aggregate(torch.from_numpy(msgs), torch.from_numpy(dst), N, kinds=KINDS)
    assert len(out) == len(KINDS)
    for a, b in zip(out, expect):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError):
        tmp.aggregate(torch.from_numpy(msgs), torch.from_numpy(dst), N, kinds=("median",))


def test_degree_vs_reference():
    _, dst, N = _graph(seed=2)
    dst[:5] = N + 3  # ids >= n are not counted
    expect = np.asarray(jmp.degree(jnp.asarray(dst), N))
    out = tmp.degree(torch.from_numpy(dst), N)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), expect)


@pytest.mark.parametrize("with_out_of_range", [False, True])
def test_segment_softmax_vs_reference(with_out_of_range):
    rng = np.random.default_rng(4)
    _, dst, N = _graph(seed=3)
    if with_out_of_range:
        dst[:7] = N + 1
    scores = (3 * rng.standard_normal((dst.shape[0], 4))).astype(np.float32)
    expect = np.asarray(jmp.segment_softmax(jnp.asarray(scores), jnp.asarray(dst), N))
    out = tmp.segment_softmax(torch.from_numpy(scores), torch.from_numpy(dst), N)
    np.testing.assert_allclose(out.numpy(), expect, atol=TOL, rtol=TOL)


def test_cpu_aggregate_counts_no_launch():
    msgs, dst, N = _graph(seed=5)
    before = dict(LAUNCHES)
    tmp.aggregate(torch.from_numpy(msgs), torch.from_numpy(dst), N, kinds=KINDS)
    assert dict(LAUNCHES) == before


# ---------------------------------------------------------------------------
# float16 on CPU tensors
# ---------------------------------------------------------------------------

# The port's wrappers run their plain version on float16 CPU tensors: it
# sums in float32 and returns float32 (the documented divergence from the
# reference's plain path, which sums in float16 and returns float16). So the
# port must equal the reference on float32 copies of the float16 values
# (TOL), and lie within the float16 rounding of the reference's own result:
# a sum of L terms in float16 rounds at most L - 1 partial sums, each by at
# most U16 * sum |v|, whatever the order.
U16 = 2.0 ** -11  # float16 unit roundoff


def _f16_bounds(h, seg, N):
    """Exact (float64) sum, mean and their float16 error bounds per (segment,
    column) for float16 values h: sum L * U16 * sum|v|; mean that over the
    count, plus the division's rounding."""
    ok = (seg >= 0) & (seg < N)
    v = h[ok].astype(np.float64)
    s, absum, cnt = np.zeros((N, h.shape[1])), np.zeros((N, h.shape[1])), np.zeros((N, 1))
    np.add.at(s, seg[ok], v)
    np.add.at(absum, seg[ok], np.abs(v))
    np.add.at(cnt, seg[ok], 1)
    s_tol = cnt * U16 * absum
    c = np.maximum(cnt, 1)
    mean, mean_tol = s / c, s_tol / c * (1 + U16) + U16 * np.abs(s / c)
    return s, s_tol, mean, mean_tol


def _within(port, expect16, exact, tol):
    """The port's float32 result within `tol` of the reference's float16."""
    assert port.dtype == torch.float32
    assert expect16.dtype == jnp.float16
    diff = np.abs(port.numpy().astype(np.float64) - np.asarray(expect16, np.float64))
    assert (diff <= tol).all(), float((diff - tol).max())
    np.testing.assert_allclose(port.numpy(), exact, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("E,D,N,with_invalid", SEG_CASES)
def test_float16_cpu_segment_sum_and_mean_vs_reference(E, D, N, with_invalid):
    vals, seg = _inputs(E, D, N, with_invalid, E + D + 16)
    h = vals.astype(np.float16)
    jh, js, th, ts = jnp.asarray(h), jnp.asarray(seg), torch.from_numpy(h), torch.from_numpy(seg)
    s, s_tol, mean, mean_tol = _f16_bounds(h, seg, N)
    ref_sum = jops.segment_sum(jh, js, N, use_pallas=False)
    ref_mean = jops.segment_mean(jh, js, N, use_pallas=False)
    sh, ss = _sorted(h, seg)
    sums = [segment_sum(th, ts, N), segment_sum_sorted(torch.from_numpy(sh), torch.from_numpy(ss), N)]
    for use_kernel in ("auto", True):
        sums.append(ops.segment_sum(th, ts, N, use_kernel=use_kernel))
        _within(ops.segment_mean(th, ts, N, use_kernel=use_kernel), ref_mean, mean, mean_tol)
    for out in sums:
        _within(out, ref_sum, s, s_tol)


@pytest.mark.parametrize("kind", KINDS)
def test_float16_cpu_aggregate_vs_reference(kind):
    """`aggregate` with use_kernel="auto" on float16 messages. Max and min
    stay float16 and equal the reference's. Std goes through the variance:
    m1 and m2 (of the float16 squares, rounded alike on both sides) within
    their mean bounds, the reference's m1^2, m2 - m1^2 and sqrt rounding
    each by U16 of their size."""
    msgs, dst, N = _graph(seed=6)
    h = msgs.astype(np.float16)
    expect = jmp.aggregate(jnp.asarray(h), jnp.asarray(dst), N, kinds=(kind,),
                           use_pallas=False)[0]
    (out,) = tmp.aggregate(torch.from_numpy(h), torch.from_numpy(dst), N, kinds=(kind,))
    s, s_tol, mean, mean_tol = _f16_bounds(h, dst, N)
    if kind in ("max", "min"):
        assert out.dtype == torch.float16 and expect.dtype == jnp.float16
        np.testing.assert_array_equal(out.numpy(), np.asarray(expect))
    elif kind == "sum":
        _within(out, expect, s, s_tol)
    elif kind == "mean":
        _within(out, expect, mean, mean_tol)
    else:
        _, _, m2, m2_tol = _f16_bounds(h * h, dst, N)
        var = np.maximum(m2 - mean * mean, 0)
        r = np.asarray(expect, np.float64)
        var_tol = (m2_tol + (2 * np.abs(mean) + mean_tol) * mean_tol
                   + 2 * U16 * (mean * mean + m2) + 3 * U16 * r * r + 1e-7)
        assert out.dtype == torch.float32 and expect.dtype == jnp.float16
        diff = np.abs(out.numpy().astype(np.float64) ** 2 - r * r)
        assert (diff <= var_tol).all(), float((diff - var_tol).max())
        np.testing.assert_allclose(out.numpy() ** 2, var + 1e-6, atol=TOL, rtol=TOL)
