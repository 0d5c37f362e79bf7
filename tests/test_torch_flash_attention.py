"""The port's attention against the reference's, on the CPU.

On CPU tensors `repro_torch.kernels.flash_attention` runs its plain
version (`kernels.ref.attention_ref`), so these tests hold the plain
version -- the function the CUDA kernel is held to on the card by
`chip_smoke.py` -- against the Pallas kernel in interpret mode and against
the reference's `attention_ref`, over the case grid of
`tests/test_kernels.py`. Tolerances are that file's: 2e-5 in float32,
2e-2 in bfloat16 (the plain versions do their products in the input
dtype, the Pallas kernel in float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import ops, ref
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

ATTN_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal, window, softcap, dtype)
    (1, 2, 2, 128, 128, 64, True, None, None, "float32"),
    (2, 4, 2, 256, 256, 64, True, None, None, "float32"),  # GQA 2:1
    (1, 8, 1, 128, 128, 128, True, None, None, "float32"),  # MQA
    (1, 2, 2, 256, 256, 64, True, 128, None, "float32"),  # sliding window
    (1, 2, 2, 128, 128, 64, True, None, 50.0, "float32"),  # gemma softcap
    (1, 2, 2, 256, 256, 64, True, 64, 30.0, "float32"),  # window + softcap
    (1, 2, 2, 128, 128, 64, False, None, None, "float32"),  # bidirectional
    (2, 2, 2, 128, 128, 64, True, None, None, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(B, Hq, Hkv, Sq, Skv, D, dtype, seed=0):
    """The same numpy draws as jax arrays and as CPU tensors of `dtype`."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    jax_in = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    torch_in = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jax_in, torch_in


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_port_attention_vs_pallas_interpret_and_ref(case):
    B, Hq, Hkv, Sq, Skv, D, causal, window, softcap, dtype = case
    (q, k, v), (tq, tk, tv) = _inputs(B, Hq, Hkv, Sq, Skv, D, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = flash_attention(tq, tk, tv, **kw)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    tol = TOL[dtype]
    pallas = jflash(q, k, v, interpret=True, **kw)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(out), _np(jref.attention_ref(q, k, v, **kw)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, -128)])
def test_fully_masked_rows_give_the_mean_of_v(causal, window):
    """Windows that mask every key (kpos > qpos - window fails for all keys
    a row may see): the finite -1e30 mask makes every weight exp(0) = 1, so
    each row is mean(v), in the Pallas kernel and here."""
    (q, k, v), (tq, tk, tv) = _inputs(1, 4, 2, 128, 128, 32, "float32", seed=5)
    out = _np(flash_attention(tq, tk, tv, causal=causal, window=window))
    mean_v = np.repeat(np.asarray(v).mean(axis=2, keepdims=True), 2, axis=1)
    np.testing.assert_allclose(out, np.broadcast_to(mean_v, out.shape), atol=2e-5, rtol=2e-5)
    pallas = jflash(q, k, v, causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(out, _np(pallas), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape", [(2, 4, 2, 77, 77, 32), (1, 2, 1, 100, 130, 16),
                                   (1, 2, 2, 130, 100, 24)], ids=str)
@pytest.mark.parametrize("causal,window,softcap", [(True, None, None), (True, 40, 20.0),
                                                   (False, 50, None)])
def test_ragged_lengths_vs_reference(shape, causal, window, softcap):
    """Lengths the Pallas kernel cannot take (Sq, Skv not multiples of its
    block, Sq != Skv, a head dim of 24): the port against the reference's plain
    version, which takes any."""
    (q, k, v), (tq, tk, tv) = _inputs(*shape, "float32", seed=7)
    kw = dict(causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(_np(flash_attention(tq, tk, tv, **kw)),
                               _np(jref.attention_ref(q, k, v, **kw)), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("q_offset", [0, 96])
def test_ops_attention_plain_paths_match_the_reference(q_offset):
    """ops.attention on CPU tensors takes the plain path, as the
    reference's does off the TPU; with an offset, as in chunked prefill."""
    (q, k, v), (tq, tk, tv) = _inputs(1, 4, 2, 32, 128, 16, "float32", seed=3)
    kw = dict(causal=True, window=48, softcap=30.0, q_offset=q_offset)
    np.testing.assert_allclose(_np(ops.attention(tq, tk, tv, **kw)),
                               _np(jops.attention(q, k, v, **kw)), atol=2e-5, rtol=2e-5)


def test_chunked_and_unchunked_plain_paths_agree():
    """Sq * Skv > 2048**2 sends ops.attention to the q-chunked plain version;
    it equals the unchunked one and the reference's chunked version."""
    (q, k, v), (tq, tk, tv) = _inputs(1, 2, 1, 2560, 2560, 8, "float32", seed=4)
    chunked = ops.attention(tq, tk, tv, causal=True, window=700)
    whole = ops.attention(tq, tk, tv, causal=True, window=700, allow_chunk=False)
    np.testing.assert_allclose(_np(chunked), _np(whole), atol=2e-5, rtol=2e-5)
    expect = jref.attention_chunked_ref(q, k, v, causal=True, window=700)
    np.testing.assert_allclose(_np(chunked), _np(expect), atol=2e-5, rtol=2e-5)
    small = ref.attention_chunked_ref(tq[:, :, :256], tk, tv, chunk=64, q_offset=5)
    np.testing.assert_allclose(_np(small), _np(ref.attention_ref(tq[:, :, :256], tk, tv,
                                                                 q_offset=5)),
                               atol=2e-5, rtol=2e-5)


def test_wrapper_on_cpu_tensors_counts_no_launch():
    _, (tq, tk, tv) = _inputs(1, 2, 1, 64, 64, 16, "bfloat16")
    before = dict(LAUNCHES)
    flash_attention(tq, tk, tv)
    ops.attention(tq, tk, tv)
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("bad", ["head_dim", "gqa", "dtype", "contiguous", "softcap"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, (q, k, v) = _inputs(1, 4, 2, 16, 16, 16, "float32")
    kw = {}
    if bad == "head_dim":
        q, k, v = (torch.zeros(x.shape[:3] + (136,)) for x in (q, k, v))
    elif bad == "gqa":
        k, v = k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1)
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "contiguous":
        q = q.transpose(2, 3)
    else:
        kw = dict(softcap=0.0)
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, k, v, **kw)


# The CUDA kernel's bf16 route runs P @ V on the tensor cores with P split
# into two bf16 halves. This CPU emulation of its 64-key online softmax on
# bf16 inputs (causal, one head at a time) is why: P rounded once to bf16
# breaks chip_smoke.py's bf16 tolerance (ATTN_TOL), hi + lo does not.
SPLIT_SEQ, SPLIT_HEADS, SPLIT_DIM, SPLIT_KEYS = 2048, 2, 128, 64
BF16_TOL = (1e-3, 1e-2)  # chip_smoke.py ATTN_TOL[torch.bfloat16]


def _p_times_v(p, v, way):
    """P @ V in float32 with P as `way` rounds it (v is bf16-valued)."""
    if way == "float32":
        return p @ v
    hi = p.to(torch.bfloat16).float()
    if way == "bf16":
        return hi @ v
    return hi @ v + (p - hi).to(torch.bfloat16).float() @ v


def _online_softmax(q, k, v, way):
    """Causal attention of one (S, D) head by key tiles, as the kernel runs
    it: float32 sums, the finite mask, output rounded to bf16."""
    S, D = q.shape
    rows = torch.arange(S)[:, None]
    m = torch.full((S, 1), ref.MASK_VALUE)
    l = torch.zeros((S, 1))
    acc = torch.zeros((S, D))
    for k0 in range(0, S, SPLIT_KEYS):
        s = (q @ k[k0:k0 + SPLIT_KEYS].T) * D ** -0.5
        s = torch.where(torch.arange(k0, k0 + s.shape[1])[None, :] > rows, ref.MASK_VALUE, s)
        m_new = torch.maximum(m, s.amax(1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(1, keepdim=True)
        acc = acc * alpha + _p_times_v(p, v[k0:k0 + SPLIT_KEYS], way)
        m = m_new
    return (acc / l).to(torch.bfloat16).double()


def test_split_p_holds_the_bf16_tolerance_where_one_rounding_does_not():
    """Against float64, worst |err| over the bf16 tolerance and the share of
    elements over it: one bf16 rounding of P exceeds the tolerance, the two
    halves stay as far inside it as float32 P does."""
    rng = np.random.default_rng(0)
    shape = (SPLIT_HEADS, SPLIT_SEQ, SPLIT_DIM)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16).float() for _ in range(3))
    causal = torch.ones((SPLIT_SEQ, SPLIT_SEQ), dtype=torch.bool).triu(1)
    worst, over = {}, {}
    for h in range(SPLIT_HEADS):
        qd, kd, vd = q[h].double(), k[h].double(), v[h].double()
        s = (qd @ kd.T * SPLIT_DIM ** -0.5).masked_fill(causal, float("-inf"))
        exact = torch.softmax(s, dim=1) @ vd
        tol = BF16_TOL[0] + BF16_TOL[1] * exact.abs()
        for way in ("float32", "bf16", "split"):
            ratio = (_online_softmax(q[h], k[h], v[h], way) - exact).abs() / tol
            worst[way] = max(worst.get(way, 0.0), float(ratio.max()))
            over[way] = over.get(way, 0) + int((ratio > 1).sum())
    assert worst["bf16"] > 1 and over["bf16"] > 0
    assert worst["split"] < 0.5 and over["split"] == 0
    assert worst["split"] <= 1.01 * worst["float32"]


# ---------------------------------------------------------------------------
# gradients: the autograd path on CPU tensors, and the backward kernel's
# tiled algorithm (csrc/flash_attention_bwd.cu) emulated in float64
# ---------------------------------------------------------------------------

GRAD_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal, window, softcap)
    (1, 2, 2, 96, 96, 32, True, None, None),
    (2, 6, 2, 70, 70, 16, True, 24, 20.0),  # GQA 3:1, window and softcap
    (1, 2, 1, 130, 50, 16, True, 16, None),  # Sq > Skv: rows 65.. see no key
    (1, 2, 2, 40, 100, 16, False, None, 5.0),  # bidirectional, Sq < Skv
    (1, 2, 2, 150, 40, 16, False, 30, None),  # bidirectional window, masked rows
]
GRAD_TOL = 2e-5  # float32, against the reference's jax.grad, of max |grad|


def _grad_inputs(case, dtype=np.float32, seed=0):
    B, Hq, Hkv, Sq, Skv, D = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype)
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D), (B, Hq, Sq, D))]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cpu_gradients_match_jax_grad_of_the_reference(case):
    """`ops.attention`'s gradients on CPU tensors (autograd through the plain
    version, as the wrapper's) and `flash_attention_bwd`'s CPU path against
    jax.grad of the reference's `attention_ref`."""
    import jax

    causal, window, softcap = case[6:]
    q, k, v, do = _grad_inputs(case)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c, **kw), q, k, v)
    want = vjp(do)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.attention(tq, tk, tv, **kw)
    out.backward(torch.from_numpy(do))
    direct = flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(), out.detach(),
                                 torch.from_numpy(do), **kw)
    for g, d, w in zip((tq.grad, tk.grad, tv.grad), direct, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_TOL * np.abs(w).max())
        assert torch.equal(g, d)


def _key_lo(q, window):
    return 0 if window is None else max(q - window + 1, 0)


def _key_hi(q, Skv, causal):
    return min(q + 1, Skv) if causal else Skv


def _bf16_operand(x, way):
    """x as a bf16 operand of the tensor cores: rounded once ("bf16") or as
    two halves hi + lo ("split"), hi = bf16(x) and lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi if way == "bf16" else hi + (x - hi).to(torch.bfloat16).to(x.dtype)


def _emulate_bwd(q, k, v, do, causal, window, softcap, tile=64, rounding=None, out=None):
    """The kernel's three passes over 64-row tiles, in float64: statistics
    (row max, 1 / denominator over the key tiles a q tile visits; Delta =
    dO . O), then dK / dV over the q tiles each key tile is visited by, then
    dQ; dU = P (dP - Delta) (1 - tanh^2), zero where masked, and the scale
    on the sums of dK and dQ. `rounding` (P's way, dU's way), as
    `_bf16_operand` takes them, rounds those operands before their
    products, as the bf16 route does, and rounds the outputs to bf16; None
    rounds nothing. `out` is the forward's output (default: float64)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group, scale = Hq // Hkv, D ** -0.5
    masked_row = lambda r: _key_lo(r, window) >= _key_hi(r, Skv, causal)
    p_op, du_op = ((lambda x, w=w: x if w is None else _bf16_operand(x, w))
                   for w in rounding or (None, None))

    def key_tiles(q0, q1):  # [q0, q1) rows
        lo, hi = _key_lo(q0, window), _key_hi(q1 - 1, Skv, causal)
        if masked_row(q1 - 1):
            lo, hi = 0, Skv
        return range(lo // tile, -(-hi // tile) if hi > lo else lo // tile)

    def visits(q0, q1, k0):  # does q tile [q0, q1) visit keys [k0, k0 + tile)?
        if masked_row(q1 - 1):
            return True
        first = max(q0, k0) if causal else q0
        return first <= q1 - 1 and _key_lo(first, window) < k0 + tile and \
            _key_hi(first, Skv, causal) > k0

    def tile_terms(b, h, q0, q1, k0, k1, m, rl, delta):
        qs, ks = torch.arange(q0, q1)[:, None], torch.arange(k0, k1)[None, :]
        u = (q[b, h, q0:q1] @ k[b, h // group, k0:k1].T) * scale
        x, dt = u, torch.ones_like(u)
        if softcap is not None:
            t = torch.tanh(u / softcap)
            x, dt = softcap * t, 1 - t * t
        mask = torch.zeros_like(u, dtype=torch.bool)
        if causal:
            mask |= ks > qs
        if window is not None:
            mask |= ks <= qs - window
        x = torch.where(mask, torch.full_like(x, ref.MASK_VALUE), x)
        if m is None:
            return x
        p = torch.exp(x - m[q0:q1, None]) * rl[q0:q1, None]
        dp = do[b, h, q0:q1] @ v[b, h // group, k0:k1].T
        du = torch.where(mask, 0.0, p * (dp - delta[q0:q1, None]) * dt)
        return p, du

    o = ref.attention_ref(q, k, v, causal=causal, window=window, softcap=softcap) \
        if out is None else out
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    stats = {}
    for b in range(B):
        for h in range(Hq):
            m = torch.full((Sq,), ref.MASK_VALUE, dtype=q.dtype)
            l = torch.zeros((Sq,), dtype=q.dtype)
            for q0 in range(0, Sq, tile):
                q1 = min(q0 + tile, Sq)
                for t in key_tiles(q0, q1):
                    x = tile_terms(b, h, q0, q1, t * tile, min(t * tile + tile, Skv), None,
                                   None, None)
                    mx = torch.maximum(m[q0:q1], x.amax(1))
                    l[q0:q1] = l[q0:q1] * torch.exp(m[q0:q1] - mx) + \
                        torch.exp(x - mx[:, None]).sum(1)
                    m[q0:q1] = mx
            stats[b, h] = (m, 1 / l, (do[b, h] * o[b, h]).sum(1))
        for hk in range(Hkv):
            for k0 in range(0, Skv, tile):
                k1 = min(k0 + tile, Skv)
                for h in range(hk * group, (hk + 1) * group):
                    for q0 in range(0, Sq, tile):
                        q1 = min(q0 + tile, Sq)
                        if visits(q0, q1, k0):
                            p, du = tile_terms(b, h, q0, q1, k0, k1, *stats[b, h])
                            dv[b, hk, k0:k1] += p_op(p).T @ do[b, h, q0:q1]
                            dk[b, hk, k0:k1] += du_op(du).T @ q[b, h, q0:q1]
        for h in range(Hq):
            for q0 in range(0, Sq, tile):
                q1 = min(q0 + tile, Sq)
                for t in key_tiles(q0, q1):
                    k0, k1 = t * tile, min(t * tile + tile, Skv)
                    _, du = tile_terms(b, h, q0, q1, k0, k1, *stats[b, h])
                    dq[b, h, q0:q1] += du_op(du) @ k[b, h // group, k0:k1]
    grads = dq * scale, dk * scale, dv
    if rounding is None:
        return grads
    return tuple(g.to(torch.bfloat16).to(q.dtype) for g in grads)


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_tiled_backward_algorithm_matches_autograd(case):
    """The kernel's algorithm, tile skipping and the masked-row rule included,
    gives autograd's gradients. On float64 inputs the emulation is float64
    throughout while the plain version takes its logits in float32, so they
    differ by float32 rounding (2.5e-7 of max |grad| measured); a skipped
    tile or a lost masked row would move them by whole terms."""
    causal, window, softcap = case[6:]
    q, k, v, do = (torch.from_numpy(a) for a in _grad_inputs(case, np.float64))
    got = _emulate_bwd(q, k, v, do, causal, window, softcap)
    want = ref.attention_grads_ref(q, k, v, do, causal=causal, window=window, softcap=softcap)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * w.abs().max().item())


def test_masked_rows_send_their_mean_gradient_to_every_value():
    """Rows that see no key average v, so each of them sends dO / Skv to
    every key's dv and nothing to dq or dk (Sq > Skv + window - 1)."""
    q, k, v, do = (torch.from_numpy(a) for a in _grad_inputs((1, 1, 1, 12, 4, 8)))
    do[:, :, :8] = 0  # only rows 8.. (window 4: rows >= 7 see no key) carry a gradient
    dq, dk, dv = ref.attention_grads_ref(q, k, v, do, causal=True, window=4)
    assert torch.count_nonzero(dq) == 0 and torch.count_nonzero(dk) == 0
    torch.testing.assert_close(dv[0, 0], (do[0, 0, 8:].sum(0) / 4).expand(4, -1))


# The backward kernel's bf16 route multiplies on the tensor cores, so P
# (for dV) and dU (for dK and dQ) become bf16 operands. chip_smoke.py holds
# it within BWD_TOL[bf16] = 2^-7 of max |grad| (max error over max |plain|
# of dq, dk and dv); its rounding is the one that stays under half of that
# here: P once, dU in two halves (one rounding of dU took dq and dk to
# about half the tolerance at some seeds).
KERNEL_ROUNDING = ("bf16", "split")  # (P, dU), as _bf16_operand takes them
BWD_TOL_BF16 = 2.0 ** -7  # chip_smoke.py BWD_TOL[torch.bfloat16]
ROUNDING_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, causal, window, softcap): training-like heads
    (1, 2, 1, 1024, 1024, 128, True, None, None),
    (1, 2, 1, 1024, 700, 128, True, 256, 50.0),  # rows 955.. see no key
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ROUNDING_CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernel_rounding_holds_half_the_bf16_tolerance(case, seed):
    """The bf16 route's rounding (KERNEL_ROUNDING) on bf16-valued inputs,
    outputs rounded to bf16, against float64 autograd of the plain
    version: max error / max |grad| of dq, dk and dv under half of the
    card's tolerance. Beside it, the unrounded emulation (float64
    throughout), one rounding of both, and the kernel's rounding with O as
    the bf16 forward hands it over (Delta = dO . O then carries O's
    rounding)."""
    causal, window, softcap = case[6:]
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16).double()
                   for a in _grad_inputs(case, np.float64, seed))
    want = ref.attention_grads_ref(q, k, v, do, causal=causal, window=window, softcap=softcap)
    o_bf16 = ref.attention_ref(q, k, v, causal=causal, window=window,
                               softcap=softcap).to(torch.bfloat16).double()
    ways = {"unrounded": (None, None), "bf16 once": (("bf16", "bf16"), None),
            "kernel": (KERNEL_ROUNDING, None), "kernel, bf16 O": (KERNEL_ROUNDING, o_bf16)}
    share = {}
    for name, (rounding, out) in ways.items():
        got = _emulate_bwd(q, k, v, do, causal, window, softcap, rounding=rounding, out=out)
        share[name] = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
    print(f"seed {seed}: max error / max |grad| (tol {BWD_TOL_BF16:.4g}): " +
          ", ".join(f"{n} {x:.4g}" for n, x in share.items()))
    assert share["kernel"] < BWD_TOL_BF16 / 2
