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

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import ops, ref
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.flash_attention import flash_attention

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
