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
