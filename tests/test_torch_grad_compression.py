"""The port's int8 gradient compression with error feedback
(`repro_torch.optim.grad_compression`) over a "pod" axis of 4 gloo ranks on
the CPU, against the reference's `compressed_psum` under shard_map on 4
host devices.

Three leaves (a matrix, a vector, a 3-d block), each rank's gradients at
its own scale (1x to 4x), two steps so that the second carries the first's
residual. Held per rank and step: the int8 payload q of its gradient plus
residual, bit for bit; its scale, the synced mean and the new residual
within 2e-7 of max |x| (x = gradient + residual) -- an ulp or two: XLA
compiles the residual x - q * scale as a fused multiply-add, PyTorch on
the CPU as two roundings; and the scale, mean and residual by their
definitions from the port's own q and scales.
"""

import numpy as np
import pytest

import _sharded_cases as C
import _torch_dist as D
import _torch_sharded as S
from _torch_threads import one_thread  # noqa: F401 (autouse: one intra-op thread)

FLOAT_TOL = 2e-7  # of max |x|
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    finish = C.start_reference(["compression"], tmp_path_factory.mktemp("gc_ref"))
    port = D.spawn(S.gc_all, C.WORLD, str(tmp_path_factory.mktemp("gloo")), timeout=TIMEOUT_S)
    return finish()["compression"], port


def _x(port, step, leaf):
    """Each rank's gradient plus the residual it carried in: (WORLD, *shape)."""
    g = C.gc_grads(step)[leaf]
    if step == 0:
        return g
    return g + np.stack([p[f"{step - 1}/residual/{leaf}"] for p in port])


@pytest.mark.parametrize("step", range(C.GC_STEPS))
@pytest.mark.parametrize("leaf", list(C.GC_SHAPES))
def test_compressed_psum_matches_reference(runs, step, leaf):
    ref, port = runs
    shape = C.GC_SHAPES[leaf]
    x = _x(port, step, leaf)
    for what in ("q", "scale", "mean", "residual"):
        want = ref[f"{step}/{what}/{leaf}"]
        want = want.reshape(C.WORLD) if what == "scale" else want.reshape((C.WORLD,) + shape)
        for r, got in enumerate(port):
            got = got[f"{step}/{what}/{leaf}"]
            assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
            if what == "q":
                np.testing.assert_array_equal(got, want[r], err_msg=f"rank {r}")
            else:
                np.testing.assert_allclose(got, want[r], rtol=0,
                                           atol=FLOAT_TOL * np.abs(x[r]).max(),
                                           err_msg=f"{what}, rank {r}")


@pytest.mark.parametrize("step", range(C.GC_STEPS))
def test_compressed_psum_definitions(runs, step):
    """scale = max |x| / 127 (as XLA compiles it), mean = sum(q) * mean scale
    / n on every rank, residual = x - q * scale."""
    _, port = runs
    for leaf in C.GC_SHAPES:
        x = _x(port, step, leaf)
        q = np.stack([p[f"{step}/q/{leaf}"] for p in port]).astype(np.float32)
        s = np.array([p[f"{step}/scale/{leaf}"] for p in port], np.float32)
        amax = np.abs(x.reshape(C.WORLD, -1)).max(1).astype(np.float32)
        np.testing.assert_array_equal(s, amax * (np.float32(1) / np.float32(127)))
        assert np.abs(q).max() <= 127
        mean = q.sum(0) * (s.sum() / np.float32(C.WORLD)) / np.float32(C.WORLD)
        for r, p in enumerate(port):
            np.testing.assert_allclose(p[f"{step}/mean/{leaf}"], mean, rtol=1e-6,
                                       atol=1e-6 * np.abs(mean).max())
            np.testing.assert_allclose(p[f"{step}/residual/{leaf}"], x[r] - q[r] * s[r],
                                       rtol=0, atol=FLOAT_TOL * np.abs(x[r]).max())
