"""The zoo's data path and shared layers against the reference, on the CPU.

  - the graph generators the zoo trains on (`erdos_renyi_graph`,
    `grid_graph`, `cora_like_graph`, `molecule_batch_graph`,
    `icosahedral_multimesh`): every array bit-equal, dtypes too;
  - `NeighborSampler.sample` (the port maps global ids to local ones by a
    `searchsorted` where the reference looks each one up in a dict) and
    `sampled_shape`, bit-equal over seeds and fanouts, seeds included that
    have no neighbours;
  - `full_graph_batch`, `gnn_batch` (several steps, one sampler) and
    `molecule_batch`, bit-equal;
  - `graph.csr.sorted_unique` (the port's `np.unique` by one sort) equal to
    `np.unique`, first indices included;
  - `layer_norm`, `gelu_mlp` (the tanh approximation, as `jax.nn.gelu`'s
    default) and `mlp_stack` within LAYER_TOL in float32, their gradients
    within GRAD_TOL of each one's largest |entry|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import graphs as JD
from repro.graph import generators as JG
from repro.graph import sampler as JS
from repro.models import layers as JL
from repro_torch.data import graphs as TD
from repro_torch.graph import generators as TG
from repro_torch.graph import sampler as TS
from repro_torch.models import layers as L

# float32; the two packages differ in the order of sums
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)  # outputs
GRAD_TOL = 1e-5  # each gradient within this of its largest |entry|


def assert_same(a, b, what=""):
    """Equal values and dtypes: arrays, dataclasses field by field, dicts
    key by key, tuples item by item, scalars."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), (what, sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, tuple):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


GENERATORS = [
    ("erdos_renyi_graph", dict(n=500, avg_degree=8.0, seed=3)),
    ("erdos_renyi_graph", dict(n=50, avg_degree=40.0, seed=0)),
    ("grid_graph", dict(side=7)),
    ("cora_like_graph", dict()),  # Cora's shape: full_graph_sm
    ("cora_like_graph", dict(n=400, e_target=1600, d_feat=8, n_classes=3)),
    ("molecule_batch_graph", dict(n_mols=128)),  # molecule's shape
    ("molecule_batch_graph", dict(n_mols=5, n_nodes=10, n_edges=20, seed=4)),
    ("icosahedral_multimesh", dict(refinement=1, grid_per_mesh=2)),
    ("icosahedral_multimesh", dict(refinement=3, seed=2)),
]


@pytest.mark.parametrize("name,kw", GENERATORS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(GENERATORS)])
def test_generators_bit_equal(name, kw):
    assert_same(getattr(JG, name)(**kw), getattr(TG, name)(**kw), name)


@pytest.fixture(scope="module")
def graph():
    # a power-law graph with some isolated nodes (degree 0 samples nothing)
    g = JG.powerlaw_graph(n=600, m=3, seed=1)
    keep = np.ones(g.n, bool)
    keep[::37] = False
    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    ok = keep[src] & keep[g.indices]
    from repro.graph.csr import build_csr

    return build_csr(g.n, src[ok], g.indices[ok])


@pytest.mark.parametrize("fanout,batch,seed", [((15, 10), 32, 0), ((5, 3), 16, 1),
                                               ((4,), 64, 2), ((2, 2, 2), 8, 3)])
def test_sampler_bit_equal(graph, fanout, batch, seed):
    assert TS.sampled_shape(batch, fanout) == JS.sampled_shape(batch, fanout)
    js, ts = JS.NeighborSampler(graph, fanout, seed=seed), TS.NeighborSampler(graph, fanout,
                                                                              seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(3):  # one sampler, its generator advancing
        seeds = rng.choice(graph.n, size=batch, replace=False)
        seeds[0] = 0  # isolated (0 % 37 == 0)
        a, b = js.sample(seeds), ts.sample(seeds)
        assert_same(a, b, "sample")
        assert b.n_edges < b.max_edges  # padded


@pytest.mark.parametrize("size,high", [(0, 1), (1, 5), (1000, 50), (100_000, 10**12)])
def test_sorted_unique_equals_np_unique(size, high):
    from repro_torch.graph.csr import sorted_unique

    a = np.random.default_rng(size).integers(-3, high, size)
    assert_same(np.unique(a), sorted_unique(a))
    assert_same(np.unique(a, return_index=True), sorted_unique(a, return_index=True))


def test_sampled_shape_of_minibatch_lg():
    assert TS.sampled_shape(1024, (15, 10)) == JS.sampled_shape(1024, (15, 10)) \
        == (169_984, 168_960)


def test_full_graph_batch_bit_equal():
    g, feats, labels = JG.cora_like_graph(n=300, e_target=1000, d_feat=12, n_classes=4)
    for with_pos in (True, False):
        assert_same(JD.full_graph_batch(g, feats, labels, with_pos=with_pos, seed=5),
                    TD.full_graph_batch(g, feats, labels, with_pos=with_pos, seed=5))


def test_gnn_batch_bit_equal(graph):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((graph.n, 6)).astype(np.float32)
    labels = rng.integers(0, 5, graph.n).astype(np.int32)
    js, ts = JS.NeighborSampler(graph, (5, 3), seed=7), TS.NeighborSampler(graph, (5, 3), seed=7)
    for step in range(3):
        assert_same(JD.gnn_batch(step, graph, feats, labels, js, batch_nodes=24, seed=1),
                    TD.gnn_batch(step, graph, feats, labels, ts, batch_nodes=24, seed=1),
                    f"step {step}")
    with pytest.raises(ValueError, match="NeighborSampler"):
        TD.gnn_batch(0, graph, feats, labels, None)


@pytest.mark.parametrize("kw", [dict(), dict(n_mols=6, n_nodes=12, n_edges=30, d_feat=5,
                                              seed=3)])
def test_molecule_batch_bit_equal(kw):
    for step in (0, 2):
        assert_same(JD.molecule_batch(step, **kw), TD.molecule_batch(step, **kw))


def _grads(fn, args):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    out.backward(torch.ones_like(out))
    return out.detach().numpy(), [x.grad.numpy() for x in ts]


def _jgrads(fn, args):
    out, vjp = jax.vjp(fn, *args)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.ones_like(out))]


def _check(jfn, tfn, args):
    jout, jg = _jgrads(jfn, args)
    out, g = _grads(tfn, args)
    np.testing.assert_allclose(out, jout, **LAYER_TOL)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_TOL * np.abs(b).max())


def test_layer_norm_vs_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 5, 24)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(24).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    _check(JL.layer_norm, L.layer_norm, (x, w, b))


@pytest.mark.parametrize("bias", [True, False])
def test_gelu_mlp_vs_reference(bias):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((7, 3, 16)).astype(np.float32) * 2
    w_in = rng.standard_normal((16, 40)).astype(np.float32) / 4
    w_out = rng.standard_normal((40, 12)).astype(np.float32) / 6
    b_in = rng.standard_normal(40).astype(np.float32)
    b_out = rng.standard_normal(12).astype(np.float32)
    if bias:
        _check(JL.gelu_mlp, L.gelu_mlp, (x, w_in, b_in, w_out, b_out))
    else:
        _check(lambda a, b, c: JL.gelu_mlp(a, b, None, c, None),
               lambda a, b, c: L.gelu_mlp(a, b, None, c, None), (x, w_in, w_out))
    # the exact erf gelu is not the reference's: it differs past the tolerance
    h = torch.from_numpy(x @ w_in + b_in)
    exact = torch.nn.functional.gelu(h).numpy()
    assert np.abs(exact - np.asarray(jax.nn.gelu(h.numpy()))).max() > 1e-4


@pytest.mark.parametrize("final_act", [False, True])
def test_mlp_stack_vs_reference(final_act):
    rng = np.random.default_rng(2)
    dims = (10, 20, 8, 3)
    ws = [(rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [rng.standard_normal(b).astype(np.float32) for b in dims[1:]]
    x = rng.standard_normal((9, 10)).astype(np.float32)

    def jfn(x, *p):
        return JL.mlp_stack(x, list(p[:3]), [p[3], None, p[4]], act=jax.nn.silu,
                            final_act=final_act)

    def tfn(x, *p):
        return L.mlp_stack(x, list(p[:3]), [p[3], None, p[4]], act=torch.nn.functional.silu,
                           final_act=final_act)

    _check(jfn, tfn, (x, *ws, bs[0], bs[2]))
    _check(lambda x, *p: JL.mlp_stack(x, list(p[:3]), list(p[3:])),
           lambda x, *p: L.mlp_stack(x, list(p[:3]), list(p[3:])), (x, *ws, *bs))
