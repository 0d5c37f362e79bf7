"""The port's GNN zoo against the reference, on the CPU.

For PNA, EGNN, GraphCast and EquiformerV2 at their `smoke_cfg()` the
reference's parameters are carried across with
`repro_torch.convert.params_from_reference`, and the same numpy batch goes
through the reference's `jax.value_and_grad(loss_fn)` and the port's
`loss_fn` backward. The cases: a Cora-like full graph (node
classification), a sampled minibatch (`gnn_batch`: padded edges, loss on
the seeds) for PNA and GraphCast, molecule graph regression for EGNN and
EquiformerV2, and GraphCast's weather mode on the icosahedral multimesh
at refinements 1 and 2.

  - the forward output, the loss and every gradient leaf: the loss within
    LOSS_TOL (relative), the output within OUT_TOL of its largest |entry|,
    each gradient leaf within GRAD_TOL (PNA: PNA_GRAD_TOL) of its own
    largest |entry|;
  - three train steps through the port's `make_train_step` against the
    reference's: loss, grad norm and learning rate within STEP_TOL
    (relative), AdamW moments within STEP_TOL of each leaf's largest
    |entry|, parameters within that plus LR_SHARE_TOL of the summed
    learning rates;
  - EGNN's E(n) equivariance on the port;
  - `ops.segment_max` / `segment_min`'s gradient split evenly among tied
    maxima (positive duplicates, and zeros, where a gradient that counts
    the scatter's initial zero would differ), as `jax.grad` splits it;
  - EquiformerV2's radial centres bit-equal to `jnp.linspace`;
  - `launch.train.build_smoke_training` builds and steps every zoo arch
    on the CPU, and asks for CUDA when no device is given.

All float32: the two packages differ in the order of float32 sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.data import graphs as JD
from repro.graph import generators as JG
from repro.graph.sampler import NeighborSampler as JSampler
from repro.kernels import ops as JOPS
from repro.models.gnn import egnn as JE, equiformer_v2 as JQ, graphcast as JC, pna as JP
from repro.models.param import init_params as jinit
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.configs import egnn as cegnn, equiformer_v2 as cequi, graphcast as ccast
from repro_torch.configs import pna as cpna
from repro_torch.kernels import ops
from repro_torch.models.gnn import egnn as TE, equiformer_v2 as TQ, graphcast as TC, pna as TP
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.train.train_step import init_train_state, make_train_step

LOSS_TOL = 1e-5
OUT_TOL = 1e-5  # measured up to 3.9e-6 (PNA)
GRAD_TOL = 1e-4  # measured up to 2.5e-5 (EquiformerV2), 8.8e-6 (EGNN), 1.1e-6 (GraphCast)
# PNA's std view is sqrt(var + 1e-6): at var ~ 0 it scales the rounding of
# var = mean(m^2) - mean(m)^2 by up to 1 / (2 sqrt(1e-6)) = 500 in the
# backward (measured up to 1.0e-4 on the full graph, 2.4e-5 on the minibatch)
PNA_GRAD_TOL = 1e-3
STEP_TOL = 1e-4
# an Adam step is lr * m / sqrt(v) an entry, whatever the gradient's size:
# a gradient entry near the rounding noise moves its parameter by a share
# of lr; parameters are held within STEP_TOL of the leaf's largest |entry|
# plus this share of the summed learning rates (measured up to 6.7e-4, a
# zero-initialized PNA bias)
LR_SHARE_TOL = 1e-2

MODELS = {"pna": (JP, TP, cpna), "egnn": (JE, TE, cegnn), "graphcast": (JC, TC, ccast),
          "equiformer-v2": (JQ, TQ, cequi)}


def _full_batch(cfg):
    g, feats, labels = JG.cora_like_graph(n=60, e_target=240, d_feat=cfg.d_in,
                                          n_classes=cfg.n_out, seed=1)
    return JD.full_graph_batch(g, feats, labels)


def _minibatch(cfg, step=0):
    g = JG.powerlaw_graph(n=200, m=3, seed=2)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((g.n, cfg.d_in)).astype(np.float32)
    labels = rng.integers(0, cfg.n_out, g.n).astype(np.int32)
    return JD.gnn_batch(step, g, feats, labels, JSampler(g, (3, 2), seed=4), batch_nodes=8)


def _molecule_batch(cfg, step=0):
    return JD.molecule_batch(step, n_mols=cfg.n_graphs, n_nodes=10, n_edges=20,
                             d_feat=cfg.d_in)


def _weather_batch(cfg, refinement):
    mm = JG.icosahedral_multimesh(refinement=refinement, grid_per_mesh=2)
    rng = np.random.default_rng(refinement)
    return {
        "grid_feat": rng.standard_normal((mm.n_grid, cfg.d_in)).astype(np.float32),
        "grid_target": rng.standard_normal((mm.n_grid, cfg.n_out)).astype(np.float32),
        "n_mesh": mm.n_mesh,
        "mesh_src": mm.mesh_src, "mesh_dst": mm.mesh_dst,
        "g2m_src": mm.g2m_src, "g2m_dst": mm.g2m_dst,
        "m2g_src": mm.m2g_src, "m2g_dst": mm.m2g_dst,
    }


def _molecule_cfg(arch):
    return dataclasses.replace(get_arch(arch).smoke_cfg(), n_out=1, task="graph_regression",
                               n_graphs=4)


def _weather_cfg():
    return JC.GraphCastConfig(n_layers=2, d_hidden=16, n_vars=5, d_in=5, n_out=5,
                              mode="weather")


def make_case(name):
    """(arch, reference cfg, batch fn of the step)."""
    arch, kind = name.rsplit("/", 1)
    if kind == "molecule":
        cfg = _molecule_cfg(arch)
        return arch, cfg, lambda step: _molecule_batch(cfg, step)
    if kind.startswith("weather"):
        cfg = _weather_cfg()
        b = _weather_batch(cfg, int(kind[-1]))
        return arch, cfg, lambda step: b
    cfg = get_arch(arch).smoke_cfg()
    if kind == "minibatch":
        return arch, cfg, lambda step: _minibatch(cfg, step)
    b = _full_batch(cfg)
    return arch, cfg, lambda step: b


CASES = ["pna/full", "pna/minibatch", "egnn/full", "egnn/molecule", "graphcast/full",
         "graphcast/minibatch", "graphcast/weather1", "graphcast/weather2",
         "equiformer-v2/full", "equiformer-v2/molecule"]
STEP_CASES = ["pna/minibatch", "egnn/molecule", "graphcast/full", "equiformer-v2/full"]


def tcfg(arch, cfg):
    """The reference's config as the port's dataclass, field for field."""
    return getattr(MODELS[arch][1], type(cfg).__name__)(**dataclasses.asdict(cfg))


def jbatch(b):
    return {k: v if isinstance(v, int) else jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: v if isinstance(v, int) else torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _forward(mod, p, b, cfg):
    return mod.forward_weather(p, b, cfg) if getattr(cfg, "mode", "") == "weather" else \
        (mod.forward_generic(p, b, cfg) if hasattr(mod, "forward_generic") else
         mod.forward(p, b, cfg))


@pytest.fixture(scope="module", params=CASES)
def case(request):
    arch, cfg, batch_fn = make_case(request.param)
    jmod, tmod, _ = MODELS[arch]
    params = jinit(jmod.param_specs(cfg), jax.random.PRNGKey(0))
    batch = batch_fn(0)
    jb = jbatch(batch)

    @jax.jit
    def ref(p):  # one compile: loss, metrics, gradients and the forward output
        return (jax.value_and_grad(lambda q: jmod.loss_fn(q, jb, cfg), has_aux=True)(p),
                _forward(jmod, p, jb, cfg))

    ((jloss, jm), jgrads), jout = ref(params)
    return dict(arch=arch, cfg=cfg, params=params, batch=batch, jloss=jloss, jm=jm,
                jgrads=jgrads, jout=jout, tcfg=tcfg(arch, cfg), tmod=tmod)


def _close(a, b, tol, what):
    b = np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def test_loss_output_and_every_gradient_match_the_reference(case):
    state = init_train_state(convert.params_from_reference(case["params"], "cpu"))
    b = tbatch(case["batch"])
    loss, metrics = case["tmod"].loss_fn(state.params, b, case["tcfg"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(case["jloss"]), rtol=LOSS_TOL)
    assert set(metrics) == set(case["jm"])
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(case["jm"][k]), rtol=LOSS_TOL)
    jleaves = jax.tree.leaves(case["jgrads"])
    leaves = tree_leaves(tree_map(lambda p: p.grad, state.params))
    assert len(jleaves) == len(leaves)
    for i, (j, g) in enumerate(zip(jleaves, leaves)):
        if g is None:  # unused by the loss (EGNN's last phi_x): the reference's is 0
            assert not np.asarray(j).any(), f"leaf {i} has no gradient"
            continue
        _close(g.numpy(), j, PNA_GRAD_TOL if case["arch"] == "pna" else GRAD_TOL,
               f"gradient leaf {i}")
    with torch.no_grad():
        out = _forward(case["tmod"], state.params, b, case["tcfg"])
    jout = case["jout"]
    for o, j in zip(out if isinstance(out, tuple) else (out,),
                    jout if isinstance(jout, tuple) else (jout,)):
        _close(o.numpy(), j, OUT_TOL, "forward output")


@pytest.mark.parametrize("name", STEP_CASES)
def test_three_train_steps_match_the_reference(name):
    arch, cfg, batch_fn = make_case(name)
    jmod, tmod, _ = MODELS[arch]
    kw = dict(warmup=2, total_steps=10)
    jstate = JTS.init_train_state(jinit(jmod.param_specs(cfg), jax.random.PRNGKey(0)))
    state = convert.train_state_from_reference(jstate, None, "cpu")
    jstep = JTS.make_train_step(lambda p, b: jmod.loss_fn(p, b, cfg), donate=False, **kw)
    t_cfg = tcfg(arch, cfg)
    step = make_train_step(lambda p, b: tmod.loss_fn(p, b, t_cfg), **kw)
    lr_sum = 0.0
    for i in range(3):
        batch = batch_fn(i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, tbatch(batch))
        assert int(m["skipped"]) == int(jm["skipped"]) == 0
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=STEP_TOL, err_msg=k)
        lr_sum += float(jm["lr"])
    got = convert.train_state_to_reference(state)
    assert int(got["step"]) == int(jstate.step) == 3
    assert int(got["opt_state"]["count"]) == int(jstate.opt_state["count"]) == 3
    for name in ("m", "v"):
        for i, (a, b) in enumerate(zip(tree_leaves(got["opt_state"][name]),
                                       jax.tree.leaves(jstate.opt_state[name]))):
            _close(np.asarray(a), b, STEP_TOL, f"{name} leaf {i}")
    for i, (a, b) in enumerate(zip(tree_leaves(got["params"]), jax.tree.leaves(jstate.params))):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, err_msg=f"parameter leaf {i}",
                                   atol=STEP_TOL * np.abs(b).max() + LR_SHARE_TOL * lr_sum)


def test_egnn_equivariance():
    """Rotating and translating the positions rotates and translates the
    port's coordinate output alike and leaves h as it was."""
    cfg = TE.EGNNConfig(n_layers=2, d_hidden=16, d_in=8, n_out=3)
    from repro_torch.models.param import init_params

    params = init_params(TE.param_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    b = tbatch(_full_batch(cfg))
    rng = np.random.default_rng(1)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    shift = rng.standard_normal(3)
    b2 = dict(b, node_pos=torch.from_numpy((b["node_pos"].numpy() @ q.T + shift)
                                           .astype(np.float32)))
    with torch.no_grad():
        h1, x1 = TE.forward(params, b, cfg)
        h2, x2 = TE.forward(params, b2, cfg)
    np.testing.assert_allclose(h2.numpy(), h1.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(x2.numpy(), x1.numpy() @ q.T + shift, atol=1e-4, rtol=1e-4)


def test_segment_max_and_min_split_the_gradient_among_ties():
    # segments: 0 two tied positive maxima, 1 a maximum of 0 twice (plus a
    # negative), 2 three tied, 3 one, 4 empty; ids -1 and 9 dropped
    vals = np.array([[1.5, -2.0], [1.5, -2.0], [0.5, -1.0], [0.0, 3.0], [0.0, 3.0],
                     [-1.0, 3.0], [2.0, 0.0], [2.0, 0.0], [2.0, 0.0], [7.0, 7.0],
                     [9.0, 9.0], [9.0, -9.0]], np.float32)
    ids = np.array([0, 0, 0, 1, 1, 1, 2, 2, 2, 3, -1, 9], np.int32)
    w = np.arange(1, 11, dtype=np.float32).reshape(5, 2)
    for jfn, tfn in ((JOPS.segment_max, ops.segment_max), (JOPS.segment_min, ops.segment_min)):
        jout, jgrad = jax.value_and_grad(lambda v: jnp.sum(jfn(v, ids, 5) * w))(vals)
        v = torch.from_numpy(vals).requires_grad_(True)
        out = torch.sum(tfn(v, torch.from_numpy(ids), 5) * torch.from_numpy(w))
        out.backward()
        assert out.item() == float(jout)
        np.testing.assert_array_equal(v.grad.numpy(), np.asarray(jgrad))
    # the even split, spelled out for segment_max: segment 1 column 0 has
    # two zeros tied (a third share for each would count the initial zero)
    assert v.grad is not None
    v = torch.from_numpy(vals).requires_grad_(True)
    torch.sum(ops.segment_max(v, torch.from_numpy(ids), 5) * torch.from_numpy(w)).backward()
    assert v.grad[3, 0] == v.grad[4, 0] == w[1, 0] / 2
    assert v.grad[6, 0] == v.grad[7, 0] == v.grad[8, 0] == np.float32(w[2, 0]) * np.float32(1 / 3)
    assert not v.grad[10:].any()


@pytest.mark.parametrize("n_rbf", [16, 8, 7, 2])
def test_rbf_centres_bit_equal_to_linspace(n_rbf):
    want = np.asarray(jnp.linspace(0.0, 5.0, n_rbf))
    got = TQ.rbf_centers(n_rbf)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    dist = np.random.default_rng(0).uniform(0, 6, 50).astype(np.float32)
    np.testing.assert_allclose(TQ._rbf(torch.from_numpy(dist), n_rbf).numpy(),
                               np.asarray(JQ._rbf(jnp.asarray(dist), n_rbf)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ["pna", "egnn", "graphcast", "equiformer-v2"])
def test_configs_equal_the_reference(arch):
    ref, port = get_arch(arch), MODELS[arch][2]
    assert dataclasses.asdict(port.smoke_cfg()) == dataclasses.asdict(ref.smoke_cfg())
    for shape in ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule"):
        assert dataclasses.asdict(port.model_cfg(shape)) == \
            dataclasses.asdict(ref.model_cfg(shape)), shape


@pytest.mark.parametrize("arch", ["din", "pna", "egnn", "graphcast", "equiformer-v2"])
def test_build_smoke_training_steps_every_zoo_arch(arch):
    from repro_torch.launch.train import build_smoke_training
    from repro_torch.train import Trainer, TrainerConfig

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_smoke_training(arch, 4, 8)
    loss_fn, init_fn, batch_fn = build_smoke_training(arch, 4, 8, "cpu")
    trainer = Trainer(loss_fn, init_fn, batch_fn, TrainerConfig(total_steps=2, log_every=1),
                      device="cpu")
    state = trainer.run()
    assert int(state.step) == 2
    assert all(np.isfinite(h["loss"]) and h["skipped"] == 0 for h in trainer.history)
