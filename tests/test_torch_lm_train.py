"""The port's LM training loss against the reference's, on the CPU.

For the smoke configs of qwen3-4b, gemma2-27b (local/global layers, a
window of 16 that bites at 32 tokens, attention and final softcaps, post
norms, embedding scale) and qwen2-moe-a2.7b (the Switch aux loss added),
the reference's parameters are carried across with `repro_torch.convert`
and the same token batch goes through the reference's
`jax.value_and_grad(loss_fn)` and the port's `models.transformer.loss_fn`
backward: the loss, ce, aux and the gradient of every leaf must agree. The
cases cover the whole-logits head (S <= xent_chunk) and the chunked one
(S = 2 x xent_chunk), with remat on and off.

All in float32. The loss within LOSS_TOL (relative); each gradient leaf
within GRAD_TOL of its own largest |entry| (the two packages differ only in
the order of float32 sums; measured up to 4.7e-6 for the dense configs and
2.7e-5 for the MoE one, the loss within 8.1e-8).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.param import init_params as jinit_params
from repro_torch import convert
from repro_torch.data.tokens import token_batch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.train.train_step import init_train_state

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B = 2
CASES = [
    # (arch, S, xent_chunk, remat)
    ("qwen3-4b", 16, 512, False),  # whole-logits head
    ("qwen3-4b", 32, 16, True),  # chunked head, remat
    ("gemma2-27b", 32, 16, False),
    ("qwen2-moe-a2.7b", 16, 512, True),
]


def _setup(arch, S, chunk, remat):
    cfg = dataclasses.replace(get_arch(arch).smoke_cfg(), xent_chunk=chunk, remat=remat)
    params = jinit_params(JT.lm_param_specs(cfg), jax.random.PRNGKey(0))
    batch = token_batch(0, B, S, cfg.vocab)
    return cfg, params, batch


def _port_loss_and_grads(cfg, params, batch):
    tcfg = convert.lm_config_from_reference(cfg)
    state = init_train_state(convert.lm_params_from_reference(params, tcfg, "cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = T.loss_fn(state.params, tb, tcfg)
    loss.backward()
    grads = T.stack_layers(tree_map(lambda p: p.grad, state.params), tcfg)
    return loss, metrics, grads


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_loss_and_every_gradient_match_the_reference(case):
    cfg, params, batch = _setup(*case)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, b, cfg), has_aux=True))(params, batch)
    loss, metrics, grads = _port_loss_and_grads(cfg, params, batch)

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL)
    np.testing.assert_allclose(metrics["ce"].item(), float(jm["ce"]), rtol=LOSS_TOL)
    np.testing.assert_allclose(metrics["aux"].item(), float(jm["aux"]), rtol=LOSS_TOL,
                               atol=1e-7)
    if cfg.moe:
        assert float(jm["aux"]) > 0
    jleaves, leaves = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(jleaves) == len(leaves)
    for j, t in zip(jleaves, leaves):
        j = np.asarray(j)
        assert j.shape == tuple(t.shape)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(j).max(), 1e-12))


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-moe-a2.7b"])
def test_remat_gives_equal_gradients(arch):
    """Recomputing each layer group in the backward changes nothing."""
    out = []
    for remat in (False, True):
        cfg, params, batch = _setup(arch, 32, 16, remat)
        loss, _, grads = _port_loss_and_grads(cfg, params, batch)
        out.append((loss, tree_leaves(grads)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_chunked_head_matches_the_whole_logits_head():
    """`chunked_unembed_xent` over 4 chunks of 8 against one pass, with a
    softcap, and the masked `cross_entropy_loss` against the reference's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 32)).astype(np.int32)
    mask = (rng.random((2, 32)) < 0.7).astype(np.float32)
    tx, tw, tl = (torch.from_numpy(a) for a in (x, w, labels))
    whole = L.chunked_unembed_xent(tx, tw, tl, cap=5.0, chunk=512)
    chunked = L.chunked_unembed_xent(tx, tw, tl, cap=5.0, chunk=8)
    ref = JL.chunked_unembed_xent(x, w, labels, cap=5.0, chunk=8)
    np.testing.assert_allclose(chunked.item(), whole.item(), rtol=1e-6)
    np.testing.assert_allclose(chunked.item(), float(ref), rtol=1e-6)
    logits = x @ w
    np.testing.assert_allclose(
        L.cross_entropy_loss(torch.from_numpy(logits), tl, torch.from_numpy(mask)).item(),
        float(JL.cross_entropy_loss(logits, labels, mask)), rtol=1e-6)
