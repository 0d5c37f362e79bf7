"""Train-step construction over (loss_fn, AdamW) (the reference's
`train/train_step.py`).

A `TrainState`'s parameters are `nn.Parameter`s that require grad (so a
model built around the tree, e.g. `models.transformer.loss_fn`, sends its
gradients to them); its optimizer state is `optim.adamw_init`'s. The step
is a plain function (no jit, no donation): it updates the state's tensors
in place and returns the state with `step` advanced, and it never syncs
with the host.

On a mesh (`make_train_step(..., mesh=, specs=)`): the state holds this
rank's shards of the parameters and of m and v, the loss function is a
per-rank one whose loss is the global batch's mean on every rank (e.g.
`models.transformer.loss_fn` with a `MeshLayout`), the global norm is
taken over the shards (`optim.global_norm` with the specs), and AdamW
updates each rank's shards in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from repro_torch.models.layers import div
from repro_torch.models.param import tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedule import warmup_cosine


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor  # () int32


def trainable(params):
    """The tree with every leaf an `nn.Parameter` that requires grad, on
    the leaf's storage (no copy)."""
    return tree_map(lambda p: nn.Parameter(p.detach(), requires_grad=True), params)


def init_train_state(params) -> TrainState:
    params = trainable(params)
    step = torch.zeros((), dtype=torch.int32, device=_leaves(params)[0].device)
    return TrainState(params=params, opt_state=adamw_init(params), step=step)


def _leaves(tree) -> list:
    """The leaves in `tree_map`'s order, which `_unflatten` inverts."""
    out: list = []
    tree_map(out.append, tree)
    return out


def _unflatten(tree, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def accum_value_and_grad(loss_fn: Callable, accum: int):
    """(params, batch) -> ((loss, metrics), grads) for a loss_fn (params,
    batch) -> (loss, metrics). With accum > 1 the batch's leading axis is
    split into `accum` microbatches, run one after another; each leaf's
    gradient is added to a float32 accumulator as `a + g / accum` as soon as
    the backward has it (a post-accumulate hook frees the parameter's
    `.grad`), so one microbatch's activations and no more than one leaf's
    own gradient live at a time. The loss and metrics are the microbatches'
    means. With accum <= 1 the gradients keep the parameters' dtype, as the
    reference's."""

    def fn(params, batch) -> Tuple[Tuple[torch.Tensor, dict], Any]:
        leaves = _leaves(params)
        n = max(accum, 1)
        if n == 1:
            grads = [None] * len(leaves)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in leaves]

        def take(i: int, p: torch.Tensor) -> None:
            g, p.grad = p.grad, None
            if n == 1:
                grads[i] = g
            else:
                grads[i].add_(div(g.float(), float(n)))

        hooks = [p.register_post_accumulate_grad_hook(lambda p, i=i: take(i, p))
                 for i, p in enumerate(leaves)]
        losses, metrics = [], []
        try:
            for j in range(n):
                mb = batch if n == 1 else \
                    {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[j]
                     for k, v in batch.items()}
                loss, m = loss_fn(params, mb)
                loss.backward()
                losses.append(loss.detach())
                metrics.append({k: x.detach() for k, x in m.items()})
        finally:
            for h in hooks:
                h.remove()
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        mean = lambda xs: div(torch.stack(xs).sum(0), float(n)) if n > 1 else xs[0]
        return ((mean(losses), {k: mean([m[k] for m in metrics]) for k in metrics[0]}),
                _unflatten(params, grads))

    return fn


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig = AdamWConfig(),
                    warmup: int = 100, total_steps: int = 10_000,
                    skip_nonfinite: bool = True, grad_accum: int = 1, mesh=None, specs=None):
    """(state, batch) -> (state, metrics): gradients (`accum_value_and_grad`),
    the `warmup_cosine` learning rate of `state.step`, and an in-place AdamW
    update. skip_nonfinite: a non-finite global gradient norm or loss keeps
    every leaf as it was (a `torch.where` per leaf, no host sync) and sets
    metrics["skipped"] to 1. Metrics: the loss function's, `loss`, `lr`,
    `grad_norm` and `skipped`. With a `mesh` (a `ProcessMesh`) and `specs`
    (the parameters' spec tree), the state is this rank's shards and every
    rank calls the step at once."""
    vg = accum_value_and_grad(loss_fn, grad_accum)

    def step_fn(state: TrainState, batch: dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        (loss, metrics), grads = vg(state.params, batch)
        lr = warmup_cosine(state.step, opt_cfg.lr, warmup, total_steps)
        gn = global_norm(grads, specs, mesh)
        ok = None
        if skip_nonfinite:
            ok = torch.isfinite(gn) & torch.isfinite(loss)
            metrics = dict(metrics, skipped=(~ok).to(torch.int32))
        _, _, opt_metrics = adamw_update(grads, state.opt_state, state.params, opt_cfg,
                                         lr=lr, ok=ok, gn=gn)
        out = TrainState(params=state.params, opt_state=state.opt_state, step=state.step + 1)
        return out, dict(metrics, loss=loss, lr=lr, **opt_metrics)

    return step_fn
