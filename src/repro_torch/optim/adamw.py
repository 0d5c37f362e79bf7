"""AdamW over parameter trees (the reference's `optim/adamw.py`).

The state is float32 whatever the parameters' dtype: m and v per leaf and
an int32 step count, which enters the bias corrections as float32
(`b ** count`). The update is computed in float32 and cast to the
parameter's dtype. Gradients are clipped by their global norm.

Where the reference returns new trees, `adamw_update` updates the
parameters, m and v IN PLACE, one leaf at a time, so that the optimizer's
float32 temporaries live for one leaf only (at Qwen3-4B's size the
embedding's are 1.56 GB each) and no second copy of the state exists.
Trees are nested dicts and lists of tensors (`models.param.tree_leaves`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.param import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0


def adamw_init(params) -> dict:
    """{"m", "v": float32 zeros shaped as each leaf, "count": () int32 0},
    on the parameters' device."""
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_opt_state(abstract_params) -> dict:
    """`adamw_init`'s state for a tree of `meta` parameters, as `meta` tensors."""
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    return {"m": tree_map(f32, abstract_params), "v": tree_map(f32, abstract_params),
            "count": torch.empty((), dtype=torch.int32, device="meta")}


def opt_state_pspecs(param_specs_tree) -> dict:
    """The optimizer state's sharding specs: m and v as their parameters."""
    return {"m": tree_map(lambda s: s, param_specs_tree),
            "v": tree_map(lambda s: s, param_specs_tree), "count": ()}


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32.

    Over a sharded tree (`specs`, a spec tree of the same structure, on a
    `ProcessMesh`): each leaf's sum of squares is psum'd over the axes it
    is split on and counted once along the axes that replicate it (its
    value is the same on each of their ranks), so the norm, and the clip
    and non-finite skip that read it, are the same on every rank. The
    leaves split over the same axes are summed first, one psum a set."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.mesh_utils import split_axes
    from repro_torch.models.param import tree_map_with

    sums: Dict[tuple, torch.Tensor] = {}

    def add(x, spec):
        named = set(split_axes(spec))
        key = tuple(a for a in mesh.axes if a in named and mesh.axis_size(a) > 1)
        sq = torch.sum(torch.square(x.float()))
        sums[key] = sq if key not in sums else sums[key] + sq

    tree_map_with(add, tree, specs)
    total = None
    for key in sorted(sums, key=lambda k: (len(k), k)):
        part = C.psum(sums[key], mesh.group(key)) if key else sums[key]
        total = part if total is None else total + part
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, cfg: AdamWConfig,
                 lr: Optional[torch.Tensor] = None, ok: Optional[torch.Tensor] = None,
                 gn: Optional[torch.Tensor] = None) -> Tuple[object, dict, Dict[str, torch.Tensor]]:
    """One AdamW step, in place; returns (params, opt_state, {"grad_norm"}).

    `grads` has the parameters' tree and is consumed (clipped in place).
    `gn` is their global norm when the caller has it. Where `ok` (a () bool
    tensor) is False, every leaf and the count keep their old values, as the
    reference train step's `jnp.where(ok, new, old)`: no host sync."""
    lr = torch.as_tensor(cfg.lr if lr is None else lr, dtype=torch.float32)
    gn = global_norm(grads) if gn is None else gn
    count = opt_state["count"] + 1
    scale = None
    if cfg.grad_clip is not None:  # a true division: the clip over the floored norm
        scale = torch.clamp(torch.full_like(gn, cfg.grad_clip) / torch.clamp(gn, min=1e-9),
                            max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c = count.float()
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c

    def commit(dst: torch.Tensor, new: torch.Tensor) -> None:
        dst.copy_(new if ok is None else torch.where(ok, new, dst))

    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"]), tree_leaves(params)):
        if scale is not None:
            g = g.mul_(scale.to(g.dtype))
        g32 = g.float()
        m_new = b1 * m
        m_new += (1 - b1) * g32
        v_new = b2 * v
        v_new += (1 - b2) * g32 * g32
        del g32
        step = m_new / bc1
        den = torch.sqrt_(v_new / bc2)
        den += cfg.eps
        step /= den
        del den
        commit(m, m_new)
        commit(v, v_new)
        del m_new, v_new
        p32 = p.float()
        step += cfg.weight_decay * p32
        commit(p, (p32 - lr * step).to(p.dtype))
    commit(opt_state["count"], count)
    return params, opt_state, {"grad_norm": gn}
