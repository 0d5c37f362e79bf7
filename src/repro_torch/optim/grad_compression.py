"""Gradient compression for a cross-pod all-reduce: int8 with error
feedback (the reference's `optim/grad_compression.py`).

The links between pods are the scarcest bandwidth; compressing the
gradient all-reduce that crosses the "pod" axis 4x (bf16 -> int8 and a
per-tensor scale), with error feedback (Seide et al.; the 1-bit Adam
lineage), quarters that collective while the residual of each step's
quantisation is carried into the next.

Usage, on every rank of the axis's group at once:

    g_sync, ef = compressed_psum(g_local, mesh.group("pod"), ef)

`ef` (the gradients' tree, float32) carries the residual.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L
from repro_torch.models.param import tree_map


class ErrorFeedbackState(NamedTuple):
    residual: object  # the gradients' tree, float32


def init_error_feedback(grads) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=tree_map(lambda g: torch.zeros(
        g.shape, dtype=torch.float32, device=g.device), grads))


# the reference's `max / 127.0` as XLA compiles it: a multiply by the
# float32 reciprocal of the constant (an ulp off a true division at times)
INV_127 = np.float32(1.0) / np.float32(127.0)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (q, scale () float32), bit for bit the
    reference's. Rounding is half to even, as `jnp.round`'s; x / scale is a
    true division (tensor by tensor, on every device)."""
    xf = x.float()
    amax = torch.clamp(torch.max(torch.abs(xf)), min=1e-12)
    scale = amax * torch.tensor(INV_127, device=x.device)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads, group, ef: Optional[ErrorFeedbackState] = None
                    ) -> Tuple[object, ErrorFeedbackState]:
    """Quantised mean all-reduce over `group` with error feedback.

    The int8 payloads cross the group summed in int32 (no int8 overflow);
    the scales are summed by a separate psum, and the mean scale stands for
    every participant's own, as the reference does. The residual
    x - dequantize(quantize(x)) is carried to the next call."""
    if ef is None:
        ef = init_error_feedback(grads)
    n = C.group_size(group)

    def one(g, r):
        x = g.float() + r
        q, scale = quantize_int8(x)
        q_sum = C.psum(q.to(torch.int32), group)
        s_sum = C.psum(scale, group)
        mean = L.div(q_sum.float() * L.div(s_sum, float(n)), float(n))
        return mean.to(g.dtype), x - dequantize_int8(q, scale)

    flat_g, flat_r = _flatten(grads), _flatten(ef.residual)
    outs = [one(g, r) for g, r in zip(flat_g, flat_r)]
    synced = _unflatten(grads, iter([o[0] for o in outs]))
    resid = _unflatten(grads, iter([o[1] for o in outs]))
    return synced, ErrorFeedbackState(residual=resid)


def _flatten(tree) -> list:
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def _unflatten(like, leaves):
    return tree_map(lambda _: next(leaves), like)
