"""PNA: Principal Neighbourhood Aggregation [arXiv:2004.05718] (the
reference's `models/gnn/pna.py`).

n_layers=4, d_hidden=75; aggregators {mean, max, min, std} x scalers
{identity, amplification, attenuation} -> 12 aggregate views concatenated
then linearly mixed (the paper's combination), with residuals. The segment
ops run plain (`use_kernel=False`), as the reference's run off its Pallas
kernel, which has no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.gnn.message_passing import aggregate, degree, rows
from repro_torch.models.param import ParamSpec

AGGREGATORS = ("mean", "max", "min", "std")
N_SCALERS = 3  # identity, amplification, attenuation


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 16
    n_out: int = 7
    avg_log_degree: float = 2.0  # delta (normalizer), dataset statistic
    task: str = "node_classification"


def param_specs(cfg: PNAConfig) -> dict:
    d = cfg.d_hidden
    f32 = torch.float32
    layer = lambda: {
        "w_msg": ParamSpec((2 * d, d), ("embed", "mlp"), dtype=f32),
        "b_msg": ParamSpec((d,), ("mlp",), init="zeros", dtype=f32),
        "w_comb": ParamSpec((len(AGGREGATORS) * N_SCALERS * d + d, d), ("mlp", "embed"),
                            dtype=f32),
        "b_comb": ParamSpec((d,), ("embed",), init="zeros", dtype=f32),
    }
    return {
        "w_in": ParamSpec((cfg.d_in, d), ("feat", "embed"), dtype=f32),
        "b_in": ParamSpec((d,), ("embed",), init="zeros", dtype=f32),
        "layers": [layer() for _ in range(cfg.n_layers)],
        "w_out": ParamSpec((d, cfg.n_out), ("embed", None), dtype=f32),
        "b_out": ParamSpec((cfg.n_out,), (None,), init="zeros", dtype=f32),
    }


def forward(params: dict, batch: dict, cfg: PNAConfig) -> torch.Tensor:
    h = F.relu(batch["node_feat"] @ params["w_in"] + params["b_in"])
    src, dst = batch["src"].long(), batch["dst"].long()
    ok = (src >= 0) & (dst >= 0)
    s = torch.where(ok, src, 0)
    t = torch.where(ok, dst, 0)
    n = h.shape[0]
    dstm = torch.where(ok, dst, -1)
    logd = torch.log(degree(dstm, n) + 1.0)
    # true divisions (a Python float divides by its reciprocal on CUDA)
    s_amp = L.div(logd, cfg.avg_log_degree)[:, None]
    s_att = (torch.full_like(logd, cfg.avg_log_degree) / torch.clamp(logd, min=1e-6))[:, None]

    for lp in params["layers"]:
        m = F.relu(torch.cat([rows(h, t), rows(h, s)], -1) @ lp["w_msg"] + lp["b_msg"])
        m = torch.where(ok[:, None], m, 0.0)
        views = []
        for a in aggregate(m, dstm, n, kinds=AGGREGATORS, use_kernel=False):
            views.extend([a, a * s_amp, a * s_att])
        h = h + F.relu(torch.cat(views + [h], -1) @ lp["w_comb"] + lp["b_comb"])
    return h


def loss_fn(params: dict, batch: dict, cfg: PNAConfig) -> Tuple[torch.Tensor, dict]:
    out = forward(params, batch, cfg) @ params["w_out"] + params["b_out"]
    loss = L.cross_entropy_loss(out, batch["labels"], batch.get("seed_mask"))
    return loss, {"ce": loss}
