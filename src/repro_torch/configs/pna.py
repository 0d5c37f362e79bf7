"""pna [arXiv:2004.05718]: n_layers=4 d_hidden=75,
aggregators mean/max/min/std x scalers id/amp/atten."""

from __future__ import annotations

from repro_torch.configs import base
from repro_torch.models.gnn import pna as model


def model_cfg(shape: str = "full_graph_sm") -> model.PNAConfig:
    d = base.GNN_SHAPES[shape]
    n_out = d.get("n_out", 7) if shape != "molecule" else 4
    return model.PNAConfig(
        n_layers=4, d_hidden=75, d_in=d["d_feat"], n_out=n_out,
        avg_log_degree=2.0, task="node_classification",
    )


def smoke_cfg() -> model.PNAConfig:
    return model.PNAConfig(n_layers=2, d_hidden=12, d_in=8, n_out=3)


ARCH = base.ArchDef(
    name="pna",
    family="gnn",
    cells=base.gnn_cells(),
    model_cfg=model_cfg,
    smoke_cfg=smoke_cfg,
    build_dryrun=lambda shape, mesh: base.build_gnn_dryrun(
        "pna", model, model_cfg(shape), shape, mesh, ARCH.cell(shape),
        needs_pos=False,
    ),
)
