"""equiformer-v2 [arXiv:2306.12059]: n_layers=12 d_hidden=128 l_max=6
m_max=2 n_heads=8, SO(2)-eSCN equivariant graph attention."""

from __future__ import annotations

from repro_torch.configs import base
from repro_torch.models.gnn import equiformer_v2 as model


def model_cfg(shape: str = "full_graph_sm") -> model.EquiformerV2Config:
    d = base.GNN_SHAPES[shape]
    if shape == "molecule":
        return model.EquiformerV2Config(
            n_layers=12, d_hidden=128, l_max=6, m_max=2, n_heads=8,
            d_in=d["d_feat"], n_out=1, task="graph_regression", n_graphs=d["batch"],
        )
    return model.EquiformerV2Config(
        n_layers=12, d_hidden=128, l_max=6, m_max=2, n_heads=8,
        d_in=d["d_feat"], n_out=d.get("n_out", 7), task="node_classification",
    )


def smoke_cfg() -> model.EquiformerV2Config:
    return model.EquiformerV2Config(
        n_layers=2, d_hidden=16, l_max=2, m_max=1, n_heads=2, d_in=8, n_out=3,
    )


ARCH = base.ArchDef(
    name="equiformer-v2",
    family="gnn",
    cells=base.gnn_cells(),
    model_cfg=model_cfg,
    smoke_cfg=smoke_cfg,
    build_dryrun=lambda shape, mesh: base.build_gnn_dryrun(
        "equiformer-v2", model, model_cfg(shape), shape, mesh, ARCH.cell(shape),
        needs_pos=True,
    ),
)
