"""egnn [arXiv:2102.09844]: n_layers=4 d_hidden=64, E(n)-equivariant."""

from __future__ import annotations

from repro_torch.configs import base
from repro_torch.models.gnn import egnn as model


def model_cfg(shape: str = "full_graph_sm") -> model.EGNNConfig:
    d = base.GNN_SHAPES[shape]
    if shape == "molecule":
        return model.EGNNConfig(
            n_layers=4, d_hidden=64, d_in=d["d_feat"], n_out=1,
            task="graph_regression", n_graphs=d["batch"],
        )
    return model.EGNNConfig(
        n_layers=4, d_hidden=64, d_in=d["d_feat"], n_out=d.get("n_out", 7),
        task="node_classification",
    )


def smoke_cfg() -> model.EGNNConfig:
    return model.EGNNConfig(n_layers=2, d_hidden=16, d_in=8, n_out=3,
                            task="node_classification")


ARCH = base.ArchDef(
    name="egnn",
    family="gnn",
    cells=base.gnn_cells(),
    model_cfg=model_cfg,
    smoke_cfg=smoke_cfg,
    build_dryrun=lambda shape, mesh: base.build_gnn_dryrun(
        "egnn", model, model_cfg(shape), shape, mesh, ARCH.cell(shape),
        needs_pos=True,
    ),
)
