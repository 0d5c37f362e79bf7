"""graphcast [arXiv:2212.12794]: n_layers=16 d_hidden=512
mesh_refinement=6 aggregator=sum n_vars=227, encoder-processor-decoder.

The zoo's graph shapes run the processor stack in `generic` mode on the
given graph (see models/gnn/graphcast.py); the native weather mode (grid
<-> icosahedral multimesh) is `forward_weather`."""

from __future__ import annotations

from repro_torch.configs import base
from repro_torch.models.gnn import graphcast as model


def model_cfg(shape: str = "full_graph_sm") -> model.GraphCastConfig:
    d = base.GNN_SHAPES[shape]
    if shape == "molecule":
        return model.GraphCastConfig(
            n_layers=16, d_hidden=512, n_vars=227, d_in=d["d_feat"], n_out=1,
            mode="generic", task="regression",
        )
    return model.GraphCastConfig(
        n_layers=16, d_hidden=512, n_vars=227, d_in=d["d_feat"],
        n_out=d.get("n_out", 7), mode="generic", task="node_classification",
    )


def smoke_cfg() -> model.GraphCastConfig:
    return model.GraphCastConfig(
        n_layers=2, d_hidden=32, n_vars=8, d_in=8, n_out=3,
        mode="generic", task="node_classification",
    )


ARCH = base.ArchDef(
    name="graphcast",
    family="gnn",
    cells=base.gnn_cells(),
    model_cfg=model_cfg,
    smoke_cfg=smoke_cfg,
    build_dryrun=lambda shape, mesh: base.build_gnn_dryrun(
        "graphcast", model, model_cfg(shape), shape, mesh, ARCH.cell(shape),
        needs_pos=False,
    ),
)
