"""Models of the port: the dense and MoE decoder-only LM (`transformer`,
`moe`), their parameter specs (`param`) and shared layers (`layers`), the
GNN zoo (`gnn`: message passing, EGNN, PNA, EquiformerV2, GraphCast) and
the recsys model (`recsys.din`)."""
