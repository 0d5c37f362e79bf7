"""The zoo's graph shapes (the reference's `configs/base.py`
`GNN_SHAPES`). The rest of that file (cells, logical sharding rules,
dry-run builders) is JAX mesh machinery and is not ported.

All four are synthetic (`graph/generators.py`, `data/graphs.py`):
full_graph_sm has Cora's shape, minibatch_lg Reddit's with GraphSAGE's
fanout, ogb_products ogbn-products' (distributed in the reference), and
molecule is a batch of 128 small molecular graphs.
"""

GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=2708, n_edges=10556, d_feat=1433, n_out=7),
    "minibatch_lg": dict(
        kind="train", n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024,
        fanout=(15, 10), d_feat=602, n_out=41,
    ),
    "ogb_products": dict(
        kind="train", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_out=47,
        distributed=True,
    ),
    "molecule": dict(kind="train", n_nodes=30, n_edges=64, batch=128, d_feat=16),
}
