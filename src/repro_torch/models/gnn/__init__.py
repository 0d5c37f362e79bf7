"""GNN models of the port: the edge-index message-passing primitives
(`message_passing`) and the zoo built on them: `egnn`, `pna`,
`equiformer_v2` and `graphcast`.

Batch format (static shapes; -1 padded edges):
  node_feat (N, F) f32 | node_pos (N, 3) f32 | src,dst (E,) int32
  labels (N,) int32 or graph targets | graph_id (N,) int32 (batched molecules)
  seed_mask (N,) f32 (minibatch: loss on seeds only)
"""

from repro_torch.models.gnn import egnn, equiformer_v2, graphcast, pna
from repro_torch.models.gnn.message_passing import aggregate, degree, segment_softmax
