"""Deterministic synthetic data (numpy; replayable from (step, seed))."""

from repro_torch.data.graphs import full_graph_batch, gnn_batch, molecule_batch
from repro_torch.data.recsys import din_batch
from repro_torch.data.tokens import token_batch

__all__ = ["din_batch", "full_graph_batch", "gnn_batch", "molecule_batch", "token_batch"]
