"""Deterministic synthetic data (numpy; replayable from (step, seed))."""

from repro_torch.data.recsys import din_batch
from repro_torch.data.tokens import token_batch

__all__ = ["din_batch", "token_batch"]
