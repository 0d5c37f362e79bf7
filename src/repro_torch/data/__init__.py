"""Deterministic synthetic data (numpy; replayable from (step, seed))."""

from repro_torch.data.tokens import token_batch

__all__ = ["token_batch"]
