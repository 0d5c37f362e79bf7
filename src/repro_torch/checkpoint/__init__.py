"""Checkpointing with a manifest (the reference's `checkpoint/`)."""

from repro_torch.checkpoint.checkpointer import (Checkpointer, latest_step,
                                                 restore_checkpoint, save_checkpoint)
