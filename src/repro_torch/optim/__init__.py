"""Optimizer and learning-rate schedule of the port (the reference's
`optim/adamw.py` and `optim/schedule.py`). The reference's
`grad_compression.py` (a collective over the "pod" axis) belongs to the
sharding slice and is not ported here."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedule import warmup_cosine
