"""Optimizer, learning-rate schedule and gradient compression of the port
(the reference's `optim/adamw.py`, `optim/schedule.py` and
`optim/grad_compression.py`)."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.optim.grad_compression import (
    ErrorFeedbackState,
    compressed_psum,
    dequantize_int8,
    init_error_feedback,
    quantize_int8,
)
