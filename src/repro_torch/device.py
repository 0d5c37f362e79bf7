"""Device policy of the port.

Every entry point (`ServingEngine`, `Router`, `make_cache`, `build_storage`,
`build_landmark_index`, ...) takes a `device` argument and resolves it here.
The port runs on the GPU: asking for nothing means CUDA, and a machine
without CUDA raises instead of quietly running on the CPU. The CPU is used
only when the caller names it (the tests do), and there each kernel wrapper
takes its plain PyTorch version because its tensors lie on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> cuda; a CUDA device without CUDA raises; "cpu" only on request.
    A CUDA device comes back with its index, so devices compare equal to
    those of the tensors made on them."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
