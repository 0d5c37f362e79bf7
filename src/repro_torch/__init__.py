"""gRouting in PyTorch: smart query routing for distributed graph querying
with decoupled storage, ported from the JAX package `repro` to CUDA.

The package mirrors `repro`'s module paths, so each function has its
counterpart under the same name:

  repro_torch.graph    -- CSR layouts, generators, hash placement (numpy)
  repro_torch.core     -- cache, storage, visited sets, query engine,
                          dispatch, landmarks, routers, workloads
  repro_torch.kernels  -- the hand-written CUDA kernels (csrc/), their
                          build/loader and plain PyTorch versions
  repro_torch.serve    -- the end-to-end ServingEngine
  repro_torch.models   -- the dense LM (prefill and decode), its layers
                          and parameter specs; GNN message passing
  repro_torch.configs  -- LM configurations (qwen3-4b, qwen2.5-14b, gemma2-27b)
  repro_torch.data     -- synthetic token and DIN click-log batches
  repro_torch.convert  -- state carried across from / back to `repro`

It imports neither `jax` nor anything of `repro`. Entry points run on CUDA
unless the caller passes device="cpu" (see `repro_torch.device`).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
__version__ = "0.1.0"
