"""gRouting's core in PyTorch: set-associative processor cache, decoupled
storage tier, visited-set layouts, the batched h-hop query engine, capacity
dispatch with a carry-over backlog, landmark preprocessing and routers."""
