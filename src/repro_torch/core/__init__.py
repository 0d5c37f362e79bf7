"""gRouting's core in PyTorch: set-associative processor cache, decoupled
storage tier, visited-set layouts, the batched h-hop query engine, capacity
dispatch with a carry-over backlog, landmark preprocessing, the graph
embedding (and both tables' graph updates) and routers; the query engine
answers h-hop aggregation, reachability and random walks."""
