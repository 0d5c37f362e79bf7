"""GNN building blocks of the port: the edge-index message-passing
primitives (`message_passing`). The GNN models themselves are later work."""
