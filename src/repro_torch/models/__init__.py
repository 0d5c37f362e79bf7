"""Models of the port: the dense decoder-only LM (`transformer`), its
parameter specs (`param`) and shared layers (`layers`), and the GNN
message-passing primitives (`gnn.message_passing`)."""
