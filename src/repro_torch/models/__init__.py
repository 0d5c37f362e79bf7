"""Models of the port: the dense decoder-only LM (`transformer`), its
parameter specs (`param`) and shared layers (`layers`)."""
