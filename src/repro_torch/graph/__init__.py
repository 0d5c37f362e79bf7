"""Graph substrate (numpy): CSR layouts, generators, hash placement and the
fanout neighbor sampler."""
