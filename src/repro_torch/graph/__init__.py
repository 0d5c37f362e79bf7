"""Graph substrate (numpy): CSR layouts, generators, hash placement."""
