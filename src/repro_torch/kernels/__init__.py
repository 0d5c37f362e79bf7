"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

  frontier -- BFS frontier expansion, dense and bit-packed visited sets
              (csrc/frontier.cu); wrappers, launch counts, word layout math
  ref      -- the plain PyTorch version of every kernel
  build    -- nvcc build into build/kernels/ at first use, ctypes loader
"""
