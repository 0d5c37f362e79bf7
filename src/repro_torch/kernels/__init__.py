"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

  frontier        -- BFS frontier expansion, dense and bit-packed visited
                     sets (csrc/frontier.cu); wrappers, word layout math
  flash_attention -- prefill attention with an online softmax
                     (csrc/flash_attention.cu)
  ops             -- kernel-or-plain dispatch (attention)
  ref             -- the plain PyTorch version of every kernel
  build           -- nvcc build into build/kernels/ at first use, ctypes
                     loader, the launch helper and the launch counts
"""
