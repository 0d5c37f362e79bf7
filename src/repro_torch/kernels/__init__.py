"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

  frontier        -- BFS frontier expansion, dense and bit-packed visited
                     sets (csrc/frontier.cu); wrappers, word layout math
  flash_attention -- prefill attention with an online softmax
                     (csrc/flash_attention.cu)
  segment_reduce  -- segment sum, one warp per output row over edges
                     grouped by a sort (csrc/segment_sum.cu)
  embedding_bag   -- weighted sum / mean of bags of table rows
                     (csrc/embedding_bag.cu)
  ops             -- kernel-or-plain dispatch (attention, segment
                     sum / mean / max / min, embedding bag)
  ref             -- the plain PyTorch version of every kernel
  build           -- nvcc build into build/kernels/ at first use, ctypes
                     loader, the launch helper and the launch counts
"""
