// BFS frontier expansion for Hopper (sm_90a): the per-hop visited-set update
// of the gRouting query engine, for both visited layouts.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/frontier.py:
//   frontier_expand_dense  <- _frontier_batched_padded / _frontier_batched_kernel
//                             (public frontier_expand_batched; frontier_expand
//                             is its B=1 view)
//   frontier_expand_packed <- _frontier_packed_padded / _frontier_packed_kernel
//                             (public frontier_expand_packed)
//
// Contract (both kernels): for every candidate (b, f, w) with w < deg[b, f]
// and 0 <= id = rows[b, f, w] < n, mark node id in query b's visited set.
// Everything else (-1 padding, stale entries past the row's degree,
// continuation-row ids >= n) is ignored, so padding bits of the packed
// layout stay zero.
//
// The TPU kernels recast this scatter as a compare-reduce over node blocks,
// because TPU vector units have no scatter. Hopper scatters natively, so the
// compare-reduce is not carried over: one thread per candidate stores
// directly. Dense stores write the constant 1, so duplicate and racing
// stores are idempotent; packed stores are atomicOr into 32-bit words, and
// OR commutes. Both results are deterministic.
//
// Bound on this card: memory. The kernel reads deg (4 B per frontier row),
// the valid row entries (4 B each; entries past deg are not loaded), and
// touches at most one visited byte (dense) or word (packed) per valid
// candidate. A warp covers 32 consecutive w of one frontier row, so row
// loads coalesce; visited stores are scattered by nature. Offsets are 64-bit
// because b * n grows with the graph. One obvious later step is to skip
// frontier rows that are all padding without launching their threads.
//
// Plain C interface, loaded with ctypes: pointers and the stream as void*,
// sizes as int64 / int. Each entry point launches on the given stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void frontier_dense_kernel(const int32_t* __restrict__ rows,
                                      const int32_t* __restrict__ deg,
                                      uint8_t* __restrict__ visited,
                                      int64_t total, int64_t F, int W,
                                      int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t row = i / W;  // flat (b, f)
    const int w = (int)(i - row * W);
    if (w >= __ldg(deg + row)) continue;
    const int32_t id = __ldg(rows + i);
    if (id < 0 || (int64_t)id >= n) continue;
    const int64_t b = row / F;
    visited[b * n + id] = 1;
  }
}

__global__ void frontier_packed_kernel(const int32_t* __restrict__ rows,
                                       const int32_t* __restrict__ deg,
                                       unsigned int* __restrict__ words,
                                       int64_t total, int64_t F, int W,
                                       int64_t n, int64_t nw) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t row = i / W;
    const int w = (int)(i - row * W);
    if (w >= __ldg(deg + row)) continue;
    const int32_t id = __ldg(rows + i);
    if (id < 0 || (int64_t)id >= n) continue;
    const int64_t b = row / F;
    atomicOr(words + b * nw + (id >> 5), 1u << (id & 31));
  }
}

int grid_for(int64_t total) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t need = (total + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * 32;  // grid-stride beyond 32 blocks / SM
  return (int)(need < cap ? (need > 0 ? need : 1) : cap);
}

}  // namespace

extern "C" int frontier_expand_dense(const void* rows, const void* deg,
                                     void* visited, int64_t B, int64_t F,
                                     int W, int64_t n, void* stream) {
  const int64_t total = B * F * (int64_t)W;
  if (total == 0) return 0;
  frontier_dense_kernel<<<grid_for(total), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)deg, (uint8_t*)visited, total, F,
      W, n);
  return (int)cudaGetLastError();
}

extern "C" int frontier_expand_packed(const void* rows, const void* deg,
                                      void* words, int64_t B, int64_t F, int W,
                                      int64_t n, int64_t nw, void* stream) {
  const int64_t total = B * F * (int64_t)W;
  if (total == 0) return 0;
  frontier_packed_kernel<<<grid_for(total), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)deg, (unsigned int*)words, total,
      F, W, n, nw);
  return (int)cudaGetLastError();
}
