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
// layout stay zero. Dense stores write the constant 1, so duplicate and
// racing stores are idempotent; packed stores are atomicOr into 32-bit
// words, and OR commutes. Both results are deterministic.
//
// The TPU kernels recast this scatter as a compare-reduce over node blocks,
// because TPU vector units have no scatter. Hopper scatters natively, so the
// compare-reduce is not carried over.
//
// What a launch on the serving path is: rows (16, 4096, 64) and deg
// (16, 4096) at every link of the query engine's chain loop, one launch a
// link. Link 0 of a hop holds the frontier; the later links hold only the
// continuation rows of hubs, so most launches carry a few dozen live rows
// (deg > 0) out of 65,536, and a hop's first link at most a few thousand,
// packed at the front of each query's F rows. The least such a launch must
// move is deg, read once (4 B a row: 262,144 B, 0.078 us at 3.35 TB/s),
// plus the live entries and the visited bytes or words they touch: a
// median launch on the path is bound at ~0.08 us, so the launch itself is
// the floor (an all-padding hop at this shape takes ~1.2-1.3 us on an
// H100; PERF.md has the measured figures).
//
// So the grid is over frontier rows, not candidates:
//   - one thread per flat row (b, f) loads deg; a warp takes 32 consecutive
//     rows, so its load is one 128-byte line. Warp w of block b takes chunk
//     w * blocks + b: a run of live rows (a hop's frontier) spreads over
//     the blocks and so over the SMs. 256 rows a block: the path's 65,536
//     rows are 256 blocks, one wave;
//   - each warp takes __ballot_sync(deg > 0) over its rows; a warp with no
//     live row exits after its one load;
//   - b = row / F is worked out once a live row, by its own lane;
//   - the warp serves its live rows together, kRowsFew (or, with more than
//     kManyRows live rows, kRowsMany) at a time: lanes over w in steps of
//     32 (coalesced loads of each row), every load of those rows issued
//     before their stores. Few rows in flight keep a light warp short; many
//     keep a heavy warp's loads in flight;
//   - packed stores are one atomicOr a lane. Lanes on one word could OR
//     their bits first (__match_any_sync, or a shuffle scan over runs of
//     lanes): over the path's launches both cost more than they saved
//     (PERF.md).
// Registers (nvcc -Xptxas -v, sm_90a, CUDA 12.8), no spills: 80 a thread
// with 32-bit indices, both layouts, so 3 blocks of 256 fit an SM and the
// path's 256 blocks need 2; with 64-bit indices 128 (dense, 2 blocks an
// SM) and 144 (packed, 1 block).
// Indices are 32-bit when the grid's rows times W and the visited set's
// B*n bytes (B*nw words) fit, which the host checks; else 64-bit (a build
// that always takes 64-bit indices is slower on the path's launches, most
// of all packed, which fits one block an SM; PERF.md). There is
// no extra launch, no compaction pass and no host sync: the grid is
// ceil(B*F / 256) blocks.
//
// Plain C interface, loaded with ctypes: pointers and the stream as void*,
// sizes as int64 / int. Each entry point launches on the given stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // frontier rows a block: 8 warps of 32
constexpr int kRowsFew = 4;          // live rows a warp loads before it stores...
constexpr int kRowsMany = 16;        // ... or, when it has more than kManyRows
constexpr int kManyRows = 8;
constexpr unsigned kFull = 0xffffffffu;

// The visited set as the warp's stores see it: `base(b)` is query b's
// first element, `mark` stores one id where `ok`.
template <typename Index>
struct DenseSet {
  uint8_t* __restrict__ visited;
  Index n;
  __device__ Index base(Index b) const { return b * n; }
  __device__ void mark(Index base, int32_t id, bool ok) const {
    if (ok) visited[base + (Index)id] = 1;
  }
};

template <typename Index>
struct PackedSet {
  unsigned int* __restrict__ words;
  Index nw;
  __device__ Index base(Index b) const { return b * nw; }
  __device__ void mark(Index base, int32_t id, bool ok) const {
    if (ok) atomicOr(words + base + (Index)(id >> 5), 1u << (id & 31));
  }
};

// The warp's live rows, K at a time: lanes over w in steps of 32, the K
// rows' loads issued before their stores. d and base are each lane's own
// row's clamped degree and visited base.
template <int K, typename Index, typename Set>
__device__ __forceinline__ void serve(const int32_t* __restrict__ rows,
                                      const Set& set, unsigned live, int d,
                                      Index base_of_lane, Index row0, int W,
                                      Index n, int lane) {
  while (live) {
    Index src[K], base[K];
    int dk[K];
    int span = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = live ? __ffs(live) - 1 : 0;  // warp-uniform
      dk[k] = live ? __shfl_sync(kFull, d, i) : 0;
      base[k] = __shfl_sync(kFull, base_of_lane, i);
      live &= live - 1;
      src[k] = (row0 + i) * (Index)W;
      span = max(span, dk[k]);
    }
    for (int w = lane; w - lane < span; w += 32) {
      int32_t id[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        id[k] = w < dk[k] ? __ldg(rows + src[k] + w) : -1;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        set.mark(base[k], id[k], id[k] >= 0 && (Index)id[k] < n);
      }
    }
  }
}

template <typename Index, typename Set>
__device__ __forceinline__ void expand_rows(const int32_t* __restrict__ rows,
                                            const int32_t* __restrict__ deg,
                                            const Set& set, Index n_rows,
                                            Index F, int W, Index n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // warp w of block b takes chunk w * blocks + b of 32 rows: its deg load
  // is one 128-byte line, and a run of live rows spreads over the SMs
  const Index row0 = ((Index)warp * gridDim.x + blockIdx.x) * 32;
  const Index r = row0 + lane;
  const int d = r < n_rows ? min(__ldg(deg + r), W) : 0;
  const unsigned live = __ballot_sync(kFull, d > 0);
  if (!live) return;
  const Index base = d > 0 ? set.base(r / F) : 0;  // b = r / F, once a row
  if (__popc(live) > kManyRows) {
    serve<kRowsMany>(rows, set, live, d, base, row0, W, n, lane);
  } else {
    serve<kRowsFew>(rows, set, live, d, base, row0, W, n, lane);
  }
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
frontier_dense_kernel(const int32_t* __restrict__ rows,
                      const int32_t* __restrict__ deg,
                      uint8_t* __restrict__ visited, Index n_rows, Index F,
                      int W, Index n) {
  expand_rows<Index>(rows, deg, DenseSet<Index>{visited, n}, n_rows, F, W, n);
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
frontier_packed_kernel(const int32_t* __restrict__ rows,
                       const int32_t* __restrict__ deg,
                       unsigned int* __restrict__ words, Index n_rows,
                       Index F, int W, Index n, Index nw) {
  expand_rows<Index>(rows, deg, PackedSet<Index>{words, nw}, n_rows, F, W, n);
}

// Blocks for n_rows rows, or 0 when the grid would not fit in gridDim.x.
unsigned blocks_for(int64_t n_rows) {
  const int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  return blocks <= INT_MAX ? (unsigned)blocks : 0u;
}

// 32-bit indices hold every row offset (up to the grid's rows times W,
// padding included) and every visited offset
bool fits_32(int64_t rows_total, int64_t vis_total) {
  return rows_total < INT_MAX && vis_total < INT_MAX;
}

}  // namespace

extern "C" int frontier_expand_dense(const void* rows, const void* deg,
                                     void* visited, int64_t B, int64_t F,
                                     int W, int64_t n, void* stream) {
  const int64_t n_rows = B * F;
  if (n_rows == 0 || W == 0) return 0;
  const unsigned blocks = blocks_for(n_rows);
  if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* r = (const int32_t*)rows;
  const int32_t* d = (const int32_t*)deg;
  if (fits_32((int64_t)blocks * kThreads * W, B * n)) {
    frontier_dense_kernel<uint32_t><<<blocks, kThreads, 0, s>>>(
        r, d, (uint8_t*)visited, (uint32_t)n_rows, (uint32_t)F, W, (uint32_t)n);
  } else {
    frontier_dense_kernel<uint64_t><<<blocks, kThreads, 0, s>>>(
        r, d, (uint8_t*)visited, (uint64_t)n_rows, (uint64_t)F, W, (uint64_t)n);
  }
  return (int)cudaGetLastError();
}

extern "C" int frontier_expand_packed(const void* rows, const void* deg,
                                      void* words, int64_t B, int64_t F, int W,
                                      int64_t n, int64_t nw, void* stream) {
  const int64_t n_rows = B * F;
  if (n_rows == 0 || W == 0) return 0;
  const unsigned blocks = blocks_for(n_rows);
  if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* r = (const int32_t*)rows;
  const int32_t* d = (const int32_t*)deg;
  if (fits_32((int64_t)blocks * kThreads * W, B * nw) && n < INT_MAX) {
    frontier_packed_kernel<uint32_t><<<blocks, kThreads, 0, s>>>(
        r, d, (unsigned int*)words, (uint32_t)n_rows, (uint32_t)F, W,
        (uint32_t)n, (uint32_t)nw);
  } else {
    frontier_packed_kernel<uint64_t><<<blocks, kThreads, 0, s>>>(
        r, d, (unsigned int*)words, (uint64_t)n_rows, (uint64_t)F, W,
        (uint64_t)n, (uint64_t)nw);
  }
  return (int)cudaGetLastError();
}
