// Segment sum for Hopper (sm_90a): the GNN message-aggregation primitive.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/segment_reduce.py
// (segment_sum_sorted, body _seg_sum_kernel; the unsorted entry point
// segment_sum sorts first, as here) and computes what it computes:
//   out[s, d] = sum over the edges e of segment s of values[e, d],
// summed in float32 and stored as float32 for float32 or bfloat16 values.
// Edges whose id lies outside [0, N) are dropped; an empty segment is 0.
//
// The wrapper (kernels/segment_reduce.py) has already grouped the edges by
// segment: a stable sort gives `order`, the edges in segment order (null
// when the values are sorted already), and `offsets` (N + 1), so that
// segment s owns sorted positions [offsets[s], offsets[s + 1]) and dropped
// edges lie outside every segment. The TPU kernel turns a block of sorted
// edges into a one-hot matrix product on its matrix unit and accumulates
// across sequential grid steps; neither carries over. Here one warp owns one
// output row: it walks that segment's edges in sorted order, reading
// values[order[e]] through the permutation (no sorted copy of the values),
// keeps the sums in registers, combines its lanes by shuffles in a fixed
// order and stores the row once. No atomics, no zero-fill pass, and the
// same inputs give the same bits on every run.
//
// The warp's 32 lanes are split into 32 / G edge slots of G lanes, with G
// the power of two at or above D (at most 32; a template parameter): at
// D = 75 all 32 lanes read one edge's row, three columns each; at D = 1
// (the count launch of a mean) 32 edges are read at once. At G = 32 a lane
// holds kCols columns per pass, and rows wider than 32 * kCols take several
// passes over the segment.
//
// Bound on this card: memory. The kernel must read each kept edge's row of
// values and its order entry once, the offsets once, and write the output
// once. Reads of values[order[e]] are random rows (a 300-byte row at the
// GNN width touches three or four 128-byte lines). A power-law hub
// serialises on its warp: each slot keeps up to kUnroll row loads in
// flight so that their latencies overlap; splitting hubs across warps is
// later work.
//
// Plain C interface, loaded with ctypes: pointers and the stream as void*.
// The entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 segments a block
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 3;       // columns a lane holds per pass at G = 32
constexpr int kUnroll = 8;     // rows a slot has in flight

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ values,
                   const int64_t* __restrict__ order,  // null: identity
                   const int64_t* __restrict__ offsets, float* __restrict__ out,
                   int64_t n_segments, int D) {
  constexpr int kSlots = 32 / G;                  // edge slots a warp
  constexpr int kU = G < kUnroll ? G : kUnroll;   // rows in flight a slot
  constexpr int kC = G < 32 ? 1 : kCols;          // columns a lane, a pass
  const int64_t seg = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (seg >= n_segments) return;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;   // column lane within an edge slot
  const int slot = lane / G;  // edge slot
  const int64_t begin = offsets[seg], end = offsets[seg + 1];
  float* row_out = out + seg * D;
  for (int d0 = 0; d0 < D; d0 += G * kC) {
    float acc[kC];
#pragma unroll
    for (int k = 0; k < kC; ++k) acc[k] = 0.f;
    // 32 edges at a time: each lane loads one order entry (coalesced), then
    // each slot reads kU rows before it adds any, so that a hub's row
    // loads overlap instead of waiting on each other
    for (int64_t c = begin; c < end; c += 32) {
      const int64_t p = c + lane;
      const int64_t mine = p < end ? (order ? __ldg(order + p) : p) : -1;
      const int64_t mine_0 = __shfl_sync(0xffffffffu, mine, 0);  // a live row
#pragma unroll 1
      for (int j0 = 0; j0 < 32; j0 += kSlots * kU) {
        float x[kU][kC];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int64_t r = __shfl_sync(0xffffffffu, mine, j0 + u * kSlots + slot);
          // every load is issued (a dead one reads a live row, or column
          // D - 1) and a select drops it: no branch stands between the
          // loads, so they are all in flight at once
          const T* row = values + (r >= 0 ? r : mine_0) * D;
#pragma unroll
          for (int k = 0; k < kC; ++k) {
            const int d = d0 + sub + k * G;
            const float v = to_float(row[d < D ? d : D - 1]);
            x[u][k] = r >= 0 && d < D ? v : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
#pragma unroll
          for (int k = 0; k < kC; ++k) acc[k] += x[u][k];
        }
      }
    }
    // combine the edge slots: lanes sub, sub + G, sub + 2G, ... in a fixed tree
#pragma unroll
    for (int k = 0; k < kC; ++k) {
#pragma unroll
      for (int off = 16; off >= G; off >>= 1) {
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
      }
    }
    if (slot == 0) {
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const int d = d0 + sub + k * G;
        if (d < D) row_out[d] = acc[k];
      }
    }
  }
}

template <typename T, int G>
int launch_g(const void* values, const void* order, const void* offsets,
             void* out, int64_t n_segments, int D, cudaStream_t stream) {
  const int64_t blocks = (n_segments + kWarps - 1) / kWarps;
  segment_sum_kernel<T, G><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      (const T*)values, (const int64_t*)order, (const int64_t*)offsets,
      (float*)out, n_segments, D);
  return (int)cudaGetLastError();
}

// G, the lanes that share one edge's row: the power of two at or above D,
// at most 32
template <typename T>
int launch(const void* values, const void* order, const void* offsets,
           void* out, int64_t n_segments, int D, cudaStream_t stream) {
  if (D <= 1) return launch_g<T, 1>(values, order, offsets, out, n_segments, D, stream);
  if (D <= 2) return launch_g<T, 2>(values, order, offsets, out, n_segments, D, stream);
  if (D <= 4) return launch_g<T, 4>(values, order, offsets, out, n_segments, D, stream);
  if (D <= 8) return launch_g<T, 8>(values, order, offsets, out, n_segments, D, stream);
  if (D <= 16) return launch_g<T, 16>(values, order, offsets, out, n_segments, D, stream);
  return launch_g<T, 32>(values, order, offsets, out, n_segments, D, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. order may be null (values already sorted).
extern "C" int segment_sum(const void* values, const void* order,
                           const void* offsets, void* out, int dtype,
                           int64_t n_segments, int D, void* stream) {
  if (n_segments == 0 || D == 0) return 0;
  return dtype == 0
             ? launch<float>(values, order, offsets, out, n_segments, D,
                             (cudaStream_t)stream)
             : launch<__nv_bfloat16>(values, order, offsets, out, n_segments,
                                     D, (cudaStream_t)stream);
}
