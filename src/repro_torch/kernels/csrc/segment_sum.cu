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
// across sequential grid steps; neither carries over.
//
// Tasks. The unit of work is a task of at most k sorted edges (the
// wrapper's TASK_EDGES, passed at launch), run by a team of lanes that reads values[order[e]] through the permutation (no
// sorted copy of the values) and keeps its sums in registers. A segment of
// L <= k edges is one task, whose team writes the output row. A segment of
// L > k edges (a power-law hub) is ceil(L / k) tasks, edges [j k, (j + 1) k)
// for task j, spread over the grid: each writes a float32 partial row
// into a workspace, and the team that arrives last (an int counter per
// segment) sums the segment's partial rows in task order, j = 0, 1, ...,
// and writes the output row. Task boundaries depend on the offsets and k
// alone, each team sums its edges in a fixed order and combines its lanes
// by shuffles in a fixed tree, so the same inputs give the same bits on
// every run; the only atomic is on the integer counter.
//
// The grid: first n_chunks = 2 ceil(E / k) chunk teams, which hold every
// task of the long segments (ceil(L / k) < 2 L / k for L > k), then one
// team per segment, which sums a short segment and returns at a long one.
// The task table is one prefix sum that the wrapper builds on the device,
// with no host sync: task_end[s] = the number of tasks of the long
// segments up to s. Chunk team x runs task x - (task_end[s] - ceil(L / k))
// of the first segment s with task_end[s] > x (a binary search; teams from
// task_end[N - 1] on return) and writes partial row x; the counter of
// segment s is arrivals[task_end[s] - ceil(L / k)], zero at the launch.
// The chunk teams come first so that the hubs' tasks start early. The
// surplus teams read one table entry and return (their cost on the
// ogb_products graph: PERF.md).
//
// Layout. G, the lanes that share one edge's row, is the power of two at
// or above D (at most 32; a template parameter). At G = 32 (D > 16, the
// GNN width 75) a team is a warp: every lane reads one edge's row, kCols
// columns a lane per pass over the task (rows wider than 32 kCols take
// several passes), kRowsWide rows in flight. At G < 32 (D = 1 is the count
// launch of every mean: an average segment there has 25 edges) a warp
// holds several teams of kNarrowTeam lanes (G lanes at G = 16), each a
// task of its own, so that one warp has several short segments in flight,
// and each team holds kNarrowTeam / G edge slots of kRowsNarrow rows. In
// both, a team loads the order entries of its next rows while the values
// of the current ones are in flight, and a row past the task's end issues
// no load (predicated off).
//
// Bound on this card: memory. The kernel must read each kept edge's row of
// values and its order entry once, the offsets once, and write the output
// once. Reads of values[order[e]] are random rows: a 300-byte row at the
// GNN width touches three or four 128-byte lines, and a 4-byte value at
// width 1 a whole 32-byte sector.
//
// Registers and occupancy: see the table after the kernel. The constants
// were chosen by timing variants (flash_compare.py --segment; PERF.md).
//
// Plain C interface, loaded with ctypes: pointers and the stream as void*.
// The entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // threads a block
constexpr int kCols = 3;          // columns a lane holds per pass at G = 32
constexpr int kRowsWide = 4;      // rows a team has in flight at G = 32
constexpr int kNarrowTeam = 8;    // lanes a task at G < 8
constexpr int kRowsNarrow = 4;    // rows an edge slot has in flight at G < 32

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int G>
struct Layout {
  static constexpr int kTeam = G < kNarrowTeam ? kNarrowTeam : G;  // lanes a task
  static constexpr int kSlots = kTeam / G;                          // edge slots a team
  static constexpr int kRows = G == 32 ? kRowsWide : kRowsNarrow;   // rows in flight a slot
  static constexpr int kC = G == 32 ? kCols : 1;                    // columns a lane, a pass
  static constexpr int kStep = kSlots * kRows;                      // edges a pass
};

// order entries of the rows that edge slot `slot` reads in the pass at c;
// -1 past the end, which issues no load
template <int G>
__device__ __forceinline__ void load_rows(const int64_t* __restrict__ order,
                                          int64_t c, int64_t end, int slot,
                                          int64_t (&r)[Layout<G>::kRows]) {
#pragma unroll
  for (int u = 0; u < Layout<G>::kRows; ++u) {
    const int64_t p = c + u * Layout<G>::kSlots + slot;
    r[u] = p < end ? (order ? __ldg(order + p) : p) : -1;
  }
}

// Sums values[order[e]] over sorted positions e in [begin, end) into
// dst[0, D): lanes of slot 0 store. `tl` is the lane within the team and
// `mask` the team's lanes.
template <typename T, int G>
__device__ __forceinline__ void sum_task(const T* __restrict__ values,
                                         const int64_t* __restrict__ order,
                                         int64_t begin, int64_t end,
                                         float* __restrict__ dst, int D, int tl,
                                         unsigned mask) {
  using Ly = Layout<G>;
  const int sub = tl % G;   // column lane within an edge slot
  const int slot = tl / G;  // edge slot
  for (int d0 = 0; d0 < D; d0 += G * Ly::kC) {
    float acc[Ly::kC];
#pragma unroll
    for (int k = 0; k < Ly::kC; ++k) acc[k] = 0.f;
    int64_t next[Ly::kRows];
    load_rows<G>(order, begin, end, slot, next);
    for (int64_t c = begin; c < end; c += Ly::kStep) {
      int64_t r[Ly::kRows];
#pragma unroll
      for (int u = 0; u < Ly::kRows; ++u) r[u] = next[u];
      // the next pass's order entries go out with this pass's rows
      load_rows<G>(order, c + Ly::kStep, end, slot, next);
      float x[Ly::kRows][Ly::kC];
#pragma unroll
      for (int u = 0; u < Ly::kRows; ++u) {
#pragma unroll
        for (int k = 0; k < Ly::kC; ++k) {
          const int d = d0 + sub + k * G;
          x[u][k] = r[u] >= 0 && d < D ? to_float(values[r[u] * D + d]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < Ly::kRows; ++u) {
#pragma unroll
        for (int k = 0; k < Ly::kC; ++k) acc[k] += x[u][k];
      }
    }
    // combine the edge slots: lanes sub, sub + G, sub + 2G, ... in a fixed tree
#pragma unroll
    for (int k = 0; k < Ly::kC; ++k) {
#pragma unroll
      for (int off = Ly::kTeam / 2; off >= G; off >>= 1) {
        acc[k] += __shfl_xor_sync(mask, acc[k], off);
      }
    }
    if (slot == 0) {
#pragma unroll
      for (int k = 0; k < Ly::kC; ++k) {
        const int d = d0 + sub + k * G;
        if (d < D) dst[d] = acc[k];
      }
    }
  }
}

// the first segment s with task_end[s] > x (task_end ascending, n entries)
__device__ __forceinline__ int64_t task_segment(const int64_t* __restrict__ task_end,
                                                int64_t n, int64_t x) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (__ldg(task_end + mid) <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ values,
                   const int64_t* __restrict__ order,  // null: identity
                   const int64_t* __restrict__ offsets,
                   const int64_t* __restrict__ task_end, int64_t k, int64_t n_chunks,
                   float* __restrict__ partial, int* __restrict__ arrivals,
                   float* __restrict__ out, int64_t n_segments, int D) {
  constexpr int kTeam = Layout<G>::kTeam;
  const int64_t team = (int64_t)blockIdx.x * (kThreads / kTeam) + threadIdx.x / kTeam;
  const int tl = threadIdx.x % kTeam;
  const unsigned mask =
      kTeam == 32 ? 0xffffffffu : ((1u << kTeam) - 1) << ((threadIdx.x & 31) & ~(kTeam - 1));
  if (team >= n_chunks) {  // a segment: its one task, unless it is long
    const int64_t seg = team - n_chunks;
    if (seg >= n_segments) return;
    const int64_t begin = offsets[seg], end = offsets[seg + 1];
    if (end - begin <= k) sum_task<T, G>(values, order, begin, end, out + seg * D, D, tl, mask);
    return;
  }
  // chunk team `team`: a task of a long segment, which writes partial row `team`
  if (team >= task_end[n_segments - 1]) return;
  const int64_t seg = task_segment(task_end, n_segments, team);
  const int64_t seg_begin = offsets[seg], seg_end = offsets[seg + 1];
  const int64_t n_tasks = (seg_end - seg_begin + k - 1) / k;
  const int64_t row0 = task_end[seg] - n_tasks;  // the partial row of task 0
  const int64_t begin = seg_begin + (team - row0) * k;
  const int64_t end = begin + k < seg_end ? begin + k : seg_end;
  sum_task<T, G>(values, order, begin, end, partial + team * D, D, tl, mask);
  // the last of the segment's tasks to arrive sums the partial rows in
  // task order: each team's row is visible before its arrival counts
  __threadfence();
  __syncwarp(mask);
  int last = 0;
  if (tl == 0) {
    __threadfence();
    last = atomicAdd(arrivals + row0, 1) == n_tasks - 1;
  }
  last = __shfl_sync(mask, last, 0, kTeam);
  if (!last) return;
  __threadfence();
  const float* rows = partial + row0 * D;
  for (int d = tl; d < D; d += kTeam) {
    float acc = 0.f;
#pragma unroll 8
    for (int64_t i = 0; i < n_tasks; ++i) acc += __ldcg(rows + i * D + d);
    out[seg * D + d] = acc;
  }
}

// Registers a thread (nvcc -Xptxas -v, sm_90a, CUDA 12.8) and the blocks
// of 256 threads an SM holds by them; no shared memory, no barriers:
//   G = 32 (D > 16; the GNN width 75): 48 -> 5 blocks, 40 warps
//   G = 16 ... 2: 64 -> 4 blocks, 32 warps (4-8 bytes spilled, but bf16 at
//                 G = 16, 8)
//   G = 1 (the count launch): 64 -> 4 blocks, 32 warps (128 teams)

template <typename T, int G>
int launch_g(const void* values, const void* order, const void* offsets,
             const void* task_end, int64_t k, int64_t n_chunks, void* partial,
             void* arrivals, void* out, int64_t n_segments, int D, cudaStream_t stream) {
  constexpr int64_t kTeams = kThreads / Layout<G>::kTeam;
  const int64_t blocks = (n_chunks + n_segments + kTeams - 1) / kTeams;
  if (blocks >= (int64_t(1) << 31)) return (int)cudaErrorInvalidConfiguration;
  segment_sum_kernel<T, G><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      (const T*)values, (const int64_t*)order, (const int64_t*)offsets,
      (const int64_t*)task_end, k, n_chunks, (float*)partial, (int*)arrivals, (float*)out,
      n_segments, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* values, const void* order, const void* offsets,
           const void* task_end, int64_t k, int64_t n_chunks, void* partial,
           void* arrivals, void* out, int64_t n_segments, int D, cudaStream_t stream) {
#define SEGMENT_SUM_LAUNCH(G)                                                 \
  return launch_g<T, G>(values, order, offsets, task_end, k, n_chunks, partial, \
                        arrivals, out, n_segments, D, stream)
  if (D <= 1) SEGMENT_SUM_LAUNCH(1);
  if (D <= 2) SEGMENT_SUM_LAUNCH(2);
  if (D <= 4) SEGMENT_SUM_LAUNCH(4);
  if (D <= 8) SEGMENT_SUM_LAUNCH(8);
  if (D <= 16) SEGMENT_SUM_LAUNCH(16);
  SEGMENT_SUM_LAUNCH(32);
#undef SEGMENT_SUM_LAUNCH
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. order may be null (values already sorted).
// task_end: N entries (the wrapper's segment_tasks, built with task length
// k); n_chunks: 2 ceil(E / k) chunk teams; partial: n_chunks rows of D
// float32; arrivals: n_chunks ints, zero.
extern "C" int segment_sum(const void* values, const void* order,
                           const void* offsets, const void* task_end, int64_t k,
                           int64_t n_chunks, void* partial, void* arrivals,
                           void* out, int dtype, int64_t n_segments, int D,
                           void* stream) {
  if (n_segments == 0 || D == 0) return 0;
  return dtype == 0
             ? launch<float>(values, order, offsets, task_end, k, n_chunks, partial,
                             arrivals, out, n_segments, D, (cudaStream_t)stream)
             : launch<__nv_bfloat16>(values, order, offsets, task_end, k, n_chunks,
                                     partial, arrivals, out, n_segments, D,
                                     (cudaStream_t)stream);
}
