// Embedding bag for Hopper (sm_90a): the recsys lookup of a bag of rows.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/embedding_bag.py
// (embedding_bag, body _bag_kernel) and computes what the reference's
// embedding_bag_ref computes:
//   out[b, d] = sum over l with idx[b, l] >= 0 of w[b, l] * table[idx[b, l], d],
// with w = 1 when no weights are given; "mean" divides by max(#valid, 1).
// Ids >= V read the last row, as the reference's gather clamps (the Pallas
// kernel in interpret mode gives NaN there instead); no read leaves the
// table. Sums and the division are float32 (IEEE: no fast math, no
// contracted multiply-adds), and the result is stored in the table's dtype
// (float32 or bfloat16, rounded to nearest even).
//
// The TPU kernel keeps the whole table resident in its fast memory and
// gathers from it a block of bags per grid step. A 1,048,576 x 18 float32
// table (75.5 MB) fits no SM's shared memory, so here the table stays in
// device memory (two thirds of it fit the 50 MB L2) and each lookup reads
// its row from there.
//
// Bound on this card. The least the function must move is the ids (and
// weights), each distinct row once and the output once. This kernel reads
// each lookup's row (a row shared by bags again, from L2 where it stays):
// 72 bytes at D = 18 float32, which span three 32-byte sectors wherever
// the row starts. Staging a batch's distinct rows once is later work. On
// DIN's serve_bulk batch the kernel is held by the latency of each bag's
// chain of loads times the bags an SM holds at once (its registers), more
// than by bytes: with every row it reads resident in L2 it still takes
// about 60 % of its time, and reading the ids alone about 30 %
// (flash_compare.py --bag's probes; the designs that lost are in PERF.md).
//
// Layout: one warp a bag. The bag's entries go in chunks of 32: lane j
// loads entry l0 + j's id and weight (one coalesced load each), and the
// next chunk's ids and weights are loaded while this chunk's rows are in
// flight. __ballot_sync(id >= 0) gives the chunk's valid entries: their
// count (for "mean") is its popcount, and a chunk with none issues no row
// load. The warp's lanes form kSlots = 8 entry slots of kLanes = 4 lanes;
// slot s takes the chunk's entries s, s + 8, s + 16, s + 24 (its four rows
// in flight at once), gets each id and weight by __shfl_sync, and its
// lanes read the row's vectors, lane i vectors i, i + 4, i + 8 (kCols = 3
// a lane): at D = 18 float32 (9 vectors of 2) lane 0's third vector is
// the ninth. A row of more than 12 vectors takes several column passes
// over the bag's ids. Every row load of a chunk is issued before any is
// summed; a padding entry issues no load, and an id >= V is clamped
// before its load.
//
// Vectors: a float32 row of even D starts 8-byte aligned when the table
// does (72 bytes a row at D = 18), and a bfloat16 row of even D 4-byte
// aligned, so there a lane reads two elements in one load (VEC = 2). The
// host checks D and the table's base address; any other D or base reads
// one element a load (VEC = 1). The branches: <T, VEC> for T float32 and
// bfloat16 and VEC 1 and 2.
//
// Order of the sums, the same bits on every run: slot s sums w * x over
// the bag's entries l = s mod 8 in ascending l (a padding entry in a chunk
// that holds a valid one adds a zero product), each product and sum
// rounded to float32; then the slots are combined by __shfl_xor_sync over
// lane offsets 16, 8, 4, a fixed tree whose every lane ends with the same
// bits; then "mean" divides by the count. No atomics; slot 0 stores each
// output element once.
//
// Depth: a bag's chain is its first chunk's id load, then one row load
// for each chunk that holds a valid entry (at most ceil(L / 32) = 4 at
// L = 100) and the id load of a chunk that holds none, where one thread
// an output element walking the bag made L = 100 dependent id-then-row
// loads. At serve_p99 (512 bags, 512 warps, under one wave of the card)
// that chain is the kernel's time.
//
// Registers and occupancy: see the note after the kernel.
//
// Plain C interface, loaded with ctypes: pointers and the stream as void*.
// The entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;          // threads a block
constexpr int kBags = kThreads / 32;   // bags a block, one warp each
constexpr int kLanes = 4;              // lanes a row
constexpr int kSlots = 32 / kLanes;    // entry slots a warp
constexpr int kRows = 32 / kSlots;     // rows in flight a slot: its share of a chunk
constexpr int kCols = 3;               // vectors a lane holds per column pass
constexpr unsigned kAll = 0xffffffffu;

// one vector of VEC elements at p (aligned to VEC elements), as float32
template <typename T, int VEC> struct Vec;
template <> struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&x)[1]) {
    x[0] = __ldg(p);
  }
};
template <> struct Vec<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float (&x)[2]) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = v.x;
    x[1] = v.y;
  }
};
// bfloat16 is the high half of a float32: widening is a shift
template <> struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[1]) {
    x[0] = __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
};
template <> struct Vec<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[2]) {
    const unsigned v = __ldg(reinterpret_cast<const unsigned*>(p));  // element 0 low
    x[0] = __uint_as_float(v << 16);
    x[1] = __uint_as_float(v & 0xffff0000u);
  }
};

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// entry l of the bag: its id (-1 past L) and weight (zeroed for padding
// where it is used); each lane loads its own entry of a chunk
__device__ __forceinline__ void load_entry(const int32_t* __restrict__ idx,
                                           const float* __restrict__ w, int l, int L,
                                           int32_t& id, float& wt) {
  id = l < L ? __ldg(idx + l) : -1;
  wt = w && l < L ? __ldg(w + l) : 0.f;
}

// Adds w * row over the valid entries of one 32-entry chunk (lane j holds
// entry j's id `cid` and weight `cw`, 0 for padding) into slot `slot`'s
// sums `acc` of vectors c0 + sub + k kLanes.
template <typename T, int VEC>
__device__ __forceinline__ void sum_chunk(const T* __restrict__ table, int64_t V, int D,
                                          int nv, int c0, int sub, int slot, int32_t cid,
                                          float cw, bool weighted, float (&acc)[kCols][VEC]) {
  const T* row[kRows];
  float wr[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int e = u * kSlots + slot;  // the lane holding the entry
    const int32_t rid = __shfl_sync(kAll, cid, e);
    wr[u] = weighted ? __shfl_sync(kAll, cw, e) : 1.f;
    const int64_t r = (int64_t)rid < V ? (int64_t)rid : V - 1;
    row[u] = rid >= 0 ? table + r * D : nullptr;
  }
  float x[kRows][kCols][VEC];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int c = c0 + sub + k * kLanes;
      if (row[u] != nullptr && c < nv) {
        Vec<T, VEC>::load(row[u] + c * VEC, x[u][k]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[u][k][v] = 0.f;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        acc[k][v] = __fadd_rn(acc[k][v], __fmul_rn(wr[u], x[u][k][v]));
      }
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table,
                     const int32_t* __restrict__ indices,
                     const float* __restrict__ weights,  // null: ones
                     T* __restrict__ out, int64_t B, int64_t V, int L, int D,
                     int mean) {
  const int64_t b = (int64_t)blockIdx.x * kBags + threadIdx.x / 32;
  if (b >= B) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;   // vector lane within a slot
  const int slot = lane / kLanes;  // entry slot
  const int32_t* idx = indices + b * L;
  const float* w = weights ? weights + b * L : nullptr;
  const int nv = D / VEC;  // vectors a row
  int count = 0;
  for (int c0 = 0; c0 < nv; c0 += kLanes * kCols) {  // column passes
    float acc[kCols][VEC];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[k][v] = 0.f;
    }
    int32_t id;
    float wt;
    load_entry(idx, w, lane, L, id, wt);
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int32_t cid = id;
      const float cw = cid >= 0 ? wt : 0.f;
      // the next chunk's ids and weights go out with this chunk's rows
      load_entry(idx, w, l0 + 32 + lane, L, id, wt);
      const unsigned valid = __ballot_sync(kAll, cid >= 0);
      if (c0 == 0) count += __popc(valid);
      if (valid != 0) {  // warp-uniform
        sum_chunk<T, VEC>(table, V, D, nv, c0, sub, slot, cid, cw, w != nullptr, acc);
      }
    }
    // combine the slots: lanes sub, sub + 4, ..., sub + 28 in a fixed tree
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
#pragma unroll
        for (int off = 16; off >= kLanes; off >>= 1) {
          acc[k][v] = __fadd_rn(acc[k][v], __shfl_xor_sync(kAll, acc[k][v], off));
        }
      }
    }
    if (slot == 0) {
      const float n = (float)(count > 1 ? count : 1);
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int c = c0 + sub + k * kLanes;
        if (c >= nv) continue;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float y = mean ? __fdiv_rn(acc[k][v], n) : acc[k][v];
          out[b * D + c * VEC + v] = from_float<T>(y);
        }
      }
    }
  }
}

// Registers a thread (nvcc -Xptxas -v, sm_90a, CUDA 12.9), no shared
// memory, no spills: <float, 2> 64 (D = 18), <float, 1> 56,
// <bf16, 2> 64, <bf16, 1> 56. So 8 and 9 blocks of 128 threads an SM.

template <typename T>
int launch(const void* table, const void* indices, const void* weights, void* out,
           int64_t B, int64_t V, int L, int D, int mean, cudaStream_t stream) {
  const int64_t blocks = (B + kBags - 1) / kBags;
  if (blocks >= (int64_t(1) << 31)) return (int)cudaErrorInvalidConfiguration;
  const bool vec = D % 2 == 0 && (uintptr_t)table % (2 * sizeof(T)) == 0;
  if (vec) {
    embedding_bag_kernel<T, 2><<<(unsigned int)blocks, kThreads, 0, stream>>>(
        (const T*)table, (const int32_t*)indices, (const float*)weights, (T*)out, B, V, L,
        D, mean);
  } else {
    embedding_bag_kernel<T, 1><<<(unsigned int)blocks, kThreads, 0, stream>>>(
        (const T*)table, (const int32_t*)indices, (const float*)weights, (T*)out, B, V, L,
        D, mean);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. weights may be null (every weight 1).
extern "C" int embedding_bag(const void* table, const void* indices,
                             const void* weights, void* out, int dtype,
                             int64_t B, int64_t V, int L, int D, int mean,
                             void* stream) {
  if (B == 0 || D == 0) return 0;
  return dtype == 0
             ? launch<float>(table, indices, weights, out, B, V, L, D, mean,
                             (cudaStream_t)stream)
             : launch<__nv_bfloat16>(table, indices, weights, out, B, V, L, D,
                                     mean, (cudaStream_t)stream);
}
