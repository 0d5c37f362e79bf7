// Embedding bag for Hopper (sm_90a): the recsys lookup of a bag of rows.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/embedding_bag.py
// (embedding_bag, body _bag_kernel) and computes what the reference's
// embedding_bag_ref computes:
//   out[b, d] = sum over l with idx[b, l] >= 0 of w[b, l] * table[idx[b, l], d],
// with w = 1 when no weights are given; "mean" divides by max(#valid, 1).
// Ids >= V read the last row, as the reference's gather clamps (the Pallas
// kernel in interpret mode gives NaN there instead); no read leaves the
// table. Sums and the division are float32 (IEEE: no fast math), and the
// result is stored in the table's dtype (float32 or bfloat16, rounded to
// nearest even).
//
// The TPU kernel keeps the whole table resident in its fast memory and
// gathers from it a block of bags per grid step. A 1,048,576 x 18 float32
// table (75.5 MB) fits no SM's shared memory, so here the table stays in
// device memory (and largely in the 50 MB L2) and one thread computes one
// output element (b, d): it walks the bag's L entries, and neighbouring
// threads take neighbouring d of one bag, so each row read is one
// contiguous span and the bag's ids and weights are read by all of its
// threads at once (served by the same cache lines).
//
// Bound on this card: memory. The function must read the ids (and the
// weights), each distinct table row it uses once, and write the output
// once; this kernel reads a row once per lookup, so a row shared by many
// bags is read again (from L2 when it stays there). Staging a batch's
// distinct rows once is later work.
//
// Plain C interface, loaded with ctypes: pointers and the stream as void*.
// The entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table,
                     const int32_t* __restrict__ indices,
                     const float* __restrict__ weights,  // null: ones
                     T* __restrict__ out, int64_t total, int64_t V, int L,
                     int D, int mean) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t b = i / D;
  const int d = (int)(i - b * D);
  const int32_t* idx = indices + b * L;
  const float* w = weights ? weights + b * L : nullptr;
  float acc = 0.f;
  int count = 0;
  for (int l = 0; l < L; ++l) {
    const int32_t id = __ldg(idx + l);
    if (id < 0) continue;
    const int64_t row = (int64_t)id < V ? (int64_t)id : V - 1;
    const float x = to_float(table[row * D + d]);
    acc = w ? fmaf(__ldg(w + l), x, acc) : acc + x;
    ++count;
  }
  if (mean) acc = __fdiv_rn(acc, (float)(count > 1 ? count : 1));
  out[i] = from_float<T>(acc);
}

template <typename T>
int launch(const void* table, const void* indices, const void* weights,
           void* out, int64_t B, int64_t V, int L, int D, int mean,
           cudaStream_t stream) {
  const int64_t total = B * (int64_t)D;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  embedding_bag_kernel<T><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      (const T*)table, (const int32_t*)indices, (const float*)weights,
      (T*)out, total, V, L, D, mean);
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
