// Flash attention backward for Hopper (sm_90a): dq, dk and dv of the
// attention that flash_attention.cu computes forward, float32 inside.
//
// The reference has no backward kernel: it differentiates its attention
// with jax.grad (src/repro/kernels/flash_attention.py, flash_attention, on
// the TPU; kernels/ref.py attention_ref elsewhere). This kernel computes the
// gradients of exactly that function:
//   u = (q . k) * scale; x = softcap * tanh(u / softcap) when a cap is set,
//   else u; a masked key (causal kpos > qpos, or a window's kpos <= qpos -
//   window) gets the finite -1e30 instead; P = softmax(x) in float32;
//   o = P @ v.
// With dP = dO @ V^T and Delta = rowsum(dO * O):
//   dV = P^T dO,  dX = P * (dP - Delta),  dU = dX * (1 - tanh^2) under a cap,
//   dQ = scale * dU K,  dK = scale * dU^T Q.
// A masked logit is a constant, so dQ and dK get nothing through it. A row
// whose every key is masked has P uniform over all Skv keys (exp(0) for
// each), so dV gets that row's dO / Skv on every key. Keys past Skv weigh
// nothing. For GQA, dk and dv sum over the q heads of the group.
//
// Design: three launches, no atomics, so every run gives the same bits.
//  1. statistics: a block per (batch * q head, 64 query rows) walks the key
//     tiles its rows see (as the forward does, every tile when a row of the
//     tile sees none) for each row's max and softmax denominator, and sums
//     Delta = dO . O in float32. The forward kernel is left as it is (it
//     does not emit them), so its serving figures stay comparable.
//  2. dK, dV: a block per (batch * kv head, 64 keys) walks, for each q head
//     of its group in order, the q tiles that see its keys or hold a fully
//     masked row, recomputes P and dU from the statistics and accumulates
//     dV += P^T dO and dK += dU^T Q in registers.
//  3. dQ: a block per (batch * q head, 64 query rows) walks the key tiles
//     its rows see, recomputes P and dU and accumulates dQ += dU K.
// Every tile is staged in shared memory as float32 (bf16 inputs are
// widened as they are loaded), products run as float32 FMAs on the CUDA
// cores, and results are written in the inputs' dtype. A thread holds 4 x 4
// entries of a 64 x 64 tile of S / dP, and 4 rows x D/16 columns of its
// block's accumulators.
//
// Bound on this card: operations. 10 * D flops per weighed (query, key)
// pair (the recomputed Q K^T, then dV, dP, dQ and dK, 2 * D each) against
// the bf16 tensor-core peak. This design issues 16 * D (the statistics pass
// and the dQ pass recompute Q K^T, and the dQ pass dP as well) as float32
// FMAs on the CUDA cores, far from that peak: the tensor cores (mma.sync or
// wgmma) are what would close the gap.
//
// Plain C interface, loaded with ctypes: pointers and the stream as void*.
// The entry point launches its three kernels on the given stream, allocates
// nothing (the statistics go to the caller's float32 workspace of 3 * B *
// Hq * Sq) and returns cudaGetLastError() of the launches.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kMaskValue = -1e30f;  // the forward's finite mask
constexpr int kBQ = 64;               // query rows per tile
constexpr int kBK = 64;               // keys per tile
constexpr int kThreads = 256;         // 16 row lanes x 16 key lanes
constexpr int kLDP = kBK + 16;        // P / dU row stride: rows 16 apart in other banks

using bf16 = __nv_bfloat16;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* row_max;  // (B * Hq * Sq) each: max, 1 / denominator, Delta
  float* row_rcp;
  float* delta;
  int64_t Hq, Hkv, group, Sq, Skv;
  int D;
  int causal;
  int has_window;
  int64_t window;
  float softcap;  // 0: none
  float scale;
  int64_t n_qtiles, n_ktiles, n_q_heads, n_kv_heads;  // n_*_heads: B * H
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) { *p = __float2bfloat16(x); }

// keys [key_lo(q), key_hi(q)) are the ones query q sees
__device__ __forceinline__ int64_t key_lo(const Args& a, int64_t q) {
  if (!a.has_window) return 0;
  const int64_t lo = q - a.window + 1;
  return lo > 0 ? lo : 0;
}
__device__ __forceinline__ int64_t key_hi(const Args& a, int64_t q) {
  if (!a.causal) return a.Skv;
  return q + 1 < a.Skv ? q + 1 : a.Skv;
}
__device__ __forceinline__ bool fully_masked(const Args& a, int64_t q) {
  return key_lo(a, q) >= key_hi(a, q);
}

// key tiles [t_lo, t_hi) that query rows [q0, q0 + q_rows) visit: those their
// rows see, or all of them when a row sees none (its P is uniform). Both
// bounds are nondecreasing in q, so fully masked rows are a suffix.
__device__ __forceinline__ void key_tiles(const Args& a, int64_t q0, int q_rows,
                                          int64_t& t_lo, int64_t& t_hi) {
  int64_t klo = key_lo(a, q0), khi = key_hi(a, q0 + q_rows - 1);
  if (fully_masked(a, q0 + q_rows - 1)) {
    klo = 0;
    khi = a.Skv;
  }
  t_lo = klo / kBK;
  t_hi = khi > klo ? (khi + kBK - 1) / kBK : t_lo;
}

// does q tile qt visit keys [k0, k0 + kBK)? (the transpose of key_tiles)
__device__ __forceinline__ bool q_tile_visits(const Args& a, int64_t qt, int64_t k0) {
  const int64_t q0 = qt * kBQ;
  const int64_t q1 = (q0 + kBQ < a.Sq ? q0 + kBQ : a.Sq) - 1;
  if (fully_masked(a, q1)) return true;
  // the first row that sees a key at or past k0; key_lo only grows after it
  const int64_t first = a.causal ? (q0 > k0 ? q0 : k0) : q0;
  return first <= q1 && key_lo(a, first) < k0 + kBK && key_hi(a, first) > k0;
}

// rows [0, kRows) of a row-major (rows, D) matrix into a float32 tile of row
// stride LD; rows >= valid_rows and columns >= D are zeros
template <typename T, int kRows>
__device__ __forceinline__ void load_tile(float* dst, int LD, const T* src, int valid_rows,
                                          int D) {
  for (int e = threadIdx.x; e < kRows * LD; e += kThreads) {
    const int r = e / LD, d = e - r * LD;
    dst[e] = r < valid_rows && d < D ? ld(src + (int64_t)r * D + d) : 0.f;
  }
}

// S = Q K^T (and dP = dO V^T when kDP) for this thread's rows ty + 16 i and
// keys tx + 16 j of a 64 x 64 tile
template <bool kDP>
__device__ __forceinline__ void tile_products(const float* Qs, const float* Ks, const float* Gs,
                                              const float* Vs, int LD, int D, int ty, int tx,
                                              float (&s)[4][4], float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], kb[4], ga[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = Qs[(ty + 16 * i) * LD + d];
      kb[i] = Ks[(tx + 16 * i) * LD + d];
      if (kDP) {
        ga[i] = Gs[(ty + 16 * i) * LD + d];
        vb[i] = Vs[(tx + 16 * i) * LD + d];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        if (kDP) dp[i][j] = fmaf(ga[i], vb[j], dp[i][j]);
      }
  }
}

// the logit of (qpos, kpos) from the raw product, and d logit / d u
__device__ __forceinline__ float logit(const Args& a, float s, int64_t qpos, int64_t kpos,
                                       float& dtanh) {
  const float u = s * a.scale;
  float x = u;
  dtanh = 1.f;
  if (a.softcap != 0.f) {
    const float t = tanhf(u / a.softcap);
    x = a.softcap * t;
    dtanh = 1.f - t * t;
  }
  if ((a.causal && kpos > qpos) || (a.has_window && kpos <= qpos - a.window)) {
    x = kMaskValue;
    dtanh = 0.f;  // a constant: nothing flows back through it
  }
  return x;
}

// P and dU = P (dP - Delta) d logit/du * scale of this thread's 4 x 4 entries
// into shared tiles; rows past Sq and keys past Skv get 0
__device__ __forceinline__ void p_and_du(const Args& a, const float (&s)[4][4],
                                         const float (&dp)[4][4], const float* Ms,
                                         const float* Ls, const float* Ds, int64_t q0,
                                         int q_rows, int64_t k0, int k_rows, int ty, int tx,
                                         float* Ps, float* dUs) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float p = 0.f, du = 0.f;
      if (r < q_rows && c < k_rows) {
        float dtanh;
        const float x = logit(a, s[i][j], q0 + r, k0 + c, dtanh);
        p = __expf(x - Ms[r]) * Ls[r];
        du = p * (dp[i][j] - Ds[r]) * dtanh * a.scale;
      }
      if (Ps != nullptr) Ps[r * kLDP + c] = p;
      dUs[r * kLDP + c] = du;
    }
  }
}

// ---------------------------------------------------------------------------
// 1. statistics: row max, 1 / denominator, Delta
// ---------------------------------------------------------------------------

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads) flash_bwd_stats_kernel(const Args a) {
  constexpr int LD = kD + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int D = a.D;
  const int64_t bh = blockIdx.x % a.n_q_heads, qt = blockIdx.x / a.n_q_heads;
  const int64_t kvh = bh / a.Hq * a.Hkv + bh % a.Hq / a.group;
  const int64_t q0 = qt * kBQ;
  const int q_rows = (int)(a.Sq - q0 < kBQ ? a.Sq - q0 : kBQ);
  const T* qg = static_cast<const T*>(a.q) + (bh * a.Sq + q0) * D;
  const T* kg = static_cast<const T*>(a.k) + kvh * a.Skv * D;

  load_tile<T, kBQ>(Qs, LD, qg, q_rows, D);
  int64_t t_lo, t_hi;
  key_tiles(a, q0, q_rows, t_lo, t_hi);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kMaskValue, l[i] = 0.f;
  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int64_t k0 = t * kBK;
    const int k_rows = (int)(a.Skv - k0 < kBK ? a.Skv - k0 : kBK);
    __syncthreads();  // the previous tile is done with Ks
    load_tile<T, kBK>(Ks, LD, kg + k0 * D, k_rows, D);
    __syncthreads();
    float s[4][4], unused[4][4];
    tile_products<false>(Qs, Ks, nullptr, nullptr, LD, D, ty, tx, s, unused);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x[4], mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float dtanh;
        x[j] = tx + 16 * j < k_rows ? logit(a, s[i][j], q0 + ty + 16 * i, k0 + tx + 16 * j, dtanh)
                                    : -INFINITY;
        mx = fmaxf(mx, x[j]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += __expf(x[j] - mx);
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * __expf(m[i] - mx) + sum;
      m[i] = mx;
    }
  }

  const T* og = static_cast<const T*>(a.o) + (bh * a.Sq + q0) * D;
  const T* gg = static_cast<const T*>(a.dout) + (bh * a.Sq + q0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float dl = 0.f;
    if (r < q_rows)
      for (int d = tx; d < D; d += 16)
        dl = fmaf(ld(og + (int64_t)r * D + d), ld(gg + (int64_t)r * D + d), dl);
#pragma unroll
    for (int w = 1; w < 16; w <<= 1) dl += __shfl_xor_sync(0xffffffffu, dl, w);
    if (tx == 0 && r < q_rows) {
      const int64_t row = bh * a.Sq + q0 + r;
      a.row_max[row] = m[i];
      a.row_rcp[row] = 1.f / fmaxf(l[i], 1e-30f);
      a.delta[row] = dl;
    }
  }
}

// statistics of rows [q0, q0 + q_rows) of head bh into shared memory
__device__ __forceinline__ void load_stats(const Args& a, int64_t bh, int64_t q0, int q_rows,
                                           float* Ms, float* Ls, float* Ds) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int64_t row = bh * a.Sq + q0 + r;
    const bool in = r < q_rows;
    Ms[r] = in ? a.row_max[row] : 0.f;
    Ls[r] = in ? a.row_rcp[row] : 0.f;
    Ds[r] = in ? a.delta[row] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV: a block per (batch * kv head, 64 keys)
// ---------------------------------------------------------------------------

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const Args a) {
  constexpr int LD = kD + 1, kC = kD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * LD;
  float* Qs = Vs + kBK * LD;
  float* Gs = Qs + kBQ * LD;
  float* Ps = Gs + kBQ * LD;
  float* dUs = Ps + kBQ * kLDP;
  float* Ms = dUs + kBQ * kLDP;
  float* Ls = Ms + kBQ;
  float* Ds = Ls + kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int D = a.D;

  // key tile 0 (the heaviest under causal) first
  const int64_t bkv = blockIdx.x % a.n_kv_heads, kt = blockIdx.x / a.n_kv_heads;
  const int64_t b = bkv / a.Hkv, hk = bkv % a.Hkv;
  const int64_t k0 = kt * kBK;
  const int k_rows = (int)(a.Skv - k0 < kBK ? a.Skv - k0 : kBK);
  load_tile<T, kBK>(Ks, LD, static_cast<const T*>(a.k) + (bkv * a.Skv + k0) * D, k_rows, D);
  load_tile<T, kBK>(Vs, LD, static_cast<const T*>(a.v) + (bkv * a.Skv + k0) * D, k_rows, D);

  float dk[4][kC], dv[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int64_t hq = hk * a.group; hq < (hk + 1) * a.group; ++hq) {
    const int64_t bh = b * a.Hq + hq;
    for (int64_t qt = 0; qt < a.n_qtiles; ++qt) {
      if (!q_tile_visits(a, qt, k0)) continue;
      const int64_t q0 = qt * kBQ;
      const int q_rows = (int)(a.Sq - q0 < kBQ ? a.Sq - q0 : kBQ);
      __syncthreads();  // the previous tile is done with Qs, Gs, Ps, dUs
      load_tile<T, kBQ>(Qs, LD, static_cast<const T*>(a.q) + (bh * a.Sq + q0) * D, q_rows, D);
      load_tile<T, kBQ>(Gs, LD, static_cast<const T*>(a.dout) + (bh * a.Sq + q0) * D, q_rows, D);
      load_stats(a, bh, q0, q_rows, Ms, Ls, Ds);
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_products<true>(Qs, Ks, Gs, Vs, LD, D, ty, tx, s, dp);
      p_and_du(a, s, dp, Ms, Ls, Ds, q0, q_rows, k0, k_rows, ty, tx, Ps, dUs);
      __syncthreads();
      // dV[key] += P[r, key] dO[r]; dK[key] += dU[r, key] Q[r]
      for (int r = 0; r < q_rows; ++r) {
        float p[4], du[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[r * kLDP + ty + 16 * i];
          du[i] = dUs[r * kLDP + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float g = Gs[r * LD + tx + 16 * c], qv = Qs[r * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][c] = fmaf(p[i], g, dv[i][c]);
            dk[i][c] = fmaf(du[i], qv, dk[i][c]);
          }
        }
      }
    }
  }

  T* dkg = static_cast<T*>(a.dk) + (bkv * a.Skv + k0) * D;
  T* dvg = static_cast<T*>(a.dv) + (bkv * a.Skv + k0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= k_rows) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        st(dkg + (int64_t)r * D + d, dk[i][c]);
        st(dvg + (int64_t)r * D + d, dv[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: a block per (batch * q head, 64 query rows)
// ---------------------------------------------------------------------------

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Args a) {
  constexpr int LD = kD + 1, kC = kD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + kBQ * LD;
  float* Ks = Gs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* dUs = Vs + kBK * LD;
  float* Ms = dUs + kBQ * kLDP;
  float* Ls = Ms + kBQ;
  float* Ds = Ls + kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int D = a.D;

  // heavy (late) q tiles first
  const int64_t bh = blockIdx.x % a.n_q_heads;
  const int64_t qt = a.n_qtiles - 1 - blockIdx.x / a.n_q_heads;
  const int64_t kvh = bh / a.Hq * a.Hkv + bh % a.Hq / a.group;
  const int64_t q0 = qt * kBQ;
  const int q_rows = (int)(a.Sq - q0 < kBQ ? a.Sq - q0 : kBQ);
  load_tile<T, kBQ>(Qs, LD, static_cast<const T*>(a.q) + (bh * a.Sq + q0) * D, q_rows, D);
  load_tile<T, kBQ>(Gs, LD, static_cast<const T*>(a.dout) + (bh * a.Sq + q0) * D, q_rows, D);
  load_stats(a, bh, q0, q_rows, Ms, Ls, Ds);
  const T* kg = static_cast<const T*>(a.k) + kvh * a.Skv * D;
  const T* vg = static_cast<const T*>(a.v) + kvh * a.Skv * D;

  float dq[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) dq[i][c] = 0.f;

  int64_t t_lo, t_hi;
  key_tiles(a, q0, q_rows, t_lo, t_hi);
  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int64_t k0 = t * kBK;
    const int k_rows = (int)(a.Skv - k0 < kBK ? a.Skv - k0 : kBK);
    __syncthreads();  // the previous tile is done with Ks, Vs, dUs
    load_tile<T, kBK>(Ks, LD, kg + k0 * D, k_rows, D);
    load_tile<T, kBK>(Vs, LD, vg + k0 * D, k_rows, D);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_products<true>(Qs, Ks, Gs, Vs, LD, D, ty, tx, s, dp);
    p_and_du(a, s, dp, Ms, Ls, Ds, q0, q_rows, k0, k_rows, ty, tx, nullptr, dUs);
    __syncthreads();
    // dQ[r] += dU[r, key] K[key]
    for (int c0 = 0; c0 < k_rows; ++c0) {
      float du[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) du[i] = dUs[(ty + 16 * i) * kLDP + c0];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float kv = Ks[c0 * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(du[i], kv, dq[i][c]);
      }
    }
  }

  T* dqg = static_cast<T*>(a.dq) + (bh * a.Sq + q0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) st(dqg + (int64_t)r * D + d, dq[i][c]);
    }
  }
}

template <typename Kernel>
int start(Kernel kernel, int64_t blocks, size_t smem, cudaStream_t stream, const Args& a) {
  if (blocks == 0) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned int)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int kD>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int LD = kD + 1;
  const size_t f = sizeof(float);
  const size_t stats = (size_t)(kBQ + kBK) * LD * f;
  const size_t dkdv = (size_t)(2 * kBK + 2 * kBQ) * LD * f + 2 * (size_t)kBQ * kLDP * f +
                      3 * (size_t)kBQ * f;
  const size_t dq = (size_t)(2 * kBQ + 2 * kBK) * LD * f + (size_t)kBQ * kLDP * f +
                    3 * (size_t)kBQ * f;
  int err = start(flash_bwd_stats_kernel<T, kD>, a.n_qtiles * a.n_q_heads, stats, stream, a);
  if (err) return err;
  err = start(flash_bwd_dkdv_kernel<T, kD>, a.n_ktiles * a.n_kv_heads, dkdv, stream, a);
  if (err) return err;
  return start(flash_bwd_dq_kernel<T, kD>, a.n_qtiles * a.n_q_heads, dq, stream, a);
}

template <typename T>
int dispatch_d(const Args& a, cudaStream_t stream) {
  if (a.D <= 16) return launch<T, 16>(a, stream);
  if (a.D <= 32) return launch<T, 32>(a, stream);
  if (a.D <= 64) return launch<T, 64>(a, stream);
  return launch<T, 128>(a, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; q, o, dout, dq (B, Hq, Sq, D), k, v, dk, dv
// (B, Hkv, Skv, D), contiguous, one dtype; workspace 3 * B * Hq * Sq
// float32. window is used when has_window != 0; softcap 0 means none. The
// wrapper checks shapes (1 <= D <= 128, Hq % Hkv == 0) and grid sizes.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, void* dq, void* dk,
                                   void* dv, void* workspace, int dtype, int64_t B,
                                   int64_t Hq, int64_t Hkv, int64_t Sq, int64_t Skv, int D,
                                   int causal, int has_window, int64_t window, float softcap,
                                   float scale, void* stream) {
  if (D < 1 || D > 128 || Hkv < 1 || Hq % Hkv != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  float* ws = static_cast<float*>(workspace);
  a.row_max = ws;
  a.row_rcp = ws + B * Hq * Sq;
  a.delta = ws + 2 * B * Hq * Sq;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.group = Hq / Hkv;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  a.causal = causal;
  a.has_window = has_window;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  a.n_qtiles = (Sq + kBQ - 1) / kBQ;
  a.n_ktiles = (Skv + kBK - 1) / kBK;
  a.n_q_heads = B * Hq;
  a.n_kv_heads = B * Hkv;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? dispatch_d<float>(a, s) : dispatch_d<bf16>(a, s);
}
