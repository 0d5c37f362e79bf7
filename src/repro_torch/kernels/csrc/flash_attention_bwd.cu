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
// Three launches, no atomics, so every run gives the same bits:
//  1. statistics: a block per (batch * q head, 64 query rows) walks the key
//     tiles its rows see (as the forward does, every tile when a row of the
//     tile sees none) for each row's max and softmax denominator, kept
//     apart (a log-sum-exp of -1e30 + log Skv rounds to -1e30), and sums
//     Delta = dO . O in float32. The forward kernel does not emit them.
//  2. dK, dV: a block per (batch * kv head, 64 keys) walks, for each q head
//     of its group in order, the q tiles that see its keys or hold a fully
//     masked row, recomputes P and dU from the statistics and accumulates
//     dV += P^T dO and dK += dU^T Q in registers.
//  3. dQ: a block per (batch * q head, 64 query rows) walks the key tiles
//     its rows see, recomputes P and dU and accumulates dQ += dU K.
// Heavy tiles launch first. Two routes, chosen by dtype alone:
//
// bfloat16: the tensor cores (flash_bwd_*_kernel_tc<kD, kVec>). Blocks of 4
// warps, two blocks an SM. All five products are bf16 mma.sync.m16n8k16
// with float32 accumulators; tiles are bf16 in shared memory, rows padded
// by 16 bytes so the 8 rows an ldmatrix reads fall in distinct banks, filled
// by cp.async (kVec: D % 8 == 0 and 16-byte aligned rows) or element by
// element (any D), rows and columns past the end zero-filled.
//  1. Each warp owns 16 query rows: Q's fragments stay in registers, K tiles
//     stream through a 2-stage cp.async ring, S = Q K^T feeds the running
//     max and denominator (log2 units, ex2.approx).
//  2. Each warp owns 16 keys. Q and dO tiles with their rows' statistics
//     stream through a 2-stage ring; K and V stay in shared memory and are
//     read by ldmatrix (the dK and dV accumulators take 128 registers a
//     thread at D 128). A q tile goes 16 rows a step: S^T = K Q^T and dP^T
//     = V dO^T, then P^T and dU^T in place, whose accumulator fragments are
//     already the A fragments of dV += P^T dO and dK += dU^T Q (dO and Q by
//     ldmatrix.trans): P and dU never go to shared memory.
//  3. Each warp owns 16 query rows: Q's and dO's fragments stay in
//     registers, K and V tiles stream through the ring, 16 keys a step: S,
//     dP, then dQ += dU K (K by ldmatrix.trans).
// At D 128 the dK / dV and dQ kernels take 246–253 registers a thread and
// spill nothing (steps of 32 spilled up to 236 bytes, for no gain in speed).
// Rounding, as tests/test_torch_flash_attention.py settles it on the CPU
// (_emulate_bwd, KERNEL_ROUNDING): P in [0, 1] is rounded once to bf16 for
// dV; one rounding of dU moves dq and dk to about half the tolerance, so dU
// goes in two halves, hi = bf16(dU) and lo = bf16(dU - hi), two MMAs
// against one fragment of Q or K. The scale multiplies the float32 sums of
// dK and dQ before the output's rounding.
//
// float32: the CUDA cores (flash_bwd_*_kernel<float, kD>), so that float32
// inputs get float32 products (TF32 would not hold a float32 tolerance).
// Blocks of 256 threads; every tile is staged in shared memory as float32,
// a thread holds 4 x 4 entries of a 64 x 64 tile of S / dP and 4 rows x
// D/16 columns of its block's accumulators; P and dU go through shared
// memory.
//
// Bound on this card: operations. 10 * D flops per weighed (query, key)
// pair (the recomputed Q K^T, then dV, dP, dQ and dK, 2 * D each) against
// the bf16 tensor-core peak (989 TFLOP/s). The bf16 route issues 20 * D:
// the statistics pass recomputes Q K^T, the dQ pass Q K^T and dP, and dK
// and dQ take dU in two halves. What separates it from the bound beyond
// that: mma.sync reaches a part of the peak that only wgmma, fed by TMA
// and a warp-specialised pipeline, fills; statistics emitted by the
// forward would save the first pass. The float32 route issues 16 * D as
// FMAs on the CUDA cores, far from it.
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
__device__ __forceinline__ void st(float* p, float x) { *p = x; }

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
int start(Kernel kernel, int64_t blocks, int threads, size_t smem, cudaStream_t stream,
          const Args& a) {
  if (blocks == 0) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned int)blocks, threads, smem, stream>>>(a);
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
  int err = start(flash_bwd_stats_kernel<T, kD>, a.n_qtiles * a.n_q_heads, kThreads, stats,
                  stream, a);
  if (err) return err;
  err = start(flash_bwd_dkdv_kernel<T, kD>, a.n_ktiles * a.n_kv_heads, kThreads, dkdv, stream,
              a);
  if (err) return err;
  return start(flash_bwd_dq_kernel<T, kD>, a.n_qtiles * a.n_q_heads, kThreads, dq, stream, a);
}

template <typename T>
int dispatch_d(const Args& a, cudaStream_t stream) {
  if (a.D <= 16) return launch<T, 16>(a, stream);
  if (a.D <= 32) return launch<T, 32>(a, stream);
  if (a.D <= 64) return launch<T, 64>(a, stream);
  return launch<T, 128>(a, stream);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 4;  // 16 query rows (statistics, dQ) or 16 keys (dK / dV) each
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSM = 2;  // at <= 256 registers a thread
constexpr int kStages = 2;       // cp.async ring
constexpr int kPad = 8;          // row padding (elements): ldmatrix rows in distinct banks
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBQ == 16 * kWarps && kBK == 16 * kWarps, "a warp owns 16 rows of a tile");

// 2^x by the special-function unit (relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) = 1 - 2 / (2^(2 x log2 e) + 1), absolute error ~1e-7, as the forward's
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, ex2(2.f * kLog2e * x) + 1.f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes from src, of which the first src_bytes are read and the rest
// zero-filled (0: all zeros, src not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 operands, float32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as one bf16 pair, x0 in the low half, as the fragments order elements
__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  return as_u32(__floats2bfloat162_rn(x0, x1));
}

// (x0, x1) as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi)
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// the A fragment of a 16 x 16 operand from two accumulator fragments of 8
// columns each (the m16n8k16 C layout is the A layout)
__device__ __forceinline__ void a_frag(const float (&c0)[4], const float (&c1)[4],
                                       uint32_t (&a)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}
__device__ __forceinline__ void a_frag_split(const float (&c0)[4], const float (&c1)[4],
                                             uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_pair(c0[0], c0[1], hi[0], lo[0]);
  split_pair(c0[2], c0[3], hi[1], lo[1]);
  split_pair(c1[0], c1[1], hi[2], lo[2]);
  split_pair(c1[2], c1[3], hi[3], lo[3]);
}

// the logit of the raw product s in log2 units, and d logit / d u; the same
// arithmetic in all three passes
__device__ __forceinline__ float logit2(const Args& a, float s, float& dtanh) {
  if (a.softcap != 0.f) {
    const float t = tanh_fast(s * a.scale / a.softcap);
    dtanh = 1.f - t * t;
    return a.softcap * kLog2e * t;
  }
  dtanh = 1.f;
  return s * a.scale * kLog2e;
}

// the mask: a key past Skv weighs nothing (-inf), a masked key gets the
// finite -1e30 (unscaled, as the forward's); neither passes a gradient
__device__ __forceinline__ float masked(const Args& a, float x, int64_t qpos, int64_t kpos,
                                       float& dtanh) {
  if (kpos >= a.Skv) {
    dtanh = 0.f;
    return -INFINITY;
  }
  if ((a.causal && kpos > qpos) || (a.has_window && kpos <= qpos - a.window)) {
    dtanh = 0.f;
    return kMaskValue;
  }
  return x;
}

// does no pair of query rows [q0, q_last] and keys [k0, k0 + kBK) need the mask?
__device__ __forceinline__ bool unmasked(const Args& a, int64_t q0, int64_t q_last, int64_t k0) {
  return k0 + kBK <= a.Skv && (!a.causal || k0 + kBK - 1 <= q0) &&
         (!a.has_window || k0 > q_last - a.window);
}

// rows [0, kRows) of a row-major (rows, D) bf16 matrix into a shared tile of
// row stride kD + kPad; rows >= valid_rows and columns >= D are zeros.
// kVec: by cp.async (asynchronous); else element by element (synchronous).
template <int kRows, int kD, bool kVec>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int valid_rows, int D,
                                          int tid) {
  constexpr int LD = kD + kPad, kChunks = kD / 8;
#pragma unroll
  for (int e = tid; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks, col = (e % kChunks) * 8;
    bf16* d = dst + r * LD + col;
    if (kVec) {
      const bool in = r < valid_rows && col < D;
      cp_async16(smem_addr(d), in ? src + (int64_t)r * D + col : src, in ? 16 : 0);
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(src) + (int64_t)r * D;
      uint32_t w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c0 = col + 2 * u;
        const uint32_t lo = r < valid_rows && c0 < D ? s[c0] : 0u;
        const uint32_t hi = r < valid_rows && c0 + 1 < D ? s[c0 + 1] : 0u;
        w[u] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// this warp's 16 rows of a shared tile as A fragments, 16 columns a step
template <int kD>
__device__ __forceinline__ void load_frags(uint32_t (&f)[kD / 16][4], const bf16* tile,
                                           int warp, int lane) {
  constexpr int LD = kD + kPad;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks)
    ldsm_x4(f[ks], smem_addr(tile + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8));
}

// B fragments of rows [r0, r0 + 16) x columns [c0, c0 + 16) of a row-major
// shared tile, as the n operand (b[0], b[1]: rows r0.., b[2], b[3]: rows
// r0 + 8..); trans: as the k operand (b[0], b[1]: columns c0.., b[2], b[3]:
// columns c0 + 8..)
template <int LD, bool kTrans>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int r0, int c0,
                                       int lane) {
  if (kTrans)
    ldsm_x4_trans(b, smem_addr(tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 +
                               (lane >> 4) * 8));
  else
    ldsm_x4(b, smem_addr(tile + (r0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 +
                         ((lane >> 3) & 1) * 8));
}

// a (16, kD) accumulator of rows row0 + g and row0 + 8 + g (those < rows)
// times mul into a row-major (rows, D) bf16 matrix
template <int kD, bool kVec>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[kD / 8][4], int row0,
                                           int rows, int D, float mul, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= rows) continue;
    bf16* row = dst + (int64_t)r * D;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int c = 8 * n + 2 * t4;
      const float x0 = acc[n][2 * i] * mul, x1 = acc[n][2 * i + 1] * mul;
      if (kVec) {  // D even: the pair is in or out together, 4-byte aligned
        if (c < D) *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < D) row[c] = __float2bfloat16(x0);
        if (c + 1 < D) row[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int kN>
__device__ __forceinline__ void zero(float (&c)[kN][4]) {
#pragma unroll
  for (int n = 0; n < kN; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// ---------------------------------------------------------------------------
// 1. statistics: row max (log2 units), 1 / denominator, Delta
// ---------------------------------------------------------------------------

template <int kD, bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
flash_bwd_stats_kernel_tc(const Args a) {
  constexpr int LD = kD + kPad, kKS = kD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBQ * LD;  // kStages tiles of kBK rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int D = a.D;

  // heavy (late) q tiles first
  const int64_t bh = blockIdx.x % a.n_q_heads;
  const int64_t qt = a.n_qtiles - 1 - blockIdx.x / a.n_q_heads;
  const int64_t kvh = bh / a.Hq * a.Hkv + bh % a.Hq / a.group;
  const int64_t q0 = qt * kBQ;
  const int q_rows = (int)(a.Sq - q0 < kBQ ? a.Sq - q0 : kBQ);
  const bf16* kg = static_cast<const bf16*>(a.k) + kvh * a.Skv * D;
  int64_t t_lo, t_hi;
  key_tiles(a, q0, q_rows, t_lo, t_hi);
  auto load_k = [&](int64_t t, int stage) {
    const int64_t k0 = t * kBK;
    load_tile<kBK, kD, kVec>(Ks + stage * kBK * LD, kg + k0 * D,
                             (int)(a.Skv - k0 < kBK ? a.Skv - k0 : kBK), D, tid);
  };
  load_tile<kBQ, kD, kVec>(Qs, static_cast<const bf16*>(a.q) + (bh * a.Sq + q0) * D, q_rows, D,
                           tid);
  cp_async_commit();
  if (t_lo < t_hi) load_k(t_lo, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  uint32_t qf[kKS][4];
  load_frags<kD>(qf, Qs, warp, lane);

  // rows g and g + 8 of the warp's slab: running max, partial denominator
  // over this lane's columns
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  const int64_t qrow = q0 + warp * 16 + g;
  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int stage = (int)((t - t_lo) & 1);
    if (t + 1 < t_hi) load_k(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const bf16* Kt = Ks + stage * kBK * LD;
    float s[kBK / 8][4];
    zero(s);
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int jp = 0; jp < kBK / 16; ++jp) {
        uint32_t kb[4];
        load_b<LD, false>(kb, Kt, 16 * jp, 16 * ks, lane);
        mma(s[2 * jp], qf[ks], kb[0], kb[1]);
        mma(s[2 * jp + 1], qf[ks], kb[2], kb[3]);
      }
    }
    const int64_t k0 = t * kBK;
    const bool full = unmasked(a, q0, q0 + q_rows - 1, k0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dtanh;
        float x = logit2(a, s[j][e], dtanh);
        if (!full) x = masked(a, x, qrow + (e >> 1) * 8, k0 + 8 * j + 2 * t4 + (e & 1), dtanh);
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      l[i] *= ex2(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += ex2(s[j][e] - m[e >> 1]);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  // Delta of the warp's 16 rows, one row at a time across the warp
  const bf16* og = static_cast<const bf16*>(a.o) + (bh * a.Sq + q0) * D;
  const bf16* gg = static_cast<const bf16*>(a.dout) + (bh * a.Sq + q0) * D;
  float delta[2] = {0.f, 0.f};
  for (int i = 0; i < 16; ++i) {
    const int r = warp * 16 + i;
    float dl = 0.f;
    if (r < q_rows)
      for (int d = lane; d < D; d += 32)
        dl = fmaf(__bfloat162float(og[(int64_t)r * D + d]),
                  __bfloat162float(gg[(int64_t)r * D + d]), dl);
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) dl += __shfl_xor_sync(0xffffffffu, dl, w);
    if (i == g) delta[0] = dl;
    if (i == g + 8) delta[1] = dl;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    if (t4 == 0 && r < q_rows) {
      const int64_t row = bh * a.Sq + q0 + r;
      a.row_max[row] = m[i];
      a.row_rcp[row] = 1.f / fmaxf(l[i], 1e-30f);
      a.delta[row] = delta[i];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV: a block per (batch * kv head, 64 keys)
// ---------------------------------------------------------------------------

// the first (q head, q tile) at or after (hq, qt), q heads in order, that
// visits keys [k0, k0 + kBK); false past the group's last q head
__device__ __forceinline__ bool next_visit(const Args& a, int64_t hq_end, int64_t k0,
                                           int64_t& hq, int64_t& qt) {
  for (; hq < hq_end; ++hq, qt = 0)
    for (; qt < a.n_qtiles; ++qt)
      if (q_tile_visits(a, qt, k0)) return true;
  return false;
}

template <int kD, bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
flash_bwd_dkdv_kernel_tc(const Args a) {
  constexpr int LD = kD + kPad, kKS = kD / 16, kN = kD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBK * LD;
  bf16* Qs = Vs + kBK * LD;            // kStages tiles of kBQ rows
  bf16* Gs = Qs + kStages * kBQ * LD;  // dO, likewise
  // kStages x (row max, 1 / denominator, Delta) x kBQ rows
  float* Ss = reinterpret_cast<float*>(Gs + kStages * kBQ * LD);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int D = a.D;

  // key tile 0 (the heaviest under causal) first
  const int64_t bkv = blockIdx.x % a.n_kv_heads, kt = blockIdx.x / a.n_kv_heads;
  const int64_t b = bkv / a.Hkv, hk = bkv % a.Hkv;
  const int64_t k0 = kt * kBK;
  const int k_rows = (int)(a.Skv - k0 < kBK ? a.Skv - k0 : kBK);
  load_tile<kBK, kD, kVec>(Ks, static_cast<const bf16*>(a.k) + (bkv * a.Skv + k0) * D, k_rows,
                           D, tid);
  load_tile<kBK, kD, kVec>(Vs, static_cast<const bf16*>(a.v) + (bkv * a.Skv + k0) * D, k_rows,
                           D, tid);

  auto load_q = [&](int64_t hq, int64_t qt, int stage) {
    const int64_t q0 = qt * kBQ, row0 = (b * a.Hq + hq) * a.Sq + q0;
    const int rows = (int)(a.Sq - q0 < kBQ ? a.Sq - q0 : kBQ);
    load_tile<kBQ, kD, kVec>(Qs + stage * kBQ * LD, static_cast<const bf16*>(a.q) + row0 * D,
                             rows, D, tid);
    load_tile<kBQ, kD, kVec>(Gs + stage * kBQ * LD, static_cast<const bf16*>(a.dout) + row0 * D,
                             rows, D, tid);
    // rows past Sq: 0 (1 / denominator 0, so P = 0)
    for (int e = tid; e < 3 * kBQ; e += kThreads) {
      const int which = e / kBQ, r = e % kBQ;
      const float* src = (which == 0 ? a.row_max : which == 1 ? a.row_rcp : a.delta) + row0;
      cp_async4(smem_addr(Ss + stage * 3 * kBQ + e), r < rows ? src + r : src,
                r < rows ? 4 : 0);
    }
  };

  const int64_t hq_end = (hk + 1) * a.group;
  int64_t hq = hk * a.group, qt = 0;
  bool have = next_visit(a, hq_end, k0, hq, qt);
  if (have) load_q(hq, qt, 0);
  cp_async_commit();  // K, V and the first q tile

  float dk[kN][4], dv[kN][4];
  zero(dk);
  zero(dv);
  const int64_t krow = k0 + warp * 16 + g;  // this thread's keys krow and krow + 8
  for (int stage = 0; have; stage ^= 1) {
    int64_t nhq = hq, nqt = qt + 1;
    const bool more = next_visit(a, hq_end, k0, nhq, nqt);
    if (more) load_q(nhq, nqt, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this q tile has landed
    __syncthreads();
    const bf16* Qt = Qs + stage * kBQ * LD;
    const bf16* Gt = Gs + stage * kBQ * LD;
    const float* Mt = Ss + stage * 3 * kBQ;
    const float* Rt = Mt + kBQ;
    const float* Dt = Rt + kBQ;
    const int64_t q0 = qt * kBQ;
    const bool full = unmasked(a, q0, (a.Sq - q0 < kBQ ? a.Sq : q0 + kBQ) - 1, k0);
#pragma unroll
    for (int r0 = 0; r0 < kBQ; r0 += 16) {
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x q rows r0..r0 + 15
      float s[2][4], dpt[2][4];
      zero(s);
      zero(dpt);
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        uint32_t ka[4], va[4], qb[4], gb[4];
        const int off = (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8;
        ldsm_x4(ka, smem_addr(Ks + off));
        ldsm_x4(va, smem_addr(Vs + off));
        load_b<LD, false>(qb, Qt, r0, 16 * ks, lane);
        mma(s[0], ka, qb[0], qb[1]);
        mma(s[1], ka, qb[2], qb[3]);
        load_b<LD, false>(gb, Gt, r0, 16 * ks, lane);
        mma(dpt[0], va, gb[0], gb[1]);
        mma(dpt[1], va, gb[2], gb[3]);
      }
      // P^T into s, dU^T (without the scale) into dpt
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = r0 + 8 * j + 2 * t4 + (e & 1);  // q row of the tile
          float dtanh;
          float x = logit2(a, s[j][e], dtanh);
          if (!full) x = masked(a, x, q0 + c, krow + 8 * (e >> 1), dtanh);
          const float p = ex2(x - Mt[c]) * Rt[c];
          s[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - Dt[c]) * dtanh;
        }
      }
      // dV += P^T dO and dK += dU^T Q
      uint32_t pa[4], uh[4], ul[4];
      a_frag(s[0], s[1], pa);
      a_frag_split(dpt[0], dpt[1], uh, ul);
#pragma unroll
      for (int np = 0; np < kD / 16; ++np) {
        uint32_t gb[4], qb[4];
        load_b<LD, true>(gb, Gt, r0, 16 * np, lane);
        mma(dv[2 * np], pa, gb[0], gb[1]);
        mma(dv[2 * np + 1], pa, gb[2], gb[3]);
        load_b<LD, true>(qb, Qt, r0, 16 * np, lane);
        mma(dk[2 * np], uh, qb[0], qb[1]);
        mma(dk[2 * np], ul, qb[0], qb[1]);
        mma(dk[2 * np + 1], uh, qb[2], qb[3]);
        mma(dk[2 * np + 1], ul, qb[2], qb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    hq = nhq;
    qt = nqt;
    have = more;
  }
  cp_async_wait<0>();

  const int64_t out0 = (bkv * a.Skv + k0) * D;
  store_rows<kD, kVec>(static_cast<bf16*>(a.dk) + out0, dk, warp * 16, k_rows, D, a.scale,
                       lane);
  store_rows<kD, kVec>(static_cast<bf16*>(a.dv) + out0, dv, warp * 16, k_rows, D, 1.f, lane);
}

// ---------------------------------------------------------------------------
// 3. dQ: a block per (batch * q head, 64 query rows)
// ---------------------------------------------------------------------------

template <int kD, bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
flash_bwd_dq_kernel_tc(const Args a) {
  constexpr int LD = kD + kPad, kKS = kD / 16, kN = kD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + kBQ * LD;
  bf16* Ks = Gs + kBQ * LD;              // kStages tiles of kBK rows
  bf16* Vs = Ks + kStages * kBK * LD;    // likewise
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int D = a.D;

  // heavy (late) q tiles first
  const int64_t bh = blockIdx.x % a.n_q_heads;
  const int64_t qt = a.n_qtiles - 1 - blockIdx.x / a.n_q_heads;
  const int64_t kvh = bh / a.Hq * a.Hkv + bh % a.Hq / a.group;
  const int64_t q0 = qt * kBQ;
  const int q_rows = (int)(a.Sq - q0 < kBQ ? a.Sq - q0 : kBQ);
  const bf16* kg = static_cast<const bf16*>(a.k) + kvh * a.Skv * D;
  const bf16* vg = static_cast<const bf16*>(a.v) + kvh * a.Skv * D;
  int64_t t_lo, t_hi;
  key_tiles(a, q0, q_rows, t_lo, t_hi);
  auto load_kv = [&](int64_t t, int stage) {
    const int64_t k0 = t * kBK;
    const int rows = (int)(a.Skv - k0 < kBK ? a.Skv - k0 : kBK);
    load_tile<kBK, kD, kVec>(Ks + stage * kBK * LD, kg + k0 * D, rows, D, tid);
    load_tile<kBK, kD, kVec>(Vs + stage * kBK * LD, vg + k0 * D, rows, D, tid);
  };
  load_tile<kBQ, kD, kVec>(Qs, static_cast<const bf16*>(a.q) + (bh * a.Sq + q0) * D, q_rows, D,
                           tid);
  load_tile<kBQ, kD, kVec>(Gs, static_cast<const bf16*>(a.dout) + (bh * a.Sq + q0) * D, q_rows,
                           D, tid);
  cp_async_commit();
  if (t_lo < t_hi) load_kv(t_lo, 0);
  cp_async_commit();

  // statistics of rows g and g + 8 of the warp's slab (rows past Sq: 0)
  float m[2], rcp[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    const int64_t row = bh * a.Sq + q0 + r;
    m[i] = r < q_rows ? a.row_max[row] : 0.f;
    rcp[i] = r < q_rows ? a.row_rcp[row] : 0.f;
    delta[i] = r < q_rows ? a.delta[row] : 0.f;
  }
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  uint32_t qf[kKS][4], gf[kKS][4];
  load_frags<kD>(qf, Qs, warp, lane);
  load_frags<kD>(gf, Gs, warp, lane);

  float dq[kN][4];
  zero(dq);
  const int64_t qrow = q0 + warp * 16 + g;
  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int stage = (int)((t - t_lo) & 1);
    if (t + 1 < t_hi) load_kv(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const bf16* Kt = Ks + stage * kBK * LD;
    const bf16* Vt = Vs + stage * kBK * LD;
    const int64_t k0 = t * kBK;
    const bool full = unmasked(a, q0, q0 + q_rows - 1, k0);
#pragma unroll
    for (int c0 = 0; c0 < kBK; c0 += 16) {
      // S = Q K^T and dP = dO V^T: this warp's 16 rows x keys c0..c0 + 15
      float s[2][4], dp[2][4];
      zero(s);
      zero(dp);
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        uint32_t kb[4], vb[4];
        load_b<LD, false>(kb, Kt, c0, 16 * ks, lane);
        mma(s[0], qf[ks], kb[0], kb[1]);
        mma(s[1], qf[ks], kb[2], kb[3]);
        load_b<LD, false>(vb, Vt, c0, 16 * ks, lane);
        mma(dp[0], gf[ks], vb[0], vb[1]);
        mma(dp[1], gf[ks], vb[2], vb[3]);
      }
      // dU (without the scale) into dp
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float dtanh;
          float x = logit2(a, s[j][e], dtanh);
          if (!full) x = masked(a, x, qrow + 8 * i, k0 + c0 + 8 * j + 2 * t4 + (e & 1), dtanh);
          const float p = ex2(x - m[i]) * rcp[i];
          dp[j][e] = p * (dp[j][e] - delta[i]) * dtanh;
        }
      }
      // dQ += dU K
      uint32_t uh[4], ul[4];
      a_frag_split(dp[0], dp[1], uh, ul);
#pragma unroll
      for (int np = 0; np < kD / 16; ++np) {
        uint32_t kb[4];
        load_b<LD, true>(kb, Kt, c0, 16 * np, lane);
        mma(dq[2 * np], uh, kb[0], kb[1]);
        mma(dq[2 * np], ul, kb[0], kb[1]);
        mma(dq[2 * np + 1], uh, kb[2], kb[3]);
        mma(dq[2 * np + 1], ul, kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  store_rows<kD, kVec>(static_cast<bf16*>(a.dq) + (bh * a.Sq + q0) * D, dq, warp * 16, q_rows,
                       D, a.scale, lane);
}

template <int kD, bool kVec>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t row = (kD + kPad) * sizeof(bf16);
  const size_t stats = (kBQ + kStages * kBK) * row;
  const size_t dkdv = (2 * kBK + 2 * kStages * kBQ) * row + kStages * 3 * kBQ * sizeof(float);
  const size_t dq = (2 * kBQ + 2 * kStages * kBK) * row;
  int err = start(flash_bwd_stats_kernel_tc<kD, kVec>, a.n_qtiles * a.n_q_heads, kThreads,
                  stats, stream, a);
  if (err) return err;
  err = start(flash_bwd_dkdv_kernel_tc<kD, kVec>, a.n_ktiles * a.n_kv_heads, kThreads, dkdv,
              stream, a);
  if (err) return err;
  return start(flash_bwd_dq_kernel_tc<kD, kVec>, a.n_qtiles * a.n_q_heads, kThreads, dq,
               stream, a);
}

template <bool kVec>
int dispatch_d(const Args& a, cudaStream_t stream) {
  if (a.D <= 16) return launch<16, kVec>(a, stream);
  if (a.D <= 32) return launch<32, kVec>(a, stream);
  if (a.D <= 64) return launch<64, kVec>(a, stream);
  return launch<128, kVec>(a, stream);
}

}  // namespace tc

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores); q, o, dout, dq
// (B, Hq, Sq, D), k, v, dk, dv (B, Hkv, Skv, D), contiguous, one dtype;
// workspace 3 * B * Hq * Sq float32. window is used when has_window != 0;
// softcap 0 means none. The wrapper checks shapes (1 <= D <= 128, Hq % Hkv
// == 0) and grid sizes.
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
  if (dtype == 0) return dispatch_d<float>(a, s);
  // 16-byte copies (and paired stores) need every row and base 16-byte aligned
  const bool vec = D % 8 == 0 && (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
                                   (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk |
                                   (uintptr_t)dv) & 15) == 0;
  return vec ? tc::dispatch_d<true>(a, s) : tc::dispatch_d<false>(a, s);
}
