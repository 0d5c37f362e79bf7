// Flash attention forward for Hopper (sm_90a): causal / sliding-window /
// softcapped GQA attention with an online softmax, float32 inside.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/flash_attention.py
// (flash_attention, body _attn_kernel), and computes what it computes:
//   q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), all contiguous, float32 or
//   bfloat16; q head h reads kv head h / (Hq / Hkv);
//   s = (q . k) * scale, then softcap * tanh(s / softcap) when a cap is set;
//   key kpos is masked for query qpos when causal and kpos > qpos, or when a
//   window is set and kpos <= qpos - window (positions count from 0 for both);
//   o = softmax(s) @ v, written in q's dtype.
// q, k and v are read into float32 before both products, as the Pallas
// kernel casts them, and the running max, denominator and numerator are
// float32. Masked logits are the Pallas kernel's finite -1e30, not -inf, so
// a row with no unmasked key gets exp(0) = 1 for every key and its output
// is the mean of v over all Skv keys, as in the reference (with -inf it
// would be NaN). Keys past the end (a ragged last tile) do not exist in the
// Pallas kernel, which needs Skv to divide into its blocks; here they get
// -inf and weigh nothing, so any Sq and Skv work.
//
// Design (simple and right first): one block of 128 threads per
// (batch * q head, tile of 64 query rows). The Q tile stays in shared
// memory; a loop over 64-key tiles of K and V (the Pallas grid's sequential
// kv axis) stages each in shared memory, computes the 64 x 64 logits with
// each thread holding 4 rows x 8 keys in registers, updates the running
// softmax per row (the 8 threads of a row combine by warp shuffles), writes
// the probabilities to shared memory and accumulates P @ V with each thread
// holding 4 rows x D/8 columns. Key tiles that no row of the q tile can see
// (above the diagonal under causal, before the window) are skipped -- unless
// some row of the tile sees no key at all, whose mean over all keys needs
// every tile. Heavy causal tiles are launched first.
//
// Bound on this card: operations. 4 * D flops per unmasked (query, key)
// pair against the bf16 tensor-core peak; this kernel runs them as float32
// FMAs on the CUDA cores, so it is far from that bound. Tensor cores (mma /
// wgmma with bf16 operands), TMA loads and double buffering are the later
// redesign.
//
// Plain C interface, loaded with ctypes: pointers and the stream as void*.
// The entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups of 4 rows x 8 key lanes
constexpr int kPLD = kBK + 1;  // probability row stride (floats)
constexpr float kMaskValue = -1e30f;  // the Pallas kernel's NEG_INF

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t Hq, group, Sq, Skv;
  int D;
  int causal;
  int has_window;
  int64_t window;
  float softcap;  // 0: none
  float scale;
  int64_t n_qtiles, n_heads_total;  // B * Hq
};

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
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// rows [lo(q), hi(q)) of the keys query q may see
__device__ __forceinline__ int64_t key_lo(const Args& a, int64_t q) {
  if (!a.has_window) return 0;
  const int64_t lo = q - a.window + 1;
  return lo > 0 ? lo : 0;
}
__device__ __forceinline__ int64_t key_hi(const Args& a, int64_t q) {
  if (!a.causal) return a.Skv;
  return q + 1 < a.Skv ? q + 1 : a.Skv;
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Args a) {
  constexpr int LD = kD + 2;  // tile row stride (elements): even, and no bank conflicts
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBQ * LD;
  T* Vs = Ks + kBK * LD;
  float* Ps = reinterpret_cast<float*>(Vs + kBK * LD);

  const int tid = threadIdx.x;
  const int r0 = (tid >> 3) * 4;  // first of this thread's 4 rows
  const int cg = tid & 7;         // key lane: keys cg + 8j, columns 2cg + 16jj
  const int D = a.D;

  // heavy (late) q tiles first; consecutive blocks share kv heads
  const int64_t bid = blockIdx.x;
  const int64_t bh = bid % a.n_heads_total;
  const int64_t qt = a.n_qtiles - 1 - bid / a.n_heads_total;
  const int64_t b = bh / a.Hq, h = bh % a.Hq;
  const int64_t kvh = b * (a.Hq / a.group) + h / a.group;
  const int64_t q0 = qt * kBQ;
  const T* qg = static_cast<const T*>(a.q) + (bh * a.Sq + q0) * D;
  const T* kg = static_cast<const T*>(a.k) + kvh * a.Skv * D;
  const T* vg = static_cast<const T*>(a.v) + kvh * a.Skv * D;
  T* og = static_cast<T*>(a.o) + (bh * a.Sq + q0) * D;

  const T zero = from_float<T>(0.f);
  // columns [D, kD) stay zero for the whole run: pairs past D read zeros
  for (int e = tid; e < kBQ * (kD - D); e += kThreads) {
    const int r = e / (kD - D), d = D + e % (kD - D);
    Qs[r * LD + d] = zero;
    Ks[r * LD + d] = zero;
    Vs[r * LD + d] = zero;
  }
  const int q_rows = (int)(a.Sq - q0 < kBQ ? a.Sq - q0 : kBQ);
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    Qs[r * LD + d] = r < q_rows ? qg[(int64_t)r * D + d] : zero;
  }

  // key range of the tile: rows see [key_lo, key_hi), both nondecreasing in
  // q; a row that sees nothing gives the mean over every key (see header)
  int64_t klo = key_lo(a, q0), khi = key_hi(a, q0 + q_rows - 1);
  for (int r = 0; r < q_rows; ++r) {
    if (key_lo(a, q0 + r) >= key_hi(a, q0 + r)) {
      klo = 0;
      khi = a.Skv;
      break;
    }
  }
  const int64_t t_lo = klo / kBK;
  const int64_t t_hi = khi > klo ? (khi + kBK - 1) / kBK : t_lo;

  float m[4], l[4], acc[4][kD / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kD / 8; ++c) acc[i][c] = 0.f;
  }

  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int64_t k0 = t * kBK;
    const int k_rows = (int)(a.Skv - k0 < kBK ? a.Skv - k0 : kBK);
    __syncthreads();  // the previous tile's P @ V is done with Ks, Vs, Ps
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      const bool in = r < k_rows;
      Ks[r * LD + d] = in ? kg[(k0 + r) * D + d] : zero;
      Vs[r * LD + d] = in ? vg[(k0 + r) * D + d] : zero;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 2) {
      float2 qa[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = load2(Qs + (r0 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) kb[j] = load2(Ks + (cg + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q0 + r0 + i;
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t kpos = k0 + cg + 8 * j;
        float x = s[i][j] * a.scale;
        if (a.softcap != 0.f) x = a.softcap * tanhf(x / a.softcap);
        if (kpos >= a.Skv) {
          x = -INFINITY;  // no such key
        } else if ((a.causal && kpos > qpos) ||
                   (a.has_window && kpos <= qpos - a.window)) {
          x = kMaskValue;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(r0 + i) * kPLD + cg + 8 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kD / 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < k_rows; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(r0 + i) * kPLD + kk];
#pragma unroll
      for (int jj = 0; jj < kD / 16; ++jj) {
        const float2 vv = load2(Vs + kk * LD + 2 * cg + 16 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][2 * jj] = fmaf(p[i], vv.x, acc[i][2 * jj]);
          acc[i][2 * jj + 1] = fmaf(p[i], vv.y, acc[i][2 * jj + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (r0 + i >= q_rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < kD / 16; ++jj) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int d = 2 * cg + 16 * jj + u;
        if (d < D) og[(int64_t)(r0 + i) * D + d] = from_float<T>(acc[i][2 * jj + u] / denom);
      }
    }
  }
}

template <typename T, int kD>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int LD = kD + 2;
  const size_t smem = (size_t)(kBQ + 2 * kBK) * LD * sizeof(T) +
                      (size_t)kBQ * kPLD * sizeof(float);
  auto kernel = flash_attention_kernel<T, kD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = a.n_qtiles * a.n_heads_total;
  kernel<<<(unsigned int)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Args& a, cudaStream_t stream) {
  if (a.D <= 16) return launch<T, 16>(a, stream);
  if (a.D <= 32) return launch<T, 32>(a, stream);
  if (a.D <= 64) return launch<T, 64>(a, stream);
  return launch<T, 128>(a, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. window is used when has_window != 0;
// softcap 0 means none. The wrapper checks shapes (1 <= D <= 128,
// Hq % Hkv == 0) and that B * Hq * ceil(Sq / 64) fits a grid.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int64_t B, int64_t Hq,
                                   int64_t Hkv, int64_t Sq, int64_t Skv, int D,
                                   int causal, int has_window, int64_t window,
                                   float softcap, float scale, void* stream) {
  if (D < 1 || D > 128 || Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (B * Hq * Sq == 0) return 0;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.Hq = Hq;
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
  a.n_heads_total = B * Hq;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 1 ? dispatch_d<__nv_bfloat16>(a, s) : dispatch_d<float>(a, s);
}
