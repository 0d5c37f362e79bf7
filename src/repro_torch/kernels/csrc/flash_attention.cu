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
// The running max, denominator and numerator are float32. Masked logits are
// the Pallas kernel's finite -1e30, not -inf, so a row with no unmasked key
// gets exp(0) = 1 for every key and its output is the mean of v over all
// Skv keys, as in the reference (with -inf it would be NaN). Keys past the
// end (a ragged last tile) do not exist in the Pallas kernel, which needs
// Skv to divide into its blocks; here they get -inf and weigh nothing, so
// any Sq and Skv work.
//
// Two routes, chosen by dtype alone:
//
// bfloat16: the tensor cores (flash_attention_kernel_tc). One block of 4
// warps per (batch * q head, tile of 64 query rows), two blocks an SM; each
// warp owns 16 rows. (8 warps on 128 rows fit one block an SM at 250
// registers a thread; two blocks keep their barriers apart, so one block's
// softmax overlaps the other's MMAs.) The block walks 64-key tiles of K
// and V (the Pallas grid's sequential kv axis) through a ring of 2 stages
// in shared memory, filled by cp.async (16 bytes a thread; rows past Skv
// and columns past D zero-filled by a source size of 0), so the next
// tile's load is in flight while the current one is computed. Rows are
// padded by 16 bytes, so the 8 rows an ldmatrix reads fall in distinct
// banks. Both products are bf16
// mma.sync.m16n8k16 with float32 accumulators: Q . K^T takes Q's fragments
// (held in registers for the whole run) and K's through ldmatrix; a bf16 x
// bf16 product is exact in float32, so this is the Pallas kernel's float32
// product up to the order of the sum. The logits' accumulator fragment is
// already the A fragment of P @ V (the m16n8k16 C layout is the A layout),
// so P never goes to shared memory. P in [0, 1] is float32 in the
// reference and one bf16 rounding of it is too coarse for the bf16 output's
// tolerance, so P @ V runs in two halves, hi = bf16(p) and lo = bf16(p -
// hi), two MMAs against one V fragment (from ldmatrix.trans): hi + lo
// carries 16 bits of p. The row max and the denominator (summed from the
// unrounded p) reduce over the 4 lanes that share a row; exponentials (and
// a softcap's tanh) go by ex2.approx in log2 units.
//
// float32: the CUDA cores (flash_attention_kernel), so that float32 inputs
// get float32 products (TF32 would not hold a float32 tolerance). One block
// of 128 threads per (batch * q head, tile of 64 query rows); each 64-key
// tile of K and V is staged in shared memory, each thread holds 4 rows x 8
// keys of logits in registers, the probabilities go through shared memory
// and each thread accumulates 4 rows x D/8 columns of P @ V.
//
// Both routes skip the key tiles that no row of the q tile can see (above
// the diagonal under causal, before the window) -- unless some row of the
// tile sees no key at all, whose mean over all keys needs every tile -- and
// launch the heavy causal tiles first.
//
// Bound on this card: operations. 4 * D flops per weighed (query, key) pair
// against the bf16 tensor-core peak. The bf16 route issues 6 * D (P @ V
// twice); mma.sync reaches a part of the peak that only wgmma fills, and
// the float32 route runs on the CUDA cores, far from it.
//
// Plain C interface, loaded with ctypes: pointers and the stream as void*.
// The entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() of the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// key tiles [t_lo, t_hi) of width bk that rows [q0, q0 + q_rows) must visit:
// rows see [key_lo, key_hi), both nondecreasing in q; a row that sees
// nothing gives the mean over every key (see header)
__device__ __forceinline__ void tile_range(const Args& a, int64_t q0, int q_rows, int bk,
                                           int64_t& t_lo, int64_t& t_hi) {
  int64_t klo = key_lo(a, q0), khi = key_hi(a, q0 + q_rows - 1);
  for (int r = 0; r < q_rows; ++r) {
    if (key_lo(a, q0 + r) >= key_hi(a, q0 + r)) {
      klo = 0;
      khi = a.Skv;
      break;
    }
  }
  t_lo = klo / bk;
  t_hi = khi > klo ? (khi + bk - 1) / bk : t_lo;
}

// the logit of (qpos, kpos) after scale and softcap, or the mask
__device__ __forceinline__ float masked_logit(const Args& a, float x, int64_t qpos,
                                              int64_t kpos) {
  if (kpos >= a.Skv) return -INFINITY;  // no such key
  if ((a.causal && kpos > qpos) || (a.has_window && kpos <= qpos - a.window))
    return kMaskValue;
  return x;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups of 4 rows x 8 key lanes
constexpr int kPLD = kBK + 1;  // probability row stride (floats)

template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Args a) {
  constexpr int LD = kD + 2;  // tile row stride (elements): even, and no bank conflicts
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

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
  const float* qg = static_cast<const float*>(a.q) + (bh * a.Sq + q0) * D;
  const float* kg = static_cast<const float*>(a.k) + kvh * a.Skv * D;
  const float* vg = static_cast<const float*>(a.v) + kvh * a.Skv * D;
  float* og = static_cast<float*>(a.o) + (bh * a.Sq + q0) * D;

  // columns [D, kD) stay zero for the whole run: pairs past D read zeros
  for (int e = tid; e < kBQ * (kD - D); e += kThreads) {
    const int r = e / (kD - D), d = D + e % (kD - D);
    Qs[r * LD + d] = 0.f;
    Ks[r * LD + d] = 0.f;
    Vs[r * LD + d] = 0.f;
  }
  const int q_rows = (int)(a.Sq - q0 < kBQ ? a.Sq - q0 : kBQ);
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    Qs[r * LD + d] = r < q_rows ? qg[(int64_t)r * D + d] : 0.f;
  }
  int64_t t_lo, t_hi;
  tile_range(a, q0, q_rows, kBK, t_lo, t_hi);

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
      Ks[r * LD + d] = in ? kg[(k0 + r) * D + d] : 0.f;
      Vs[r * LD + d] = in ? vg[(k0 + r) * D + d] : 0.f;
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
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float2*>(Qs + (r0 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kb[j] = *reinterpret_cast<const float2*>(Ks + (cg + 8 * j) * LD + d);
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
        float x = s[i][j] * a.scale;
        if (a.softcap != 0.f) x = a.softcap * tanhf(x / a.softcap);
        x = masked_logit(a, x, qpos, k0 + cg + 8 * j);
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
        const float2 vv = *reinterpret_cast<const float2*>(Vs + kk * LD + 2 * cg + 16 * jj);
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
        if (d < D) og[(int64_t)(r0 + i) * D + d] = acc[i][2 * jj + u] / denom;
      }
    }
  }
}

template <int kD>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int LD = kD + 2;
  const size_t smem = (size_t)(kBQ + 2 * kBK) * LD * sizeof(float) +
                      (size_t)kBQ * kPLD * sizeof(float);
  auto kernel = flash_attention_kernel<kD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = a.n_qtiles * a.n_heads_total;
  kernel<<<(unsigned int)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 4;          // 16 query rows each
constexpr int kBQ = 16 * kWarps;    // query rows per block
constexpr int kBK = 64;             // keys per tile
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSM = 2;     // at <= 256 registers a thread
constexpr int kStages = 2;          // K/V ring
constexpr int kPad = 8;             // row padding (elements): ldmatrix rows in distinct banks
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// 2^x by the special-function unit (relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) = 1 - 2 / (2^(2 x log2 e) + 1), absolute error ~1e-7 (a logit
// error of softcap * 1e-7); the accurate tanhf took most of a softcapped
// tile's time
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, ex2(2.f * kLog2e * x) + 1.f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, of which the first src_bytes are read and the rest
// zero-filled (0: all zeros, src not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
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

// (x0, x1) as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi); x0 in the
// low half, as the fragments order elements
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// rows [0, kRows) of a row-major (rows, D) bf16 matrix into a shared tile of
// row stride kD + kPad; rows >= valid_rows and columns >= D are zeros.
// kVec: D % 8 == 0 and 16-byte aligned rows, by cp.async (asynchronous);
// else element by element (synchronous).
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

template <int kD, bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
flash_attention_kernel_tc(const Args a) {
  constexpr int LD = kD + kPad;
  constexpr int kKS = kD / 16;  // 16-wide steps over the head dim
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBQ * LD;             // kStages tiles of kBK rows
  bf16* Vs = Ks + kStages * kBK * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row and column pair
  const int D = a.D;

  // heavy (late) q tiles first; consecutive blocks share kv heads
  const int64_t bid = blockIdx.x;
  const int64_t bh = bid % a.n_heads_total;
  const int64_t qt = a.n_qtiles - 1 - bid / a.n_heads_total;
  const int64_t b = bh / a.Hq, h = bh % a.Hq;
  const int64_t kvh = b * (a.Hq / a.group) + h / a.group;
  const int64_t q0 = qt * kBQ;
  const bf16* qg = static_cast<const bf16*>(a.q) + (bh * a.Sq + q0) * D;
  const bf16* kg = static_cast<const bf16*>(a.k) + kvh * a.Skv * D;
  const bf16* vg = static_cast<const bf16*>(a.v) + kvh * a.Skv * D;
  bf16* og = static_cast<bf16*>(a.o) + (bh * a.Sq + q0) * D;

  const int q_rows = (int)(a.Sq - q0 < kBQ ? a.Sq - q0 : kBQ);
  int64_t t_lo, t_hi;
  tile_range(a, q0, q_rows, kBK, t_lo, t_hi);

  auto load_kv = [&](int64_t t, int stage) {
    const int64_t k0 = t * kBK;
    const int rows = (int)(a.Skv - k0 < kBK ? a.Skv - k0 : kBK);
    load_tile<kBK, kD, kVec>(Ks + stage * kBK * LD, kg + k0 * D, rows, D, tid);
    load_tile<kBK, kD, kVec>(Vs + stage * kBK * LD, vg + k0 * D, rows, D, tid);
  };
  load_tile<kBQ, kD, kVec>(Qs, qg, q_rows, D, tid);
  cp_async_commit();
  if (t_lo < t_hi) load_kv(t_lo, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // this warp's 16 rows of Q as A fragments, for the whole run
  uint32_t qf[kKS][4];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks)
    ldsm_x4(qf[ks], smem_addr(Qs + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8));

  // rows g and g + 8 of the warp's slab: running max (log2 units), partial
  // denominator over this lane's columns, numerator fragments
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int64_t qrow = q0 + warp * 16 + g;
  const int64_t q_last = q0 + q_rows - 1;

  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int stage = (int)((t - t_lo) & 1);
    if (t + 1 < t_hi) load_kv(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const bf16* Kt = Ks + stage * kBK * LD;
    const bf16* Vt = Vs + stage * kBK * LD;

    // S = Q K^T: 16 rows x 64 keys a warp, 8 fragments of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int jp = 0; jp < kBK / 16; ++jp) {
        uint32_t kb[4];  // keys 16jp..+7 and +8..+15, head dims 16ks..+15
        ldsm_x4(kb, smem_addr(Kt + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * LD +
                              ks * 16 + ((lane >> 3) & 1) * 8));
        mma(s[2 * jp], qf[ks], kb[0], kb[1]);
        mma(s[2 * jp + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // online softmax in log2 units; the mask only where the tile needs it
    const int64_t k0 = t * kBK;
    const float scale_log2 = a.scale * kLog2e;
    const bool full = k0 + kBK <= a.Skv && (!a.causal || k0 + kBK - 1 <= q0) &&
                      (!a.has_window || k0 > q_last - a.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = a.softcap != 0.f
                      ? a.softcap * kLog2e * tanh_fast(s[j][e] * a.scale / a.softcap)
                      : s[j][e] * scale_log2;
        if (!full) x = masked_logit(a, x, qrow + (e >> 1) * 8, k0 + 8 * j + 2 * t4 + (e & 1));
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = ex2(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[j][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[j][e] = p;
      }
    }

    // O += P V in two bf16 halves of P, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < kD / 16; ++np) {
        uint32_t vb[4];  // keys 16kk..+15, head dims 16np..+7 and +8..+15
        ldsm_x4_trans(vb, smem_addr(Vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                    16 * np + (lane >> 4) * 8));
        mma(o[2 * np], ph, vb[0], vb[1]);
        mma(o[2 * np], pl, vb[0], vb[1]);
        mma(o[2 * np + 1], ph, vb[2], vb[3]);
        mma(o[2 * np + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    if (r >= q_rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    bf16* orow = og + (int64_t)r * D;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int c = 8 * n + 2 * t4;
      const float x0 = o[n][2 * i] / denom, x1 = o[n][2 * i + 1] / denom;
      if (kVec) {  // D even: the pair is in or out together, 4-byte aligned
        if (c < D) *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < D) orow[c] = __float2bfloat16(x0);
        if (c + 1 < D) orow[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int kD, bool kVec>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int LD = kD + kPad;
  const size_t smem = (size_t)(kBQ + 2 * kStages * kBK) * LD * sizeof(bf16);
  auto kernel = flash_attention_kernel_tc<kD, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = a.n_qtiles * a.n_heads_total;
  kernel<<<(unsigned int)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kVec>
int dispatch_d(const Args& a, cudaStream_t stream) {
  if (a.D <= 16) return launch<16, kVec>(a, stream);
  if (a.D <= 32) return launch<32, kVec>(a, stream);
  if (a.D <= 64) return launch<64, kVec>(a, stream);
  return launch<128, kVec>(a, stream);
}

}  // namespace tc

int dispatch_f32(const Args& a, cudaStream_t stream) {
  if (a.D <= 16) return f32::launch<16>(a, stream);
  if (a.D <= 32) return f32::launch<32>(a, stream);
  if (a.D <= 64) return f32::launch<64>(a, stream);
  return f32::launch<128>(a, stream);
}

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores); both take
// 64-row q tiles. window is used when has_window != 0; softcap 0 means
// none. The wrapper checks shapes (1 <= D <= 128, Hq % Hkv == 0) and that
// B * Hq * ceil(Sq / 64) fits a grid.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int64_t B, int64_t Hq,
                                   int64_t Hkv, int64_t Sq, int64_t Skv, int D,
                                   int causal, int has_window, int64_t window,
                                   float softcap, float scale, void* stream) {
  if (D < 1 || D > 128 || Hkv < 1 || Hq % Hkv != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
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
  a.n_heads_total = B * Hq;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    a.n_qtiles = (Sq + f32::kBQ - 1) / f32::kBQ;
    return dispatch_f32(a, s);
  }
  a.n_qtiles = (Sq + tc::kBQ - 1) / tc::kBQ;
  // 16-byte copies (and paired stores) need every row and base 16-byte aligned
  const bool vec = D % 8 == 0 &&
                   (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15) == 0;
  return vec ? tc::dispatch_d<true>(a, s) : tc::dispatch_d<false>(a, s);
}
