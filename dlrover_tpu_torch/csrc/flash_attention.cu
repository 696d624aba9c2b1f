// FlashAttention-2 forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of dlrover_tpu/ops/pallas_attention.py:
//   flash_fwd_kernel     <- _fwd_kernel        (driven by _flash_fwd)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel     (driven by _pallas_backward)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel    (driven by _pallas_backward)
// with the same arithmetic: scores s = (q . k) * scale in f32; masked
// scores (causal q_pos >= k_pos aligned top-left, a sliding window
// q_pos - k_pos < window, keys past the ragged end) set to -1e30; the
// online softmax of _fwd_head_step, in which p = exp(s - m) is rounded to
// the input type before P.V while l sums the unrounded p; l == 0 -> 1;
// lse = m + log l. The backward recomputes p = exp(s - lse) and
// ds = p * (dp - delta) * scale (_p_and_ds), with delta = rowsum(dO * O)
// computed outside (an lse cotangent folds into delta there), and rounds
// p and ds to the input type before the dV, dK and dQ products.
//
// What bounds it: operations. Causal attention at the training shapes
// (B 8, S 1024, H 16, D 128) does 4 * B * H * S^2 * D / 2 = 3.4e10 FLOP in
// the forward, ~100x its bytes over the card's ridge. So the products run
// on the tensor cores: bf16 mma.sync m16n8k16 with f32 accumulation for
// every product of a bf16 call. An f32 call (the f32 model check) runs the
// same tiles through f32 FMAs on the CUDA cores, with the same fragment
// layout, so both share one body.
//
// Design. No block carries state to another: the forward gives each block
// one (b * H + h, 64-row q tile) and loops over 64-key tiles inside; the
// dq kernel does the same; the dkv kernel gives each block one
// (b * Hkv + kh, 64-key tile) and loops over the query heads of the KV
// head's group and over 32-row q tiles, so the GQA group sum of dk/dv is
// a sum in registers and needs no atomics. Each of the block's 4 warps owns
// 16 rows of the output tile and keeps them in mma accumulator fragments.
// Tiles of Q, K, V and dO are staged in shared memory with their rows
// padded by 16 bytes (conflict-free fragment loads); P and dS go through a
// small per-warp buffer, which also rounds them to the input type. The
// operand of a product that is read along its rows (V in P.V, K in dS.K,
// dO in P^T.dO, Q in dS^T.Q) is loaded with ldmatrix.trans. Tiles wholly
// above the causal diagonal or below the window are skipped (_block_runs);
// masks are exact per element, and the ragged tail of S is masked in the
// kernel, so S need not be a multiple of a tile. cp.async/TMA pipelining,
// wgmma and register-resident P are later work.
//
// Layouts as the JAX package's public functions: q, out, dq [B, Sq, H, D];
// k, v, dk, dv [B, Sk, Hkv, D]; lse and delta [B, H, Sq] f32; all
// contiguous. Interface: plain C functions launched on the caller's stream;
// they allocate nothing and return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kFwdBQ = 64;  // q rows per forward / dq block (16 per warp)
constexpr int kFwdBK = 64;  // keys per inner tile of the forward and dq
constexpr int kKvBK = 64;   // keys per dkv block (16 per warp)
constexpr int kKvBQ = 32;   // q rows per inner tile of dkv

using bf16 = __nv_bfloat16;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* out;  // forward: written
  const void* dout;
  const float* lse;    // forward: written
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H, Hkv;
  float scale;
  int causal;
  int window;
};

template <typename T>
__host__ __device__ constexpr int pad_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Two adjacent elements of a row, written as one access.
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Rows [row0, row0 + ROWS) of a [*, D] operand whose rows are gstride
// elements apart, into shared memory with row stride ld; rows at or past
// n_rows are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* s, int ld, const T* g,
                                          size_t gstride, int row0,
                                          int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * gstride +
                                            c);
    *reinterpret_cast<uint4*>(s + r * ld + c) = val;
  }
}

// ---------------------------------------------------------------------------
// Warp-level products. C is a 16 x (8 * NT) tile in mma.sync's accumulator
// layout: lane (g = lane / 4, t = lane % 4) holds c[nt][0..1] at row g,
// columns nt * 8 + 2t, 2t + 1, and c[nt][2..3] at row g + 8. A is a
// row-major [16][K] shared tile (stride lda). B is either given
// transposed, Bt[n][k] (mma_nt), or as stored, B[k][n] (mma_nn).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int NT, int K>
__device__ __forceinline__ void mma_nt(const bf16* A, int lda, const bf16* Bt,
                                       int ldb, float (*c)[4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t a0 = ld32(A + g * lda + k0 + 2 * t);
    const uint32_t a1 = ld32(A + (g + 8) * lda + k0 + 2 * t);
    const uint32_t a2 = ld32(A + g * lda + k0 + 8 + 2 * t);
    const uint32_t a3 = ld32(A + (g + 8) * lda + k0 + 8 + 2 * t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* bp = Bt + (nt * 8 + g) * ldb + k0 + 2 * t;
      mma_bf16(c[nt], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
    }
  }
}

template <int NT, int K>
__device__ __forceinline__ void mma_nn(const bf16* A, int lda, const bf16* B,
                                       int ldb, float (*c)[4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t a0 = ld32(A + g * lda + k0 + 2 * t);
    const uint32_t a1 = ld32(A + (g + 8) * lda + k0 + 2 * t);
    const uint32_t a2 = ld32(A + g * lda + k0 + 8 + 2 * t);
    const uint32_t a3 = ld32(A + (g + 8) * lda + k0 + 8 + 2 * t);
    // lanes 0-15 address rows k0 .. k0 + 15 of B; the transposed 8x8 loads
    // hand lane (g, t) B[k0 + 2t, +1][n0 + g] and B[k0 + 8 + 2t, +1][n0 + g]
    const bf16* row = B + (k0 + (lane & 15)) * ldb;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t addr =
          static_cast<uint32_t>(__cvta_generic_to_shared(row + nt * 8));
      uint32_t b0, b1;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
          : "=r"(b0), "=r"(b1)
          : "r"(addr));
      mma_bf16(c[nt], a0, a1, a2, a3, b0, b1);
    }
  }
}

// The f32 twins: the same tiles and fragment layout, f32 FMAs.
template <int NT, int K>
__device__ __forceinline__ void mma_nt(const float* A, int lda,
                                       const float* Bt, int ldb,
                                       float (*c)[4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a_lo = A[g * lda + k], a_hi = A[(g + 8) * lda + k];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * t;
      const float b0 = Bt[n * ldb + k], b1 = Bt[(n + 1) * ldb + k];
      c[nt][0] = fmaf(a_lo, b0, c[nt][0]);
      c[nt][1] = fmaf(a_lo, b1, c[nt][1]);
      c[nt][2] = fmaf(a_hi, b0, c[nt][2]);
      c[nt][3] = fmaf(a_hi, b1, c[nt][3]);
    }
  }
}

template <int NT, int K>
__device__ __forceinline__ void mma_nn(const float* A, int lda, const float* B,
                                       int ldb, float (*c)[4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a_lo = A[g * lda + k], a_hi = A[(g + 8) * lda + k];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * t;
      const float b0 = B[k * ldb + n], b1 = B[k * ldb + n + 1];
      c[nt][0] = fmaf(a_lo, b0, c[nt][0]);
      c[nt][1] = fmaf(a_lo, b1, c[nt][1]);
      c[nt][2] = fmaf(a_hi, b0, c[nt][2]);
      c[nt][3] = fmaf(a_hi, b1, c[nt][3]);
    }
  }
}

// The mask rule of _allowed_mask, plus the ragged ends of both sequences.
__device__ __forceinline__ bool allowed(const Args& a, int qp, int kp) {
  if (kp >= a.Sk || qp >= a.Sq) return false;
  if (!a.causal) return true;
  return qp >= kp && (a.window == 0 || qp - kp < a.window);
}

// The key tiles [begin, end) of width bk that a q tile [q0, q0 + bq) may
// see (_block_runs): causal tiles past the diagonal and, with a window,
// tiles wholly before the oldest row's window are skipped.
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int bq,
                                          int bk, int* begin, int* end) {
  int e = (a.Sk + bk - 1) / bk;
  int b = 0;
  if (a.causal) {
    e = min(e, (q0 + bq - 1) / bk + 1);
    if (a.window) b = max(0, (q0 - a.window + 1) / bk);
  }
  *begin = b;
  *end = e;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t fwd_smem() {
  constexpr int ld = D + pad_elems<T>(), ldp = kFwdBK + pad_elems<T>();
  return sizeof(T) *
         ((size_t)(kFwdBQ + 2 * kFwdBK) * ld + (size_t)kWarps * 16 * ldp);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Args a) {
  constexpr int LD = D + pad_elems<T>();
  constexpr int LDP = kFwdBK + pad_elems<T>();
  constexpr int NTD = D / 8, NTK = kFwdBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kFwdBQ * LD;
  T* sV = sK + kFwdBK * LD;
  T* sP = sV + kFwdBK * LD + (threadIdx.x / 32) * 16 * LDP;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kFwdBQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int kh = h / (a.H / a.Hkv);
  const size_t qs = (size_t)a.H * D, ks = (size_t)a.Hkv * D;
  const T* qg = static_cast<const T*>(a.q) + ((size_t)b * a.Sq * a.H + h) * D;
  const T* kg =
      static_cast<const T*>(a.k) + ((size_t)b * a.Sk * a.Hkv + kh) * D;
  const T* vg =
      static_cast<const T*>(a.v) + ((size_t)b * a.Sk * a.Hkv + kh) * D;

  load_tile<T, D, kFwdBQ>(sQ, LD, qg, qs, q0, a.Sq);
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NTD][4];
#pragma unroll
  for (int i = 0; i < NTD; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int kt0, kt1;
  key_tiles(a, q0, kFwdBQ, kFwdBK, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kFwdBK;
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile<T, D, kFwdBK>(sK, LD, kg, ks, k0, a.Sk);
    load_tile<T, D, kFwdBK>(sV, LD, vg, ks, k0, a.Sk);
    __syncthreads();
    float s[NTK][4];
#pragma unroll
    for (int i = 0; i < NTK; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    mma_nt<NTK, D>(sQ + warp * 16 * LD, LD, sK, LD, s);
    float cur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + nt * 8 + 2 * t + (i & 1);
        const float x = s[nt][i] * a.scale;
        s[nt][i] = allowed(a, row[i >> 1], kp) ? x : kNegInf;
        cur[i >> 1] = fmaxf(cur[i >> 1], s[nt][i]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(cur[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
      const float p0 = expf(s[nt][0] - m[0]), p1 = expf(s[nt][1] - m[0]);
      const float p2 = expf(s[nt][2] - m[1]), p3 = expf(s[nt][3] - m[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      store2(sP + g * LDP + nt * 8 + 2 * t, p0, p1);
      store2(sP + (g + 8) * LDP + nt * 8 + 2 * t, p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + quad_sum(sum[r]);
#pragma unroll
    for (int i = 0; i < NTD; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
    __syncwarp();
    mma_nn<NTD, kFwdBK>(sP, LDP, sV, LD, acc);
    __syncwarp();
  }

  T* og = static_cast<T*>(const_cast<void*>(a.out)) +
          ((size_t)b * a.Sq * a.H + h) * D;
  float* lg = const_cast<float*>(a.lse) + (size_t)blockIdx.y * a.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.Sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    T* orow = og + (size_t)row[r] * qs;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt)
      store2(orow + nt * 8 + 2 * t, acc[nt][2 * r] / denom,
             acc[nt][2 * r + 1] / denom);
    if (t == 0) lg[row[r]] = m[r] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t dq_smem() {
  constexpr int ld = D + pad_elems<T>(), ldp = kFwdBK + pad_elems<T>();
  return sizeof(T) * ((size_t)(2 * kFwdBQ + 2 * kFwdBK) * ld +
                      (size_t)kWarps * 16 * ldp);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Args a) {
  constexpr int LD = D + pad_elems<T>();
  constexpr int LDP = kFwdBK + pad_elems<T>();
  constexpr int NTD = D / 8, NTK = kFwdBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + kFwdBQ * LD;  // dO
  T* sK = sO + kFwdBQ * LD;
  T* sV = sK + kFwdBK * LD;
  T* sS = sV + kFwdBK * LD + (threadIdx.x / 32) * 16 * LDP;  // this warp's dS

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kFwdBQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int kh = h / (a.H / a.Hkv);
  const size_t qs = (size_t)a.H * D, ks = (size_t)a.Hkv * D;
  const size_t qoff = ((size_t)b * a.Sq * a.H + h) * D;
  const size_t koff = ((size_t)b * a.Sk * a.Hkv + kh) * D;
  const T* kg = static_cast<const T*>(a.k) + koff;
  const T* vg = static_cast<const T*>(a.v) + koff;

  load_tile<T, D, kFwdBQ>(sQ, LD, static_cast<const T*>(a.q) + qoff, qs, q0,
                          a.Sq);
  load_tile<T, D, kFwdBQ>(sO, LD, static_cast<const T*>(a.dout) + qoff, qs, q0,
                          a.Sq);
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t i = (size_t)blockIdx.y * a.Sq + row[r];
    lse[r] = row[r] < a.Sq ? a.lse[i] : 0.f;
    delta[r] = row[r] < a.Sq ? a.delta[i] : 0.f;
  }
  float dq[NTD][4];
#pragma unroll
  for (int i = 0; i < NTD; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  int kt0, kt1;
  key_tiles(a, q0, kFwdBQ, kFwdBK, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kFwdBK;
    __syncthreads();
    load_tile<T, D, kFwdBK>(sK, LD, kg, ks, k0, a.Sk);
    load_tile<T, D, kFwdBK>(sV, LD, vg, ks, k0, a.Sk);
    __syncthreads();
    float s[NTK][4], dp[NTK][4];
#pragma unroll
    for (int i = 0; i < NTK; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    mma_nt<NTK, D>(sQ + warp * 16 * LD, LD, sK, LD, s);
    mma_nt<NTK, D>(sO + warp * 16 * LD, LD, sV, LD, dp);
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int kp = k0 + nt * 8 + 2 * t + (i & 1);
        const float x =
            allowed(a, row[r], kp) ? s[nt][i] * a.scale : kNegInf;
        const float p = expf(x - lse[r]);
        ds[i] = p * (dp[nt][i] - delta[r]) * a.scale;
      }
      store2(sS + g * LDP + nt * 8 + 2 * t, ds[0], ds[1]);
      store2(sS + (g + 8) * LDP + nt * 8 + 2 * t, ds[2], ds[3]);
    }
    __syncwarp();
    mma_nn<NTD, kFwdBK>(sS, LDP, sK, LD, dq);
    __syncwarp();
  }

  T* dqg = static_cast<T*>(a.dq) + qoff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.Sq) continue;
    T* drow = dqg + (size_t)row[r] * qs;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt)
      store2(drow + nt * 8 + 2 * t, dq[nt][2 * r], dq[nt][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t dkv_smem() {
  constexpr int ld = D + pad_elems<T>(), ldw = kKvBQ + pad_elems<T>();
  return sizeof(T) * ((size_t)(2 * kKvBK + 2 * kKvBQ) * ld +
                      (size_t)kWarps * 16 * ldw) +
         sizeof(float) * 2 * kKvBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Args a) {
  constexpr int LD = D + pad_elems<T>();
  constexpr int LDW = kKvBQ + pad_elems<T>();
  constexpr int NTD = D / 8, NTQ = kKvBQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kKvBK * LD;
  T* sQ = sV + kKvBK * LD;
  T* sO = sQ + kKvBQ * LD;  // dO
  T* sW0 = sO + kKvBQ * LD;
  float* sLse = reinterpret_cast<float*>(sW0 + kWarps * 16 * LDW);
  float* sDelta = sLse + kKvBQ;
  T* sW = sW0 + (threadIdx.x / 32) * 16 * LDW;  // this warp's P^T, then dS^T

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kKvBK;
  const int b = blockIdx.y / a.Hkv, kh = blockIdx.y % a.Hkv;
  const int groups = a.H / a.Hkv;
  const size_t qs = (size_t)a.H * D, ks = (size_t)a.Hkv * D;
  const size_t koff = ((size_t)b * a.Sk * a.Hkv + kh) * D;

  load_tile<T, D, kKvBK>(sK, LD, static_cast<const T*>(a.k) + koff, ks, k0,
                         a.Sk);
  load_tile<T, D, kKvBK>(sV, LD, static_cast<const T*>(a.v) + koff, ks, k0,
                         a.Sk);
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk[NTD][4], dv[NTD][4];
#pragma unroll
  for (int i = 0; i < NTD; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  // q tiles of width kKvBQ that may see a key of [k0, k0 + kKvBK)
  const int n_qt = (a.Sq + kKvBQ - 1) / kKvBQ;
  int qt0 = 0, qt1 = n_qt;
  if (a.causal) {
    qt0 = min(k0 / kKvBQ, n_qt);
    if (a.window)
      qt1 = min(n_qt, (k0 + kKvBK - 1 + a.window - 1) / kKvBQ + 1);
  }
  for (int hg = 0; hg < groups; ++hg) {
    const int h = kh * groups + hg;
    const size_t qoff = ((size_t)b * a.Sq * a.H + h) * D;
    const size_t roff = ((size_t)b * a.H + h) * a.Sq;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * kKvBQ;
      __syncthreads();
      load_tile<T, D, kKvBQ>(sQ, LD, static_cast<const T*>(a.q) + qoff, qs, q0,
                             a.Sq);
      load_tile<T, D, kKvBQ>(sO, LD, static_cast<const T*>(a.dout) + qoff, qs,
                             q0, a.Sq);
      for (int i = threadIdx.x; i < kKvBQ; i += kThreads) {
        const bool in = q0 + i < a.Sq;
        sLse[i] = in ? a.lse[roff + q0 + i] : 0.f;
        sDelta[i] = in ? a.delta[roff + q0 + i] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: this warp's 16 keys x kKvBQ queries
      float st[NTQ][4], dpt[NTQ][4];
#pragma unroll
      for (int i = 0; i < NTQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
      mma_nt<NTQ, D>(sK + warp * 16 * LD, LD, sQ, LD, st);
      mma_nt<NTQ, D>(sV + warp * 16 * LD, LD, sO, LD, dpt);
      float ds[NTQ][4];
#pragma unroll
      for (int nt = 0; nt < NTQ; ++nt) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = nt * 8 + 2 * t + (i & 1);
          const float x = allowed(a, q0 + c, key[i >> 1]) ? st[nt][i] * a.scale
                                                          : kNegInf;
          p[i] = expf(x - sLse[c]);
          ds[nt][i] = p[i] * (dpt[nt][i] - sDelta[c]) * a.scale;
        }
        store2(sW + g * LDW + nt * 8 + 2 * t, p[0], p[1]);
        store2(sW + (g + 8) * LDW + nt * 8 + 2 * t, p[2], p[3]);
      }
      __syncwarp();
      mma_nn<NTD, kKvBQ>(sW, LDW, sO, LD, dv);  // dV += P^T dO
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < NTQ; ++nt) {
        store2(sW + g * LDW + nt * 8 + 2 * t, ds[nt][0], ds[nt][1]);
        store2(sW + (g + 8) * LDW + nt * 8 + 2 * t, ds[nt][2], ds[nt][3]);
      }
      __syncwarp();
      mma_nn<NTD, kKvBQ>(sW, LDW, sQ, LD, dk);  // dK += dS^T Q
      __syncwarp();
    }
  }

  T* dkg = static_cast<T*>(a.dk) + koff;
  T* dvg = static_cast<T*>(a.dv) + koff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= a.Sk) continue;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
      const size_t o = (size_t)key[r] * ks + nt * 8 + 2 * t;
      store2(dkg + o, dk[nt][2 * r], dk[nt][2 * r + 1]);
      store2(dvg + o, dv[nt][2 * r], dv[nt][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const Args& a,
                   cudaStream_t stream) {
  // shared memory above 48 KB is opt-in, per kernel
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run(int which, const Args& a, cudaStream_t stream) {
  switch (which) {
    case 0:
      return launch(flash_fwd_kernel<T, D>,
                    dim3((a.Sq + kFwdBQ - 1) / kFwdBQ, a.B * a.H),
                    fwd_smem<T, D>(), a, stream);
    case 1:
      return launch(flash_bwd_dq_kernel<T, D>,
                    dim3((a.Sq + kFwdBQ - 1) / kFwdBQ, a.B * a.H),
                    dq_smem<T, D>(), a, stream);
    case 2:
      return launch(flash_bwd_dkv_kernel<T, D>,
                    dim3((a.Sk + kKvBK - 1) / kKvBK, a.B * a.Hkv),
                    dkv_smem<T, D>(), a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(int which, const Args& a, int D, int dtype, void* stream) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.Hkv <= 0 || a.H % a.Hkv ||
      a.window < 0)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128) return run<bf16, 128>(which, a, st);
  if (dtype == 1 && D == 64) return run<bf16, 64>(which, a, st);
  if (dtype == 0 && D == 128) return run<float, 128>(which, a, st);
  if (dtype == 0 && D == 64) return run<float, 64>(which, a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dO, dq, dk, dv); D is 64
// or 128; lse and delta are f32. Every pointer is 16-byte aligned. Returns
// a cudaError_t (0 = launched).
int dlrover_flash_fwd(const void* q, const void* k, const void* v, void* out,
                      float* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
                      float scale, int causal, int window, int dtype,
                      void* stream) {
  Args a = {q, k, v, out, nullptr, lse, nullptr, nullptr, nullptr, nullptr,
            B, Sq, Sk, H, Hkv, scale, causal, window};
  return dispatch(0, a, D, dtype, stream);
}

// which: 1 = flash_bwd_dq_kernel (writes dq), 2 = flash_bwd_dkv_kernel
// (writes dk, dv).
int dlrover_flash_bwd(int which, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                      int H, int Hkv, int D, float scale, int causal,
                      int window, int dtype, void* stream) {
  if (which != 1 && which != 2) return cudaErrorInvalidValue;
  Args a = {q, k, v, nullptr, dout, lse, delta, dq, dk, dv,
            B, Sq, Sk, H, Hkv, scale, causal, window};
  return dispatch(which, a, D, dtype, stream);
}

}  // extern "C"
