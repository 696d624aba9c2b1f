// FlashAttention-2 forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of dlrover_tpu/ops/pallas_attention.py:
//   flash_fwd_wgmma_kernel         <- _fwd_kernel, bf16         (driven by _flash_fwd)
//   flash_fwd_kernel               <- _fwd_kernel, f32
//   flash_bwd_dq_wgmma_kernel      <- _bwd_dq_kernel, bf16      (driven by _pallas_backward)
//   flash_bwd_dkv_wgmma_kernel     <- _bwd_dkv_kernel, bf16     (driven by _pallas_backward)
//   flash_bwd_dq_kernel            <- _bwd_dq_kernel, f32
//   flash_bwd_dkv_kernel           <- _bwd_dkv_kernel, f32
//   flash_fwd_packed_wgmma_kernel  <- _fwd_kernel_packed, bf16  (head_pack 2)
//   flash_fwd_packed_kernel        <- _fwd_kernel_packed, f32   (head_pack 2)
//   flash_bwd_dq_packed_wgmma_kernel  <- _bwd_dq_kernel_packed, bf16  (head_pack 2)
//   flash_bwd_dkv_packed_wgmma_kernel <- _bwd_dkv_kernel_packed, bf16 (head_pack 2)
//   flash_bwd_dq_packed_kernel     <- _bwd_dq_kernel_packed, f32   (head_pack 2)
//   flash_bwd_dkv_packed_kernel    <- _bwd_dkv_kernel_packed, f32  (head_pack 2)
// with the same arithmetic: scores s = (q . k) * scale in f32; masked
// scores (causal q_pos >= k_pos aligned top-left, a sliding window
// q_pos - k_pos < window, GLM prefix-LM keys k_pos < prefix[b] seen by every
// query, keys past the ragged end) set to -1e30; the online softmax of
// _fwd_head_step, in which p = exp(s - m) is rounded to the input type
// before P.V while l sums the unrounded p; l == 0 -> 1; lse = m + log l.
// The backward recomputes p = exp(s - lse) and ds = p * (dp - delta) *
// scale (_p_and_ds), with delta = rowsum(dO * O) computed outside (an lse
// cotangent folds into delta there), and rounds p and ds to the input type
// before the dV, dK and dQ products.
//
// What bounds it: operations. Causal attention at the training shapes
// (B 8, S 1024, H 16, D 128) does 4 * B * H * S^2 * D / 2 = 3.4e10 FLOP in
// the forward, ~100x its bytes over the card's ridge; the backward's least
// work is 10·D FLOP a visible pair (five products), and its two kernels
// execute 14·D (both recompute Q.K^T and dO.V^T, so that neither needs
// atomics). So the products run on the tensor cores: every bf16 kernel
// runs on wgmma, the only path to the card's full tensor-core rate, from
// shared-memory tiles that TMA fills under the products (attn_fwd_core.cuh's
// primitives; P and dS kept in registers): flash_fwd_wgmma_kernel and
// flash_fwd_packed_wgmma_kernel (one persistent body walking items of a
// head and 128 q rows, or of two heads and 64 q rows),
// flash_bwd_dq_wgmma_kernel (128 q rows of a head a block) and
// flash_bwd_dkv_wgmma_kernel (128 keys of a KV head a block), and their
// packed twins flash_bwd_dq_packed_wgmma_kernel (64 q rows of two heads)
// and flash_bwd_dkv_packed_wgmma_kernel (64 keys of two heads); see each
// below. An f32 call (the f32 model checks) runs the mma.sync bodies,
// whose tiles go through f32 FMAs on the CUDA cores in mma.sync's fragment
// layout.
//
// The mma.sync bodies (every f32 kernel). No block carries state to
// another: the forward gives each block NH query heads of one batch element
// and one 64-row q tile and loops over 64-key tiles inside; the dq kernel
// does the same; the dkv kernel gives each block NH KV heads and one 64-key
// tile and loops over the query heads of each KV head's group and over
// 32-row q tiles, so the GQA group sum of dk/dv is a sum in registers and
// needs no atomics. Each head of a block has a group of 4 warps; each warp
// owns 16 rows of its head's output tile and keeps them in mma accumulator
// fragments. Tiles of Q, K, V and dO are staged in shared memory with their
// rows padded by 16 bytes (conflict-free fragment loads); P and dS go
// through a small per-warp buffer. The operand of a product that is read
// along its rows (V in P.V, K in dS.K, dO in P^T.dO, Q in dS^T.Q) is read
// as stored (mma_nn). Tiles wholly above the causal diagonal or below the
// window, and outside the prefix, are skipped (_block_runs); tiles wholly
// visible (under the diagonal, inside the prefix) only scale their scores;
// the others are masked exactly per element, the ragged tail of S included,
// so S need not be a multiple of a tile. The packed bodies' forward and dkv
// double-buffer their streamed tiles with cp.async (below, kv_bufs).
//
// Head packing (NH = 2, D = 64, MHA: the packed kernels). In the
// [B, S, H, D] layout heads 2p and 2p + 1 are one contiguous run of 128
// elements (256 bytes in bf16) of every row, so a packed block stages Q, K,
// V and dO as [rows, 128] tiles in one coalesced pass by all 8 warps (the
// bf16 kernels: two adjacent TMA boxes a tile), where the unpacked D = 64
// kernel reads 128-byte pieces H * D * 2 bytes apart: the card's
// counterpart of the TPU kernels' K/V DMA in pack-head batches. Each warp
// group then computes one head from the shared tiles. With an odd H the
// last pack's second head does not exist: its block loads only the first
// head's columns, and the second warp group takes part in the loads and
// barriers but computes and writes nothing (the JAX wrapper zero-pads the
// heads instead).
//
// Layouts as the JAX package's public functions: q, out, dq [B, Sq, H, D];
// k, v, dk, dv [B, Sk, Hkv, D]; lse and delta [B, H, Sq] f32; prefix [B]
// int32 (or null); all contiguous. Interface: plain C functions launched on
// the caller's stream; they allocate nothing and return cudaGetLastError()
// after the launch.

#include <cuda.h>  // CUtensorMap
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "attn_fwd_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;   // warps per head of a block (16 rows each)
constexpr int kFwdBQ = 64;  // q rows per forward / dq block (16 per warp)
constexpr int kFwdBK = 64;  // keys per inner tile of the forward and dq
constexpr int kKvBK = 64;   // keys per dkv block (16 per warp)
constexpr int kKvBQ = 32;   // q rows per inner tile of dkv
constexpr int kPackD = 64;  // head_dim of the packed kernels (2 heads)

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
  const int* prefix;  // [B] prefix-LM lengths, or null
  int B, Sq, Sk, H, Hkv;
  float scale;
  int causal;
  int window;
};

template <typename T>
__host__ __device__ constexpr int pad_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

// threads of a block holding NH heads: a group of kWarps warps per head
template <int NH>
__host__ __device__ constexpr int block_threads() {
  return NH * kWarps * 32;
}

// Two adjacent elements of a row, written as one access.
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Rows [row0, row0 + ROWS) of an operand whose rows are gstride elements
// apart, W columns of each, into shared memory with row stride ld; rows at
// or past n_rows, and columns at or past cols (the missing head of a ragged
// pack), are zero and never read.
template <typename T, int W, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(T* s, int ld, const T* g,
                                          size_t gstride, int row0,
                                          int n_rows, int cols) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = W / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += THREADS) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows && c < cols)
      val = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * gstride +
                                            c);
    *reinterpret_cast<uint4*>(s + r * ld + c) = val;
  }
}

// load_tile's asynchronous twin (cp.async, 16 bytes a thread a step):
// the copies land in the background until cp_async_wait; rows or
// columns out of range are zero-filled without a read.
__device__ __forceinline__ void cp_async(void* s, const void* g, int bytes,
                                         bool valid) {
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
                 "l"(g), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa),
                 "l"(g), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int W, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(T* s, int ld, const T* g,
                                                size_t gstride, int row0,
                                                int n_rows, int cols) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = W / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += THREADS) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const bool valid = row0 + r < n_rows && c < cols;
    cp_async(s + r * ld + c, valid ? g + (size_t)(row0 + r) * gstride + c : g,
             16, valid);
  }
}

// ---------------------------------------------------------------------------
// Warp-level products of the f32 bodies, in mma.sync's fragment layout
// through f32 FMAs. C is a 16 x (8 * NT) tile: lane (g = lane / 4, t =
// lane % 4) holds c[nt][0..1] at row g, columns nt * 8 + 2t, 2t + 1, and
// c[nt][2..3] at row g + 8. A is a row-major [16][K] shared tile (stride
// lda). B is either given transposed, Bt[n][k] (mma_nt), or as stored,
// B[k][n] (mma_nn).
// ---------------------------------------------------------------------------

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
// pref is this batch element's prefix length (0 without a prefix).
__device__ __forceinline__ bool allowed(const Args& a, int pref, int qp,
                                        int kp) {
  if (kp >= a.Sk || qp >= a.Sq) return false;
  if (!a.causal || kp < pref) return true;
  return qp >= kp && (a.window == 0 || qp - kp < a.window);
}

// Every (query, key) of the tile [q0, q0 + bq) x [k0, k0 + bk) is visible:
// the tiles under the causal diagonal (inside the window) or inside the
// prefix, most of a causal sweep, need no mask.
__device__ __forceinline__ bool tile_visible(const Args& a, int pref, int q0,
                                             int bq, int k0, int bk) {
  if (q0 + bq > a.Sq || k0 + bk > a.Sk) return false;
  if (!a.causal || k0 + bk <= pref) return true;
  return k0 + bk - 1 <= q0 && (a.window == 0 || q0 + bq - 1 - k0 < a.window);
}

// s *= scale, and the elements of the tile that the mask hides set to -1e30
// (none on a wholly visible tile). Element (nt, i) of this lane lies at row
// rows[i >> 1] and column c0 + nt * 8 + 2t + (i & 1); rows are queries and
// columns keys, or (KEY_ROWS, the dkv kernel's transposed scores) the other
// way round.
template <int NT, bool KEY_ROWS>
__device__ __forceinline__ void scale_mask(float (*s)[4], const Args& a,
                                           int pref, bool whole,
                                           const int rows[2], int c0) {
  if (whole) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] *= a.scale;
    return;
  }
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rows[i >> 1], c = c0 + nt * 8 + 2 * t + (i & 1);
      const bool in =
          KEY_ROWS ? allowed(a, pref, c, r) : allowed(a, pref, r, c);
      s[nt][i] = in ? s[nt][i] * a.scale : kNegInf;
    }
}

// The key tiles [begin, end) of width bk that a q tile [q0, q0 + bq) may
// see (_block_runs): causal tiles past the diagonal and, with a window,
// tiles wholly before the oldest row's window are skipped; tiles that reach
// into the prefix run for every q tile.
__device__ __forceinline__ void key_tiles(const Args& a, int pref, int q0,
                                          int bq, int bk, int* begin,
                                          int* end) {
  const int n = (a.Sk + bk - 1) / bk;
  int b = 0, e = n;
  if (a.causal) {
    e = min(n, (q0 + bq - 1) / bk + 1);
    if (a.window) b = max(0, (q0 - a.window + 1) / bk);
    e = max(e, (min(pref, a.Sk) + bk - 1) / bk);
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

// The heads of a block: batch element b, NH consecutive heads from h0 of
// which nh exist (nh < NH only in the last pack of an odd head count), and
// the KV head kh they read (NH > 1 is MHA, so kh == h0). n_heads is H for
// the forward and dq, Hkv for dkv.
struct Heads {
  int b, h0, nh, kh;
};

template <int NH>
__device__ __forceinline__ Heads block_heads(const Args& a, int n_heads) {
  const int per_b = (n_heads + NH - 1) / NH;
  Heads x;
  x.b = blockIdx.y / per_b;
  x.h0 = (blockIdx.y % per_b) * NH;
  x.nh = NH == 1 ? 1 : min(NH, n_heads - x.h0);
  x.kh = x.h0 / (a.H / a.Hkv);
  return x;
}

__device__ __forceinline__ int prefix_of(const Args& a, int b) {
  return a.prefix ? a.prefix[b] : 0;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// The packed kernels double-buffer their streamed tiles (K/V in the
// forward, Q/dO with lse/delta in dkv): the next tile's cp.async copies
// run under the current tile's products. Their blocks of 8 warps share
// one barrier per tile, so an SM's two blocks hide less of an unpipelined
// load than the unpacked kernels' four blocks of 4 warps.
template <int NH>
__host__ __device__ constexpr int kv_bufs() {
  return NH > 1 ? 2 : 1;
}

template <typename T, int W, int NH>
constexpr size_t fwd_smem() {
  constexpr int ld = W + pad_elems<T>(), ldp = kFwdBK + pad_elems<T>();
  return sizeof(T) * ((size_t)(kFwdBQ + kv_bufs<NH>() * 2 * kFwdBK) * ld +
                      (size_t)NH * kWarps * 16 * ldp);
}

template <typename T, int D, int NH>
__device__ __forceinline__ void fwd_body(const Args& a) {
  constexpr int W = NH * D;
  constexpr int LD = W + pad_elems<T>();
  constexpr int LDP = kFwdBK + pad_elems<T>();
  constexpr int NTD = D / 8, NTK = kFwdBK / 8;
  constexpr int THREADS = block_threads<NH>();
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NB = kv_bufs<NH>();
  constexpr int KV = 2 * kFwdBK * LD;  // one buffer: K, then V
  T* sQ = reinterpret_cast<T*>(smem);
  T* sKV = sQ + kFwdBQ * LD;
  T* sP = sKV + NB * KV + (threadIdx.x / 32) * 16 * LDP;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // this warp's head and its 16-row slice (one head a block: 0 and warp)
  const int hh = NH == 1 ? 0 : warp / kWarps;
  const int wr = NH == 1 ? warp : warp % kWarps;
  const int q0 = blockIdx.x * kFwdBQ;
  const Heads hd = block_heads<NH>(a, a.H);
  const bool live = NH == 1 || hh < hd.nh;  // false: a ragged pack's head 2
  const int pref = prefix_of(a, hd.b);
  const int cols = hd.nh * D;
  const size_t qs = (size_t)a.H * D, ks = (size_t)a.Hkv * D;
  const T* qg =
      static_cast<const T*>(a.q) + ((size_t)hd.b * a.Sq * a.H + hd.h0) * D;
  const T* kg =
      static_cast<const T*>(a.k) + ((size_t)hd.b * a.Sk * a.Hkv + hd.kh) * D;
  const T* vg =
      static_cast<const T*>(a.v) + ((size_t)hd.b * a.Sk * a.Hkv + hd.kh) * D;

  load_tile<T, W, kFwdBQ, THREADS>(sQ, LD, qg, qs, q0, a.Sq, cols);
  const int row[2] = {q0 + wr * 16 + g, q0 + wr * 16 + g + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[NTD][4];
#pragma unroll
  for (int i = 0; i < NTD; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int kt0, kt1;
  key_tiles(a, pref, q0, kFwdBQ, kFwdBK, &kt0, &kt1);
  auto prefetch = [&](int k0, T* buf) {
    load_tile_async<T, W, kFwdBK, THREADS>(buf, LD, kg, ks, k0, a.Sk, cols);
    load_tile_async<T, W, kFwdBK, THREADS>(buf + kFwdBK * LD, LD, vg, ks, k0,
                                           a.Sk, cols);
  };
  if constexpr (NB == 2) {
    if (kt0 < kt1) prefetch(kt0 * kFwdBK, sKV);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kFwdBK;
    T* sK = sKV + (NB == 2 ? ((kt - kt0) & 1) * KV : 0);
    T* sV = sK + kFwdBK * LD;
    if constexpr (NB == 2) {
      cp_async_wait<0>();  // this tile's copies, the only ones in flight
      // one barrier: this tile is visible to every warp, and the other
      // buffer's readers (the previous tile) are done, so refill it under
      // this tile's products
      __syncthreads();
      if (kt + 1 < kt1)
        prefetch(k0 + kFwdBK, sKV + ((kt + 1 - kt0) & 1) * KV);
      cp_async_commit();
    } else {
      __syncthreads();  // the previous tile's K/V are no longer read
      load_tile<T, W, kFwdBK, THREADS>(sK, LD, kg, ks, k0, a.Sk, cols);
      load_tile<T, W, kFwdBK, THREADS>(sV, LD, vg, ks, k0, a.Sk, cols);
      __syncthreads();
    }
    if (!live) continue;
    const bool whole = tile_visible(a, pref, q0, kFwdBQ, k0, kFwdBK);
    float s[NTK][4];
#pragma unroll
    for (int i = 0; i < NTK; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    mma_nt<NTK, D>(sQ + wr * 16 * LD + hh * D, LD, sK + hh * D, LD, s);
    scale_mask<NTK, false>(s, a, pref, whole, row, k0);
    float cur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) cur[i >> 1] = fmaxf(cur[i >> 1], s[nt][i]);
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(cur[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
      const float p0 = expf(s[nt][0] - m[0]);
      const float p1 = expf(s[nt][1] - m[0]);
      const float p2 = expf(s[nt][2] - m[1]);
      const float p3 = expf(s[nt][3] - m[1]);
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
    mma_nn<NTD, kFwdBK>(sP, LDP, sV + hh * D, LD, acc);
    __syncwarp();
  }
  if (!live) return;

  T* og = static_cast<T*>(const_cast<void*>(a.out)) +
          ((size_t)hd.b * a.Sq * a.H + hd.h0 + hh) * D;
  float* lg =
      const_cast<float*>(a.lse) + ((size_t)hd.b * a.H + hd.h0 + hh) * a.Sq;
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

template <typename T, int W, int NH>
constexpr size_t dq_smem() {
  constexpr int ld = W + pad_elems<T>(), ldp = kFwdBK + pad_elems<T>();
  return sizeof(T) * ((size_t)(2 * kFwdBQ + 2 * kFwdBK) * ld +
                      (size_t)NH * kWarps * 16 * ldp);
}

template <typename T, int D, int NH>
__device__ __forceinline__ void dq_body(const Args& a) {
  constexpr int W = NH * D;
  constexpr int LD = W + pad_elems<T>();
  constexpr int LDP = kFwdBK + pad_elems<T>();
  constexpr int NTD = D / 8, NTK = kFwdBK / 8;
  constexpr int THREADS = block_threads<NH>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + kFwdBQ * LD;  // dO
  T* sK = sO + kFwdBQ * LD;
  T* sV = sK + kFwdBK * LD;
  T* sS = sV + kFwdBK * LD + (threadIdx.x / 32) * 16 * LDP;  // this warp's dS

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int hh = NH == 1 ? 0 : warp / kWarps;
  const int wr = NH == 1 ? warp : warp % kWarps;
  const int q0 = blockIdx.x * kFwdBQ;
  const Heads hd = block_heads<NH>(a, a.H);
  const bool live = NH == 1 || hh < hd.nh;
  const int pref = prefix_of(a, hd.b);
  const int cols = hd.nh * D;
  const size_t qs = (size_t)a.H * D, ks = (size_t)a.Hkv * D;
  const size_t qoff = ((size_t)hd.b * a.Sq * a.H + hd.h0) * D;
  const size_t koff = ((size_t)hd.b * a.Sk * a.Hkv + hd.kh) * D;
  const T* kg = static_cast<const T*>(a.k) + koff;
  const T* vg = static_cast<const T*>(a.v) + koff;

  load_tile<T, W, kFwdBQ, THREADS>(sQ, LD, static_cast<const T*>(a.q) + qoff,
                                   qs, q0, a.Sq, cols);
  load_tile<T, W, kFwdBQ, THREADS>(
      sO, LD, static_cast<const T*>(a.dout) + qoff, qs, q0, a.Sq, cols);
  const int row[2] = {q0 + wr * 16 + g, q0 + wr * 16 + g + 8};
  float lse[2], delta[2], dq[NTD][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = live && row[r] < a.Sq;
    const size_t i = ((size_t)hd.b * a.H + hd.h0 + hh) * a.Sq + row[r];
    lse[r] = in ? a.lse[i] : 0.f;
    delta[r] = in ? a.delta[i] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < NTD; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  int kt0, kt1;
  key_tiles(a, pref, q0, kFwdBQ, kFwdBK, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kFwdBK;
    __syncthreads();
    load_tile<T, W, kFwdBK, THREADS>(sK, LD, kg, ks, k0, a.Sk, cols);
    load_tile<T, W, kFwdBK, THREADS>(sV, LD, vg, ks, k0, a.Sk, cols);
    __syncthreads();
    if (!live) continue;
    const bool whole = tile_visible(a, pref, q0, kFwdBQ, k0, kFwdBK);
    float s[NTK][4], dp[NTK][4];
#pragma unroll
    for (int i = 0; i < NTK; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    mma_nt<NTK, D>(sQ + wr * 16 * LD + hh * D, LD, sK + hh * D, LD, s);
    mma_nt<NTK, D>(sO + wr * 16 * LD + hh * D, LD, sV + hh * D, LD, dp);
    scale_mask<NTK, false>(s, a, pref, whole, row, k0);
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float p = expf(s[nt][i] - lse[r]);
        ds[i] = p * (dp[nt][i] - delta[r]) * a.scale;
      }
      store2(sS + g * LDP + nt * 8 + 2 * t, ds[0], ds[1]);
      store2(sS + (g + 8) * LDP + nt * 8 + 2 * t, ds[2], ds[3]);
    }
    __syncwarp();
    mma_nn<NTD, kFwdBK>(sS, LDP, sK + hh * D, LD, dq);
    __syncwarp();
  }
  if (!live) return;

  T* dqg = static_cast<T*>(a.dq) + qoff + hh * D;
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

template <typename T, int W, int NH>
constexpr size_t dkv_smem() {
  constexpr int ld = W + pad_elems<T>(), ldw = kKvBQ + pad_elems<T>();
  constexpr int nb = kv_bufs<NH>();
  return sizeof(T) * ((size_t)(2 * kKvBK + nb * 2 * kKvBQ) * ld +
                      (size_t)NH * kWarps * 16 * ldw) +
         sizeof(float) * nb * 2 * NH * kKvBQ;
}

template <typename T, int D, int NH>
__device__ __forceinline__ void dkv_body(const Args& a) {
  constexpr int W = NH * D;
  constexpr int LD = W + pad_elems<T>();
  constexpr int LDW = kKvBQ + pad_elems<T>();
  constexpr int NTD = D / 8, NTQ = kKvBQ / 8;
  constexpr int THREADS = block_threads<NH>();
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NB = kv_bufs<NH>();
  constexpr int QO = 2 * kKvBQ * LD;  // one buffer: Q, then dO
  constexpr int RS = 2 * NH * kKvBQ;  // one buffer: lse, then delta [NH][BQ]
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kKvBK * LD;
  T* sQO = sV + kKvBK * LD;
  T* sW0 = sQO + NB * QO;
  float* sRows = reinterpret_cast<float*>(sW0 + NH * kWarps * 16 * LDW);
  T* sW = sW0 + (threadIdx.x / 32) * 16 * LDW;  // this warp's P^T, then dS^T

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int hh = NH == 1 ? 0 : warp / kWarps;  // head, 16-key slice
  const int wr = NH == 1 ? warp : warp % kWarps;
  const int k0 = blockIdx.x * kKvBK;
  const Heads hd = block_heads<NH>(a, a.Hkv);  // h0, nh: KV heads
  const bool live = NH == 1 || hh < hd.nh;
  const int pref = prefix_of(a, hd.b);
  const int cols = hd.nh * D;
  const int groups = a.H / a.Hkv;  // 1 when packed (MHA)
  const size_t qs = (size_t)a.H * D, ks = (size_t)a.Hkv * D;
  const size_t koff = ((size_t)hd.b * a.Sk * a.Hkv + hd.h0) * D;

  load_tile<T, W, kKvBK, THREADS>(sK, LD, static_cast<const T*>(a.k) + koff,
                                  ks, k0, a.Sk, cols);
  load_tile<T, W, kKvBK, THREADS>(sV, LD, static_cast<const T*>(a.v) + koff,
                                  ks, k0, a.Sk, cols);
  const int key[2] = {k0 + wr * 16 + g, k0 + wr * 16 + g + 8};
  float dk[NTD][4], dv[NTD][4];
#pragma unroll
  for (int i = 0; i < NTD; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  // q tiles of width kKvBQ that may see a key of [k0, k0 + kKvBK): under
  // causal from the diagonal on, unless the tile reaches into the prefix,
  // whose keys every query sees
  const int n_qt = (a.Sq + kKvBQ - 1) / kKvBQ;
  int qt0 = 0, qt1 = n_qt;
  if (a.causal && k0 >= pref) {
    qt0 = min(k0 / kKvBQ, n_qt);
    if (a.window)
      qt1 = min(n_qt, (k0 + kKvBK - 1 + a.window - 1) / kKvBQ + 1);
  }
  for (int hg = 0; hg < groups; ++hg) {
    // query heads h0 * groups + hg (+ hh when packed, where groups == 1, so
    // the double-buffered loop below runs once)
    const int qh0 = hd.h0 * groups + hg;
    const size_t qoff = ((size_t)hd.b * a.Sq * a.H + qh0) * D;
    const T* qg = static_cast<const T*>(a.q) + qoff;
    const T* og = static_cast<const T*>(a.dout) + qoff;  // dO
    const size_t roff = ((size_t)hd.b * a.H + qh0) * a.Sq;
    // a q tile's Q, dO, lse and delta into buffer b, asynchronously
    auto prefetch = [&](int q0, int b) {
      load_tile_async<T, W, kKvBQ, THREADS>(sQO + b * QO, LD, qg, qs, q0,
                                            a.Sq, cols);
      load_tile_async<T, W, kKvBQ, THREADS>(sQO + b * QO + kKvBQ * LD, LD,
                                            og, qs, q0, a.Sq, cols);
      float* rows = sRows + b * RS;
      for (int i = threadIdx.x; i < NH * kKvBQ; i += THREADS) {
        const int h = i / kKvBQ, r = i % kKvBQ;
        const bool in = h < hd.nh && q0 + r < a.Sq;
        const size_t j = roff + (size_t)h * a.Sq + q0 + r;
        cp_async(rows + i, in ? a.lse + j : a.lse, 4, in);
        cp_async(rows + NH * kKvBQ + i, in ? a.delta + j : a.delta, 4, in);
      }
    };
    if constexpr (NB == 2) {
      if (qt0 < qt1) prefetch(qt0 * kKvBQ, 0);
      cp_async_commit();
    }
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * kKvBQ;
      const int b = NB == 2 ? (qt - qt0) & 1 : 0;
      const T* sQ = sQO + b * QO;
      const T* sO = sQ + kKvBQ * LD;  // dO
      const float* lse_h = sRows + b * RS + hh * kKvBQ;
      const float* delta_h = lse_h + NH * kKvBQ;
      if constexpr (NB == 2) {
        cp_async_wait<0>();  // as in the forward: one barrier a tile
        __syncthreads();
        if (qt + 1 < qt1) prefetch(q0 + kKvBQ, b ^ 1);
        cp_async_commit();
      } else {
        __syncthreads();
        load_tile<T, W, kKvBQ, THREADS>(sQO, LD, qg, qs, q0, a.Sq, cols);
        load_tile<T, W, kKvBQ, THREADS>(sQO + kKvBQ * LD, LD, og, qs, q0,
                                        a.Sq, cols);
        for (int i = threadIdx.x; i < NH * kKvBQ; i += THREADS) {
          const int h = i / kKvBQ, r = i % kKvBQ;
          const bool in = h < hd.nh && q0 + r < a.Sq;
          const size_t j = roff + (size_t)h * a.Sq + q0 + r;
          sRows[i] = in ? a.lse[j] : 0.f;
          sRows[NH * kKvBQ + i] = in ? a.delta[j] : 0.f;
        }
        __syncthreads();
      }
      if (!live) continue;
      const bool whole = tile_visible(a, pref, q0, kKvBQ, k0, kKvBK);
      // S^T and dP^T: this warp's 16 keys x kKvBQ queries
      float st[NTQ][4], dpt[NTQ][4];
#pragma unroll
      for (int i = 0; i < NTQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
      mma_nt<NTQ, D>(sK + wr * 16 * LD + hh * D, LD, sQ + hh * D, LD, st);
      mma_nt<NTQ, D>(sV + wr * 16 * LD + hh * D, LD, sO + hh * D, LD, dpt);
      scale_mask<NTQ, true>(st, a, pref, whole, key, q0);
      float ds[NTQ][4];
#pragma unroll
      for (int nt = 0; nt < NTQ; ++nt) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = nt * 8 + 2 * t + (i & 1);
          p[i] = expf(st[nt][i] - lse_h[c]);
          ds[nt][i] = p[i] * (dpt[nt][i] - delta_h[c]) * a.scale;
        }
        store2(sW + g * LDW + nt * 8 + 2 * t, p[0], p[1]);
        store2(sW + (g + 8) * LDW + nt * 8 + 2 * t, p[2], p[3]);
      }
      __syncwarp();
      mma_nn<NTD, kKvBQ>(sW, LDW, sO + hh * D, LD, dv);  // dV += P^T dO
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < NTQ; ++nt) {
        store2(sW + g * LDW + nt * 8 + 2 * t, ds[nt][0], ds[nt][1]);
        store2(sW + (g + 8) * LDW + nt * 8 + 2 * t, ds[nt][2], ds[nt][3]);
      }
      __syncwarp();
      mma_nn<NTD, kKvBQ>(sW, LDW, sQ + hh * D, LD, dk);  // dK += dS^T Q
      __syncwarp();
    }
  }
  if (!live) return;

  T* dkg = static_cast<T*>(a.dk) + koff + hh * D;
  T* dvg = static_cast<T*>(a.dv) + koff + hh * D;
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
// the mma.sync kernels: one head per block (D 64 or 128, GQA; f32) or two
// packed heads of 64 (MHA; f32), a warp group each
// ---------------------------------------------------------------------------

constexpr int kThreads1 = block_threads<1>();
constexpr int kThreads2 = block_threads<2>();

template <typename T, int D>
__global__ void __launch_bounds__(kThreads1) flash_fwd_kernel(const Args a) {
  fwd_body<T, D, 1>(a);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads1)
    flash_bwd_dq_kernel(const Args a) {
  dq_body<T, D, 1>(a);
}

// at D 64, four blocks an SM (128 registers a thread) hide the global loads
// of the unpipelined q-tile loop; one more register costs a quarter of them
template <typename T, int D>
__global__ void __launch_bounds__(kThreads1, D == 64 ? 4 : 1)
    flash_bwd_dkv_kernel(const Args a) {
  dkv_body<T, D, 1>(a);
}

// the packed kernels keep the unpacked D 64 kernels' 16 warps an SM: two
// blocks of 8 warps at 128 registers a thread
template <typename T>
__global__ void __launch_bounds__(kThreads2, 2)
    flash_fwd_packed_kernel(const Args a) {
  fwd_body<T, kPackD, 2>(a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads2, 2)
    flash_bwd_dq_packed_kernel(const Args a) {
  dq_body<T, kPackD, 2>(a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads2, 2)
    flash_bwd_dkv_packed_kernel(const Args a) {
  dkv_body<T, kPackD, 2>(a);
}

// ---------------------------------------------------------------------------
// the bf16 forward on the tensor-core core: one head, or two packed heads
// of 64, a work item
// ---------------------------------------------------------------------------
//
// flash_fwd_wgmma_kernel replaces _fwd_kernel (pallas_attention.py l.213;
// pallas_call l.1039 in _flash_fwd l.887) for bf16, and
// flash_fwd_packed_wgmma_kernel replaces _fwd_kernel_packed (l.278; the
// same pallas_call). Both are one body, fwd_wgmma_body<D, NH>, with the
// heads of a work item as a template parameter:
// - NH 1 (K1): one query head of D 64 or 128 and a tile of 128 q rows (64
//   a consumer warpgroup); GQA reads KV head h / (H / Hkv), never
//   repeated;
// - NH 2 (K1p): two MHA heads of 64 and a tile of 64 q rows, the mask
//   computed once for both; consumer warpgroup j computes head 2p + j.
// What bounds them: at llama-1.4b's shape (B 8, S 1024, H 16, D 128,
// causal) the bytes (134 MB read and written once: 40 us at the HBM rate)
// and the operations (3.4e10 FLOP: 35 us at the bf16 peak) are close, at
// gpt2-1.5b's (B 8, S 1024, H 25, D 64) 106 MB (32 us) and 2.7e10 FLOP
// (27 us). So the design goes for the tensor-core rate on
// attn_fwd_core.cuh's core (wgmma for Q.K^T and P.V, the online softmax in
// registers; p rounded to bf16 before P.V, l summing the unrounded p,
// l == 0 -> 1) and keeps the tensor cores fed from one item to the next.
//
// Persistent: one block an SM takes items from a counter in device memory
// (K1 g_fwd_work, K1p g_packed_work) in the order of the hardware's block
// scheduler, and its K/V ring runs on from one item into the next. Items
// go head by head, each head's q tiles from the last: the causal items
// that do the most work first. K1 walks KV head by KV head with the query
// heads of one group adjacent at each q tile, so the blocks at work at
// once read few heads' K/V, which stay in L2 (K1p: pack by pack). The
// last block to finish resets the counter, so a kernel's launches must
// follow each other on one stream.
//
// The producer thread takes the item, publishes it beside its Q slot and,
// once the consumers have released the slot, loads the item's Q by TMA
// ([64 rows, 64 columns] boxes of a 4-d map [B, Sq, H, D]) on the slot's
// barrier; then each stage of 128 keys ([128 keys, 64 columns] boxes of
// [B, Sk, Hkv, D] maps: K1 the D / 64 column blocks of its KV head, K1p
// heads 2p and 2p + 1, which lays the stage out exactly as a D 128 stage,
// column block j holding head 2p + j); then an end Meta. The key tiles are
// key_tiles' for the item's rows. The consumers release the Q slot as soon
// as their walk has read Q for the last time (consume()'s q_done), so the
// next item's Q and first stages land under this item's last P.V and its
// output stores; the output leaves by TMA from the last tile's stage
// (consume()'s epi, below). Shared memory: K1 at D 128 holds one Q slot of 128 rows
// (32 KB) and 3 stages of 128 keys (192 KB), 225 KB in all; two Q slots
// and 3 stages would take 257 KB of the 227 KB a block can have, and two
// Q slots with 2 stages ran 18% slower at llama-1.4b's shape (0.1191
// against 0.1009 ms, PERF.md). K1p holds two Q slots of 16 KB.
// Keys past Sk and rows past Sq come in from TMA as zeros and are masked;
// stores stop at Sq. lse [B, H, Sq] f32 is written as K2 reads it.
//
// With an odd H the last pack of K1p has one head: its producer loads only
// that head's boxes (half the expected bytes), and the second consumer
// computes and writes nothing but still takes and releases each of the
// item's stages and its Q slot, so every barrier counts both consumers'
// arrivals.
//
// The mask (RangeMask) is one range of keys [lo, hi) a row, computed once
// an item, so a masked tile costs two compares and a select a score: a
// per-element rule compiled with its branches took the softmax of a
// masked tile (one in 4.5 at these shapes) to ~5k cycles.

namespace ac = attn_core;

constexpr int kTcBK = 128;  // keys a K/V stage

// q rows a forward item: 128 of one head (64 a consumer), or 64 of a pack
template <int NH>
__host__ __device__ constexpr int fwd_rows() {
  return ac::kRows * ac::kConsumers / NH;
}

// The forward's shared memory: a stage holds the NH heads' columns, laid
// out as a D * NH stage; the Q region holds kQSlots slots of kSlot bytes,
// consumer j's tile at j * kSlot / 2 of its slot; extra: the Q slots'
// full and empty barriers, then their item numbers.
template <int D, int NH>
struct FwdTc {
  static_assert(NH == 1 || D == 64, "the packed heads are 64 wide");
  static constexpr int kQSlots = NH == 1 ? 1 : 2;
  using L = ac::Layout<D * NH, kTcBK, 48>;
  static constexpr int kSlot = ac::kConsumers * L::kQTile / kQSlots;
};

// The keys a row sees are one range: causal, [max(0, q - window + 1),
// max(prefix, q + 1)) (a window and a prefix exclude each other), else
// [0, Sk); cut to [0, Sk), and empty for rows past Sq. whole(): every row
// of this warp sees every key of the tile. tile(): the rows' ranges
// relative to this thread's first key of the tile, k0 + 2t.
struct RangeMask {
  int lo[2], hi[2];  // this thread's rows
  int wlo, whi;      // keys every row of this warp sees: [wlo, whi)
  int t2;            // 2t
  struct Tile {
    int lo[2], hi[2];
  };
  __device__ __forceinline__ void init(const Args& a, int pref, int q0warp,
                                       const int (&row)[2]) {
    auto lo_of = [&](int q) {
      return a.causal && a.window ? q - a.window + 1 : 0;
    };
    auto hi_of = [&](int q) {
      if (q >= a.Sq) return 0;
      return a.causal ? min(a.Sk, max(pref, q + 1)) : a.Sk;
    };
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lo[i] = lo_of(row[i]);
      hi[i] = hi_of(row[i]);
    }
    // lo grows and hi never falls with the row: the warp's last row
    // bounds lo, its first bounds hi; a warp reaching past Sq sees none
    wlo = lo_of(q0warp + 15);
    whi = q0warp + 16 > a.Sq ? 0 : hi_of(q0warp);
    t2 = 2 * (threadIdx.x & 3);
  }
  __device__ __forceinline__ bool whole(const ac::Meta& mt) const {
    return mt.k0 >= wlo && mt.k0 + kTcBK <= whi;
  }
  __device__ __forceinline__ Tile tile(const ac::Meta& mt) const {
    const int k0 = mt.k0 + t2;
    return {{lo[0] - k0, lo[1] - k0}, {hi[0] - k0, hi[1] - k0}};
  }
  __device__ __forceinline__ bool allowed(const Tile& tv, int i,
                                          int c) const {
    return (c >= tv.lo[i]) & (c < tv.hi[i]);
  }
};

// The item counters (next item, blocks done) of the persistent forwards:
// K1's, and K1p's.
__device__ unsigned int g_fwd_work[2];
__device__ unsigned int g_packed_work[2];

template <int NH>
__device__ __forceinline__ unsigned int* fwd_work() {
  return NH == 1 ? g_fwd_work : g_packed_work;
}

// A forward work item: batch element, first head, heads that exist (2,
// or 1 in an odd H's last pack), the KV head, first q row.
struct FwdItem {
  int b, h0, nh, kh, q0;
};

template <int NH>
__host__ __device__ __forceinline__ int fwd_items(const Args& a) {
  return (a.Sq + fwd_rows<NH>() - 1) / fwd_rows<NH>() * a.B *
         ((a.H + NH - 1) / NH);
}

// Item w, in the order blocks take them: K1 (batch element, KV head, q
// tile from the last, query head of the group); K1p (batch element, pack,
// q tile from the last).
template <int NH>
__device__ __forceinline__ FwdItem fwd_item(const Args& a, int w) {
  constexpr int R = fwd_rows<NH>();
  const int n_qt = (a.Sq + R - 1) / R;
  FwdItem it;
  if constexpr (NH == 1) {
    const int groups = a.H / a.Hkv;
    const int r = w / groups, bk = r / n_qt;
    it.q0 = (n_qt - 1 - r % n_qt) * R;
    it.b = bk / a.Hkv;
    it.kh = bk % a.Hkv;
    it.h0 = it.kh * groups + w % groups;
    it.nh = 1;
  } else {
    const int packs = (a.H + 1) / 2;
    const int bp = w / n_qt;
    it.q0 = (n_qt - 1 - w % n_qt) * R;
    it.b = bp / packs;
    it.h0 = (bp % packs) * 2;
    it.nh = min(2, a.H - it.h0);
    it.kh = it.h0;  // MHA
  }
  return it;
}

template <int D, int NH>
__device__ __forceinline__ void fwd_wgmma_body(const Args& a,
                                               const CUtensorMap& qm,
                                               const CUtensorMap& km,
                                               const CUtensorMap& vm,
                                               const CUtensorMap& om) {
  using T = FwdTc<D, NH>;
  using L = typename T::L;
  constexpr int QS = T::kQSlots;
  constexpr int kCols = D / 64;  // column blocks of one head
  const uint32_t base = ac::smem_base();
  // Q slot s: filled on q_full(s), released on q_empty(s) by every
  // consumer thread; consumer j's tile at q_tile(s, j)
  auto q_full = [&](int s) { return base + L::extra + 8 * s; };
  auto q_empty = [&](int s) { return base + L::extra + 16 + 8 * s; };
  auto q_tile = [&](int s, int j) {
    return base + L::q + s * T::kSlot + j * (T::kSlot / 2);
  };
  auto item_of = [&](int s) {
    return reinterpret_cast<volatile int*>(
        ac::smem_ptr(base + L::extra + 32 + 4 * s));
  };
  if (threadIdx.x == 0) {  // fenced and synced by init_barriers
    for (int s = 0; s < QS; ++s) {
      ac::mbar_init(q_full(s), 1);
      ac::mbar_init(q_empty(s), 128 * ac::kConsumers);
    }
  }
  ac::init_barriers<L>(base, 1);
  const int wg = threadIdx.x / 128;
  const int items = fwd_items<NH>(a);
  unsigned int* work = fwd_work<NH>();
  ac::Ring ring;
  if (wg == 0) {
    ac::setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    for (int n = 0;; ++n) {
      const int w = atomicAdd(&work[0], 1u);
      const int s = n % QS;
      if (n >= QS) ac::mbar_wait(q_empty(s), (n / QS - 1) & 1);
      *item_of(s) = w;
      if (w >= items) {  // no work left: the consumers see w and stop
        ac::mbar_arrive(q_full(s));
        break;
      }
      const FwdItem it = fwd_item<NH>(a, w);
      // Q boxes: K1 both consumers' 64 rows in kCols column blocks; K1p
      // 64 rows of each head that exists
      const int nq = NH == 1 ? ac::kConsumers * kCols : it.nh;
      ac::mbar_arrive_tx(q_full(s), nq * ac::kRows * 128);
      for (int x = 0; x < nq; ++x) {
        const int j = NH == 1 ? x / kCols : x, c = NH == 1 ? x % kCols : 0;
        ac::tma_load_4d(q_tile(s, j) + c * ac::kRows * 128, &qm, q_full(s),
                        c * 64, it.h0 + (NH == 1 ? 0 : j),
                        it.q0 + (NH == 1 ? j * ac::kRows : 0), it.b);
      }
      // K/V boxes a stage: K1 its KV head's column blocks; K1p the heads
      const int nkv = NH == 1 ? kCols : it.nh;
      int kt0, kt1;
      key_tiles(a, prefix_of(a, it.b), it.q0, fwd_rows<NH>(), kTcBK, &kt0,
                &kt1);
      for (int kt = kt0; kt < kt1; ++kt) {
        ac::wait_empty<L>(base, ring);
        ac::write_meta<L>(base, ring.stage, kt * kTcBK, ~0ull);
        const uint32_t full = base + L::full + 8 * ring.stage;
        ac::mbar_arrive_tx(full, nkv * 2 * kTcBK * 128);
        for (int x = 0; x < nkv; ++x) {
          const uint32_t off = x * kTcBK * 128;
          const int col = NH == 1 ? x * 64 : 0;
          const int head = NH == 1 ? it.kh : it.h0 + x;
          ac::tma_load_4d(L::k_tile(base, ring.stage) + off, &km, full, col,
                          head, kt * kTcBK, it.b);
          ac::tma_load_4d(L::v_tile(base, ring.stage) + off, &vm, full, col,
                          head, kt * kTcBK, it.b);
        }
        ring.advance();
      }
      ac::wait_empty<L>(base, ring);
      ac::write_meta<L>(base, ring.stage, -1, 0);
      ac::mbar_arrive(base + L::full + 8 * ring.stage);
      ring.advance();
    }
    // the last block out resets the counter for the next launch
    if (atomicAdd(&work[1], 1u) == gridDim.x - 1) {
      work[0] = 0;
      work[1] = 0;
    }
    return;
  }
  ac::setmaxnreg_inc<232>();
  const int j = wg - 1;  // this consumer's rows (K1) or head (K1p)
  const int ct = threadIdx.x - 128 * wg;
  const int warp = ct / 32, lane = ct % 32, g = lane >> 2, t = lane & 3;
  const size_t qs = (size_t)a.H * D;
  for (int n = 0;; ++n) {
    const int s = n % QS;
    ac::mbar_wait(q_full(s), (n / QS) & 1);
    const int w = *item_of(s);
    if (w >= items) break;
    const FwdItem it = fwd_item<NH>(a, w);
    if (NH == 2 && j >= it.nh) {
      // a ragged pack's absent head: take and release the item's stages,
      // up to and with its end Meta, and its Q slot
      for (;;) {
        ac::mbar_wait(base + L::full + 8 * ring.stage, ring.phase);
        const bool end = reinterpret_cast<const ac::Meta*>(
                             ac::smem_ptr(base + L::meta + 16 * ring.stage))
                             ->k0 < 0;
        ac::mbar_arrive(base + L::empty + 8 * ring.stage);
        ring.advance();
        if (end) break;
      }
      ac::mbar_arrive(q_empty(s));
      continue;
    }
    const int h = it.h0 + (NH == 1 ? 0 : j);
    const int r0 = NH == 1 ? j * ac::kRows : 0;  // first row in the item
    const int q0warp = it.q0 + r0 + warp * 16;
    const int row[2] = {q0warp + g, q0warp + g + 8};
    RangeMask pol;
    pol.init(a, prefix_of(a, it.b), q0warp, row);
    ac::State<D> st;
    // The output leaves through the last tile's stage: its K tile (K1:
    // 128 rows of D; K1p: column block j, 64 rows of head h) takes this
    // consumer's rows, rounded to bf16 in the swizzled layout, and one
    // thread stores them by TMA (rows past Sq clipped by the map); the
    // stage is released once the store has read it. Stored row by row
    // from registers, 4 bytes a thread, the output took a quarter of the
    // kernel's time (PERF.md). K1's consumers both read every column
    // block of K, so they meet first; a K1p consumer reads only its own.
    bool staged = false;
    auto stage_out = [&](int stg) {
      if (NH == 1) ac::named_sync(3, 128 * ac::kConsumers);
      const uint32_t o_tile =
          L::k_tile(base, stg) + (NH == 1 ? 0u : j * kTcBK * 128);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + warp * 16 + g + 8 * i;
        const float inv = 1.f / (st.l[i] == 0.f ? 1.f : st.l[i]);
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
          *reinterpret_cast<uint32_t*>(
              ac::smem_ptr(o_tile + ac::swz<kTcBK>(r, nt) + 4 * t)) =
              ac::pack_bf16(st.o[nt * 4 + 2 * i] * inv,
                            st.o[nt * 4 + 2 * i + 1] * inv);
      }
      ac::fence_proxy_async();  // the generic stores, read by the TMA
      ac::named_sync(1 + j, 128);
      if (ct == 0) {
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          ac::tma_store_4d(&om, o_tile + c * kTcBK * 128 + r0 * 128, c * 64,
                           h, it.q0 + r0, it.b);
        ac::tma_store_wait_read();
      }
      ac::named_sync(1 + j, 128);  // the stage is read: consume() frees it
      staged = true;
    };
    ac::consume<D, L>(base, q_tile(s, j), pol, a.scale * ac::kLog2e, st,
                      NH == 1 ? 0u : j * kTcBK * 128, ring,
                      [&] { ac::mbar_arrive(q_empty(s)); }, stage_out);
    // the end Meta's stage, released
    ac::mbar_arrive(base + L::empty + 8 * ring.stage);
    ring.advance();
    bf16* og = static_cast<bf16*>(const_cast<void*>(a.out)) +
               ((size_t)it.b * a.Sq * a.H + h) * D;
    float* lg =
        const_cast<float*>(a.lse) + ((size_t)it.b * a.H + h) * a.Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= a.Sq) continue;
      // a walk without a tile (no key to see: exact zeros) held no stage
      if (!staged) ac::store_row<D>(st, i, og + (size_t)row[i] * qs);
      // l == 0 -> 1: a row that saw no key is exactly 0
      if (t == 0)
        lg[row[i]] = st.m[i] * a.scale + logf(st.l[i] == 0.f ? 1.f : st.l[i]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(ac::block_threads(1), 1)
    flash_fwd_wgmma_kernel(const Args a,
                           const __grid_constant__ CUtensorMap qm,
                           const __grid_constant__ CUtensorMap km,
                           const __grid_constant__ CUtensorMap vm,
                           const __grid_constant__ CUtensorMap om) {
  fwd_wgmma_body<D, 1>(a, qm, km, vm, om);
}

__global__ void __launch_bounds__(ac::block_threads(1), 1)
    flash_fwd_packed_wgmma_kernel(const Args a,
                                  const __grid_constant__ CUtensorMap qm,
                                  const __grid_constant__ CUtensorMap km,
                                  const __grid_constant__ CUtensorMap vm,
                                  const __grid_constant__ CUtensorMap om) {
  fwd_wgmma_body<kPackD, 2>(a, qm, km, vm, om);
}

// ---------------------------------------------------------------------------
// the bf16 backward on the tensor cores: one head a block, or two packed
// heads of 64
// ---------------------------------------------------------------------------
//
// flash_bwd_dkv_wgmma_kernel and flash_bwd_dq_wgmma_kernel replace
// _bwd_dkv_kernel (pallas_attention.py l.423; pallas_call l.859) and
// _bwd_dq_kernel (l.369; pallas_call l.823) for bf16, D 64 or 128, GQA, as
// _pallas_backward (l.615) drives them; their packed twins
// flash_bwd_dkv_packed_wgmma_kernel and flash_bwd_dq_packed_wgmma_kernel
// replace _bwd_dkv_kernel_packed (l.546; pallas_call l.799) and
// _bwd_dq_kernel_packed (l.484; pallas_call l.764) for bf16, two MHA heads
// of 64 a block. All four are one pair of bodies with the heads a block
// (NH = 1 or 2) as a template parameter. What bounds them: operations.
// The backward's least work is five products, 10·D FLOP a visible (query,
// key) pair. It stays two kernels so that neither needs atomics: the GQA
// group sum of dk and dv is a sum in registers in a fixed order, and a
// call repeats bit for bit. So both recompute S = Q.K^T and dP = dO.V^T:
// 14·D FLOP a pair executed. At llama-1.4b's shape (B 8, S 1024, H 16, D
// 128, causal) that is 1.2e11 FLOP, 0.12 ms at the bf16 peak, against 134
// MB read and written once (0.04 ms). Every product therefore runs on
// wgmma, built from attn_fwd_core.cuh's primitives: a producer warpgroup
// keeps a ring of 3 stages filled by TMA behind full/empty mbarriers and
// gives its registers to two consumer warpgroups of 64 rows (setmaxnreg:
// 24 and 240 a thread); tiles are stored in the 128-byte swizzle; the
// products that consume P or dS take it in registers as the A operand
// (the score accumulator's layout is the A fragment's) with the other
// operand MN-major (wgmma_pv), so P and dS never pass through shared
// memory. The arithmetic is _p_and_ds (l.183): p = exp(s - lse)
// recomputed from the forward's lse, as 2^(q.k * scale * log2(e) - lse *
// log2(e)) in one FMA; a masked element is exactly 0; ds = p (dp - delta)
// scale, computed as p (dp scale - delta scale); p and ds rounded to bf16
// for the products that take them; sums in f32, rounded once when stored.
//
// What sets the pace (clock64 counters per phase, in scratch copies): the
// wgmmas of the two consumer warpgroups and their elementwise work. Both
// warpgroups take every stage, so left alone they run in step, issue their
// wgmmas together and then leave the tensor cores idle through their
// elementwise work together. PingPong hands the tensor cores from one to
// the other, so one's elementwise work runs under the other's products.
// The elementwise work (per element an FMA, an exponential, a range test
// against constants, an FMA and a multiply) is kept short: it is on the
// critical path.
//
// Work items. A dkv item is 128 keys of one KV head (64 a consumer
// warpgroup), or 64 keys of a pack's two heads (consumer j: head 2p + j);
// a dq item 128 q rows of one query head (64 a consumer), or 64 q rows of
// a pack's two heads. At D 128 a block takes one item. At D 64 a block is
// persistent (one an SM): its producer takes items from a counter in
// device memory (the packed forward's scheme), and since a consumer holds
// its item's K and V (dkv) or Q and dO (dq) in registers once it has read
// them, the next item's land, and its first stages stream, while this
// item's walk and stores run: at gpt2-1.5b's shape the blocks had spent
// ~7k of their ~25k cycles outside the walk. Items go in the order of
// one block an item: dkv's key tiles from the first (under causal key
// tile 0 is seen by every q tile), dq's q tiles from the last.
//
// dkv: an item's K and V are loaded once by TMA. The producer streams, for
// each query head of the group and each q tile of 64 rows that can see the
// item's keys (q_tiles), the Q and dO tiles (TMA, one thread) with their
// lse and delta rows (4-byte cp.async by a second warp: a [B, H, Sq] f32
// row is not a multiple of the 16 bytes a tensor map's strides need at
// every Sq). A consumer computes S^T = K.Q^T and dP^T = V.dO^T (keys as
// the M rows; K and V from shared memory at D 128, as register A operands
// at D 64), P^T and dS^T in registers, then dV += P^T.dO and dK += dS^T.Q.
// Its mask is a range of queries a key (q_range: RangeMask turned round).
//
// dq: an item's Q and dO are loaded once by TMA; the producer thread
// streams K and V tiles of kDqKeys keys over key_tiles' range, as the
// forward's does. A consumer keeps the lse and delta of its rows, and its
// Q and dO as A fragments, in registers, computes S = Q.K^T and dP =
// dO.V^T (register A, K and V K-major from the stage: only B is read from
// shared memory, whose bandwidth the shared-A form of these m64n64
// products saturates), dS in registers, and dQ += dS.K with the stage's K
// as the MN-major operand. Its mask is the packed forward's RangeMask.
//
// Packed (NH = 2, MHA, D 64): a ring stage holds both heads' tiles, two
// [rows, 64] TMA boxes from the D 64 tensor maps laid out as one D 128
// stage (column block j: head 2p + j), as flash_fwd_packed_wgmma_kernel
// lays out its K/V; consumer j reads column block j. The row tiles of 64
// (dq's q rows, dkv's keys) leave no stage that one consumer's rows cannot
// see under causal, where one head's 128 rows leave one in each item.
// The mask (a key range a row, a query range a key) depends only on the
// rows, so it is the same for both heads. With an odd H the last pack has
// one head: its producer loads only that head's boxes (half the expected
// bytes) and the second consumer still takes and releases every stage, on
// shared memory nothing filled, and writes nothing, so every barrier
// counts both consumers' arrivals. The two consumers of a packed block
// share no tile, so a stage holds twice a one-head stage's bytes: the
// packed rings run 4 stages. At D 64 dK and dV take half the accumulators
// they take at D 128, so a dkv consumer keeps its K and V as register A
// operands, as dq keeps Q and dO.
//
// Every consumer thread takes and releases every stage, whatever its rows
// see of it (a stage that none of a warpgroup's rows sees adds exactly 0),
// so the barrier counts never drift. Rows past Sq and keys past Sk come in
// from TMA as zeros and are masked; stores stop at Sq and Sk.

constexpr int kDkvBQ = 64;   // q rows a dkv stage
constexpr int kDqKeys = 64;  // keys a dq stage

// rows a block owns (dq: q rows; dkv: keys): 64 a consumer of one head,
// or 64 of both packed heads
template <int NH>
__host__ __device__ constexpr int bwd_rows() {
  return ac::kRows * ac::kConsumers / NH;
}

// The backward's rings: a packed stage holds both heads' tiles (32 KB),
// twice a one-head stage at D 64, and takes longer to land, so a packed
// ring runs a stage deeper (dq at gpt2-1.5b's shape: 0.1239 ms at 3
// stages, 0.1195 at 4; dkv alike at both).
template <int NH>
__host__ __device__ constexpr int bwd_stages() {
  return NH == 2 ? 4 : ac::kStages;
}

// dkv's shared memory, for KEYS keys a block and stages W = NH * D wide:
// K and V of the block's keys ([KEYS][64] column blocks), the ring's NS
// stages (Q and dO tiles of kDkvBQ rows), each stage's lse and delta rows
// of each head (f32), the barriers, the item's number.
template <int W, int KEYS, int NH, int NS>
struct DkvLayout {
  static constexpr int kRingStages = NS;
  static constexpr int kRowTile = (W / 64) * kDkvBQ * 128;
  static constexpr int kKvTile = (W / 64) * KEYS * 128;
  static constexpr int kRowBytes = NH * 2 * kDkvBQ * 4;
  static constexpr int k = 0;
  static constexpr int v = kKvTile;
  static constexpr int stages = 2 * kKvTile;
  static constexpr int rows = stages + NS * 2 * kRowTile;
  static constexpr int full = rows + NS * kRowBytes;
  static constexpr int empty = full + 8 * NS;
  static constexpr int kv_full = empty + 8 * NS;
  static constexpr int kv_empty = kv_full + 8;
  static constexpr int slot = kv_empty + 8;  // the item number
  static constexpr int bytes = slot + 8;
  static constexpr int alloc = bytes + 1024;  // alignment slack
  static __device__ __forceinline__ uint32_t q_tile(uint32_t base, int s) {
    return base + stages + s * 2 * kRowTile;
  }
  static __device__ __forceinline__ uint32_t do_tile(uint32_t base, int s) {
    return q_tile(base, s) + kRowTile;
  }
  // head i's lse[kDkvBQ], then its delta[kDkvBQ]
  static __device__ __forceinline__ uint32_t rows_of(uint32_t base, int s,
                                                     int i) {
    return base + rows + s * kRowBytes + i * 2 * kDkvBQ * 4;
  }
};

// dq's: the core's layout for stages NH * D wide (the K/V ring; the Q
// tiles, a consumer's of (D / 64) * 8 KB at the front of its region) with
// the dO tiles, the Q/dO barriers and the item's number as its extra
// bytes.
template <int D, int NH>
using DqLayout =
    ac::Layout<NH * D, kDqKeys, 2 * (D / 64) * ac::kRows * 128 + 24,
               bwd_stages<NH>()>;

// D[64 x N] = A.B^T over D: A this warpgroup's 64 rows of a swizzled tile
// whose column blocks are A_ROWS rows, B a swizzled tile of N rows, both
// K-major (D contiguous).
template <int D, int N, int A_ROWS>
__device__ __forceinline__ void issue_kmajor(float (&d)[N / 2], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ac::wgmma_s<N>(
        d, ac::desc_kmajor(a + (ks >> 2) * A_ROWS * 128 + (ks & 3) * 32),
        ac::desc_kmajor(b + (ks >> 2) * N * 128 + (ks & 3) * 32), ks > 0);
}

// D[64 x D] += A.B over K: A in registers (K / 16 k-steps), B a swizzled
// tile of K rows, MN-major (D contiguous).
template <int D, int K>
__device__ __forceinline__ void issue_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[K / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int j = 0; j < K / 16; ++j)
    ac::wgmma_pv<D>(d, a[j], ac::desc_mnmajor<K>(b + j * 16 * 128));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A in registers, B K-major in
// shared memory (wgmma's register-A form with B not transposed).
__device__ __forceinline__ void wgmma_rs_kmajor_m64n64(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// This thread's A fragments of a warpgroup's 64-row swizzled tile of D
// columns, for products over D: k-step ks, register i holds row
// 16 warp + g + 8 (i & 1), columns 16 ks + 8 (i >> 1) + 2t and + 1.
template <int D>
__device__ __forceinline__ void load_a(uint32_t tile, int warp, int lane,
                                       uint32_t (&a)[D / 16][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 16 + g + 8 * (i & 1);
      const int c = ks * 16 + 8 * (i >> 1) + 2 * t;
      a[ks][i] = *reinterpret_cast<const uint32_t*>(
          ac::smem_ptr(tile + ac::swz<ac::kRows>(r, c >> 3) + (c & 7) * 2));
    }
}

// An m64nN accumulator rounded to bf16 as the A fragments of the next
// product: n-tile nt = i / 4 is half (nt & 1) of k-step nt / 2.
template <int NS>
__device__ __forceinline__ void to_a(const float (&s)[NS],
                                     uint32_t (&a)[NS / 8][4]) {
#pragma unroll
  for (int i = 0; i < NS; i += 2) {
    const int nt = i >> 2;
    a[nt >> 1][(nt & 1) * 2 + ((i >> 1) & 1)] = ac::pack_bf16(s[i], s[i + 1]);
  }
}

// The two consumer warpgroups take turns at issuing their wgmmas (FA3's
// ping-pong): warpgroup j waits on named barrier 1 + j before a burst and
// arrives on the other's after it, so one warpgroup's elementwise work
// runs under the other's products. Both give the same number of bursts;
// warpgroup 1 arrives once before the first (warpgroup 0 goes first) and
// not after its last, so no arrival is left over.
struct PingPong {
  int j;  // this consumer warpgroup, 0 or 1
  __device__ __forceinline__ void start() const {
    if (j == 1) arrive(1);
  }
  __device__ __forceinline__ void turn() const {
    ac::named_sync(1 + j, 128 * ac::kConsumers);
  }
  __device__ __forceinline__ void pass(bool last) const {
    if (!(last && j == 1)) arrive(2 - j);
  }
  static __device__ __forceinline__ void arrive(int id) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(128 * ac::kConsumers)
                 : "memory");
  }
};

// The queries [lo, hi) that key k sees, RangeMask's rule turned round:
// causal, [k, k + window) ([k, Sq) without a window); a key inside the
// prefix, or any key without causal, is seen by every query; cut to
// [0, Sq), and empty for keys past Sk. (ops/flash_attention.py's
// dkv_q_range is its plain twin.)
__device__ __forceinline__ void q_range(const Args& a, int pref, int k,
                                        int& lo, int& hi) {
  lo = 0;
  hi = k < a.Sk ? a.Sq : 0;
  if (a.causal && k >= pref) {
    lo = k;
    if (a.window) hi = min(hi, k + a.window);
  }
}

// The q tiles [begin, end) of kDkvBQ rows that may see a key of
// [k0, k0 + keys): under causal from the diagonal on, up to the last
// key's window; every tile when the block reaches into the prefix.
__device__ __forceinline__ void q_tiles(const Args& a, int pref, int k0,
                                        int keys, int& begin, int& end) {
  const int n = (a.Sq + kDkvBQ - 1) / kDkvBQ;
  begin = 0;
  end = n;
  if (a.causal && k0 >= pref) {
    begin = min(k0 / kDkvBQ, n);
    if (a.window)
      end = min(n, (k0 + keys - 1 + a.window - 1) / kDkvBQ + 1);
  }
}

// The TMA box of column block c of a stage NH * D wide: one head's column
// block c (NH 1: columns 64 c of head h), or head h + c of a pack (D 64).
template <int NH>
__device__ __forceinline__ void stage_box(int h, int c, int& col, int& head) {
  col = NH == 1 ? 64 * c : 0;
  head = NH == 1 ? h : h + c;
}

// lse and delta of rows [q0, q0 + kDkvBQ) of the [B, H, Sq] row that
// starts at row0, into a stage's rows (lse, then delta), by one warp in
// 4-byte copies (16-byte copies, where Sq keeps the rows aligned, ran the
// D 128 dkv 12% slower and the D 64 kernels 1% faster); rows past Sq are
// zeros and never read.
__device__ __forceinline__ void copy_rows(const Args& a, size_t row0, int q0,
                                          int lane, unsigned char* rows) {
#pragma unroll
  for (int r = lane; r < kDkvBQ; r += 32) {
    const bool in = q0 + r < a.Sq;
    const size_t at = in ? row0 + q0 + r : 0;
    cp_async(rows + 4 * r, a.lse + at, 4, in);
    cp_async(rows + 4 * (kDkvBQ + r), a.delta + at, 4, in);
  }
}

// The backward's work items: (batch element, head or pack, tile of the
// block's rows), the tiles fastest, in the order blocks take them: dkv's
// key tiles from the first, dq's q tiles from the last (under causal the
// tiles that do the most work first, and the blocks at work at once read
// few heads' tiles, which stay in L2). r0: the tile's first key (dkv) or
// q row (dq); nh: the heads that exist (an odd H's last pack: 1).
struct BwdItem {
  int b, h0, nh, r0;
};

template <int NH, bool DKV>
__device__ __forceinline__ int bwd_tiles(const Args& a) {
  return ((DKV ? a.Sk : a.Sq) + bwd_rows<NH>() - 1) / bwd_rows<NH>();
}

template <int NH, bool DKV>
__device__ __forceinline__ int bwd_items(const Args& a) {
  const int heads = DKV ? a.Hkv : a.H;
  return bwd_tiles<NH, DKV>(a) * a.B * ((heads + NH - 1) / NH);
}

template <int NH, bool DKV>
__device__ __forceinline__ BwdItem bwd_item(const Args& a, int w) {
  const int heads = DKV ? a.Hkv : a.H;
  const int n_t = bwd_tiles<NH, DKV>(a);
  const int per_b = (heads + NH - 1) / NH;
  const int bp = w / n_t, tile = w % n_t;
  BwdItem it;
  it.b = bp / per_b;
  it.h0 = (bp % per_b) * NH;
  it.nh = NH == 1 ? 1 : min(NH, heads - it.h0);
  it.r0 = (DKV ? tile : n_t - 1 - tile) * bwd_rows<NH>();
  return it;
}

// The item counters (next item, blocks done) of the persistent backward
// kernels, by [dkv][NH - 1]. The last block out resets its pair, so a
// kernel's launches must follow each other on one stream.
__device__ unsigned int g_bwd_work[2][2][2];

// At D 64 a backward kernel is persistent (one block an SM, never more than
// there are items; the producer takes items from g_bwd_work): a consumer
// holds its item's K and V (dkv) or Q and dO (dq) in registers, so the
// next item's land, and its first stages stream, while this item's walk
// and stores run. At D 128 a block takes one item (its own index).
template <int D>
__host__ __device__ constexpr bool bwd_persistent() {
  return D == 64;
}

// The item number the producer takes for its n-th item: >= items ends.
template <int D>
__device__ __forceinline__ int take_item(unsigned int* work, int n,
                                         int items) {
  if constexpr (bwd_persistent<D>())
    return static_cast<int>(atomicAdd(&work[0], 1u));
  else
    return n == 0 ? static_cast<int>(blockIdx.x) : items;
}

// The producer thread, once its last item is taken: the last block out
// resets the counter for the next launch.
template <int D>
__device__ __forceinline__ void finish_items(unsigned int* work) {
  if constexpr (bwd_persistent<D>()) {
    if (atomicAdd(&work[1], 1u) == gridDim.x - 1) {
      work[0] = 0;
      work[1] = 0;
    }
  }
}

template <int D, int NH>
__device__ __forceinline__ void dkv_wgmma_body(const Args& a,
                                               const CUtensorMap& qm,
                                               const CUtensorMap& om,
                                               const CUtensorMap& km,
                                               const CUtensorMap& vm) {
  constexpr int KEYS = bwd_rows<NH>();
  using L = DkvLayout<NH * D, KEYS, NH, bwd_stages<NH>()>;
  const uint32_t base = ac::smem_base();
  // an item's K and V (and its number in the slot) landed; the consumers
  // are done with them
  const uint32_t kv_full = base + L::kv_full;
  const uint32_t kv_empty = base + L::kv_empty;
  volatile int* slot =
      reinterpret_cast<volatile int*>(ac::smem_ptr(base + L::slot));
  if (threadIdx.x == 0) {  // synced below
    ac::mbar_init(kv_full, 1);
    ac::mbar_init(kv_empty, 128 * ac::kConsumers);
  }
  // full: the TMA thread's expect_tx and the rows warp's 32 cp.async
  // arrivals
  ac::init_barriers<L>(base, 1 + 32);
  const int wg = threadIdx.x / 128;
  const int items = bwd_items<NH, true>(a);
  const int groups = NH == 1 ? a.H / a.Hkv : 1;
  // registers: 128 * P + 256 * C = 384 * 168, the block's pool. At D 64
  // the consumers need fewer (their K and V fragments included), and the
  // producer, which copies a pack's two heads of lse and delta rows a
  // stage, ran out of 24 (spilled, and took 2.7x the cycles a stage of
  // one head's producer) and so starved the consumers.
  constexpr int kProducerRegs = D == 64 ? 40 : 24;
  constexpr int kConsumerRegs = D == 64 ? 232 : 240;
  // The producer is two warps: warp 0's lane 0 takes the items and issues
  // the TMA copies, warp 1 copies the lse and delta rows, each stage on
  // both once it is empty (on one warp the two took twice the cycles of a
  // packed stage).
  if (wg == 0) {
    ac::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 64) return;
    const bool rows_warp = threadIdx.x >= 32;
    const int lane = threadIdx.x % 32;
    unsigned int* work = g_bwd_work[1][NH - 1];
    int col, head;
    ac::RingN<L::kRingStages> ring;
    for (int n = 0;; ++n) {
      // the next item, published once the consumers are done with the
      // last one's K and V, and once warp 1 has read the last one's number
      ac::named_sync(3, 64);
      if (threadIdx.x == 0) {
        const int w = take_item<D>(work, n, items);
        if (n > 0) ac::mbar_wait(kv_empty, (n - 1) & 1);
        *slot = w;
      }
      ac::named_sync(3, 64);
      const int w = *slot;
      if (w >= items) {  // no work left: the consumers see w and stop
        if (threadIdx.x == 0) {
          ac::mbar_arrive(kv_full);
          finish_items<D>(work);
        }
        break;
      }
      const BwdItem it = bwd_item<NH, true>(a, w);
      // column blocks of a tile: D / 64 of one head, or a pack's heads
      const int n_cb = NH == 1 ? D / 64 : it.nh;
      if (threadIdx.x == 0) {
        ac::mbar_arrive_tx(kv_full, 2 * n_cb * KEYS * 128);
        for (int c = 0; c < n_cb; ++c) {
          const uint32_t off = c * KEYS * 128;
          stage_box<NH>(it.h0, c, col, head);
          ac::tma_load_4d(base + L::k + off, &km, kv_full, col, head, it.r0,
                          it.b);
          ac::tma_load_4d(base + L::v + off, &vm, kv_full, col, head, it.r0,
                          it.b);
        }
      }
      int qt0, qt1;
      q_tiles(a, prefix_of(a, it.b), it.r0, KEYS, qt0, qt1);
      // NH 2: one pass, h the pack's first head
      for (int h = it.h0 * groups; h < (it.h0 + 1) * groups; ++h) {
        for (int q0 = qt0 * kDkvBQ; q0 < qt1 * kDkvBQ; q0 += kDkvBQ) {
          ac::wait_empty<L>(base, ring);
          const uint32_t full = base + L::full + 8 * ring.stage;
          if (!rows_warp) {
            if (lane == 0) {
              ac::mbar_arrive_tx(full, 2 * n_cb * kDkvBQ * 128);
              for (int c = 0; c < n_cb; ++c) {
                const uint32_t off = c * kDkvBQ * 128;
                stage_box<NH>(h, c, col, head);
                ac::tma_load_4d(L::q_tile(base, ring.stage) + off, &qm, full,
                                col, head, q0, it.b);
                ac::tma_load_4d(L::do_tile(base, ring.stage) + off, &om,
                                full, col, head, q0, it.b);
              }
            }
          } else {
#pragma unroll
            for (int i = 0; i < NH; ++i) {
              if (i >= n_cb) break;  // NH 1 has one head, whatever n_cb is
              copy_rows(a, ((size_t)it.b * a.H + h + i) * a.Sq, q0, lane,
                        ac::smem_ptr(L::rows_of(base, ring.stage, i)));
            }
            ac::cp_async_arrive(full);
          }
          ring.advance();
        }
      }
    }
    return;
  }
  ac::setmaxnreg_inc<kConsumerRegs>();
  const int j = wg - 1;  // this consumer's keys (NH 1) or head (NH 2)
  const int ct = threadIdx.x - 128 * wg;
  const int warp = ct / 32, lane = ct % 32, g = lane >> 2, t = lane & 3;
  // this consumer's 64 keys of K and V: rows 64 j of one head's tiles, or
  // column block j of a pack's (both j * 8 KB on)
  const uint32_t k_tile = base + L::k + j * ac::kRows * 128;
  const uint32_t v_tile = base + L::v + j * ac::kRows * 128;
  // its column block of a stage's Q and dO tiles, and its lse/delta rows
  const uint32_t q_off = NH == 1 ? 0 : j * kDkvBQ * 128;
  const int row_head = NH == 1 ? 0 : j;
  const float scale = a.scale, scale_log2 = scale * ac::kLog2e;
  float dk[D / 2], dv[D / 2];
  float st[kDkvBQ / 2], dpt[kDkvBQ / 2];             // S^T, dP^T
  uint32_t pa[kDkvBQ / 16][4], da[kDkvBQ / 16][4];  // P^T, dS^T in bf16
  // At D 64, this consumer's K and V as register A operands (32
  // registers, which the D 64 accumulators leave free): S^T and dP^T then
  // read only Q and dO from shared memory, whose bandwidth the shared-A
  // form of these m64n64 products saturates (dq's reason). At D 128 they
  // would take 64 and leave too few.
  constexpr bool kRegKv = D == 64;
  static_assert(!bwd_persistent<D>() || kRegKv,
                "a persistent dkv needs K and V in registers");
  uint32_t ka[kRegKv ? D / 16 : 1][4], va[kRegKv ? D / 16 : 1][4];
  // the item's: the queries [lo, hi) each of this thread's keys sees, and
  // its q tiles [qt0, qt1) of each query head of the group
  int lo[2] = {0, 0}, hi[2] = {0, 0}, qt0 = 0, qt1 = 0, stages = 0;
  ac::RingN<L::kRingStages> ring;
  const PingPong pp{j};
  // Every wgmma is issued unconditionally between its fence and its wait,
  // with its registers pinned on both sides (fence_regs), or the compiler
  // serializes every wgmma of the kernel.
  auto issue_sdp = [&](int stg) {  // S^T = K Q^T, dP^T = V dO^T
    ac::fence_regs(st);
    ac::fence_regs(dpt);
    const uint32_t qt = L::q_tile(base, stg) + q_off;
    const uint32_t ot = L::do_tile(base, stg) + q_off;
    if constexpr (kRegKv) {
      ac::fence_regs(ka);
      ac::fence_regs(va);
      ac::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks & 3) * 32;
        wgmma_rs_kmajor_m64n64(st, ka[ks], ac::desc_kmajor(qt + off), ks > 0);
        wgmma_rs_kmajor_m64n64(dpt, va[ks], ac::desc_kmajor(ot + off),
                               ks > 0);
      }
    } else {
      ac::wgmma_fence();
      issue_kmajor<D, kDkvBQ, KEYS>(st, k_tile, qt);
      issue_kmajor<D, kDkvBQ, KEYS>(dpt, v_tile, ot);
    }
    ac::wgmma_commit();
  };
  auto wait_sdp = [&]() {
    ac::wgmma_wait<0>();
    ac::fence_regs(st);
    ac::fence_regs(dpt);
  };
  auto issue_dkv = [&](int stg) {  // dV += P^T dO, dK += dS^T Q
    ac::fence_regs(dv);
    ac::fence_regs(dk);
    ac::fence_regs(pa);
    ac::fence_regs(da);
    ac::wgmma_fence();
    issue_rs<D, kDkvBQ>(dv, pa, L::do_tile(base, stg) + q_off);
    issue_rs<D, kDkvBQ>(dk, da, L::q_tile(base, stg) + q_off);
    ac::wgmma_commit();
  };
  auto wait_dkv = [&]() {
    ac::wgmma_wait<0>();
    ac::fence_regs(dv);
    ac::fence_regs(dk);
    ac::fence_regs(pa);
    ac::fence_regs(da);
  };
  // the stage of q tile q0, in place: st becomes P^T, dpt dS^T, then both
  // are rounded into the A fragments. Element i: key row r = (i >> 1) & 1
  // of this thread, query q0 + 2t + col, col = (i >> 2) * 8 + (i & 1).
  // The elementwise work sets the pace of a stage, so it is kept short:
  // the key row's query range is taken relative to q0 + 2t, so that each
  // test compares with a constant, on every stage (a branch to skip it on
  // the wholly visible stages doubles the code and ran slower), and the
  // scale is folded into dP - delta.
  auto grads = [&](int q0, int stg) {
    const float* rows = reinterpret_cast<const float*>(
        ac::smem_ptr(L::rows_of(base, stg, row_head)));
    const int lr[2] = {lo[0] - q0 - 2 * t, lo[1] - q0 - 2 * t};
    const int hr[2] = {hi[0] - q0 - 2 * t, hi[1] - q0 - 2 * t};
#pragma unroll
    for (int nt = 0; nt < kDkvBQ / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      const float2 ls = *reinterpret_cast<const float2*>(rows + c);
      const float2 dl = *reinterpret_cast<const float2*>(rows + kDkvBQ + c);
      const float l2[2] = {ls.x * ac::kLog2e, ls.y * ac::kLog2e};
      const float ds[2] = {dl.x * scale, dl.y * scale};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = nt * 4 + e, col = nt * 8 + (e & 1), r = e >> 1;
        const float p = (col >= lr[r]) & (col < hr[r])
                            ? ac::ex2(fmaf(st[i], scale_log2, -l2[e & 1]))
                            : 0.f;
        st[i] = p;
        dpt[i] = p * fmaf(dpt[i], scale, -ds[e & 1]);
      }
    }
    to_a(st, pa);
    to_a(dpt, da);
  };
  auto acquire = [&]() {
    const int stg = ring.stage;
    ac::mbar_wait(base + L::full + 8 * stg, ring.phase);
    ring.advance();
    return stg;
  };
  auto release = [&](int stg) { ac::mbar_arrive(base + L::empty + 8 * stg); };
  // A burst is this stage's dV and dK, then the next stage's S^T and dP^T
  // (one after the other: with the next S^T and dP^T in flight under dV
  // and dK, the D 128 kernel has too few registers and ptxas serializes
  // the wgmmas, C7512, and the D 64 kernels ran no faster); the stage's
  // P^T and dS^T are computed while the other warpgroup's burst runs.
  auto walk = [&]() {
    if (stages == 0) return;
    // the q tile of the stage, which runs over [qt0, qt1) for each query
    // head of the group
    int q0 = qt0 * kDkvBQ;
    auto next_q0 = [&]() {
      q0 += kDkvBQ;
      if (q0 == qt1 * kDkvBQ) q0 = qt0 * kDkvBQ;
    };
    pp.start();
    int cur = acquire();
    pp.turn();
    issue_sdp(cur);
    pp.pass(false);
    wait_sdp();
    grads(q0, cur);
    for (int n = 1; n < stages; ++n) {
      const int nxt = acquire();
      next_q0();
      pp.turn();
      issue_dkv(cur);
      wait_dkv();
      release(cur);
      issue_sdp(nxt);
      pp.pass(false);
      wait_sdp();
      grads(q0, nxt);
      cur = nxt;
    }
    pp.turn();
    issue_dkv(cur);
    pp.pass(true);
    wait_dkv();
    release(cur);
  };
  // this thread's first key of the item's tile
  const int key_off = (NH == 1 ? j * ac::kRows : 0) + warp * 16 + g;
  for (int n = 0;; ++n) {
    ac::mbar_wait(kv_full, n & 1);
    const int w = *slot;
    if (w >= items) break;
    {  // the item's mask and q tiles (only these stay live in the walk)
      const BwdItem it = bwd_item<NH, true>(a, w);
      const int pref = prefix_of(a, it.b);
      q_tiles(a, pref, it.r0, KEYS, qt0, qt1);
      stages = groups * (qt1 - qt0);  // (query head, q tile)
      q_range(a, pref, it.r0 + key_off, lo[0], hi[0]);
      q_range(a, pref, it.r0 + key_off + 8, lo[1], hi[1]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    if constexpr (kRegKv) {
      load_a<D>(k_tile, warp, lane, ka);
      load_a<D>(v_tile, warp, lane, va);
      ac::mbar_arrive(kv_empty);  // the next item's K and V may land
    }
    walk();
    if constexpr (!kRegKv) ac::mbar_arrive(kv_empty);
    const BwdItem it = bwd_item<NH, true>(a, w);
    const int key[2] = {it.r0 + key_off, it.r0 + key_off + 8};
    if (NH == 2 && j >= it.nh) continue;  // an odd H's absent head
    const int out_head = NH == 1 ? it.h0 : it.h0 + j;
    const size_t ks = (size_t)a.Hkv * D;
    const size_t koff = ((size_t)it.b * a.Sk * a.Hkv + out_head) * D;
    bf16* dkg = static_cast<bf16*>(a.dk) + koff;
    bf16* dvg = static_cast<bf16*>(a.dv) + koff;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key[i] >= a.Sk) continue;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const size_t o = (size_t)key[i] * ks + nt * 8 + 2 * t;
        store2(dkg + o, dk[nt * 4 + 2 * i], dk[nt * 4 + 2 * i + 1]);
        store2(dvg + o, dv[nt * 4 + 2 * i], dv[nt * 4 + 2 * i + 1]);
      }
    }
  }
}

template <int D, int NH>
__device__ __forceinline__ void dq_wgmma_body(const Args& a,
                                              const CUtensorMap& qm,
                                              const CUtensorMap& om,
                                              const CUtensorMap& km,
                                              const CUtensorMap& vm) {
  using L = DqLayout<D, NH>;
  constexpr int kQT = (D / 64) * ac::kRows * 128;  // a consumer's Q tile
  const uint32_t base = ac::smem_base();
  const uint32_t do_tiles = base + L::extra;  // consumer j's at + j kQT
  // an item's Q and dO (and its number in the slot) landed; the consumers
  // hold them in registers
  const uint32_t q_full = base + L::extra + 2 * kQT;
  const uint32_t q_empty = q_full + 8;
  volatile int* slot =
      reinterpret_cast<volatile int*>(ac::smem_ptr(q_full + 16));
  if (threadIdx.x == 0) {  // synced below
    ac::mbar_init(q_full, 1);
    ac::mbar_init(q_empty, 128 * ac::kConsumers);
  }
  ac::init_barriers<L>(base, 1);
  const int wg = threadIdx.x / 128;
  const int items = bwd_items<NH, false>(a);
  // consumer j's Q/dO tile: rows 64 j of one head, or a pack's head j
  auto head_of = [](const BwdItem& it, int j) {
    return NH == 1 ? it.h0 : it.h0 + j;
  };
  auto row_of = [](const BwdItem& it, int j) {
    return NH == 1 ? it.r0 + j * ac::kRows : it.r0;
  };
  // registers: 128 * P + 256 * C = 384 * 168, the block's pool; at D 64
  // the consumers' Q and dO fragments take half their D 128 count, and the
  // producer's item loop spilled in 24
  constexpr int kProducerRegs = D == 64 ? 40 : 24;
  constexpr int kConsumerRegs = D == 64 ? 232 : 240;
  if (wg == 0) {
    ac::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    unsigned int* work = g_bwd_work[0][NH - 1];
    int col, head;
    ac::RingN<L::kRingStages> ring;
    for (int n = 0;; ++n) {
      // the next item, published once the consumers hold the last one's
      // Q and dO in registers
      const int w = take_item<D>(work, n, items);
      if (n > 0) ac::mbar_wait(q_empty, (n - 1) & 1);
      *slot = w;
      if (w >= items) {  // no work left: the consumers see w and stop
        ac::mbar_arrive(q_full);
        finish_items<D>(work);
        break;
      }
      const BwdItem it = bwd_item<NH, false>(a, w);
      const int kh = it.h0 / (a.H / a.Hkv);
      // the tiles of both consumers, or of the pack's heads that exist
      const int n_q = NH == 1 ? ac::kConsumers : it.nh;
      ac::mbar_arrive_tx(q_full, 2 * n_q * kQT);
      for (int jj = 0; jj < n_q; ++jj)
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          const uint32_t off = jj * kQT + cb * ac::kRows * 128;
          ac::tma_load_4d(base + L::q + off, &qm, q_full, cb * 64,
                          head_of(it, jj), row_of(it, jj), it.b);
          ac::tma_load_4d(do_tiles + off, &om, q_full, cb * 64,
                          head_of(it, jj), row_of(it, jj), it.b);
        }
      int kt0, kt1;
      key_tiles(a, prefix_of(a, it.b), it.r0, bwd_rows<NH>(), kDqKeys, &kt0,
                &kt1);
      const int n_cb = NH == 1 ? D / 64 : it.nh;
      for (int kt = kt0; kt < kt1; ++kt) {
        ac::wait_empty<L>(base, ring);
        const uint32_t full = base + L::full + 8 * ring.stage;
        ac::mbar_arrive_tx(full, 2 * n_cb * kDqKeys * 128);
        for (int c = 0; c < n_cb; ++c) {
          const uint32_t off = c * kDqKeys * 128;
          stage_box<NH>(kh, c, col, head);
          ac::tma_load_4d(L::k_tile(base, ring.stage) + off, &km, full, col,
                          head, kt * kDqKeys, it.b);
          ac::tma_load_4d(L::v_tile(base, ring.stage) + off, &vm, full, col,
                          head, kt * kDqKeys, it.b);
        }
        ring.advance();
      }
    }
    return;
  }
  ac::setmaxnreg_inc<kConsumerRegs>();
  const int j = wg - 1;  // this consumer's rows (NH 1) or head (NH 2)
  const int ct = threadIdx.x - 128 * wg;
  const int warp = ct / 32, lane = ct % 32, g = lane >> 2, t = lane & 3;
  const uint32_t q_tile = base + L::q + j * kQT;
  const uint32_t o_tile = do_tiles + j * kQT;
  // this consumer's column block of a stage's K and V (a pack's head j)
  const uint32_t kv_off = NH == 1 ? 0 : j * kDqKeys * 128;
  const float scale = a.scale, scale_log2 = scale * ac::kLog2e;
  float dq[D / 2];
  float s[kDqKeys / 2], dp[kDqKeys / 2];
  uint32_t da[kDqKeys / 16][4];  // dS in bf16
  // Q and dO of this warpgroup's rows as register A operands: S and dP
  // then read only K and V from shared memory, whose bandwidth the
  // shared-A form of m64n64 products saturates
  uint32_t qa[D / 16][4], oa[D / 16][4];
  // the item's: each row's keys [lo, hi), lse * log2(e) and delta * scale
  // of this thread's rows (0 past Sq, where every key is masked), its key
  // tiles [kt0, kt1)
  RangeMask pol = {};
  float lse2[2] = {0.f, 0.f}, delta_s[2] = {0.f, 0.f};
  int kt0 = 0, kt1 = 0;
  ac::RingN<L::kRingStages> ring;
  static_assert(kDqKeys == 64, "S and dP are m64n64 products");
  auto issue_sdp = [&](int stg) {  // S = Q K^T, dP = dO V^T
    const uint32_t k_tile = L::k_tile(base, stg) + kv_off;
    const uint32_t v_tile = L::v_tile(base, stg) + kv_off;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks >> 2) * kDqKeys * 128 + (ks & 3) * 32;
      wgmma_rs_kmajor_m64n64(s, qa[ks], ac::desc_kmajor(k_tile + off),
                             ks > 0);
      wgmma_rs_kmajor_m64n64(dp, oa[ks], ac::desc_kmajor(v_tile + off),
                             ks > 0);
    }
    ac::wgmma_commit();
  };
  auto issue_dq = [&](int stg) {  // dQ += dS K
    issue_rs<D, kDqKeys>(dq, da, L::k_tile(base, stg) + kv_off);
    ac::wgmma_commit();
  };
  // key tile kt, in place: s becomes dS. Element i: row r = (i >> 1) & 1
  // of this thread, key kt * kDqKeys + 2t + col, col = (i >> 2) * 8 +
  // (i & 1); the row's key range relative to kt * kDqKeys + 2t, as dkv's.
  auto grads = [&](int kt) {
    const int k0 = kt * kDqKeys + 2 * t;
    const int lr[2] = {pol.lo[0] - k0, pol.lo[1] - k0};
    const int hr[2] = {pol.hi[0] - k0, pol.hi[1] - k0};
#pragma unroll
    for (int i = 0; i < kDqKeys / 2; ++i) {
      const int r = (i >> 1) & 1, col = (i >> 2) * 8 + (i & 1);
      const float p = (col >= lr[r]) & (col < hr[r])
                          ? ac::ex2(fmaf(s[i], scale_log2, -lse2[r]))
                          : 0.f;
      s[i] = p * fmaf(dp[i], scale, -delta_s[r]);
    }
  };
  auto acquire = [&]() {
    const int stg = ring.stage;
    ac::mbar_wait(base + L::full + 8 * stg, ring.phase);
    ring.advance();
    return stg;
  };
  auto release = [&](int stg) { ac::mbar_arrive(base + L::empty + 8 * stg); };
  // A burst is the next tile's S and dP, then this tile's dQ, in flight
  // while the next tile's dS is computed in place (the forward's overlap)
  // and while the other warpgroup's burst runs (PingPong).
  const PingPong pp{j};
  auto walk = [&]() {
    if (kt0 >= kt1) return;  // a causal window's rows past Sk + window
    pp.start();
    int cur = acquire();
    pp.turn();
    ac::fence_regs(s);
    ac::fence_regs(dp);
    ac::fence_regs(qa);
    ac::fence_regs(oa);
    ac::wgmma_fence();
    issue_sdp(cur);
    pp.pass(false);
    ac::wgmma_wait<0>();
    ac::fence_regs(s);
    ac::fence_regs(dp);
    grads(kt0);
    to_a(s, da);
    for (int kt = kt0 + 1; kt < kt1; ++kt) {
      const int nxt = acquire();
      pp.turn();
      ac::fence_regs(s);
      ac::fence_regs(dp);
      ac::fence_regs(qa);
      ac::fence_regs(oa);
      ac::wgmma_fence();
      issue_sdp(nxt);
      ac::fence_regs(dq);
      ac::wgmma_fence();
      issue_dq(cur);
      pp.pass(false);
      ac::wgmma_wait<1>();  // the next tile's S and dP
      ac::fence_regs(s);
      ac::fence_regs(dp);
      grads(kt);
      ac::wgmma_wait<0>();
      ac::fence_regs(dq);
      ac::fence_regs(da);
      release(cur);
      to_a(s, da);
      cur = nxt;
    }
    pp.turn();
    ac::fence_regs(dq);
    ac::wgmma_fence();
    issue_dq(cur);
    pp.pass(true);
    ac::wgmma_wait<0>();
    ac::fence_regs(dq);
    ac::fence_regs(da);
    release(cur);
  };
  for (int n = 0;; ++n) {
    ac::mbar_wait(q_full, n & 1);
    const int w = *slot;
    if (w >= items) break;
    const BwdItem it = bwd_item<NH, false>(a, w);
    const int pref = prefix_of(a, it.b);
    key_tiles(a, pref, it.r0, bwd_rows<NH>(), kDqKeys, &kt0, &kt1);
    const int h = head_of(it, j);
    const bool present = NH == 1 || j < it.nh;  // an odd H's last pack: 1
    const int q0warp = row_of(it, j) + warp * 16;
    const int row[2] = {q0warp + g, q0warp + g + 8};
    pol.init(a, pref, q0warp, row);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in = present && row[i] < a.Sq;
      const size_t r = in ? ((size_t)it.b * a.H + h) * a.Sq + row[i] : 0;
      lse2[i] = in ? a.lse[r] * ac::kLog2e : 0.f;
      delta_s[i] = in ? a.delta[r] * a.scale : 0.f;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    load_a<D>(q_tile, warp, lane, qa);
    load_a<D>(o_tile, warp, lane, oa);
    ac::mbar_arrive(q_empty);  // the next item's Q and dO may land
    walk();
    if (!present) continue;
    const size_t qs = (size_t)a.H * D;
    bf16* dqg =
        static_cast<bf16*>(a.dq) + ((size_t)it.b * a.Sq * a.H + h) * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= a.Sq) continue;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        store2(dqg + (size_t)row[i] * qs + nt * 8 + 2 * t,
               dq[nt * 4 + 2 * i], dq[nt * 4 + 2 * i + 1]);
    }
  }
}

#define BWD_WGMMA_PARAMS                                                    \
  const Args a, const __grid_constant__ CUtensorMap qm,                     \
      const __grid_constant__ CUtensorMap om,                               \
      const __grid_constant__ CUtensorMap km,                               \
      const __grid_constant__ CUtensorMap vm

template <int D>
__global__ void __launch_bounds__(ac::block_threads(1), 1)
    flash_bwd_dkv_wgmma_kernel(BWD_WGMMA_PARAMS) {
  dkv_wgmma_body<D, 1>(a, qm, om, km, vm);
}

template <int D>
__global__ void __launch_bounds__(ac::block_threads(1), 1)
    flash_bwd_dq_wgmma_kernel(BWD_WGMMA_PARAMS) {
  dq_wgmma_body<D, 1>(a, qm, om, km, vm);
}

__global__ void __launch_bounds__(ac::block_threads(1), 1)
    flash_bwd_dkv_packed_wgmma_kernel(BWD_WGMMA_PARAMS) {
  dkv_wgmma_body<kPackD, 2>(a, qm, om, km, vm);
}

__global__ void __launch_bounds__(ac::block_threads(1), 1)
    flash_bwd_dq_packed_wgmma_kernel(BWD_WGMMA_PARAMS) {
  dq_wgmma_body<kPackD, 2>(a, qm, om, km, vm);
}

#undef BWD_WGMMA_PARAMS

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [B, S, Hkv, D] bf16 as a 4-d tensor map of [rows, 64 columns] boxes
// (rows: kTcBK keys, or a Q tile's 64 rows) in the 128-byte swizzle.
bool kv_tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int Hkv,
                   int D, int rows = kTcBK) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2,
                                 (cuuint64_t)S * Hkv * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The SMs of the current device, cached per device.
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

// NH 1: flash_fwd_wgmma_kernel<D>; NH 2 (D 64, MHA):
// flash_fwd_packed_wgmma_kernel. One block an SM (the block takes the
// SM's shared memory), never more than there are items.
template <int D, int NH>
cudaError_t run_fwd_wgmma(const Args& a, cudaStream_t stream) {
  using L = typename FwdTc<D, NH>::L;
  CUtensorMap qm, km, vm, om;
  if (!kv_tensor_map(&qm, a.q, a.B, a.Sq, a.H, D, ac::kRows) ||
      !kv_tensor_map(&km, a.k, a.B, a.Sk, a.Hkv, D) ||
      !kv_tensor_map(&vm, a.v, a.B, a.Sk, a.Hkv, D) ||
      !kv_tensor_map(&om, a.out, a.B, a.Sq, a.H, D, ac::kRows))
    return cudaErrorInvalidValue;
  decltype(&flash_fwd_packed_wgmma_kernel) kernel;  // both alike
  if constexpr (NH == 1)
    kernel = flash_fwd_wgmma_kernel<D>;
  else
    kernel = flash_fwd_packed_wgmma_kernel;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::alloc);
  if (err != cudaSuccess) return err;
  const int blocks = std::min(fwd_items<NH>(a), std::max(1, sm_count()));
  kernel<<<blocks, ac::block_threads(1), L::alloc, stream>>>(a, qm, km, vm,
                                                              om);
  return cudaGetLastError();
}

// which: 1 = the dq kernel, 2 = the dkv kernel; NH 1:
// flash_bwd_{dq,dkv}_wgmma_kernel<D>; NH 2 (D 64, MHA):
// flash_bwd_{dq,dkv}_packed_wgmma_kernel.
template <int D, int NH>
cudaError_t run_bwd_wgmma(int which, const Args& a, cudaStream_t stream) {
  const bool dkv = which == 2;
  constexpr int ROWS = bwd_rows<NH>();  // a block's q rows (dq) or keys
  // TMA boxes: rows x 64 columns
  const int q_rows = dkv ? kDkvBQ : ac::kRows;
  const int kv_rows = dkv ? ROWS : kDqKeys;
  CUtensorMap qm, om, km, vm;
  if (!kv_tensor_map(&qm, a.q, a.B, a.Sq, a.H, D, q_rows) ||
      !kv_tensor_map(&om, a.dout, a.B, a.Sq, a.H, D, q_rows) ||
      !kv_tensor_map(&km, a.k, a.B, a.Sk, a.Hkv, D, kv_rows) ||
      !kv_tensor_map(&vm, a.v, a.B, a.Sk, a.Hkv, D, kv_rows))
    return cudaErrorInvalidValue;
  decltype(&flash_bwd_dq_packed_wgmma_kernel) kernel;  // all four alike
  if constexpr (NH == 1)
    kernel = dkv ? flash_bwd_dkv_wgmma_kernel<D> : flash_bwd_dq_wgmma_kernel<D>;
  else
    kernel = dkv ? flash_bwd_dkv_packed_wgmma_kernel
                 : flash_bwd_dq_packed_wgmma_kernel;
  const int smem = dkv ? DkvLayout<NH * D, ROWS, NH, bwd_stages<NH>()>::alloc
                       : DqLayout<D, NH>::alloc;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // blocks: one an item (the rows' tiles, by batch element and head or
  // pack), or, persistent, one an SM, never more than there are items
  const int heads = dkv ? a.Hkv : a.H;
  const int rows = dkv ? a.Sk : a.Sq;
  const int items = (rows + ROWS - 1) / ROWS * a.B * ((heads + NH - 1) / NH);
  const int blocks =
      bwd_persistent<D>() ? std::min(items, std::max(1, sm_count())) : items;
  kernel<<<blocks, ac::block_threads(1), smem, stream>>>(a, qm, om, km, vm);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   const Args& a, cudaStream_t stream) {
  // shared memory above 48 KB is opt-in, per kernel
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The one-head kernels on mma.sync tiles serve f32 only (the f32 model
// checks); bf16 runs flash_fwd_wgmma_kernel and the backward pair above.
template <int D>
cudaError_t run_f32(int which, const Args& a, cudaStream_t stream) {
  using T = float;
  const dim3 q_grid((a.Sq + kFwdBQ - 1) / kFwdBQ, a.B * a.H);
  const dim3 kv_grid((a.Sk + kKvBK - 1) / kKvBK, a.B * a.Hkv);
  switch (which) {
    case 0:
      return launch(flash_fwd_kernel<T, D>, q_grid, kThreads1,
                    fwd_smem<T, D, 1>(), a, stream);
    case 1:
      return launch(flash_bwd_dq_kernel<T, D>, q_grid, kThreads1,
                    dq_smem<T, D, 1>(), a, stream);
    case 2:
      return launch(flash_bwd_dkv_kernel<T, D>, kv_grid, kThreads1,
                    dkv_smem<T, D, 1>(), a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The packed kernels on mma.sync tiles serve f32 only (the f32 model
// checks); bf16 runs flash_fwd_packed_wgmma_kernel and the packed backward
// pair on wgmma.
cudaError_t run_packed_f32(int which, const Args& a, cudaStream_t stream) {
  using T = float;
  constexpr int W = 2 * kPackD;
  const int packs = (a.H + 1) / 2;  // MHA: H == Hkv
  const dim3 q_grid((a.Sq + kFwdBQ - 1) / kFwdBQ, a.B * packs);
  const dim3 kv_grid((a.Sk + kKvBK - 1) / kKvBK, a.B * packs);
  switch (which) {
    case 0:
      return launch(flash_fwd_packed_kernel<T>, q_grid, kThreads2,
                    fwd_smem<T, W, 2>(), a, stream);
    case 1:
      return launch(flash_bwd_dq_packed_kernel<T>, q_grid, kThreads2,
                    dq_smem<T, W, 2>(), a, stream);
    case 2:
      return launch(flash_bwd_dkv_packed_kernel<T>, kv_grid, kThreads2,
                    dkv_smem<T, W, 2>(), a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Forward kernel ids (the wrapper names the one to launch).
constexpr int kFwdOneHead = 0;  // flash_fwd_kernel: f32
constexpr int kFwdPacked = 1;   // flash_fwd_packed_kernel: f32
constexpr int kFwdWgmma = 2;    // flash_fwd_wgmma_kernel: bf16
constexpr int kFwdPackedWgmma = 3;  // flash_fwd_packed_wgmma_kernel: bf16

// Backward kernel ids (the wrapper names the pair to launch, one at a
// time: dq, then dkv).
constexpr int kBwdDq = 0;            // flash_bwd_dq_kernel: f32
constexpr int kBwdDkv = 1;           // flash_bwd_dkv_kernel: f32
constexpr int kBwdDqPacked = 2;      // flash_bwd_dq_packed_kernel: f32
constexpr int kBwdDkvPacked = 3;     // flash_bwd_dkv_packed_kernel: f32
constexpr int kBwdDqWgmma = 4;       // flash_bwd_dq_wgmma_kernel: bf16
constexpr int kBwdDkvWgmma = 5;      // flash_bwd_dkv_wgmma_kernel: bf16
constexpr int kBwdDqPackedWgmma = 6;   // flash_bwd_dq_packed_wgmma_kernel: bf16
constexpr int kBwdDkvPackedWgmma = 7; // flash_bwd_dkv_packed_wgmma_kernel: bf16

bool valid(const Args& a) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.Hkv <= 0 || a.H % a.Hkv ||
      a.window < 0)
    return false;
  // the prefix is a causal mask's, and excludes a window
  return !(a.prefix && (!a.causal || a.window));
}

int dispatch(int which, const Args& a, int D, int pack, int dtype,
             void* stream) {
  if (!valid(a)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (pack == 2) {
    if (D != kPackD || a.H != a.Hkv || dtype != 0)
      return cudaErrorInvalidValue;
    return run_packed_f32(which, a, st);
  }
  if (pack != 1 || dtype != 0) return cudaErrorInvalidValue;
  if (D == 128) return run_f32<128>(which, a, st);
  if (D == 64) return run_f32<64>(which, a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dO, dq, dk, dv); D is 64
// or 128; lse and delta are f32; prefix is [B] int32 or null (causal, no
// window). Every pointer is 16-byte aligned (prefix 4-byte). Returns a
// cudaError_t (0 = launched).
//
// kernel (forward): 0 = flash_fwd_kernel (a head a block, f32), 1 =
// flash_fwd_packed_kernel (two heads of 64 a block; MHA, any H; f32), 2 =
// flash_fwd_wgmma_kernel (a head a block, bf16), 3 =
// flash_fwd_packed_wgmma_kernel (two heads of 64 a block; MHA, any H;
// bf16).
int dlrover_flash_fwd(const void* q, const void* k, const void* v, void* out,
                      float* lse, const int* prefix, int B, int Sq, int Sk,
                      int H, int Hkv, int D, float scale, int causal,
                      int window, int kernel, int dtype, void* stream) {
  Args a = {q,       k,       v,      out, nullptr, lse, nullptr,
            nullptr, nullptr, nullptr, prefix, B,  Sq,  Sk,
            H,       Hkv,     scale,  causal, window};
  switch (kernel) {
    case kFwdOneHead:
      if (dtype != 0) return cudaErrorInvalidValue;
      return dispatch(0, a, D, 1, dtype, stream);
    case kFwdPacked:
      return dispatch(0, a, D, 2, dtype, stream);
    case kFwdWgmma: {
      if (dtype != 1 || !valid(a)) return cudaErrorInvalidValue;
      auto st = static_cast<cudaStream_t>(stream);
      if (D == 128) return run_fwd_wgmma<128, 1>(a, st);
      if (D == 64) return run_fwd_wgmma<64, 1>(a, st);
      return cudaErrorInvalidValue;
    }
    case kFwdPackedWgmma:
      if (dtype != 1 || D != kPackD || a.H != a.Hkv || !valid(a))
        return cudaErrorInvalidValue;
      return run_fwd_wgmma<kPackD, 2>(a, static_cast<cudaStream_t>(stream));
    default:
      return cudaErrorInvalidValue;
  }
}

// kernel (backward; a dq kernel writes dq, a dkv kernel dk and dv): 0 =
// flash_bwd_dq_kernel, 1 = flash_bwd_dkv_kernel (a head a block, f32); 2 =
// flash_bwd_dq_packed_kernel, 3 = flash_bwd_dkv_packed_kernel (two heads of
// 64 a block; MHA, any H; f32); 4 = flash_bwd_dq_wgmma_kernel, 5 =
// flash_bwd_dkv_wgmma_kernel (a head a block, bf16, on the tensor cores);
// 6 = flash_bwd_dq_packed_wgmma_kernel, 7 =
// flash_bwd_dkv_packed_wgmma_kernel (two heads of 64 a block; MHA, any H;
// bf16, on the tensor cores).
int dlrover_flash_bwd(int kernel, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, void* dk, void* dv, const int* prefix, int B,
                      int Sq, int Sk, int H, int Hkv, int D, float scale,
                      int causal, int window, int dtype, void* stream) {
  Args a = {q,  k,  v,  nullptr, dout, lse, delta, dq,     dk,    dv,
            prefix, B, Sq, Sk,   H,    Hkv, scale, causal, window};
  auto st = static_cast<cudaStream_t>(stream);
  switch (kernel) {
    case kBwdDq:
    case kBwdDkv:
      return dispatch(kernel == kBwdDq ? 1 : 2, a, D, 1, dtype, stream);
    case kBwdDqPacked:
    case kBwdDkvPacked:
      return dispatch(kernel == kBwdDqPacked ? 1 : 2, a, D, 2, dtype, stream);
    case kBwdDqWgmma:
    case kBwdDkvWgmma: {
      if (dtype != 1 || !valid(a)) return cudaErrorInvalidValue;
      const int which = kernel == kBwdDqWgmma ? 1 : 2;
      if (D == 128) return run_bwd_wgmma<128, 1>(which, a, st);
      if (D == 64) return run_bwd_wgmma<64, 1>(which, a, st);
      return cudaErrorInvalidValue;
    }
    case kBwdDqPackedWgmma:
    case kBwdDkvPackedWgmma:
      if (dtype != 1 || D != kPackD || a.H != a.Hkv || !valid(a))
        return cudaErrorInvalidValue;
      return run_bwd_wgmma<kPackD, 2>(kernel == kBwdDqPackedWgmma ? 1 : 2, a,
                                      st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
