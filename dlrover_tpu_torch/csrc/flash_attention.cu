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
//   flash_bwd_dq_packed_kernel     <- _bwd_dq_kernel_packed     (head_pack 2)
//   flash_bwd_dkv_packed_kernel    <- _bwd_dkv_kernel_packed    (head_pack 2)
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
// atomics). So the products run on the tensor cores. The bf16 kernels of
// one head a block and the bf16 packed forward run on wgmma, the only path
// to the card's full tensor-core rate, from shared-memory tiles that TMA
// fills under the products (attn_fwd_core.cuh's primitives; P and dS kept
// in registers): flash_fwd_wgmma_kernel (a head and 128 q rows a block),
// flash_fwd_packed_wgmma_kernel (a persistent kernel walking items of two
// heads and 64 q rows), flash_bwd_dq_wgmma_kernel (128 q rows of a head a
// block) and flash_bwd_dkv_wgmma_kernel (128 keys of a KV head a block);
// see each below. The packed backward (both types) uses mma.sync m16n8k16
// with f32 accumulation. An f32 call (the f32 model checks) runs the
// mma.sync bodies' tiles through f32 FMAs on the CUDA cores, with the same
// fragment layout, so both share one body.
//
// The mma.sync bodies (the packed backward; every f32 kernel). No block
// carries state to another: the forward gives each block NH query heads of one
// batch element and one 64-row q tile and loops over 64-key tiles inside;
// the dq kernel does the same; the dkv kernel gives each block NH KV heads
// and one 64-key tile and loops over the query heads of each KV head's
// group and over 32-row q tiles, so the GQA group sum of dk/dv is a sum in
// registers and needs no atomics. Each head of a block has a group of 4
// warps; each warp owns 16 rows of its head's output tile and keeps them in
// mma accumulator fragments. Tiles of Q, K, V and dO are staged in shared
// memory with their rows padded by 16 bytes (conflict-free fragment
// loads); P and dS go through a small per-warp buffer, which also rounds
// them to the input type. The operand of a product that is read along its
// rows (V in P.V, K in dS.K, dO in P^T.dO, Q in dS^T.Q) is loaded with
// ldmatrix.trans. Tiles wholly above the causal diagonal or below the
// window, and outside the prefix, are skipped (_block_runs); tiles wholly
// visible (under the diagonal, inside the prefix) only scale their scores;
// the others are masked exactly per element, the ragged tail of S included,
// so S need not be a multiple of a tile. The packed bodies' forward and
// dkv double-buffer their streamed tiles with cp.async (below, kv_bufs).
//
// Head packing (NH = 2, D = 64, MHA: the packed kernels). In the
// [B, S, H, D] layout heads 2p and 2p + 1 are one contiguous run of 128
// elements (256 bytes in bf16) of every row, so a packed block stages Q, K,
// V and dO as [rows, 128] tiles in one coalesced pass by all 8 warps (the
// bf16 forward: two adjacent TMA boxes a tile), where the unpacked D = 64
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
#include <type_traits>

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
// packed heads of 64 (MHA; f32, and the bf16 backward), a warp group each
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
// the bf16 forward of one head a block on the tensor-core core
// ---------------------------------------------------------------------------
//
// flash_fwd_wgmma_kernel replaces _fwd_kernel (pallas_attention.py l.213;
// pallas_call l.1039 in _flash_fwd l.887) for bf16. What bounds it: at
// llama-1.4b's shape (B 8, S 1024, H 16, D 128, causal) the bytes (134 MB
// read and written once: 40 us at the HBM rate) and the operations (3.4e10
// FLOP: 35 us at the bf16 peak) are close, so the design goes for the
// tensor-core rate: attn_fwd_core.cuh's core (wgmma for Q.K^T and P.V, the
// online softmax in registers) on a q tile of 128 rows (two consumer
// warpgroups of 64) of one query head; GQA reads KV head h / (H / Hkv),
// never repeated. The producer is one thread issuing TMA copies of the K
// and V tiles of 128 keys ([128 keys, 64 columns] boxes of a 4-d tensor
// map [B, Sk, Hkv, D], two a tile at D 128; keys past Sk come in as zeros
// and are masked) into a ring of 3 stages. The key tiles are key_tiles'
// (causal, window, prefix) for the block's 128 rows; a warp skips the mask
// on a wholly visible tile and masks the others per element, by
// allowed()'s rule. Blocks take q tiles from the last: causal tiles late
// in the sequence do the most work. (The packed kernel below masks by a
// range of keys a row, which took its masked tiles' softmax from ~5k
// cycles to the unmasked tiles' cost; this kernel keeps allowed().)

namespace ac = attn_core;

constexpr int kTcBQ = ac::kRows * ac::kConsumers;  // q rows a block
constexpr int kTcBK = 128;                         // keys a K/V tile

// What a consumer warpgroup's rows see of a key tile: allowed() and
// tile_visible() on values held in registers.
struct FlashMask {
  int sq, sk, causal, window, pref;
  int q0warp;  // first row of this warp
  int row[2];  // this thread's rows
  __device__ __forceinline__ bool whole(const ac::Meta& mt) const {
    const int k1 = mt.k0 + kTcBK;
    if (q0warp + 16 > sq || k1 > sk) return false;
    if (!causal || k1 <= pref) return true;
    return k1 - 1 <= q0warp && (window == 0 || q0warp + 15 - mt.k0 < window);
  }
  __device__ __forceinline__ bool allowed(const ac::Meta& mt, int i,
                                          int col) const {
    const int kp = mt.k0 + col, qp = row[i];
    if (kp >= sk || qp >= sq) return false;
    if (!causal || kp < pref) return true;
    return qp >= kp && (window == 0 || qp - kp < window);
  }
};

template <int D>
__global__ void __launch_bounds__(ac::block_threads(1), 1)
    flash_fwd_wgmma_kernel(const Args a, const __grid_constant__ CUtensorMap km,
                           const __grid_constant__ CUtensorMap vm) {
  using L = ac::Layout<D, kTcBK, 0>;
  const uint32_t base = ac::smem_base();
  ac::init_barriers<L>(base, 1);
  const int wg = threadIdx.x / 128;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int pref = prefix_of(a, b);
  if (wg == 0) {
    ac::setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    const int kh = h / (a.H / a.Hkv);
    int kt0, kt1;
    key_tiles(a, pref, q0, kTcBQ, kTcBK, &kt0, &kt1);
    ac::Ring ring;
    for (int kt = kt0; kt < kt1; ++kt) {
      ac::wait_empty<L>(base, ring);
      ac::write_meta<L>(base, ring.stage, kt * kTcBK, ~0ull);
      const uint32_t full = base + L::full + 8 * ring.stage;
      ac::mbar_arrive_tx(full, 2 * L::kKvTile);
#pragma unroll
      for (int half = 0; half < D / 64; ++half) {
        const uint32_t off = half * kTcBK * 128;
        ac::tma_load_4d(L::k_tile(base, ring.stage) + off, &km, full,
                        half * 64, kh, kt * kTcBK, b);
        ac::tma_load_4d(L::v_tile(base, ring.stage) + off, &vm, full,
                        half * 64, kh, kt * kTcBK, b);
      }
      ring.advance();
    }
    ac::wait_empty<L>(base, ring);
    ac::write_meta<L>(base, ring.stage, -1, 0);
    ac::mbar_arrive(base + L::full + 8 * ring.stage);
    return;
  }
  ac::setmaxnreg_inc<232>();
  const int ct = threadIdx.x - 128 * wg;
  const int warp = ct / 32, lane = ct % 32, g = lane >> 2;
  FlashMask pol;
  pol.sq = a.Sq;
  pol.sk = a.Sk;
  pol.causal = a.causal;
  pol.window = a.window;
  pol.pref = pref;
  const int q0w = q0 + (wg - 1) * ac::kRows;
  pol.q0warp = q0w + warp * 16;
  pol.row[0] = pol.q0warp + g;
  pol.row[1] = pol.q0warp + g + 8;
  const uint32_t q_tile = base + L::q + (wg - 1) * L::kQTile;
  const size_t qs = (size_t)a.H * D;
  const bf16* qg = static_cast<const bf16*>(a.q) +
                   ((size_t)b * a.Sq * a.H + h) * D;
  ac::load_q<D>(q_tile, ct, [&](int r) -> const bf16* {
    const int row = q0w + r;
    return row < a.Sq ? qg + (size_t)row * qs : nullptr;
  }, wg);
  ac::State<D> st;
  ac::consume<D, L>(base, q_tile, pol, a.scale * ac::kLog2e, st);
  bf16* og = static_cast<bf16*>(const_cast<void*>(a.out)) +
             ((size_t)b * a.Sq * a.H + h) * D;
  float* lg = const_cast<float*>(a.lse) + ((size_t)b * a.H + h) * a.Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = pol.row[i];
    if (row >= a.Sq) continue;
    ac::store_row<D>(st, i, og + (size_t)row * qs);
    if ((lane & 3) == 0)
      lg[row] = st.m[i] * a.scale + logf(st.l[i] == 0.f ? 1.f : st.l[i]);
  }
}

// ---------------------------------------------------------------------------
// the bf16 forward of two packed heads of 64 on the tensor-core core
// ---------------------------------------------------------------------------
//
// flash_fwd_packed_wgmma_kernel replaces _fwd_kernel_packed
// (pallas_attention.py l.278; pallas_call l.1039) for bf16: a work item is
// two heads of 64 of one batch element and a tile of 64 q rows, the mask
// computed once for both heads. What bounds it: at gpt2-1.5b's shape (B 8,
// S 1024, H 25, D 64, causal) the bytes (106 MB read and written once:
// 32 us at the HBM rate) and the operations (2.7e10 FLOP: 27 us at the
// bf16 peak) are close, so, as for K1, the design goes for the tensor-core
// rate on attn_fwd_core.cuh's core.
//
// Persistent: one block an SM takes items from a counter in device memory
// in the order of the hardware's block scheduler (pack by pack, each
// pack's q tiles from the last: the causal items that do the most work
// first, and the blocks at work at once read few heads' K/V, which stay
// in L2), and its K/V ring runs on from one item into the next. The last
// block to finish resets the counter, so launches must follow each other
// on one stream. The producer thread takes the item, publishes it beside
// its Q slot and loads both heads' Q tiles ([64 rows, 64 columns] TMA
// boxes, into one of two Q slots on that slot's barrier, once the
// consumers have released the slot's previous item), then, per
// 128-key stage, four TMA boxes of [128 keys, 64 columns] from the D 64
// tensor maps: K and V of heads 2p and 2p + 1, which lays the stage out
// exactly as a D 128 stage (ac::Layout<128, 128, .>), column block j
// holding head 2p + j; then an end Meta. So an item's Q and first tiles
// land while the consumers still finish the previous item, and its output
// stores run under the next item's loads. Consumer warpgroup j computes
// head 2p + j from its column block (consume()'s kv_off) with the core's
// arithmetic (p rounded to bf16 before P.V, l summing the unrounded p,
// l == 0 -> 1) and writes lse [B, H, Sq] f32 as K2p reads it. The key
// tiles are key_tiles' for the item's rows, shared by both heads. With an
// odd H the last pack has one head: its producer loads only that head's
// boxes (half the expected bytes), and the second consumer computes and
// writes nothing but still takes and releases each of the item's stages
// and its Q slot, so every barrier counts both consumers' arrivals.
//
// The mask (RangeMask) is one range of keys [lo, hi) a row, computed once
// an item, so a masked tile costs two compares and a select a score: the
// per-element rule of allowed(), compiled with its branches, took the
// softmax of a masked tile (one in 4.5 at gpt2's shape) to ~5k cycles.

constexpr int kPackBQ = ac::kRows;  // q rows a packed item (both heads)

// The keys a row sees are one range: causal, [max(0, q - window + 1),
// max(prefix, q + 1)) (a window and a prefix exclude each other), else
// [0, Sk); cut to [0, Sk), and empty for rows past Sq. whole(): every row
// of this warp sees every key of the tile.
struct RangeMask {
  int lo[2], hi[2];  // this thread's rows
  int wlo, whi;      // keys every row of this warp sees: [wlo, whi)
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
  }
  __device__ __forceinline__ bool whole(const ac::Meta& mt) const {
    return mt.k0 >= wlo && mt.k0 + kTcBK <= whi;
  }
  __device__ __forceinline__ bool allowed(const ac::Meta& mt, int i,
                                          int col) const {
    const int kp = mt.k0 + col;
    return (kp >= lo[i]) & (kp < hi[i]);
  }
};

// extra: the Q slots' full and empty barriers, then their item numbers
using PackedLayout = ac::Layout<2 * kPackD, kTcBK, 48>;

// The item counter (next item, blocks done) of the packed forward.
__device__ unsigned int g_packed_work[2];

// Work item w of the packed forward: batch element, first head, heads
// (2, or 1 in an odd H's last pack), first q row.
struct PackedItem {
  int b, h0, nh, q0;
  __device__ __forceinline__ PackedItem(const Args& a, int w) {
    const int packs = (a.H + 1) / 2;
    const int n_qt = (a.Sq + kPackBQ - 1) / kPackBQ;
    const int bp = w / n_qt;
    q0 = (n_qt - 1 - w % n_qt) * kPackBQ;
    b = bp / packs;
    h0 = (bp % packs) * 2;
    nh = min(2, a.H - h0);
  }
};

__device__ __forceinline__ int packed_items(const Args& a) {
  return (a.Sq + kPackBQ - 1) / kPackBQ * a.B * ((a.H + 1) / 2);
}

__global__ void __launch_bounds__(ac::block_threads(1), 1)
    flash_fwd_packed_wgmma_kernel(const Args a,
                                  const __grid_constant__ CUtensorMap qm,
                                  const __grid_constant__ CUtensorMap km,
                                  const __grid_constant__ CUtensorMap vm) {
  using L = PackedLayout;
  const uint32_t base = ac::smem_base();
  // Q slot s: tiles of heads 0 and 1 at q + (2 s + j) * 8 KB; filled on
  // q_full(s), released on q_empty(s) by every consumer thread
  auto q_full = [&](int s) { return base + L::extra + 8 * s; };
  auto q_empty = [&](int s) { return base + L::extra + 16 + 8 * s; };
  auto q_tile = [&](int s, int j) {
    return base + L::q + (2 * s + j) * kPackBQ * 128;
  };
  auto item_of = [&](int s) {
    return reinterpret_cast<volatile int*>(
        ac::smem_ptr(base + L::extra + 32 + 4 * s));
  };
  if (threadIdx.x == 0) {  // fenced and synced by init_barriers
    for (int s = 0; s < 2; ++s) {
      ac::mbar_init(q_full(s), 1);
      ac::mbar_init(q_empty(s), 128 * ac::kConsumers);
    }
  }
  ac::init_barriers<L>(base, 1);
  const int wg = threadIdx.x / 128;
  const int items = packed_items(a);
  ac::Ring ring;
  if (wg == 0) {
    ac::setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    for (int n = 0;; ++n) {
      const int w = atomicAdd(&g_packed_work[0], 1u);
      const int s = n & 1;
      if (n >= 2) ac::mbar_wait(q_empty(s), ((n >> 1) - 1) & 1);
      *item_of(s) = w;
      if (w >= items) {  // no work left: the consumers see w and stop
        ac::mbar_arrive(q_full(s));
        break;
      }
      const PackedItem it(a, w);
      ac::mbar_arrive_tx(q_full(s), it.nh * kPackBQ * 128);
      for (int j = 0; j < it.nh; ++j)
        ac::tma_load_4d(q_tile(s, j), &qm, q_full(s), 0, it.h0 + j, it.q0,
                        it.b);
      int kt0, kt1;
      key_tiles(a, prefix_of(a, it.b), it.q0, kPackBQ, kTcBK, &kt0, &kt1);
      for (int kt = kt0; kt < kt1; ++kt) {
        ac::wait_empty<L>(base, ring);
        ac::write_meta<L>(base, ring.stage, kt * kTcBK, ~0ull);
        const uint32_t full = base + L::full + 8 * ring.stage;
        ac::mbar_arrive_tx(full, it.nh * 2 * kTcBK * 128);
        for (int j = 0; j < it.nh; ++j) {
          const uint32_t off = j * kTcBK * 128;
          ac::tma_load_4d(L::k_tile(base, ring.stage) + off, &km, full, 0,
                          it.h0 + j, kt * kTcBK, it.b);
          ac::tma_load_4d(L::v_tile(base, ring.stage) + off, &vm, full, 0,
                          it.h0 + j, kt * kTcBK, it.b);
        }
        ring.advance();
      }
      ac::wait_empty<L>(base, ring);
      ac::write_meta<L>(base, ring.stage, -1, 0);
      ac::mbar_arrive(base + L::full + 8 * ring.stage);
      ring.advance();
    }
    // the last block out resets the counter for the next launch
    if (atomicAdd(&g_packed_work[1], 1u) == gridDim.x - 1) {
      g_packed_work[0] = 0;
      g_packed_work[1] = 0;
    }
    return;
  }
  ac::setmaxnreg_inc<232>();
  const int j = wg - 1;  // this consumer's head: h0 + j
  const int ct = threadIdx.x - 128 * wg;
  const int warp = ct / 32, lane = ct % 32, g = lane >> 2, t = lane & 3;
  const size_t qs = (size_t)a.H * kPackD;
  for (int n = 0;; ++n) {
    const int s = n & 1;
    ac::mbar_wait(q_full(s), (n >> 1) & 1);
    const int w = *item_of(s);
    if (w >= items) break;
    const PackedItem it(a, w);
    if (j >= it.nh) {
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
    const int h = it.h0 + j;
    const int q0warp = it.q0 + warp * 16;
    const int row[2] = {q0warp + g, q0warp + g + 8};
    RangeMask pol;
    pol.init(a, prefix_of(a, it.b), q0warp, row);
    ac::State<kPackD> st;
    ac::consume<kPackD, L>(base, q_tile(s, j), pol, a.scale * ac::kLog2e, st,
                           j * kTcBK * 128, ring);
    // the end Meta's stage and the Q slot, released
    ac::mbar_arrive(base + L::empty + 8 * ring.stage);
    ring.advance();
    ac::mbar_arrive(q_empty(s));
    bf16* og = static_cast<bf16*>(const_cast<void*>(a.out)) +
               ((size_t)it.b * a.Sq * a.H + h) * kPackD;
    float* lg =
        const_cast<float*>(a.lse) + ((size_t)it.b * a.H + h) * a.Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= a.Sq) continue;
      // l == 0 -> 1: a row that saw no key is exactly 0
      const float l = st.l[i] == 0.f ? 1.f : st.l[i];
      const float inv = 1.f / l;
      bf16* dst = og + (size_t)row[i] * qs;
#pragma unroll
      for (int nt = 0; nt < kPackD / 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8 + 2 * t) =
            __floats2bfloat162_rn(st.o[nt * 4 + 2 * i] * inv,
                                  st.o[nt * 4 + 2 * i + 1] * inv);
      if (t == 0) lg[row[i]] = st.m[i] * a.scale + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// the bf16 backward of one head a block on the tensor cores
// ---------------------------------------------------------------------------
//
// flash_bwd_dkv_wgmma_kernel and flash_bwd_dq_wgmma_kernel replace
// _bwd_dkv_kernel (pallas_attention.py l.423; pallas_call l.859) and
// _bwd_dq_kernel (l.369; pallas_call l.823) for bf16, D 64 or 128, GQA, as
// _pallas_backward (l.615) drives them. What bounds them: operations. The
// backward's least work is five products, 10·D FLOP a visible (query, key)
// pair. It stays two kernels so that neither needs atomics: the GQA group
// sum of dk and dv is a sum in registers in a fixed order, and a call
// repeats bit for bit. So both recompute S = Q.K^T and dP = dO.V^T: 14·D
// FLOP a pair executed. At llama-1.4b's shape (B 8, S 1024, H 16, D 128,
// causal) that is 1.2e11 FLOP, 0.12 ms at the bf16 peak, against 134 MB
// read and written once (0.04 ms). Every product therefore runs on wgmma,
// built from attn_fwd_core.cuh's primitives: a producer warpgroup keeps a
// ring of 3 stages filled by TMA behind full/empty mbarriers and gives its
// registers to two consumer warpgroups of 64 rows (setmaxnreg: 24 and 240
// a thread); tiles are stored in the 128-byte swizzle; the products that
// consume P or dS take it in registers as the A operand (the score
// accumulator's layout is the A fragment's) with the other operand
// MN-major (wgmma_pv), so P and dS never pass through shared memory. The
// arithmetic is _p_and_ds (l.183): p = exp(s - lse) recomputed from the
// forward's lse, as 2^(q.k * scale * log2(e) - lse * log2(e)) in one FMA;
// a masked element is exactly 0; ds = p (dp - delta) scale, computed as
// p (dp scale - delta scale); p and ds rounded to bf16 for the products
// that take them; sums in f32, rounded once when stored.
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
// dkv: a block owns 128 keys of one KV head (64 a consumer warpgroup) and
// loads their K and V once by TMA. One producer warp streams, for each
// query head of the group and each q tile of 64 rows that can see the
// block's keys (q_tiles), the Q and dO tiles (TMA) with their lse and
// delta rows (4-byte cp.async: a [B, H, Sq] f32 row is not a multiple of
// the 16 bytes a tensor map's strides need at every Sq). A consumer
// computes S^T = K.Q^T and dP^T = V.dO^T (keys as the M rows, both
// operands from shared memory, wgmma_s), P^T and dS^T in registers, then
// dV += P^T.dO and dK += dS^T.Q. Its mask is a range of queries a key
// (q_range: RangeMask turned round). Blocks take key tiles from the
// first: under causal key tile 0 is seen by every q tile.
//
// dq: a block owns 128 q rows of one query head (64 a consumer) and loads
// their Q and dO once by TMA; the producer thread streams K and V tiles of
// kDqKeys keys over key_tiles' range, as the forward's does. A consumer
// keeps the lse and delta of its rows, and its Q and dO as A fragments, in
// registers, computes S = Q.K^T and dP = dO.V^T (register A, K and V
// K-major from the stage: only B is read from shared memory, whose
// bandwidth the shared-A form of these m64n64 products saturates), dS in
// registers, and dQ += dS.K with the stage's K as the MN-major operand.
// Its mask is the packed forward's RangeMask. Blocks take q tiles from the
// last, as the forward does.
//
// Every consumer thread takes and releases every stage, whatever its rows
// see of it (a stage that none of a warpgroup's rows sees adds exactly 0),
// so the barrier counts never drift. Rows past Sq and keys past Sk come in
// from TMA as zeros and are masked; stores stop at Sq and Sk.

constexpr int kDkvKeys = ac::kRows * ac::kConsumers;  // keys a dkv block
constexpr int kDkvBQ = 64;                            // q rows a dkv stage
constexpr int kDqBQ = ac::kRows * ac::kConsumers;     // q rows a dq block
constexpr int kDqKeys = 64;                           // keys a dq stage

// dkv's shared memory: K and V of the block's keys ([128 keys][64] column
// blocks), the ring's stages (Q and dO tiles of kDkvBQ rows), each stage's
// lse and delta rows (f32), the barriers.
template <int D>
struct DkvLayout {
  static constexpr int kRowTile = (D / 64) * kDkvBQ * 128;
  static constexpr int kKvTile = (D / 64) * kDkvKeys * 128;
  static constexpr int k = 0;
  static constexpr int v = kKvTile;
  static constexpr int stages = 2 * kKvTile;
  static constexpr int rows = stages + ac::kStages * 2 * kRowTile;
  static constexpr int full = rows + ac::kStages * 2 * kDkvBQ * 4;
  static constexpr int empty = full + 8 * ac::kStages;
  static constexpr int kv_full = empty + 8 * ac::kStages;
  static constexpr int bytes = kv_full + 8;
  static constexpr int alloc = bytes + 1024;  // alignment slack
  static __device__ __forceinline__ uint32_t q_tile(uint32_t base, int s) {
    return base + stages + s * 2 * kRowTile;
  }
  static __device__ __forceinline__ uint32_t do_tile(uint32_t base, int s) {
    return q_tile(base, s) + kRowTile;
  }
  // lse[kDkvBQ], then delta[kDkvBQ]
  static __device__ __forceinline__ uint32_t rows_of(uint32_t base, int s) {
    return base + rows + s * 2 * kDkvBQ * 4;
  }
};

// dq's: the core's layout (Q tiles, the K/V ring) with the dO tiles and
// the Q/dO barrier as its extra bytes.
template <int D>
using DqLayout = ac::Layout<D, kDqKeys, 2 * (D / 64) * ac::kRows * 128 + 8>;

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
// [k0, k0 + kDkvKeys): under causal from the diagonal on, up to the last
// key's window; every tile when the block reaches into the prefix.
__device__ __forceinline__ void q_tiles(const Args& a, int pref, int k0,
                                        int& begin, int& end) {
  const int n = (a.Sq + kDkvBQ - 1) / kDkvBQ;
  begin = 0;
  end = n;
  if (a.causal && k0 >= pref) {
    begin = min(k0 / kDkvBQ, n);
    if (a.window)
      end = min(n, (k0 + kDkvKeys - 1 + a.window - 1) / kDkvBQ + 1);
  }
}

template <int D>
__global__ void __launch_bounds__(ac::block_threads(1), 1)
    flash_bwd_dkv_wgmma_kernel(const Args a,
                               const __grid_constant__ CUtensorMap qm,
                               const __grid_constant__ CUtensorMap om,
                               const __grid_constant__ CUtensorMap km,
                               const __grid_constant__ CUtensorMap vm) {
  using L = DkvLayout<D>;
  const uint32_t base = ac::smem_base();
  const uint32_t kv_full = base + L::kv_full;
  if (threadIdx.x == 0) ac::mbar_init(kv_full, 1);  // synced below
  // full: the producer thread's expect_tx and its warp's 32 cp.async
  // arrivals
  ac::init_barriers<L>(base, 1 + 32);
  const int wg = threadIdx.x / 128;
  const int k0 = blockIdx.x * kDkvKeys;
  const int b = blockIdx.y / a.Hkv, kh = blockIdx.y % a.Hkv;
  const int groups = a.H / a.Hkv;
  const int pref = prefix_of(a, b);
  int qt0, qt1;
  q_tiles(a, pref, k0, qt0, qt1);
  const int n_qt = qt1 - qt0;
  const int stages = groups * n_qt;  // (query head, q tile) in that order
  // registers: 128 * 24 + 256 * 240 = 384 * 168, the block's pool
  if (wg == 0) {
    ac::setmaxnreg_dec<24>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      ac::mbar_arrive_tx(kv_full, 2 * L::kKvTile);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        const uint32_t off = cb * kDkvKeys * 128;
        ac::tma_load_4d(base + L::k + off, &km, kv_full, cb * 64, kh, k0, b);
        ac::tma_load_4d(base + L::v + off, &vm, kv_full, cb * 64, kh, k0, b);
      }
    }
    ac::Ring ring;
    for (int n = 0; n < stages; ++n) {
      const int h = kh * groups + n / n_qt;
      const int q0 = (qt0 + n % n_qt) * kDkvBQ;
      ac::wait_empty<L>(base, ring);
      const uint32_t full = base + L::full + 8 * ring.stage;
      if (lane == 0) {
        ac::mbar_arrive_tx(full, 2 * L::kRowTile);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          const uint32_t off = cb * kDkvBQ * 128;
          ac::tma_load_4d(L::q_tile(base, ring.stage) + off, &qm, full,
                          cb * 64, h, q0, b);
          ac::tma_load_4d(L::do_tile(base, ring.stage) + off, &om, full,
                          cb * 64, h, q0, b);
        }
      }
      const size_t row0 = ((size_t)b * a.H + h) * a.Sq;
      unsigned char* rows = ac::smem_ptr(L::rows_of(base, ring.stage));
#pragma unroll
      for (int i = lane; i < kDkvBQ; i += 32) {
        const bool in = q0 + i < a.Sq;  // rows past Sq: zeros, no read
        const size_t r = in ? row0 + q0 + i : 0;
        cp_async(rows + 4 * i, a.lse + r, 4, in);
        cp_async(rows + 4 * (kDkvBQ + i), a.delta + r, 4, in);
      }
      ac::cp_async_arrive(full);
      ring.advance();
    }
    return;
  }
  ac::setmaxnreg_inc<240>();
  const int j = wg - 1;  // this consumer's keys: k0 + 64 j ..
  const int ct = threadIdx.x - 128 * wg;
  const int warp = ct / 32, lane = ct % 32, g = lane >> 2, t = lane & 3;
  const int key[2] = {k0 + j * ac::kRows + warp * 16 + g,
                      k0 + j * ac::kRows + warp * 16 + g + 8};
  int lo[2], hi[2];
  q_range(a, pref, key[0], lo[0], hi[0]);
  q_range(a, pref, key[1], lo[1], hi[1]);
  const uint32_t k_tile = base + L::k + j * ac::kRows * 128;
  const uint32_t v_tile = base + L::v + j * ac::kRows * 128;
  const float scale = a.scale, scale_log2 = scale * ac::kLog2e;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float st[kDkvBQ / 2], dpt[kDkvBQ / 2];             // S^T, dP^T
  uint32_t pa[kDkvBQ / 16][4], da[kDkvBQ / 16][4];  // P^T, dS^T in bf16
  ac::Ring ring;
  const PingPong pp{j};
  // Every wgmma is issued unconditionally between its fence and its wait,
  // with its registers pinned on both sides (fence_regs), or the compiler
  // serializes every wgmma of the kernel.
  auto issue_sdp = [&](int stg) {  // S^T = K Q^T, dP^T = V dO^T
    ac::fence_regs(st);
    ac::fence_regs(dpt);
    ac::wgmma_fence();
    issue_kmajor<D, kDkvBQ, kDkvKeys>(st, k_tile, L::q_tile(base, stg));
    issue_kmajor<D, kDkvBQ, kDkvKeys>(dpt, v_tile, L::do_tile(base, stg));
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
    issue_rs<D, kDkvBQ>(dv, pa, L::do_tile(base, stg));
    issue_rs<D, kDkvBQ>(dk, da, L::q_tile(base, stg));
    ac::wgmma_commit();
  };
  auto wait_dkv = [&]() {
    ac::wgmma_wait<0>();
    ac::fence_regs(dv);
    ac::fence_regs(dk);
    ac::fence_regs(pa);
    ac::fence_regs(da);
  };
  // stage n of the walk, in place: st becomes P^T, dpt dS^T, then both
  // are rounded into the A fragments. Element i: key row r = (i >> 1) & 1
  // of this thread, query q0 + 2t + col, col = (i >> 2) * 8 + (i & 1). The
  // elementwise work sets the pace of a stage, so it is kept short: the
  // key row's query range is taken relative to q0 + 2t, so that each test
  // compares with a constant, on every stage (a branch to skip it on the
  // wholly visible stages doubles the code and ran slower), and the scale
  // is folded into dP - delta.
  auto grads = [&](int n, int stg) {
    const int q0 = (qt0 + n % n_qt) * kDkvBQ;
    const float* rows =
        reinterpret_cast<const float*>(ac::smem_ptr(L::rows_of(base, stg)));
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
  // (one after the other: P^T, dS^T, S^T, dP^T, dK and dV live at once
  // leave ptxas too few registers at D 128, and it serializes the wgmmas,
  // C7512); the stage's P^T and dS^T are computed while the other
  // warpgroup's burst runs.
  auto walk = [&]() {
    if (stages == 0) return;
    pp.start();
    int cur = acquire();
    pp.turn();
    issue_sdp(cur);
    pp.pass(false);
    wait_sdp();
    grads(0, cur);
    for (int n = 1; n < stages; ++n) {
      const int nxt = acquire();
      pp.turn();
      issue_dkv(cur);
      wait_dkv();
      release(cur);
      issue_sdp(nxt);
      pp.pass(false);
      wait_sdp();
      grads(n, nxt);
      cur = nxt;
    }
    pp.turn();
    issue_dkv(cur);
    pp.pass(true);
    wait_dkv();
    release(cur);
  };
  ac::mbar_wait(kv_full, 0);
  walk();
  const size_t ks = (size_t)a.Hkv * D;
  const size_t koff = ((size_t)b * a.Sk * a.Hkv + kh) * D;
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

template <int D>
__global__ void __launch_bounds__(ac::block_threads(1), 1)
    flash_bwd_dq_wgmma_kernel(const Args a,
                              const __grid_constant__ CUtensorMap qm,
                              const __grid_constant__ CUtensorMap om,
                              const __grid_constant__ CUtensorMap km,
                              const __grid_constant__ CUtensorMap vm) {
  using L = DqLayout<D>;
  const uint32_t base = ac::smem_base();
  const uint32_t do_tiles = base + L::extra;  // consumer j's at + j kQTile
  const uint32_t q_full = base + L::extra + 2 * L::kQTile;
  if (threadIdx.x == 0) ac::mbar_init(q_full, 1);  // synced below
  ac::init_barriers<L>(base, 1);
  const int wg = threadIdx.x / 128;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqBQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int pref = prefix_of(a, b);
  int kt0, kt1;
  key_tiles(a, pref, q0, kDqBQ, kDqKeys, &kt0, &kt1);
  if (wg == 0) {
    // registers: 128 * 24 + 256 * 240 = 384 * 168, the block's pool
    ac::setmaxnreg_dec<24>();
    if (threadIdx.x != 0) return;
    const int kh = h / (a.H / a.Hkv);
    ac::mbar_arrive_tx(q_full, 2 * ac::kConsumers * L::kQTile);
#pragma unroll
    for (int j = 0; j < ac::kConsumers; ++j)
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        const uint32_t off = j * L::kQTile + cb * ac::kRows * 128;
        const int row = q0 + j * ac::kRows;
        ac::tma_load_4d(base + L::q + off, &qm, q_full, cb * 64, h, row, b);
        ac::tma_load_4d(do_tiles + off, &om, q_full, cb * 64, h, row, b);
      }
    ac::Ring ring;
    for (int kt = kt0; kt < kt1; ++kt) {
      ac::wait_empty<L>(base, ring);
      const uint32_t full = base + L::full + 8 * ring.stage;
      ac::mbar_arrive_tx(full, 2 * L::kKvTile);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        const uint32_t off = cb * kDqKeys * 128;
        ac::tma_load_4d(L::k_tile(base, ring.stage) + off, &km, full,
                        cb * 64, kh, kt * kDqKeys, b);
        ac::tma_load_4d(L::v_tile(base, ring.stage) + off, &vm, full,
                        cb * 64, kh, kt * kDqKeys, b);
      }
      ring.advance();
    }
    return;
  }
  ac::setmaxnreg_inc<240>();
  const int j = wg - 1;  // this consumer's rows: q0 + 64 j ..
  const int ct = threadIdx.x - 128 * wg;
  const int warp = ct / 32, lane = ct % 32, g = lane >> 2, t = lane & 3;
  const int q0warp = q0 + j * ac::kRows + warp * 16;
  const int row[2] = {q0warp + g, q0warp + g + 8};
  RangeMask pol;  // its keys [lo, hi) a row
  pol.init(a, pref, q0warp, row);
  // lse * log2(e) and delta * scale of this thread's rows; 0 past Sq,
  // where every key is masked
  float lse2[2], delta_s[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < a.Sq;
    const size_t r = ((size_t)b * a.H + h) * a.Sq + row[i];
    lse2[i] = in ? a.lse[r] * ac::kLog2e : 0.f;
    delta_s[i] = in ? a.delta[r] * a.scale : 0.f;
  }
  const uint32_t q_tile = base + L::q + j * L::kQTile;
  const uint32_t o_tile = do_tiles + j * L::kQTile;
  const float scale = a.scale, scale_log2 = scale * ac::kLog2e;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float s[kDqKeys / 2], dp[kDqKeys / 2];
  uint32_t da[kDqKeys / 16][4];  // dS in bf16
  // Q and dO of this warpgroup's rows as register A operands: S and dP
  // then read only K and V from shared memory, whose bandwidth the
  // shared-A form of m64n64 products saturates
  uint32_t qa[D / 16][4], oa[D / 16][4];
  ac::Ring ring;
  static_assert(kDqKeys == 64, "S and dP are m64n64 products");
  auto issue_sdp = [&](int stg) {  // S = Q K^T, dP = dO V^T
    const uint32_t k_tile = L::k_tile(base, stg);
    const uint32_t v_tile = L::v_tile(base, stg);
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
    issue_rs<D, kDqKeys>(dq, da, L::k_tile(base, stg));
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
  ac::mbar_wait(q_full, 0);
  load_a<D>(q_tile, warp, lane, qa);
  load_a<D>(o_tile, warp, lane, oa);
  walk();
  const size_t qs = (size_t)a.H * D;
  bf16* dqg = static_cast<bf16*>(a.dq) + ((size_t)b * a.Sq * a.H + h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= a.Sq) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      store2(dqg + (size_t)row[i] * qs + nt * 8 + 2 * t, dq[nt * 4 + 2 * i],
             dq[nt * 4 + 2 * i + 1]);
  }
}

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

template <int D>
cudaError_t run_fwd_wgmma(const Args& a, cudaStream_t stream) {
  using L = ac::Layout<D, kTcBK, 0>;
  CUtensorMap km, vm;
  if (!kv_tensor_map(&km, a.k, a.B, a.Sk, a.Hkv, D) ||
      !kv_tensor_map(&vm, a.v, a.B, a.Sk, a.Hkv, D))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::alloc);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kTcBQ - 1) / kTcBQ, a.B * a.H);
  kernel<<<grid, ac::block_threads(1), L::alloc, stream>>>(a, km, vm);
  return cudaGetLastError();
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

cudaError_t run_fwd_packed_wgmma(const Args& a, cudaStream_t stream) {
  using L = PackedLayout;
  CUtensorMap qm, km, vm;
  if (!kv_tensor_map(&qm, a.q, a.B, a.Sq, a.H, kPackD, kPackBQ) ||
      !kv_tensor_map(&km, a.k, a.B, a.Sk, a.Hkv, kPackD) ||
      !kv_tensor_map(&vm, a.v, a.B, a.Sk, a.Hkv, kPackD))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_packed_wgmma_kernel;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::alloc);
  if (err != cudaSuccess) return err;
  // one block an SM (the block takes the SM's shared memory), never more
  // than there are items
  const int items = (a.Sq + kPackBQ - 1) / kPackBQ * a.B * ((a.H + 1) / 2);
  const int blocks = std::min(items, std::max(1, sm_count()));
  kernel<<<blocks, ac::block_threads(1), L::alloc, stream>>>(a, qm, km, vm);
  return cudaGetLastError();
}

// which: 1 = flash_bwd_dq_wgmma_kernel, 2 = flash_bwd_dkv_wgmma_kernel.
template <int D>
cudaError_t run_bwd_wgmma(int which, const Args& a, cudaStream_t stream) {
  const bool dkv = which == 2;
  const int q_rows = dkv ? kDkvBQ : ac::kRows;  // a TMA box: rows x 64
  const int kv_rows = dkv ? kDkvKeys : kDqKeys;
  CUtensorMap qm, om, km, vm;
  if (!kv_tensor_map(&qm, a.q, a.B, a.Sq, a.H, D, q_rows) ||
      !kv_tensor_map(&om, a.dout, a.B, a.Sq, a.H, D, q_rows) ||
      !kv_tensor_map(&km, a.k, a.B, a.Sk, a.Hkv, D, kv_rows) ||
      !kv_tensor_map(&vm, a.v, a.B, a.Sk, a.Hkv, D, kv_rows))
    return cudaErrorInvalidValue;
  auto kernel =
      dkv ? flash_bwd_dkv_wgmma_kernel<D> : flash_bwd_dq_wgmma_kernel<D>;
  const int smem = dkv ? DkvLayout<D>::alloc : DqLayout<D>::alloc;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = dkv ? dim3((a.Sk + kDkvKeys - 1) / kDkvKeys, a.B * a.Hkv)
                        : dim3((a.Sq + kDqBQ - 1) / kDqBQ, a.B * a.H);
  kernel<<<grid, ac::block_threads(1), smem, stream>>>(a, qm, om, km, vm);
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

template <typename T>
cudaError_t run_packed(int which, const Args& a, cudaStream_t stream) {
  constexpr int W = 2 * kPackD;
  const int packs = (a.H + 1) / 2;  // MHA: H == Hkv
  const dim3 q_grid((a.Sq + kFwdBQ - 1) / kFwdBQ, a.B * packs);
  const dim3 kv_grid((a.Sk + kKvBK - 1) / kKvBK, a.B * packs);
  switch (which) {
    case 0:
      // the packed forward on mma.sync tiles serves f32 only; bf16 runs
      // flash_fwd_packed_wgmma_kernel
      if constexpr (std::is_same<T, float>::value)
        return launch(flash_fwd_packed_kernel<T>, q_grid, kThreads2,
                      fwd_smem<T, W, 2>(), a, stream);
      return cudaErrorInvalidValue;
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
constexpr int kBwdDqPacked = 2;      // flash_bwd_dq_packed_kernel: f32, bf16
constexpr int kBwdDkvPacked = 3;     // flash_bwd_dkv_packed_kernel: f32, bf16
constexpr int kBwdDqWgmma = 4;       // flash_bwd_dq_wgmma_kernel: bf16
constexpr int kBwdDkvWgmma = 5;      // flash_bwd_dkv_wgmma_kernel: bf16

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
    if (D != kPackD || a.H != a.Hkv) return cudaErrorInvalidValue;
    if (dtype == 1) return run_packed<bf16>(which, a, st);
    if (dtype == 0) return run_packed<float>(which, a, st);
    return cudaErrorInvalidValue;
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
      if (D == 128) return run_fwd_wgmma<128>(a, st);
      if (D == 64) return run_fwd_wgmma<64>(a, st);
      return cudaErrorInvalidValue;
    }
    case kFwdPackedWgmma:
      if (dtype != 1 || D != kPackD || a.H != a.Hkv || !valid(a))
        return cudaErrorInvalidValue;
      return run_fwd_packed_wgmma(a, static_cast<cudaStream_t>(stream));
    default:
      return cudaErrorInvalidValue;
  }
}

// kernel (backward; a dq kernel writes dq, a dkv kernel dk and dv): 0 =
// flash_bwd_dq_kernel, 1 = flash_bwd_dkv_kernel (a head a block, f32); 2 =
// flash_bwd_dq_packed_kernel, 3 = flash_bwd_dkv_packed_kernel (two heads of
// 64 a block; MHA, any H; f32 or bf16); 4 = flash_bwd_dq_wgmma_kernel, 5 =
// flash_bwd_dkv_wgmma_kernel (a head a block, bf16, on the tensor cores).
int dlrover_flash_bwd(int kernel, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, void* dk, void* dv, const int* prefix, int B,
                      int Sq, int Sk, int H, int Hkv, int D, float scale,
                      int causal, int window, int dtype, void* stream) {
  Args a = {q,  k,  v,  nullptr, dout, lse, delta, dq,     dk,    dv,
            prefix, B, Sq, Sk,   H,    Hkv, scale, causal, window};
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
      auto st = static_cast<cudaStream_t>(stream);
      if (D == 128) return run_bwd_wgmma<128>(which, a, st);
      if (D == 64) return run_bwd_wgmma<64>(which, a, st);
      return cudaErrorInvalidValue;
    }
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
