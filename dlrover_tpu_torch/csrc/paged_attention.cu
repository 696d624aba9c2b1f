// Paged flash-decode over block-table KV pools, for Hopper (sm_90a).
//
// Replaces the TPU kernel dlrover_tpu/ops/pallas_paged.py::_paged_kernel
// (driven by _paged_call / paged_attention) in its "decode" (one query per
// slot), "chunk" (C queries per slot, chunked prefill) and "verify" (a
// speculative-decoding draft chunk whose K/V rows are in flight) variants,
// over
// bf16/f32 pools ([P, ps, Hkv, D]) or int8 pools ([P, ps, nb, blk] payloads
// with f32 per-block scales [P, ps, nb]). Same semantics: a table entry of
// -1 is an unassigned page and is skipped, key kpos serves query row r iff
// kpos <= pos[r] (and kpos > pos[r] - window with a window), f32 online
// softmax with masked probabilities zeroed explicitly, and rows that see no
// key at all come out as exact zeros (l == 0 -> 1), so a free slot gives 0
// and never NaN. int8 payloads dequantize in f32 and round through the
// compute type, the values quant.kv_decode_rows hands the plain version.
//
// What bounds it: at decode, the bytes of the pages a slot holds: each
// K/V element serves only the `groups` query heads of its KV head, a few
// FLOPs per byte, far below the card's ~295 FLOP/byte ridge. A 256-row
// prefill chunk reuses each element 4 * 256 times and is bound by
// operations on the tensor cores: in bf16 it runs on the Hopper core of
// attn_fwd_core.cuh (paged_chunk_wgmma_kernel below: wgmma, P in
// registers, pages gathered under the products); the f32 and D 32 calls
// keep the CUDA-core chunk kernel. What the design does about the bytes:
// every page is read at most once per block and only if it can hold a key
// some row of the block may see (unassigned pages and pages outside
// [min_pos - window, max_pos] are skipped); int8 pages are read at one
// byte per element and dequantized in registers; loads are vectors of 4
// contiguous elements per lane.
//
// Query rows are ordered (c, g) as in the TPU kernel: H is KV-head-major,
// so query head h belongs to KV head h / groups, and row r of KV head kh is
// chunk row r / groups, head kh * groups + r % groups. A loop over the
// table columns inside a block takes the place of the TPU's sequential
// grid axis and its m/l/acc scratch; each block reads its own table row and
// positions (the TPU's scalar prefetch). The caller names the kernel to
// launch (the Python wrapper picks by the number of query rows per (slot,
// KV head), n_q = C * groups, and by dtype and D; it counts the launches
// under the variant the rows pick, "decode" or "chunk"):
//
// - paged_decode_kernel (n_q <= 8: decode). Grid (slot, KV head). One warp
//   holds every row of the block; the block's warps split the page walk
//   (warp w takes columns w, w + n_warps, ...), each with its own running
//   (m, l, acc), loading K/V straight into registers 16 keys at a time.
//   The warps' partial states merge through shared memory at the end. This
//   keeps 8 pages in flight per (slot, KV head) instead of one.
// - paged_chunk_wgmma_kernel (n_q > 8, bf16, D 64 or 128: prefill
//   chunks). Grid (slot, KV head, tile of 128 rows); see its section.
// - paged_chunk_kernel (n_q > 8, f32 or D 32). Grid (slot, KV head,
//   tile of 32 rows). Each warp holds 4 rows; the block stages one page's
//   K and V for its KV head in shared memory (f32) and every warp reuses
//   it, so a page is read once per 32 rows.
// - the verify variant always runs paged_decode_kernel<VERIFY = true>, in
//   tiles of 8 rows (grid (slot, KV head, tile)): a verify chunk of
//   spec_k + 1 = 5 rows at llama3-8b's 4 query heads per KV head is 20
//   rows, past the decode kernel's 8 per warp, but the chunk kernel stages
//   every page in shared memory for 32 rows at a time and was measured
//   slower than its plain version; a few short rows are decode-shaped
//   work, so 3 tiles of 8 rows re-read each page from L2 instead. Held
//   pages fold only keys kpos < start (start = the chunk's first
//   position: cells at chunk positions may hold an evicted tenant's or a
//   copy-on-write donor's stale rows) and pages from start on are
//   skipped. The C in-flight rows (extra_k / extra_v [B, C, Hkv, D], the
//   compute type) are then folded once per row, by the LAST warp after
//   its share of the pages, before the merge: one fixed warp, so a row's
//   result does not depend on the walk width. In-flight key i at
//   position pos[i] serves row r iff pos[i] <= pos[r] (and the window).
//
// In the CUDA-core kernels scores are a warp-shuffle reduction per key;
// lane i keeps key i's score, so a group of up to 32 keys is one
// max/exp/sum step of the online softmax. Tensor cores for decode and
// verify, and splitting the walk across blocks, are left for later work.
//
// Interface: a plain C function, launched on the caller's stream; it
// allocates nothing and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_fwd_core.cuh"

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;         // warps per block, both kernels
constexpr int kKeysPerStep = 16;  // decode: keys loaded per step of a warp
constexpr int kChunkRows = 4;     // chunk: query rows per warp

// N contiguous elements of E, moved as one vector access.
template <typename E, int N>
struct alignas(sizeof(E) * N) Pack {
  E e[N];
};

template <typename E, int N>
__device__ __forceinline__ Pack<E, N> load_pack(const E* p) {
  return *reinterpret_cast<const Pack<E, N>*>(p);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A stored K/V element as the attention math sees it.
template <typename T, bool INT8, typename E>
__device__ __forceinline__ float kv_value(E x, float scale) {
  if constexpr (INT8) {
    return to_f32(from_f32<T>(to_f32(x) * scale));
  } else {
    return to_f32(x);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One online-softmax step over the keys whose scores the lanes hold (lane
// i: key position kpos = first + i, present iff key_ok). Returns each
// lane's probability per row in p_mine and rescales the running state.
template <int R, int DPL>
__device__ __forceinline__ void softmax_step(
    const float (&s_mine)[R], const int (&pos)[R], const bool (&row_ok)[R],
    int kpos, bool key_ok, int window, float (&m)[R], float (&l)[R],
    float (&acc)[R][DPL], float (&p_mine)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bool allowed = key_ok && row_ok[r] && kpos <= pos[r];
    if (window > 0) allowed = allowed && kpos > pos[r] - window;
    const float s = allowed ? s_mine[r] : kNegInf;
    const float m_new = fmaxf(m[r], warp_max(s));
    const float alpha = expf(m[r] - m_new);
    // zero masked probabilities explicitly: an all-masked group would
    // otherwise add exp(kNegInf - kNegInf) = 1 per lane
    const float p = allowed ? expf(s - m_new) : 0.f;
    l[r] = alpha * l[r] + warp_sum(p);
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[r][t] *= alpha;
    m[r] = m_new;
    p_mine[r] = p;
  }
}

struct Args {
  const void* q;        // [B, C, H, D] T
  void* out;            // [B, C, H, D] T
  const void* k_pool;   // T [P, ps, Hkv, D] | int8 [P, ps, Hkv * D]
  const void* v_pool;
  const float* k_scale;  // [P, ps, nb] (int8 only)
  const float* v_scale;
  const int* tables;     // [B, tab_stride]; the first W columns are walked
  const int* positions;  // [B, C]
  const void* extra_k;   // verify: in-flight rows [B, C, Hkv, D] T
  const void* extra_v;
  int C, H, Hkv, ps, W, tab_stride, blk, window;
  float scale;
};

// ---------------------------------------------------------------------------
// decode (and verify): one warp holds all R rows of the block's row tile,
// the warps split the page walk
// ---------------------------------------------------------------------------

template <typename T, bool INT8, int DPL, int R, bool VERIFY>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const Args a) {
  using E = std::conditional_t<INT8, int8_t, T>;
  constexpr int D = DPL * 32;
  constexpr int KC = kKeysPerStep;
  extern __shared__ float smem[];  // [n_warps][R][D + 2] partial states

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int row0 = blockIdx.z * R;  // this block's tile of query rows
  const int groups = a.H / a.Hkv;
  const int n_q = a.C * groups;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int d0 = lane * DPL;  // this lane's elements d0 .. d0 + DPL - 1
  const T* q = static_cast<const T*>(a.q);
  // verify: held keys at or past the chunk's first position are stale
  const int start = VERIFY ? a.positions[(size_t)b * a.C] : INT_MAX;

  float qv[R][DPL], acc[R][DPL], m[R], l[R], s_mine[R], p_mine[R];
  int pos[R];
  bool row_ok[R];
  int min_pos = INT_MAX, max_pos = INT_MIN;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    row_ok[r] = row < n_q;
    const int c = row_ok[r] ? row / groups : 0;
    const int g = row_ok[r] ? row % groups : 0;
    pos[r] = row_ok[r] ? a.positions[(size_t)b * a.C + c] : 0;
    if (row_ok[r]) {
      min_pos = min(min_pos, pos[r]);
      max_pos = max(max_pos, pos[r]);
      const Pack<T, DPL> qp = load_pack<T, DPL>(
          q + (((size_t)b * a.C + c) * a.H + kh * groups + g) * D + d0);
#pragma unroll
      for (int t = 0; t < DPL; ++t) qv[r][t] = to_f32(qp.e[t]);
    } else {
#pragma unroll
      for (int t = 0; t < DPL; ++t) qv[r][t] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[r][t] = 0.f;
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  const int row_elems = a.Hkv * D;
  const int nb = row_elems / a.blk;
  const E* kp = static_cast<const E*>(a.k_pool);
  const E* vp = static_cast<const E*>(a.v_pool);
  for (int j = warp; j < a.W; j += n_warps) {
    const int page = a.tables[(size_t)b * a.tab_stride + j];
    const int first = j * a.ps;
    bool page_ok = page >= 0 && first <= max_pos && first < start;
    if (a.window > 0)
      page_ok = page_ok && first + a.ps - 1 > min_pos - a.window;
    if (!page_ok) continue;  // uniform across the warp

    for (int i0 = 0; i0 < a.ps; i0 += KC) {
      Pack<E, DPL> kr[KC], vr[KC];
      float ks[KC], vs[KC];
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        ks[i] = vs[i] = 1.f;
        if (i0 + i < a.ps) {
          const size_t cell = (size_t)page * a.ps + i0 + i;
          const size_t off = INT8 ? cell * row_elems + kh * D + d0
                                  : (cell * a.Hkv + kh) * D + d0;
          kr[i] = load_pack<E, DPL>(kp + off);
          vr[i] = load_pack<E, DPL>(vp + off);
          if constexpr (INT8) {
            const size_t si = cell * nb + (kh * D + d0) / a.blk;
            ks[i] = a.k_scale[si];
            vs[i] = a.v_scale[si];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) s_mine[r] = kNegInf;
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        if (i0 + i < a.ps) {
          float kf[DPL];
#pragma unroll
          for (int t = 0; t < DPL; ++t)
            kf[t] = kv_value<T, INT8>(kr[i].e[t], ks[i]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float part = 0.f;
#pragma unroll
            for (int t = 0; t < DPL; ++t) part = fmaf(qv[r][t], kf[t], part);
            const float s = warp_sum(part) * a.scale;
            if (lane == i) s_mine[r] = s;
          }
        }
      }
      const int kpos = first + i0 + lane;
      softmax_step<R, DPL>(s_mine, pos, row_ok, kpos,
                           lane < min(KC, a.ps - i0) && kpos < start,
                           a.window, m, l, acc, p_mine);
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        if (i0 + i < a.ps) {
          float vf[DPL];
#pragma unroll
          for (int t = 0; t < DPL; ++t)
            vf[t] = kv_value<T, INT8>(vr[i].e[t], vs[i]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float pi = __shfl_sync(0xffffffffu, p_mine[r], i);
#pragma unroll
            for (int t = 0; t < DPL; ++t) acc[r][t] = fmaf(pi, vf[t], acc[r][t]);
          }
        }
      }
    }
  }

  if constexpr (VERIFY) {
    // the in-flight chunk rows, folded once per row by the last warp
    if (warp == n_warps - 1) {
      const T* ek = static_cast<const T*>(a.extra_k);
      const T* ev = static_cast<const T*>(a.extra_v);
      for (int i0 = 0; i0 < a.C; i0 += KC) {
        const int n_keys = min(KC, a.C - i0);
#pragma unroll
        for (int r = 0; r < R; ++r) s_mine[r] = kNegInf;
#pragma unroll
        for (int i = 0; i < KC; ++i) {
          if (i < n_keys) {
            const Pack<T, DPL> kr = load_pack<T, DPL>(
                ek + (((size_t)b * a.C + i0 + i) * a.Hkv + kh) * D + d0);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              float part = 0.f;
#pragma unroll
              for (int t = 0; t < DPL; ++t)
                part = fmaf(qv[r][t], to_f32(kr.e[t]), part);
              const float s = warp_sum(part) * a.scale;
              if (lane == i) s_mine[r] = s;
            }
          }
        }
        const int kpos =
            lane < n_keys ? a.positions[(size_t)b * a.C + i0 + lane] : 0;
        softmax_step<R, DPL>(s_mine, pos, row_ok, kpos, lane < n_keys,
                             a.window, m, l, acc, p_mine);
#pragma unroll
        for (int i = 0; i < KC; ++i) {
          if (i < n_keys) {
            const Pack<T, DPL> vr = load_pack<T, DPL>(
                ev + (((size_t)b * a.C + i0 + i) * a.Hkv + kh) * D + d0);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float pi = __shfl_sync(0xffffffffu, p_mine[r], i);
#pragma unroll
              for (int t = 0; t < DPL; ++t)
                acc[r][t] = fmaf(pi, to_f32(vr.e[t]), acc[r][t]);
            }
          }
        }
      }
    }
  }

  // merge the warps' partial (m, l, acc) states
  constexpr int stride = D + 2;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* st = smem + (warp * R + r) * stride;
#pragma unroll
    for (int t = 0; t < DPL; ++t) st[d0 + t] = acc[r][t];
    if (lane == 0) {
      st[D] = m[r];
      st[D + 1] = l[r];
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  for (int r = warp; r < R && row0 + r < n_q; r += n_warps) {
    float mm = kNegInf;
    for (int w = 0; w < n_warps; ++w)
      mm = fmaxf(mm, smem[(w * R + r) * stride + D]);
    float ll = 0.f, o[DPL];
#pragma unroll
    for (int t = 0; t < DPL; ++t) o[t] = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      const float* st = smem + (w * R + r) * stride;
      const float f = expf(st[D] - mm);
      ll += st[D + 1] * f;
#pragma unroll
      for (int t = 0; t < DPL; ++t) o[t] += st[d0 + t] * f;
    }
    const float denom = ll == 0.f ? 1.f : ll;  // fully masked -> 0
    Pack<T, DPL> res;
#pragma unroll
    for (int t = 0; t < DPL; ++t) res.e[t] = from_f32<T>(o[t] / denom);
    const int c = (row0 + r) / groups;
    const int g = (row0 + r) % groups;
    *reinterpret_cast<Pack<T, DPL>*>(
        out + (((size_t)b * a.C + c) * a.H + kh * groups + g) * D + d0) = res;
  }
}

// ---------------------------------------------------------------------------
// chunk: warps split the rows, the block stages each page in shared memory
// ---------------------------------------------------------------------------

template <typename T, bool INT8, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
    paged_chunk_kernel(const Args a) {
  using E = std::conditional_t<INT8, int8_t, T>;
  constexpr int D = DPL * 32;
  constexpr int R = kChunkRows;
  extern __shared__ float smem[];
  float* k_s = smem;             // [ps][D] staged K of (page, kh), f32
  float* v_s = smem + a.ps * D;  // [ps][D] staged V
  __shared__ int tile_pos[2];    // min / max query position of this tile

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int groups = a.H / a.Hkv;
  const int n_q = a.C * groups;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows_per_block = (blockDim.x >> 5) * R;
  const int tile_row0 = blockIdx.z * rows_per_block;
  const T* q = static_cast<const T*>(a.q);

  // lane holds elements lane, lane + 32, ... (conflict-free smem reads)
  float qv[R][DPL], acc[R][DPL], m[R], l[R], s_mine[R], p_mine[R];
  int pos[R];
  bool row_ok[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = tile_row0 + warp * R + r;
    row_ok[r] = row < n_q;
    const int c = row_ok[r] ? row / groups : 0;
    const int g = row_ok[r] ? row % groups : 0;
    pos[r] = row_ok[r] ? a.positions[(size_t)b * a.C + c] : 0;
    const T* qp = q + (((size_t)b * a.C + c) * a.H + kh * groups + g) * D;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      qv[r][t] = row_ok[r] ? to_f32(qp[t * 32 + lane]) : 0.f;
      acc[r][t] = 0.f;
    }
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  // The page range this tile can see: a skipped page would contribute
  // only masked keys to every row of the tile, i.e. nothing.
  if (threadIdx.x == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    const int row_end = min(n_q, tile_row0 + rows_per_block);
    for (int c = tile_row0 / groups; c <= (row_end - 1) / groups; ++c) {
      const int p = a.positions[(size_t)b * a.C + c];
      lo = min(lo, p);
      hi = max(hi, p);
    }
    tile_pos[0] = lo;
    tile_pos[1] = hi;
  }
  __syncthreads();
  const int min_pos = tile_pos[0];
  const int max_pos = tile_pos[1];

  const int row_elems = a.Hkv * D;
  const int nb = row_elems / a.blk;
  const int vec_per_key = D / 4;
  const int n_vec = a.ps * vec_per_key;
  const E* kp = static_cast<const E*>(a.k_pool);
  const E* vp = static_cast<const E*>(a.v_pool);
  for (int j = 0; j < a.W; ++j) {
    const int page = a.tables[(size_t)b * a.tab_stride + j];
    const int first = j * a.ps;
    bool page_ok = page >= 0 && first <= max_pos;
    if (a.window > 0)
      page_ok = page_ok && first + a.ps - 1 > min_pos - a.window;
    if (!page_ok) continue;  // uniform across the block

    __syncthreads();  // every warp is done with the previous page
    // stage: all loads of a round first, then the shared-memory stores
    for (int base = 0; base < n_vec; base += 4 * blockDim.x) {
      Pack<E, 4> kr[4], vr[4];
      float ks[4], vs[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ks[u] = vs[u] = 1.f;
        const int idx = base + u * blockDim.x + threadIdx.x;
        if (idx < n_vec) {
          const int key = idx / vec_per_key;
          const int d = (idx - key * vec_per_key) * 4;
          const size_t cell = (size_t)page * a.ps + key;
          const size_t off = INT8 ? cell * row_elems + kh * D + d
                                  : (cell * a.Hkv + kh) * D + d;
          kr[u] = load_pack<E, 4>(kp + off);
          vr[u] = load_pack<E, 4>(vp + off);
          if constexpr (INT8) {
            const size_t si = cell * nb + (kh * D + d) / a.blk;
            ks[u] = a.k_scale[si];
            vs[u] = a.v_scale[si];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = base + u * blockDim.x + threadIdx.x;
        if (idx < n_vec) {
          const int key = idx / vec_per_key;
          const int d = (idx - key * vec_per_key) * 4;
          float4 kf, vf;
          kf.x = kv_value<T, INT8>(kr[u].e[0], ks[u]);
          kf.y = kv_value<T, INT8>(kr[u].e[1], ks[u]);
          kf.z = kv_value<T, INT8>(kr[u].e[2], ks[u]);
          kf.w = kv_value<T, INT8>(kr[u].e[3], ks[u]);
          vf.x = kv_value<T, INT8>(vr[u].e[0], vs[u]);
          vf.y = kv_value<T, INT8>(vr[u].e[1], vs[u]);
          vf.z = kv_value<T, INT8>(vr[u].e[2], vs[u]);
          vf.w = kv_value<T, INT8>(vr[u].e[3], vs[u]);
          *reinterpret_cast<float4*>(k_s + key * D + d) = kf;
          *reinterpret_cast<float4*>(v_s + key * D + d) = vf;
        }
      }
    }
    __syncthreads();

    for (int i0 = 0; i0 < a.ps; i0 += 32) {
#pragma unroll
      for (int r = 0; r < R; ++r) s_mine[r] = kNegInf;
      const int n_keys = min(32, a.ps - i0);
      for (int i = 0; i < n_keys; ++i) {
        float kreg[DPL];
#pragma unroll
        for (int t = 0; t < DPL; ++t)
          kreg[t] = k_s[(i0 + i) * D + t * 32 + lane];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float part = 0.f;
#pragma unroll
          for (int t = 0; t < DPL; ++t) part = fmaf(qv[r][t], kreg[t], part);
          const float s = warp_sum(part) * a.scale;
          if (lane == i) s_mine[r] = s;
        }
      }
      softmax_step<R, DPL>(s_mine, pos, row_ok, first + i0 + lane,
                           lane < n_keys, a.window, m, l, acc, p_mine);
      for (int i = 0; i < n_keys; ++i) {
        float vreg[DPL];
#pragma unroll
        for (int t = 0; t < DPL; ++t)
          vreg[t] = v_s[(i0 + i) * D + t * 32 + lane];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float pi = __shfl_sync(0xffffffffu, p_mine[r], i);
#pragma unroll
          for (int t = 0; t < DPL; ++t)
            acc[r][t] = fmaf(pi, vreg[t], acc[r][t]);
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!row_ok[r]) continue;
    const int row = tile_row0 + warp * R + r;
    const int c = row / groups;
    const int g = row % groups;
    const float denom = l[r] == 0.f ? 1.f : l[r];  // fully masked -> 0
    T* op = out + (((size_t)b * a.C + c) * a.H + kh * groups + g) * D;
#pragma unroll
    for (int t = 0; t < DPL; ++t)
      op[t * 32 + lane] = from_f32<T>(acc[r][t] / denom);
  }
}

// ---------------------------------------------------------------------------
// chunk on the tensor cores (bf16 compute; bf16 or int8 pools; D 64, 128)
// ---------------------------------------------------------------------------
//
// paged_chunk_wgmma_kernel replaces the "chunk" variant of
// dlrover_tpu/ops/pallas_paged.py::_paged_kernel (l.300; pallas_call l.558
// in _paged_call l.472) for bf16 queries of head dim 64 or 128, over bf16
// or int8 pools. What bounds it: operations. A llama3-8b prefill chunk
// (B 1, C 256 at position 1536, 4 query heads a KV head) does 7.0e9 FLOP
// on the tensor cores (7.1 us at the bf16 peak) and moves 7.9 MB (2.4 us
// at the HBM rate): each K/V element serves 4 * 256 query rows. What the
// design does about it: the products run on wgmma from the core of
// attn_fwd_core.cuh, with P in registers, while producer warpgroups gather
// the next pages; the page walk reads each page once per 128 rows.
//
// Grid (slot, KV head, tile of 128 query rows: two consumer warpgroups of
// 64), rows in the (c, g) order above, K/V tiles of 64 keys. The
// producers walk the key tiles [min_pos - window, max_pos] of the row
// tile; a tile is published only if one of its pages is assigned and in
// range, with a mask of the keys such pages hold (a -1 page or one outside
// the range is never read: its keys are zero-filled and masked). bf16
// pages are gathered by cp.async straight into the swizzled tile,
// completing on the stage's mbarrier. int8 pages and their f32 block
// scales arrive by cp.async in a staging buffer one tile ahead (each
// producer thread reads back only its own copies, so no barrier among
// them), are dequantized and rounded to bf16 exactly as kv_value does, and
// stored into the swizzled tile; that work takes a second producer
// warpgroup. The D 32 and f32 calls keep paged_chunk_kernel (wgmma needs
// 16-element k-steps of a 64-element swizzle row; the f32 model checks
// need f32 math).

namespace ac = attn_core;

constexpr int kTcRows = ac::kRows * ac::kConsumers;  // query rows a block
constexpr int kTcKeys = 64;                          // keys a K/V tile

template <bool INT8, int D>
struct ChunkTc {
  // producer warpgroups: the int8 dequant takes a second one
  static constexpr int kProducers = INT8 ? 2 : 1;
  static constexpr int kThreads = ac::block_threads(kProducers);
  // int8 staging, per buffer: K, V payloads [64 keys][D]; then K, V scale
  // slots, 16 bytes for each 16-element chunk
  static constexpr int kStg = INT8 ? 4 * kTcKeys * D : 0;
  using L = ac::Layout<D, kTcKeys, 2 * kStg>;
};

// What a consumer warp's rows see of a published tile.
struct PagedMask {
  int pos[2];      // this thread's two rows (-1: no such row)
  int wmin, wmax;  // over this warp's 16 rows (an absent row: -1)
  int window;
  __device__ __forceinline__ bool whole(const ac::Meta& mt) const {
    return mt.valid == ~0ull && wmin >= 0 &&
           mt.k0 + kTcKeys - 1 <= wmin &&
           (window == 0 || mt.k0 > wmax - window);
  }
  __device__ __forceinline__ bool allowed(const ac::Meta& mt, int i,
                                          int col) const {
    const int kpos = mt.k0 + col;
    return ((mt.valid >> col) & 1) && kpos <= pos[i] &&
           (window == 0 || kpos > pos[i] - window);
  }
};

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 4 int8 (one 32-bit word) times a scale, each rounded to bf16, as two
// packed pairs: kv_value's arithmetic. The int8 -> f32 conversion is exact
// and off the conversion unit: byte b ^ 0x80 placed under the exponent of
// 2^23 is the float 2^23 + 128 + b.
__device__ __forceinline__ uint2 dequant4(uint32_t w, float s) {
  const uint32_t biased = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = (__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + e)) -
            8388736.f) * s;
  return make_uint2(ac::pack_bf16(f[0], f[1]), ac::pack_bf16(f[2], f[3]));
}

// The producer warpgroup of paged_chunk_wgmma_kernel. Each warp walks the
// same tiles: lane l holds the table entries of keys l and l + 32 of a
// tile (loaded a tile ahead), a ballot makes the tile's key mask, and a
// thread copying a chunk of key k takes k's pool cell from lane k % 32 by
// a shuffle, so the gather itself reads no table.
template <bool INT8, int D>
__device__ __forceinline__ void chunk_tc_producer(const Args& a,
                                                  uint32_t base, int b,
                                                  int kh, int row0) {
  using L = typename ChunkTc<INT8, D>::L;
  constexpr int kStg = ChunkTc<INT8, D>::kStg;
  constexpr int kProd = 128 * ChunkTc<INT8, D>::kProducers;  // threads
  const int pt = threadIdx.x;  // 0 .. kProd - 1
  const int lane = pt & 31;
  const int groups = a.H / a.Hkv;
  const int n_q = a.C * groups;
  const int* tab = a.tables + (size_t)b * a.tab_stride;

  // the row tile's positions
  int lo = INT_MAX, hi = INT_MIN;
  const int row_end = min(n_q, row0 + kTcRows);
  for (int c = row0 / groups + lane; c <= (row_end - 1) / groups; c += 32) {
    const int p = a.positions[(size_t)b * a.C + c];
    lo = min(lo, p);
    hi = max(hi, p);
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  const int n_keys = a.W * a.ps;
  const int t_end = min(hi, n_keys - 1) / kTcKeys;
  const int t_beg = a.window > 0 ? max(0, lo - a.window + 1) / kTcKeys : 0;

  // the table entry of key kpos of the walk (-1 past it)
  auto entry = [&](int kpos) {
    return kpos / kTcKeys <= t_end && kpos < n_keys ? tab[kpos / a.ps]
                                                      : -1;
  };
  // key kpos on page pg is read iff the page is assigned and some row of
  // the tile may see a key of it (the old kernel's skip rule)
  auto key_ok = [&](int kpos, int pg) {
    const int first = kpos - kpos % a.ps;
    bool ok = pg >= 0 && first <= hi;
    if (a.window > 0) ok = ok && first + a.ps - 1 > lo - a.window;
    return ok;
  };
  // key k's pool cell, from the lane holding it
  auto cell_of = [&](int key, int cell_lo, int cell_hi) {
    const int x = __shfl_sync(0xffffffffu, cell_lo, key & 31);
    const int y = __shfl_sync(0xffffffffu, cell_hi, key & 31);
    return static_cast<size_t>(key < 32 ? x : y);
  };
  // every live tile in order: f(t, mask, cell_lo, cell_hi)
  auto walk = [&](auto&& f) {
    int pg_lo = entry(t_beg * kTcKeys + lane);
    int pg_hi = entry(t_beg * kTcKeys + 32 + lane);
    for (int t = t_beg; t <= t_end; ++t) {
      const int k_lo = t * kTcKeys + lane, k_hi = k_lo + 32;
      // the next tile's entries, in flight while this tile is copied
      const int nx_lo = entry(k_lo + kTcKeys);
      const int nx_hi = entry(k_hi + kTcKeys);
      const uint32_t m0 = __ballot_sync(0xffffffffu, key_ok(k_lo, pg_lo));
      const uint32_t m1 = __ballot_sync(0xffffffffu, key_ok(k_hi, pg_hi));
      const uint64_t mask = m0 | (static_cast<uint64_t>(m1) << 32);
      if (mask)
        f(t, mask, pg_lo * a.ps + k_lo % a.ps, pg_hi * a.ps + k_hi % a.ps);
      pg_lo = nx_lo;
      pg_hi = nx_hi;
    }
  };
  auto publish = [&](ac::Ring& ring, int k0, uint64_t mask) {
    if (pt == 0) ac::write_meta<L>(base, ring.stage, k0, mask);
  };

  ac::Ring ring;
  if constexpr (!INT8) {
    const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k_pool);
    const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v_pool);
    constexpr int kChunks = D / 8;  // 16-byte chunks of a key row
    walk([&](int t, uint64_t mask, int cell_lo, int cell_hi) {
      ac::wait_empty<L>(base, ring);
      const uint32_t kt = L::k_tile(base, ring.stage);
      const uint32_t vt = L::v_tile(base, ring.stage);
#pragma unroll
      for (int i = pt; i < kTcKeys * kChunks; i += kProd) {
        const int key = i / kChunks, c = i % kChunks;
        const bool ok = (mask >> key) & 1;
        const size_t cell = cell_of(key, cell_lo, cell_hi);
        const size_t off = ok ? (cell * a.Hkv + kh) * D + c * 8 : 0;
        ac::cp_async16(kt + ac::swz<kTcKeys>(key, c), kp + off, ok);
        ac::cp_async16(vt + ac::swz<kTcKeys>(key, c), vp + off, ok);
      }
      const uint32_t full = base + L::full + 8 * ring.stage;
      publish(ring, t * kTcKeys, mask);
      if (pt == 0) ac::mbar_arrive(full);
      ac::cp_async_arrive(full);
      ring.advance();
    });
    ac::wait_empty<L>(base, ring);
    const uint32_t full = base + L::full + 8 * ring.stage;
    publish(ring, -1, 0);
    if (pt == 0) ac::mbar_arrive(full);
    ac::cp_async_arrive(full);
  } else {
    const int8_t* kp = static_cast<const int8_t*>(a.k_pool);
    const int8_t* vp = static_cast<const int8_t*>(a.v_pool);
    constexpr int kChunks = D / 16;  // 16-element chunks of a key row
    constexpr int kPay = kTcKeys * D;
    const int row_elems = a.Hkv * D;
    const int nb = row_elems / a.blk;
    const bool one_scale = a.blk % 16 == 0;  // a chunk lies in one block
    auto stg = [&](int buf) { return base + L::extra + buf * kStg; };
    // tile t's payloads and scales into staging buffer buf
    auto issue = [&](uint64_t mask, int cell_lo, int cell_hi, int buf) {
      const uint32_t s0 = stg(buf);
#pragma unroll
      for (int i = pt; i < kTcKeys * kChunks; i += kProd) {
        const int key = i / kChunks, c = i % kChunks;
        const size_t cell = cell_of(key, cell_lo, cell_hi);
        if (!((mask >> key) & 1)) continue;
        const size_t off = cell * row_elems + kh * D + c * 16;
        ac::cp_async16(s0 + key * D + c * 16, kp + off, true);
        ac::cp_async16(s0 + kPay + key * D + c * 16, vp + off, true);
        const int d0 = kh * D + c * 16;
        const uint32_t slot = s0 + 2 * kPay + i * 16;
        for (int g = 0; g < (one_scale ? 1 : 4); ++g) {
          const size_t si = cell * nb + (d0 + 4 * g) / a.blk;
          ac::cp_async4(slot + 4 * g, a.k_scale + si);
          ac::cp_async4(slot + kPay + 4 * g, a.v_scale + si);
        }
      }
      ac::cp_async_commit();
    };
    // staging buffer buf, dequantized, into the stage's swizzled tiles:
    // per tensor, every load of the thread's chunks first, then the math
    auto convert = [&](uint64_t m, int buf, int stage) {
      constexpr int kPer = kTcKeys * kChunks / kProd;  // chunks a thread
      const uint32_t s0 = stg(buf);
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        uint4 w[kPer];
        float4 sc[kPer];
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int i = pt + kProd * u, key = i / kChunks, c = i % kChunks;
          w[u] = *reinterpret_cast<const uint4*>(
              ac::smem_ptr(s0 + kv * kPay + key * D + c * 16));
          sc[u] = *reinterpret_cast<const float4*>(
              ac::smem_ptr(s0 + (2 + kv) * kPay + i * 16));
        }
        const uint32_t tile = kv ? L::v_tile(base, stage)
                                 : L::k_tile(base, stage);
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int i = pt + kProd * u, key = i / kChunks, c = i % kChunks;
          uint4 lo16 = make_uint4(0u, 0u, 0u, 0u), hi16 = lo16;
          if ((m >> key) & 1) {
            const float s1 = one_scale ? sc[u].x : sc[u].y;
            const float s2 = one_scale ? sc[u].x : sc[u].z;
            const float s3 = one_scale ? sc[u].x : sc[u].w;
            const uint2 e0 = dequant4(w[u].x, sc[u].x);
            const uint2 e1 = dequant4(w[u].y, s1);
            const uint2 e2 = dequant4(w[u].z, s2);
            const uint2 e3 = dequant4(w[u].w, s3);
            lo16 = make_uint4(e0.x, e0.y, e1.x, e1.y);
            hi16 = make_uint4(e2.x, e2.y, e3.x, e3.y);
          }
          *reinterpret_cast<uint4*>(
              ac::smem_ptr(tile + ac::swz<kTcKeys>(key, 2 * c))) = lo16;
          *reinterpret_cast<uint4*>(
              ac::smem_ptr(tile + ac::swz<kTcKeys>(key, 2 * c + 1))) = hi16;
        }
      }
    };
    // the previous live tile is converted while this one's copies fly
    auto finish = [&](int t, uint64_t mask, int buf) {
      ac::wait_empty<L>(base, ring);
      convert(mask, buf, ring.stage);
      ac::fence_proxy_async();
      publish(ring, t * kTcKeys, mask);
      ac::mbar_arrive(base + L::full + 8 * ring.stage);
      ring.advance();
    };
    int prev = -1, buf = 0;
    uint64_t prev_mask = 0;
    walk([&](int t, uint64_t mask, int cell_lo, int cell_hi) {
      issue(mask, cell_lo, cell_hi, buf);
      if (prev >= 0) {
        ac::cp_async_wait<1>();  // this thread's copies of tile prev
        finish(prev, prev_mask, buf ^ 1);
      }
      prev = t;
      prev_mask = mask;
      buf ^= 1;
    });
    if (prev >= 0) {
      ac::cp_async_wait<0>();
      finish(prev, prev_mask, buf ^ 1);
    }
    ac::wait_empty<L>(base, ring);
    publish(ring, -1, 0);
    ac::mbar_arrive(base + L::full + 8 * ring.stage);
  }
}

template <bool INT8, int D>
__global__ void __launch_bounds__(ChunkTc<INT8, D>::kThreads, 1)
    paged_chunk_wgmma_kernel(const Args a) {
  using L = typename ChunkTc<INT8, D>::L;
  constexpr int kProducers = ChunkTc<INT8, D>::kProducers;
  const uint32_t base = ac::smem_base();
  // full: every int8 producer thread arrives; the bf16 producer's 128
  // cp.async arrivals and thread 0's, which publishes the Meta
  ac::init_barriers<L>(base, INT8 ? 128 * kProducers : 129);
  const int wg = threadIdx.x / 128;
  const int b = blockIdx.x, kh = blockIdx.y;
  const int groups = a.H / a.Hkv;
  const int n_q = a.C * groups;
  const int row0 = blockIdx.z * kTcRows;
  // registers: the block starts with 65536 / threads a thread (168 at
  // 384 threads, 128 at 512); what the producers give up, the consumers
  // take: 128 * 56 + 256 * 224 = 384 * 168, 256 * 56 + 256 * 200 = 512 * 128
  if (wg < kProducers) {
    ac::setmaxnreg_dec<56>();
    chunk_tc_producer<INT8, D>(a, base, b, kh, row0);
    return;
  }
  ac::setmaxnreg_inc<kProducers == 1 ? 224 : 200>();
  const int ct = threadIdx.x - 128 * wg;
  const int warp = ct / 32, lane = ct % 32, g = lane >> 2;
  const int cw = wg - kProducers;  // consumer warpgroup 0 or 1
  const int wr0 = row0 + cw * ac::kRows;
  PagedMask pol;
  pol.window = a.window;
  int rows[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = wr0 + warp * 16 + g + 8 * i;
    pol.pos[i] = rows[i] < n_q
                     ? a.positions[(size_t)b * a.C + rows[i] / groups]
                     : -1;
  }
  pol.wmin = warp_min(min(pol.pos[0], pol.pos[1]));
  pol.wmax = warp_max(max(pol.pos[0], pol.pos[1]));
  const uint32_t q_tile = base + L::q + cw * L::kQTile;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  ac::load_q<D>(q_tile, ct, [&](int r) -> const __nv_bfloat16* {
    const int row = wr0 + r;
    if (row >= n_q) return nullptr;
    return q + (((size_t)b * a.C + row / groups) * a.H + kh * groups +
                row % groups) * D;
  }, 1 + cw);
  ac::State<D> st;
  ac::consume<D, L>(base, q_tile, pol, a.scale * ac::kLog2e, st);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= n_q) continue;
    ac::store_row<D>(st, i, out + (((size_t)b * a.C + rows[i] / groups) *
                                       a.H + kh * groups + rows[i] % groups) *
                                      D);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, bool INT8, int DPL, bool VERIFY>
void launch_decode(const Args& a, int B, int n_q, cudaStream_t stream) {
  constexpr int D = DPL * 32;
  if constexpr (!VERIFY) {
    if (n_q <= 4) {
      const size_t smem = sizeof(float) * kWarps * 4 * (D + 2);
      paged_decode_kernel<T, INT8, DPL, 4, false>
          <<<dim3(B, a.Hkv, 1), kWarps * 32, smem, stream>>>(a);
      return;
    }
  }
  // tiles of 8 rows (verify always: one instantiation fewer to build)
  const size_t smem = sizeof(float) * kWarps * 8 * (D + 2);
  paged_decode_kernel<T, INT8, DPL, 8, VERIFY>
      <<<dim3(B, a.Hkv, (n_q + 7) / 8), kWarps * 32, smem, stream>>>(a);
}

template <bool INT8, int D>
cudaError_t launch_chunk_tc(const Args& a, int B, int n_q,
                            cudaStream_t stream) {
  using L = typename ChunkTc<INT8, D>::L;
  auto kernel = paged_chunk_wgmma_kernel<INT8, D>;
  // shared memory above 48 KB is opt-in, per kernel
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::alloc);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, a.Hkv, (n_q + kTcRows - 1) / kTcRows),
           ChunkTc<INT8, D>::kThreads,
           L::alloc, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool INT8, int DPL>
cudaError_t launch(const Args& a, int B, int kernel, cudaStream_t stream) {
  constexpr int D = DPL * 32;
  const int n_q = a.C * (a.H / a.Hkv);
  // bf16 chunks of D 64 and 128 run on the tensor cores (kernel 3) only
  constexpr bool kTc = std::is_same_v<T, __nv_bfloat16> && D >= 64;
  if (kernel == 3 || (kTc && kernel == 1)) {
    if constexpr (kTc) {
      if (kernel == 3) return launch_chunk_tc<INT8, D>(a, B, n_q, stream);
    }
    return cudaErrorInvalidValue;
  }
  if (kernel == 0) {
    launch_decode<T, INT8, DPL, false>(a, B, n_q, stream);
    return cudaGetLastError();
  }
  if (kernel == 2) {
    launch_decode<T, INT8, DPL, true>(a, B, n_q, stream);
    return cudaGetLastError();
  }
  if constexpr (!kTc) {
    const int warps = std::min(kWarps, (n_q + kChunkRows - 1) / kChunkRows);
    const int rows_per_block = warps * kChunkRows;
    const dim3 grid(B, a.Hkv, (n_q + rows_per_block - 1) / rows_per_block);
    const size_t smem = 2 * sizeof(float) * static_cast<size_t>(a.ps) * D;
    paged_chunk_kernel<T, INT8, DPL><<<grid, warps * 32, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, bool INT8>
cudaError_t dispatch_dim(int D, const Args& a, int B, int kernel,
                         cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, INT8, 1>(a, B, kernel, stream);
    case 64:
      return launch<T, INT8, 2>(a, B, kernel, stream);
    case 128:
      return launch<T, INT8, 4>(a, B, kernel, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// kernel: 0 = paged_decode_kernel (at most 8 query rows per (slot, KV
// head), C * H / Hkv <= 8), 1 = paged_chunk_kernel (any number; f32, or
// bf16 at D 32), 2 = the
// verify variant (paged_decode_kernel<VERIFY>, any number of rows; needs
// extra_k / extra_v, and takes W == 0: only the in-flight rows), 3 =
// paged_chunk_wgmma_kernel (any number; bf16 only, D 64 or 128).
// dtype: 0 = float32, 1 = bfloat16 (q, out, verbatim pools, extra rows).
// int8: 1 when the pools are int8 payloads with f32 block scales, whose
// block width blk must be a multiple of 4. q, out, the pools and the
// extra rows are 16-byte aligned (vector loads); tables and positions
// 4-byte. Returns a cudaError_t (0 = launched).
int dlrover_paged_attention(const void* q, void* out, const void* k_pool,
                            const void* v_pool, const void* k_scale,
                            const void* v_scale, const void* tables,
                            const void* positions, const void* extra_k,
                            const void* extra_v, int B, int C, int H,
                            int Hkv, int D, int ps, int W, int tab_stride,
                            int blk, int window, float scale, int dtype,
                            int int8, int kernel, void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || H % Hkv || ps <= 0 || ps > 32 ||
      W < (kernel == 2 ? 0 : 1) || W > tab_stride ||
      (int8 && (blk <= 0 || blk % 4 || (Hkv * D) % blk)) ||
      kernel < 0 || kernel > 3 || (kernel == 0 && C * (H / Hkv) > 8) ||
      (kernel == 2 && (extra_k == nullptr || extra_v == nullptr)))
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.out = out;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.tables = static_cast<const int*>(tables);
  a.positions = static_cast<const int*>(positions);
  a.extra_k = extra_k;
  a.extra_v = extra_v;
  a.C = C;
  a.H = H;
  a.Hkv = Hkv;
  a.ps = ps;
  a.W = W;
  a.tab_stride = tab_stride;
  a.blk = int8 ? blk : 1;
  a.window = window;
  a.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return int8 ? dispatch_dim<__nv_bfloat16, true>(D, a, B, kernel, st)
                : dispatch_dim<__nv_bfloat16, false>(D, a, B, kernel, st);
  if (dtype == 0)
    return int8 ? dispatch_dim<float, true>(D, a, B, kernel, st)
                : dispatch_dim<float, false>(D, a, B, kernel, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
