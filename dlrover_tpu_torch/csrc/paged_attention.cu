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
// What bounds it: at decode and verify, the bytes of the pages a slot
// holds: each K/V element serves only the `groups` query heads of its KV
// head (times the chunk's rows in verify), a few FLOPs per byte, far below
// the card's ~295 FLOP/byte ridge. A 256-row prefill chunk reuses each
// element 4 * 256 times and is bound by operations on the tensor cores:
// in bf16 it runs on the Hopper core of attn_fwd_core.cuh
// (paged_chunk_wgmma_kernel below: wgmma, P in registers, pages gathered
// under the products); the f32 and D 32 calls keep the CUDA-core chunk
// kernel. What the designs do about the bytes: a page is read once per row
// tile and only where it can hold a key some row of the tile may see
// (unassigned pages and keys outside [min_pos - window + 1, max_pos] are
// skipped); int8 pages are read at one byte per element and dequantized
// on the card.
//
// Query rows are ordered (c, g) as in the TPU kernel: H is KV-head-major,
// so query head h belongs to KV head h / groups, and row r of KV head kh is
// chunk row r / groups, head kh * groups + r % groups. A loop over the
// table columns inside a block takes the place of the TPU's sequential
// grid axis and its m/l/acc scratch; each block reads its own table row and
// positions (the TPU's scalar prefetch). The caller names the kernel to
// launch (the Python wrapper picks by the number of query rows per (slot,
// KV head), n_q = C * groups, and by dtype and D; it counts the launches
// under the variant the rows pick, "decode" or "chunk", and under
// "verify" for the verify variant):
//
// - paged_decode_split_kernel (n_q <= 8: decode; and every verify call, as
//   its VERIFY instantiation). Grid (split, KV head x tile of 8 rows, or
//   32 in verify, slot): the walk of each row tile is split across blocks
//   over contiguous table columns, K/V stages of 32 keys arrive by
//   cp.async, and the last split to finish merges the partial states; see
//   its section. In verify,
//   held keys serve only below start (the chunk's first position: cells at
//   chunk positions may hold an evicted tenant's or a copy-on-write donor's
//   stale rows), and the C in-flight rows (extra_k / extra_v [B, C, Hkv,
//   D], the compute type) are folded once per row after the merge.
// - paged_chunk_wgmma_kernel (n_q > 8, bf16, D 64 or 128: prefill
//   chunks). Grid (split, KV head x tile of 128 rows, slot): the walk of
//   each row tile split across blocks as in decode; see its section.
// - paged_chunk_kernel (n_q > 8, f32 or D 32). Grid (slot, KV head,
//   tile of 32 rows). Each warp holds 4 rows; the block stages one page's
//   K and V for its KV head in shared memory (f32) and every warp reuses
//   it, so a page is read once per 32 rows. Its scores are a warp-shuffle
//   reduction per key; lane i keeps key i's score, so a group of up to 32
//   keys is one max/exp/sum step of the online softmax.
//
// Interface: a plain C function, launched on the caller's stream; it
// allocates nothing (the split kernel's workspace is the caller's) and
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_fwd_core.cuh"

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;         // warps per block, paged_chunk_kernel
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
  float* part;           // split kernel: f32 partial (m, l, acc) per split
  int* counters;         // split kernel: finished splits per row tile
  int C, H, Hkv, ps, W, tab_stride, blk, window;
  int splits;            // split kernel: blocks sharing a row tile's walk
  int n_sc;              // split kernel, int8: most scale blocks a head spans
  float scale;
};

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
// the next pages; the walk is split across blocks so that a lone prefill
// chunk fills the card.
//
// - Grid (split, KV head x tile of 128 query rows, slot): a row tile is
//   two consumer warpgroups of 64 rows, rows in the (c, g) order above.
//   The keys the tile's rows may see, [min_pos - window + 1, max_pos] cut
//   to the table, are T tiles of 64 keys from the first; split s of S
//   walks tiles [s T / S, (s + 1) T / S) (ops/paged_attention.py
//   chunk_split_keys is the plain twin). Splitting the visible keys, not
//   the table columns as decode does, keeps the splits even where a
//   window or the page bucket leaves most columns unseen. S comes from
//   the launch shape alone (ops/paged_attention.py plan_chunk_splits: one
//   wave of blocks), never from positions or tables, so a call needs no
//   device read and can be captured in a graph. llama3-8b's prefill chunk
//   (B 1, C 256) has 64 row tiles: 64 blocks left half the SMs idle.
// - A tile is published only if it holds a key on an assigned page inside
//   the split's range, with a mask of such keys (Meta::valid); no other
//   key is read (its rows are zero-filled and masked). bf16 pages are
//   gathered by cp.async straight into the swizzled tile, completing on
//   the stage's mbarrier.
// - int8 pages take two producer warpgroups with one role each. The copy
//   warpgroup gathers a tile's payloads and f32 block scales by cp.async
//   into one of kStgBufs staging buffers, up to kStgBufs tiles ahead,
//   completing on the buffer's `landed` mbarrier
//   (cp.async.mbarrier.arrive.noinc); the convert warpgroup waits there,
//   dequantizes the buffer into a ring stage exactly as kv_value does (f32,
//   rounded to bf16: dequant4) and releases it on its `freed` mbarrier.
//   Each waits only on the other's barrier. When a scale block spans a
//   whole number of 16-element chunks (blk % 16 == 0), a key row's scales
//   for its KV head are copied once a row, not once a chunk, and a
//   converter holds one scale a chunk.
// - The mask (ChunkMask) is one key range [pos - window + 1, pos] a row
//   ([0, pos] without a window), computed once, ANDed with the tile's key
//   mask: two compares, a bit test and a select a score.
// - With S > 1 each split writes its rows' partial (m, l, acc) in f32 to
//   the caller's workspace; the last split block of a row tile to finish
//   (an atomic counter after a __threadfence, reset by that block for the
//   next call) merges the partials in split order 0 .. S - 1 and writes
//   the output. So a row's result does not depend on which block finishes
//   last: a call repeats bit for bit. With S == 1 the block writes its
//   output directly.
//
// The D 32 and f32 calls keep paged_chunk_kernel (wgmma needs 16-element
// k-steps of a 64-element swizzle row; the f32 model checks need f32
// math).

namespace ac = attn_core;

constexpr int kTcRows = ac::kRows * ac::kConsumers;  // query rows a tile
constexpr int kTcKeys = 64;                          // keys a K/V tile
// int8 staging buffers (D 128: 32 KB each; three bring the block to 225 KB
// of the 227 KB it can have)
constexpr int kStgBufs = 3;

template <bool INT8, int D>
struct ChunkTc {
  // producer warpgroups: int8 pages take a copy and a convert warpgroup
  static constexpr int kProducers = INT8 ? 2 : 1;
  static constexpr int kThreads = ac::block_threads(kProducers);
  // int8 staging, per buffer: K, V payloads [64 keys][D]; then K, V scale
  // slots, [64 keys][D / 4] f32
  static constexpr int kStg = INT8 ? 4 * kTcKeys * D : 0;
  static constexpr int kBufs = INT8 ? kStgBufs : 0;
  // after the staging buffers: the buffers' landed and freed barriers,
  // their tile records (first key, key mask), the merge's flag
  static constexpr int kCtl = kBufs * kStg;
  static constexpr int landed = kCtl;
  static constexpr int freed = kCtl + 32;
  static constexpr int rec = kCtl + 64;
  static constexpr int flag = kCtl + 128;
  using L = ac::Layout<D, kTcKeys, kCtl + 144>;
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

// What a consumer thread's rows see: keys [lo, hi] (hi < lo: none; a row
// past the chunk sees none), ANDed with the tile's key mask. whole():
// every row of this warp sees every key of the tile. tile(): the ranges
// relative to this thread's first key k0 + 2t, and the mask from there.
struct ChunkMask {
  int lo[2], hi[2];
  int wlo, whi;  // keys every row of this warp sees: [wlo, whi]
  int t2;        // 2t
  struct Tile {
    int lo[2], hi[2];
    uint64_t valid;
  };
  __device__ __forceinline__ void init(const int (&pos)[2], int window) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      hi[i] = pos[i];  // -1 for a row past the chunk
      lo[i] = pos[i] < 0 ? 0 : window > 0 ? pos[i] - window + 1 : 0;
    }
    wlo = warp_max(max(lo[0], lo[1]));
    whi = warp_min(min(hi[0], hi[1]));
    t2 = 2 * (threadIdx.x & 3);
  }
  __device__ __forceinline__ bool whole(const ac::Meta& mt) const {
    return mt.valid == ~0ull && mt.k0 >= wlo && mt.k0 + kTcKeys - 1 <= whi;
  }
  __device__ __forceinline__ Tile tile(const ac::Meta& mt) const {
    const int k0 = mt.k0 + t2;
    return {{lo[0] - k0, lo[1] - k0}, {hi[0] - k0, hi[1] - k0},
            mt.valid >> t2};
  }
  __device__ __forceinline__ bool allowed(const Tile& tv, int i,
                                          int c) const {
    return (c >= tv.lo[i]) & (c <= tv.hi[i]) &
           static_cast<bool>((tv.valid >> c) & 1);
  }
};

// 4 int8 (one 32-bit word) times a scale, in f32: kv_value's arithmetic
// for f32 compute. The int8 -> f32 conversion is exact and off the
// conversion unit: byte b ^ 0x80 placed under the exponent of 2^23 is the
// float 2^23 + 128 + b.
__device__ __forceinline__ void dequant4f(uint32_t w, float s, float (&f)[4]) {
  const uint32_t biased = w ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = (__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + e)) -
            8388736.f) * s;
}

// The same, each rounded to bf16, as two packed pairs: kv_value's
// arithmetic for bf16 compute.
__device__ __forceinline__ uint2 dequant4(uint32_t w, float s) {
  float f[4];
  dequant4f(w, s, f);
  return make_uint2(ac::pack_bf16(f[0], f[1]), ac::pack_bf16(f[2], f[3]));
}

// The tile records the int8 copy warpgroup hands the convert warpgroup
// with each staging buffer (k0 < 0 ends the walk).
struct StgRec {
  int k0;
  int pad;
  uint64_t mask;
};

// The producers of paged_chunk_wgmma_kernel. The copying warpgroup (the
// only one for bf16 pages; warpgroup 0 for int8) walks the split's tiles,
// each warp alike: lane l holds the table entries of keys l and l + 32 of
// a tile (loaded a tile ahead), a ballot makes the tile's key mask, and a
// thread copying a chunk of key k takes k's pool cell from lane k % 32 by
// a shuffle, so the gather itself reads no table. For int8 pages
// warpgroup 1 converts.
template <bool INT8, int D>
__device__ __forceinline__ void chunk_tc_producer(const Args& a,
                                                  uint32_t base, int b,
                                                  int kh, int row0,
                                                  int split) {
  using C = ChunkTc<INT8, D>;
  using L = typename C::L;
  const int wg = threadIdx.x / 128;
  const int pt = threadIdx.x - 128 * wg;  // 0 .. 127
  const int lane = pt & 31;
  auto stg = [&](int buf) { return base + L::extra + buf * C::kStg; };
  auto landed = [&](int buf) { return base + L::extra + C::landed + 8 * buf; };
  auto freed = [&](int buf) { return base + L::extra + C::freed + 8 * buf; };
  auto rec = [&](int buf) {
    return reinterpret_cast<volatile StgRec*>(
        ac::smem_ptr(base + L::extra + C::rec + 16 * buf));
  };
  const int kpay = kTcKeys * D;  // bytes of a staged payload tile
  const int row_elems = a.Hkv * D;
  const int sb0 = kh * D / a.blk;  // the KV head's first scale block

  if constexpr (INT8) {
    if (wg == 1) {
      // the convert warpgroup: each landed buffer, dequantized into the
      // next ring stage (keys outside the mask as zeros), then freed
      constexpr int kChunks = D / 16;  // 16-element chunks of a key row
      constexpr int kPer = kTcKeys * kChunks / 128;  // chunks a thread
      static_assert(128 % kChunks == 0, "one chunk column a thread");
      const int c = pt % kChunks;  // every unit's chunk column
      const bool one_scale = a.blk % 16 == 0;  // a chunk lies in one block
      const int slot = (kh * D + c * 16) / a.blk - sb0;
      ac::Ring ring;
      for (int n = 0;; ++n) {
        const int buf = n % kStgBufs;
        ac::mbar_wait(landed(buf), (n / kStgBufs) & 1);
        const int k0 = rec(buf)->k0;
        const uint64_t m = rec(buf)->mask;
        ac::wait_empty<L>(base, ring);
        if (k0 < 0) {
          if (pt == 0) ac::write_meta<L>(base, ring.stage, -1, 0);
          ac::mbar_arrive(base + L::full + 8 * ring.stage);
          return;
        }
        const uint32_t s0 = stg(buf);
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          // per tensor, every load of the thread's chunks first, then the
          // math; a scale a chunk (blk % 16 == 0), else one a 4-element
          // group, read again below
          uint4 w[kPer];
          float x[kPer];
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int key = (pt + 128 * u) / kChunks;
            w[u] = *reinterpret_cast<const uint4*>(
                ac::smem_ptr(s0 + kv * kpay + key * D + c * 16));
            x[u] = *reinterpret_cast<const float*>(
                ac::smem_ptr(s0 + (2 + kv) * kpay + key * D +
                             (one_scale ? 4 * slot : c * 16)));
          }
          const uint32_t tile = kv ? L::v_tile(base, ring.stage)
                                   : L::k_tile(base, ring.stage);
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int key = (pt + 128 * u) / kChunks;
            uint4 lo16 = make_uint4(0u, 0u, 0u, 0u), hi16 = lo16;
            if ((m >> key) & 1) {
              float4 sc = make_float4(x[u], x[u], x[u], x[u]);
              if (!one_scale)
                sc = *reinterpret_cast<const float4*>(ac::smem_ptr(
                    s0 + (2 + kv) * kpay + key * D + c * 16));
              const uint2 e0 = dequant4(w[u].x, sc.x);
              const uint2 e1 = dequant4(w[u].y, sc.y);
              const uint2 e2 = dequant4(w[u].z, sc.z);
              const uint2 e3 = dequant4(w[u].w, sc.w);
              lo16 = make_uint4(e0.x, e0.y, e1.x, e1.y);
              hi16 = make_uint4(e2.x, e2.y, e3.x, e3.y);
            }
            *reinterpret_cast<uint4*>(
                ac::smem_ptr(tile + ac::swz<kTcKeys>(key, 2 * c))) = lo16;
            *reinterpret_cast<uint4*>(
                ac::smem_ptr(tile + ac::swz<kTcKeys>(key, 2 * c + 1))) = hi16;
          }
        }
        ac::fence_proxy_async();  // the generic-proxy stores, read by wgmma
        if (pt == 0) ac::write_meta<L>(base, ring.stage, k0, m);
        ac::mbar_arrive(base + L::full + 8 * ring.stage);
        ac::mbar_arrive(freed(buf));
        ring.advance();
      }
    }
  }

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
  // the split's keys [kbeg, kend]: split s of S takes tiles [s T / S,
  // (s + 1) T / S) of the T tiles of 64 keys that cover the keys some row
  // of the tile may see, [lo - window + 1, hi] cut to the table
  const int k_lo = a.window > 0 ? max(0, lo - a.window + 1) : 0;
  const int k_hi = min(hi, a.W * a.ps - 1);
  const int n_all = k_hi >= k_lo ? (k_hi - k_lo) / kTcKeys + 1 : 0;
  const int t0 = split * n_all / a.splits;
  const int n_tiles = (split + 1) * n_all / a.splits - t0;
  const int kbeg = k_lo + t0 * kTcKeys;
  const int kend = min(k_hi, kbeg + n_tiles * kTcKeys - 1);

  // the table entry of key kpos of the walk (-1 past it)
  auto entry = [&](int kpos) { return kpos <= kend ? tab[kpos / a.ps] : -1; };
  // key k's pool cell, from the lane holding it
  auto cell_of = [&](int key, int cell_lo, int cell_hi) {
    const int x = __shfl_sync(0xffffffffu, cell_lo, key & 31);
    const int y = __shfl_sync(0xffffffffu, cell_hi, key & 31);
    return static_cast<size_t>(key < 32 ? x : y);
  };
  // every live tile in order: f(k0, mask, cell_lo, cell_hi); a key is
  // read iff its page is assigned and it lies in [kbeg, kend]
  auto walk = [&](auto&& f) {
    int pg_lo = entry(kbeg + lane);
    int pg_hi = entry(kbeg + 32 + lane);
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = kbeg + t * kTcKeys;
      const int k_lo = k0 + lane, k_hi = k_lo + 32;
      // the next tile's entries, in flight while this tile is copied
      const int nx_lo = entry(k_lo + kTcKeys);
      const int nx_hi = entry(k_hi + kTcKeys);
      const uint32_t m0 = __ballot_sync(0xffffffffu, pg_lo >= 0);
      const uint32_t m1 = __ballot_sync(0xffffffffu, pg_hi >= 0);
      const uint64_t mask = m0 | (static_cast<uint64_t>(m1) << 32);
      if (mask)
        f(k0, mask, pg_lo * a.ps + k_lo % a.ps, pg_hi * a.ps + k_hi % a.ps);
      pg_lo = nx_lo;
      pg_hi = nx_hi;
    }
  };

  if constexpr (!INT8) {
    ac::Ring ring;
    const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k_pool);
    const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v_pool);
    constexpr int kChunks = D / 8;  // 16-byte chunks of a key row
    auto publish = [&](int k0, uint64_t mask) {
      const uint32_t full = base + L::full + 8 * ring.stage;
      if (pt == 0) {
        ac::write_meta<L>(base, ring.stage, k0, mask);
        ac::mbar_arrive(full);
      }
      ac::cp_async_arrive(full);
    };
    walk([&](int k0, uint64_t mask, int cell_lo, int cell_hi) {
      ac::wait_empty<L>(base, ring);
      const uint32_t kt = L::k_tile(base, ring.stage);
      const uint32_t vt = L::v_tile(base, ring.stage);
#pragma unroll
      for (int i = pt; i < kTcKeys * kChunks; i += 128) {
        const int key = i / kChunks, c = i % kChunks;
        const bool ok = (mask >> key) & 1;
        const size_t cell = cell_of(key, cell_lo, cell_hi);
        const size_t off = ok ? (cell * a.Hkv + kh) * D + c * 8 : 0;
        ac::cp_async16(kt + ac::swz<kTcKeys>(key, c), kp + off, ok);
        ac::cp_async16(vt + ac::swz<kTcKeys>(key, c), vp + off, ok);
      }
      publish(k0, mask);
      ring.advance();
    });
    ac::wait_empty<L>(base, ring);
    publish(-1, 0);
  } else {
    // the copy threads: tile n's payloads and scales into staging buffer
    // n % kStgBufs once the convert threads have freed it
    const int8_t* kp = static_cast<const int8_t*>(a.k_pool);
    const int8_t* vp = static_cast<const int8_t*>(a.v_pool);
    constexpr int kChunks = D / 16;  // 16-element chunks of a key row
    const int nb = row_elems / a.blk;
    const bool one_scale = a.blk % 16 == 0;
    const int n_sc_kh = (kh * D + D - 1) / a.blk - sb0 + 1;
    int n = 0;
    auto take = [&]() {  // the next buffer, once freed
      const int buf = n % kStgBufs;
      if (n >= kStgBufs) ac::mbar_wait(freed(buf), (n / kStgBufs - 1) & 1);
      return buf;
    };
    auto hand_over = [&](int buf, int k0, uint64_t mask) {
      if (pt == 0) {
        rec(buf)->k0 = k0;
        rec(buf)->mask = mask;
        ac::mbar_arrive(landed(buf));
      }
      ac::cp_async_arrive(landed(buf));
      ++n;
    };
    walk([&](int k0, uint64_t mask, int cell_lo, int cell_hi) {
      const int buf = take();
      const uint32_t s0 = stg(buf);
#pragma unroll
      for (int i = pt; i < kTcKeys * kChunks; i += 128) {
        const int key = i / kChunks, c = i % kChunks;
        const size_t cell = cell_of(key, cell_lo, cell_hi);
        if (!((mask >> key) & 1)) continue;
        const size_t off = cell * row_elems + kh * D + c * 16;
        ac::cp_async16(s0 + key * D + c * 16, kp + off, true);
        ac::cp_async16(s0 + kpay + key * D + c * 16, vp + off, true);
        if (!one_scale) {  // a scale a 4-element group
          const uint32_t sa = s0 + 2 * kpay + key * D + c * 16;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const size_t si = cell * nb + (kh * D + c * 16 + 4 * g) / a.blk;
            ac::cp_async4(sa + 4 * g, a.k_scale + si);
            ac::cp_async4(sa + kpay + 4 * g, a.v_scale + si);
          }
        }
      }
      if (one_scale) {  // a key row's scale blocks, once a row
        for (int u = 0; u * 128 < kTcKeys * a.n_sc; ++u) {
          const int i = pt + 128 * u;
          const int key = min(i / a.n_sc, kTcKeys - 1), j = i % a.n_sc;
          const size_t cell = cell_of(key, cell_lo, cell_hi);
          if (i < kTcKeys * a.n_sc && j < n_sc_kh && ((mask >> key) & 1)) {
            const size_t si = cell * nb + sb0 + j;
            const uint32_t sa = s0 + 2 * kpay + key * D + 4 * j;
            ac::cp_async4(sa, a.k_scale + si);
            ac::cp_async4(sa + kpay, a.v_scale + si);
          }
        }
      }
      hand_over(buf, k0, mask);
    });
    hand_over(take(), -1, 0);  // the end of the walk
  }
}

template <bool INT8, int D>
__global__ void __launch_bounds__(ChunkTc<INT8, D>::kThreads, 1)
    paged_chunk_wgmma_kernel(const Args args) {
  // a copy the lambdas below capture: capturing the kernel parameter
  // itself takes its address and turns every field read into a load
  const Args a = args;
  using C = ChunkTc<INT8, D>;
  using L = typename C::L;
  constexpr int kProducers = C::kProducers;
  const uint32_t base = ac::smem_base();
  if (INT8 && threadIdx.x == 0) {  // fenced and synced by init_barriers
    for (int buf = 0; buf < kStgBufs; ++buf) {
      // landed: the copy warpgroup's 128 cp.async arrivals and its
      // thread 0's, which writes the record; freed: the 128 converters
      ac::mbar_init(base + L::extra + C::landed + 8 * buf, 129);
      ac::mbar_init(base + L::extra + C::freed + 8 * buf, 128);
    }
  }
  // full: the int8 converters' 128 arrivals; the bf16 producer's 128
  // cp.async arrivals and thread 0's, which publishes the Meta
  ac::init_barriers<L>(base, INT8 ? 128 : 129);
  const int wg = threadIdx.x / 128;
  const int split = blockIdx.x;
  const int kh = blockIdx.y % a.Hkv;
  const int row0 = (blockIdx.y / a.Hkv) * kTcRows;
  const int b = blockIdx.z;
  const int groups = a.H / a.Hkv;
  const int n_q = a.C * groups;
  // registers: the block starts with 65536 / threads a thread (168 at
  // 384 threads, 128 at 512); what the producers give up, the consumers
  // take: 128 * 56 + 256 * 224 = 384 * 168, 256 * 56 + 256 * 200 = 512 * 128
  if (wg < kProducers) {
    ac::setmaxnreg_dec<56>();
    chunk_tc_producer<INT8, D>(a, base, b, kh, row0, split);
    return;
  }
  ac::setmaxnreg_inc<kProducers == 1 ? 224 : 200>();
  const int ct = threadIdx.x - 128 * wg;
  const int warp = ct / 32, lane = ct % 32, g = lane >> 2, t = lane & 3;
  const int cw = wg - kProducers;  // consumer warpgroup 0 or 1
  const int wr0 = row0 + cw * ac::kRows;
  int rows[2], pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = wr0 + warp * 16 + g + 8 * i;
    pos[i] = rows[i] < n_q ? a.positions[(size_t)b * a.C + rows[i] / groups]
                           : -1;
  }
  ChunkMask pol;
  pol.init(pos, a.window);
  const uint32_t q_tile = base + L::q + cw * L::kQTile;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  ac::load_q<D>(q_tile, ct, [&](int r) -> const __nv_bfloat16* {
    const int row = wr0 + r;
    if (row >= n_q) return nullptr;
    return q + (((size_t)b * a.C + row / groups) * a.H + kh * groups +
                row % groups) * D;
  }, 1 + cw);
  ac::State<D> st;
  const float scale_log2 = a.scale * ac::kLog2e;
  ac::consume<D, L>(base, q_tile, pol, scale_log2, st);

  if (a.splits > 1) {
    // this split's partial (m, l, acc) of the tile's 128 rows: acc
    // [splits][128][D], then (m, l) [splits][128][2], f32, by row tile
    const int S = a.splits;
    const size_t n_bk = (size_t)gridDim.y * gridDim.z;
    const size_t bk = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
    float* p_acc = a.part + bk * S * kTcRows * D;
    float* p_ml = a.part + n_bk * S * kTcRows * D + bk * S * kTcRows * 2;
    int r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r[i] = cw * ac::kRows + warp * 16 + g + 8 * i;
      float* dst = p_acc + ((size_t)split * kTcRows + r[i]) * D + 2 * t;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<float2*>(dst + nt * 8) =
            make_float2(st.o[nt * 4 + 2 * i], st.o[nt * 4 + 2 * i + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(p_ml + ((size_t)split * kTcRows + r[i]) *
                                              2) =
            make_float2(st.m[i], st.l[i]);
    }
    __threadfence();
    ac::named_sync(3, 128 * ac::kConsumers);
    volatile int* last = reinterpret_cast<volatile int*>(
        ac::smem_ptr(base + L::extra + C::flag));
    if (cw == 0 && ct == 0) {
      const int done = atomicAdd(a.counters + bk, 1);
      *last = done == S - 1;
      if (done == S - 1) a.counters[bk] = 0;  // ready for the next call
    }
    ac::named_sync(3, 128 * ac::kConsumers);
    if (!*last) return;
    __threadfence();
    // the merge, in split order: m the largest partial m, each split's
    // factor 2^((m_s - m) * scale * log2(e)), l and acc summed
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m = ac::kNegInf;
      for (int s = 0; s < S; ++s)
        m = fmaxf(m, __ldcg(p_ml + ((size_t)s * kTcRows + r[i]) * 2));
      float l = 0.f;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        st.o[nt * 4 + 2 * i] = st.o[nt * 4 + 2 * i + 1] = 0.f;
      for (int s = 0; s < S; ++s) {
        const float2 ml = __ldcg(reinterpret_cast<const float2*>(
            p_ml + ((size_t)s * kTcRows + r[i]) * 2));
        const float f = ac::ex2((ml.x - m) * scale_log2);
        l += ml.y * f;
        const float* src = p_acc + ((size_t)s * kTcRows + r[i]) * D + 2 * t;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          const float2 x =
              __ldcg(reinterpret_cast<const float2*>(src + nt * 8));
          st.o[nt * 4 + 2 * i] += x.x * f;
          st.o[nt * 4 + 2 * i + 1] += x.y * f;
        }
      }
      st.m[i] = m;
      st.l[i] = l;
    }
  }
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
// decode and verify: the page walk split across blocks (flash-decoding)
// ---------------------------------------------------------------------------
//
// paged_decode_split_kernel replaces the "decode" and "verify" variants of
// dlrover_tpu/ops/pallas_paged.py::_paged_kernel (l.300; pallas_call l.558)
// for calls of at most 8 query rows per (slot, KV head), and for every
// verify call. What bounds it: the bytes of the pages a slot holds (a
// llama3-8b decode of 8 slots up to position 2047 over int8 pages moves
// ~12 MB, 3.6 us at the HBM rate; each K/V element serves only the 4 query
// heads of its KV head). What the design does about it:
//
// - Grid (split, KV head x row tile, slot). A row tile is up to 8 query
//   rows of one (slot, KV head) in decode (llama3-8b: 4) and up to 32 in
//   verify (a spec_k=4 chunk at llama3-8b: 20); more rows take more tiles.
//   Each split walks a contiguous range of table columns (split s of S:
//   [s W / S, (s + 1) W / S)), so a lone long request still fills the
//   card; S is planned on the host from the launch shape alone
//   (ops/paged_attention.py plan_splits: about 8 blocks an SM, at least
//   two stages a split, at most 64 splits), never from positions or
//   tables, so a call needs no device read and can be captured in a graph.
// - Keys arrive 32 a stage through a cp.async ring of 3 stages (2 for f32
//   pools) in shared memory. Lane i of every warp holds the table entry of
//   key i of a stage (loaded a stage ahead; without a window the first
//   ones load beside the positions); a ballot makes the stage's key mask
//   and the copying threads take their key's pool cell by a shuffle. Only
//   keys on assigned pages inside the row tile's visible range
//   [min_pos - window + 1, max_pos] (and below the chunk's start in
//   verify) are read; a stage with none is skipped. int8 payloads arrive
//   with their f32 block scales and are dequantized once per element into
//   a compute-type tile, rounded as kv_value does.
// - Q.K^T: for bf16 queries on mma.sync (m16n8k16, bf16 operands from
//   shared memory, f32 accumulate: the products of bf16 values are exact
//   in f32), warp w taking keys 8w .. 8w + 7 of the stage; for f32 on the
//   CUDA cores, lane i owning key i and q read from shared memory by
//   broadcast. Either way no score is a reduction across lanes. The online
//   softmax: warp w owns rows w, w + 4, ..., lane i key i; one warp max and
//   one warp sum per (row, stage). P.V on the CUDA cores: a thread owns 4
//   columns of D and a set of rows, reading p from shared memory. Scores,
//   softmax and P.V are f32; p is never rounded.
// - Each split writes its rows' partial (m, l, acc) in f32 to a workspace
//   the wrapper owns; the last split block of a row tile to finish (an
//   atomic counter after a __threadfence, reset by that block for the next
//   call) merges the partials in split order 0 .. S - 1 (the per-split
//   factors exp(m_s - m) in shared memory), folds the verify chunk's
//   in-flight rows once, after the merge, and writes the output. So a
//   row's result does not depend on which block finishes last, nor, beyond
//   f32 rounding, on S; with S == 1 the block goes straight on. One launch
//   a call.
//
// What is left (PERF.md): a block's fixed costs (the q load, the first
// table and page reads, the partial write and the merge) are a third of a
// decode block's time at S = 17, and the f32 P.V on the CUDA cores is most
// of verify's.
//
// Masks as in the TPU kernel: key kpos serves row r iff kpos <= pos[r]
// (and kpos > pos[r] - window); in verify held keys serve only below the
// chunk's start and in-flight key i serves row r iff pos[i] <= pos[r] (and
// the window). Masked probabilities are zeroed explicitly, and a row that
// sees no key comes out as exact zeros (l == 0 -> 1).

constexpr int kSplitThreads = 128;  // 4 warps
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitKeys = 32;      // keys a stage: lane i holds key i
constexpr int kMaxSplits = 64;      // the merge: two splits a lane
// query rows of a row tile: a decode's up to 8; a verify chunk's up to 32
__host__ __device__ constexpr int split_rows(bool verify) {
  return verify ? 32 : 8;
}

// Shared-memory layout (bytes) of paged_decode_split_kernel.
template <typename T, bool INT8, int D, bool VERIFY>
struct Split {
  using E = std::conditional_t<INT8, int8_t, T>;
  static constexpr int kRows = split_rows(VERIFY);
  static constexpr int kStages = sizeof(E) == 4 ? 2 : 3;
  // bf16 scores run on mma.sync (m16n8k16, f32 accumulate)
  static constexpr bool kMma = std::is_same_v<T, __nv_bfloat16>;
  static constexpr int kMTiles = (kRows + 15) / 16;  // mma row tiles
  // a key row of a compute-type tile, padded by 16 bytes: the 16-byte
  // reads of 8 lanes (8 keys) at one column, and the 4-byte fragment reads
  // of 8 rows x 4 lanes, fall in distinct banks
  static constexpr int kRowBytes = D * sizeof(T) + 16;
  static constexpr int kTile = kSplitKeys * kRowBytes;  // K or V
  static constexpr int kRaw = kSplitKeys * D;           // int8 payload
  // q: mma, bf16 rows (16 a row tile) padded as the key rows; else f32
  static constexpr int kQRows = kMma ? 16 * kMTiles : kRows;
  static constexpr int kQRowBytes = kMma ? kRowBytes : D * 4;
  static constexpr int q = 0;
  static constexpr int p = q + kQRows * kQRowBytes;     // f32 [rows][keys]
  static constexpr int row = p + kRows * kSplitKeys * 4;  // 2 x [rows]
  static constexpr int flags = row + 2 * kRows * 4;     // stage masks, last
  // int8: the compute-type K, V tiles, then the stages of raw payloads and
  // scales; otherwise the stages of compute-type K, V tiles
  static constexpr int tiles = flags + 16 * 4;
  static __host__ __device__ int scales_bytes(int n_sc) {
    return kSplitKeys * n_sc * 4;
  }
  static __host__ __device__ int stage_bytes(int n_sc) {
    return INT8 ? 2 * kRaw + 2 * scales_bytes(n_sc) : 2 * kTile;
  }
  static constexpr int ring = tiles + (INT8 ? 2 * kTile : 0);  // stages
  // the merge's per-split factors, f32 [2][rows][splits], past the ring
  static __host__ __device__ int merge_at(int n_sc) {
    return ring + kStages * stage_bytes(n_sc);
  }
  static __host__ int bytes(int n_sc, int splits) {
    return merge_at(n_sc) + (splits > 1 ? 2 * kRows * splits * 4 : 0);
  }
};

// C += A B on the tensor cores: m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 4 compute-type elements at a shared-memory address, as f32.
template <typename T>
__device__ __forceinline__ void load4(const unsigned char* src, float (&f)[4]) {
  if constexpr (std::is_same_v<T, float>) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(src);
    f[0] = __uint_as_float(w.x << 16);
    f[1] = __uint_as_float(w.x & 0xffff0000u);
    f[2] = __uint_as_float(w.y << 16);
    f[3] = __uint_as_float(w.y & 0xffff0000u);
  }
}

template <typename T, bool INT8, int D, bool VERIFY>
__global__ void __launch_bounds__(kSplitThreads)
    paged_decode_split_kernel(const Args args) {
  // a copy the lambdas below capture: capturing the kernel parameter
  // itself takes its address and turns every field read into a load
  const Args a = args;
  using L = Split<T, INT8, D, VERIFY>;
  constexpr int KT = kSplitKeys, RT = L::kRows, NST = L::kStages;
  constexpr int kQkRows = RT / kSplitWarps;  // rows a warp scores
  constexpr int kCg = D / 4;                 // P.V: column groups of 4
  constexpr int kRg = kSplitThreads / kCg;   // P.V: row groups
  constexpr int kPvRows = (RT + kRg - 1) / kRg;  // P.V: rows a thread
  extern __shared__ __align__(16) unsigned char sm[];
  const float* q_s = reinterpret_cast<const float*>(sm + L::q);  // f32 q
  float* p_s = reinterpret_cast<float*>(sm + L::p);
  float* a_s = reinterpret_cast<float*>(sm + L::row);  // alpha, merged m
  float* l_s = a_s + RT;
  uint32_t* flags = reinterpret_cast<uint32_t*>(sm + L::flags);
  const uint32_t base = ac::smem_u32(sm);

  const int split = blockIdx.x;
  const int kh = blockIdx.y % a.Hkv;
  const int row0 = (blockIdx.y / a.Hkv) * RT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = a.H / a.Hkv;
  const int nr = min(RT, a.C * groups - row0);  // rows of this tile
  const int* posb = a.positions + (size_t)b * a.C;
  auto q_index = [&](int r) {  // element offset of tile row r's query
    const int row = row0 + r;
    return (((size_t)b * a.C + row / groups) * a.H + kh * groups +
            row % groups) * D;
  };

  // the tile's query rows (rows past the tile as zeros): bf16 for the
  // mma fragments, else f32
  // (every load first, then the stores: one memory latency, not one per
  // row)
  const T* q = static_cast<const T*>(a.q);
  constexpr int kQVecs = L::kQRows * kCg;  // 4-element groups
  constexpr int kQPer = (kQVecs + kSplitThreads - 1) / kSplitThreads;
  Pack<T, 4> qx[kQPer];
#pragma unroll
  for (int u = 0; u < kQPer; ++u) {
    const int i = tid + u * kSplitThreads, r = i / kCg;
#pragma unroll
    for (int e = 0; e < 4; ++e) qx[u].e[e] = from_f32<T>(0.f);
    if (r < nr) qx[u] = load_pack<T, 4>(q + q_index(r) + (i % kCg) * 4);
  }
#pragma unroll
  for (int u = 0; u < kQPer; ++u) {
    const int i = tid + u * kSplitThreads, r = i / kCg, d = (i % kCg) * 4;
    if (i >= kQVecs) break;
    unsigned char* dst = sm + L::q + r * L::kQRowBytes;
    if constexpr (L::kMma) {
      *reinterpret_cast<Pack<T, 4>*>(dst + d * sizeof(T)) = qx[u];
    } else {
      *reinterpret_cast<float4*>(dst + d * 4) =
          make_float4(to_f32(qx[u].e[0]), to_f32(qx[u].e[1]),
                      to_f32(qx[u].e[2]), to_f32(qx[u].e[3]));
    }
  }

  // this warp's score rows (r = warp + 4 i) and their positions; -1 for a
  // row past the tile, which no key serves
  const int qk_rows = max(0, (nr - warp + kSplitWarps - 1) / kSplitWarps);
  int pos[kQkRows];
  float m[kQkRows], l[kQkRows];
#pragma unroll
  for (int i = 0; i < kQkRows; ++i) {
    const int r = warp + kSplitWarps * i;
    pos[i] = r < nr ? posb[(row0 + r) / groups] : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  // this thread's P.V rows (r = rg + kRg i) and columns
  const int cg = tid % kCg, rg = tid / kCg;
  const int pv_rows = max(0, (nr - rg + kRg - 1) / kRg);
  float acc[kPvRows][4];
#pragma unroll
  for (int i = 0; i < kPvRows; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  // One stage of keys through the online softmax: K and V tiles (compute
  // type, padded rows) in shared memory, lane i's key at kpos, present
  // iff key_ok.
  auto step = [&](const unsigned char* kt, const unsigned char* vt,
                  int kpos, bool key_ok) {
    float sc[kQkRows];  // the raw score of lane's key for each warp row
    if constexpr (L::kMma) {
      // S = Q K^T on the tensor cores: warp w takes keys 8w .. 8w + 7 of
      // every row tile; its scores go to p_s, read back by the rows' warps
      const int g = lane >> 2, t4 = lane & 3;
      const unsigned char* kb = kt + (warp * 8 + g) * L::kRowBytes + 4 * t4;
      const unsigned char* qb = sm + L::q + g * L::kQRowBytes + 4 * t4;
      float c[L::kMTiles][4];
#pragma unroll
      for (int mt = 0; mt < L::kMTiles; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kb + ks * 32);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kb + ks * 32 + 16);
#pragma unroll
        for (int mt = 0; mt < L::kMTiles; ++mt) {
          const unsigned char* qa = qb + mt * 16 * L::kQRowBytes + ks * 32;
          const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa);
          const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qa + 16);
          uint32_t a1 = 0u, a3 = 0u;
          if (mt * 16 + 8 < RT) {  // rows g + 8 of the tile exist
            a1 = *reinterpret_cast<const uint32_t*>(qa + 8 * L::kQRowBytes);
            a3 = *reinterpret_cast<const uint32_t*>(qa + 8 * L::kQRowBytes +
                                                    16);
          }
          mma_bf16(c[mt], a0, a1, a2, a3, b0, b1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < L::kMTiles; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + g + 8 * h;
          if (r < RT)
            *reinterpret_cast<float2*>(p_s + r * KT + warp * 8 + 2 * t4) =
                make_float2(c[mt][2 * h], c[mt][2 * h + 1]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kQkRows; ++i)
        sc[i] = p_s[(warp + kSplitWarps * i) * KT + lane];
    } else {
      float s[kQkRows][4];
#pragma unroll
      for (int i = 0; i < kQkRows; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
      const unsigned char* krow = kt + lane * L::kRowBytes;
      // the loop over D stays rolled: unrolled, the stage's code outgrows
      // the instruction cache
#pragma unroll 1
      for (int d0 = 0; d0 < D; d0 += 32) {
        float kf[32];  // T is f32 here
#pragma unroll
        for (int e = 0; e < 32; e += 4) {
          const float4 x =
              *reinterpret_cast<const float4*>(krow + (d0 + e) * 4);
          kf[e] = x.x;
          kf[e + 1] = x.y;
          kf[e + 2] = x.z;
          kf[e + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < kQkRows; ++i) {
          if (i < qk_rows) {
            const float* qr = q_s + (warp + kSplitWarps * i) * D + d0;
#pragma unroll
            for (int e = 0; e < 32; e += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qr + e);
              s[i][0] = fmaf(qq.x, kf[e], s[i][0]);
              s[i][1] = fmaf(qq.y, kf[e + 1], s[i][1]);
              s[i][2] = fmaf(qq.z, kf[e + 2], s[i][2]);
              s[i][3] = fmaf(qq.w, kf[e + 3], s[i][3]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kQkRows; ++i)
        sc[i] = (s[i][0] + s[i][1]) + (s[i][2] + s[i][3]);
    }
    // every row of the warp, present or not (a row past the tile has
    // position -1 and sees no key): no branch between the rows, so their
    // shuffle reductions overlap
#pragma unroll
    for (int i = 0; i < kQkRows; ++i) {
      {
        const int r = warp + kSplitWarps * i;
        bool ok = key_ok && kpos <= pos[i];
        if (a.window > 0) ok = ok && kpos > pos[i] - a.window;
        const float sv = ok ? sc[i] * a.scale : kNegInf;
        const float m_new = fmaxf(m[i], warp_max(sv));
        const float alpha = expf(m[i] - m_new);
        // zero masked probabilities explicitly: an all-masked stage would
        // otherwise add exp(kNegInf - kNegInf) = 1 per lane
        const float p = ok ? expf(sv - m_new) : 0.f;
        l[i] = alpha * l[i] + warp_sum(p);
        m[i] = m_new;
        p_s[r * KT + lane] = p;
        if (lane == 0) a_s[r] = alpha;
      }
    }
    __syncthreads();
    const unsigned char* vcol = vt + cg * 4 * sizeof(T);
#pragma unroll
    for (int i = 0; i < kPvRows; ++i) {
      if (i < pv_rows) {
        const float alpha = a_s[rg + kRg * i];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
      }
    }
    // the rows keep their branches here: P.V is most of verify's work, and
    // products for absent rows would cost more than the overlap gains
#pragma unroll 1
    for (int k = 0; k < KT; k += 4) {
      float vf[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) load4<T>(vcol + (k + j) * L::kRowBytes, vf[j]);
#pragma unroll
      for (int i = 0; i < kPvRows; ++i) {
        if (i < pv_rows) {
          const float4 pp =
              *reinterpret_cast<const float4*>(p_s + (rg + kRg * i) * KT + k);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float o = acc[i][c];
            o = fmaf(pp.x, vf[0][c], o);
            o = fmaf(pp.y, vf[1][c], o);
            o = fmaf(pp.z, vf[2][c], o);
            o = fmaf(pp.w, vf[3][c], o);
            acc[i][c] = o;
          }
        }
      }
    }
  };

  // ---- the split's walk -------------------------------------------------
  const int c0 = (int)((long long)split * a.W / a.splits);
  const int c1 = (int)((long long)(split + 1) * a.W / a.splits);
  const int* tab = a.tables + (size_t)b * a.tab_stride;
  // the table entry of key kpos of this split's columns (-1 past them)
  auto entry_at = [&](int kpos) {
    return kpos < c1 * a.ps ? tab[kpos / a.ps] : -1;
  };
  // without a window the walk starts at the split's first column: its
  // first entries load while the positions do
  int ent = a.window > 0 ? -1 : entry_at(c0 * a.ps + lane);
  int lo = INT_MAX, hi = INT_MIN;  // the tile's positions
  for (int c = row0 / groups + lane; c <= (row0 + nr - 1) / groups; c += 32) {
    lo = min(lo, posb[c]);
    hi = max(hi, posb[c]);
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  int k_hi = min(hi, a.W * a.ps - 1);
  if (VERIFY) k_hi = min(k_hi, posb[0] - 1);  // held keys below the start
  const int k_lo = a.window > 0 ? max(0, lo - a.window + 1) : 0;
  const int kbeg = max(c0 * a.ps, k_lo);
  const int kend = min(c1 * a.ps - 1, k_hi);
  const int n_tiles = kend >= kbeg ? (kend - kbeg) / KT + 1 : 0;
  if (a.window > 0) ent = entry_at(kbeg + lane);

  auto stage_at = [&](int st) { return L::ring + st * L::stage_bytes(a.n_sc); };
  unsigned char* tt = sm + L::tiles;  // int8: the compute-type K, V tiles
  const int row_elems = a.Hkv * D;
  const int nb = row_elems / a.blk;
  const int sb0 = INT8 ? kh * D / a.blk : 0;
  const int n_sc_kh = INT8 ? (kh * D + D - 1) / a.blk - sb0 + 1 : 0;

  // stage t's copies: lane i's entry is key i's page (loaded a stage
  // ahead); a key is read iff its page is assigned and it lies in the walk
  auto issue = [&](int t) {
    const int kpos = kbeg + t * KT + lane;
    const int nx = entry_at(kpos + KT);  // in flight while these copies go
    const int st = t % NST;
    const bool held = ent >= 0 && t < n_tiles && kpos <= kend;
    const int cell = held ? ent * a.ps + kpos % a.ps : 0;
    const uint32_t mask = __ballot_sync(0xffffffffu, held);
    if (tid == 0) flags[st] = mask;
    const uint32_t s0 = base + stage_at(st);
    if (mask) {
      if constexpr (!INT8) {
        constexpr int kCpk = D * sizeof(T) / 16;  // 16-byte chunks a key
        constexpr int kPer = KT * kCpk / kSplitThreads;
        const T* kp = static_cast<const T*>(a.k_pool);
        const T* vp = static_cast<const T*>(a.v_pool);
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int i = tid + u * kSplitThreads, key = i / kCpk, c = i % kCpk;
          const int cl = __shfl_sync(0xffffffffu, cell, key);
          const bool ok = (mask >> key) & 1;
          const size_t off =
              ok ? ((size_t)cl * a.Hkv + kh) * D + c * (16 / sizeof(T)) : 0;
          const uint32_t dst = s0 + key * L::kRowBytes + c * 16;
          ac::cp_async16(dst, kp + off, ok);
          ac::cp_async16(dst + L::kTile, vp + off, ok);
        }
      } else {
        constexpr int kCpk = D / 16;
        constexpr int kPer = (KT * kCpk + kSplitThreads - 1) / kSplitThreads;
        const int8_t* kp = static_cast<const int8_t*>(a.k_pool);
        const int8_t* vp = static_cast<const int8_t*>(a.v_pool);
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int i = tid + u * kSplitThreads;
          const int key = min(i / kCpk, KT - 1), c = i % kCpk;
          const int cl = __shfl_sync(0xffffffffu, cell, key);
          if (i < KT * kCpk && ((mask >> key) & 1)) {
            const size_t off = (size_t)cl * row_elems + kh * D + c * 16;
            const uint32_t dst = s0 + key * D + c * 16;
            ac::cp_async16(dst, kp + off, true);
            ac::cp_async16(dst + L::kRaw, vp + off, true);
          }
        }
        const uint32_t sc = s0 + 2 * L::kRaw;
        const int n_sc_copies = KT * a.n_sc;
        for (int u = 0; u * kSplitThreads < n_sc_copies; ++u) {
          const int i = tid + u * kSplitThreads;
          const int key = min(i / a.n_sc, KT - 1), j = i % a.n_sc;
          const int cl = __shfl_sync(0xffffffffu, cell, key);
          if (i < n_sc_copies && j < n_sc_kh && ((mask >> key) & 1)) {
            const size_t si = (size_t)cl * nb + sb0 + j;
            ac::cp_async4(sc + (key * a.n_sc + j) * 4, a.k_scale + si);
            ac::cp_async4(sc + L::scales_bytes(a.n_sc) + (key * a.n_sc + j) * 4,
                          a.v_scale + si);
          }
        }
      }
    }
    ac::cp_async_commit();
    ent = nx;
  };

  // int8: stage st's payloads, dequantized once, into the compute-type
  // tiles (keys outside the mask as zeros)
  // int8: the scale slot of each 4-element group of this thread's
  // 16-element chunk (the same chunk c = tid % (D / 16) in every unit)
  int slot[4] = {0, 0, 0, 0};
  if constexpr (INT8) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      slot[g] = (kh * D + (tid % (D / 16)) * 16 + 4 * g) / a.blk - sb0;
  }
  auto convert = [&](int st, uint32_t mask) {
    const unsigned char* s0 = sm + stage_at(st);
    constexpr int kCpk = D / 16;               // 16-element chunks a key
    constexpr int kUnits = 2 * KT * kCpk;      // K and V
    static_assert(kSplitThreads % kCpk == 0, "one chunk column a thread");
#pragma unroll
    for (int u = 0; u < kUnits / kSplitThreads; ++u) {
      const int i = tid + u * kSplitThreads;
      const int kv = i / (KT * kCpk), j = i % (KT * kCpk);
      const int key = j / kCpk, c = j % kCpk;
      unsigned char* dst = tt + kv * L::kTile + key * L::kRowBytes +
                           c * 16 * sizeof(T);
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      float sg[4] = {0.f, 0.f, 0.f, 0.f};
      if ((mask >> key) & 1) {
        w = *reinterpret_cast<const uint4*>(s0 + kv * L::kRaw + key * D +
                                            c * 16);
        const float* sc = reinterpret_cast<const float*>(
            s0 + 2 * L::kRaw + kv * L::scales_bytes(a.n_sc)) + key * a.n_sc;
#pragma unroll
        for (int g = 0; g < 4; ++g) sg[g] = sc[slot[g]];
      }
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
      if constexpr (std::is_same_v<T, float>) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float f[4];
          dequant4f(ws[g], sg[g], f);
          reinterpret_cast<float4*>(dst)[g] = make_float4(f[0], f[1], f[2], f[3]);
        }
      } else {
        const uint2 e0 = dequant4(ws[0], sg[0]), e1 = dequant4(ws[1], sg[1]);
        const uint2 e2 = dequant4(ws[2], sg[2]), e3 = dequant4(ws[3], sg[3]);
        reinterpret_cast<uint4*>(dst)[0] = make_uint4(e0.x, e0.y, e1.x, e1.y);
        reinterpret_cast<uint4*>(dst)[1] = make_uint4(e2.x, e2.y, e3.x, e3.y);
      }
    }
  };

#pragma unroll
  for (int t = 0; t < NST - 1; ++t) issue(t);
  for (int t = 0; t < n_tiles; ++t) {
    ac::cp_async_wait<NST - 2>();  // this thread's copies of stage t
    __syncthreads();               // everyone's; and stage t - 1 is free
    issue(t + NST - 1);
    const int st = t % NST;
    const uint32_t mask = flags[st];
    if (!mask) continue;  // uniform: no key of the stage is held
    const unsigned char* kt = sm + stage_at(st);
    if constexpr (INT8) {
      convert(st, mask);
      __syncthreads();
      kt = tt;
    }
    step(kt, kt + L::kTile, kbeg + t * KT + lane, (mask >> lane) & 1);
  }
  ac::cp_async_wait<0>();

  // ---- partials, and the merge by the last split to finish --------------
  if (a.splits > 1) {
    const size_t n_bk = (size_t)gridDim.y * gridDim.z;
    const size_t bk = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
    float* p_acc = a.part + bk * a.splits * RT * D;
    float* p_ml = a.part + n_bk * a.splits * RT * D + bk * a.splits * RT * 2;
#pragma unroll
    for (int i = 0; i < kPvRows; ++i) {
      if (i < pv_rows) {
        const int r = rg + kRg * i;
        *reinterpret_cast<float4*>(p_acc + ((size_t)split * RT + r) * D +
                                   4 * cg) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kQkRows; ++i) {
      if (i < qk_rows && lane == 0) {
        const int r = warp + kSplitWarps * i;
        *reinterpret_cast<float2*>(p_ml + ((size_t)split * RT + r) * 2) =
            make_float2(m[i], l[i]);
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int done = atomicAdd(a.counters + bk, 1);
      const bool last = done == a.splits - 1;
      if (last) a.counters[bk] = 0;  // ready for the next call
      flags[NST] = last;
    }
    __syncthreads();
    if (!flags[NST]) return;
    __threadfence();
    // the score rows' partial m and l (lane j holds splits j and j + 32):
    // the merged m, each split's factor exp(m_s - m), and l summed in split
    // order; the factors go to shared memory for the P.V rows
    float* f_s = reinterpret_cast<float*>(sm + L::merge_at(a.n_sc));
    float* lf_s = f_s + RT * a.splits;  // l_s times its factor
#pragma unroll
    for (int i = 0; i < kQkRows; ++i) {
      if (i < qk_rows) {
        const int r = warp + kSplitWarps * i;
        float2 x[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int s = lane + 32 * j;
          x[j] = s < a.splits ? __ldcg(reinterpret_cast<const float2*>(
                                    p_ml + ((size_t)s * RT + r) * 2))
                              : make_float2(kNegInf, 0.f);
        }
        const float mm = warp_max(fmaxf(x[0].x, x[1].x));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int s = lane + 32 * j;
          if (s < a.splits) {
            const float f = expf(x[j].x - mm);
            f_s[r * a.splits + s] = f;
            lf_s[r * a.splits + s] = x[j].y * f;
          }
        }
        __syncwarp();
        float ll = 0.f;
#pragma unroll 8
        for (int s = 0; s < a.splits; ++s) ll += lf_s[r * a.splits + s];
        m[i] = mm;
        l[i] = ll;
      }
    }
    __syncthreads();
    // the P.V rows' partial acc, summed in split order (every row's load of
    // a split in flight together)
#pragma unroll
    for (int i = 0; i < kPvRows; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
#pragma unroll 4
    for (int s = 0; s < a.splits; ++s) {
#pragma unroll
      for (int i = 0; i < kPvRows; ++i) {
        if (i < pv_rows) {
          const int r = rg + kRg * i;
          const float f = f_s[r * a.splits + s];
          const float4 x = __ldcg(reinterpret_cast<const float4*>(
              p_acc + ((size_t)s * RT + r) * D + 4 * cg));
          acc[i][0] += x.x * f;
          acc[i][1] += x.y * f;
          acc[i][2] += x.z * f;
          acc[i][3] += x.w * f;
        }
      }
    }
  }

  // ---- verify: the in-flight rows, folded once, after the merge ---------
  if constexpr (VERIFY) {
    const T* ek = static_cast<const T*>(a.extra_k);
    const T* ev = static_cast<const T*>(a.extra_v);
    unsigned char* kt = INT8 ? tt : sm + stage_at(0);
    constexpr int kCpk = D * sizeof(T) / 16;
    for (int e0 = 0; e0 < a.C; e0 += KT) {
      const int n_keys = min(KT, a.C - e0);
      __syncthreads();  // the tiles are free
      for (int i = tid; i < 2 * KT * kCpk; i += kSplitThreads) {
        const int kv = i / (KT * kCpk), j = i % (KT * kCpk);
        const int key = j / kCpk, c = j % kCpk;
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if (key < n_keys)
          w = *reinterpret_cast<const uint4*>(
              (kv ? ev : ek) + (((size_t)b * a.C + e0 + key) * a.Hkv + kh) * D +
              c * (16 / sizeof(T)));
        *reinterpret_cast<uint4*>(kt + kv * L::kTile + key * L::kRowBytes +
                                  c * 16) = w;
      }
      __syncthreads();
      const bool ok = lane < n_keys;
      step(kt, kt + L::kTile, ok ? posb[e0 + lane] : 0, ok);
    }
  }

  // ---- the output: acc / l, a row that saw no key as zeros --------------
#pragma unroll
  for (int i = 0; i < kQkRows; ++i)
    if (i < qk_rows && lane == 0) l_s[warp + kSplitWarps * i] = l[i];
  __syncthreads();
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < kPvRows; ++i) {
    if (i < pv_rows) {
      const int r = rg + kRg * i;
      const float ll = l_s[r];
      const float denom = ll == 0.f ? 1.f : ll;
      Pack<T, 4> res;
#pragma unroll
      for (int c = 0; c < 4; ++c) res.e[c] = from_f32<T>(acc[i][c] / denom);
      *reinterpret_cast<Pack<T, 4>*>(out + q_index(r) + 4 * cg) = res;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Shared memory above 48 KB is opt-in, per kernel and device. The
// attribute is set once for the largest size asked so far (a call on the
// host per launch would cost the host-bound serving steps, and is not a
// stream operation a CUDA graph could capture); `opted` is the caller's,
// one per kernel.
template <typename K>
cudaError_t opt_in_smem(K* kernel, int bytes, int (&opted)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || bytes <= 48 * 1024) return err;
  if (dev < 64 && bytes <= opted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) opted[dev] = bytes;
  return err;
}

template <bool INT8, int D>
cudaError_t launch_chunk_tc(const Args& a, int B, int n_q,
                            cudaStream_t stream) {
  using L = typename ChunkTc<INT8, D>::L;
  auto kernel = paged_chunk_wgmma_kernel<INT8, D>;
  static int opted[64] = {};
  const cudaError_t err = opt_in_smem(kernel, L::alloc, opted);
  if (err != cudaSuccess) return err;
  const int tiles = (n_q + kTcRows - 1) / kTcRows;
  kernel<<<dim3(a.splits, a.Hkv * tiles, B), ChunkTc<INT8, D>::kThreads,
           L::alloc, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool INT8, int D, bool VERIFY>
cudaError_t launch_split(const Args& a, int B, int n_q, cudaStream_t stream) {
  auto kernel = paged_decode_split_kernel<T, INT8, D, VERIFY>;
  const int smem = Split<T, INT8, D, VERIFY>::bytes(a.n_sc, a.splits);
  static int opted[64] = {};
  const cudaError_t err = opt_in_smem(kernel, smem, opted);
  if (err != cudaSuccess) return err;
  const int tiles = (n_q + split_rows(VERIFY) - 1) / split_rows(VERIFY);
  kernel<<<dim3(a.splits, a.Hkv * tiles, B), kSplitThreads, smem, stream>>>(
      a);
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
  if (kernel == 0) return launch_split<T, INT8, D, false>(a, B, n_q, stream);
  if (kernel == 2) return launch_split<T, INT8, D, true>(a, B, n_q, stream);
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

// kernel: 0 = paged_decode_split_kernel (at most 8 query rows per (slot,
// KV head), C * H / Hkv <= 8), 1 = paged_chunk_kernel (any number; f32,
// or bf16 at D 32), 2 = the verify variant
// (paged_decode_split_kernel<VERIFY>, any number of rows; needs extra_k /
// extra_v, and takes W == 0: only the in-flight rows), 3 =
// paged_chunk_wgmma_kernel (any number; bf16 only, D 64 or 128).
// dtype: 0 = float32, 1 = bfloat16 (q, out, verbatim pools, extra rows).
// int8: 1 when the pools are int8 payloads with f32 block scales, whose
// block width blk must be a multiple of 4. q, out, the pools and the
// extra rows are 16-byte aligned (vector loads); tables and positions
// 4-byte. Kernels 0, 2 and 3 split each row tile's walk over `splits`
// blocks (1 <= splits <= min(max(W, 1), 64)); with splits > 1 they take the
// caller's workspace: `part`, f32, B * Hkv * tiles * splits * R * (D + 2)
// values (R = 8 rows a tile for kernel 0, 32 for kernel 2, 128 for kernel
// 3; tiles = ceil(C * H / Hkv / R)), and `counters`, B * Hkv * tiles
// ints, zero before the first call and left zero by every call. Calls
// sharing a workspace must run in order (one stream). Returns a
// cudaError_t (0 = launched).
int dlrover_paged_attention(const void* q, void* out, const void* k_pool,
                            const void* v_pool, const void* k_scale,
                            const void* v_scale, const void* tables,
                            const void* positions, const void* extra_k,
                            const void* extra_v, int B, int C, int H,
                            int Hkv, int D, int ps, int W, int tab_stride,
                            int blk, int window, float scale, int dtype,
                            int int8, int kernel, void* stream, void* part,
                            void* counters, int splits) {
  const bool split_kernel = kernel == 0 || kernel == 2 || kernel == 3;
  if (B <= 0 || C <= 0 || Hkv <= 0 || H % Hkv || ps <= 0 || ps > 32 ||
      W < (kernel == 2 ? 0 : 1) || W > tab_stride ||
      (int8 && (blk <= 0 || blk % 4 || (Hkv * D) % blk)) ||
      kernel < 0 || kernel > 3 || (kernel == 0 && C * (H / Hkv) > 8) ||
      (kernel == 2 && (extra_k == nullptr || extra_v == nullptr)) ||
      (split_kernel &&
       (splits < 1 || splits > std::max(W, 1) || splits > kMaxSplits ||
        (splits > 1 && (part == nullptr || counters == nullptr)))))
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
  a.part = static_cast<float*>(part);
  a.counters = static_cast<int*>(counters);
  a.splits = split_kernel ? splits : 1;
  // int8: the most scale blocks one head's D elements span
  a.n_sc = 0;
  for (int kh = 0; int8 && kh < Hkv; ++kh)
    a.n_sc = std::max(a.n_sc, (kh * D + D - 1) / blk - kh * D / blk + 1);
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
