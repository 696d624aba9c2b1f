// Paged flash-decode over block-table KV pools, for Hopper (sm_90a).
//
// Replaces the TPU kernel dlrover_tpu/ops/pallas_paged.py::_paged_kernel
// (driven by _paged_call / paged_attention) in its "decode" (one query per
// slot) and "chunk" (C queries per slot, chunked prefill) variants, over
// bf16/f32 pools ([P, ps, Hkv, D]) or int8 pools ([P, ps, nb, blk] payloads
// with f32 per-block scales [P, ps, nb]). Same semantics: a table entry of
// -1 is an unassigned page and is skipped, key kpos serves query row r iff
// kpos <= pos[r] (and kpos > pos[r] - window with a window), f32 online
// softmax with masked probabilities zeroed explicitly, and rows that see no
// key at all come out as exact zeros (l == 0 -> 1), so a free slot gives 0
// and never NaN. int8 payloads dequantize in f32 and round through the
// compute type, the values quant.kv_decode_rows hands the plain version.
//
// What bounds it: the bytes of the pages a slot holds. At decode each K/V
// element serves only the `groups` query heads of its KV head, a few FLOPs
// per byte, far below the card's ~295 FLOP/byte ridge; a 256-row prefill
// chunk reuses each element 4 * 256 times and would be bound by operations
// on the tensor cores, which this first kernel does not use (it does the
// math in f32 on the CUDA cores). What the design does about the bytes:
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
// positions (the TPU's scalar prefetch). Two kernels; the caller names the
// one to launch (the Python wrapper picks by the number of query rows per
// (slot, KV head), n_q = C * groups, and counts that kernel's launches):
//
// - paged_decode_kernel (n_q <= 8: decode). Grid (slot, KV head). One warp
//   holds every row of the block; the block's warps split the page walk
//   (warp w takes columns w, w + n_warps, ...), each with its own running
//   (m, l, acc), loading K/V straight into registers 16 keys at a time.
//   The warps' partial states merge through shared memory at the end. This
//   keeps 8 pages in flight per (slot, KV head) instead of one.
// - paged_chunk_kernel (n_q > 8: prefill chunks). Grid (slot, KV head,
//   tile of 32 rows). Each warp holds 4 rows; the block stages one page's
//   K and V for its KV head in shared memory (f32) and every warp reuses
//   it, so a page is read once per 32 rows.
//
// Scores are a warp-shuffle reduction per key; lane i keeps key i's score,
// so a group of up to 32 keys is one max/exp/sum step of the online
// softmax. Tensor cores, TMA, and splitting the walk across blocks are
// left for later work.
//
// Interface: a plain C function, launched on the caller's stream; it
// allocates nothing and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
  int C, H, Hkv, ps, W, tab_stride, blk, window;
  float scale;
};

// ---------------------------------------------------------------------------
// decode: one warp holds all R rows, the warps split the page walk
// ---------------------------------------------------------------------------

template <typename T, bool INT8, int DPL, int R>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const Args a) {
  using E = std::conditional_t<INT8, int8_t, T>;
  constexpr int D = DPL * 32;
  constexpr int KC = kKeysPerStep;
  extern __shared__ float smem[];  // [n_warps][R][D + 2] partial states

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int groups = a.H / a.Hkv;
  const int n_q = a.C * groups;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int d0 = lane * DPL;  // this lane's elements d0 .. d0 + DPL - 1
  const T* q = static_cast<const T*>(a.q);

  float qv[R][DPL], acc[R][DPL], m[R], l[R], s_mine[R], p_mine[R];
  int pos[R];
  bool row_ok[R];
  int min_pos = INT_MAX, max_pos = INT_MIN;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row_ok[r] = r < n_q;
    const int c = row_ok[r] ? r / groups : 0;
    const int g = row_ok[r] ? r % groups : 0;
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
    bool page_ok = page >= 0 && first <= max_pos;
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
      softmax_step<R, DPL>(s_mine, pos, row_ok, first + i0 + lane,
                           lane < min(KC, a.ps - i0), a.window, m, l, acc,
                           p_mine);
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
  for (int r = warp; r < R && r < n_q; r += n_warps) {
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
    const int c = r / groups;
    const int g = r % groups;
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
// launch
// ---------------------------------------------------------------------------

template <typename T, bool INT8, int DPL>
cudaError_t launch(const Args& a, int B, bool decode, cudaStream_t stream) {
  constexpr int D = DPL * 32;
  const int n_q = a.C * (a.H / a.Hkv);
  if (decode) {
    const dim3 grid(B, a.Hkv, 1);
    if (n_q <= 4) {
      const size_t smem = sizeof(float) * kWarps * 4 * (D + 2);
      paged_decode_kernel<T, INT8, DPL, 4>
          <<<grid, kWarps * 32, smem, stream>>>(a);
    } else {
      const size_t smem = sizeof(float) * kWarps * 8 * (D + 2);
      paged_decode_kernel<T, INT8, DPL, 8>
          <<<grid, kWarps * 32, smem, stream>>>(a);
    }
    return cudaGetLastError();
  }
  const int warps = std::min(kWarps, (n_q + kChunkRows - 1) / kChunkRows);
  const int rows_per_block = warps * kChunkRows;
  const dim3 grid(B, a.Hkv, (n_q + rows_per_block - 1) / rows_per_block);
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(a.ps) * D;
  paged_chunk_kernel<T, INT8, DPL><<<grid, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool INT8>
cudaError_t dispatch_dim(int D, const Args& a, int B, bool decode,
                         cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, INT8, 1>(a, B, decode, stream);
    case 64:
      return launch<T, INT8, 2>(a, B, decode, stream);
    case 128:
      return launch<T, INT8, 4>(a, B, decode, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// kernel: 0 = paged_decode_kernel (at most 8 query rows per (slot, KV
// head), C * H / Hkv <= 8), 1 = paged_chunk_kernel (any number).
// dtype: 0 = float32, 1 = bfloat16 (q, out and verbatim pools).
// int8: 1 when the pools are int8 payloads with f32 block scales, whose
// block width blk must be a multiple of 4. Every pointer is 16-byte
// aligned. Returns a cudaError_t (0 = launched).
int dlrover_paged_attention(const void* q, void* out, const void* k_pool,
                            const void* v_pool, const void* k_scale,
                            const void* v_scale, const void* tables,
                            const void* positions, int B, int C, int H,
                            int Hkv, int D, int ps, int W, int tab_stride,
                            int blk, int window, float scale, int dtype,
                            int int8, int kernel, void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || H % Hkv || ps <= 0 || ps > 32 ||
      W <= 0 || W > tab_stride ||
      (int8 && (blk <= 0 || blk % 4 || (Hkv * D) % blk)) ||
      (kernel != 0 && kernel != 1) || (kernel == 0 && C * (H / Hkv) > 8))
    return cudaErrorInvalidValue;
  const bool decode = kernel == 0;
  Args a;
  a.q = q;
  a.out = out;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.tables = static_cast<const int*>(tables);
  a.positions = static_cast<const int*>(positions);
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
    return int8 ? dispatch_dim<__nv_bfloat16, true>(D, a, B, decode, st)
                : dispatch_dim<__nv_bfloat16, false>(D, a, B, decode, st);
  if (dtype == 0)
    return int8 ? dispatch_dim<float, true>(D, a, B, decode, st)
                : dispatch_dim<float, false>(D, a, B, decode, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
