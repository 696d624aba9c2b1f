// Fused rmsnorm / layernorm, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of dlrover_tpu/ops/pallas_norm.py:
//   norm_fwd_kernel <- _fwd_kernel (driven by _call_fwd)
//   norm_bwd_kernel <- _bwd_kernel (driven by _norm_call_bwd)
// with the same arithmetic. Forward: the optional residual add in the
// input type (h = x + res, rounded once, also written out), statistics in
// f32 (rmsnorm: mean of squares; layernorm: single-pass E[x], E[x^2] with
// the variance clamped at 0), out = stat-normed x * scale (+ bias) cast to
// the input type. Backward: the statistics recomputed from the saved
// stream h, dx from the per-row formulas of _bwd_kernel, the stream's own
// cotangent gh added to dx, and the dscale / dbias partials of each block
// written to [blocks, d] f32 rows that the caller sums (as JAX sums its
// per-program partials).
//
// What bounds both: bytes. A row of d elements costs a few FLOP per
// element against 2-4 bytes moved (the backward reads g and h, and gh
// with a residual, and writes dx), far below the card's ~295 FLOP/byte
// ridge. So each byte moves once, with 16-byte vector accesses (8 bf16 or
// 4 f32 a lane), each row held in registers between its statistics and
// its output, and enough loads in flight to keep the memory busy.
//
// Both kernels walk rows the same way: a persistent grid (as many blocks
// of 8 warps as the card holds at once, never more than the rows need),
// in which a group of G warps owns a row and walks rows gridDim.x * 8 / G
// apart, issuing the next row's loads before this row's reductions and
// stores, so every warp keeps loads in flight. Lane L of a row's G warps
// (L = 32 * part + lane) holds the row's 16-byte vectors L, L + 32 G, ...,
// NV of them at most, the same columns on every row it visits. The
// wrapper plans G and NV (ops/norm.py fwd_plan, bwd_plan): the fewest
// warps that hold the row at a few vectors a lane, so a row is spread
// over many small loads (the plans the H100 ran fastest at the training
// widths, PERF.md). The G warps of a row add their partial sums through
// shared memory in one order, so each computes the same statistics.
//
// Forward: scale (and bias) are staged in shared memory once per block,
// as float4 chunks a warp reads without bank conflicts: the output loop
// reads them with 16-byte loads.
//
// Backward: since a lane keeps its columns on every row, it loads its
// scale into registers once and keeps its dscale (and dbias) sums there,
// in f32, across every row it visits: no shared-memory traffic per
// element, and the registers, not d, set the occupancy. The row sums take
// one cross-warp round for rmsnorm (sum h^2 and sum (g scale) h together)
// and two for layernorm (E[x], E[x^2]; then sum g scale and sum g scale
// xhat, as _bwd_kernel computes them). At the end a block's groups add
// their column sums in group order and write one partial row, so the
// partial count is the grid's size, which the C side reports
// (dlrover_norm_bwd_blocks) before the wrapper allocates it; a second
// kernel of the same C call sums the partial rows (norm_bwd_colsum_kernel).
// Rows go to groups by a fixed stride and every sum runs in a fixed
// order: a call repeats bit for bit.
//
// Interface: plain C functions launched on the caller's stream; they
// allocate nothing and return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

// 16 bytes of a row: 8 bf16 or 4 f32, moved as one vector access.
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T e[N];
};

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

template <typename T>
__device__ __forceinline__ Vec<T> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T>*>(p);
}
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const Vec<T>& v) {
  *reinterpret_cast<Vec<T>*>(p) = v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// forward: G warps per row, each warp walking rows; scale and bias staged
// in shared memory once per block
// ---------------------------------------------------------------------------

constexpr int kFwdWarps = 8;  // warps per block (forward and backward)

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// This lane's vectors of row `row` (x, and res with a residual): no
// lambda, so the kernel's parameters are never taken by address (which
// would turn each read of one into a load from memory).
template <typename T, bool RES, int NV, int G>
__device__ __forceinline__ void load_row(const T* __restrict__ x,
                                         const T* __restrict__ res, int row,
                                         int d, int lg, Vec<T> (&xv)[NV],
                                         Vec<T> (&rv)[NV]) {
  constexpr int VEC = Vec<T>::N;
  const size_t base = (size_t)row * d;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int vi = lg + 32 * G * j;
    if (vi < d / VEC) {
      xv[j] = load_vec(x + base + vi * VEC);
      if constexpr (RES) rv[j] = load_vec(res + base + vi * VEC);
    }
  }
}

// Lane L of a row's G warps (L = 32 * part + lane) holds the row's 16-byte
// vectors L, L + 32 G, ..., NV of them at most. The f32 scale (and bias)
// of vector vi sit in shared memory as VEC / 4 float4 chunks, chunk k at
// [k * n_vec + vi], so a warp's lanes read consecutive float4s.
template <typename T, bool RMS, bool RES, bool BIAS, int NV, int G>
__global__ void __launch_bounds__(kFwdWarps * 32)
    norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, T* __restrict__ out,
                    T* __restrict__ h_out, int n, int d, float eps) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CH = VEC / 4;          // float4 chunks of scale a vector
  constexpr int GROUPS = kFwdWarps / G;  // rows in flight a block
  extern __shared__ float4 cols[];     // scale, then bias: [CH][n_vec]
  __shared__ float2 red[2][kFwdWarps];  // (s1, s2) of each warp, by parity
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / G, part = warp % G;
  const int lg = part * 32 + lane;
  const int n_vec = d / VEC;
  float4* sc = cols;
  float4* bi = cols + CH * n_vec;
  for (int i = threadIdx.x; i < CH * n_vec; i += kFwdWarps * 32) {
    const int vi = i / CH, k = i % CH;
    sc[k * n_vec + vi] = reinterpret_cast<const float4*>(scale)[i];
    if constexpr (BIAS)
      bi[k * n_vec + vi] = reinterpret_cast<const float4*>(bias)[i];
  }
  __syncthreads();

  Vec<T> xv[NV], rv[NV];
  const int stride = gridDim.x * GROUPS;
  int row = blockIdx.x * GROUPS + grp;
  if (row < n) load_row<T, RES, NV, G>(x, res, row, d, lg, xv, rv);
  for (int it = 0; row < n; row += stride, ++it) {
    const size_t base = (size_t)row * d;
    Vec<T> hv[NV];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int vi = lg + 32 * G * j;
      if (vi >= n_vec) break;
      hv[j] = xv[j];
      if constexpr (RES) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)  // the add in the input type
          hv[j].e[e] = from_f32<T>(to_f32(hv[j].e[e]) + to_f32(rv[j].e[e]));
        store_vec(h_out + base + vi * VEC, hv[j]);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f32(hv[j].e[e]);
        s1 += f;
        s2 += f * f;
      }
    }
    // the next row's loads, in flight under this row's sums and stores
    if (row + stride < n)
      load_row<T, RES, NV, G>(x, res, row + stride, d, lg, xv, rv);
    s2 = warp_sum(s2);
    if constexpr (!RMS) s1 = warp_sum(s1);
    if constexpr (G > 1) {
      // the row's G partials, summed in the same order by every warp
      if (lane == 0) red[it & 1][warp] = make_float2(s1, s2);
      named_sync(1 + grp, 32 * G);
      s1 = s2 = 0.f;
#pragma unroll
      for (int w = 0; w < G; ++w) {
        const float2 p = red[it & 1][grp * G + w];
        s1 += p.x;
        s2 += p.y;
      }
    }
    float mean = 0.f, r;
    if constexpr (RMS) {
      r = rsqrtf(s2 / d + eps);
    } else {
      mean = s1 / d;
      const float var = fmaxf(s2 / d - mean * mean, 0.f);
      r = rsqrtf(var + eps);
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int vi = lg + 32 * G * j;
      if (vi >= n_vec) break;
      Vec<T> ov;
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const float4 s4 = sc[k * n_vec + vi];
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
        float bv[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (BIAS) {
          const float4 b4 = bi[k * n_vec + vi];
          bv[0] = b4.x;
          bv[1] = b4.y;
          bv[2] = b4.z;
          bv[3] = b4.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float hf = to_f32(hv[j].e[4 * k + e]);
          float y = RMS ? hf * r : (hf - mean) * r;
          y = y * sv[e];
          if constexpr (BIAS) y = y + bv[e];
          ov.e[4 * k + e] = from_f32<T>(y);
        }
      }
      store_vec(out + base + vi * VEC, ov);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: the forward's walk, rows fetched ahead into a ring in shared
// memory, each lane's column sums in registers
// ---------------------------------------------------------------------------

// Rows of a group's ring: the row it works on and kBwdStages - 1 ahead.
constexpr int kBwdStages = 3;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The streams of a row in a ring stage, d elements each: g, h (and gh).
template <bool RES>
__host__ __device__ constexpr int bwd_streams() {
  return RES ? 3 : 2;
}

// This lane's 16-byte vectors of row `row` of each stream into their
// places in ring stage `st` (the same places it reads them back from, so
// no other thread waits on them).
template <typename T, bool RES, int NV, int G>
__device__ __forceinline__ void fetch_row(const T* __restrict__ g,
                                          const T* __restrict__ h,
                                          const T* __restrict__ gh, int row,
                                          int d, int lg, T* st) {
  constexpr int VEC = Vec<T>::N;
  const size_t base = (size_t)row * d;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (lg + 32 * G * j) * VEC;
    if (c < d) {
      cp_async16(st + c, g + base + c);
      cp_async16(st + d + c, h + base + c);
      if constexpr (RES) cp_async16(st + 2 * d + c, gh + base + c);
    }
  }
}

// The row's G partials of two sums, added by every warp of the group in
// the same order through red (one of two buffers: a buffer is written
// again only after every warp has passed the barrier of the sum between).
template <int G>
__device__ __forceinline__ void group_sum2(float& a, float& b,
                                           float2 (&red)[kFwdWarps], int grp,
                                           int warp, int lane) {
  a = warp_sum(a);
  b = warp_sum(b);
  if constexpr (G > 1) {
    if (lane == 0) red[warp] = make_float2(a, b);
    named_sync(1 + grp, 32 * G);
    a = b = 0.f;
#pragma unroll
    for (int w = 0; w < G; ++w) {
      const float2 p = red[grp * G + w];
      a += p.x;
      b += p.y;
    }
  }
}

// dx of each row; this block's dscale (and dbias) column sums into row
// blockIdx.x of ds_part (db_part). Lane lg's vectors are vi = lg + 32 G j;
// the f32 scale of vector vi sits in shared memory as the forward stages
// it (VEC / 4 float4 chunks, chunk k at [k * n_vec + vi]). Shared memory:
// scale, then each group's ring of kBwdStages rows, which the groups'
// column sums take over once every group has walked its rows.
template <typename T, bool RMS, bool RES, bool BIAS, int NV, int G>
__global__ void __launch_bounds__(kFwdWarps * 32, sizeof(T) == 2 ? 2 : 1)
    norm_bwd_kernel(const T* __restrict__ g, const T* __restrict__ h,
                    const float* __restrict__ scale, const T* __restrict__ gh,
                    T* __restrict__ dx, float* __restrict__ ds_part,
                    float* __restrict__ db_part, int n, int d, float eps) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CH = VEC / 4;            // float4 chunks of scale a vector
  constexpr int GROUPS = kFwdWarps / G;  // rows in flight a block
  constexpr int STREAMS = bwd_streams<RES>();
  extern __shared__ float4 cols[];
  __shared__ float2 red[2][kFwdWarps];  // the row sums of each warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / G, part = warp % G;
  const int lg = part * 32 + lane;
  const int n_vec = d / VEC;
  const float4* sc = cols;
  T* ring = reinterpret_cast<T*>(cols + CH * n_vec) +
            (size_t)grp * kBwdStages * STREAMS * d;
  // the group's first rows, in flight while scale is staged
  const int stride = gridDim.x * GROUPS;
  const int row0 = blockIdx.x * GROUPS + grp;
#pragma unroll
  for (int s = 0; s < kBwdStages - 1; ++s) {
    if (row0 + s * stride < n)
      fetch_row<T, RES, NV, G>(g, h, gh, row0 + s * stride, d, lg,
                               ring + (size_t)s * STREAMS * d);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < CH * n_vec; i += kFwdWarps * 32)
    cols[(i % CH) * n_vec + i / CH] =
        reinterpret_cast<const float4*>(scale)[i];
  __syncthreads();
  // scale e of this lane's vector vi, from shared memory
  auto scale_of = [&](int vi, int e) {
    const float4 s4 = sc[(e / 4) * n_vec + vi];
    return (e & 3) == 0 ? s4.x : (e & 3) == 1 ? s4.y : (e & 3) == 2 ? s4.z
                                                                      : s4.w;
  };

  // this lane's column sums, kept in registers for every row it visits
  float ds[NV][VEC], db[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) ds[j][e] = db[j][e] = 0.f;

  int it = 0;
  for (int row = row0; row < n; row += stride, ++it) {
    const size_t base = (size_t)row * d;
    // the row kBwdStages - 1 ahead into the stage read last iteration
    const int ahead = row + (kBwdStages - 1) * stride;
    if (ahead < n)
      fetch_row<T, RES, NV, G>(
          g, h, gh, ahead, d, lg,
          ring + (size_t)((it + kBwdStages - 1) % kBwdStages) * STREAMS * d);
    cp_async_commit();
    cp_async_wait<kBwdStages - 1>();  // this row's copies have landed
    const T* st = ring + (size_t)(it % kBwdStages) * STREAMS * d;
    Vec<T> gc[NV], hc[NV], ghv[NV];
    float s1 = 0.f, s2 = 0.f, dot = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int vi = lg + 32 * G * j;
      if (vi >= n_vec) break;
      gc[j] = load_vec(st + vi * VEC);
      hc[j] = load_vec(st + d + vi * VEC);
      if constexpr (RES) ghv[j] = load_vec(st + 2 * d + vi * VEC);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float hf = to_f32(hc[j].e[e]);
        s1 += hf;
        s2 += hf * hf;
        if constexpr (RMS)
          dot += to_f32(gc[j].e[e]) * scale_of(vi, e) * hf;
      }
    }
    // the row sums of the formulas: rms sum(gx * h); layer sum(gx) and
    // sum(gx * xhat), gx = g * scale, xhat = (h - mean) * r
    float mean = 0.f, m1 = 0.f, r;
    if constexpr (RMS) {
      group_sum2<G>(s2, dot, red[it & 1], grp, warp, lane);
      r = rsqrtf(s2 / d + eps);
      dot = dot / d;
    } else {
      group_sum2<G>(s1, s2, red[0], grp, warp, lane);
      mean = s1 / d;
      r = rsqrtf(fmaxf(s2 / d - mean * mean, 0.f) + eps);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int vi = lg + 32 * G * j;
        if (vi >= n_vec) break;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float gx = to_f32(gc[j].e[e]) * scale_of(vi, e);
          m1 += gx;
          dot += gx * ((to_f32(hc[j].e[e]) - mean) * r);
        }
      }
      group_sum2<G>(dot, m1, red[1], grp, warp, lane);
      dot = dot / d;
      m1 = m1 / d;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int vi = lg + 32 * G * j;
      if (vi >= n_vec) break;
      Vec<T> ov;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float gf = to_f32(gc[j].e[e]);
        const float hf = to_f32(hc[j].e[e]);
        const float gx = gf * scale_of(vi, e);
        float dxv;
        if constexpr (RMS) {
          dxv = r * gx - (r * r * r) * dot * hf;
          ds[j][e] += gf * hf * r;
        } else {
          const float xhat = (hf - mean) * r;
          dxv = r * (gx - m1 - xhat * dot);
          ds[j][e] += gf * xhat;
          if constexpr (BIAS) db[j][e] += gf;
        }
        if constexpr (RES) dxv += to_f32(ghv[j].e[e]);
        ov.e[e] = from_f32<T>(dxv);
      }
      store_vec(dx + base + vi * VEC, ov);
    }
  }

  // one partial row a block: the groups' column sums added in group order
  // (through the rings' shared memory once every group is done with it)
  const size_t prow = (size_t)blockIdx.x * d;
  auto put = [&](float* dst, const float (&v)[VEC]) {
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k)
      reinterpret_cast<float4*>(dst)[k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  };
  float* cs = reinterpret_cast<float*>(cols + CH * n_vec);
  if constexpr (GROUPS > 1) __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int vi = lg + 32 * G * j;
    if (vi >= n_vec) break;
    if constexpr (GROUPS == 1) {
      put(ds_part + prow + vi * VEC, ds[j]);
      if constexpr (BIAS) put(db_part + prow + vi * VEC, db[j]);
    } else {
      put(cs + (size_t)grp * d + vi * VEC, ds[j]);
      if constexpr (BIAS)
        put(cs + (size_t)(GROUPS + grp) * d + vi * VEC, db[j]);
    }
  }
  if constexpr (GROUPS > 1) {
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += kFwdWarps * 32) {
      float s = 0.f, sb = 0.f;
#pragma unroll
      for (int w = 0; w < GROUPS; ++w) {
        s += cs[(size_t)w * d + c];
        if constexpr (BIAS) sb += cs[(size_t)(GROUPS + w) * d + c];
      }
      ds_part[prow + c] = s;
      if constexpr (BIAS) db_part[prow + c] = sb;
    }
  }
}

// dscale (and dbias): the column sums of the backward's n_part partial
// rows, launched right after it on the same stream. Each column is summed
// in one fixed order (each warp's rows in order, then the warps in
// order), so a call repeats bit for bit. A block sums 32 columns, its 8
// warps a share of the rows each, so the rows' loads are spread over the
// card (two torch column sums took ~12 us, a quarter of the backward at
// gpt2's d 1600).
__global__ void __launch_bounds__(kFwdWarps * 32)
    norm_bwd_colsum_kernel(const float* __restrict__ ds_part,
                           const float* __restrict__ db_part,
                           float* __restrict__ dscale,
                           float* __restrict__ dbias, int n_part, int d) {
  __shared__ float part[2][kFwdWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f, sb = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int r = warp; r < n_part; r += kFwdWarps) {
      s += ds_part[(size_t)r * d + c];
      if (db_part != nullptr) sb += db_part[(size_t)r * d + c];
    }
  }
  part[0][warp][lane] = s;
  part[1][warp][lane] = sb;
  __syncthreads();
  if (warp != 0 || c >= d) return;
  s = sb = 0.f;
#pragma unroll
  for (int w = 0; w < kFwdWarps; ++w) {
    s += part[0][w][lane];
    sb += part[1][w][lane];
  }
  dscale[c] = s;
  if (dbias != nullptr) dbias[c] = sb;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Call {
  const void* a;      // fwd: x; bwd: g
  const void* b;      // fwd: res; bwd: h
  const float* scale;
  const float* bias;  // fwd: bias
  const void* c;      // bwd: gh
  void* out;          // fwd: out; bwd: dx
  void* h_out;        // fwd: h
  float* ds_part;
  float* db_part;
  int n, d;
  float eps;
  int* blocks;  // bwd: the grid; 0 asks for it (written, nothing launched)
};

// The SMs of the current device, cached per device.
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

// A persistent grid: as many blocks as fit on the card at once (each
// group of G warps walks rows), never more than the rows need. per_sm
// and last_d: the caller's cache of the blocks an SM holds, for the last
// d (the shared memory may depend on it).
template <typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, size_t smem, int groups,
                              const Call& k, int& last_d, int& per_sm,
                              int* blocks) {
  if (k.d != last_d) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kFwdWarps * 32, smem);
    if (err != cudaSuccess) return err;
    last_d = k.d;
  }
  const int need = (k.n + groups - 1) / groups;
  *blocks = std::min(need, std::max(1, per_sm * sm_count()));
  return cudaSuccess;
}

template <typename T, bool RMS, bool RES, bool BIAS, int NV, int G>
cudaError_t launch_fwd(const Call& k, cudaStream_t st) {
  auto kernel = norm_fwd_kernel<T, RMS, RES, BIAS, NV, G>;
  const size_t smem = sizeof(float) * (BIAS ? 2 : 1) * k.d;
  static int last_d = -1, per_sm = 0;
  int blocks = 0;
  const cudaError_t err = persistent_blocks(kernel, smem, kFwdWarps / G, k,
                                            last_d, per_sm, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kFwdWarps * 32, smem, st>>>(
      static_cast<const T*>(k.a), static_cast<const T*>(k.b), k.scale,
      k.bias, static_cast<T*>(k.out), static_cast<T*>(k.h_out), k.n, k.d,
      k.eps);
  return cudaGetLastError();
}

// The backward: *k.blocks == 0 asks for its grid (the partial rows the
// caller allocates); otherwise it launches that many blocks.
template <typename T, bool RMS, bool RES, bool BIAS, int NV, int G>
cudaError_t launch_bwd(const Call& k, cudaStream_t st) {
  auto kernel = norm_bwd_kernel<T, RMS, RES, BIAS, NV, G>;
  constexpr int groups = kFwdWarps / G;
  // scale, then the groups' rings, which their column sums (more than one
  // group) take over at the end
  const size_t ring = sizeof(T) * groups * kBwdStages * bwd_streams<RES>();
  const size_t sums = groups > 1 ? sizeof(float) * (BIAS ? 2 : 1) * groups : 0;
  const size_t smem = k.d * (sizeof(float) + std::max(ring, sums));
  if (smem > 48 * 1024) {  // above 48 KB only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (*k.blocks == 0) {
    static int last_d = -1, per_sm = 0;
    return persistent_blocks(kernel, smem, groups, k, last_d, per_sm,
                             k.blocks);
  }
  kernel<<<*k.blocks, kFwdWarps * 32, smem, st>>>(
      static_cast<const T*>(k.a), static_cast<const T*>(k.b), k.scale,
      static_cast<const T*>(k.c), static_cast<T*>(k.out), k.ds_part,
      k.db_part, k.n, k.d, k.eps);
  return cudaGetLastError();
}

// The forward's plan from the wrapper (ops/norm.py fwd_plan): G warps a
// row (1, 2, 4 or 8) and NV vectors a lane (1, 2 or 4), covering the row.
template <typename T, bool RMS, bool RES, bool BIAS>
cudaError_t pick_fwd_plan(int warps_per_row, int nv, const Call& k,
                          cudaStream_t st) {
  switch (warps_per_row * 10 + nv) {
    case 11:
      return launch_fwd<T, RMS, RES, BIAS, 1, 1>(k, st);
    case 12:
      return launch_fwd<T, RMS, RES, BIAS, 2, 1>(k, st);
    case 14:
      return launch_fwd<T, RMS, RES, BIAS, 4, 1>(k, st);
    case 22:
      return launch_fwd<T, RMS, RES, BIAS, 2, 2>(k, st);
    case 24:
      return launch_fwd<T, RMS, RES, BIAS, 4, 2>(k, st);
    case 42:
      return launch_fwd<T, RMS, RES, BIAS, 2, 4>(k, st);
    case 44:
      return launch_fwd<T, RMS, RES, BIAS, 4, 4>(k, st);
    case 82:
      return launch_fwd<T, RMS, RES, BIAS, 2, 8>(k, st);
    case 84:
      return launch_fwd<T, RMS, RES, BIAS, 4, 8>(k, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The backward's plan (ops/norm.py bwd_plan): at most 2 vectors a lane
// but past 8 warps (f32 rows over 2048 elements: 4).
template <typename T, bool RMS, bool RES, bool BIAS>
cudaError_t pick_bwd_plan(int warps_per_row, int nv, const Call& k,
                          cudaStream_t st) {
  switch (warps_per_row * 10 + nv) {
    case 11:
      return launch_bwd<T, RMS, RES, BIAS, 1, 1>(k, st);
    case 12:
      return launch_bwd<T, RMS, RES, BIAS, 2, 1>(k, st);
    case 22:
      return launch_bwd<T, RMS, RES, BIAS, 2, 2>(k, st);
    case 42:
      return launch_bwd<T, RMS, RES, BIAS, 2, 4>(k, st);
    case 82:
      return launch_bwd<T, RMS, RES, BIAS, 2, 8>(k, st);
    case 84:  // f32 only: no bf16 row passes 8 warps at 2 vectors a lane
      if constexpr (sizeof(T) == 4)
        return launch_bwd<T, RMS, RES, BIAS, 4, 8>(k, st);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// The kernel's kind from the flags: fwd or bwd, with the wrapper's plan.
template <typename T, bool RMS, bool RES, bool BIAS>
cudaError_t pick(bool fwd, int warps_per_row, int nv, const Call& k,
                 cudaStream_t st) {
  const int n_vec = k.d / Vec<T>::N;
  if (n_vec > 32 * warps_per_row * nv) return cudaErrorInvalidValue;
  return fwd ? pick_fwd_plan<T, RMS, RES, BIAS>(warps_per_row, nv, k, st)
             : pick_bwd_plan<T, RMS, RES, BIAS>(warps_per_row, nv, k, st);
}

template <typename T>
cudaError_t pick_kind(bool fwd, int rms, int res, int bias, int warps_per_row,
                      int nv, const Call& k, cudaStream_t st) {
  const int w = warps_per_row;
  if (rms) {
    return res ? pick<T, true, true, false>(fwd, w, nv, k, st)
               : pick<T, true, false, false>(fwd, w, nv, k, st);
  }
  if (bias)
    return res ? pick<T, false, true, true>(fwd, w, nv, k, st)
               : pick<T, false, false, true>(fwd, w, nv, k, st);
  return res ? pick<T, false, true, false>(fwd, w, nv, k, st)
             : pick<T, false, false, false>(fwd, w, nv, k, st);
}

int dispatch(bool fwd, int rms, int res, int bias, int dtype,
             int warps_per_row, int nv, const Call& k, void* stream) {
  if (k.n <= 0 || k.d <= 0 || k.d % 8) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return pick_kind<bf16>(fwd, rms, res, bias, warps_per_row, nv, k, st);
  if (dtype == 0)
    return pick_kind<float>(fwd, rms, res, bias, warps_per_row, nv, k, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Rows of d elements (d a multiple of 8 and at most 4096); dtype:
// 0 = float32, 1 = bfloat16 for x / res / out / h; scale and bias f32.
// rms: 1 = rmsnorm, 0 = layernorm. warps_per_row and nv: the wrapper's
// plan (ops/norm.py fwd_plan). Returns a cudaError_t (0 = launched).
int dlrover_norm_fwd(const void* x, const void* res, const float* scale,
                     const float* bias, void* out, void* h_out, int n, int d,
                     float eps, int rms, int dtype, int warps_per_row,
                     int nv, void* stream) {
  Call k = {x, res, scale, bias, nullptr, out, h_out, nullptr, nullptr,
            n, d, eps, nullptr};
  return dispatch(true, rms, res != nullptr, bias != nullptr, dtype,
                  warps_per_row, nv, k, stream);
}

// The backward's grid for these rows and flags (res, bias: 1 with a
// residual, a bias) and the plan (ops/norm.py bwd_plan): the partial rows
// dlrover_norm_bwd writes. Returns the count (> 0), or minus a
// cudaError_t.
int dlrover_norm_bwd_blocks(int n, int d, int rms, int res, int bias,
                            int dtype, int warps_per_row, int nv) {
  int blocks = 0;
  Call k = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
            nullptr, nullptr, n, d, 0.f, &blocks};
  const int err = dispatch(false, rms, res, bias, dtype, warps_per_row, nv,
                           k, nullptr);
  return err != 0 ? -err : blocks;
}

// The backward over n_part blocks (dlrover_norm_bwd_blocks' count), then
// the sums of its partial rows: ds_part / db_part are [n_part, d] f32
// scratch, dscale / dbias [d] f32 (db_part and dbias only for layernorm
// with a bias); gh may be null (no residual).
int dlrover_norm_bwd(const void* g, const void* h, const float* scale,
                     const void* gh, void* dx, float* ds_part, float* db_part,
                     float* dscale, float* dbias, int n, int d, float eps,
                     int rms, int dtype, int warps_per_row, int nv,
                     int n_part, void* stream) {
  if (n_part <= 0) return cudaErrorInvalidValue;
  Call k = {g, h, scale, nullptr, gh, dx, nullptr, ds_part, db_part,
            n, d, eps, &n_part};
  const int err = dispatch(false, rms, gh != nullptr, db_part != nullptr,
                           dtype, warps_per_row, nv, k, stream);
  if (err != 0) return err;
  norm_bwd_colsum_kernel<<<(d + 31) / 32, kFwdWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      ds_part, db_part, dscale, dbias, n_part, d);
  return cudaGetLastError();
}

}  // extern "C"
