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
// written to [n_blocks, d] f32 rows that the caller sums (as JAX sums its
// per-program partials).
//
// What bounds it: bytes. A row of d elements costs a few FLOP per element
// against 2-4 bytes moved, far below the card's ~295 FLOP/byte ridge. The
// design moves each byte once, with 16-byte vector accesses (8 bf16 or 4
// f32 a lane) and each row held in registers between its statistics and
// its output.
//
// Forward: a persistent grid (as many blocks of 8 warps as the card holds
// at once), in which a group of G warps owns a row and walks rows
// gridDim.x * 8 / G apart, issuing the next row's loads before this row's
// reduction and stores, so every warp keeps loads in flight. The wrapper
// plans G and the vectors a lane, NV (ops/norm.py fwd_plan): the fewest
// warps that hold the row at 2 vectors a lane (4 with a residual, whose
// lanes also hold the residual's vectors), so a row is spread over many
// small loads: at bf16 d 2048 four warps, at d 4096 eight (the plans the
// H100 ran fastest at the training widths, PERF.md). The G warps of a row
// add their partial sums through shared memory in one order, so each
// computes the same statistics. scale (and bias) are staged in shared
// memory once per block, as float4 chunks a warp reads without bank
// conflicts: the output loop reads them with 16-byte loads, where one
// thread used to read them as scalar global loads, twice the loads of its
// row's own traffic.
//
// Backward: one warp owns one row (NV vectors a lane, chosen at launch
// from d). Its column sums (dscale, dbias) accumulate per warp in shared
// memory and leave each block as one partial row, so no atomics are needed
// and the partials stay small ([n / 32, d] at 32 rows a block). It runs 8
// warps a block unless their dscale (+ dbias) rows pass the 227 KB of
// shared memory a block can have, as layernorm with a bias does at d >
// 3632 (glm-10b's 4096: 256 KB); then it runs 4.
//
// Interface: plain C functions launched on the caller's stream; they
// allocate nothing and return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kWarps = 8;          // backward: rows in flight per block
constexpr int kBwdRowsPerBlock = 32;
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory a block

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

constexpr int kFwdWarps = 8;  // warps per forward block

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
// backward: kBwdRowsPerBlock rows per block, one warp per row at a time
// ---------------------------------------------------------------------------

template <typename T, bool RMS, bool RES, bool BIAS, int NV, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    norm_bwd_kernel(const T* __restrict__ g, const T* __restrict__ h,
                    const float* __restrict__ scale, const T* __restrict__ gh,
                    T* __restrict__ dx, float* __restrict__ dscale_part,
                    float* __restrict__ dbias_part, int n, int d, float eps) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ float part[];  // [WARPS][d] dscale (+ [WARPS][d] dbias)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_vec = d / VEC;
  float* ds_w = part + (size_t)warp * d;
  float* db_w = part + (size_t)(WARPS + warp) * d;
  for (int c = lane; c < d; c += 32) {
    ds_w[c] = 0.f;
    if constexpr (BIAS) db_w[c] = 0.f;
  }
  const int row_end = min(n, (blockIdx.x + 1) * kBwdRowsPerBlock);
  for (int row = blockIdx.x * kBwdRowsPerBlock + warp; row < row_end;
       row += WARPS) {
    const size_t base = (size_t)row * d;
    Vec<T> gv[NV], hv[NV];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int vi = lane + 32 * j;
      if (vi >= n_vec) break;
      gv[j] = load_vec(g + base + vi * VEC);
      hv[j] = load_vec(h + base + vi * VEC);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f32(hv[j].e[e]);
        s1 += f;
        s2 += f * f;
      }
    }
    s2 = warp_sum(s2);
    float mean = 0.f, r;
    if constexpr (RMS) {
      r = rsqrtf(s2 / d + eps);
    } else {
      s1 = warp_sum(s1);
      mean = s1 / d;
      r = rsqrtf(fmaxf(s2 / d - mean * mean, 0.f) + eps);
    }
    // the row sums of the formulas: rms sum(gx * h); layer sum(gx) and
    // sum(gx * xhat), gx = g * scale, xhat = (h - mean) * r
    float dot = 0.f, m1 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int vi = lane + 32 * j;
      if (vi >= n_vec) break;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int c = vi * VEC + e;
        const float gx = to_f32(gv[j].e[e]) * scale[c];
        const float hf = to_f32(hv[j].e[e]);
        if constexpr (RMS) {
          dot += gx * hf;
        } else {
          m1 += gx;
          dot += gx * ((hf - mean) * r);
        }
      }
    }
    dot = warp_sum(dot) / d;
    if constexpr (!RMS) m1 = warp_sum(m1) / d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int vi = lane + 32 * j;
      if (vi >= n_vec) break;
      Vec<T> ghv;
      if constexpr (RES) ghv = load_vec(gh + base + vi * VEC);
      Vec<T> ov;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int c = vi * VEC + e;
        const float gf = to_f32(gv[j].e[e]);
        const float hf = to_f32(hv[j].e[e]);
        const float gx = gf * scale[c];
        float dxv;
        if constexpr (RMS) {
          dxv = r * gx - (r * r * r) * dot * hf;
          ds_w[c] += gf * hf * r;
        } else {
          const float xhat = (hf - mean) * r;
          dxv = r * (gx - m1 - xhat * dot);
          ds_w[c] += gf * xhat;
          if constexpr (BIAS) db_w[c] += gf;
        }
        if constexpr (RES) dxv += to_f32(ghv.e[e]);
        ov.e[e] = from_f32<T>(dxv);
      }
      store_vec(dx + base + vi * VEC, ov);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += WARPS * 32) {
    float s = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      s += part[(size_t)w * d + c];
      if constexpr (BIAS) sb += part[(size_t)(WARPS + w) * d + c];
    }
    dscale_part[(size_t)blockIdx.x * d + c] = s;
    if constexpr (BIAS) dbias_part[(size_t)blockIdx.x * d + c] = sb;
  }
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
};

template <typename T, bool RMS, bool RES, bool BIAS, int NV, int WARPS>
cudaError_t launch_bwd(const Call& k, size_t smem, cudaStream_t st) {
  auto kernel = norm_bwd_kernel<T, RMS, RES, BIAS, NV, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((k.n + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock);
  kernel<<<grid, WARPS * 32, smem, st>>>(
      static_cast<const T*>(k.a), static_cast<const T*>(k.b), k.scale,
      static_cast<const T*>(k.c), static_cast<T*>(k.out), k.ds_part,
      k.db_part, k.n, k.d, k.eps);
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

// The forward: a persistent grid of as many blocks as fit on the card at
// once (each group of G warps walks rows), never more than the rows need.
template <typename T, bool RMS, bool RES, bool BIAS, int NV, int G>
cudaError_t launch_fwd(const Call& k, cudaStream_t st) {
  auto kernel = norm_fwd_kernel<T, RMS, RES, BIAS, NV, G>;
  const size_t smem = sizeof(float) * (BIAS ? 2 : 1) * k.d;
  // blocks an SM at this shared-memory size, cached for the last d
  static int last_d = -1, per_sm = 0;
  if (k.d != last_d) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kFwdWarps * 32, smem);
    if (err != cudaSuccess) return err;
    last_d = k.d;
  }
  constexpr int groups = kFwdWarps / G;
  const int need = (k.n + groups - 1) / groups;
  const int blocks = std::min(need, std::max(1, per_sm * sm_count()));
  kernel<<<blocks, kFwdWarps * 32, smem, st>>>(
      static_cast<const T*>(k.a), static_cast<const T*>(k.b), k.scale,
      k.bias, static_cast<T*>(k.out), static_cast<T*>(k.h_out), k.n, k.d,
      k.eps);
  return cudaGetLastError();
}

// The forward's plan from the wrapper (ops/norm.py fwd_plan): G warps a
// row (1, 2, 4 or 8) and NV vectors a lane (1, 2 or 4), covering the row.
template <typename T, bool RMS, bool RES, bool BIAS>
cudaError_t pick_plan(int warps_per_row, int nv, const Call& k,
                      cudaStream_t st) {
  const int n_vec = k.d / Vec<T>::N;
  if (n_vec > 32 * warps_per_row * nv) return cudaErrorInvalidValue;
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

template <typename T, bool RMS, bool RES, bool BIAS, int NV>
cudaError_t launch_one(const Call& k, cudaStream_t st) {
  // the dscale (+ dbias) rows of kWarps warps; 4 warps where they do not
  // fit (only rows of more than 8 vectors a lane can pass the limit)
  const size_t row_bytes = sizeof(float) * (BIAS ? 2 : 1) * k.d;
  if constexpr (NV > 8) {
    if (row_bytes * kWarps > kMaxSmem)
      return launch_bwd<T, RMS, RES, BIAS, NV, 4>(k, row_bytes * 4, st);
  }
  return launch_bwd<T, RMS, RES, BIAS, NV, kWarps>(k, row_bytes * kWarps,
                                                    st);
}

// The backward's vectors a lane, from d.
template <typename T, bool RMS, bool RES, bool BIAS>
cudaError_t pick_nv(const Call& k, cudaStream_t st) {
  const int per_lane = (k.d / Vec<T>::N + 31) / 32;
  if (per_lane <= 1) return launch_one<T, RMS, RES, BIAS, 1>(k, st);
  if (per_lane <= 2) return launch_one<T, RMS, RES, BIAS, 2>(k, st);
  if (per_lane <= 4) return launch_one<T, RMS, RES, BIAS, 4>(k, st);
  if (per_lane <= 8) return launch_one<T, RMS, RES, BIAS, 8>(k, st);
  if (per_lane <= 16) return launch_one<T, RMS, RES, BIAS, 16>(k, st);
  // 32 vectors a lane only in f32, for d 2049-4096 (glm-10b's width):
  // no bf16 path runs them, only the f32 model check (train_model_glm)
  if constexpr (sizeof(T) == 4) {
    if (per_lane <= 32) return launch_one<T, RMS, RES, BIAS, 32>(k, st);
  }
  return cudaErrorInvalidValue;
}

// The kernel's kind from the flags: fwd (with the plan) or bwd.
template <typename T, bool RMS, bool RES, bool BIAS>
cudaError_t pick(bool fwd, int warps_per_row, int nv, const Call& k,
                 cudaStream_t st) {
  return fwd ? pick_plan<T, RMS, RES, BIAS>(warps_per_row, nv, k, st)
             : pick_nv<T, RMS, RES, BIAS>(k, st);
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
            n, d, eps};
  return dispatch(true, rms, res != nullptr, bias != nullptr, dtype,
                  warps_per_row, nv, k, stream);
}

// The partials ds_part / db_part are [ceil(n / 32), d] f32 (db_part only
// for layernorm with a bias); gh may be null (no residual).
int dlrover_norm_bwd(const void* g, const void* h, const float* scale,
                     const void* gh, void* dx, float* ds_part, float* db_part,
                     int n, int d, float eps, int rms, int dtype,
                     void* stream) {
  Call k = {g, h, scale, nullptr, gh, dx, nullptr, ds_part, db_part,
            n, d, eps};
  return dispatch(false, rms, gh != nullptr, db_part != nullptr, dtype, 0, 0,
                  k, stream);
}

int dlrover_norm_bwd_rows_per_block() { return kBwdRowsPerBlock; }

}  // extern "C"
