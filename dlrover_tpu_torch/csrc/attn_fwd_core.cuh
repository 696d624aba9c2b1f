// One Hopper tensor-core attention-forward core, shared by the flash
// forwards (flash_attention.cu: flash_fwd_wgmma_kernel, a head a block,
// and flash_fwd_packed_wgmma_kernel, two heads of 64 a block) and the
// paged prefill-chunk kernel (paged_attention.cu, paged_chunk_wgmma_kernel).
//
// A block is a producer warpgroup (two for int8 pages, which take the
// dequantization) and two consumer warpgroups. The producer keeps a ring
// of kStages K/V tiles of KEYS keys in shared memory (64 for the paged
// kernel, 128 for the flash kernels), each signalled through a "full"
// mbarrier and released through an "empty" one; it gives up registers
// (setmaxnreg) to the two consumer warpgroups. Where the K/V
// tiles come from is the kernel's business (TMA from a dense tensor, or
// cp.async gathers of pages through a block table); the core only fixes
// their layout and the handshake. Each consumer warpgroup holds 64 query
// rows and runs, per key tile (the one-head kernels: 128 rows a block
// over one head; the packed flash kernel: 64 rows a block, consumer j
// over head 2p + j, reading column block j of a stage laid out for
// D 128: consume()'s kv_off):
//
//   S = Q K^T         wgmma m64n{KEYS}k16, bf16 in, f32 accumulate; Q and
//                     K from shared memory, K-major, 128-byte swizzle;
//   mask              the kernel's policy answers: is the tile wholly
//                     visible to a warp's rows, or masked per element
//                     (masked scores -1e30)?
//   online softmax    in registers: p = 2^(s * scale * log2(e) - m'),
//                     the scale folded into one FMA and m' the scaled
//                     running max (0 while a row has seen no key, so its
//                     -1e30 scores give exactly 0); p is rounded to bf16
//                     for P.V while l sums the unrounded p; l == 0 is
//                     taken as 1 at the end;
//   O += P V          wgmma m64n{D}k16 with P as the register A operand
//                     (the score accumulator's layout is the A fragment's)
//                     and V from shared memory as the transposed
//                     (MN-major) B operand.
//
// The next tile's Q.K^T and this tile's P.V run on the tensor cores while
// the warpgroup computes the next tile's softmax (consume()).
//
// Shared-memory tiles. A tile of R rows (Q: 64; K, V: KEYS) is stored as
// D / 64 column blocks of [R rows][64 bf16], R * 128 bytes apart: 128-byte
// rows, the 16-byte chunk c of row r stored at chunk c ^ (r % 8) (the
// 128-byte swizzle TMA writes with CU_TENSOR_MAP_SWIZZLE_128B), blocks
// 1024-byte aligned. For S the tiles are K-major (D is the reduction,
// contiguous); for P.V the V tile is MN-major (D contiguous, keys along
// rows).
//
// Tile metadata. With every K/V stage the producer publishes a Meta:
// the first key of the tile, and (tiles of 64 keys) a mask of the keys
// that exist (the paged kernel's unassigned or out-of-range pages). A
// Meta with k0 < 0 ends the walk. Tiles that no row of the block can see
// are never published.


#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace attn_core {

constexpr int kRows = 64;         // query rows per consumer warpgroup
constexpr int kConsumers = 2;     // consumer warpgroups per block
// threads of a block with `producers` producer warpgroups
__host__ __device__ constexpr int block_threads(int producers) {
  return 128 * (producers + kConsumers);
}
constexpr int kStages = 3;        // K/V stages in flight
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Meta {
  int k0;          // first key of the tile; < 0 ends the walk
  int pad;
  uint64_t valid;  // bit i: key k0 + i exists (tiles of 64 keys)
};

// Byte offsets into the block's dynamic shared memory (1024-aligned
// base) for head dim D and K/V tiles of KEYS keys in a ring of NS stages.
// EXTRA: kernel-owned bytes (the paged kernel's int8 staging).
template <int D, int KEYS, int EXTRA, int NS = kStages>
struct Layout {
  static constexpr int kKeys = KEYS;
  static constexpr int kRingStages = NS;
  static constexpr int kQTile = (D / 64) * kRows * 128;  // 64 rows x D
  static constexpr int kKvTile = (D / 64) * KEYS * 128;  // KEYS rows x D
  static constexpr int q = 0;                            // kConsumers tiles
  static constexpr int kv = q + kConsumers * kQTile;     // stages: K, V
  static constexpr int extra = kv + NS * 2 * kKvTile;
  static constexpr int full = extra + EXTRA;             // NS mbarriers
  static constexpr int empty = full + 8 * NS;
  static constexpr int meta = empty + 8 * NS;            // NS Metas
  static constexpr int bytes = meta + 16 * NS;
  static constexpr int alloc = bytes + 1024;             // alignment slack
  static __device__ __forceinline__ uint32_t k_tile(uint32_t base, int s) {
    return base + kv + s * 2 * kKvTile;
  }
  static __device__ __forceinline__ uint32_t v_tile(uint32_t base, int s) {
    return k_tile(base, s) + kKvTile;
  }
};

// Offset of 16-byte chunk c (0 .. D / 8 - 1) of row r in a swizzled tile
// of ROWS rows.
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// barriers, copies, fences
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// The arrive-on of an mbarrier once every cp.async this thread issued
// so far has landed (counted as one of the barrier's arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// 16 bytes global -> shared; zero-filled without a read when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
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

// Generic-proxy shared-memory writes <-> the async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Barrier `id` (1 .. 15) over `threads` threads of the block.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// A 4-d TMA tile load into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// A 4-d TMA tile store from shared memory (the tensor map clips what lies
// past its bounds), in this thread's bulk group.
__device__ __forceinline__ void tma_store_4d(const void* map, uint32_t src,
                                             int c0, int c1, int c2,
                                             int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, "
      "%3, %4}], [%5];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
      : "memory");
}

// Commits this thread's bulk stores and waits until their shared-memory
// sources have been read.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptors for the 128-byte swizzle: SBO = 1024
// bytes between groups of 8 rows; LBO (MN-major only) = the next block
// of 64 columns along N, ROWS * 128 bytes on.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(ROWS * 128 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of wgmma are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from touching the registers of an asynchronous
// wgmma (accumulators, A fragments) before its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(a[j][k])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, "
      "0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers, B MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers, B MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "
      "%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_m64n128(o, a, db);
  else
    wgmma_rs_m64n64(o, a, db);
}

template <int KEYS>
__device__ __forceinline__ void wgmma_s(float (&d)[KEYS / 2], uint64_t da,
                                        uint64_t db, int accumulate) {
  if constexpr (KEYS == 128)
    wgmma_ss_m64n128(d, da, db, accumulate);
  else
    wgmma_ss_m64n64(d, da, db, accumulate);
}

// ---------------------------------------------------------------------------
// the block's setup and the producer's side of the handshake
// ---------------------------------------------------------------------------

// The 1024-aligned shared address of the block's dynamic shared memory.
__device__ __forceinline__ uint32_t smem_base() {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  return (smem_u32(dyn_smem) + 1023u) & ~1023u;
}

__device__ __forceinline__ unsigned char* smem_ptr(uint32_t addr) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  return dyn_smem + (addr - smem_u32(dyn_smem));
}

// Thread 0 initialises the barriers of the L::kRingStages stages: `full`
// expects `full_count` arrivals (plus the TMA bytes, if any), `empty` one
// per consumer thread. Every thread of the block must call this (it syncs
// them).
template <class L>
__device__ __forceinline__ void init_barriers(uint32_t base, int full_count) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kRingStages; ++s) {
      mbar_init(base + L::full + 8 * s, full_count);
      mbar_init(base + L::empty + 8 * s, 128 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();
}

// A position in a ring of NS stages. The producer's first pass over the
// stages waits on nothing (parity 1 of a fresh barrier counts as
// completed); the consumers wait on parity 0 of the full barriers.
template <int NS>
struct RingN {
  int stage = 0;
  int phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == NS) {
      stage = 0;
      phase ^= 1;
    }
  }
};
using Ring = RingN<kStages>;

template <class L, class R>
__device__ __forceinline__ void wait_empty(uint32_t base, const R& r) {
  mbar_wait(base + L::empty + 8 * r.stage, r.phase ^ 1);
}

template <class L>
__device__ __forceinline__ void write_meta(uint32_t base, int stage, int k0,
                                           uint64_t valid) {
  Meta* m = reinterpret_cast<Meta*>(smem_ptr(base + L::meta + 16 * stage));
  m->k0 = k0;
  m->valid = valid;
}

// ---------------------------------------------------------------------------
// the consumer warpgroup
// ---------------------------------------------------------------------------

// Q rows of this consumer warpgroup into its swizzled tile: row i (0 ..
// 63) from row_ptr(i) (D contiguous bf16, 16-byte aligned), or zeros
// where it returns null. Synchronises the warpgroup on barrier `bar_id`.
template <int D, class RowPtr>
__device__ __forceinline__ void load_q(uint32_t q_tile, int ct,
                                       RowPtr row_ptr, int bar_id) {
  constexpr int kChunks = D / 8;
  for (int i = ct; i < kRows * kChunks; i += 128) {
    const int r = i / kChunks, c = i % kChunks;
    const __nv_bfloat16* src = row_ptr(r);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr) v = *reinterpret_cast<const uint4*>(src + c * 8);
    *reinterpret_cast<uint4*>(smem_ptr(q_tile + swz<kRows>(r, c))) = v;
  }
  fence_proxy_async();
  named_sync(bar_id, 128);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x on the special-function unit (denormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The running state of a consumer thread: its two rows (g and g + 8 of
// its warp's 16) in the accumulator layout of m64nN: o[nt * 4 + i] is
// row (i < 2 ? g : g + 8), column nt * 8 + 2t + (i & 1).
template <int D>
struct State {
  float o[D / 2];
  float m[2];  // running max of the unscaled scores q.k
  float l[2];
};

// Walks the published K/V tiles until the end Meta. Both consumer
// warpgroups take every tile; where none of a row's keys is in a tile,
// its scores there are all masked and add exactly 0. Policy `pol`:
//   bool whole(const Meta&)  every row of this warp sees every key
//   T tile(const Meta&)      what allowed() needs of a masked tile,
//                            computed once a tile (key ranges relative to
//                            this thread's first key k0 + 2t, page bits)
//   bool allowed(const T&, int i, int c)  row i (0: g, 1: g + 8) of this
//                            thread sees key k0 + 2t + c; c = (e >> 2) * 8
//                            + (e & 1) for score e is a constant once
//                            unrolled, so a score costs a few compares
//                            and a select, no branch
// `scale_log2` = softmax scale * log2(e). Scores stay unscaled until the
// exponent: the masks compare raw q.k, whose order is the scaled one's.
// `kv_off`: bytes from a stage's K (and V) tile to the column block this
// warpgroup reads (0 but in the packed flash forward). `ring`: the
// consumers' position in the ring, left at the stage of the end Meta (a
// kernel that walks several times releases that stage and moves on).
// `q_done()` is called once, as soon as the walk has read Q for the last
// time (its end Meta seen, every Q.K^T landed): a persistent kernel
// releases the item's Q slot there, before the last P.V and the stores.
// `epi(stage)` is called once the last P.V has landed, before the last
// tile's stage is released, where the walk had a tile: the flash forward
// stages its output in that stage for a TMA store.
//
// Overlap: the next tile's Q.K^T and this tile's P.V run on the tensor
// cores while the warpgroup computes the next tile's softmax.
template <int D, class L, class Policy, class QDone, class Epi>
__device__ __forceinline__ void consume(uint32_t base, uint32_t q_tile,
                                        const Policy& pol, float scale_log2,
                                        State<D>& st, uint32_t kv_off,
                                        Ring& ring, QDone&& q_done,
                                        Epi&& epi) {
  constexpr int KEYS = L::kKeys;
  constexpr int NS = KEYS / 2;  // score registers a thread
#pragma unroll
  for (int i = 0; i < D / 2; ++i) st.o[i] = 0.f;
  st.m[0] = st.m[1] = kNegInf;
  st.l[0] = st.l[1] = 0.f;
  // the next tile; false at the end of the walk
  auto acquire = [&](Meta& mt, int& stg) {
    mbar_wait(base + L::full + 8 * ring.stage, ring.phase);
    fence_proxy_async();  // cp.async-written tiles, read by wgmma
    mt = *reinterpret_cast<const Meta*>(
        smem_ptr(base + L::meta + 16 * ring.stage));
    if (mt.k0 < 0) return false;
    stg = ring.stage;
    ring.advance();
    return true;
  };
  auto issue_s = [&](float (&s)[NS], int stg) {
    const uint32_t k_tile = L::k_tile(base, stg) + kv_off;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_s<KEYS>(
          s, desc_kmajor(q_tile + (ks >> 2) * kRows * 128 + (ks & 3) * 32),
          desc_kmajor(k_tile + (ks >> 2) * KEYS * 128 + (ks & 3) * 32),
          ks > 0);
    wgmma_commit();
  };
  // the online softmax of one score tile, in place: s becomes the
  // unrounded p; alpha rescales O; m and l run on
  auto softmax = [&](float (&s)[NS], const Meta& mt, float (&alpha)[2]) {
    // masked scores -1e30; the scale is folded into the exponent
    if (!pol.whole(mt)) {
      const auto tv = pol.tile(mt);
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = pol.allowed(tv, (i >> 1) & 1, (i >> 2) * 8 + (i & 1))
                   ? s[i]
                   : kNegInf;
    }
    float cur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < NS; ++i)
      cur[(i >> 1) & 1] = fmaxf(cur[(i >> 1) & 1], s[i]);
    float mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(st.m[r], quad_max(cur[r]));
      alpha[r] = ex2((st.m[r] - m_new) * scale_log2);
      st.m[r] = m_new;
      // a row that has seen no key yet: its masked scores give
      // ex2(-1e30 * scale) = 0, not ex2(0) = 1
      mc[r] = m_new == kNegInf ? 0.f : m_new * scale_log2;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      s[i] = ex2(fmaf(s[i], scale_log2, -mc[(i >> 1) & 1]));
      sum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      st.l[r] = alpha[r] * st.l[r] + quad_sum(sum[r]);
  };
  // p rounded to bf16, as the A fragments of P.V: n-tile nt = i / 4 of S
  // is half (nt & 1) of k-step nt / 2 of P
  auto to_p = [&](const float (&s)[NS], uint32_t (&pa)[KEYS / 16][4]) {
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const int nt = i >> 2;
      pa[nt >> 1][(nt & 1) * 2 + ((i >> 1) & 1)] = pack_bf16(s[i], s[i + 1]);
    }
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) st.o[i] *= alpha[(i >> 1) & 1];
  };
  auto issue_pv = [&](const uint32_t (&pa)[KEYS / 16][4], int stg) {
    const uint32_t v_tile = L::v_tile(base, stg) + kv_off;
#pragma unroll
    for (int j = 0; j < KEYS / 16; ++j)
      wgmma_pv<D>(st.o, pa[j], desc_mnmajor<KEYS>(v_tile + j * 16 * 128));
    wgmma_commit();
  };
  auto release = [&](int stg) { mbar_arrive(base + L::empty + 8 * stg); };

  // The order of FlashAttention-3's intra-warpgroup overlap: the next
  // tile's Q.K^T, then this tile's P.V (O rescaled first), both in flight
  // while the next tile's softmax runs in place on its scores; P is
  // rounded into its registers once this P.V has landed. Every wgmma is
  // issued unconditionally between its fence and its wait, with its
  // registers pinned on both sides (fence_regs): a wgmma under a branch,
  // or a register of a wgmma in flight written or copied, makes the
  // compiler serialize every wgmma of the kernel.
  Meta mt;
  int cur;
  if (!acquire(mt, cur)) {
    q_done();
    return;
  }
  float s[NS], alpha[2];
  uint32_t pa[KEYS / 16][4];
  fence_regs(s);
  wgmma_fence();
  issue_s(s, cur);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(s, mt, alpha);  // O is still 0: alpha changes nothing
  to_p(s, pa);
  Meta mn;
  int nxt;
  while (acquire(mn, nxt)) {
    fence_regs(s);
    wgmma_fence();
    issue_s(s, nxt);
    rescale(alpha);
    fence_regs(st.o);
    wgmma_fence();
    issue_pv(pa, cur);
    wgmma_wait<1>();  // the next tile's scores
    fence_regs(s);
    softmax(s, mn, alpha);
    wgmma_wait<0>();
    fence_regs(st.o);
    fence_regs(pa);
    release(cur);
    to_p(s, pa);
    cur = nxt;
  }
  q_done();
  // the last tile's P.V
  rescale(alpha);
  fence_regs(st.o);
  wgmma_fence();
  issue_pv(pa, cur);
  wgmma_wait<0>();
  fence_regs(st.o);
  epi(cur);
  release(cur);
}

// One walk from a fresh ring (a kernel that walks once a block:
// paged_chunk_wgmma_kernel).
template <int D, class L, class Policy>
__device__ __forceinline__ void consume(uint32_t base, uint32_t q_tile,
                                        const Policy& pol, float scale_log2,
                                        State<D>& st) {
  Ring ring;
  consume<D, L>(base, q_tile, pol, scale_log2, st, 0, ring, [] {},
                [](int) {});
}

// Row i (0: g, 1: g + 8) of this thread's output as bf16, times 1 / l
// (l == 0 -> 1: a row that saw no key is exactly 0): one division a row,
// not one an element (those took a quarter of K1's cycles).
template <int D>
__device__ __forceinline__ void store_row(const State<D>& st, int i,
                                          __nv_bfloat16* dst) {
  const int t = threadIdx.x & 3;
  const float inv = 1.f / (st.l[i] == 0.f ? 1.f : st.l[i]);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8 + 2 * t) =
        __floats2bfloat162_rn(st.o[nt * 4 + 2 * i] * inv,
                              st.o[nt * 4 + 2 * i + 1] * inv);
}

}  // namespace attn_core
