// The TMA + wgmma GEMM pipeline for Hopper (sm_90a) shared by K7
// (bf16_probe_gemm.cu: bf16 x bf16 -> f32) and K4's GEMM phase
// (fused_ch_gemm.cu: s8 x s8 -> s32):
//
//   acc[m,n] = sum_k a[m,k] * b[n,k]    a [M, K], b [N, K], both K-contiguous
//
// then a per-instantiation epilogue on the accumulator registers.  Both
// operands are K-major, which the s8 form of wgmma requires, so neither is
// transposed.
//
// Design.  A persistent grid (one block per SM) walks the BM x BN output
// tiles (128 x 256) in row-major order, N fastest, so the tiles in flight
// at a time share their A rows and all of B in L2.  Each tile walks K in
// chunks of 128 bytes: 64 bf16 values or 128 s8 codes, so a 32-byte K step
// is one wgmma of either kind (m64n256k16 bf16 or m64n256k32 s8) and the
// loop is the same for both.  The block has three warpgroups.  Warpgroup 0
// is the producer: one thread issues the TMA loads of each chunk (a 128 x
// 128-byte box of A and a 256 x 128-byte box of B, 128-byte swizzled, rows
// past M or N filled with zeros by the hardware) into a ring of four
// stages in shared memory, running ahead into the next tile while the
// consumers store the last one.  Warpgroups 1 and 2 are the consumers:
// each runs wgmma on a 64-row slab of A against the whole B chunk, keeping
// its 64 x 256 sum in registers (f32 or int32) over the whole K.  Every
// stage has a full barrier (the producer arms it with the box bytes, the
// TMA completes it) and an empty one (each consumer warpgroup arrives once
// the wgmma group that read the stage has retired, with one group still in
// flight).  setmaxnreg moves registers from the producer to the consumers.
// 128 x 256 tiles beat 128 x 128 ones at 4096^3 on an H100.
//
// Shared-memory descriptors: K-major with 128-byte swizzle, start address
// >> 4, leading offset unused (1), stride offset 1024 bytes (8 rows of 128
// bytes), layout SWIZZLE_128B; every buffer is 1024-byte aligned, and each
// 32-byte K step inside the 128-byte row adds 2 to the start address.
//
// The wgmma m64nN accumulator layout (f32 and s32 alike): thread t of a
// warpgroup, warp w = t / 32, g = (t % 32) / 4, q = t % 4, holds d[4j + 2h
// + e] at row 16w + g + 8h, column 8j + 2q + e of its 64 x BN slab: the
// m16n8 fragment layout, repeated over BN / 8 column blocks.
//
// Epilogue.  Once per tile, each consumer thread converts its fragment to
// f32 values v (exact for the s32 sums, which stay below 2^24).  The
// instantiation's functor, epi(v, j0, j1, row, col, M, N), with (row, col)
// the position of v[0], may rescale column blocks [j0, j1) of v in place
// (K4; K7 keeps the sums).  The pipeline calls it one output box at a
// time, just before it stores the box as Epi::Out (bf16, rounded to
// nearest even, or f32), so whatever the functor loads stays live for one
// box only.  Where a row of the output is a multiple of 16 bytes, each
// warpgroup writes its slab through a 16 KB staging area in shared memory
// (two 64-row x 128-byte boxes, 128-byte swizzled, so the fragment's
// writes hit 32 banks) and one thread sends each box out with a TMA store,
// which clips at M and N and leaves the warpgroup free to start its next
// tile.  (Stored straight from the registers, the fragment's scattered
// 4-byte writes held the consumers, and so the tensor cores, for much of
// each tile.)  Other widths store the column pairs directly
// (for_each_pair).
//
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint(ByVersion), so a source that
// includes this header needs no -lcuda.  Operands must be 16-byte aligned
// and K a multiple of 128 bytes (TMA's 16-byte stride rule holds then).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_common.cuh"

namespace wgmma_gemm {

using cuda_common::kMaxDevices;
using cuda_common::opt_in_smem;
using cuda_common::store_pair;

constexpr int BM = 128;                    // rows of an output tile
constexpr int CHUNK = 128;                 // bytes of K per stage
constexpr int CONSUMERS = 2;               // warpgroups of 64 rows each
constexpr int THREADS = 128 * (1 + CONSUMERS);
// A barrier wait longer than this traps (a launch error) instead of
// hanging the card.
constexpr unsigned long long kHangNs = 4000000000ull;

// Element types: accumulator, bytes per value, TMA data type.
struct Bf16 {
  using Acc = float;
  static constexpr int BYTES = 2;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
struct S8 {
  using Acc = int;
  static constexpr int BYTES = 1;
  // TMA copies bytes; the zero fill is the int8 zero
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

constexpr int BN = 256;                    // columns of an output tile
constexpr int A_BYTES = BM * CHUNK;
constexpr int B_BYTES = BN * CHUNK;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // 48 KB, 1024-aligned
constexpr int STAGES = 4;
constexpr int ACC = BN / 2;                // accumulators per consumer thread
constexpr int BOX_BYTES = 64 * 128;        // one output box: 64 x 128 bytes
constexpr int STAGING_BYTES = 2 * BOX_BYTES;   // per consumer warpgroup
// the ring, the staging buffers, the full and empty barriers, and slack to
// align the ring
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + CONSUMERS * STAGING_BYTES +
                           16 * STAGES + 1024;

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > kHangNs) __trap();
  }
}

// A 2-D TMA load of the box at (c0 = K element, c1 = row) into `dst`,
// completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A 2-D TMA store of the box at (c0 = column, c1 = row) from `src`.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// All but the last N bulk-store groups of the issuing thread have read
// their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// ... and have written device memory.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Make this thread's shared-memory writes visible to the TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier `id` over the 128 threads of one warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void st_shared_pair(uint32_t addr, float v0,
                                               float v1, __nv_bfloat16*) {
  const __nv_bfloat162 p =
      __halves2bfloat162(__float2bfloat16(v0), __float2bfloat16(v1));
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
               "r"(*reinterpret_cast<const uint32_t*>(&p))
               : "memory");
}
__device__ __forceinline__ void st_shared_pair(uint32_t addr, float v0,
                                               float v1, float*) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(v0),
               "f"(v1)
               : "memory");
}

// K-major, 128-byte swizzle: start >> 4, leading offset 1 (unused),
// stride offset 1024 bytes, layout SWIZZLE_128B (1 at bit 62).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of the accumulators across the
// asynchronous wgmma (which writes them after it was issued).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WG_F(x) "+f"(x)
#define WG_I(x) "+r"(x)
#define WG_8(C, d, i)                                                    \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]),           \
      C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define WG_64(C, d, i)                                                   \
  WG_8(C, d, i), WG_8(C, d, i + 8), WG_8(C, d, i + 16),                  \
      WG_8(C, d, i + 24), WG_8(C, d, i + 32), WG_8(C, d, i + 40),        \
      WG_8(C, d, i + 48), WG_8(C, d, i + 56)
#define WG_REGS64                                                        \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63"
#define WG_REGS128                                                       \
  WG_REGS64 ", "                                                         \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, " \
  "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, " \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "     \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// One 32-byte K step: d += A[64 x 32 B] . B[256 x 32 B]^T.
__device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_REGS128
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : WG_64(WG_F, d, 0), WG_64(WG_F, d, 64)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma(int (&d)[128], uint64_t da,
                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" WG_REGS128
      "}, %128, %129, p;\n}\n"
      : WG_64(WG_I, d, 0), WG_64(WG_I, d, 64)
      : "l"(da), "l"(db), "r"(1));
}

#undef WG_F
#undef WG_I
#undef WG_8
#undef WG_64
#undef WG_REGS64
#undef WG_REGS128

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// f(r, c, v0, v1) for every column pair (c, c + 1) of a consumer thread's
// fragment v, whose v[0] sits at (row, col), with r < M and c < N.
template <typename F>
__device__ __forceinline__ void for_each_pair(const float (&v)[ACC], int row,
                                              int col, int M, int N,
                                              const F& f) {
#pragma unroll
  for (int j = 0; j < ACC / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      const int c = col + 8 * j;
      if (r < M && c < N) f(r, c, v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
    }
}

// Store consumer warpgroup c's 64 x BN slab v (its fragment, rows from
// row0, columns from n0) with TMA stores of 64 x 128-byte boxes, through
// the two box buffers of its staging area in turn: box b is written while
// box b - 1 is still being read out.  Thread t's pair (j, h) lands in row
// r = 16w + g + 8h of its box, its 16-byte chunk k of the row at chunk
// k ^ (r % 8), the 128-byte swizzle (r % 8 is g), so the lanes of a warp
// spread over all 32 banks.
template <typename Epi>
__device__ __forceinline__ void store_slab(const Epi& epi, float (&v)[ACC],
                                           uint32_t staging,
                                           const CUtensorMap* map_out,
                                           int row0, int n0, int M, int N,
                                           int c) {
  using Out = typename Epi::Out;
  constexpr int CB = 128 / sizeof(Out);    // columns per box
  constexpr int JB = CB / 8;               // column blocks per box
  const int t = threadIdx.x % 128;
  const int w = t / 32;
  const int g = (t % 32) / 4;
  const int q = t % 4;
#pragma unroll
  for (int b = 0; b < BN / CB; ++b) {
    const uint32_t box = staging + (b % 2) * BOX_BYTES;
    epi(v, b * JB, (b + 1) * JB, row0 + 16 * w + g, n0 + 2 * q, M, N);
    // this buffer's last box has been read (the other's may still be)
    if (t == 0) bulk_wait_read<1>();
    warpgroup_sync(1 + c);
#pragma unroll
    for (int jb = 0; jb < JB; ++jb) {
      const int j = b * JB + jb;
      const int byte = (8 * jb + 2 * q) * static_cast<int>(sizeof(Out));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * w + g + 8 * h;
        st_shared_pair(box + r * 128 + (((byte / 16) ^ g) * 16) + byte % 16,
                       v[4 * j + 2 * h], v[4 * j + 2 * h + 1],
                       static_cast<Out*>(nullptr));
      }
    }
    fence_proxy_async();
    warpgroup_sync(1 + c);
    // a box that starts past M or N holds nothing to store
    if (t == 0 && row0 < M && n0 + b * CB < N) {
      tma_store(map_out, box, n0 + b * CB, row0);
    }
    if (t == 0) bulk_commit();
  }
}

template <typename E, typename Epi>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ CUtensorMap map_out, int tma_out, int M,
            int N, int nchunks, const Epi epi) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t staging = ring + STAGES * STAGE_BYTES;
  const uint32_t full = staging + CONSUMERS * STAGING_BYTES;
  const uint32_t empty = full + 8 * STAGES;
  const int wg = threadIdx.x / 128;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = n_tiles * ((M + BM - 1) / BM);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // `it` counts the chunks through the ring over all of the block's tiles:
  // stage it % STAGES, in its (it / STAGES)-th round
  if (wg == 0) {
    // producer: one thread keeps the ring filled, tile after tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * BM;
        const int n0 = (tile % n_tiles) * BN;
        for (int kc = 0; kc < nchunks; ++kc, ++it) {
          const int s = it % STAGES;
          const int round = it / STAGES;
          if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
          const uint32_t bar = full + 8 * s;
          const uint32_t buf = ring + s * STAGE_BYTES;
          const int k0 = kc * (CHUNK / E::BYTES);
          // a box clipped at M or N still lands (zero-filled) in full
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load(buf, &map_a, bar, k0, m0);
          tma_load(buf + A_BYTES, &map_b, bar, k0, n0);
        }
      }
    }
  } else {
    // consumers: warpgroup c runs rows [m0 + 64c, m0 + 64c + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const bool leader = t == 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * BM;
      const int n0 = (tile % n_tiles) * BN;
      typename E::Acc d[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) d[i] = 0;
      for (int kc = 0; kc < nchunks; ++kc, ++it) {
        const int s = it % STAGES;
        mbar_wait(full + 8 * s, (it / STAGES) & 1);
        const uint32_t buf = ring + s * STAGE_BYTES;
        const uint64_t da = smem_desc(buf + c * 64 * CHUNK);
        const uint64_t db = smem_desc(buf + A_BYTES);
        fence_acc(d);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < CHUNK / 32; ++ks) {
          mma(d, da + 2 * ks, db + 2 * ks);
        }
        wgmma_commit();
        fence_acc(d);
        // the group of the previous chunk has retired: its stage is free
        wgmma_wait<1>();
        if (kc > 0 && leader) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (leader) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
      const int row0 = m0 + 64 * c;
      float v[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) v[i] = static_cast<float>(d[i]);
      if (tma_out) {
        store_slab(epi, v, staging + c * STAGING_BYTES, &map_out, row0, n0,
                   M, N, c);
      } else {
        const int row = row0 + 16 * (t / 32) + (t % 32) / 4;
        const int col = n0 + 2 * (t % 4);
#pragma unroll
        for (int j0 = 0; j0 < ACC / 4; j0 += 8) {
          epi(v, j0, j0 + 8, row, col, M, N);
          asm volatile("" ::: "memory");   // one group's loads live at once
        }
        for_each_pair(v, row, col, M, N,
                      [&](int r, int cc, float v0, float v1) {
                        store_pair(epi.out, N, r, cc, v0, v1);
                      });
      }
    }
    if (leader) bulk_wait();
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The map of a [rows, cols] row-major matrix of `dtype` (elem_bytes a
// value), boxes of box_rows x 128 bytes, 128-byte swizzle, zero fill past
// the edges on loads and clipping on stores.
inline cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType dtype,
                            int elem_bytes, const void* ptr, int rows,
                            int cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(CHUNK / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, dtype, 2, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline CUtensorMapDataType tma_type(const __nv_bfloat16*) {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
inline CUtensorMapDataType tma_type(const float*) {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// The number of SMs of the current device.
inline int sm_count() {
  static int count[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (count[dev] == 0) {
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return count[dev];
}

// Launch out = epi(a [M, K] . b [N, K]^T) on `stream` (K in elements, a
// multiple of 128 / E::BYTES; a, b and epi.out 16-byte aligned): one block
// per SM, or one per tile where there are fewer tiles.
template <typename E, typename Epi>
cudaError_t launch(const void* a, const void* b, int M, int N, int K,
                   const Epi& epi, cudaStream_t stream) {
  using Out = typename Epi::Out;
  if (M <= 0 || N <= 0 || K <= 0 || (K * E::BYTES) % CHUNK != 0) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap map_a, map_b, map_out = {};
  cudaError_t e = make_map(&map_a, E::TMA, E::BYTES, a, M, K, BM);
  if (e == cudaSuccess) e = make_map(&map_b, E::TMA, E::BYTES, b, N, K, BN);
  // TMA stores need rows of a multiple of 16 bytes
  const int tma_out = (static_cast<long long>(N) * sizeof(Out)) % 16 == 0;
  if (e == cudaSuccess && tma_out) {
    e = make_map(&map_out, tma_type(epi.out), sizeof(Out), epi.out, M, N, 64);
  }
  if (e == cudaSuccess) e = opt_in_smem<gemm_kernel<E, Epi>>(SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const int tiles = ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const int sms = sm_count();
  const int blocks = sms > 0 && sms < tiles ? sms : tiles;
  gemm_kernel<E, Epi><<<blocks, THREADS, SMEM_BYTES, stream>>>(
      map_a, map_b, map_out, tma_out, M, N, K * E::BYTES / CHUNK, epi);
  return cudaGetLastError();
}

}  // namespace wgmma_gemm
