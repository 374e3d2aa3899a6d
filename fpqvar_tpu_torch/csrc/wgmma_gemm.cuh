// The TMA + wgmma GEMM pipeline for Hopper (sm_90a) shared by K7
// (bf16_probe_gemm.cu: bf16 x bf16 -> f32), K4's GEMM phase, K3 and K6
// (fused_ch_gemm.cu, int8ch_gemm.cu: s8 x s8 -> s32, the rescale of
// ch_rescale.cuh; int8_probe_gemm.cu: the s32 sums stored as bf16) and K1
// and K5 (int8_group_gemm.cu, int8_nd_gemm.cu: s8 x s8 -> s32 per scale
// group, folded into f32 by group_fold.cuh):
//
//   acc[m,n] = sum_k a[m,k] * b[n,k]    a [M, K], b [N, K], both K-contiguous
//
// then a per-instantiation epilogue on the accumulator registers.  Both
// operands are K-major, which the s8 form of wgmma requires, so neither is
// transposed.  A sibling kernel further down (rs_gemm_kernel, K2:
// packed_dequant_gemm.cu) takes its A operand from registers instead.
//
// Group fold (K1, K5).  An epilogue functor with a member fold() turns the
// wgmma sum into a per-group part: the first wgmma of each scale group
// runs with scale-d = 0 (the part starts afresh), and once the group's
// wgmmas have retired the functor folds the part into an f32 sum of its
// own (acc += part * scales), which the epilogue then stores.  K1 and K5
// run with BN = 128 (a template parameter), so that the int32 part and the
// f32 sum (64 + 64 registers a thread) fit in a consumer's registers.
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
// f32 values v.  An s32 sum converts with static_cast<float>
// (cvt.rn.f32.s32, nearest even): exact for K3's and K4's sums (|code| <=
// 64 and K <= 4096 keep them within 2^24), rounded for K6's, whose full
// int8 codes reach 2^26 at K = 4096 (the first of the two roundings of
// PyTorch's and JAX's int32 -> bf16 conversion; the bf16 store is the
// second).  The instantiation's functor, epi(v, j0, j1, row, col, M, N),
// with (row, col) the position of v[0], may rescale column blocks [j0, j1)
// of v in place (K3, K4; K6 and K7 keep the sums, and K1 and K5 folded
// their scales in already).  The pipeline calls it one output box at a time, just before
// it stores the box as Epi::Out (bf16, rounded to nearest even, or f32),
// so whatever the functor loads stays live for one box only.  Where a row
// of the output is a multiple of 16 bytes, each warpgroup writes its slab
// through a 16 KB staging area in shared memory (two 64-row x 128-byte
// boxes, 128-byte swizzled, so the fragment's writes hit 32 banks) and one
// thread sends each box out with a TMA store, which clips at M and N and
// leaves the warpgroup free to start its next tile.  (Stored straight from the registers, the fragment's scattered
// 4-byte writes held the consumers, and so the tensor cores, for much of
// each tile.)  Other widths store the column pairs directly
// (for_each_pair).
//
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint(ByVersion), so a source that
// includes this header needs no -lcuda.  Operands must be 16-byte aligned
// and K a multiple of 128 bytes (TMA's 16-byte stride rule holds then).
// The weight operand's map (b, and K2's codes) is kept in a cache keyed by
// everything the encoder reads (pointer, dims, strides, type, box,
// swizzle), so a hit is the map the encoder would give, even where an
// allocation was freed and its address reused; a call encodes only the
// maps of its activation and its output.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <unordered_map>

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

constexpr int BN = 256;                    // tile columns (K3, K4, K7)
constexpr int STAGES = 4;
constexpr int ACC = BN / 2;                // accumulators per consumer thread
constexpr int BOX_BYTES = 64 * 128;        // one output box: 64 x 128 bytes
constexpr int STAGING_BYTES = 2 * BOX_BYTES;   // per consumer warpgroup
constexpr int SMEM_LIMIT = 232448;         // dynamic shared memory a block

// The sizes of a BM x BN_ tile.
template <int BN_>
struct Tile {
  static constexpr int A_BYTES = BM * CHUNK;
  static constexpr int B_BYTES = BN_ * CHUNK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;   // 1024-aligned
  static constexpr int ACC = BN_ / 2;      // accumulators a consumer thread
  // the ring, the staging buffers, the full and empty barriers, and slack
  // to align the ring
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES +
                                    CONSUMERS * STAGING_BYTES + 16 * STAGES +
                                    1024;
};

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
__device__ __forceinline__ void st_shared_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ uint32_t ld_shared_u16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr) : "memory");
  return v;
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

template <int N>
__device__ __forceinline__ void fence_acc(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WG_F(x) "+f"(x)
#define WG_I(x) "+r"(x)
#define WG_8(C, d, i)                                                    \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]),           \
      C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define WG_32(C, d, i)                                                   \
  WG_8(C, d, i), WG_8(C, d, i + 8), WG_8(C, d, i + 16), WG_8(C, d, i + 24)
#define WG_64(C, d, i) WG_32(C, d, i), WG_32(C, d, i + 32)
#define WG_REGS8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_REGS32                                                        \
  WG_REGS8 ", %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_REGS64                                                        \
  WG_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "   \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63"
#define WG_REGS128                                                       \
  WG_REGS64 ", "                                                         \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, " \
  "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, " \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "     \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// One 32-byte K step: d = A[64 x 32 B] . B[BN x 32 B]^T + (scale_d ? d : 0),
// both operands from shared memory.
__device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_REGS128
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : WG_64(WG_F, d, 0), WG_64(WG_F, d, 64)
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void mma(int (&d)[128], uint64_t da,
                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" WG_REGS128
      "}, %128, %129, p;\n}\n"
      : WG_64(WG_I, d, 0), WG_64(WG_I, d, 64)
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db,
                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" WG_REGS64
      "}, %64, %65, p;\n}\n"
      : WG_64(WG_I, d, 0)
      : "l"(da), "l"(db), "r"(scale_d));
}

// One 16-value K step with A from registers (the m16n8k16 A fragment of
// each warp's 16 rows, bf16 pairs): d = A[64 x 16] . B[N x 16]^T +
// (scale_d ? d : 0), N = 16, 64 or 128, B K-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[8], const uint32_t (&a)[4],
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {" WG_REGS8
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : WG_8(WG_F, d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WG_32(WG_F, d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_REGS64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WG_64(WG_F, d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef WG_F
#undef WG_I
#undef WG_8
#undef WG_32
#undef WG_64
#undef WG_REGS8
#undef WG_REGS32
#undef WG_REGS64
#undef WG_REGS128

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// f(r, c, v0, v1) for every column pair (c, c + 1) of a consumer thread's
// fragment v, whose v[0] sits at (row, col), with r < M and c < N.
template <int NV, typename F>
__device__ __forceinline__ void for_each_pair(const float (&v)[NV], int row,
                                              int col, int M, int N,
                                              const F& f) {
#pragma unroll
  for (int j = 0; j < NV / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      const int c = col + 8 * j;
      if (r < M && c < N) f(r, c, v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
    }
}

// Store consumer warpgroup c's 64 x BN_ slab v (its fragment, rows from
// row0, columns from n0) with TMA stores of 64 x 128-byte boxes, through
// the two box buffers of its staging area in turn: box b is written while
// box b - 1 is still being read out.  Thread t's pair (j, h) lands in row
// r = 16w + g + 8h of its box, its 16-byte chunk k of the row at chunk
// k ^ (r % 8), the 128-byte swizzle (r % 8 is g), so the lanes of a warp
// spread over all 32 banks.
template <int BN_, typename Epi>
__device__ __forceinline__ void store_slab(const Epi& epi,
                                           float (&v)[BN_ / 2],
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
  for (int b = 0; b < BN_ / CB; ++b) {
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

// An epilogue functor that folds scale groups (K1, K5) has chunks_per_group,
// load_scales(group, row, col, M, N), called before the group's wgmmas are
// issued, and fold(acc, part, scales), after they retire.
template <typename T, typename = void>
struct HasFold : std::false_type {};
template <typename T>
struct HasFold<T, std::void_t<decltype(&T::fold)>> : std::true_type {};

// The scales of a group (nothing where nothing is folded).
template <typename Epi>
__device__ __forceinline__ auto fold_scales(const Epi& epi, int g, int row,
                                            int col, int M, int N) {
  if constexpr (HasFold<Epi>::value) {
    return epi.load_scales(g, row, col, M, N);
  } else {
    return 0;
  }
}

// The chunks of a scale group: the whole K where nothing is folded.
template <typename Epi>
__device__ __forceinline__ int group_chunks(const Epi& epi, int nchunks) {
  if constexpr (HasFold<Epi>::value) {
    return epi.chunks_per_group;
  } else {
    return nchunks;
  }
}

template <typename E, typename Epi, int BN_>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ CUtensorMap map_out, int tma_out, int M,
            int N, int nchunks, const Epi epi) {
  using T = Tile<BN_>;
  constexpr bool kFold = HasFold<Epi>::value;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t staging = ring + STAGES * T::STAGE_BYTES;
  const uint32_t full = staging + CONSUMERS * STAGING_BYTES;
  const uint32_t empty = full + 8 * STAGES;
  const int wg = threadIdx.x / 128;
  const int n_tiles = (N + BN_ - 1) / BN_;
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
        const int n0 = (tile % n_tiles) * BN_;
        for (int kc = 0; kc < nchunks; ++kc, ++it) {
          const int s = it % STAGES;
          const int round = it / STAGES;
          if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
          const uint32_t bar = full + 8 * s;
          const uint32_t buf = ring + s * T::STAGE_BYTES;
          const int k0 = kc * (CHUNK / E::BYTES);
          // a box clipped at M or N still lands (zero-filled) in full
          mbar_expect_tx(bar, T::STAGE_BYTES);
          tma_load(buf, &map_a, bar, k0, m0);
          tma_load(buf + T::A_BYTES, &map_b, bar, k0, n0);
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
      const int n0 = (tile % n_tiles) * BN_;
      const int row0 = m0 + 64 * c;
      const int row = row0 + 16 * (t / 32) + (t % 32) / 4;
      const int col = n0 + 2 * (t % 4);
      typename E::Acc d[T::ACC];
      float acc[kFold ? T::ACC : 1];
#pragma unroll
      for (int i = 0; i < T::ACC; ++i) d[i] = 0;
#pragma unroll
      for (int i = 0; i < (kFold ? T::ACC : 1); ++i) acc[i] = 0.f;
      // K in scale groups of cpg chunks (one group of the whole K where
      // nothing is folded).  Every wait sits outside any data-dependent
      // branch: a wait that ptxas cannot place (a fold under an `if`) makes
      // it insert its own and serialize the wgmmas.
      const int cpg = group_chunks(epi, nchunks);
      for (int kg = 0; kg < nchunks; kg += cpg) {
        [[maybe_unused]] const auto scales =
            fold_scales(epi, kg / cpg, row, col, M, N);
        for (int kk = 0; kk < cpg; ++kk, ++it) {
          const int s = it % STAGES;
          mbar_wait(full + 8 * s, (it / STAGES) & 1);
          const uint32_t buf = ring + s * T::STAGE_BYTES;
          const uint64_t da = smem_desc(buf + c * 64 * CHUNK);
          const uint64_t db = smem_desc(buf + T::A_BYTES);
          fence_acc(d);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < CHUNK / 32; ++ks) {
            // a scale group's first wgmma starts its part afresh
            mma(d, da + 2 * ks, db + 2 * ks, kFold && kk == 0 && ks == 0 ? 0
                                                                          : 1);
          }
          wgmma_commit();
          fence_acc(d);
          // the group of the previous chunk has retired: its stage is free
          wgmma_wait<1>();
          if (kk > 0 && leader) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
        }
        wgmma_wait<0>();
        fence_acc(d);
        if (leader) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
        if constexpr (kFold) epi.fold(acc, d, scales);
      }
      float v[T::ACC];
#pragma unroll
      for (int i = 0; i < T::ACC; ++i) {
        if constexpr (kFold) {
          v[i] = acc[i];
        } else {
          v[i] = static_cast<float>(d[i]);
        }
      }
      if (tma_out) {
        store_slab<BN_>(epi, v, staging + c * STAGING_BYTES, &map_out, row0,
                        n0, M, N, c);
      } else {
#pragma unroll
        for (int j0 = 0; j0 < T::ACC / 4; j0 += 8) {
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
// The register-A sibling (K2)
// ---------------------------------------------------------------------------
//
//   out[m,n] = sum_g s[g,n] * sum_{k in g} x[m,k] * w[n,k]      (f32 out)
//
// with w[n,k] = grid[code[n,k]] decoded in registers.  Only wgmma's A
// operand may come from registers, so the operands are swapped: a block
// computes out^T = w . x^T for a tile of 128 weight rows (n) and BX rows of
// x (m; BX = 16, 64 or 128 is wgmma's N).  The producer's TMA loads, per
// 128-value K chunk, the x box (BX rows, as two 64-value boxes, 128-byte
// swizzled: the B operand, K-major as in the kernel above) and the raw code
// box (Dec::CODE_ROWS rows x 128 bytes, 128-byte swizzled).  Consumer
// warpgroup c owns weight rows [64c, 64c + 64) of the tile: for each
// 16-value K step it reads its m16n8k16 A fragment's codes (four 16-bit
// pieces: rows g and g + 8 of its warp, K columns 2q and 2q + 8), decodes
// them with Dec::pair into four bf16 pairs and issues an RS wgmma.  Two
// fragment buffers alternate, so step k + 1 is decoded while step k's
// wgmma runs (wait_group 1 frees the buffer of step k - 1).  Each scale
// group starts a fresh f32 part (scale-d = 0); once its wgmmas retire the
// part is folded into the f32 sum, acc += part * s[g, n] (n is the
// accumulator's row: two scales a thread).  The epilogue writes acc
// transposed into a swizzled staging area (per warpgroup two boxes of BX
// rows of out x 32 f32 columns) and sends it with TMA stores, or, where a
// row of out is not a multiple of 16 bytes, stores it directly.
//
// Dec (the format): CODE_ROWS (code box rows a tile: 64 for row-split
// nibbles, 128 for one code a byte), code_rows(N) (rows of the code
// matrix), code_row(n0) (first code row of a tile), box_row(c) (first box
// row of consumer c's 64 weight rows) and pair(piece, c) (the bf16 pair,
// low half first, of the two codes in a 16-bit piece of two code bytes).

template <typename Dec, int BX>
struct RsTile {
  static constexpr int X_BOX = BX * CHUNK;          // BX rows x 64 bf16
  static constexpr int X_BYTES = 2 * X_BOX;         // 128 values of K
  static constexpr int STAGE_BYTES = X_BYTES + Dec::CODE_ROWS * CHUNK;
  static constexpr int OUT_BOX = BX * 128;          // BX rows x 32 f32
  static constexpr int STAGING = CONSUMERS * 2 * OUT_BOX;
  static constexpr int FIT = (SMEM_LIMIT - STAGING - 1024 - 16 * 8) /
                             STAGE_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + STAGING +
                                    16 * STAGES + 1024;
  static constexpr int ACC = BX / 2;                // f32 a thread, per sum
  static_assert(STAGES >= 2, "the ring needs two stages");
};

template <typename Dec, int BX>
__global__ void __launch_bounds__(THREADS, 1)
rs_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_codes,
               const __grid_constant__ CUtensorMap map_out, int tma_out,
               float* __restrict__ out, const float* __restrict__ scales,
               int M, int N, int nchunks, int chunks_per_group) {
  using T = RsTile<Dec, BX>;
  constexpr int STAGES_ = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t staging = ring + STAGES_ * T::STAGE_BYTES;
  const uint32_t full = staging + T::STAGING;
  const uint32_t empty = full + 8 * STAGES_;
  const int wg = threadIdx.x / 128;
  const int n_tiles = (N + BM - 1) / BM;
  const int tiles = n_tiles * ((M + BX - 1) / BX);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES_; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * BX;
        const int n0 = (tile % n_tiles) * BM;
        for (int kc = 0; kc < nchunks; ++kc, ++it) {
          const int s = it % STAGES_;
          const int round = it / STAGES_;
          if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
          const uint32_t bar = full + 8 * s;
          const uint32_t buf = ring + s * T::STAGE_BYTES;
          const int k0 = kc * CHUNK;
          mbar_expect_tx(bar, T::STAGE_BYTES);
          tma_load(buf, &map_x, bar, k0, m0);
          tma_load(buf + T::X_BOX, &map_x, bar, k0 + CHUNK / 2, m0);
          tma_load(buf + T::X_BYTES, &map_codes, bar, k0, Dec::code_row(n0));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int t = threadIdx.x % 128;
    const int w = t / 32;
    const int g = (t % 32) / 4;
    const int q = t % 4;
    const bool leader = t == 0;
    // the code bytes of this thread's fragment rows (box rows r and r + 8,
    // r % 8 == g, so K step ks sits in the swizzled 16-byte chunk ks ^ g)
    const uint32_t row_off = (Dec::box_row(c) + 16 * w + g) * CHUNK + 2 * q;
    const int nrow = 64 * c + 16 * w + g;   // weight row of a[0] in a tile
    float part[T::ACC];
#pragma unroll
    for (int i = 0; i < T::ACC; ++i) part[i] = 0.f;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * BX;
      const int n0 = (tile % n_tiles) * BM;
      float acc[T::ACC];
#pragma unroll
      for (int i = 0; i < T::ACC; ++i) acc[i] = 0.f;
      // K in scale groups of chunks_per_group chunks; the waits sit
      // outside any data-dependent branch (see gemm_kernel)
      for (int kg = 0; kg < nchunks; kg += chunks_per_group) {
        // the group's two scales, loaded before its wgmmas
        const float* sg = scales +
                          static_cast<size_t>(kg / chunks_per_group) * N +
                          n0 + nrow;
        const float sc[2] = {n0 + nrow < N ? sg[0] : 0.f,
                             n0 + nrow + 8 < N ? sg[8] : 0.f};
        for (int kk = 0; kk < chunks_per_group; ++kk, ++it) {
          const int s = it % STAGES_;
          mbar_wait(full + 8 * s, (it / STAGES_) & 1);
          const uint32_t buf = ring + s * T::STAGE_BYTES;
          const uint32_t codes = buf + T::X_BYTES + row_off;
          uint32_t a[2][4];
#pragma unroll
          for (int ks = 0; ks < CHUNK / 16; ++ks) {
            uint32_t(&f)[4] = a[ks & 1];
            const uint32_t p = codes + ((ks ^ g) << 4);
            f[0] = Dec::pair(ld_shared_u16(p), c);
            f[1] = Dec::pair(ld_shared_u16(p + 8 * CHUNK), c);
            f[2] = Dec::pair(ld_shared_u16(p + 8), c);
            f[3] = Dec::pair(ld_shared_u16(p + 8 * CHUNK + 8), c);
            fence_acc(f);
            fence_acc(part);
            wgmma_fence();
            mma_rs(part, f,
                   smem_desc(buf + (ks / 4) * T::X_BOX) + 2 * (ks % 4),
                   kk == 0 && ks == 0 ? 0 : 1);
            wgmma_commit();
            fence_acc(part);
            wgmma_wait<1>();   // step ks - 1 retired: its buffer is free
            fence_acc(part);
            // the previous chunk's wgmmas have retired: its stage is free
            if (ks == 0 && kk > 0 && leader) {
              mbar_arrive(empty + 8 * ((it - 1) % STAGES_));
            }
          }
        }
        wgmma_wait<0>();
        fence_acc(part);
        if (leader) mbar_arrive(empty + 8 * ((it - 1) % STAGES_));
#pragma unroll
        for (int i = 0; i < T::ACC; ++i) {
          acc[i] = fmaf(part[i], sc[(i >> 1) & 1], acc[i]);
        }
      }
      // acc[4j + 2h + e] is out[m0 + 8j + 2q + e, n0 + nrow + 8h]
      if (tma_out) {
        const uint32_t stg = staging + c * 2 * T::OUT_BOX;
        // the previous tile's boxes have been read out of the staging area
        if (leader) bulk_wait_read<0>();
        warpgroup_sync(1 + c);
#pragma unroll
        for (int j = 0; j < BX / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int nl = 16 * w + g + 8 * h;   // 0..63: box nl / 32
              const int m = 8 * j + 2 * q + e;
              const int byte = (nl % 32) * 4;
              st_shared_f32(stg + (nl / 32) * T::OUT_BOX + m * 128 +
                                (((byte / 16) ^ (m % 8)) * 16) + byte % 16,
                            acc[4 * j + 2 * h + e]);
            }
        fence_proxy_async();
        warpgroup_sync(1 + c);
        if (leader) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int nb = n0 + 64 * c + 32 * b;
            if (m0 < M && nb < N) {
              tma_store(&map_out, stg + b * T::OUT_BOX, nb, m0);
            }
          }
          bulk_commit();
        }
      } else {
#pragma unroll
        for (int j = 0; j < BX / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int m = m0 + 8 * j + 2 * q + e;
              const int n = n0 + nrow + 8 * h;
              if (m < M && n < N) {
                out[static_cast<size_t>(m) * N + n] = acc[4 * j + 2 * h + e];
              }
            }
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

// What make_map's encode reads: the pointer, the dims, the type and value
// size (the stride is cols * elem_bytes, the box 128 bytes wide and
// box_rows high, the swizzle 128 bytes, for every map).
struct MapKey {
  const void* ptr;
  int dtype, elem_bytes, rows, cols, box_rows;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && dtype == o.dtype && elem_bytes == o.elem_bytes &&
           rows == o.rows && cols == o.cols && box_rows == o.box_rows;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = reinterpret_cast<size_t>(k.ptr);
    for (int v : {k.dtype, k.elem_bytes, k.rows, k.cols, k.box_rows}) {
      h = h * 1000003u ^ static_cast<size_t>(v);
    }
    return h;
  }
};
struct MapCache {
  std::mutex mu;
  std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  long long hits = 0, misses = 0;
};
inline MapCache& map_cache() {
  static MapCache cache;
  return cache;
}

// make_map through the cache: for operands that outlive a call (weights).
inline cudaError_t cached_map(CUtensorMap* map, CUtensorMapDataType dtype,
                              int elem_bytes, const void* ptr, int rows,
                              int cols, int box_rows) {
  MapCache& cache = map_cache();
  const MapKey key{ptr, static_cast<int>(dtype), elem_bytes, rows, cols,
                   box_rows};
  {
    std::lock_guard<std::mutex> lock(cache.mu);
    auto hit = cache.maps.find(key);
    if (hit != cache.maps.end()) {
      *map = hit->second;
      ++cache.hits;
      return cudaSuccess;
    }
  }
  const cudaError_t e =
      make_map(map, dtype, elem_bytes, ptr, rows, cols, box_rows);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(cache.mu);
  if (cache.maps.size() >= 4096) cache.maps.clear();   // bounded
  cache.maps.emplace(key, *map);
  ++cache.misses;
  return cudaSuccess;
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

// One block per SM, or one per tile where there are fewer tiles.
inline int grid_blocks(int tiles) {
  const int sms = sm_count();
  return sms > 0 && sms < tiles ? sms : tiles;
}

// Launch out = epi(a [M, K] . b [N, K]^T) on `stream` over BM x BN_ tiles
// (K in elements, a multiple of 128 / E::BYTES; a, b and epi.out 16-byte
// aligned).  b is the weight: its map comes from the cache.
template <typename E, int BN_ = BN, typename Epi>
cudaError_t launch(const void* a, const void* b, int M, int N, int K,
                   const Epi& epi, cudaStream_t stream) {
  using Out = typename Epi::Out;
  using T = Tile<BN_>;
  if (M <= 0 || N <= 0 || K <= 0 || (K * E::BYTES) % CHUNK != 0) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap map_a, map_b, map_out = {};
  cudaError_t e = make_map(&map_a, E::TMA, E::BYTES, a, M, K, BM);
  if (e == cudaSuccess) {
    e = cached_map(&map_b, E::TMA, E::BYTES, b, N, K, BN_);
  }
  // TMA stores need rows of a multiple of 16 bytes
  const int tma_out = (static_cast<long long>(N) * sizeof(Out)) % 16 == 0;
  if (e == cudaSuccess && tma_out) {
    e = make_map(&map_out, tma_type(epi.out), sizeof(Out), epi.out, M, N, 64);
  }
  if (e == cudaSuccess) {
    e = opt_in_smem<gemm_kernel<E, Epi, BN_>>(T::SMEM_BYTES);
  }
  if (e != cudaSuccess) return e;
  const int tiles = ((N + BN_ - 1) / BN_) * ((M + BM - 1) / BM);
  gemm_kernel<E, Epi, BN_><<<grid_blocks(tiles), THREADS, T::SMEM_BYTES,
                             stream>>>(map_a, map_b, map_out, tma_out, M, N,
                                       K * E::BYTES / CHUNK, epi);
  return cudaGetLastError();
}

// Launch rs_gemm_kernel<Dec, BX> on `stream`: x [M, K] bf16, codes
// [Dec::code_rows(N), K] (the weight: its map comes from the cache),
// scales [K / group, N] f32, out [M, N] f32; K and group multiples of 128,
// x and codes 16-byte aligned.
template <typename Dec, int BX>
cudaError_t launch_rs(const void* x, const void* codes, const float* scales,
                      float* out, int M, int N, int K, int group,
                      cudaStream_t stream) {
  using T = RsTile<Dec, BX>;
  CUtensorMap map_x, map_codes, map_out = {};
  cudaError_t e = make_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M,
                           K, BX);
  if (e == cudaSuccess) {
    e = cached_map(&map_codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes,
                   Dec::code_rows(N), K, Dec::CODE_ROWS);
  }
  const int tma_out = N % 4 == 0;          // rows of a multiple of 16 bytes
  if (e == cudaSuccess && tma_out) {
    e = make_map(&map_out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, M, N, BX);
  }
  if (e == cudaSuccess) {
    e = opt_in_smem<rs_gemm_kernel<Dec, BX>>(T::SMEM_BYTES);
  }
  if (e != cudaSuccess) return e;
  const int tiles = ((N + BM - 1) / BM) * ((M + BX - 1) / BX);
  rs_gemm_kernel<Dec, BX><<<grid_blocks(tiles), THREADS, T::SMEM_BYTES,
                            stream>>>(map_x, map_codes, map_out, tma_out, out,
                                      scales, M, N, K / CHUNK, group / CHUNK);
  return cudaGetLastError();
}

}  // namespace wgmma_gemm
