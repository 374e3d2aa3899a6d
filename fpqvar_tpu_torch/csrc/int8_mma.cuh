// The mma.sync tile loop of the rate probe's full-K s8 x s8 -> s32 GEMM
// for Hopper (sm_90a), K6 (int8_probe_gemm.cu), staging 128-byte K chunks
// with cp.async.  (Every GEMM of the generation path runs the TMA + wgmma
// pipeline of wgmma_gemm.cuh: K1, K3, K4, K5 and K7 its s8 or bf16
// instantiations, K2 its register-A sibling.)
//
// One thread block owns one 128x128 output tile and walks K in chunks of
// 128 int8 codes.  A chunk of A (128 rows of the block's M tile) and of B
// (128 rows of its N tile, in the [N, K] layout: mma.sync wants the B
// operand K-contiguous) sits in shared memory, rows padded to 144 bytes so
// the 32-bit fragment loads hit 32 distinct banks.  Eight warps (2 x 4)
// each own a 64x32 sub-tile and run mma.sync m16n8k32 s8 into int32
// registers on it (k_loop); the epilogue stores through store_tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cuda_common.cuh"

namespace int8mma {

using cuda_common::opt_in_smem;
using cuda_common::store1;
using cuda_common::store2;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 128;                 // K chunk staged per pipeline step
constexpr int PITCH = BK + 16;          // padded smem row, bytes
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;        // 64 rows per warp
constexpr int WN = BN / WARPS_N;        // 32 cols per warp
constexpr int MI = WM / 16;             // m16 tiles per warp
constexpr int NI = WN / 8;              // n8 tiles per warp
constexpr int TILE_BYTES = 128 * PITCH; // one staged 128-row chunk

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [r0, r0 + 128) x byte chunk [k0, k0 + 128) of a [rows, K]
// matrix of K bytes a row into smem with cp.async; rows at or past `rows`
// are zero-filled.
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src,
                                          int rows, int K, int r0, int k0,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < (128 * BK / 16) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 3;
    const int col = (c & 7) * 16;
    const int gr = r0 + r;
    const bool ok = gr < rows;
    const int8_t* p = src + static_cast<size_t>(ok ? gr : 0) * K + k0 + col;
    cp_async16(dst + r * PITCH + col, p, ok ? 16 : 0);
  }
}

__device__ __forceinline__ void zero(int (&part)[MI][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0;
}

// part += the warp's 64x32 sub-tile of sA (128 rows x BK bytes) . sB^T
// (128 x BK bytes) for one staged chunk of s8 codes into int32 `part`.
// Warp (wm, wn); g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_chunk(const int8_t* sA, const int8_t* sB,
                                          int (&part)[MI][NI][4], int wm,
                                          int wn, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < BK; ks += 32) {
    unsigned af[MI][4];
    unsigned bf[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int8_t* p = sA + (wm * WM + mi * 16 + g) * PITCH + ks + t * 4;
      af[mi][0] = *reinterpret_cast<const unsigned*>(p);
      af[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * PITCH);
      af[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
      af[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * PITCH + 16);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int8_t* q = sB + (wn * WN + ni * 8 + g) * PITCH + ks + t * 4;
      bf[ni][0] = *reinterpret_cast<const unsigned*>(q);
      bf[ni][1] = *reinterpret_cast<const unsigned*>(q + 16);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_s8(part[mi][ni], af[mi], bf[ni]);
  }
}

// Shared memory of k_loop: two stages of an A chunk and a B chunk.
constexpr int KLOOP_STAGE_BYTES = 2 * TILE_BYTES;
constexpr int KLOOP_SMEM_BYTES = 2 * KLOOP_STAGE_BYTES;

// The K loop of one block: part += A[m0, m0 + 128) . B[n0, n0 + 128)^T over
// rows of `row_bytes` bytes (a multiple of BK; rows of A and B at or past M
// and N read as zeros), each BK-byte chunk staged by cp.async two stages
// deep into `smem` (KLOOP_SMEM_BYTES).
__device__ __forceinline__ void k_loop(const int8_t* __restrict__ a,
                                       const int8_t* __restrict__ b, int M,
                                       int N, int row_bytes, int m0, int n0,
                                       int (&part)[MI][NI][4], int8_t* smem) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nchunks = row_bytes / BK;
  load_tile(smem, a, M, row_bytes, m0, 0, tid);
  load_tile(smem + TILE_BYTES, b, N, row_bytes, n0, 0, tid);
  cp_async_commit();
  for (int kc = 0; kc < nchunks; ++kc) {
    if (kc + 1 < nchunks) {
      int8_t* nxt = smem + ((kc + 1) & 1) * KLOOP_STAGE_BYTES;
      load_tile(nxt, a, M, row_bytes, m0, (kc + 1) * BK, tid);
      load_tile(nxt + TILE_BYTES, b, N, row_bytes, n0, (kc + 1) * BK, tid);
    }
    cp_async_commit();         // possibly empty: keeps the wait count uniform
    cp_async_wait_prev();      // chunk kc has landed
    __syncthreads();
    const int8_t* sA = smem + (kc & 1) * KLOOP_STAGE_BYTES;
    mma_chunk(sA, sA + TILE_BYTES, part, warp / WARPS_N, warp % WARPS_N,
              lane >> 2, lane & 3);
    __syncthreads();           // the next iteration refills this stage
  }
}

// Row and column of accumulator element e of tile (mi, ni) of warp (wm, wn),
// relative to the block's output tile (the m16n8 C fragment layout).
__device__ __forceinline__ int frag_row(int wm, int mi, int g, int e) {
  return wm * WM + mi * 16 + g + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int wn, int ni, int t, int e) {
  return wn * WN + ni * 8 + t * 2 + (e & 1);
}

// Store the warp's fragments of the block's output tile (at m0, n0) as
// OutT, element e of tile (mi, ni) being value(mi, ni, e): rows masked at
// M, columns at N, column pairs stored together (a bf16 pair rounded to
// nearest even as one __nv_bfloat162) where N is even.
template <typename OutT, typename Value>
__device__ __forceinline__ void store_tile(OutT* __restrict__ out, int M,
                                           int N, int m0, int n0,
                                           Value value) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + frag_row(wm, mi, lane >> 2, 2 * h);
        const int c = n0 + frag_col(wn, ni, lane & 3, 0);
        if (r >= M) continue;
        OutT* o = out + static_cast<size_t>(r) * N + c;
        const float v0 = value(mi, ni, 2 * h);
        const float v1 = value(mi, ni, 2 * h + 1);
        if (pairs && c + 1 < N) {
          store2(o, v0, v1);
        } else {
          if (c < N) store1(o, v0);
          if (c + 1 < N) store1(o + 1, v1);
        }
      }
}

}  // namespace int8mma
