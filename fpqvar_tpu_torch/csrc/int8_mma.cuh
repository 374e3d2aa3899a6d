// The s8 x s8 -> s32 tile loop shared by the int8 GEMMs for Hopper (sm_90a):
// K1 (int8_group_gemm.cu), K3 (int8ch_gemm.cu) and K4 (fused_ch_gemm.cu).
//
// One thread block owns one 128x128 output tile and walks K in 128-wide
// chunks.  A chunk of A codes (128 rows of the block's M tile) and of W
// codes (128 rows of its N tile, the weight's own [N, K] layout: mma.sync
// wants the B operand K-contiguous) sits in shared memory, rows padded to
// 144 bytes so the 32-bit fragment loads hit 32 distinct banks.  Eight
// warps (2 x 4) each own a 64x32 sub-tile and run mma.sync m16n8k32 on it
// into int32 registers.  K3 and K4 also share the full-K epilogue
// (store_rescaled).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int8mma {

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
constexpr int kMaxDevices = 64;

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

// Stage rows [r0, r0 + 128) x K chunk [k0, k0 + 128) of a [rows, K] int8
// matrix into smem with cp.async; rows at or past `rows` are zero-filled.
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

// part += the warp's 64x32 sub-tile of sA (128 x BK codes) . sB^T (128 x BK)
// for one staged chunk.  Warp (wm, wn); g = lane / 4, t = lane % 4.
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

// Row and column of accumulator element e of tile (mi, ni) of warp (wm, wn),
// relative to the block's output tile (the m16n8 C fragment layout).
__device__ __forceinline__ int frag_row(int wm, int mi, int g, int e) {
  return wm * WM + mi * 16 + g + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int wn, int ni, int t, int e) {
  return wn * WN + ni * 8 + t * 2 + (e & 1);
}

__device__ __forceinline__ void store2(float* o, float v0, float v1) {
  *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(o) =
      __halves2bfloat162(__float2bfloat16(v0), __float2bfloat16(v1));
}
__device__ __forceinline__ void store1(float* o, float v) { *o = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16(v);
}

// The full-K epilogue of K3 and K4, on the registers:
//   out[m0 + rl, c] = (float(part) * row_scale(rl)) * wsc[c]
// as OutT (f32 or bf16) for the warp's fragments, rows masked at M and
// columns at N.  The two multiplies keep JAX's order; there is no add to
// contract into an FMA.
template <typename OutT, typename RowScale>
__device__ __forceinline__ void store_rescaled(
    OutT* __restrict__ out, const int (&part)[MI][NI][4],
    const float* __restrict__ wsc, int M, int N, int m0, int n0, int wm,
    int wn, int g, int t, RowScale row_scale) {
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = frag_row(wm, mi, g, 2 * h);
      const int r = m0 + rl;
      if (r >= M) continue;
      const float rs = row_scale(rl);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int c = n0 + frag_col(wn, ni, t, 0);
        const float v0 = c < N ? static_cast<float>(part[mi][ni][2 * h]) *
                                     rs * __ldg(wsc + c)
                               : 0.f;
        const float v1 = c + 1 < N
                             ? static_cast<float>(part[mi][ni][2 * h + 1]) *
                                   rs * __ldg(wsc + c + 1)
                             : 0.f;
        OutT* o = out + static_cast<size_t>(r) * N + c;
        if (pairs && c + 1 < N) {
          store2(o, v0, v1);
        } else {
          if (c < N) store1(o, v0);
          if (c + 1 < N) store1(o + 1, v1);
        }
      }
    }
}

// Opt `Kernel` in to `bytes` of dynamic shared memory on the current
// device.  The attribute is per device: set it on the first launch on
// each device only (setting it twice is harmless).
template <auto Kernel>
cudaError_t opt_in_smem(int bytes) {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace int8mma
