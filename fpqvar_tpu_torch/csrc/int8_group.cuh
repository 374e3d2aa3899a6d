// The grouped-scale int8 GEMM tile of K5 (int8_nd_gemm.cu, bf16 or f32
// output; K1, int8_group_gemm.cu, computes the same sum in f32 on
// wgmma_gemm.cuh):
//
//   out[m,n] = OutT(sum_g asc[m,g] * wsc[g,n] * sum_{k in g} ac[m,k] * wc[n,k])
//
// Operands: ac [M,K] int8 row-major, asc [M,G] f32, wc [N,K] int8 (the
// weight's own (out, in) layout: mma.sync wants the B operand K-contiguous,
// where the TPU kernels took [K,N]), wsc [G,N] f32, out [M,N] OutT.
// G = K / group, group a multiple of 128.
//
// Design.  The K loop of int8_mma.cuh (k_loop): one 128x128 output tile per
// block, K walked in 128-wide chunks inside the block (the TPU kernels'
// sequential K grid axis becomes this loop), each chunk of A and W codes
// staged by cp.async two stages deep, mma.sync m16n8k32 s8 x s8 -> s32.  At
// the end of every scale group the exact int32 partials are converted to
// f32 and accumulated as part * asc * wsc in f32 registers; the f32 sum is
// written once as OutT (a bf16 pair rounded to nearest even and stored as
// one __nv_bfloat162).  Ragged M and N edges are zero-filled on load
// (cp.async with src-size 0) and masked on store, so any M >= 1 and N >= 1
// work; K must be a multiple of the group.
//
// Exactness.  |code| <= 64, so a 128-term group sum is below 2^19: the int32
// part is exact and so is its f32 conversion.  The f32 result differs from
// the plain PyTorch version only in the summation order over the G groups;
// a bf16 output is that f32 value rounded once.
#pragma once

#include "int8_mma.cuh"

namespace int8mma {

template <typename OutT>
__device__ __forceinline__ void group_gemm_tile(
    const int8_t* __restrict__ ac, const float* __restrict__ asc,
    const int8_t* __restrict__ wc, const float* __restrict__ wsc,
    OutT* __restrict__ out, int M, int N, int K, int group, int8_t* smem) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int g = lane >> 2;     // mma groupID
  const int t = lane & 3;      // mma threadID_in_group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int G = K / group;
  const int chunks_per_group = group / BK;

  float acc[MI][NI][4];
  int part[MI][NI][4];
  zero(part);
  zero(acc);

  k_loop(ac, wc, M, N, K, m0, n0, part, smem, [&](int kc) {
    if ((kc + 1) % chunks_per_group != 0) return;
    const int gi = kc / chunks_per_group;
    float sa[MI][2];
    float sw[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + frag_row(wm, mi, g, 2 * h);
        sa[mi][h] = r < M ? __ldg(asc + static_cast<size_t>(r) * G + gi)
                          : 0.f;
      }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + frag_col(wn, ni, t, h);
        sw[ni][h] = c < N ? __ldg(wsc + static_cast<size_t>(gi) * N + c)
                          : 0.f;
      }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mi][ni][e] += static_cast<float>(part[mi][ni][e]) *
                            sa[mi][e >> 1] * sw[ni][e & 1];
          part[mi][ni][e] = 0;
        }
  });

  store_tile(out, M, N, m0, n0,
             [&](int mi, int ni, int e) { return acc[mi][ni][e]; });
}

}  // namespace int8mma
