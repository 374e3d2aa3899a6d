// The per-channel rescale epilogue of the full-K int8 GEMMs K4 (phase (b)
// of fused_ch_gemm.cu) and K3 (int8ch_gemm.cu), both the s8 instantiation
// of wgmma_gemm.cuh over 128 x 256 tiles:
//
//   out[m,n] = (float(sum_k ac[m,k] * wc[n,k]) * row_scale[m]) * wsc[n]
//
// stored as Out (f32, or bf16 rounded to nearest even) by the pipeline.
// K4 reads its row scales from its own phase (a), K3 from the caller's
// activation scales.  The two multiplies run in JAX's order, and there is
// no add to contract into an FMA, so with the exact int32 sum (|code| <= 64
// on both sides and K <= 4096: below 2^24, exact in f32) the result is
// bit-equal to the plain PyTorch version (channel_dot_ref).  Each kernel
// derives an epilogue type of its own name from RowColRescale<Out>, so
// that a profiler tells the two apart.
#pragma once

#include "wgmma_gemm.cuh"

namespace ch_rescale {

// In place on the f32 sums of column blocks [j0, j1): v = (v *
// row_scale[row]) * wsc[col].  The scales are read with plain loads at
// fixed offsets from one pointer: the compiler moves read-only (__ldg)
// loads, and the addresses of the 64 column scales, above the K loop and
// keeps them live through it, which spills the consumer's registers.
template <typename OutT>
struct RowColRescale {
  using Out = OutT;
  Out* out;
  const float* row_scale;
  const float* wsc;
  __device__ __forceinline__ void operator()(float (&v)[wgmma_gemm::ACC],
                                             int j0, int j1, int row,
                                             int col, int M, int N) const {
    const float* w = wsc + col;
    const int cols = N - col;              // column 8j + e is inside N
    const float s[2] = {row < M ? row_scale[row] : 0.f,
                        row + 8 < M ? row_scale[row + 8] : 0.f};
#pragma unroll
    for (int j = j0; j < j1; ++j) {
      const float wj[2] = {8 * j < cols ? w[8 * j] : 0.f,
                           8 * j + 1 < cols ? w[8 * j + 1] : 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = v[4 * j + 2 * h + e];
          x = x * s[h] * wj[e];
        }
    }
  }
};

// Launch out = Epi(codes [M, K] . wc [N, K]^T) on `stream` (Epi derived
// from RowColRescale<Out>); codes and wc 16-byte aligned, K % 128 == 0.
template <typename Epi>
cudaError_t launch(const void* codes, const void* row_scale, const void* wc,
                   const void* wsc, void* out, int M, int N, int K,
                   cudaStream_t stream) {
  using Out = typename Epi::Out;
  const Epi epi{{static_cast<Out*>(out), static_cast<const float*>(row_scale),
                 static_cast<const float*>(wsc)}};
  return wgmma_gemm::launch<wgmma_gemm::S8>(codes, wc, M, N, K, epi, stream);
}

}  // namespace ch_rescale
