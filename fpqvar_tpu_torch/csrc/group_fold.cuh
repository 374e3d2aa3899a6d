// The scale-group fold of the grouped int8 GEMMs K1 (int8_group_gemm.cu,
// f32 output) and K5 (int8_nd_gemm.cu, bf16 or f32 output), both the s8
// instantiation of wgmma_gemm.cuh over 128 x 128 tiles:
//
//   out[m,n] = Out(sum_g  asc[m,g] * wsc[g,n] * sum_{k in g} ac[m,k] * wc[n,k])
//
// Each scale group's first wgmma starts a fresh int32 part (scale-d = 0),
// and once the group's wgmmas retire (wait_group 0) the part is folded into
// f32 registers, acc += (part * asc[m,g]) * wsc[g,n], with the scales
// loaded before the group's wgmmas were issued.  The f32 sum is the
// output: the pipeline stores it as Out (f32, or bf16 rounded to nearest
// even once), so K5's bf16 output is K1's f32 output cast, bit for bit.
// Each kernel derives an epilogue type of its own name from Fold<Out>, so
// that a profiler tells the two apart.
//
// Exactness.  |code| <= 64, so a 128-term group sum is below 2^19: the
// int32 part is exact and so is its f32 conversion.  The f32 result
// differs from the plain PyTorch version only in the summation order over
// the G groups and in the fused multiply-add of the fold.
#pragma once

#include "wgmma_gemm.cuh"

namespace group_fold {

constexpr int BN = 128;                  // columns of an output tile
constexpr int ACC = BN / 2;              // accumulators a consumer thread

// The fold of one scale group into the f32 sum, and the (empty) epilogue:
// the scales are applied group by group, so the sums are the output.
// The part and the sum take 128 of a consumer's 168 registers (ptxas's
// budget at 384 threads a block), so a thread does not hold its 32 column
// scales: lane 4g + q loads the two column pairs 8j + 2q, j = 2g and
// 2g + 1, of the warp's 128 columns (load_scales, before the group's
// wgmmas are issued, so the loads' latency hides behind them), and the
// fold takes column block j's pair from lane 4(j / 2) + q by shuffle.  The
// scales are read with plain loads (see ch_rescale.cuh: read-only loads
// get hoisted and held through the loop).
template <typename OutT>
struct Fold {
  using Out = OutT;
  Out* out;
  const float* asc;
  const float* wsc;
  int G;
  int chunks_per_group;

  struct Scales {
    float a[2];           // asc of rows row, row + 8
    float w[2][2];        // wsc of columns 8j + 2q + e, j = 2g + i, at [i][e]
  };

  __device__ __forceinline__ Scales load_scales(int g, int row, int col,
                                                int M, int N) const {
    const int lane = threadIdx.x % 32;
    Scales s;
    s.a[0] = row < M ? asc[static_cast<size_t>(row) * G + g] : 0.f;
    s.a[1] = row + 8 < M ? asc[static_cast<size_t>(row + 8) * G + g] : 0.f;
    const float* w = wsc + static_cast<size_t>(g) * N + col;
    const int cols = N - col;              // column c of w is inside N
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * (2 * (lane / 4) + i) + e;
        s.w[i][e] = c < cols ? w[c] : 0.f;
      }
    return s;
  }

  __device__ __forceinline__ void fold(float (&acc)[ACC],
                                       const int (&part)[ACC],
                                       const Scales& s) const {
    const int q = threadIdx.x % 4;
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j) {
      const int src = 4 * (j / 2) + q;
      const float sw[2] = {__shfl_sync(0xffffffffu, s.w[j % 2][0], src),
                           __shfl_sync(0xffffffffu, s.w[j % 2][1], src)};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          acc[i] += static_cast<float>(part[i]) * s.a[h] * sw[e];
        }
    }
  }

  __device__ __forceinline__ void operator()(float (&)[ACC], int, int, int,
                                             int, int, int) const {}
};

// Launch out = Epi's fold over a [M, K] . wc [N, K]^T on `stream` (Epi
// derived from Fold<Out>); the code pointers must be 16-byte aligned,
// K % group == 0 and group % 128 == 0 (so every code row is a whole number
// of 128-byte chunks).
template <typename Epi>
cudaError_t launch(const void* ac, const void* asc, const void* wc,
                   const void* wsc, void* out, int M, int N, int K,
                   int group, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || group <= 0 ||
      group % wgmma_gemm::CHUNK != 0 || K % group != 0) {
    return cudaErrorInvalidValue;
  }
  using Out = typename Epi::Out;
  const Epi epi{{static_cast<Out*>(out), static_cast<const float*>(asc),
                 static_cast<const float*>(wsc), K / group,
                 group / wgmma_gemm::CHUNK}};
  return wgmma_gemm::launch<wgmma_gemm::S8, BN>(ac, wc, M, N, K, epi,
                                                 stream);
}

}  // namespace group_fold
