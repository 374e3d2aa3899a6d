// Grouped-scale int8 GEMM for Hopper (sm_90a):
//
//   out[m,n] = sum_g  asc[m,g] * wsc[g,n] * sum_{k in g} ac[m,k] * wc[n,k]
//
// Replaces the TPU kernel fpqvar_tpu/ops/pallas/int8_matmul.py
// (_kernel / _int8_matmul_2d).  Operands: ac [M,K] int8 row-major,
// asc [M,G] f32, wc [N,K] int8 (the weight's own (out, in) layout: the s8
// wgmma wants both operands K-major, where the TPU kernel took [K,N]),
// wsc [G,N] f32, out [M,N] f32.  G = K / group, group a multiple of 128.
//
// Design.  The s8 instantiation of wgmma_gemm.cuh with BN = 128 and a
// group fold: TMA loads 128-byte K chunks of ac and wc into a four-stage
// ring, two consumer warpgroups run wgmma m64n128k32 s8 x s8 -> s32 on a
// 128 x 128 output tile.  One chunk is 128 codes, one scale group at group
// 128 (a group of 256 is two chunks): the group's first wgmma starts a
// fresh int32 part (scale-d = 0), and once the group's wgmmas retire
// (wait_group 0) the part is folded into f32 registers, acc += (part *
// asc[m,g]) * wsc[g,n], the scales loaded before the group's wgmmas were
// issued (GroupFold).  While one consumer warpgroup folds, the other's
// wgmmas keep the tensor cores busy.  The f32 sum goes out through the
// pipeline's TMA-store epilogue.
//
// Exactness.  |code| <= 64, so a 128-term group sum is below 2^19: the
// int32 part is exact and so is its f32 conversion.  The f32 result
// differs from the plain PyTorch version only in the summation order over
// the G groups and in the fused multiply-add of the fold.
//
// Bound on an H100 SXM.  At the d16 fc2 shape of the last scale (M = 4096,
// K = 4096, N = 1024) the work is 2*4096*4096*1024 = 34 GOP, 17.4 us at the
// 1,979 TOP/s int8 peak, while it moves 16 MB + 4 MB of codes, 0.6 MB of
// scales and 16 MB of f32 output, 11 us at 3.35 TB/s: the operations bound
// it (at fc1, N = 4096 and K = 1024, the 64 MB output does).  PERF.md has
// its times.
#include "wgmma_gemm.cuh"

namespace {

constexpr int kBN = 128;
constexpr int kAcc = kBN / 2;

// The fold of one scale group into the f32 sum, and the (empty) epilogue:
// the scales are applied group by group, so the sums are the output.
// The part and the sum take 128 of a consumer's 168 registers (ptxas's
// budget at 384 threads a block), so a thread does not hold its 32 column
// scales: lane 4g + q loads the two column pairs 8j + 2q, j = 2g and
// 2g + 1, of the warp's 128 columns (load_scales, before the group's
// wgmmas are issued, so the loads' latency hides behind them), and the
// fold takes column block j's pair from lane 4(j / 2) + q by shuffle.  The
// scales are read with plain loads (see fused_ch_gemm.cu's FusedChRescale:
// read-only loads get hoisted and held through the loop).
struct GroupFold {
  using Out = float;
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

  __device__ __forceinline__ void fold(float (&acc)[kAcc],
                                       const int (&part)[kAcc],
                                       const Scales& s) const {
    const int q = threadIdx.x % 4;
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
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

  __device__ __forceinline__ void operator()(float (&)[kAcc], int, int, int,
                                             int, int, int) const {}
};

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The code pointers must be 16-byte aligned, K % group == 0 and
// group % 128 == 0 (so every code row is a whole number of 128-byte
// chunks).
extern "C" int int8_group_gemm(const void* ac, const void* asc,
                               const void* wc, const void* wsc, void* out,
                               int M, int N, int K, int group, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || group <= 0 ||
      group % wgmma_gemm::CHUNK != 0 || K % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GroupFold epi{static_cast<float*>(out),
                      static_cast<const float*>(asc),
                      static_cast<const float*>(wsc), K / group,
                      group / wgmma_gemm::CHUNK};
  return static_cast<int>(wgmma_gemm::launch<wgmma_gemm::S8, kBN>(
      ac, wc, M, N, K, epi, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* int8_group_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
