// Grouped-scale int8 GEMM over [B, T, K] activations with the output written
// once in its own dtype, for Hopper (sm_90a):
//
//   y[b,t,n] = out_dtype(sum_g  as[b,t,g] * ws[g,n]
//                               * sum_{k in g} ac[b,t,k] * wc[n,k])
//
// Replaces the TPU kernel fpqvar_tpu/ops/pallas/int8_matmul.py
// (_kernel3 / _int8_matmul_3d).  Operands: ac [B,T,K] int8 and as [B,T,G]
// f32, both contiguous; wc [N,K] int8 (K-contiguous, as mma.sync wants its
// B operand; the TPU kernel took [K,N]); ws [G,N] f32; y [B,T,N] bf16 or
// f32.  G = K / group, group a multiple of 128.
//
// Design.  On the TPU the batch rides the grid and each batch's T rows are
// padded to 32, then sliced off.  Here the [B, T] rows of a contiguous
// [B, T, K] tensor already form one row-major [B*T, K] matrix, so the
// kernel walks the B*T rows as M and takes B and T only to shape the
// output: no padding, and ragged T (9, 1 at the first scales) costs no
// per-batch tile.  The tile (int8_group.cuh, K1's until K1 moved to
// wgmma): 128x128 output tiles, K in 128-wide cp.async chunks, mma.sync
// m16n8k32 s8, the exact int32 group parts accumulated in f32 registers;
// the f32 sum is written once as out_dtype (a bf16 pair rounded to nearest
// even as one __nv_bfloat162), so no f32 [M, N] pass and no separate cast
// reach device memory.  With f32 output it computes K1's function within
// K1's tolerance; with bf16 output, that f32 value rounded once.
//
// Bound on an H100 SXM.  At fc1 of VAR-d16's last scale at batch 8 (CFG
// doubles it: B = 16, T = 256, so M = 4096, K = 1024, N = 4096) the GEMM is
// 34 GOP, 17.4 us at the 1,979 TOP/s int8 peak, while it moves 8 MB of
// codes, 0.25 MB of scales and 32 MB of bf16 output, 12 us at 3.35 TB/s:
// operations bound it (K1's f32 output made bytes bound it).  This first
// version uses mma.sync without wgmma or TMA (PERF.md has its times).
#include "int8_group.cuh"

using namespace int8mma;

namespace {

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
int8_nd_gemm_kernel(const int8_t* __restrict__ ac,
                    const float* __restrict__ asc,
                    const int8_t* __restrict__ wc,
                    const float* __restrict__ wsc,
                    OutT* __restrict__ out, int M, int N, int K, int group) {
  extern __shared__ __align__(16) int8_t smem[];
  group_gemm_tile(ac, asc, wc, wsc, out, M, N, K, group, smem);
}

template <typename OutT>
int launch(const void* ac, const void* asc, const void* wc, const void* wsc,
           void* out, int M, int N, int K, int group, cudaStream_t stream) {
  cudaError_t e = opt_in_smem<int8_nd_gemm_kernel<OutT>>(KLOOP_SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_nd_gemm_kernel<OutT>
      <<<grid, THREADS, KLOOP_SMEM_BYTES, stream>>>(
      static_cast<const int8_t*>(ac), static_cast<const float*>(asc),
      static_cast<const int8_t*>(wc), static_cast<const float*>(wsc),
      static_cast<OutT*>(out), M, N, K, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// B * T rows of K codes each; the code pointers must be 16-byte aligned,
// K % group == 0 and group % 128 == 0.  out_bf16: 1 for a bf16 output, 0
// for f32.
extern "C" int int8_nd_gemm(const void* ac, const void* asc, const void* wc,
                            const void* wsc, void* out, int B, int T, int N,
                            int K, int group, int out_bf16, void* stream) {
  if (B <= 0 || T <= 0 || N <= 0 || K <= 0 || group <= 0 ||
      group % BK != 0 || K % group != 0 ||
      static_cast<long long>(B) * T > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int M = B * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16
             ? launch<__nv_bfloat16>(ac, asc, wc, wsc, out, M, N, K, group, s)
             : launch<float>(ac, asc, wc, wsc, out, M, N, K, group, s);
}

extern "C" const char* int8_nd_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
