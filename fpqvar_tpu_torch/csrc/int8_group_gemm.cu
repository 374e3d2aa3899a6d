// Grouped-scale int8 GEMM for Hopper (sm_90a):
//
//   out[m,n] = sum_g  asc[m,g] * wsc[g,n] * sum_{k in g} ac[m,k] * wc[n,k]
//
// Replaces the TPU kernel fpqvar_tpu/ops/pallas/int8_matmul.py
// (_kernel / _int8_matmul_2d).  Operands: ac [M,K] int8 row-major,
// asc [M,G] f32, wc [N,K] int8 (the weight's own (out, in) layout: mma.sync
// wants the B operand K-contiguous, where the TPU kernel took [K,N]),
// wsc [G,N] f32, out [M,N] f32.  G = K / group, group a multiple of 128.
//
// Design.  The grouped tile of int8_group.cuh (shared with K5,
// int8_nd_gemm.cu) with an f32 output: 128x128 output tiles, K walked in
// 128-wide chunks staged by cp.async, mma.sync m16n8k32 s8 x s8 -> s32, the
// exact int32 group parts scaled into f32 registers at the end of each
// group.  The result differs from the plain PyTorch version only in the f32
// summation order over the G groups.
//
// Bound on an H100 SXM.  At the d16 shapes of the last scale (M = 4096),
// fc1 is 2*4096*1024*4096 = 34 GOP, 17 us at the 1,979 TOP/s int8 peak,
// while it moves 4 MB + 4 MB of codes and 64 MB of f32 output, 22 us at
// 3.35 TB/s: the f32 output write bounds it.  This first version is
// mma.sync without wgmma, TMA or a bf16 epilogue, and is slower than that
// bound (PERF.md has its times).
#include "int8_group.cuh"

using namespace int8mma;

namespace {

__global__ void __launch_bounds__(THREADS)
int8_group_gemm_kernel(const int8_t* __restrict__ ac,
                       const float* __restrict__ asc,
                       const int8_t* __restrict__ wc,
                       const float* __restrict__ wsc,
                       float* __restrict__ out,
                       int M, int N, int K, int group) {
  extern __shared__ __align__(16) int8_t smem[];
  group_gemm_tile(ac, asc, wc, wsc, out, M, N, K, group, smem);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The code pointers must be 16-byte aligned, K % group == 0 and
// group % 128 == 0 (so every code row is a whole number of 16-byte chunks).
extern "C" int int8_group_gemm(const void* ac, const void* asc,
                               const void* wc, const void* wsc, void* out,
                               int M, int N, int K, int group, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || group <= 0 || group % BK != 0 ||
      K % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = opt_in_smem<int8_group_gemm_kernel>(KLOOP_SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_group_gemm_kernel<<<grid, THREADS, KLOOP_SMEM_BYTES,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ac), static_cast<const float*>(asc),
      static_cast<const int8_t*>(wc), static_cast<const float*>(wsc),
      static_cast<float*>(out), M, N, K, group);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_group_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
