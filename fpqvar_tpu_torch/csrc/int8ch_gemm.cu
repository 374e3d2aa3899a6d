// Full-K int8 GEMM with the per-channel rescale fused, for Hopper (sm_90a):
//
//   out[m,n] = (float(sum_k ac[m,k] * wc[n,k]) * asc[m]) * wsc[n]
//
// written as f32 or bf16.  Replaces the TPU kernel
// fpqvar_tpu/ops/pallas/int8_matmul.py (_ch_kernel / _int8ch_matmul_2d).
// The port runs it on fc2 of the int8ch recipe: the dual-grid activation
// codes are made outside (quant_int_codes_dual), and each half is one launch
// with f32 output; the two halves are summed before the cast.  Operands:
// ac [M,K] int8 row-major, asc [M,1] f32, wc [N,K] int8 (K-contiguous, as
// mma.sync wants its B operand), wsc [1,N] f32.  K a multiple of 128.
//
// Design.  The K loop of int8_mma.cuh (k_loop): one 128x128 output tile per
// block, K walked in 128-wide chunks, cp.async two stages deep, mma.sync
// m16n8k32 s8 x s8 -> s32.  Unlike K1 the int32 sum runs over the whole K
// (one scale per row and per column), so the f32 epilogue happens once, on
// the registers, before the one store: no [M, N] int32 or f32 pass is
// written to device memory.  Ragged M and N are zero-filled on load and
// masked on store.
//
// Exactness.  |code| <= 64 on both sides, so at K <= 4096 every partial
// sum is an integer of magnitude <= 2^24: the int32 sum and its f32
// conversion are exact, and the two multiplies run in JAX's order (nothing
// to fuse into an FMA).  The result is bit-equal to the plain PyTorch
// version (channel_dot_ref).
//
// Bound on an H100 SXM.  At fc2 of VAR-d16's last scale at batch 8
// (M = 4096, K = 4096, N = 1024) the GEMM is 34 GOP, 17.4 us at the
// 1,979 TOP/s int8 peak, against 36 MB moved (16 MB of codes each side and
// 16 MB of f32 output), 10.8 us at 3.35 TB/s: operations bound it.  This
// first version uses mma.sync without wgmma or TMA (PERF.md has its times).
#include "int8_mma.cuh"

using namespace int8mma;

namespace {

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
int8ch_gemm_kernel(const int8_t* __restrict__ ac,
                   const float* __restrict__ asc,
                   const int8_t* __restrict__ wc,
                   const float* __restrict__ wsc,
                   OutT* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) int8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int part[MI][NI][4];
  zero(part);
  k_loop(ac, wc, M, N, K, m0, n0, part, smem, [](int) {});
  store_rescaled(out, part, wsc, M, N, m0, n0, warp / WARPS_N,
                 warp % WARPS_N, lane >> 2, lane & 3,
                 [&](int rl) { return __ldg(asc + m0 + rl); });
}

template <typename OutT>
int launch(const void* ac, const void* asc, const void* wc, const void* wsc,
           void* out, int M, int N, int K, cudaStream_t stream) {
  cudaError_t e = opt_in_smem<int8ch_gemm_kernel<OutT>>(KLOOP_SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8ch_gemm_kernel<OutT><<<grid, THREADS, KLOOP_SMEM_BYTES, stream>>>(
      static_cast<const int8_t*>(ac), static_cast<const float*>(asc),
      static_cast<const int8_t*>(wc), static_cast<const float*>(wsc),
      static_cast<OutT*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The code pointers must be 16-byte aligned and K % 128 == 0 (every code row
// is a whole number of 16-byte chunks).  out_bf16: 1 for a bf16 output,
// 0 for f32.
extern "C" int int8ch_gemm(const void* ac, const void* asc, const void* wc,
                           const void* wsc, void* out, int M, int N, int K,
                           int out_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16>(ac, asc, wc, wsc, out, M, N, K, s)
                  : launch<float>(ac, asc, wc, wsc, out, M, N, K, s);
}

extern "C" const char* int8ch_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
