// Full-K int8 GEMM with an int32 accumulator and a bf16 output, no scales,
// for Hopper (sm_90a):
//
//   out[m,n] = bf16(float(sum_k a[m,k] * b[n,k]))
//
// Replaces the TPU kernel of the int8 rate probe,
// scripts/int8_rate_probe.py (pallas_int8: int32 VMEM scratch over the K
// grid axis, cast to bf16 on the last step).  Operands: a [M,K] int8
// row-major, b [N,K] int8 (K-contiguous, as mma.sync wants its B operand;
// the TPU kernel took [K,N], the probe transposes once outside its timed
// windows), out [M,N] bf16.  K a multiple of 128.
//
// Design.  The K loop of int8_mma.cuh (k_loop): one 128x128 output tile per
// block, K walked in 128-wide chunks staged by cp.async two stages deep,
// mma.sync m16n8k32 s8 x s8 -> s32 into registers over the whole K (the
// TPU kernel's int32 scratch), then one epilogue on the registers.
//
// The conversion.  PyTorch's int32 -> bfloat16 (and float64 -> bfloat16)
// conversion and JAX's int32 -> bfloat16 both round to float32 first and
// then to bf16, each to nearest even.  Above 2^24 an int32 sum can sit next
// to a bf16 midpoint, and the two roundings then differ from one rounding
// of the exact sum (2^24 + 2^16 + 1 -> 2^24 in two steps, 2^24 + 2^17 in
// one).  The kernel takes the same two steps (__int2float_rn, then
// __float2bfloat16), so it equals the plain version bit for bit.
//
// Bound on an H100 SXM.  At the probe's 4096x4096x4096 the GEMM is
// 137 GOP, 69.4 us at the 1,979 TOP/s int8 peak, against 64 MB moved
// (16 MB of codes each side, 32 MB of bf16 output), 20 us at 3.35 TB/s:
// operations bound it.  This first version uses mma.sync without wgmma or
// TMA (PERF.md has its times).
#include "int8_mma.cuh"

using namespace int8mma;

namespace {

__global__ void __launch_bounds__(THREADS)
int8_probe_gemm_kernel(const int8_t* __restrict__ a,
                       const int8_t* __restrict__ b,
                       __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) int8_t smem[];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  int acc[MI][NI][4];
  zero(acc);
  k_loop(a, b, M, N, K, m0, n0, acc, smem);
  // int32 -> f32 (nearest even), then store_tile rounds to bf16
  store_tile(out, M, N, m0, n0, [&](int mi, int ni, int e) {
    return __int2float_rn(acc[mi][ni][e]);
  });
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The code pointers must be 16-byte aligned and K % 128 == 0 (every code row
// is a whole number of 16-byte chunks).
extern "C" int int8_probe_gemm(const void* a, const void* b, void* out, int M,
                               int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = opt_in_smem<int8_probe_gemm_kernel>(KLOOP_SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_probe_gemm_kernel<<<grid, THREADS, KLOOP_SMEM_BYTES,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_probe_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
