// bf16 GEMM with f32 accumulators and a bf16 output, for Hopper (sm_90a):
//
//   out[m,n] = bf16(sum_k a[m,k] * b[n,k])
//
// Replaces the TPU kernel of the int8 rate probe,
// scripts/int8_rate_probe.py (pallas_bf16: f32 VMEM scratch over the K grid
// axis, cast to bf16 on the last step), the probe's control for what a
// hand-written kernel costs against the library GEMM.  Operands: a [M,K]
// bf16 row-major, b [N,K] bf16 (K-contiguous, as mma.sync wants its B
// operand; the TPU kernel took [K,N], the probe transposes once outside its
// timed windows), out [M,N] bf16.  K a multiple of 64.
//
// Design.  The K loop of int8_mma.cuh (k_loop) on bytes: one 128x128 output
// tile per block, K walked in chunks of 128 bytes (64 bf16 values) staged by
// cp.async two stages deep, rows padded to 144 bytes.  A 32-byte K step is
// one mma.sync m16n8k16 bf16 x bf16 -> f32, whose fragments sit at the same
// bytes as the s8 k32 ones, so the fragment loop is the int8 kernels'; the
// accumulators are f32 registers over the whole K (the TPU kernel's f32
// scratch), written once as bf16 pairs rounded to nearest even.  This is
// K2's bf16 MMA path (packed_dequant_gemm.cu) without the decode.  Ragged M
// and N are zero-filled on load and masked on store.
//
// Bound on an H100 SXM.  At the probe's 4096x4096x4096 the GEMM is
// 137 GFLOP, 139 us at the 989 TFLOP/s dense bf16 peak, against 96 MB moved
// (32 MB each side and 32 MB of output), 29 us at 3.35 TB/s: operations
// bound it.  This first version uses mma.sync without wgmma or TMA (PERF.md
// has its times).
#include "int8_mma.cuh"

using namespace int8mma;

namespace {

constexpr int BK_VALUES = BK / 2;             // bf16 values per chunk

__global__ void __launch_bounds__(THREADS)
bf16_probe_gemm_kernel(const __nv_bfloat16* __restrict__ a,
                       const __nv_bfloat16* __restrict__ b,
                       __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) int8_t smem[];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[MI][NI][4];
  zero(acc);
  // the loop stages bytes: a bf16 row is 2 K of them
  k_loop(reinterpret_cast<const int8_t*>(a), reinterpret_cast<const int8_t*>(b),
         M, N, 2 * K, m0, n0, acc, smem, [](int) {});
  store_tile(out, M, N, m0, n0,
             [&](int mi, int ni, int e) { return acc[mi][ni][e]; });
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The operand pointers must be 16-byte aligned and K % 64 == 0 (every row is
// a whole number of 128-byte chunks).
extern "C" int bf16_probe_gemm(const void* a, const void* b, void* out, int M,
                               int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK_VALUES != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = opt_in_smem<bf16_probe_gemm_kernel>(KLOOP_SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bf16_probe_gemm_kernel<<<grid, THREADS, KLOOP_SMEM_BYTES,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bf16_probe_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
