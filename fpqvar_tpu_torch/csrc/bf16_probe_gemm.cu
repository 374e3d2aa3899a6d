// bf16 GEMM with f32 accumulators and a bf16 output, for Hopper (sm_90a):
//
//   out[m,n] = bf16(sum_k a[m,k] * b[n,k])
//
// Replaces the TPU kernel of the int8 rate probe,
// scripts/int8_rate_probe.py (pallas_bf16: f32 VMEM scratch over the K grid
// axis, cast to bf16 on the last step), the probe's control for what a
// hand-written kernel costs against the library GEMM.  Operands: a [M,K]
// bf16 row-major, b [N,K] bf16 (K-major, as the pipeline takes both
// operands; the TPU kernel took [K,N], the probe transposes once outside
// its timed windows), out [M,N] bf16.  K a multiple of 64.
//
// Design.  The bf16 instantiation of wgmma_gemm.cuh: TMA loads 128-byte K
// chunks (64 values) of A and B into a ring of wgmma_gemm::STAGES stages,
// two consumer warpgroups run wgmma m64n256k16 bf16 x bf16 -> f32 on a
// 128 x 256 output tile, and the f32 accumulators (the TPU kernel's f32
// scratch) live in registers over the whole K and are written once as bf16
// rounded to nearest even, through shared memory and TMA stores.  Ragged M
// and N are zero-filled by the TMA loads and clipped by the stores.
//
// Bound on an H100 SXM.  At the probe's 4096x4096x4096 the GEMM is
// 137 GFLOP, 139 us at the 989 TFLOP/s dense bf16 peak, against 96 MB moved
// (32 MB each side and 32 MB of output), 29 us at 3.35 TB/s: operations
// bound it.  PERF.md has its times beside torch.matmul's.
#include "wgmma_gemm.cuh"

namespace {

// The f32 sums are the output values; the pipeline rounds them to bf16.
struct Bf16Out {
  using Out = __nv_bfloat16;
  Out* out;
  __device__ __forceinline__ void operator()(float (&)[wgmma_gemm::ACC], int,
                                             int, int, int, int, int) const {}
};

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The operand pointers must be 16-byte aligned and K % 64 == 0 (every row is
// a whole number of 128-byte chunks).
extern "C" int bf16_probe_gemm(const void* a, const void* b, void* out, int M,
                               int N, int K, void* stream) {
  const Bf16Out epi{static_cast<__nv_bfloat16*>(out)};
  return static_cast<int>(wgmma_gemm::launch<wgmma_gemm::Bf16>(
      a, b, M, N, K, epi, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* bf16_probe_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
