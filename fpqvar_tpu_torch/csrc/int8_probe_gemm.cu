// Full-K int8 GEMM with an int32 accumulator and a bf16 output, no scales,
// for Hopper (sm_90a):
//
//   out[m,n] = bf16(float(sum_k a[m,k] * b[n,k]))
//
// Replaces the TPU kernel of the int8 rate probe,
// scripts/int8_rate_probe.py (pallas_int8: int32 VMEM scratch over the K
// grid axis, cast to bf16 on the last step).  Operands: a [M,K] int8
// row-major, b [N,K] int8 (K-major, as the s8 wgmma takes both operands;
// the TPU kernel took [K,N], the probe transposes once outside its timed
// windows), out [M,N] bf16.  K a multiple of 128.
//
// Design.  The s8 instantiation of wgmma_gemm.cuh that K3 and K4's phase
// (b) run: TMA loads of 128-byte K chunks into a four-stage ring, two
// consumer warpgroups on wgmma m64n256k32 s8 x s8 -> s32 over 128 x 256
// tiles, a persistent grid.  The int32 sum (the TPU kernel's int32
// scratch) lives in registers over the whole K; the epilogue keeps the
// values as they are (Int8ProbeOut, a name of its own, so that a profiler
// tells K6 from K3 and K4) and the pipeline stores them as bf16 through
// shared memory and TMA stores.  Ragged M and N are zero-filled by the TMA
// loads and clipped by the stores.  Any int8 code is taken, -128 included:
// wgmma's s8 x s8 -> s32 product is exact for all of them, and nothing is
// folded per group (no HasFold), so no smaller range is assumed.
//
// The conversion.  PyTorch's int32 -> bfloat16 (and float64 -> bfloat16)
// conversion and JAX's int32 -> bfloat16 both round to float32 first and
// then to bf16, each to nearest even.  At K = 4096 the sums of full-range
// codes reach 2^26, and above 2^24 an int32 sum can sit next to a bf16
// midpoint, where the two roundings differ from one rounding of the exact
// sum (2^24 + 2^16 + 1 -> 2^24 in two steps, 2^24 + 2^17 in one).  The
// pipeline takes the same two steps: static_cast<float> of the s32
// fragment (cvt.rn.f32.s32), then __float2bfloat16 (nearest even) in the
// store, so the kernel equals the plain version bit for bit.
//
// Bound on an H100 SXM.  At the probe's 4096x4096x4096 the GEMM is
// 137 GOP, 69.4 us at the 1,979 TOP/s int8 peak, against 64 MB moved
// (16 MB of codes each side, 32 MB of bf16 output), 20 us at 3.35 TB/s:
// operations bound it.  PERF.md has its times beside torch._int_mm's.
#include "wgmma_gemm.cuh"

namespace {

// The int32 sums, converted to f32, are the output values; the pipeline
// rounds them to bf16.
struct Int8ProbeOut {
  using Out = __nv_bfloat16;
  Out* out;
  __device__ __forceinline__ void operator()(float (&)[wgmma_gemm::ACC], int,
                                             int, int, int, int, int) const {}
};

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The code pointers must be 16-byte aligned and K % 128 == 0 (every code row
// is a whole number of 128-byte chunks).
extern "C" int int8_probe_gemm(const void* a, const void* b, void* out, int M,
                               int N, int K, void* stream) {
  const Int8ProbeOut epi{static_cast<__nv_bfloat16*>(out)};
  return static_cast<int>(wgmma_gemm::launch<wgmma_gemm::S8>(
      a, b, M, N, K, epi, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* int8_probe_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
