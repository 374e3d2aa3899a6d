// Grouped-scale int8 GEMM over [B, T, K] activations with the output written
// once in its own dtype, for Hopper (sm_90a):
//
//   y[b,t,n] = out_dtype(sum_g  as[b,t,g] * ws[g,n]
//                               * sum_{k in g} ac[b,t,k] * wc[n,k])
//
// Replaces the TPU kernel fpqvar_tpu/ops/pallas/int8_matmul.py
// (_kernel3 / _int8_matmul_3d).  Operands: ac [B,T,K] int8 and as [B,T,G]
// f32, both contiguous; wc [N,K] int8 (the weight's own (out, in) layout:
// the s8 wgmma wants both operands K-major, where the TPU kernel took
// [K,N]); ws [G,N] f32; y [B,T,N] bf16 or f32.  G = K / group, group a
// multiple of 128.
//
// Design.  On the TPU the batch rides the grid and each batch's T rows are
// padded to 32, then sliced off.  Here the [B, T] rows of a contiguous
// [B, T, K] tensor already form one row-major [B*T, K] matrix, so the
// kernel walks the B*T rows as M and takes B and T only to check their
// product: no padding, and ragged T (9, 1 at the first scales) costs no
// per-batch tile (TMA fills the rows past M of the last tile with zeros
// and clips them on the store).  The GEMM is K1's: the s8 instantiation
// of wgmma_gemm.cuh over 128 x 128 tiles with the scale-group fold of
// group_fold.cuh, instantiated here with a bf16 or an f32 output.  The
// f32 sum is rounded once (bf16, to nearest even) in the pipeline's
// store, so no f32 [M, N] pass and no separate cast reach device memory,
// and the result equals K1's output followed by a cast, bit for bit.
// Exactness: see group_fold.cuh.
//
// Bound on an H100 SXM.  At fc1 of VAR-d16's last scale at batch 8 (CFG
// doubles it: B = 16, T = 256, so M = 4096, K = 1024, N = 4096) the GEMM is
// 34 GOP, 17.4 us at the 1,979 TOP/s int8 peak, while it moves 8 MB of
// codes, 0.25 MB of scales and 32 MB of bf16 output, 12 us at 3.35 TB/s:
// operations bound it (K1's f32 output made bytes bound it).  PERF.md has
// its times.
#include "group_fold.cuh"

namespace {

// K5's epilogue: the group fold, under a name of its own.
template <typename OutT>
struct NdGroupSum : group_fold::Fold<OutT> {};

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// B * T rows of K codes each; the code pointers must be 16-byte aligned,
// K % group == 0 and group % 128 == 0.  out_bf16: 1 for a bf16 output, 0
// for f32.
extern "C" int int8_nd_gemm(const void* ac, const void* asc, const void* wc,
                            const void* wsc, void* out, int B, int T, int N,
                            int K, int group, int out_bf16, void* stream) {
  if (B <= 0 || T <= 0 || static_cast<long long>(B) * T > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int M = B * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      out_bf16 ? group_fold::launch<NdGroupSum<__nv_bfloat16>>(
                     ac, asc, wc, wsc, out, M, N, K, group, s)
               : group_fold::launch<NdGroupSum<float>>(ac, asc, wc, wsc, out,
                                                       M, N, K, group, s));
}

extern "C" const char* int8_nd_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
