// Full-K int8 GEMM with the per-channel rescale fused, for Hopper (sm_90a):
//
//   out[m,n] = (float(sum_k ac[m,k] * wc[n,k]) * asc[m]) * wsc[n]
//
// written as f32 or bf16.  Replaces the TPU kernel
// fpqvar_tpu/ops/pallas/int8_matmul.py (_ch_kernel / _int8ch_matmul_2d).
// The port runs it on fc2 of the int8ch recipe: the dual-grid activation
// codes are made outside (quant_int_codes_dual), and each half is one launch
// with f32 output; the two halves are summed before the cast.  Operands:
// ac [M,K] int8 row-major, asc [M,1] f32, wc [N,K] int8 (the weight's own
// (out, in) layout: the s8 wgmma wants both operands K-major), wsc [1,N]
// f32.  K a multiple of 128.
//
// Design.  K4's phase (b) (fused_ch_gemm.cu) computes this function on the
// codes its phase (a) made, so K3 is the same GEMM: the s8 instantiation
// of wgmma_gemm.cuh (TMA loads of 128-byte K chunks into a four-stage
// ring, two consumer warpgroups on wgmma m64n256k32 s8 x s8 -> s32 over
// 128 x 256 tiles, a persistent grid), whose epilogue is the rescale of
// ch_rescale.cuh reading asc where K4 reads its own row scales.  The int32
// sum runs over the whole K (one scale per row and per column), so the
// epilogue happens once, on the registers, before the TMA store: no
// [M, N] int32 or f32 pass is written to device memory.  TMA fills the
// rows and columns past M and N with zeros on load and clips the store.
//
// Exactness.  |code| <= 64 on both sides, so at K <= 4096 every partial
// sum is an integer of magnitude <= 2^24: the int32 sum and its f32
// conversion are exact, and the two multiplies run in JAX's order (nothing
// to fuse into an FMA).  The result is bit-equal to the plain PyTorch
// version (channel_dot_ref).
//
// Bound on an H100 SXM.  At fc2 of VAR-d16's last scale at batch 8
// (M = 4096, K = 4096, N = 1024) the GEMM is 34 GOP, 17.4 us at the
// 1,979 TOP/s int8 peak, against 36 MB moved (16 MB of activation codes,
// 4 MB of weight codes and 16 MB of f32 output), 10.8 us at 3.35 TB/s:
// operations bound it.
// PERF.md has its times.
#include "ch_rescale.cuh"

namespace {

// K3's epilogue: the per-channel rescale, under a name of its own.
template <typename OutT>
struct Int8ChRescale : ch_rescale::RowColRescale<OutT> {};

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The code pointers must be 16-byte aligned and K % 128 == 0 (every code row
// is a whole number of 128-byte chunks).  out_bf16: 1 for a bf16 output,
// 0 for f32.
extern "C" int int8ch_gemm(const void* ac, const void* asc, const void* wc,
                           const void* wsc, void* out, int M, int N, int K,
                           int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      out_bf16 ? ch_rescale::launch<Int8ChRescale<__nv_bfloat16>>(
                     ac, asc, wc, wsc, out, M, N, K, s)
               : ch_rescale::launch<Int8ChRescale<float>>(ac, asc, wc, wsc,
                                                          out, M, N, K, s));
}

extern "C" const char* int8ch_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
