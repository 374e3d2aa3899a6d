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
// Design.  The s8 instantiation of wgmma_gemm.cuh with BN = 128 and the
// group fold of group_fold.cuh (K5 runs the same fold over [B*T, K] rows):
// TMA loads 128-byte K chunks of ac and wc into a four-stage ring, two
// consumer warpgroups run wgmma m64n128k32 s8 x s8 -> s32 on a 128 x 128
// output tile.  One chunk is 128 codes, one scale group at group 128 (a
// group of 256 is two chunks); each group's exact int32 part is folded
// into f32 registers once its wgmmas retire.  While one consumer
// warpgroup folds, the other's wgmmas keep the tensor cores busy.  The f32
// sum goes out through the pipeline's TMA-store epilogue.  Exactness: see
// group_fold.cuh (the group parts are exact; only the f32 order over the
// groups differs from the plain version).
//
// Bound on an H100 SXM.  At the d16 fc2 shape of the last scale (M = 4096,
// K = 4096, N = 1024) the work is 2*4096*4096*1024 = 34 GOP, 17.4 us at the
// 1,979 TOP/s int8 peak, while it moves 16 MB + 4 MB of codes, 0.6 MB of
// scales and 16 MB of f32 output, 11 us at 3.35 TB/s: the operations bound
// it (at fc1, N = 4096 and K = 1024, the 64 MB output does).  PERF.md has
// its times.
#include "group_fold.cuh"

namespace {

// K1's epilogue: the group fold, under a name of its own.
struct GroupFold : group_fold::Fold<float> {};

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The code pointers must be 16-byte aligned, K % group == 0 and
// group % 128 == 0 (so every code row is a whole number of 128-byte
// chunks).
extern "C" int int8_group_gemm(const void* ac, const void* asc,
                               const void* wc, const void* wsc, void* out,
                               int M, int N, int K, int group, void* stream) {
  return static_cast<int>(group_fold::launch<GroupFold>(
      ac, asc, wc, wsc, out, M, N, K, group,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* int8_group_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
