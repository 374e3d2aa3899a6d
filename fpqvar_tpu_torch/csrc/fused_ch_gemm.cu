// Per-token quantize, then a full-K int8 GEMM, for Hopper (sm_90a):
//
//   scale[m] = amax_m > 0 ? amax_m * inv : 1       amax_m = max_k |x[m,k]|
//   code[m,k] = codes[#{i : x[m,k] / scale[m] >= mids[i]}]
//   out[m,n] = (float(sum_k code[m,k] * wc[n,k]) * (scale[m] / mult)) * wsc[n]
//
// written as f32 or bf16.  Replaces the TPU kernel
// fpqvar_tpu/ops/pallas/int8_matmul.py (_fused_ch_kernel /
// _fused_ch_matmul_2d).  The port runs it on every block linear of the
// per-channel recipes (int8ch: qkv, proj, fc1; int8chs and int8chsnr: all
// four), so no block linear there runs the eager activation quantizer.
// Operands: x [M,K] bf16 or f32 row-major, wc [N,K] int8 (K-major), wsc
// [1,N] f32; scratch for the codes [M,K] int8 and the row scales rs [M] f32
// (the wrapper allocates both); the format's midpoints (grid units), integer
// codes, f32(1 / max|grid|) and code multiplier come in the kernel's
// arguments.  K a multiple of 128.
//
// Exactness.  The arithmetic is that of the port's quant_int_codes, which
// is bit-equal to the JAX package's jitted one: the scale is the reciprocal
// multiply amax * f32(1/gmax) (XLA's rewrite of amax / gmax under jit), the
// quotient x / scale is an IEEE division, and the code is the count of
// midpoints <= the quotient (the compare-sum's >= rule; a binary search
// over the sorted midpoints counts the same prefix).  So this file must be
// built without --use_fast_math, -ftz=true or -prec-div=false: a
// flushed denormal scale or an approximate quotient flips codes.  The int32
// sum is exact (|code| <= 64 on both sides, K <= 4096: <= 2^24), and the
// result is bit-equal to the plain PyTorch version (fused_ch_gemm_ref).
//
// Design.  On the TPU the grid runs in order, and the kernel quantizes its
// [bm, K] block once (at j == kk == 0) into VMEM for every N tile.  Blocks
// on the card run in parallel and share nothing, so one call runs two
// kernels on one stream, and each row is quantized exactly once:
//   (a) fused_ch_quantize_kernel: one warp per row takes the absmax over
//       the whole K, then re-reads the row (from L1 / L2) and writes its
//       int8 codes and rs = scale / mult (its grid table, 16-byte loads,
//       binary-lifting encode and code stores are grid_snap.cuh's, which
//       the quantizers Q1-Q3 share);
//   (b) the s8 instantiation of wgmma_gemm.cuh over the codes and wc
//       (TMA ring, wgmma m64n256k32 s8 x s8 -> s32 on 128 x 256 tiles),
//       whose epilogue (FusedChRescale, on ch_rescale.cuh; K3 runs the
//       same GEMM and rescale on codes made outside) computes
//       (float(acc) * rs[m]) * wsc[n]: two multiplies in JAX's order, no
//       add to contract.
// The TPU kernel kept the codes out of HBM because a dot-only kernel lost
// there; here the codes of a whole call (4 MB at d16's qkv, 16 MB at fc2)
// fit in the 50 MB L2 between the two kernels.
//
// Bound on an H100 SXM.  At VAR-d16's last scale at batch 8 (M = 4096,
// K = 1024) qkv is 2*4096*1024*3072 = 25.8 GOP, 13.0 us at the 1,979 TOP/s
// int8 peak, against 36 MB moved (8 MB of bf16 x, 3 MB of weight codes,
// 25 MB of bf16 output), 10.8 us at 3.35 TB/s: operations bound it (also
// at fc1 and fc2); proj (N = 1024) is bound by its 18 MB, 5.3 us.  PERF.md
// keeps that bound, which counts no activation codes.  The codes' round
// trip adds 8 MB at qkv, proj and fc1 (4 MB written, 4 MB read) and 32 MB
// at fc2, +2.4 us and +9.6 us at 3.35 TB/s if it went to HBM, less where
// L2 holds the codes.  PERF.md has the times of (a), (b) and the whole
// call.
#include "ch_rescale.cuh"
#include "grid_snap.cuh"

namespace {

constexpr int kMaxGrid = 64;             // grid values (fp6_e2m3: 63)
constexpr int QUANT_WARPS = grid_snap::kWarps;   // rows per block of (a)

// The format's midpoints, integer codes, 1/gmax and multiplier
// (grid_snap.cuh, shared with the quantizers Q1-Q3).
using Grid = grid_snap::Table<kMaxGrid, int>;

// (a) One warp per row: the absmax over the whole K, then the codes of the
// row (16 bytes of x a lane per step) and its output scale scale / mult.
template <bool XBF16, int FIRST>
__global__ void __launch_bounds__(32 * QUANT_WARPS)
fused_ch_quantize_kernel(const void* __restrict__ xv,
                         int8_t* __restrict__ codes, float* __restrict__ rs,
                         int M, int K, const __grid_constant__ Grid grid) {
  using V = grid_snap::XVec<XBF16>;
  constexpr int XBYTES = XBF16 ? 2 : 4;
  __shared__ float s_mid[kMaxGrid];
  __shared__ int s_code[kMaxGrid];
  grid_snap::stage(grid, s_mid, s_code);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * QUANT_WARPS + threadIdx.x / 32;
  if (r >= M) return;
  const int row_bytes = K * XBYTES;
  const char* row = static_cast<const char*>(xv) + static_cast<size_t>(r) *
                                                       row_bytes;
  float amax = 0.f;
#pragma unroll 4
  for (int c = lane * 16; c < row_bytes; c += 32 * 16) {
    float v[V::N];
    V::load(row + c, v);
#pragma unroll
    for (int j = 0; j < V::N; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = amax > 0.f ? amax * grid.inv : 1.f;
  if (lane == 0) rs[r] = scale / grid.mult;

  int8_t* out = codes + static_cast<size_t>(r) * K;
  const int n_mids = grid.n_mids;
  for (int c = lane * 16; c < row_bytes; c += 32 * 16) {
    float v[V::N];
    V::load(row + c, v);
    int q[V::N];
#pragma unroll
    for (int j = 0; j < V::N; ++j)
      q[j] = grid_snap::encode<FIRST>(v[j] / scale, s_mid, n_mids, s_code);
    grid_snap::store_codes(out + c / XBYTES, q);
  }
}

// (b)'s epilogue: the per-channel rescale of ch_rescale.cuh, reading the
// row scales that (a) wrote, under a name of its own.
template <typename OutT>
struct FusedChRescale : ch_rescale::RowColRescale<OutT> {};

template <bool XBF16, typename OutT>
int launch(const void* x, const void* wc, const void* wsc, void* codes,
           void* rs, void* out, int M, int N, int K, const Grid& grid,
           cudaStream_t stream) {
  const int blocks = (M + QUANT_WARPS - 1) / QUANT_WARPS;
  auto quantize = grid.n_mids < 16 ? fused_ch_quantize_kernel<XBF16, 8>
                                   : fused_ch_quantize_kernel<XBF16, 32>;
  quantize<<<blocks, 32 * QUANT_WARPS, 0, stream>>>(
      x, static_cast<int8_t*>(codes), static_cast<float*>(rs), M, K, grid);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(ch_rescale::launch<FusedChRescale<OutT>>(
      codes, rs, wc, wsc, out, M, N, K, stream));
}

}  // namespace

// Launch (a) then (b) on `stream`; returns the cudaError_t of the launches
// (0 = success).  x, wc and codes must be 16-byte aligned and K % 128 == 0;
// codes [M, K] int8 and rs [M] f32 are scratch.  x_bf16 / out_bf16: 1 for
// bf16, 0 for f32.  mids (n_mids floats) and codes_table (n_mids + 1 ints)
// are host pointers, copied into the kernel's arguments.
extern "C" int fused_ch_gemm(const void* x, const void* wc, const void* wsc,
                             void* codes, void* rs, void* out, int M, int N,
                             int K, int x_bf16, int out_bf16,
                             const float* mids, const int* codes_table,
                             int n_mids, float inv, float mult,
                             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 128 != 0 || n_mids < 1 ||
      n_mids >= kMaxGrid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Grid grid =
      grid_snap::make_table<kMaxGrid, int>(mids, codes_table, n_mids, inv,
                                           mult);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return out_bf16 ? launch<true, __nv_bfloat16>(x, wc, wsc, codes, rs, out,
                                                  M, N, K, grid, s)
                    : launch<true, float>(x, wc, wsc, codes, rs, out, M, N,
                                          K, grid, s);
  }
  return out_bf16 ? launch<false, __nv_bfloat16>(x, wc, wsc, codes, rs, out,
                                                 M, N, K, grid, s)
                  : launch<false, float>(x, wc, wsc, codes, rs, out, M, N, K,
                                         grid, s);
}

extern "C" const char* fused_ch_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
