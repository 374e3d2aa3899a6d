// Q1: absmax-scaled fake quantization onto a value grid, for Hopper
// (sm_90a), per group of gs consecutive values of x (a row of K values per
// token, or a group of 128):
//
//   single grid:  v' = clamp(v, -clip, clip)      (where clip is given)
//                 s  = x_dtype(amax|v'| * inv), or 1 where amax is not > 0
//                 y  = x_dtype(grid[pos(v' / s)] * s)
//   dual grid:    vn = v <= 0 ? v : 0,  vp = v > 0 ? v : 0
//                 sn, sp from amax|vn|, amax|vp| as s above
//                 y  = x_dtype(x_dtype(gn[pos_n(vn / sn)] * sn)
//                              + x_dtype(gp[pos_p(vp / sp)] * sp))
//
// with pos(q) the count of grid midpoints <= q (grid_snap.cuh).  x and y
// are bf16 or f32; s, sn and sp are rounded to x's dtype and the quotient
// is an f32 division that is not rounded to x's dtype first.
//
// Replaces no TPU kernel: in the JAX package these quantizers are plain
// jnp under jit (fpqvar_tpu/ops/quantizers.py fake_quant_fp :105,
// fake_quant_dual :138), which XLA fuses into a few loops, while the
// port's plain versions (ops/quantizers.py fake_quant_fp_ref,
// fake_quant_dual_ref) run as eager PyTorch, four kernels a grid
// midpoint.  This kernel is their function in one launch: the
// activations of the packed, fake and w6a6 recipes and of the paper's fp4
// and fp6 recipes, the dense fp6 KV cache of the _kv6 recipes
// (fake_quant_kv), the format search and GALT's STE.  The wrapper is
// ops/quant_kernels.py fake_quant_fp / fake_quant_dual.
//
// Exactness.  Bit-equal to the plain version on the card: the scale is
// the product amax * f32(1 / gmax) rounded to x's dtype (XLA's rewrite of
// absmax / gmax under jit), the quotient an IEEE division (__fdiv_rn),
// the products and the dual sum __fmul_rn / __fadd_rn (no FMA), each
// rounded to x's dtype where PyTorch rounds it, and the absmax a
// NaN-propagating max (a group with a NaN gets scale 1, as torch.amax
// and safe_scale give it; a NaN element snaps to grid[0]).  No fast-math
// flag may reach this file (ops/_build.py NVCC_FLAGS holds none).
//
// Design and bound.  One warp per group: the first pass takes the absmax
// (both halves' for a dual grid), the second re-reads the group from L1 /
// L2 and writes y, 16 bytes a lane a step.  The table (up to 256 values:
// fp8_e4m3 has 255) sits in shared memory; pos() is a binary lifting of
// log2(table size) steps.  The work is a few operations a byte, so bytes
// bound it: at VAR-d16's last scale at batch 8, x [4096, 1024] bf16 is 8
// MB read and 8 MB written, 5.0 us at 3.35 TB/s ([4096, 4096]: 20 us).
// A group of 128 bf16 values keeps half a warp busy (16 lanes of 16
// bytes); the simple layout is the first port's.
#include "grid_snap.cuh"

namespace {

using grid_snap::kWarps;

template <int CAP>
using ValueTable = grid_snap::Table<CAP, float>;

template <bool XBF16, int CAP>
__global__ void __launch_bounds__(32 * kWarps)
fake_grid_kernel(const void* __restrict__ x, void* __restrict__ y,
                 int n_groups, int gs, float clip, int has_clip,
                 const __grid_constant__ ValueTable<CAP> t) {
  using V = grid_snap::XVec<XBF16>;
  __shared__ float s_mid[CAP];
  __shared__ float s_val[CAP];
  grid_snap::stage(t, s_mid, s_val);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int g = blockIdx.x * kWarps + threadIdx.x / 32;
  if (g >= n_groups) return;
  const size_t base = static_cast<size_t>(g) * gs * V::BYTES;
  const char* src = static_cast<const char*>(x) + base;
  char* dst = static_cast<char*>(y) + base;
  float amax = 0.f;
  for (int c = lane * V::N; c < gs; c += 32 * V::N) {
    float v[V::N];
    V::load(src + c * V::BYTES, v);
#pragma unroll
    for (int j = 0; j < V::N; ++j) {
      const float w = has_clip ? grid_snap::clamp_nan(v[j], -clip, clip)
                               : v[j];
      amax = grid_snap::nan_max(fabsf(w), amax);
    }
  }
  amax = grid_snap::warp_nan_max(amax);
  const float s = grid_snap::safe_scale<XBF16, true>(amax, t.inv);
  const int n_mids = t.n_mids;
  for (int c = lane * V::N; c < gs; c += 32 * V::N) {
    float v[V::N];
    V::load(src + c * V::BYTES, v);
#pragma unroll
    for (int j = 0; j < V::N; ++j) {
      const float w = has_clip ? grid_snap::clamp_nan(v[j], -clip, clip)
                               : v[j];
      const float q =
          grid_snap::encode<CAP / 2>(__fdiv_rn(w, s), s_mid, n_mids, s_val);
      v[j] = __fmul_rn(q, s);
    }
    V::store(dst + c * V::BYTES, v);
  }
}

template <bool XBF16, int CAP>
__global__ void __launch_bounds__(32 * kWarps)
fake_dual_kernel(const void* __restrict__ x, void* __restrict__ y,
                 int n_groups, int gs,
                 const __grid_constant__ ValueTable<CAP> tn,
                 const __grid_constant__ ValueTable<CAP> tp) {
  using V = grid_snap::XVec<XBF16>;
  __shared__ float s_mid_n[CAP];
  __shared__ float s_val_n[CAP];
  __shared__ float s_mid_p[CAP];
  __shared__ float s_val_p[CAP];
  grid_snap::stage(tn, s_mid_n, s_val_n);
  grid_snap::stage(tp, s_mid_p, s_val_p);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int g = blockIdx.x * kWarps + threadIdx.x / 32;
  if (g >= n_groups) return;
  const size_t base = static_cast<size_t>(g) * gs * V::BYTES;
  const char* src = static_cast<const char*>(x) + base;
  char* dst = static_cast<char*>(y) + base;
  // x <= 0 on the negative grid, x > 0 on the positive one; each half
  // holds +0 where the other holds x (and a NaN is +0 in both)
  float an = 0.f, ap = 0.f;
  for (int c = lane * V::N; c < gs; c += 32 * V::N) {
    float v[V::N];
    V::load(src + c * V::BYTES, v);
#pragma unroll
    for (int j = 0; j < V::N; ++j) {
      an = grid_snap::nan_max(fabsf(v[j] <= 0.f ? v[j] : 0.f), an);
      ap = grid_snap::nan_max(fabsf(v[j] > 0.f ? v[j] : 0.f), ap);
    }
  }
  an = grid_snap::warp_nan_max(an);
  ap = grid_snap::warp_nan_max(ap);
  const float sn = grid_snap::safe_scale<XBF16, true>(an, tn.inv);
  const float sp = grid_snap::safe_scale<XBF16, true>(ap, tp.inv);
  for (int c = lane * V::N; c < gs; c += 32 * V::N) {
    float v[V::N];
    V::load(src + c * V::BYTES, v);
#pragma unroll
    for (int j = 0; j < V::N; ++j) {
      const float vn = v[j] <= 0.f ? v[j] : 0.f;
      const float vp = v[j] > 0.f ? v[j] : 0.f;
      const float qn = grid_snap::encode<CAP / 2>(__fdiv_rn(vn, sn), s_mid_n,
                                                  tn.n_mids, s_val_n);
      const float qp = grid_snap::encode<CAP / 2>(__fdiv_rn(vp, sp), s_mid_p,
                                                  tp.n_mids, s_val_p);
      v[j] = __fadd_rn(grid_snap::round_x<XBF16>(__fmul_rn(qn, sn)),
                       grid_snap::round_x<XBF16>(__fmul_rn(qp, sp)));
    }
    V::store(dst + c * V::BYTES, v);
  }
}

template <bool XBF16, int CAP>
cudaError_t launch_single(const void* x, void* y, int n_groups, int gs,
                          const float* mids, const float* vals, int n_mids,
                          float inv, float clip, int has_clip,
                          cudaStream_t stream) {
  const auto t = grid_snap::make_table<CAP, float>(mids, vals, n_mids, inv,
                                                   1.f);
  const int blocks = (n_groups + kWarps - 1) / kWarps;
  fake_grid_kernel<XBF16, CAP><<<blocks, 32 * kWarps, 0, stream>>>(
      x, y, n_groups, gs, clip, has_clip, t);
  return cudaGetLastError();
}

template <bool XBF16, int CAP>
cudaError_t launch_dual(const void* x, void* y, int n_groups, int gs,
                        const float* mids_n, const float* vals_n, int n_n,
                        float inv_n, const float* mids_p, const float* vals_p,
                        int n_p, float inv_p, cudaStream_t stream) {
  const auto tn = grid_snap::make_table<CAP, float>(mids_n, vals_n, n_n,
                                                    inv_n, 1.f);
  const auto tp = grid_snap::make_table<CAP, float>(mids_p, vals_p, n_p,
                                                    inv_p, 1.f);
  const int blocks = (n_groups + kWarps - 1) / kWarps;
  fake_dual_kernel<XBF16, CAP><<<blocks, 32 * kWarps, 0, stream>>>(
      x, y, n_groups, gs, tn, tp);
  return cudaGetLastError();
}

template <bool XBF16>
cudaError_t dispatch(const void* x, void* y, int n_groups, int gs, int dual,
                     const float* mids_a, const float* vals_a, int n_a,
                     float inv_a, const float* mids_b, const float* vals_b,
                     int n_b, float inv_b, float clip, int has_clip,
                     cudaStream_t s) {
  if (dual) {
    const int cap = grid_snap::table_cap(n_a > n_b ? n_a : n_b);
    if (cap == 16)
      return launch_dual<XBF16, 16>(x, y, n_groups, gs, mids_a, vals_a, n_a,
                                    inv_a, mids_b, vals_b, n_b, inv_b, s);
    if (cap == 64)
      return launch_dual<XBF16, 64>(x, y, n_groups, gs, mids_a, vals_a, n_a,
                                    inv_a, mids_b, vals_b, n_b, inv_b, s);
    return cudaErrorInvalidValue;
  }
  switch (grid_snap::table_cap(n_a)) {
    case 16:
      return launch_single<XBF16, 16>(x, y, n_groups, gs, mids_a, vals_a,
                                      n_a, inv_a, clip, has_clip, s);
    case 64:
      return launch_single<XBF16, 64>(x, y, n_groups, gs, mids_a, vals_a,
                                      n_a, inv_a, clip, has_clip, s);
    case 256:
      return launch_single<XBF16, 256>(x, y, n_groups, gs, mids_a, vals_a,
                                       n_a, inv_a, clip, has_clip, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch Q1 on `stream`; returns the launch's cudaError_t (0 = success).
// x and y [n_groups * gs] (bf16 where x_bf16, else f32) must be 16-byte
// aligned with gs * element bytes a multiple of 16.  dual = 0: one grid
// (table a: n_a midpoints, n_a + 1 values, inv_a), clamped to +-clip
// first where has_clip; dual = 1: table a the negative half, table b the
// positive half, each of at most 64 values.  The tables are host
// pointers, copied into the kernel's arguments.
extern "C" int fake_quant_grid(const void* x, void* y, int n_groups, int gs,
                               int x_bf16, int dual, const float* mids_a,
                               const float* vals_a, int n_a, float inv_a,
                               const float* mids_b, const float* vals_b,
                               int n_b, float inv_b, float clip, int has_clip,
                               void* stream) {
  const int vec = x_bf16 ? 8 : 4;
  if (n_groups <= 0 || gs <= 0 || gs % vec != 0 || n_a < 1 ||
      (dual && n_b < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      x_bf16 ? dispatch<true>(x, y, n_groups, gs, dual, mids_a, vals_a, n_a,
                              inv_a, mids_b, vals_b, n_b, inv_b, clip,
                              has_clip, s)
             : dispatch<false>(x, y, n_groups, gs, dual, mids_a, vals_a, n_a,
                               inv_a, mids_b, vals_b, n_b, inv_b, clip,
                               has_clip, s);
  return static_cast<int>(e);
}

extern "C" const char* fake_quant_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
