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
// Design and bound.  The work is a few operations a byte, so bytes bound
// it: at VAR-d16's last scale at batch 8, x [4096, 1024] bf16 is 8 MB
// read and 8 MB written, 5.0 us at 3.35 TB/s ([4096, 4096]: 20 us).  A
// group spans as many lanes as it has 16-byte vectors (grid_snap.cuh's
// layout: 2 groups of 128 bf16 a warp, 4 KV rows of 64, a row of 4,096
// over 128 threads), is read once into registers, reduced by shuffles
// and snapped from the same registers.  The table (up to 256 values:
// fp8_e4m3 has 255; 8 for a half of the fp4 dual grids) sits in shared
// memory; pos() is a binary lifting of log2(table size) steps.  A value
// of a dual grid lies in one half: the other half holds +0 there, whose
// output is the same for the whole group, so it is computed once a group
// and half, from the real division +0 / s (a scale that rounded to 0
// makes it NaN, position 0, not the grid's 0).  Each value then takes one
// division and one table walk, on its own half's table, where it took
// two of each.  What is left is issue: the SASS holds ~35 instructions a
// value of one grid and ~45-60 of a dual grid (the division's ~10, ~5 a
// step of the walk), 21-34 us of issue at [4096, 4096], above the bytes
// bound (PERF.md section 6).
#include "grid_snap.cuh"

namespace {

using grid_snap::kMaxBlock;
using grid_snap::kVecs;
using grid_snap::round_x;
using grid_snap::Slot;

template <int CAP>
using ValueTable = grid_snap::Table<CAP, float>;

template <bool XBF16, int CAP, int MAXV>
__global__ void __launch_bounds__(kMaxBlock)
fake_grid_kernel(const void* __restrict__ x, void* __restrict__ y,
                 int n_groups, int vecs, int seg, float clip, int has_clip,
                 const __grid_constant__ ValueTable<CAP> t) {
  using V = grid_snap::XVec<XBF16>;
  __shared__ float s_mid[CAP];
  __shared__ float s_val[CAP];
  __shared__ float red[kMaxBlock / 32][1];
  grid_snap::stage(t, s_mid, s_val);
  __syncthreads();
  const Slot at(seg, n_groups);
  const size_t base = static_cast<size_t>(at.group) * vecs * 16;
  const char* src = static_cast<const char*>(x) + base;
  char* dst = static_cast<char*>(y) + base;
  const int chunk = seg * MAXV;
  uint4 raw[MAXV];
  float amax[1] = {0.f};
  for (int c0 = 0; c0 < vecs; c0 += chunk) {
    grid_snap::load_vecs(raw, src, at, seg, vecs, c0);
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      float v[V::N];
      V::unpack(raw[k], v);
#pragma unroll
      for (int j = 0; j < V::N; ++j) {
        const float w = has_clip ? grid_snap::clamp_nan(v[j], -clip, clip)
                                 : v[j];
        amax[0] = grid_snap::max_nan(fabsf(w), amax[0]);
      }
    }
  }
  grid_snap::seg_nan_max(amax, seg, red);
  const float s = grid_snap::safe_scale<XBF16, true>(amax[0], t.inv);
  for (int c0 = 0; c0 < vecs; c0 += chunk) {
    if (vecs > chunk) grid_snap::load_vecs(raw, src, at, seg, vecs, c0);
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      const int i = c0 + at.lane + k * seg;
      if (!at.live || i >= vecs) continue;
      float v[V::N];
      V::unpack(raw[k], v);
#pragma unroll
      for (int j = 0; j < V::N; ++j) {
        const float w = has_clip ? grid_snap::clamp_nan(v[j], -clip, clip)
                                 : v[j];
        const float q = s_val[grid_snap::snap<CAP / 2>(__fdiv_rn(w, s),
                                                       s_mid)];
        v[j] = __fmul_rn(q, s);
      }
      V::store(dst + static_cast<size_t>(i) * 16, v);
    }
  }
}

template <bool XBF16, int CAP, int MAXV>
__global__ void __launch_bounds__(kMaxBlock)
fake_dual_kernel(const void* __restrict__ x, void* __restrict__ y,
                 int n_groups, int vecs, int seg,
                 const __grid_constant__ ValueTable<CAP> tn,
                 const __grid_constant__ ValueTable<CAP> tp) {
  using V = grid_snap::XVec<XBF16>;
  // the negative half's table at 0, the positive half's at CAP
  __shared__ float s_mid[2 * CAP];
  __shared__ float s_val[2 * CAP];
  __shared__ float red[kMaxBlock / 32][2];
  grid_snap::stage(tn, s_mid, s_val);
  grid_snap::stage(tp, s_mid + CAP, s_val + CAP);
  __syncthreads();
  const Slot at(seg, n_groups);
  const size_t base = static_cast<size_t>(at.group) * vecs * 16;
  const char* src = static_cast<const char*>(x) + base;
  char* dst = static_cast<char*>(y) + base;
  const int chunk = seg * MAXV;
  uint4 raw[MAXV];
  // x <= 0 on the negative grid, x > 0 on the positive one; each half
  // holds +0 where the other holds x (and a NaN is +0 in both), so the
  // halves' absmax are the max of 0 and -x, and of 0 and x, over the
  // values that are not NaN (fmaxf drops a NaN)
  float a[2] = {0.f, 0.f};
  for (int c0 = 0; c0 < vecs; c0 += chunk) {
    grid_snap::load_vecs(raw, src, at, seg, vecs, c0);
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      float v[V::N];
      V::unpack(raw[k], v);
#pragma unroll
      for (int j = 0; j < V::N; ++j) {
        a[0] = fmaxf(a[0], -v[j]);
        a[1] = fmaxf(a[1], v[j]);
      }
    }
  }
  grid_snap::seg_nan_max(a, seg, red);
  const float sn = grid_snap::safe_scale<XBF16, true>(a[0], tn.inv);
  const float sp = grid_snap::safe_scale<XBF16, true>(a[1], tp.inv);
  // each half's output where it holds +0: snap(+0 / s) by the real
  // division (0 / 0 is NaN where the scale rounded to 0)
  const float yn0 = round_x<XBF16>(__fmul_rn(
      s_val[grid_snap::snap<CAP / 2>(__fdiv_rn(0.f, sn), s_mid)], sn));
  const float yp0 = round_x<XBF16>(__fmul_rn(
      s_val[CAP + grid_snap::snap<CAP / 2>(__fdiv_rn(0.f, sp),
                                           s_mid + CAP)],
      sp));
  for (int c0 = 0; c0 < vecs; c0 += chunk) {
    if (vecs > chunk) grid_snap::load_vecs(raw, src, at, seg, vecs, c0);
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      const int i = c0 + at.lane + k * seg;
      if (!at.live || i >= vecs) continue;
      float v[V::N];
      V::unpack(raw[k], v);
#pragma unroll
      for (int j = 0; j < V::N; ++j) {
        // the value's own half (a NaN: +0 on the negative half, which is
        // yn0); the other half's output is its constant
        const bool pos = v[j] > 0.f;
        const float w = (pos || v[j] <= 0.f) ? v[j] : 0.f;
        const int h = pos ? CAP : 0;
        const float s = pos ? sp : sn;
        const float yq = round_x<XBF16>(__fmul_rn(
            s_val[h + grid_snap::snap<CAP / 2>(__fdiv_rn(w, s), s_mid + h)],
            s));
        v[j] = pos ? __fadd_rn(yn0, yq) : __fadd_rn(yq, yp0);
      }
      V::store(dst + static_cast<size_t>(i) * 16, v);
    }
  }
}

template <bool XBF16, int CAP, int MAXV>
cudaError_t launch_single(const void* x, void* y, int n_groups,
                          const grid_snap::Layout& l,
                          const ValueTable<CAP>& t, float clip, int has_clip,
                          cudaStream_t stream) {
  fake_grid_kernel<XBF16, CAP, MAXV>
      <<<grid_snap::layout_blocks(l, n_groups), l.block, 0, stream>>>(
          x, y, n_groups, l.vecs, l.seg, clip, has_clip, t);
  return cudaGetLastError();
}

template <bool XBF16, int CAP, int MAXV>
cudaError_t launch_dual(const void* x, void* y, int n_groups,
                        const grid_snap::Layout& l, const ValueTable<CAP>& tn,
                        const ValueTable<CAP>& tp, cudaStream_t stream) {
  fake_dual_kernel<XBF16, CAP, MAXV>
      <<<grid_snap::layout_blocks(l, n_groups), l.block, 0, stream>>>(
          x, y, n_groups, l.vecs, l.seg, tn, tp);
  return cudaGetLastError();
}

template <bool XBF16, int CAP>
cudaError_t single(const void* x, void* y, int n_groups, int gs,
                   const float* mids, const float* vals, int n_mids,
                   float inv, float clip, int has_clip, cudaStream_t s) {
  const auto t = grid_snap::make_table<CAP, float>(mids, vals, n_mids, inv,
                                                   1.f);
  const auto l = grid_snap::layout(gs / grid_snap::XVec<XBF16>::N);
  if (l.maxv == 1)
    return launch_single<XBF16, CAP, 1>(x, y, n_groups, l, t, clip,
                                        has_clip, s);
  return launch_single<XBF16, CAP, kVecs>(x, y, n_groups, l, t, clip,
                                          has_clip, s);
}

template <bool XBF16, int CAP>
cudaError_t dual(const void* x, void* y, int n_groups, int gs,
                 const float* mids_n, const float* vals_n, int n_n,
                 float inv_n, const float* mids_p, const float* vals_p,
                 int n_p, float inv_p, cudaStream_t s) {
  const auto tn = grid_snap::make_table<CAP, float>(mids_n, vals_n, n_n,
                                                    inv_n, 1.f);
  const auto tp = grid_snap::make_table<CAP, float>(mids_p, vals_p, n_p,
                                                    inv_p, 1.f);
  const auto l = grid_snap::layout(gs / grid_snap::XVec<XBF16>::N);
  if (l.maxv == 1)
    return launch_dual<XBF16, CAP, 1>(x, y, n_groups, l, tn, tp, s);
  return launch_dual<XBF16, CAP, kVecs>(x, y, n_groups, l, tn, tp, s);
}

template <bool XBF16>
cudaError_t dispatch(const void* x, void* y, int n_groups, int gs, int dual_,
                     const float* mids_a, const float* vals_a, int n_a,
                     float inv_a, const float* mids_b, const float* vals_b,
                     int n_b, float inv_b, float clip, int has_clip,
                     cudaStream_t s) {
  if (dual_) {
    const int cap = grid_snap::table_cap(n_a > n_b ? n_a : n_b);
    if (cap == 8)
      return dual<XBF16, 8>(x, y, n_groups, gs, mids_a, vals_a, n_a, inv_a,
                            mids_b, vals_b, n_b, inv_b, s);
    if (cap == 16)
      return dual<XBF16, 16>(x, y, n_groups, gs, mids_a, vals_a, n_a, inv_a,
                             mids_b, vals_b, n_b, inv_b, s);
    if (cap == 64)
      return dual<XBF16, 64>(x, y, n_groups, gs, mids_a, vals_a, n_a, inv_a,
                             mids_b, vals_b, n_b, inv_b, s);
    return cudaErrorInvalidValue;
  }
  switch (grid_snap::table_cap(n_a)) {
    case 8:
      return single<XBF16, 8>(x, y, n_groups, gs, mids_a, vals_a, n_a,
                              inv_a, clip, has_clip, s);
    case 16:
      return single<XBF16, 16>(x, y, n_groups, gs, mids_a, vals_a, n_a,
                               inv_a, clip, has_clip, s);
    case 64:
      return single<XBF16, 64>(x, y, n_groups, gs, mids_a, vals_a, n_a,
                               inv_a, clip, has_clip, s);
    case 256:
      return single<XBF16, 256>(x, y, n_groups, gs, mids_a, vals_a, n_a,
                                inv_a, clip, has_clip, s);
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
