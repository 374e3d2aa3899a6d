// Q2: absmax-scaled integer codes of a value grid, for Hopper (sm_90a),
// per group of gs consecutive values of x:
//
//   single grid:  s    = amax|v| * inv (f32; rounded to x's dtype where
//                        round_scale), or 1 where amax is not > 0
//                 code = table[pos(v / s)]          -> int8
//                 out scale = s / mult              -> f32 per group
//   dual grid:    vn = v <= 0 ? v : 0,  vp = v > 0 ? v : 0, each half on
//                 its own grid, scale and multiplier as above (two code
//                 tensors and two scale tensors)
//
// with pos(q) the count of grid midpoints <= q (grid_snap.cuh).  x is
// bf16 or f32, read as f32 (exact); the quotient is an f32 division.  The
// table holds the integer value codes round(grid * mult) (ops/packing.py
// CODE_MULT) or the grid indices 0..n-1 as int8 (a grid of more than 128
// values keeps the index's low byte, as .to(int8) does).
//
// Replaces no TPU kernel: in the JAX package these are plain jnp under
// jit (fpqvar_tpu/ops/packing.py quant_int_codes :207,
// quant_int_codes_dual :227, and encode_to_grid :72 after pack's or the
// KV codec's scale), which XLA fuses, while the port's plain versions
// (ops/packing.py quant_int_codes_ref, quant_int_codes_dual_ref,
// pack_codes_ref, grid_index_codes_ref) run as eager PyTorch, four kernels
// a grid midpoint.  This kernel is their function in one launch: the int8
// recipe's activation codes (K5's and K1's operands), the per-token dual
// codes of fc2 under the per-channel recipes (K3's operands), the packed
// KV cache's encode (int8kv, int8att) and the weight codes of pack and
// pack_int_codes on the card.  The wrapper is ops/quant_kernels.py.
//
// Exactness.  Bit-equal to the plain version on the card: the scale is
// amax * f32(1 / gmax) (XLA's rewrite of absmax / gmax under jit), in f32
// for quant_int_codes and the KV codec, rounded to x's dtype for pack;
// the quotient an IEEE division (__fdiv_rn); the output scale s / mult an
// IEEE division by a power of two; the absmax a NaN-propagating max.  No
// fast-math flag may reach this file.
//
// Design and bound.  K4's phase (a) with a table of up to 256 values and
// a group of any multiple of 16 bytes: one warp per group takes the
// absmax, then re-reads the group from L1 / L2 and writes its codes, 16
// bytes of x a lane a step.  Bytes bound it: x [4096, 1024] bf16 per
// group of 128 reads 8 MB and writes 4 MB of codes and 128 KB of scales,
// 3.8 us at 3.35 TB/s.
#include "grid_snap.cuh"

namespace {

using grid_snap::kWarps;

template <int CAP>
using CodeTable = grid_snap::Table<CAP, int>;

template <bool XBF16, int CAP, bool ROUND>
__global__ void __launch_bounds__(32 * kWarps)
grid_codes_kernel(const void* __restrict__ x, int8_t* __restrict__ codes,
                  float* __restrict__ scales, int n_groups, int gs,
                  const __grid_constant__ CodeTable<CAP> t) {
  using V = grid_snap::XVec<XBF16>;
  __shared__ float s_mid[CAP];
  __shared__ int s_code[CAP];
  grid_snap::stage(t, s_mid, s_code);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int g = blockIdx.x * kWarps + threadIdx.x / 32;
  if (g >= n_groups) return;
  const size_t first = static_cast<size_t>(g) * gs;
  const char* src = static_cast<const char*>(x) + first * V::BYTES;
  int8_t* dst = codes + first;
  float amax = 0.f;
  for (int c = lane * V::N; c < gs; c += 32 * V::N) {
    float v[V::N];
    V::load(src + c * V::BYTES, v);
#pragma unroll
    for (int j = 0; j < V::N; ++j)
      amax = grid_snap::nan_max(fabsf(v[j]), amax);
  }
  amax = grid_snap::warp_nan_max(amax);
  const float s = grid_snap::safe_scale<XBF16, ROUND>(amax, t.inv);
  if (lane == 0) scales[g] = __fdiv_rn(s, t.mult);
  const int n_mids = t.n_mids;
  for (int c = lane * V::N; c < gs; c += 32 * V::N) {
    float v[V::N];
    V::load(src + c * V::BYTES, v);
    int q[V::N];
#pragma unroll
    for (int j = 0; j < V::N; ++j)
      q[j] = grid_snap::encode<CAP / 2>(__fdiv_rn(v[j], s), s_mid, n_mids,
                                        s_code);
    grid_snap::store_codes(dst + c, q);
  }
}

template <bool XBF16, int CAP>
__global__ void __launch_bounds__(32 * kWarps)
dual_codes_kernel(const void* __restrict__ x, int8_t* __restrict__ codes_n,
                  float* __restrict__ scales_n, int8_t* __restrict__ codes_p,
                  float* __restrict__ scales_p, int n_groups, int gs,
                  const __grid_constant__ CodeTable<CAP> tn,
                  const __grid_constant__ CodeTable<CAP> tp) {
  using V = grid_snap::XVec<XBF16>;
  __shared__ float s_mid_n[CAP];
  __shared__ int s_code_n[CAP];
  __shared__ float s_mid_p[CAP];
  __shared__ int s_code_p[CAP];
  grid_snap::stage(tn, s_mid_n, s_code_n);
  grid_snap::stage(tp, s_mid_p, s_code_p);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int g = blockIdx.x * kWarps + threadIdx.x / 32;
  if (g >= n_groups) return;
  const size_t first = static_cast<size_t>(g) * gs;
  const char* src = static_cast<const char*>(x) + first * V::BYTES;
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
  const float sn = grid_snap::safe_scale<XBF16, false>(an, tn.inv);
  const float sp = grid_snap::safe_scale<XBF16, false>(ap, tp.inv);
  if (lane == 0) {
    scales_n[g] = __fdiv_rn(sn, tn.mult);
    scales_p[g] = __fdiv_rn(sp, tp.mult);
  }
  for (int c = lane * V::N; c < gs; c += 32 * V::N) {
    float v[V::N];
    V::load(src + c * V::BYTES, v);
    int qn[V::N], qp[V::N];
#pragma unroll
    for (int j = 0; j < V::N; ++j) {
      const float vn = v[j] <= 0.f ? v[j] : 0.f;
      const float vp = v[j] > 0.f ? v[j] : 0.f;
      qn[j] = grid_snap::encode<CAP / 2>(__fdiv_rn(vn, sn), s_mid_n,
                                         tn.n_mids, s_code_n);
      qp[j] = grid_snap::encode<CAP / 2>(__fdiv_rn(vp, sp), s_mid_p,
                                         tp.n_mids, s_code_p);
    }
    grid_snap::store_codes(codes_n + first + c, qn);
    grid_snap::store_codes(codes_p + first + c, qp);
  }
}

template <bool XBF16, int CAP, bool ROUND>
cudaError_t launch_single(const void* x, void* codes, void* scales,
                          int n_groups, int gs, const float* mids,
                          const int* tab, int n_mids, float inv, float mult,
                          cudaStream_t stream) {
  const auto t = grid_snap::make_table<CAP, int>(mids, tab, n_mids, inv, mult);
  const int blocks = (n_groups + kWarps - 1) / kWarps;
  grid_codes_kernel<XBF16, CAP, ROUND><<<blocks, 32 * kWarps, 0, stream>>>(
      x, static_cast<int8_t*>(codes), static_cast<float*>(scales), n_groups,
      gs, t);
  return cudaGetLastError();
}

template <bool XBF16, int CAP>
cudaError_t launch_dual(const void* x, void* codes_n, void* scales_n,
                        void* codes_p, void* scales_p, int n_groups, int gs,
                        const float* mids_n, const int* tab_n, int n_n,
                        float inv_n, float mult_n, const float* mids_p,
                        const int* tab_p, int n_p, float inv_p, float mult_p,
                        cudaStream_t stream) {
  const auto tn =
      grid_snap::make_table<CAP, int>(mids_n, tab_n, n_n, inv_n, mult_n);
  const auto tp =
      grid_snap::make_table<CAP, int>(mids_p, tab_p, n_p, inv_p, mult_p);
  const int blocks = (n_groups + kWarps - 1) / kWarps;
  dual_codes_kernel<XBF16, CAP><<<blocks, 32 * kWarps, 0, stream>>>(
      x, static_cast<int8_t*>(codes_n), static_cast<float*>(scales_n),
      static_cast<int8_t*>(codes_p), static_cast<float*>(scales_p), n_groups,
      gs, tn, tp);
  return cudaGetLastError();
}

template <bool XBF16, bool ROUND>
cudaError_t dispatch_single(const void* x, void* codes, void* scales,
                            int n_groups, int gs, const float* mids,
                            const int* tab, int n_mids, float inv,
                            float mult, cudaStream_t s) {
  switch (grid_snap::table_cap(n_mids)) {
    case 16:
      return launch_single<XBF16, 16, ROUND>(x, codes, scales, n_groups, gs,
                                             mids, tab, n_mids, inv, mult, s);
    case 64:
      return launch_single<XBF16, 64, ROUND>(x, codes, scales, n_groups, gs,
                                             mids, tab, n_mids, inv, mult, s);
    case 256:
      return launch_single<XBF16, 256, ROUND>(x, codes, scales, n_groups, gs,
                                              mids, tab, n_mids, inv, mult,
                                              s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool XBF16>
cudaError_t dispatch(const void* x, void* codes_a, void* scales_a,
                     void* codes_b, void* scales_b, int n_groups, int gs,
                     int dual, int round_scale, const float* mids_a,
                     const int* tab_a, int n_a, float inv_a, float mult_a,
                     const float* mids_b, const int* tab_b, int n_b,
                     float inv_b, float mult_b, cudaStream_t s) {
  if (!dual) {
    return round_scale
               ? dispatch_single<XBF16, true>(x, codes_a, scales_a, n_groups,
                                              gs, mids_a, tab_a, n_a, inv_a,
                                              mult_a, s)
               : dispatch_single<XBF16, false>(x, codes_a, scales_a,
                                               n_groups, gs, mids_a, tab_a,
                                               n_a, inv_a, mult_a, s);
  }
  if (round_scale) return cudaErrorInvalidValue;
  const int cap = grid_snap::table_cap(n_a > n_b ? n_a : n_b);
  if (cap == 16)
    return launch_dual<XBF16, 16>(x, codes_a, scales_a, codes_b, scales_b,
                                  n_groups, gs, mids_a, tab_a, n_a, inv_a,
                                  mult_a, mids_b, tab_b, n_b, inv_b, mult_b,
                                  s);
  if (cap == 64)
    return launch_dual<XBF16, 64>(x, codes_a, scales_a, codes_b, scales_b,
                                  n_groups, gs, mids_a, tab_a, n_a, inv_a,
                                  mult_a, mids_b, tab_b, n_b, inv_b, mult_b,
                                  s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Launch Q2 on `stream`; returns the launch's cudaError_t (0 = success).
// x [n_groups * gs] (bf16 where x_bf16, else f32) must be 16-byte aligned
// with gs * element bytes a multiple of 16; codes_* [n_groups * gs] int8
// (8-byte aligned), scales_* [n_groups] f32.  dual = 0: one grid (table a:
// n_a midpoints, n_a + 1 codes, inv_a, mult_a), the scale rounded to x's
// dtype where round_scale; dual = 1: table a the negative half into
// codes_a / scales_a, table b the positive half into codes_b / scales_b,
// each of at most 64 values, f32 scales.  The tables are host pointers,
// copied into the kernel's arguments.
extern "C" int grid_codes(const void* x, void* codes_a, void* scales_a,
                          void* codes_b, void* scales_b, int n_groups, int gs,
                          int x_bf16, int dual, int round_scale,
                          const float* mids_a, const int* tab_a, int n_a,
                          float inv_a, float mult_a, const float* mids_b,
                          const int* tab_b, int n_b, float inv_b,
                          float mult_b, void* stream) {
  const int vec = x_bf16 ? 8 : 4;
  if (n_groups <= 0 || gs <= 0 || gs % vec != 0 || n_a < 1 ||
      (dual && n_b < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      x_bf16 ? dispatch<true>(x, codes_a, scales_a, codes_b, scales_b,
                              n_groups, gs, dual, round_scale, mids_a, tab_a,
                              n_a, inv_a, mult_a, mids_b, tab_b, n_b, inv_b,
                              mult_b, s)
             : dispatch<false>(x, codes_a, scales_a, codes_b, scales_b,
                               n_groups, gs, dual, round_scale, mids_a,
                               tab_a, n_a, inv_a, mult_a, mids_b, tab_b, n_b,
                               inv_b, mult_b, s);
  return static_cast<int>(e);
}

extern "C" const char* grid_codes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
