// Q3: linear INT fake quantization, for Hopper (sm_90a), per group of gs
// consecutive values of x (a row of K values per token, or a group of
// 128), every step rounded to x's dtype X as PyTorch rounds it:
//
//   symmetric:   s  = X(X(max(amax|v|, eps)) * inv)         inv = 1 / q_max
//                y  = X(clamp(rint(X(v / s)), q_min, q_max) * s)
//   asymmetric:  s  = X(X(max(X(max v - min v), eps)) * inv)
//                                              inv = 1 / (q_max - q_min)
//                zp = rint(X(q_min - X(min v / s)))
//                q  = clamp(X(rint(X(v / s)) + zp), q_min, q_max)
//                y  = X(X(q - zp) * s)
//
// x and y are bf16 or f32; inv is f32(1 / n) (XLA's multiply for a
// division by a constant under jit); rint rounds half to even, as
// torch.round does; max, min and clamp propagate NaN.
//
// Replaces no TPU kernel: in the JAX package these quantizers are plain
// jnp under jit (fpqvar_tpu/ops/quantizers.py fake_quant_int_sym :209,
// fake_quant_int_asym :232), which XLA fuses, while the port's plain
// versions (ops/quantizers.py fake_quant_int_sym_ref,
// fake_quant_int_asym_ref) run as a dozen eager PyTorch kernels.  This
// kernel is their function in one launch: int4_rtn's activations
// (symmetric; asymmetric at fc2), the int_sym dense KV cache
// (fake_quant_kv, on f32) and int_sym_ste.  The wrapper is
// ops/quant_kernels.py fake_quant_int_sym / fake_quant_int_asym.
//
// Exactness.  Bit-equal to the plain version on the card: every
// division is __fdiv_rn (the bf16 quotient is rounded to bf16 before
// rint, as PyTorch's bf16 division rounds it), every product, sum and
// difference __fmul_rn / __fadd_rn / __fsub_rn (nvcc contracts none of
// them into an FMA), each rounded to X where PyTorch keeps a tensor of x's
// dtype.  No fast-math flag may reach this file.
//
// Design and bound.  grid_snap.cuh's layout: one warp per group, the
// first pass takes the absmax (or the min and the max), the second
// re-reads the group from L1 / L2 and writes y.  Bytes bound it: x [4096,
// 4096] bf16 (fc2's input at VAR-d16's last scale, batch 8) is 32 MB read
// and 32 MB written, 20 us at 3.35 TB/s.
#include "grid_snap.cuh"

namespace {

using grid_snap::kWarps;
using grid_snap::round_x;

template <bool XBF16, bool ASYM>
__global__ void __launch_bounds__(32 * kWarps)
fake_int_kernel(const void* __restrict__ x, void* __restrict__ y,
                int n_groups, int gs, float q_min, float q_max, float inv,
                float eps) {
  using V = grid_snap::XVec<XBF16>;
  const int lane = threadIdx.x % 32;
  const int g = blockIdx.x * kWarps + threadIdx.x / 32;
  if (g >= n_groups) return;
  const size_t base = static_cast<size_t>(g) * gs * V::BYTES;
  const char* src = static_cast<const char*>(x) + base;
  char* dst = static_cast<char*>(y) + base;
  // ASYM: the min and the max; else the absmax (in hi)
  const float inf = __int_as_float(0x7f800000);
  float lo = inf, hi = ASYM ? -inf : 0.f;
  for (int c = lane * V::N; c < gs; c += 32 * V::N) {
    float v[V::N];
    V::load(src + c * V::BYTES, v);
#pragma unroll
    for (int j = 0; j < V::N; ++j) {
      if constexpr (ASYM) {
        lo = grid_snap::nan_min(v[j], lo);
        hi = grid_snap::nan_max(v[j], hi);
      } else {
        hi = grid_snap::nan_max(fabsf(v[j]), hi);
      }
    }
  }
  hi = grid_snap::warp_nan_max(hi);
  float range = hi;
  if constexpr (ASYM) {
    lo = grid_snap::warp_nan_min(lo);
    range = round_x<XBF16>(__fsub_rn(hi, lo));
  }
  // clamp_min(eps): NaN stays NaN
  const float clamped = round_x<XBF16>(range != range ? range
                                                       : fmaxf(range, eps));
  const float s = round_x<XBF16>(__fmul_rn(clamped, inv));
  float zp = 0.f;
  if constexpr (ASYM) {
    zp = rintf(round_x<XBF16>(
        __fsub_rn(q_min, round_x<XBF16>(__fdiv_rn(lo, s)))));
  }
  for (int c = lane * V::N; c < gs; c += 32 * V::N) {
    float v[V::N];
    V::load(src + c * V::BYTES, v);
#pragma unroll
    for (int j = 0; j < V::N; ++j) {
      float q = rintf(round_x<XBF16>(__fdiv_rn(v[j], s)));
      if constexpr (ASYM) {
        q = grid_snap::clamp_nan(round_x<XBF16>(__fadd_rn(q, zp)), q_min,
                                 q_max);
        v[j] = __fmul_rn(round_x<XBF16>(__fsub_rn(q, zp)), s);
      } else {
        v[j] = __fmul_rn(grid_snap::clamp_nan(q, q_min, q_max), s);
      }
    }
    V::store(dst + c * V::BYTES, v);
  }
}

template <bool XBF16, bool ASYM>
cudaError_t launch(const void* x, void* y, int n_groups, int gs, float q_min,
                   float q_max, float inv, float eps, cudaStream_t stream) {
  const int blocks = (n_groups + kWarps - 1) / kWarps;
  fake_int_kernel<XBF16, ASYM><<<blocks, 32 * kWarps, 0, stream>>>(
      x, y, n_groups, gs, q_min, q_max, inv, eps);
  return cudaGetLastError();
}

}  // namespace

// Launch Q3 on `stream`; returns the launch's cudaError_t (0 = success).
// x and y [n_groups * gs] (bf16 where x_bf16, else f32) must be 16-byte
// aligned with gs * element bytes a multiple of 16.  asym = 0: the
// symmetric quantizer (inv = f32(1 / q_max)); 1: the asymmetric one (inv
// = f32(1 / (q_max - q_min))).  eps is the scale's floor.
extern "C" int fake_quant_int(const void* x, void* y, int n_groups, int gs,
                              int x_bf16, int asym, float q_min, float q_max,
                              float inv, float eps, void* stream) {
  const int vec = x_bf16 ? 8 : 4;
  if (n_groups <= 0 || gs <= 0 || gs % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_bf16) {
    e = asym ? launch<true, true>(x, y, n_groups, gs, q_min, q_max, inv, eps,
                                  s)
             : launch<true, false>(x, y, n_groups, gs, q_min, q_max, inv,
                                   eps, s);
  } else {
    e = asym ? launch<false, true>(x, y, n_groups, gs, q_min, q_max, inv,
                                   eps, s)
             : launch<false, false>(x, y, n_groups, gs, q_min, q_max, inv,
                                    eps, s);
  }
  return static_cast<int>(e);
}

extern "C" const char* fake_quant_int_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
