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
// Design and bound.  Bytes bound it: x [4096, 4096] bf16 (fc2's input at
// VAR-d16's last scale, batch 8) is 32 MB read and 32 MB written, 20 us at
// 3.35 TB/s ([4096, 1024]: 5.0 us).  Q1's layout (grid_snap.cuh): a group
// spans as many lanes as it has 16-byte vectors (2 groups of 128 bf16 a
// warp, 2 KV rows of 64 f32, a row of 1,024 bf16 over a warp, 4,096 over
// 128 threads), is read once into registers, reduced by shuffles and
// quantized and stored from the same registers.  The asymmetric min and
// max are one reduction: seg_nan_max over the pair (-v, v), whose -min is
// the max of -v, so both ride the same xor steps.  Every lane starts the
// pair at (-inf, -inf), the identities of a min and a max, and adds only
// the vectors that lie in its group: an idle lane, past the group's
// vectors in a power-of-two segment or a block's last warp, leaves them
// there, where a +0 would raise the max of an all-negative group or lower
// the min of an all-positive one.  The symmetric absmax starts at +0, its
// identity.  Each value then takes one IEEE division, roundings, rint,
// the clamp and a product: ~22-30 SASS instructions, so at the last scale
// issue and bytes are of one size (PERF.md section 6).  The first scales
// of a generation have 16 to 1,024 rows: at 4 vectors a thread a launch
// would fill a few SMs with warps that each run 32 values' division
// chains in turn, so where it would have fewer than kSpreadThreads
// threads a group longer than a warp takes one vector a thread instead
// (a block of up to 1,024 threads a group).
#include "grid_snap.cuh"

namespace {

using grid_snap::kMaxBlock;
using grid_snap::kVecs;
using grid_snap::round_x;
using grid_snap::Slot;

// Groups that at kVecs vectors a thread would give a launch fewer threads
// than this (half of what the card's 132 SMs hold at once) spread over
// one vector a thread instead: each thread's serial share of the
// division chains falls fourfold where no other work would hide it.  At
// VAR-d16's shapes on an H100 this takes each shape's faster layout
// (chip_smoke.py --quant-ab against both; PERF.md section 6).
constexpr long long kSpreadThreads = 132LL * 1024;

// torch.clamp's rule (NaN stays NaN) in two instructions: min.NaN and
// max.NaN return the card's canonical NaN, which the product with s that
// follows every clamp would return all the same.
__device__ __forceinline__ float clamp_code(float v, float lo, float hi) {
  return grid_snap::min_nan(grid_snap::max_nan(v, lo), hi);
}

template <bool XBF16, bool ASYM, int MAXV>
__global__ void __launch_bounds__(kMaxBlock)
fake_int_kernel(const void* __restrict__ x, void* __restrict__ y,
                int n_groups, int vecs, int seg, float q_min, float q_max,
                float inv, float eps) {
  using V = grid_snap::XVec<XBF16>;
  constexpr int NM = ASYM ? 2 : 1;
  __shared__ float red[kMaxBlock / 32][NM];
  const Slot at(seg, n_groups);
  const size_t base = static_cast<size_t>(at.group) * vecs * 16;
  const char* src = static_cast<const char*>(x) + base;
  char* dst = static_cast<char*>(y) + base;
  const int chunk = seg * MAXV;
  uint4 raw[MAXV];
  // ASYM: m = (max -v, max v), so that the min is -m[0]; else the absmax
  const float inf = __int_as_float(0x7f800000);
  float m[NM];
  m[0] = ASYM ? -inf : 0.f;
  if constexpr (ASYM) m[1] = -inf;
  for (int c0 = 0; c0 < vecs; c0 += chunk) {
    grid_snap::load_vecs(raw, src, at, seg, vecs, c0);
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      // load_vecs' zeros stand for the vectors past the group: the
      // absmax's identity, but not the min's or the max's
      if (ASYM && !(at.live && c0 + at.lane + k * seg < vecs)) continue;
      float v[V::N];
      V::unpack(raw[k], v);
#pragma unroll
      for (int j = 0; j < V::N; ++j) {
        if constexpr (ASYM) {
          m[0] = grid_snap::max_nan(-v[j], m[0]);
          m[1] = grid_snap::max_nan(v[j], m[1]);
        } else {
          m[0] = grid_snap::max_nan(fabsf(v[j]), m[0]);
        }
      }
    }
  }
  grid_snap::seg_nan_max(m, seg, red);
  const float lo = -m[0];  // ASYM: the min
  const float range =
      ASYM ? round_x<XBF16>(__fsub_rn(m[NM - 1], lo)) : m[0];
  // clamp_min(eps): NaN stays NaN
  const float clamped = round_x<XBF16>(range != range ? range
                                                       : fmaxf(range, eps));
  const float s = round_x<XBF16>(__fmul_rn(clamped, inv));
  float zp = 0.f;
  if constexpr (ASYM) {
    zp = rintf(round_x<XBF16>(
        __fsub_rn(q_min, round_x<XBF16>(__fdiv_rn(lo, s)))));
  }
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
        float q = rintf(round_x<XBF16>(__fdiv_rn(v[j], s)));
        if constexpr (ASYM) {
          q = clamp_code(round_x<XBF16>(__fadd_rn(q, zp)), q_min, q_max);
          v[j] = __fmul_rn(round_x<XBF16>(__fsub_rn(q, zp)), s);
        } else {
          v[j] = __fmul_rn(clamp_code(q, q_min, q_max), s);
        }
      }
      V::store(dst + static_cast<size_t>(i) * 16, v);
    }
  }
}

template <bool XBF16, bool ASYM, int MAXV>
cudaError_t launch(const void* x, void* y, int n_groups,
                   const grid_snap::Layout& l, float q_min, float q_max,
                   float inv, float eps, cudaStream_t stream) {
  fake_int_kernel<XBF16, ASYM, MAXV>
      <<<grid_snap::layout_blocks(l, n_groups), l.block, 0, stream>>>(
          x, y, n_groups, l.vecs, l.seg, q_min, q_max, inv, eps);
  return cudaGetLastError();
}

template <bool XBF16, bool ASYM>
cudaError_t dispatch(const void* x, void* y, int n_groups, int gs,
                     float q_min, float q_max, float inv, float eps,
                     cudaStream_t s) {
  const int vecs = gs / grid_snap::XVec<XBF16>::N;
  auto l = grid_snap::layout(vecs);
  if (l.maxv > 1 && vecs <= kMaxBlock &&
      static_cast<long long>(grid_snap::layout_blocks(l, n_groups)) *
              l.block < kSpreadThreads)
    l = grid_snap::layout(vecs, 1);
  if (l.maxv == 1)
    return launch<XBF16, ASYM, 1>(x, y, n_groups, l, q_min, q_max, inv, eps,
                                  s);
  return launch<XBF16, ASYM, kVecs>(x, y, n_groups, l, q_min, q_max, inv,
                                    eps, s);
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
    e = asym ? dispatch<true, true>(x, y, n_groups, gs, q_min, q_max, inv,
                                    eps, s)
             : dispatch<true, false>(x, y, n_groups, gs, q_min, q_max, inv,
                                     eps, s);
  } else {
    e = asym ? dispatch<false, true>(x, y, n_groups, gs, q_min, q_max, inv,
                                     eps, s)
             : dispatch<false, false>(x, y, n_groups, gs, q_min, q_max, inv,
                                      eps, s);
  }
  return static_cast<int>(e);
}

extern "C" const char* fake_quant_int_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
