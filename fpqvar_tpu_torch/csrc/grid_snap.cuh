// The pieces that the port's quantize kernels share: K4's phase (a)
// (fused_ch_gemm.cu) and the activation / KV-cache quantizers Q1
// (fake_quant_grid.cu), Q2 (grid_codes.cu) and Q3 (fake_quant_int.cu).
//
// - Table: a sorted value grid of at most CAP values as its midpoints
//   (in grid units) and one output per position, the grid value (Q1) or
//   an integer code (Q2, K4), with f32(1 / max|grid|) and the code
//   multiplier.  The host builds it once per format (ops/quant_kernels.py
//   grid_table) and the kernel's arguments carry it.
// - XVec: 16 bytes of a row as floats, 8 bf16 or 4 f32 values (exact),
//   and the store back, each value rounded to nearest even.
// - snap_pos: the count of midpoints <= q, the position of q's nearest
//   grid value under the compare-sum's rule (x == mid counts as >=, so
//   a midpoint snaps to the larger value; NaN compares false everywhere
//   and stays at position 0, as the compare-sum leaves it at grid[0]).
//   The midpoints are sorted, so the count is a prefix, found by binary
//   lifting from the step CAP / 2.
// - nan_max / nan_min: the reductions of torch.amax / amin, which
//   propagate NaN (fmaxf drops it, and would give a group with a NaN
//   another scale than the plain version's).
// - round_x: a float rounded to the input's dtype (bf16: to nearest even;
//   f32: itself), where the plain version keeps a value in x's dtype.
//
// Exactness.  The sources that include this header must be built without
// --use_fast_math, -ftz=true, -prec-div=false or -fmad=true reaching the
// quantizer arithmetic: every division is __fdiv_rn and every product or
// sum that PyTorch rounds on its own is __fmul_rn / __fadd_rn /
// __fsub_rn, so that nvcc cannot contract it into an FMA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace grid_snap {

// Rows or groups a block handles: one warp each.
constexpr int kWarps = 8;

template <int CAP, typename OutT>
struct Table {
  float mid[CAP];    // sorted midpoints in grid units (n_mids of them)
  OutT out[CAP];     // per position: the grid value or the integer code
  int n_mids;
  float inv;         // f32(1 / max|grid|)
  float mult;        // code multiplier (a power of two; 1 for Q1)
};

// The table's midpoints and outputs from host arrays (n_mids and n_mids + 1
// entries).
template <int CAP, typename OutT, typename SrcT>
Table<CAP, OutT> make_table(const float* mids, const SrcT* outs, int n_mids,
                            float inv, float mult) {
  Table<CAP, OutT> t = {};
  for (int i = 0; i < n_mids; ++i) t.mid[i] = mids[i];
  for (int i = 0; i <= n_mids; ++i) t.out[i] = static_cast<OutT>(outs[i]);
  t.n_mids = n_mids;
  t.inv = inv;
  t.mult = mult;
  return t;
}

// The smallest table of 16, 64 or 256 entries that holds n_mids + 1
// values (0 if none does).
inline int table_cap(int n_mids) {
  return n_mids < 16 ? 16 : n_mids < 64 ? 64 : n_mids < 256 ? 256 : 0;
}

// A table's midpoints and outputs copied to shared memory by the block.
template <int CAP, typename OutT>
__device__ __forceinline__ void stage(const Table<CAP, OutT>& t, float* mid,
                                      OutT* out) {
  for (int i = threadIdx.x; i < CAP; i += blockDim.x) {
    mid[i] = t.mid[i];
    out[i] = t.out[i];
  }
}

// 16 bytes of a row of x as floats: 8 bf16 or 4 f32 values (exact), and
// back (rounded to nearest even for bf16).
template <bool XBF16>
struct XVec;

template <>
struct XVec<true> {
  static constexpr int N = 8;
  static constexpr int BYTES = 2;
  __device__ __forceinline__ static void load(const void* p, float (&v)[8]) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void store(void* p, const float (&v)[8]) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j]));
      const unsigned hi =
          __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1]));
      w[j] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct XVec<false> {
  static constexpr int N = 4;
  static constexpr int BYTES = 4;
  __device__ __forceinline__ static void load(const void* p, float (&v)[4]) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
  __device__ __forceinline__ static void store(void* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// N int8 codes (8 or 4) as one 8- or 4-byte store.
template <int N>
__device__ __forceinline__ void store_codes(int8_t* dst, const int (&q)[N]) {
  unsigned packed[(N + 3) / 4] = {};
#pragma unroll
  for (int j = 0; j < N; ++j)
    packed[j / 4] |= (static_cast<unsigned>(q[j]) & 0xffu) << (8 * (j % 4));
  if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
  } else {
    *reinterpret_cast<unsigned*>(dst) = packed[0];
  }
}

// The count of midpoints <= q (a prefix of the sorted midpoints) by binary
// lifting from the step FIRST over at most 2 * FIRST - 1 entries.
template <int FIRST>
__device__ __forceinline__ int snap_pos(float q, const float* mid,
                                        int n_mids) {
  int pos = 0;
#pragma unroll
  for (int step = FIRST; step > 0; step >>= 1) {
    if (pos + step <= n_mids && q >= mid[pos + step - 1]) pos += step;
  }
  return pos;
}

// The output of q's position: code[snap_pos(q)].
template <int FIRST, typename OutT>
__device__ __forceinline__ OutT encode(float q, const float* mid, int n_mids,
                                       const OutT* code) {
  return code[snap_pos<FIRST>(q, mid, n_mids)];
}

// max / min that return NaN where either side is NaN (torch.amax / amin).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float warp_nan_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_nan_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// v rounded to x's dtype.
template <bool XBF16>
__device__ __forceinline__ float round_x(float v) {
  if constexpr (XBF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// torch.clamp's rule in float: NaN stays NaN, else min(max(v, lo), hi).
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// torch.where(absmax > 0, absmax * inv, 1) with the product rounded to
// x's dtype where ROUND (a NaN absmax gives 1).
template <bool XBF16, bool ROUND>
__device__ __forceinline__ float safe_scale(float absmax, float inv) {
  if (!(absmax > 0.f)) return 1.f;
  const float s = __fmul_rn(absmax, inv);
  return ROUND ? round_x<XBF16>(s) : s;
}

}  // namespace grid_snap
