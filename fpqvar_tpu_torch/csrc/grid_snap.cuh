// The pieces that the port's quantize kernels share: K4's phase (a)
// (fused_ch_gemm.cu) and the activation / KV-cache quantizers Q1
// (fake_quant_grid.cu), Q2 (grid_codes.cu) and Q3 (fake_quant_int.cu).
//
// - Table: a sorted value grid of at most CAP values as its midpoints
//   (in grid units) and one output per position, the grid value (Q1) or
//   an integer code (Q2, K4), with f32(1 / max|grid|) and the code
//   multiplier.  The host builds it once per format (ops/quant_kernels.py
//   grid_table) and the kernel's arguments carry it; the midpoints past
//   the grid's are NaN.
// - XVec: 16 bytes of a row as floats, 8 bf16 or 4 f32 values (exact),
//   loaded at once or held raw (uint4) and unpacked later, and the store
//   back, each value rounded to nearest even.
// - snap_pos: the count of midpoints <= q, the position of q's nearest
//   grid value under the compare-sum's rule (x == mid counts as >=, so
//   a midpoint snaps to the larger value; NaN compares false everywhere
//   and stays at position 0, as the compare-sum leaves it at grid[0]).
//   The midpoints are sorted, so the count is a prefix, found by binary
//   lifting from the step CAP / 2.  snap is the same count without the
//   bound check: q >= NaN is false, so the NaN midpoints past the grid's
//   are never counted.
// - nan_max, max_nan: the reduction of torch.amax, which propagates NaN
//   (fmaxf drops it, and would give a group with a NaN another scale than
//   the plain version's); a NaN-propagating min is the max of -v.
// - round_x: a float rounded to the input's dtype (bf16: to nearest even;
//   f32: itself), where the plain version keeps a value in x's dtype.
// - Layout, Slot, load_vecs, seg_nan_max: how Q1, Q2 and Q3 lay a group
//   over threads.  Only K4's phase (a) takes one warp a row (kWarps a
//   block) and reads it twice.
//
// The quantizers' layout.  A group of gs values is L = gs * bytes / 16
// vectors of 16 bytes, spread over a segment of threads:
//   L <= 32:   the power of two >= L lanes of a warp, one vector a lane,
//              so a warp holds 32 / seg groups (4 KV rows of 64 bf16, 2
//              groups of 128 bf16, 1 of 128 f32); lanes past L idle;
//   L <= 128:  one warp, up to kVecs = 4 vectors a lane (a row of 1,024
//              bf16), kBlock / 32 groups a block;
//   longer:    a block of 32 * ceil(L / 128) threads, at most kMaxBlock,
//              kVecs vectors a thread (4,096 bf16: 128 threads; 9,216:
//              288), the absmax crossing its warps in shared memory;
//   Q3 with few groups: past 32 vectors, one vector a thread (a row of
//              1,024 bf16 over 128 threads, 4,096 over 512), where kVecs
//              would launch too few threads to fill the card.
// Lane i of a segment holds vectors i, i + seg, ..., so each load of a
// warp is contiguous.  A thread loads its vectors into registers once
// (raw, 16-byte loads; zeros where a lane has no vector), the segment
// takes the absmax (Q3: or the min and the max, which leave the zeros
// out) by xor shuffles, and the same registers are quantized and stored.
// Rows longer than kMaxBlock * kVecs vectors (32,768 bf16 or 16,384 f32;
// none on the main path) are walked in chunks of that many vectors and
// read twice: a block has no more threads, and more vectors a thread
// would cost every shorter row registers.  The groups past n_groups in
// the last block load nothing and store nothing, but shuffle with their
// warp.
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
#include <limits>

namespace grid_snap {

// Rows a block handles in K4's phase (a): one warp each.
constexpr int kWarps = 8;
// Q1-Q3: threads a block where a group takes a warp or less; vectors
// of 16 bytes a thread holds where a group takes more than 32; the
// largest block (one group longer than 128 vectors).
constexpr int kBlock = 256;
constexpr int kVecs = 4;
constexpr int kMaxBlock = 1024;

template <int CAP, typename OutT>
struct Table {
  float mid[CAP];    // sorted midpoints in grid units, then NaN
  OutT out[CAP];     // per position: the grid value or the integer code
  int n_mids;
  float inv;         // f32(1 / max|grid|)
  float mult;        // code multiplier (a power of two; 1 for Q1)
};

// The table's midpoints and outputs from host arrays (n_mids and n_mids + 1
// entries); the midpoints past n_mids are NaN.
template <int CAP, typename OutT, typename SrcT>
Table<CAP, OutT> make_table(const float* mids, const SrcT* outs, int n_mids,
                            float inv, float mult) {
  Table<CAP, OutT> t = {};
  for (int i = 0; i < CAP; ++i)
    t.mid[i] = i < n_mids ? mids[i] : std::numeric_limits<float>::quiet_NaN();
  for (int i = 0; i <= n_mids; ++i) t.out[i] = static_cast<OutT>(outs[i]);
  t.n_mids = n_mids;
  t.inv = inv;
  t.mult = mult;
  return t;
}

// The smallest table of 8, 16, 64 or 256 entries that holds n_mids + 1
// values (0 if none does).
inline int table_cap(int n_mids) {
  return n_mids < 8    ? 8
         : n_mids < 16 ? 16
         : n_mids < 64 ? 64
         : n_mids < 256 ? 256
         : 0;
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
  __device__ __forceinline__ static void unpack(const uint4& raw,
                                                float (&v)[8]) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void load(const void* p, float (&v)[8]) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
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
  __device__ __forceinline__ static void unpack(const uint4& raw,
                                                float (&v)[4]) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  }
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

// snap_pos over a staged table whose midpoints past the grid's are NaN
// (make_table): no q counts them, so no bound check is needed.
template <int FIRST>
__device__ __forceinline__ int snap(float q, const float* mid) {
  int pos = 0;
#pragma unroll
  for (int step = FIRST; step > 0; step >>= 1) {
    if (q >= mid[pos + step - 1]) pos += step;
  }
  return pos;
}

// max that returns NaN where either side is NaN (torch.amax).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// nan_max in one instruction (PTX max.NaN, sm_80 and later): the NaN it
// returns may carry other bits than nan_max's, which no output shows (an
// absmax that is NaN selects Q1's and Q2's scale 1, and Q3's NaN reaches
// its output only through arithmetic, whose NaN the card makes
// canonical).
__device__ __forceinline__ float max_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return nan_max(a, b);
#endif
}
// min.NaN likewise: NaN where either side is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return -nan_max(-a, -b);
#endif
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

// ---------------------------------------------------------------------------
// The quantizers' layout (see the head of this file)
// ---------------------------------------------------------------------------

// The launch of groups of `vecs` 16-byte vectors: threads a group (seg: a
// power of two up to 32, or a whole block of whole warps), threads a
// block, groups a block, and vectors a thread holds (1, or `per_thread`
// where a group is longer than a warp: kVecs, or 1 to spread a group
// over as many threads as it has vectors, up to kMaxBlock).
struct Layout {
  int vecs;
  int seg;
  int block;
  int groups;
  int maxv;
};

inline Layout layout(int vecs, int per_thread = kVecs) {
  Layout l;
  l.vecs = vecs;
  if (vecs <= 32) {
    l.seg = 1;
    while (l.seg < vecs) l.seg *= 2;
    l.block = kBlock;
    l.maxv = 1;
  } else if (vecs <= 32 * per_thread) {
    l.seg = 32;
    l.block = kBlock;
    l.maxv = per_thread;
  } else {
    const int warps = (vecs + 32 * per_thread - 1) / (32 * per_thread);
    l.seg = 32 * (warps < kMaxBlock / 32 ? warps : kMaxBlock / 32);
    l.block = l.seg;
    l.maxv = per_thread;
  }
  l.groups = l.block / l.seg;
  return l;
}

// Blocks for n_groups groups.
inline unsigned layout_blocks(const Layout& l, int n_groups) {
  return static_cast<unsigned>(
      (static_cast<long long>(n_groups) + l.groups - 1) / l.groups);
}

// A thread's place: its lane in its group's segment of seg threads, the
// group, and whether the group exists (the tail of the last block holds
// none).  A segment is a power of two up to 32 or the whole block
// (layout), so no integer division is needed.
struct Slot {
  int lane;
  long long group;
  bool live;
  __device__ __forceinline__ Slot(int seg, int n_groups) {
    if (seg > 32) {
      lane = threadIdx.x;
      group = blockIdx.x;
    } else {
      lane = threadIdx.x & (seg - 1);
      group = (static_cast<long long>(blockIdx.x) * blockDim.x +
               threadIdx.x) >> (__ffs(seg) - 1);
    }
    live = group < n_groups;
  }
};

// The vectors c0 + lane + k * seg (k < MAXV) of the group at src that lie
// below vecs, raw; zeros elsewhere (|+0| adds nothing to an absmax).
template <int MAXV>
__device__ __forceinline__ void load_vecs(uint4 (&raw)[MAXV],
                                          const char* src, const Slot& at,
                                          int seg, int vecs, int c0) {
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const int i = c0 + at.lane + k * seg;
    raw[k] = make_uint4(0u, 0u, 0u, 0u);
    if (at.live && i < vecs)
      raw[k] = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(i) * 16));
  }
}

// The NaN-propagating max of each v[i] over a segment of seg threads:
// xor shuffles within the segment's lanes (the steps below seg: seg <=
// 32 is a power of two, segments aligned in the warp), then, where the
// segment is the whole block (seg > 32), across its warps: each lane
// reads one warp's result from red (lanes past the warps read warp 0's,
// which a max takes twice at no cost) and the warp shuffles them.  Every
// thread of the block calls it, once.  The NaN it returns is max_nan's.
template <int NV>
__device__ __forceinline__ void seg_nan_max(float (&v)[NV], int seg,
                                            float (*red)[NV]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o < seg) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
        v[i] = max_nan(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
    }
  }
  if (seg > 32) {
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) red[threadIdx.x / 32][i] = v[i];
    }
    __syncthreads();
    const int w = lane < static_cast<int>(blockDim.x) / 32 ? lane : 0;
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = red[w][i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
        v[i] = max_nan(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
    }
  }
}

}  // namespace grid_snap
