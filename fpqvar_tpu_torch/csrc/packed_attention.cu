// Attention over the packed KV cache's value codes, in one kernel (A1).
//
// What it computes, for each (row b, head h) and this step's l queries over
// the cached tokens [0, end): the value-code branch of ``models/var.py``
// ``_packed_attention`` (plain version: ``ops/packed_attention.py``
// ``packed_attention_ref``), in the same types:
//
//   s   = (q . kc) * ks          q [B, l, H, 64] bf16 or f32, kc int8
//                                [B, H, L, 64], ks f32 [B, H, L]
//   p   = softmax(s) over the cached tokens, in f32
//   out = sum_m round_q(p_m * vs_m) * vc_m, f32 sums, rounded to q's dtype
//
// written once as [B, l, H * 64], the layout the projection reads.  The
// weights round where the chain rounds them, after the division by the row
// sum: a kernel that rounded exp(s - m) * vs before the division (one pass,
// FlashAttention's running rescale) moved half of VAR-d36-512's attention
// outputs by a bf16 step, which the next linear's 4-bit activation codes
// turned into three times the benchmark's block_err (0.072-0.074 against
// 0.024-0.027, limit 0.08; PERF.md).
//
// It replaces no TPU kernel: the JAX package leaves this chain to XLA (an
// einsum, the softmax and an einsum).  As plain PyTorch on this card the
// chain writes the f32 scores [B, H, l, M] and reads them back about nine
// times (the scale fold, the softmax, the fold of vs, the cast): at
// VAR-d36-512's last scale 4.9 GB a block, about six times the time of
// this kernel.  Here the scores never leave registers.
//
// What bounds it.  At the last scales (l = 576 and 1,024 queries over M =
// 1,216 and 2,240 cached tokens) a (row, head) takes 384 tensor-core
// operations a score (q k^T twice, p v once) against two exponentials, a
// division and about twenty other instructions a score (the scale, the max,
// the sum, the fold of vs, the rounding): the FP32 pipe and the tensor
// cores bound it, not the bytes (the codes, 130 bytes a cached token, are
// read twice per query tile, from L2 after the first).  At the first
// scales (l = 1 to 16 over a few tokens) one block a (row, head) does
// almost nothing: launch latency and the first loads bound it.
//
// Design.  Two passes over the cached tokens on mma.sync m16n8k16 (bf16
// in, f32 accumulate): pass 0 computes s and each row's running max and
// sum of exp(s - max); pass 1 computes s again and the weights exp(s -
// max) / sum * vs, rounds them and accumulates p v.  mma.sync and not
// wgmma: at head_dim 64 a warp's 16 x 64 score tile sits in its own
// registers from the product through the softmax into the next product,
// where wgmma's 64-row warpgroup tiles would ask for a producer / consumer
// split that the exponentials, and not the products, would wait on.
// - One block a (b, h, tile of 16 * warps query rows), warps = ceil(l / 16)
//   up to 8, chosen by the wrapper from l: the first scales take one warp
//   of 16 rows (not a 64-row tile a query), the last scales 8 warps of 128
//   rows, so that a tile of codes read from L2 feeds 128 queries.
// - Cached tokens in tiles of 64: the int8 codes and f32 scales (pass 0
//   the keys only) arrive by cp.async in a ring of two stages, two tiles
//   ahead of the one computed (rows at or past ``end`` read as zeros).  The
//   block converts a tile's codes to bf16 once (exact: |code| <= 127), into
//   a tile whose 16-byte chunks are swizzled so that ldmatrix reads it
//   without bank conflicts.
// - q's fragments stay in registers through both passes; the scale ks, the
//   max, the sum and the weights in f32 (expf: full f32 accuracy, an IEEE
//   division), the weights rounded to bf16 in registers as the A operand
//   of p v^T.
// - f32 q (the float32 compute dtype: calibration, CPU-exact tests): q and
//   the weights split into three bf16 parts each, whose sum is the f32
//   value exactly, and three MMAs a product, each started from zero and
//   added in IEEE f32 (mma_fadd): the tensor cores truncate an MMA's terms
//   against its largest, the accumulator included, so a chained sum would
//   lose the low parts' bits against the high parts' total (the bound
//   this keeps: ops/packed_attention.py ``tolerance``).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;            // head_dim
constexpr int kBn = 64;            // cached tokens a tile
constexpr int kMaxWarps = 8;       // 16 query rows a warp
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kCodeChunks = kBn * kHd / 16;   // 16-byte chunks of a code tile
constexpr unsigned kFull = 0xffffffffu;

// One stage of the ring: a tile as the cache holds it.
struct __align__(16) RawTile {
  int8_t k[kBn * kHd];
  int8_t v[kBn * kHd];
  float ks[kBn];
  float vs[kBn];
};

// The tile the MMAs read: the codes as bf16 bits, row r's 16-byte chunk c
// at chunk c ^ (r & 7).
struct __align__(16) MmaTile {
  uint16_t k[kBn * kHd];
  uint16_t v[kBn * kHd];
  float ks[kBn];
  float vs[kBn];
};

struct Smem {
  RawTile raw[2];
  MmaTile t;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 16 (or 4) bytes to shared memory, or zeros where !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one group of copies is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: the MMA started from zero, its sum added to d in IEEE f32.
__device__ __forceinline__ void mma_fadd(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = __fadd_rn(d[e], t[e]);
}

// (lo, hi) rounded to bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// (x0, x1) as three bf16 pairs whose sum is (x0, x1) exactly: each part
// takes the nearest bf16 of what the parts before it left.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& p0,
                                       uint32_t& p1, uint32_t& p2) {
  p0 = pack_bf16(x0, x1);
  const float r0 = x0 - bf16_lo(p0), r1 = x1 - bf16_hi(p0);
  p1 = pack_bf16(r0, r1);
  p2 = pack_bf16(r0 - bf16_lo(p1), r1 - bf16_hi(p1));
}

// Four int8 codes as four bf16 (exact): each byte c + 128 under the
// exponent of 2^23 is the float 2^23 + c + 128.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  // byte `sel & 3` of u under the exponent byte 0x4B, less 2^23 + 128
  const auto code = [u](uint32_t sel) {
    return __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.0f;
  };
  lo = pack_bf16(code(0x7540), code(0x7541));
  hi = pack_bf16(code(0x7542), code(0x7543));
}

// Element offset of (row r, 8-value chunk c) in a swizzled tile.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kHd + ((c ^ (r & 7)) << 3);
}

template <bool kF32>
__global__ void __launch_bounds__(kMaxThreads, kF32 ? 1 : 2)
packed_attention_kernel(const void* __restrict__ q_ptr, long long sqb,
                        long long sql, long long sqh,
                        const int8_t* __restrict__ kc,
                        const int8_t* __restrict__ vc, long long scb,
                        long long sch, const float* __restrict__ ks,
                        const float* __restrict__ vs, long long ssb,
                        long long ssh, void* __restrict__ out_ptr, int l,
                        int end, int heads) {
  constexpr int kParts = kF32 ? 3 : 1;
  __shared__ __align__(16) unsigned char smem_bytes[sizeof(Smem)];
  Smem& sm = *reinterpret_cast<Smem*>(smem_bytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int g = lane >> 2, t4 = lane & 3;       // mma fragment row, column pair
  const int mi = lane >> 3, rr = lane & 7;      // ldmatrix matrix, row
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * (nthreads / 2) + warp * 16;
  const bool active = row0 < l;                 // warp-uniform
  const int8_t* kb = kc + b * scb + h * sch;
  const int8_t* vb = vc + b * scb + h * sch;
  const float* ksb = ks + b * ssb + h * ssh;
  const float* vsb = vs + b * ssb + h * ssh;
  const int n_tiles = (end + kBn - 1) / kBn;

  // the ring's tiles in order: pass 0 reads tiles 0 .. n - 1 of the keys
  // (codes and scales), pass 1 the same tiles of keys and values
  const int n_steps = 2 * n_tiles;
  auto load_tile = [&](int step, RawTile& dst) {
    const bool with_v = step >= n_tiles;
    const int key0 = (with_v ? step - n_tiles : step) * kBn;
    for (int i = tid; i < (with_v ? 2 : 1) * kCodeChunks; i += nthreads) {
      const bool is_v = i >= kCodeChunks;
      const int r = (i % kCodeChunks) >> 2, c = i & 3;
      const bool ok = key0 + r < end;
      const int8_t* src = (is_v ? vb : kb)
                          + (ok ? (long long)(key0 + r) * kHd + c * 16 : 0);
      cp_async16((is_v ? dst.v : dst.k) + r * kHd + c * 16, src, ok);
    }
    for (int i = tid; i < (with_v ? 2 : 1) * kBn; i += nthreads) {
      const bool is_v = i >= kBn;
      const int r = i % kBn;
      const bool ok = key0 + r < end;
      cp_async4((is_v ? dst.vs : dst.ks) + r,
                (is_v ? vsb : ksb) + (ok ? key0 + r : 0), ok);
    }
  };

  // q's A fragments for the four 16-wide chunks of head_dim: registers
  // (row g, cols 2t..), (row g + 8, cols 2t..), (row g, cols 8 + 2t..),
  // (row g + 8, cols 8 + 2t..); rows past l are zeros
  uint32_t qa[kParts][4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int row = row0 + g + ((reg & 1) ? 8 : 0);
      const int d = kk * 16 + ((reg & 2) ? 8 : 0) + 2 * t4;
      const long long off = b * sqb + (long long)row * sql + h * sqh + d;
      if constexpr (kF32) {
        float2 x = make_float2(0.f, 0.f);
        if (row < l) x = *reinterpret_cast<const float2*>(
            static_cast<const float*>(q_ptr) + off);
        uint32_t parts[3];
        split3(x.x, x.y, parts[0], parts[1], parts[2]);
#pragma unroll
        for (int pp = 0; pp < kParts; ++pp) qa[pp][kk][reg] = parts[pp];
      } else {
        qa[0][kk][reg] = row < l ? *reinterpret_cast<const uint32_t*>(
            static_cast<const __nv_bfloat16*>(q_ptr) + off) : 0u;
      }
    }
  }

  float o[8][4];                   // [head_dim n-tile][fragment]
#pragma unroll
  for (int nd = 0; nd < 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;       // rows g, g + 8
  float l_a = 0.f, l_b = 0.f;

  load_tile(0, sm.raw[0]);
  cp_async_commit();
  load_tile(1, sm.raw[1]);
  cp_async_commit();

  for (int step = 0; step < n_steps; ++step) {
    const bool second = step >= n_tiles;        // pass 1: the weights
    const int key0 = (second ? step - n_tiles : step) * kBn;
    RawTile& raw = sm.raw[step & 1];
    cp_async_wait_one();
    __syncthreads();      // the tile landed; every warp is done with sm.t
    for (int i = tid; i < (second ? 2 : 1) * kCodeChunks; i += nthreads) {
      const bool is_v = i >= kCodeChunks;
      const int r = (i % kCodeChunks) >> 2, c = i & 3;
      const uint4 w = *reinterpret_cast<const uint4*>(
          (is_v ? raw.v : raw.k) + r * kHd + c * 16);
      uint4 lo, hi;
      i8x4_to_bf16(w.x, lo.x, lo.y);
      i8x4_to_bf16(w.y, lo.z, lo.w);
      i8x4_to_bf16(w.z, hi.x, hi.y);
      i8x4_to_bf16(w.w, hi.z, hi.w);
      uint16_t* dst = is_v ? sm.t.v : sm.t.k;
      *reinterpret_cast<uint4*>(dst + swz(r, 2 * c)) = lo;
      *reinterpret_cast<uint4*>(dst + swz(r, 2 * c + 1)) = hi;
    }
    for (int i = tid; i < (second ? 2 : 1) * kBn; i += nthreads) {
      if (i < kBn) sm.t.ks[i] = raw.ks[i];
      else sm.t.vs[i - kBn] = raw.vs[i - kBn];
    }
    __syncthreads();      // sm.t is whole; raw is free
    if (step + 2 < n_steps) load_tile(step + 2, raw);
    cp_async_commit();
    if (!active) continue;
    if (step == n_tiles) {                      // the rows' sums are whole
      l_a += __shfl_xor_sync(kFull, l_a, 1);
      l_a += __shfl_xor_sync(kFull, l_a, 2);
      l_b += __shfl_xor_sync(kFull, l_b, 1);
      l_b += __shfl_xor_sync(kFull, l_b, 2);
    }

    // s = (q k^T) * ks over this tile's 64 tokens (n-tile nt holds tokens
    // 8 nt .. 8 nt + 7), tokens at or past end masked (the last tile only)
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t bk[4];
        ldsm_x4(bk, sm.t.k + swz(16 * p + (mi >> 1) * 8 + rr,
                                 2 * kk + (mi & 1)));
        if constexpr (kF32) {
#pragma unroll
          for (int pp = 0; pp < kParts; ++pp) {
            mma_fadd(s[2 * p], qa[pp][kk], bk[0], bk[1]);
            mma_fadd(s[2 * p + 1], qa[pp][kk], bk[2], bk[3]);
          }
        } else {
          mma(s[2 * p], qa[0][kk], bk[0], bk[1]);
          mma(s[2 * p + 1], qa[0][kk], bk[2], bk[3]);
        }
      }
    }
    const bool ragged = key0 + kBn > end;       // block-uniform
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 8 * nt + 2 * t4;
      const float2 sc = *reinterpret_cast<const float2*>(sm.t.ks + col);
      // rounded on its own, as the chain's product (no contraction into
      // the exponent's argument)
      s[nt][0] = __fmul_rn(s[nt][0], sc.x);
      s[nt][1] = __fmul_rn(s[nt][1], sc.y);
      s[nt][2] = __fmul_rn(s[nt][2], sc.x);
      s[nt][3] = __fmul_rn(s[nt][3], sc.y);
      if (ragged) {
        if (key0 + col >= end) s[nt][0] = s[nt][2] = -INFINITY;
        if (key0 + col + 1 >= end) s[nt][1] = s[nt][3] = -INFINITY;
      }
    }

    if (!second) {
      // pass 0: the running max and the sum of exp(s - max) of each row
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, 2));
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        sa += expf(s[nt][0] - mx_a) + expf(s[nt][1] - mx_a);
        sb += expf(s[nt][2] - mx_b) + expf(s[nt][3] - mx_b);
      }
      l_a = l_a * expf(m_a - mx_a) + sa;
      l_b = l_b * expf(m_b - mx_b) + sb;
      m_a = mx_a;
      m_b = mx_b;
      continue;
    }

    // pass 1: the softmax weights exp(s - max) / sum, times vs, rounded to
    // q's dtype (three exact bf16 parts at f32) as the A operand of p v^T:
    // [part][nt][row g, row g + 8]
    uint32_t pa[kParts][8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 sv = *reinterpret_cast<const float2*>(
          sm.t.vs + 8 * nt + 2 * t4);
      const float w0 = expf(s[nt][0] - m_a) / l_a * sv.x;
      const float w1 = expf(s[nt][1] - m_a) / l_a * sv.y;
      const float w2 = expf(s[nt][2] - m_b) / l_b * sv.x;
      const float w3 = expf(s[nt][3] - m_b) / l_b * sv.y;
      if constexpr (kF32) {
        uint32_t ra[3], rb[3];
        split3(w0, w1, ra[0], ra[1], ra[2]);
        split3(w2, w3, rb[0], rb[1], rb[2]);
#pragma unroll
        for (int pp = 0; pp < kParts; ++pp) {
          pa[pp][nt][0] = ra[pp];
          pa[pp][nt][1] = rb[pp];
        }
      } else {
        pa[0][nt][0] = pack_bf16(w0, w1);
        pa[0][nt][1] = pack_bf16(w2, w3);
      }
    }

    // o += p v over the tile's four 16-token chunks
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, sm.t.v + swz(16 * kk + (mi & 1) * 8 + rr,
                                       2 * p + (mi >> 1)));
#pragma unroll
        for (int pp = 0; pp < kParts; ++pp) {
          const uint32_t a[4] = {pa[pp][2 * kk][0], pa[pp][2 * kk][1],
                                 pa[pp][2 * kk + 1][0],
                                 pa[pp][2 * kk + 1][1]};
          if constexpr (kF32) {
            mma_fadd(o[2 * p], a, bv[0], bv[1]);
            mma_fadd(o[2 * p + 1], a, bv[2], bv[3]);
          } else {
            mma(o[2 * p], a, bv[0], bv[1]);
            mma(o[2 * p + 1], a, bv[2], bv[3]);
          }
        }
      }
    }
  }
  if (!active) return;

  const long long row_stride = (long long)heads * kHd;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= l) continue;
    const long long base = ((long long)b * l + row) * row_stride + h * kHd
                           + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      const float y0 = o[nd][2 * half], y1 = o[nd][2 * half + 1];
      if constexpr (kF32) {
        *reinterpret_cast<float2*>(static_cast<float*>(out_ptr) + base
                                   + 8 * nd) = make_float2(y0, y1);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out_ptr)
                                     + base + 8 * nd) = pack_bf16(y0, y1);
      }
    }
  }
}

}  // namespace

// Launch A1 on `stream`: q (bf16, or f32 where q_f32) with element strides
// sqb, sql, sqh (head_dim contiguous); kc, vc int8 codes with strides scb,
// sch (rows of 64 contiguous); ks, vs f32 scales with strides ssb, ssh
// (tokens contiguous); out [batch, l, heads * 64] in q's dtype; `end`
// cached tokens; blocks of `warps` warps (16 query rows each).  Returns
// the launch's cudaError_t (0 = success).
extern "C" int packed_attention(const void* q, long long sqb, long long sql,
                                long long sqh, int q_f32, const void* kc,
                                const void* vc, long long scb, long long sch,
                                const void* ks, const void* vs,
                                long long ssb, long long ssh, void* out,
                                int batch, int heads, int l, int end,
                                int warps, void* stream) {
  if (warps < 1 || warps > kMaxWarps || l < 1 || end < 1 || batch < 1
      || heads < 1 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((l + 16 * warps - 1) / (16 * warps), heads, batch);
  const dim3 block(32 * warps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* k8 = static_cast<const int8_t*>(kc);
  const auto* v8 = static_cast<const int8_t*>(vc);
  const auto* kf = static_cast<const float*>(ks);
  const auto* vf = static_cast<const float*>(vs);
  if (q_f32) {
    packed_attention_kernel<true><<<grid, block, 0, s>>>(
        q, sqb, sql, sqh, k8, v8, scb, sch, kf, vf, ssb, ssh, out, l, end,
        heads);
  } else {
    packed_attention_kernel<false><<<grid, block, 0, s>>>(
        q, sqb, sql, sqh, k8, v8, scb, sch, kf, vf, ssb, ssh, out, l, end,
        heads);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* packed_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
