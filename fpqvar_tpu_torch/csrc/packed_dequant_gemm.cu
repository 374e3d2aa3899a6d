// Dequantize-in-register GEMM for Hopper (sm_90a):
//
//   out[m,n] = sum_g  s[g,n] * sum_{k in g} x[m,k] * grid[code[n,k]]
//
// Replaces the TPU kernel fpqvar_tpu/ops/pallas/quant_matmul.py
// (_kernel / _packed_matmul_2d).  Operands: x [M,K] bf16 or f32 row-major;
// codes int8, either e2m1 grid indices two per byte in the row-split layout
// [N/2,K] (within each 128-row tile, byte row r holds row r in its low
// nibble and row 64+r in its high nibble) or one index per byte [N,K]
// (e2m1 or e2m3); s [G,N] f32; out [M,N] f32.  G = K / group, group a
// multiple of 128.
//
// Design (bf16 x, the main path).  wgmma_gemm.cuh's register-A sibling,
// rs_gemm_kernel: only wgmma's A operand may come from registers, so the
// operands are swapped, out^T = W . x^T.  TMA loads each 128-value K chunk of
// x (the K-major B operand, BX = 16, 64 or 128 rows of x a tile, the narrowest
// that holds M where M <= 64) and of the raw code bytes (64 byte rows of a
// 128-row tile of nibbles, or 128 rows of bytes) into a shared ring.  Consumer
// warpgroup c owns weight rows [64c, 64c + 64) of the tile: with nibbles both
// read the same byte rows, c = 0 the low and c = 1 the high nibbles.  Each
// thread decodes its m16n8k16 A fragment (8 codes a 16-value K step) straight
// into bf16 registers and issues wgmma m64nBXk16 bf16 (RS); the next step is
// decoded while this one runs.  The decode is exact bit assembly, no table and
// no select tree: for the code c of a format with zero code Z, i = c - Z, and
// |i| is the magnitude's exponent and mantissa bits, which placed SH bits up
// in a float32 (with the sign of i) give grid[c] * 2^-126 (the e = 0 codes
// land on float32 subnormals, the rest on normals, all exact), so one multiply
// by 2^126 gives grid[c]: a shift or mask, a multiply-add, an absolute value,
// an or and a multiply per code, and one convert per pair.  e2m1 is Z = 7,
// SH = 22 (magnitudes 0, .5, 1, 1.5, 2, 3, 4, 6), e2m3 Z = 31, SH = 20 (0.125 k
// below 1, then 1 + m/8 times 1, 2, 4); all are exact in bf16.  Each scale
// group (128 values, or a multiple) sums into a fresh f32 part that is then
// folded as acc += part * s[g, n], as the TPU kernel applies the scale to each
// group's partial product.  The sum leaves transposed, through a swizzled
// staging area and TMA stores.  Every block decodes its own weight tile once
// for every M tile it runs.
//
// f32 x (not on the main path, whose compute dtype is bf16).  An f32 x has to
// stay exact to within K2_REL_TOL, which one bf16 rounding of x breaks.  It
// runs this file's mma.sync kernel: one 128 x 128 output tile a block,
// mma.sync m16n8k16 bf16 over a decoded weight tile in shared memory, and each
// f32 value split into three bf16 parts, x = hi + mid + lo exactly (each
// residual of a bf16 rounding is exact in f32 and the last one fits in bf16's
// 8 significant bits), each part its own mma.  Every product of a part and a
// grid value is exact, so only the f32 sums differ from the plain version; the
// part is folded into the sum every 128 values of K.  (Three B boxes a code
// box in the wgmma kernel would need three times its x bytes in the ring and
// its registers for a path no recipe runs.)
//
// Ragged M is zero-filled on load and clipped or masked on store.  Nibble
// codes need N % 128 == 0 (the layout requires it); byte codes take any
// N >= 1 (rows past N are zero-filled and masked).
//
// Bound on an H100 SXM.  At the d16 fc1 shape of the last scale
// (M = 4096, K = 1024, N = 4096) the work is 2*M*N*K = 34 GFLOP, 34.7 us at
// the 989 TFLOP/s dense bf16 peak, while it moves 8 MB of x, 2 MB of codes
// and 64 MB of f32 output, 22 us at 3.35 TB/s: the operations bound it.
// PERF.md has its times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_gemm.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 x: the formats of wgmma_gemm::rs_gemm_kernel
// ---------------------------------------------------------------------------

// grid[c] of the code c of a format with zero code Z, its magnitude's
// exponent and mantissa SH bits up in a float32: exact (see above).  Four
// instructions from c: u = (c - Z) << SH as one multiply-add, |u|, the
// sign of u or'ed in, the multiply (abs.s32 keeps ptxas from expanding
// |c - Z| into a compare, an add and a select).
template <int Z, int SH>
__device__ __forceinline__ float decode_bits(uint32_t c) {
  const int u = static_cast<int>(c << SH) - (Z << SH);
  int a;
  asm("abs.s32 %0, %1;" : "=r"(a) : "r"(u));
  const uint32_t bits = (static_cast<uint32_t>(u) & 0x80000000u) |
                        static_cast<uint32_t>(a);
  return __uint_as_float(bits) * 0x1p126f;
}

// Two decoded codes as a bf16 pair, c0 in the low half (the lower K index).
template <int Z, int SH>
__device__ __forceinline__ uint32_t decode_pair(uint32_t c0, uint32_t c1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(decode_bits<Z, SH>(c0),
                                                 decode_bits<Z, SH>(c1));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// e2m1 in row-split nibbles: 64 byte rows a 128-row tile, consumer c takes
// nibble c of each byte.
struct NibbleE2m1 {
  static constexpr int CODE_ROWS = 64;
  static int code_rows(int N) { return N / 2; }
  __device__ static int code_row(int n0) { return n0 / 2; }
  __device__ static int box_row(int) { return 0; }
  __device__ static uint32_t pair(uint32_t piece, int c) {
    const uint32_t p = piece >> (4 * c);
    return decode_pair<7, 22>(p & 0xF, (p >> 8) & 0xF);
  }
};

// One code a byte (Z, SH as decode_bits): consumer c takes rows
// [64c, 64c + 64) of the tile's 128.
template <int Z, int SH>
struct ByteCodes {
  static constexpr int CODE_ROWS = 128;
  static int code_rows(int N) { return N; }
  __device__ static int code_row(int n0) { return n0; }
  __device__ static int box_row(int c) { return 64 * c; }
  __device__ static uint32_t pair(uint32_t piece, int) {
    return decode_pair<Z, SH>(piece & 0xFF, piece >> 8);
  }
};
using ByteE2m1 = ByteCodes<7, 22>;
using ByteE2m3 = ByteCodes<31, 20>;

// x rows a tile: the narrowest of wgmma's N = 16, 64, 128 that holds M
// where M <= 64.
template <typename Dec>
cudaError_t launch_bf16(const void* x, const void* codes, const void* scales,
                        void* out, int M, int N, int K, int group,
                        cudaStream_t stream) {
  const float* s = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  if (M <= 16) {
    return wgmma_gemm::launch_rs<Dec, 16>(x, codes, s, o, M, N, K, group,
                                          stream);
  }
  if (M <= 64) {
    return wgmma_gemm::launch_rs<Dec, 64>(x, codes, s, o, M, N, K, group,
                                          stream);
  }
  return wgmma_gemm::launch_rs<Dec, 128>(x, codes, s, o, M, N, K, group,
                                         stream);
}

// ---------------------------------------------------------------------------
// f32 x: mma.sync over a decoded weight tile in shared memory
// ---------------------------------------------------------------------------

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 128;                 // K chunk staged per pipeline step
constexpr int XPITCH = BK + 8;          // padded x row in elements
constexpr int WPITCH = BK + 8;          // padded bf16 weight row (272 bytes)
constexpr int CODE_STAGE = BN * BK;     // raw code bytes per stage
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;        // 64 rows per warp
constexpr int WN = BN / WARPS_N;        // 32 cols per warp
constexpr int MI = WM / 16;             // m16 tiles per warp
constexpr int NI = WN / 8;              // n8 tiles per warp

enum { FMT_E2M1 = 0, FMT_E2M3 = 1 };

constexpr int STAGE_BYTES = BM * XPITCH * 4 + CODE_STAGE;
constexpr int SMEM_BYTES = 2 * STAGE_BYTES + BN * WPITCH * 2;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// Grid value of one code, exact in bf16 (packing.decode_fp4_e2m1).
__device__ __forceinline__ float decode_e2m1(int c) {
  const int i = c - 7;
  const int k = i < 0 ? -i : i;
  const float mag = k < 4 ? 0.5f * k
                          : static_cast<float>((2 + (k & 1)) << ((k >> 1) - 2));
  return i < 0 ? -mag : mag;
}

// Grid value of one code, exact in bf16 (packing.decode_fp6_e2m3).
__device__ __forceinline__ float decode_e2m3(int c) {
  const int i = c - 31;
  const int k = i < 0 ? -i : i;
  const float mag = k < 16 ? 0.125f * k
                           : (8.f + (k & 7)) * (k >= 24 ? 0.5f : 0.25f);
  return i < 0 ? -mag : mag;
}

template <int FMT>
__device__ __forceinline__ float decode(int c) {
  return FMT == FMT_E2M1 ? decode_e2m1(c) : decode_e2m3(c);
}

// Stage rows [m0, m0 + 128) x K chunk [k0, k0 + 128) of x into smem; rows at
// or past M are zero-filled.
__device__ __forceinline__ void load_x(float* dst, const float* x, int M,
                                       int K, int m0, int k0, int tid) {
  constexpr int EPC = 4;                // elements per 16-byte chunk
  constexpr int CPR = BK / EPC;         // chunks per row
#pragma unroll
  for (int i = 0; i < BM * CPR / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / CPR;
    const int col = (c % CPR) * EPC;
    const int gr = m0 + r;
    const bool ok = gr < M;
    const float* p = x + static_cast<size_t>(ok ? gr : 0) * K + k0 + col;
    cp_async16(dst + r * XPITCH + col, p, ok ? 16 : 0);
  }
}

// Stage the code bytes of the tile's 128 weight rows (64 byte rows when
// nibble-packed) for K chunk [k0, k0 + 128); rows past the end are
// zero-filled.
template <bool NIBBLE>
__device__ __forceinline__ void load_codes(int8_t* dst, const int8_t* codes,
                                           int N, int K, int n0, int k0,
                                           int tid) {
  constexpr int ROWS = NIBBLE ? BN / 2 : BN;
  const int r0 = NIBBLE ? n0 / 2 : n0;
  const int rows = NIBBLE ? N / 2 : N;
#pragma unroll
  for (int i = 0; i < ROWS * (BK / 16) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 3;
    const int col = (c & 7) * 16;
    const int gr = r0 + r;
    const bool ok = gr < rows;
    const int8_t* p = codes + static_cast<size_t>(ok ? gr : 0) * K + k0 + col;
    cp_async16(dst + r * BK + col, p, ok ? 16 : 0);
  }
}

// Decode the staged code bytes into the bf16 weight tile w [128][WPITCH]
// (row = output column n - n0, K-contiguous).
template <int FMT, bool NIBBLE>
__device__ __forceinline__ void decode_tile(const int8_t* sc,
                                            __nv_bfloat16* w, int tid) {
  constexpr int ROWS = NIBBLE ? BN / 2 : BN;
#pragma unroll
  for (int i = 0; i < ROWS * (BK / 16) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 3;
    const int col = (c & 7) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(sc + r * BK + col);
    const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
    unsigned lo[8];
    unsigned hi[NIBBLE ? 8 : 1];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned b0 = (words[j >> 1] >> (16 * (j & 1))) & 0xFF;
      const unsigned b1 = (words[j >> 1] >> (16 * (j & 1) + 8)) & 0xFF;
      if constexpr (NIBBLE) {
        lo[j] = pack_bf16(__floats2bfloat162_rn(decode<FMT>(b0 & 0xF),
                                                decode<FMT>(b1 & 0xF)));
        hi[j] = pack_bf16(__floats2bfloat162_rn(decode<FMT>(b0 >> 4),
                                                decode<FMT>(b1 >> 4)));
      } else {
        lo[j] = pack_bf16(__floats2bfloat162_rn(decode<FMT>(b0),
                                                decode<FMT>(b1)));
      }
    }
    uint4* dlo = reinterpret_cast<uint4*>(w + r * WPITCH + col);
    dlo[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    dlo[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    if constexpr (NIBBLE) {
      uint4* dhi = reinterpret_cast<uint4*>(w + (r + BN / 2) * WPITCH + col);
      dhi[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dhi[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
  }
}

// Split two f32 values into three bf16 pairs with v = hi + mid + lo exactly.
__device__ __forceinline__ void split3(float2 v, unsigned& hi, unsigned& mid,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v.x - hf.x;
  const float r1 = v.y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = pack_bf16(h);
  mid = pack_bf16(m);
  lo = pack_bf16(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

template <int FMT, bool NIBBLE>
__global__ void __launch_bounds__(THREADS)
packed_dequant_gemm_kernel(const float* __restrict__ x,
                           const int8_t* __restrict__ codes,
                           const float* __restrict__ scales,
                           float* __restrict__ out,
                           int M, int N, int K, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(
      smem + 2 * STAGE_BYTES);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int g = lane >> 2;     // mma groupID
  const int t = lane & 3;      // mma threadID_in_group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int chunks_per_group = group / BK;
  const int nchunks = K / BK;

  float acc[MI][NI][4];
  float part[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0.f;
        part[mi][ni][e] = 0.f;
      }

  auto stage_x = [&](int s) {
    return reinterpret_cast<float*>(smem + s * STAGE_BYTES);
  };
  auto stage_codes = [&](int s) {
    return reinterpret_cast<int8_t*>(smem + s * STAGE_BYTES +
                                     BM * XPITCH * sizeof(float));
  };

  load_x(stage_x(0), x, M, K, m0, 0, tid);
  load_codes<NIBBLE>(stage_codes(0), codes, N, K, n0, 0, tid);
  cp_async_commit();

  for (int kc = 0; kc < nchunks; ++kc) {
    if (kc + 1 < nchunks) {
      const int s = (kc + 1) & 1;
      load_x(stage_x(s), x, M, K, m0, (kc + 1) * BK, tid);
      load_codes<NIBBLE>(stage_codes(s), codes, N, K, n0, (kc + 1) * BK, tid);
    }
    cp_async_commit();         // possibly empty: keeps the wait count uniform
    cp_async_wait_prev();      // chunk kc has landed
    __syncthreads();
    decode_tile<FMT, NIBBLE>(stage_codes(kc & 1), sw, tid);
    __syncthreads();

    const float* sx = stage_x(kc & 1);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      unsigned bfr[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const __nv_bfloat16* q = sw + (wn * WN + ni * 8 + g) * WPITCH + ks +
                                 2 * t;
        bfr[ni][0] = ld32(q);
        bfr[ni][1] = ld32(q + 8);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const float* p = sx + (wm * WM + mi * 16 + g) * XPITCH + ks + 2 * t;
        unsigned ah[4], am[4], al[4];
        const float2 v[4] = {
            *reinterpret_cast<const float2*>(p),
            *reinterpret_cast<const float2*>(p + 8 * XPITCH),
            *reinterpret_cast<const float2*>(p + 8),
            *reinterpret_cast<const float2*>(p + 8 * XPITCH + 8)};
#pragma unroll
        for (int e = 0; e < 4; ++e) split3(v[e], ah[e], am[e], al[e]);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          mma_bf16(part[mi][ni], ah, bfr[ni]);
          mma_bf16(part[mi][ni], am, bfr[ni]);
          mma_bf16(part[mi][ni], al, bfr[ni]);
        }
      }
    }
    __syncthreads();           // the next iteration refills this stage and sw

    {   // every chunk: 3 * 128 terms a part (quant_matmul.K2_REL_TOL)
      const int gi = kc / chunks_per_group;
      float s[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = n0 + wn * WN + ni * 8 + t * 2 + h;
          s[ni][h] = c < N ? __ldg(scales + static_cast<size_t>(gi) * N + c)
                           : 0.f;
        }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mi][ni][e] += part[mi][ni][e] * s[ni][e & 1];
            part[mi][ni][e] = 0.f;
          }
    }
  }

  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * WM + mi * 16 + g + 8 * h;
        const int c = n0 + wn * WN + ni * 8 + t * 2;
        if (r >= M) continue;
        float* o = out + static_cast<size_t>(r) * N + c;
        const float v0 = acc[mi][ni][2 * h];
        const float v1 = acc[mi][ni][2 * h + 1];
        if (pairs && c + 1 < N) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (c < N) o[0] = v0;
          if (c + 1 < N) o[1] = v1;
        }
      }
}

template <int FMT, bool NIBBLE>
cudaError_t launch_f32(const void* x, const void* codes, const void* scales,
                       void* out, int M, int N, int K, int group,
                       cudaStream_t stream) {
  auto kernel = packed_dequant_gemm_kernel<FMT, NIBBLE>;
  cudaError_t e =
      cuda_common::opt_in_smem<packed_dequant_gemm_kernel<FMT, NIBBLE>>(
          SMEM_BYTES);
  if (e != cudaSuccess) return e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scales), static_cast<float*>(out), M, N, K,
      group);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* x, const void* codes, const void* scales,
                     void* out, int M, int N, int K, int group, int x_f32,
                     int fmt, int nibble, cudaStream_t stream) {
  if (x_f32) {
    if (nibble) {
      return launch_f32<FMT_E2M1, true>(x, codes, scales, out, M, N, K,
                                        group, stream);
    }
    if (fmt == FMT_E2M1) {
      return launch_f32<FMT_E2M1, false>(x, codes, scales, out, M, N, K,
                                         group, stream);
    }
    return launch_f32<FMT_E2M3, false>(x, codes, scales, out, M, N, K, group,
                                       stream);
  }
  if (nibble) {
    return launch_bf16<NibbleE2m1>(x, codes, scales, out, M, N, K, group,
                                   stream);
  }
  if (fmt == FMT_E2M1) {
    return launch_bf16<ByteE2m1>(x, codes, scales, out, M, N, K, group,
                                 stream);
  }
  return launch_bf16<ByteE2m3>(x, codes, scales, out, M, N, K, group,
                               stream);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// x_f32: 1 for float32 x, 0 for bfloat16.  fmt: 0 = e2m1, 1 = e2m3.
// nibble: 1 for row-split e2m1 nibbles (N % 128 == 0).  The x and code
// pointers must be 16-byte aligned, K % group == 0 and group % 128 == 0.
extern "C" int packed_dequant_gemm(const void* x, const void* codes,
                                   const void* scales, void* out, int M,
                                   int N, int K, int group, int x_f32,
                                   int fmt, int nibble, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || group <= 0 || group % BK != 0 ||
      K % group != 0 || (fmt != FMT_E2M1 && fmt != FMT_E2M3) ||
      (nibble && (fmt != FMT_E2M1 || N % BN != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dispatch(x, codes, scales, out, M, N, K, group,
                                   x_f32, fmt, nibble,
                                   static_cast<cudaStream_t>(stream)));
}

// The weight tensor-map cache of this library: lookups that found a map
// and maps encoded.
extern "C" void packed_dequant_gemm_map_cache(long long* hits,
                                              long long* misses) {
  wgmma_gemm::MapCache& cache = wgmma_gemm::map_cache();
  std::lock_guard<std::mutex> lock(cache.mu);
  *hits = cache.hits;
  *misses = cache.misses;
}

extern "C" const char* packed_dequant_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
