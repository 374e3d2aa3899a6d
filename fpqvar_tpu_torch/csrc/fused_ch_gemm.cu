// Per-token quantize inside a full-K int8 GEMM, for Hopper (sm_90a):
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
// Operands: x [M,K] bf16 or f32 row-major, wc [N,K] int8 (K-contiguous,
// as mma.sync wants its B operand), wsc [1,N] f32; the format's midpoints
// (grid units), integer codes, f32(1 / max|grid|) and code multiplier come
// in the kernel's arguments.  K a multiple of 128.
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
// on the card run in parallel and share nothing, so each 128x128 output
// tile's block first reduces |x| over its 128 rows' whole K (into shared
// memory), then, for every 128-wide K chunk, quantizes the chunk of x into
// a shared-memory int8 tile just before its MMAs (mma.sync m16n8k32, the
// tile loop of int8_mma.cuh) while cp.async brings the next weight chunk.
// The codes never reach device memory, which is the point of the kernel;
// the price is that every row is quantized N / 128 times (24 at d16's qkv)
// and read from L2 twice per N tile.
//
// Bound on an H100 SXM.  At VAR-d16's last scale at batch 8 (M = 4096,
// K = 1024) qkv is 2*4096*1024*3072 = 25.8 GOP, 13.0 us at the 1,979 TOP/s
// int8 peak, against 36 MB moved (8 MB of bf16 x, 3 MB of codes, 25 MB of
// bf16 output), 10.8 us at 3.35 TB/s: operations bound it (also at fc1 and
// fc2); proj (N = 1024) is bound by its 18 MB, 5.3 us.  This first version
// does the division and the search per element on the CUDA cores for every
// N tile, and uses mma.sync without wgmma or TMA (PERF.md has its times).
#include "int8_mma.cuh"

using namespace int8mma;

namespace {

constexpr int kMaxGrid = 64;                  // grid values (fp6_e2m3: 63)
constexpr int SMEM_BYTES = 3 * TILE_BYTES;    // A codes + two W stages

struct Grid {
  float mid[kMaxGrid];    // sorted midpoints in grid units
  int code[kMaxGrid];     // integer code of each grid value
  int n_mids;
  float inv;              // f32(1 / max|grid|)
  float mult;             // code multiplier (a power of two)
};

// 16 bytes of a row of x as floats: 8 bf16 or 4 f32 values (exact).
template <bool XBF16>
struct XVec;

template <>
struct XVec<true> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const void* p, float (&v)[8]) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};

template <>
struct XVec<false> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const void* p, float (&v)[4]) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
};

// The integer code of q: the count of midpoints <= q (a prefix of the
// sorted midpoints), found by binary lifting over at most 63 entries.
__device__ __forceinline__ int encode(float q, const float* mid, int n_mids,
                                      const int* code) {
  int pos = 0;
#pragma unroll
  for (int step = 32; step > 0; step >>= 1) {
    if (pos + step <= n_mids && q >= mid[pos + step - 1]) pos += step;
  }
  return code[pos];
}

template <bool XBF16, typename OutT>
__global__ void __launch_bounds__(THREADS)
fused_ch_gemm_kernel(const void* __restrict__ xv,
                     const int8_t* __restrict__ wc,
                     const float* __restrict__ wsc,
                     OutT* __restrict__ out, int M, int N, int K,
                     const __grid_constant__ Grid grid) {
  using V = XVec<XBF16>;
  constexpr int XBYTES = XBF16 ? 2 : 4;
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ float s_scale[BM];   // the quantization scale of each row
  __shared__ float s_rs[BM];      // scale / mult: the row's output scale
  __shared__ float s_mid[kMaxGrid];
  __shared__ int s_code[kMaxGrid];
  int8_t* sA = smem;
  int8_t* sW = smem + TILE_BYTES;
  const char* x = static_cast<const char*>(xv);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int nchunks = K / BK;
  const size_t row_bytes = static_cast<size_t>(K) * XBYTES;

  // The first weight chunk is in flight while the rows' absmax is taken.
  load_tile(sW, wc, N, K, n0, 0, tid);
  cp_async_commit();
  if (tid < kMaxGrid) {
    s_mid[tid] = grid.mid[tid];
    s_code[tid] = grid.code[tid];
  }

  // Phase 1: every row's absmax over the whole K; each warp takes 16 rows.
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int gr = m0 + r;
    float amax = 0.f;
    if (gr < M) {
      const char* row = x + gr * row_bytes;
      for (int c = lane * 16; c < static_cast<int>(row_bytes); c += 32 * 16) {
        float v[V::N];
        V::load(row + c, v);
#pragma unroll
        for (int j = 0; j < V::N; ++j) amax = fmaxf(amax, fabsf(v[j]));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) {
      const float scale = amax > 0.f ? amax * grid.inv : 1.f;
      s_scale[r] = scale;
      s_rs[r] = scale / grid.mult;
    }
  }
  __syncthreads();

  int part[MI][NI][4];
  zero(part);
  const int n_mids = grid.n_mids;
  constexpr int VEC_PER_ROW = BK / V::N;      // 16-byte vectors per chunk row
  for (int kc = 0; kc < nchunks; ++kc) {
    if (kc + 1 < nchunks) {
      load_tile(sW + ((kc + 1) & 1) * TILE_BYTES, wc, N, K, n0,
                (kc + 1) * BK, tid);
    }
    cp_async_commit();         // possibly empty: keeps the wait count uniform

    // Phase 2: quantize x[m0:m0+128, chunk kc] into the int8 tile sA.
#pragma unroll 4
    for (int i = 0; i < BM * VEC_PER_ROW / THREADS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / VEC_PER_ROW;
      const int col = (c % VEC_PER_ROW) * V::N;
      const int gr = m0 + r;
      unsigned packed[V::N / 4];
#pragma unroll
      for (int j = 0; j < V::N / 4; ++j) packed[j] = 0u;
      if (gr < M) {
        float v[V::N];
        V::load(x + gr * row_bytes + (kc * BK + col) * XBYTES, v);
        const float scale = s_scale[r];
#pragma unroll
        for (int j = 0; j < V::N; ++j) {
          const int q = encode(v[j] / scale, s_mid, n_mids, s_code);
          packed[j >> 2] |= (static_cast<unsigned>(q) & 0xffu)
                            << (8 * (j & 3));
        }
      }
      int8_t* dst = sA + r * PITCH + col;
      if constexpr (V::N == 8) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
      } else {
        *reinterpret_cast<unsigned*>(dst) = packed[0];
      }
    }
    cp_async_wait_prev();      // weight chunk kc has landed
    __syncthreads();
    mma_chunk(sA, sW + (kc & 1) * TILE_BYTES, part, wm, wn, g, t);
    __syncthreads();           // sA and this weight stage are refilled next
  }

  // Epilogue on the registers, with the row's output scale scale / mult.
  store_rescaled(out, part, wsc, M, N, m0, n0, wm, wn, g, t,
                 [&](int rl) { return s_rs[rl]; });
}

template <bool XBF16, typename OutT>
int launch(const void* x, const void* wc, const void* wsc, void* out, int M,
           int N, int K, const Grid& grid, cudaStream_t stream) {
  cudaError_t e = opt_in_smem<fused_ch_gemm_kernel<XBF16, OutT>>(SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 blocks((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_ch_gemm_kernel<XBF16, OutT><<<blocks, THREADS, SMEM_BYTES, stream>>>(
      x, static_cast<const int8_t*>(wc), static_cast<const float*>(wsc),
      static_cast<OutT*>(out), M, N, K, grid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// x and wc must be 16-byte aligned and K % 128 == 0.  x_bf16 / out_bf16:
// 1 for bf16, 0 for f32.  mids (n_mids floats) and codes (n_mids + 1 ints)
// are host pointers, copied into the kernel's arguments.
extern "C" int fused_ch_gemm(const void* x, const void* wc, const void* wsc,
                             void* out, int M, int N, int K, int x_bf16,
                             int out_bf16, const float* mids,
                             const int* codes, int n_mids, float inv,
                             float mult, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK != 0 || n_mids < 1 ||
      n_mids >= kMaxGrid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Grid grid = {};
  for (int i = 0; i < n_mids; ++i) grid.mid[i] = mids[i];
  for (int i = 0; i <= n_mids; ++i) grid.code[i] = codes[i];
  grid.n_mids = n_mids;
  grid.inv = inv;
  grid.mult = mult;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return out_bf16
               ? launch<true, __nv_bfloat16>(x, wc, wsc, out, M, N, K, grid, s)
               : launch<true, float>(x, wc, wsc, out, M, N, K, grid, s);
  }
  return out_bf16
             ? launch<false, __nv_bfloat16>(x, wc, wsc, out, M, N, K, grid, s)
             : launch<false, float>(x, wc, wsc, out, M, N, K, grid, s);
}

extern "C" const char* fused_ch_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
