// Grouped-scale int8 GEMM for Hopper (sm_90a):
//
//   out[m,n] = sum_g  asc[m,g] * wsc[g,n] * sum_{k in g} ac[m,k] * wc[n,k]
//
// Replaces the TPU kernel fpqvar_tpu/ops/pallas/int8_matmul.py
// (_kernel / _int8_matmul_2d).  Operands: ac [M,K] int8 row-major,
// asc [M,G] f32, wc [N,K] int8 (the weight's own (out, in) layout: mma.sync
// wants the B operand K-contiguous, where the TPU kernel took [K,N]),
// wsc [G,N] f32, out [M,N] f32.  G = K / group, group a multiple of 128.
//
// Design.  The tile loop of int8_mma.cuh: one 128x128 output tile per
// block, K walked in 128-wide chunks inside the block (the TPU kernel's
// sequential K grid axis becomes this loop), each chunk of A and W codes
// staged by cp.async two stages deep, mma.sync m16n8k32 s8 x s8 -> s32.
// At the end of every scale group the exact int32 partials are converted to
// f32 and accumulated as part * asc * wsc in f32 registers.  Ragged M and N
// edges are zero-filled on load (cp.async with src-size 0) and masked on
// store, so any M >= 1 and N >= 1 work; K must be a multiple of the group.
//
// Exactness.  |code| <= 64, so a 128-term group sum is below 2^19: the int32
// part is exact and so is its f32 conversion.  The result differs from the
// plain PyTorch version only in the f32 summation order over the G groups.
//
// Bound on an H100 SXM.  At the d16 shapes of the last scale (M = 4096),
// fc1 is 2*4096*1024*4096 = 34 GOP, 17 us at the 1,979 TOP/s int8 peak,
// while it moves 4 MB + 4 MB of codes and 64 MB of f32 output, 22 us at
// 3.35 TB/s: the f32 output write bounds it.  This first version is
// mma.sync without wgmma, TMA or a bf16 epilogue, and is slower than that
// bound (PERF.md has its times).
#include "int8_mma.cuh"

using namespace int8mma;

namespace {

constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // A and W chunks
constexpr int SMEM_BYTES = 2 * STAGE_BYTES;

__global__ void __launch_bounds__(THREADS)
int8_group_gemm_kernel(const int8_t* __restrict__ ac,
                       const float* __restrict__ asc,
                       const int8_t* __restrict__ wc,
                       const float* __restrict__ wsc,
                       float* __restrict__ out,
                       int M, int N, int K, int group) {
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int g = lane >> 2;     // mma groupID
  const int t = lane & 3;      // mma threadID_in_group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int G = K / group;
  const int chunks_per_group = group / BK;
  const int nchunks = K / BK;

  float acc[MI][NI][4];
  int part[MI][NI][4];
  zero(part);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  load_tile(smem, ac, M, K, m0, 0, tid);
  load_tile(smem + TILE_BYTES, wc, N, K, n0, 0, tid);
  cp_async_commit();

  for (int kc = 0; kc < nchunks; ++kc) {
    if (kc + 1 < nchunks) {
      int8_t* nxt = smem + ((kc + 1) & 1) * STAGE_BYTES;
      load_tile(nxt, ac, M, K, m0, (kc + 1) * BK, tid);
      load_tile(nxt + TILE_BYTES, wc, N, K, n0, (kc + 1) * BK, tid);
    }
    cp_async_commit();         // possibly empty: keeps the wait count uniform
    cp_async_wait_prev();      // chunk kc has landed
    __syncthreads();

    const int8_t* sA = smem + (kc & 1) * STAGE_BYTES;
    mma_chunk(sA, sA + TILE_BYTES, part, wm, wn, g, t);
    __syncthreads();           // the next iteration refills this stage

    if ((kc + 1) % chunks_per_group == 0) {
      const int gi = kc / chunks_per_group;
      float sa[MI][2];
      float sw[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + wm * WM + mi * 16 + g + 8 * h;
          sa[mi][h] = r < M ? __ldg(asc + static_cast<size_t>(r) * G + gi)
                            : 0.f;
        }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = n0 + wn * WN + ni * 8 + t * 2 + h;
          sw[ni][h] = c < N ? __ldg(wsc + static_cast<size_t>(gi) * N + c)
                            : 0.f;
        }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mi][ni][e] += static_cast<float>(part[mi][ni][e]) *
                              sa[mi][e >> 1] * sw[ni][e & 1];
            part[mi][ni][e] = 0;
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

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The code pointers must be 16-byte aligned, K % group == 0 and
// group % 128 == 0 (so every code row is a whole number of 16-byte chunks).
extern "C" int int8_group_gemm(const void* ac, const void* asc,
                               const void* wc, const void* wsc, void* out,
                               int M, int N, int K, int group, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || group <= 0 || group % BK != 0 ||
      K % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = opt_in_smem<int8_group_gemm_kernel>(SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_group_gemm_kernel<<<grid, THREADS, SMEM_BYTES,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ac), static_cast<const float*>(asc),
      static_cast<const int8_t*>(wc), static_cast<const float*>(wsc),
      static_cast<float*>(out), M, N, K, group);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_group_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
