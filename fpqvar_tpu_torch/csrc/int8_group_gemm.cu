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
// Design.  One thread block owns one 128x128 output tile and walks K in
// 128-wide chunks inside the block (the TPU kernel's sequential K grid
// axis becomes this loop).  Each chunk of A and W codes is staged in shared
// memory by cp.async, two stages deep, rows padded to 144 bytes so the
// 32-bit fragment loads hit 32 distinct banks.  Eight warps (2 x 4) each
// own a 64x32 sub-tile and run mma.sync m16n8k32 s8 x s8 -> s32 on it.
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 128;                 // K chunk staged per pipeline step
constexpr int PITCH = BK + 16;          // padded smem row, bytes
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;        // 64 rows per warp
constexpr int WN = BN / WARPS_N;        // 32 cols per warp
constexpr int MI = WM / 16;             // m16 tiles per warp
constexpr int NI = WN / 8;              // n8 tiles per warp
constexpr int STAGE_BYTES = (BM + BN) * PITCH;
constexpr int SMEM_BYTES = 2 * STAGE_BYTES;
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [r0, r0 + 128) x K chunk [k0, k0 + 128) of a [rows, K] int8
// matrix into smem; rows at or past `rows` are zero-filled.
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src,
                                          int rows, int K, int r0, int k0,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < (128 * BK / 16) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 3;
    const int col = (c & 7) * 16;
    const int gr = r0 + r;
    const bool ok = gr < rows;
    const int8_t* p = src + static_cast<size_t>(ok ? gr : 0) * K + k0 + col;
    cp_async16(dst + r * PITCH + col, p, ok ? 16 : 0);
  }
}

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
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0.f;
        part[mi][ni][e] = 0;
      }

  load_tile(smem, ac, M, K, m0, 0, tid);
  load_tile(smem + BM * PITCH, wc, N, K, n0, 0, tid);
  cp_async_commit();

  for (int kc = 0; kc < nchunks; ++kc) {
    if (kc + 1 < nchunks) {
      int8_t* nxt = smem + ((kc + 1) & 1) * STAGE_BYTES;
      load_tile(nxt, ac, M, K, m0, (kc + 1) * BK, tid);
      load_tile(nxt + BM * PITCH, wc, N, K, n0, (kc + 1) * BK, tid);
    }
    cp_async_commit();         // possibly empty: keeps the wait count uniform
    cp_async_wait_prev();      // chunk kc has landed
    __syncthreads();

    const int8_t* sA = smem + (kc & 1) * STAGE_BYTES;
    const int8_t* sB = sA + BM * PITCH;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned af[MI][4];
      unsigned bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int8_t* p = sA + (wm * WM + mi * 16 + g) * PITCH + ks + t * 4;
        af[mi][0] = *reinterpret_cast<const unsigned*>(p);
        af[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * PITCH);
        af[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * PITCH + 16);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int8_t* q = sB + (wn * WN + ni * 8 + g) * PITCH + ks + t * 4;
        bf[ni][0] = *reinterpret_cast<const unsigned*>(q);
        bf[ni][1] = *reinterpret_cast<const unsigned*>(q + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8(part[mi][ni], af[mi], bf[ni]);
    }
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
  // The shared-memory opt-in is a per-device function attribute: set it on
  // the first launch on each device only (setting it twice is harmless).
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    e = cudaFuncSetAttribute(int8_group_gemm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = true;
  }
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
