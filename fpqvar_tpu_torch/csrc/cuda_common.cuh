// Host and device helpers shared by the port's CUDA sources: the
// per-device shared-memory opt-in (packed_dequant_gemm.cu's f32 K2,
// wgmma_gemm.cuh's K1 to K7) and the f32 / bf16 column-pair stores of the
// pipeline's direct-store epilogue.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cuda_common {

constexpr int kMaxDevices = 64;

// Column-pair stores of the epilogues: f32, or a bf16 pair rounded to
// nearest even.
__device__ __forceinline__ void store2(float* o, float v0, float v1) {
  *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(o) =
      __halves2bfloat162(__float2bfloat16(v0), __float2bfloat16(v1));
}
__device__ __forceinline__ void store1(float* o, float v) { *o = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16(v);
}

// out[row, col], out[row, col + 1] (the second where col + 1 < N): one
// paired store where N is even (the pair is then aligned).
template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* out, int N, int row, int col,
                                           float v0, float v1) {
  OutT* o = out + static_cast<size_t>(row) * N + col;
  if ((N % 2) == 0) {
    store2(o, v0, v1);
  } else {
    store1(o, v0);
    if (col + 1 < N) store1(o + 1, v1);
  }
}

// Opt `Kernel` in to `bytes` of dynamic shared memory on the current
// device.  The attribute is per device: set it on the first launch on
// each device only (setting it twice is harmless).
template <auto Kernel>
cudaError_t opt_in_smem(int bytes) {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace cuda_common
