// The stage marker: an empty kernel, launched at the start of each scale of
// a generation and once after the last scale.
//
// A generation runs as one CUDA graph, so a device trace sees one block of
// kernels per replay, under one correlation id.  The markers are captured
// into that graph with the work around them, so a replay's kernels split by
// scale in the order they ran, on the device's own timestamps: the kernels
// from one marker to the next belong to one scale.  `stage` is the scale's
// index (the number of scales for the marker after the last); the kernel
// does nothing with it, and it is there for a reader of the launch.
#include <cuda_runtime.h>

extern "C" __global__ void fpq_stage_mark(int stage) {}

// Launch one marker on `stream`; returns the launch's cudaError_t (0 =
// success).
extern "C" int stage_mark(int stage, void* stream) {
  fpq_stage_mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(stage);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stage_mark_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
