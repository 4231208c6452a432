// The kernels' launch counters (anyref_tpu_torch/ops/flash.py
// launch_counts): where a wrapper launches its kernel, it launches this one
// after it on the same stream, which adds one to the wrapper's int64 slot on
// the device. Inside a CUDA graph the count is a node beside the kernel, so
// each replay, and each pass of a loop node, counts what it runs. It ports
// no Pallas kernel: one thread, bound by its launch.
#include "common.cuh"

__global__ void anyref_count_kernel(unsigned long long* count) { atomicAdd(count, 1ull); }

ANYREF_API int anyref_count_launch(void* count, void* stream) {
  anyref_count_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}
