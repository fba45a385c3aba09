// An empty kernel: the floor under every launch's time.
//
// Replaces no TPU kernel and runs on no path. The measuring tools
// (chip_smoke.py's kernel phase, scripts/torch_klt_latency.py) replay it in
// a CUDA graph at a kernel's grid, as they replay the kernels, so that a
// kernel's time per call can be read as this floor plus its own work: the
// part no design of the kernel removes.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int launch_floor_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
