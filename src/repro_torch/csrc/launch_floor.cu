// An empty kernel: what one launch costs on the card with no work in it.
// chip_smoke.py times it as it times the small kernels (CUDA-graph replays
// between CUDA events) and prints it beside them; it replaces no TPU
// kernel and the port's paths never launch it.
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

MOE_API int moe_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return moe_last_error();
}
