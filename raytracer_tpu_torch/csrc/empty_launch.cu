// A kernel that does nothing: the floor of what launching a hand-written
// kernel costs on the card, timed beside `add_one.cu` by
// tools/torch_probe_launch.py.  A library of its own, so that its launches
// are counted apart from add_one's.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches a kernel that does nothing on `stream`.  Returns the CUDA error
// (0 = none).
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
