// o = x + 1: the smallest kernel there is, to measure what a hand-written
// kernel's launch costs on the card.
//
// Hand-written Hopper (sm_90a) counterpart of the Pallas TPU dispatch probes
// `triv_kernel` of tools/probe_r4.py (`triv` at :35, `triv_grid` at :47; the
// same pair in tools/probe_r4b.py and tools/probe_r4c.py).  `triv` runs the
// whole (2048, 128) array as one program and `triv_grid` as a 256-step grid
// of (8, 128) blocks; here the whole-array form is ONE thread block of 1,024
// threads that strides over the array, and the grid form is one thread block
// per 1,024 elements (256 blocks at that shape), one element per thread.
//
// Bound on the card: neither bytes nor operations but the launch itself: the
// array is 1 MiB in and 1 MiB out.  Nothing in the design hides that: it is
// what the probe exists to show.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads) add_one_kernel(const float* __restrict__ x,
                                                           float* __restrict__ o, int n) {
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) o[i] = x[i] + 1.0f;
}

}  // namespace

// Launches o = x + 1 over n floats on `stream`, as one thread block (grid == 0)
// or as one thread block per 1,024 elements (grid != 0); returns
// cudaGetLastError().
extern "C" int add_one_launch(const void* x, void* o, int n, int grid, void* stream) {
  if (n <= 0) return 0;
  const int blocks = grid ? (n + kThreads - 1) / kThreads : 1;
  add_one_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return static_cast<int>(cudaGetLastError());
}
