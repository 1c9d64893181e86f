// o = x + 1: the smallest kernel there is, to measure what a hand-written
// kernel's launch costs on the card.
//
// Hand-written Hopper (sm_90a) counterpart of the Pallas TPU dispatch probes
// `triv_kernel` of tools/probe_r4.py (`triv` at :35, `triv_grid` at :47; the
// same pair in tools/probe_r4b.py and tools/probe_r4c.py).  `triv` runs the
// whole (2048, 128) array as one program and `triv_grid` as a 256-step grid
// of (8, 128) blocks.  Here both are one launch of the same kernel over
// tiles of 1,024 elements: the grid form takes one thread block per tile
// (256 blocks at that shape), the whole-array form a grid sized to the card
// (one block per SM) whose blocks stride over the tiles, so its cost does
// not grow with a per-tile grid.
//
// What bounds it on the card: neither bytes nor operations but the launch
// itself.  The array is 1 MiB in and 1 MiB out and stays in the 50 MB L2, so
// the floor is what an empty kernel costs per launch (`empty_launch.cu`, timed
// beside it by tools/torch_probe_launch.py).  The design keeps the kernel's
// own time under that: 256 threads a block, 16 bytes a thread and access
// (float4), a scalar path for the last partial tile and for pointers that
// are not 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4 * kThreads;  // elements per block and step

// kVec: x and o are 16-byte aligned, so whole tiles move as float4
template <bool kVec>
__global__ void __launch_bounds__(kThreads) add_one_kernel(const float* __restrict__ x,
                                                           float* __restrict__ o, int n) {
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kTile; base < n;
       base += static_cast<int64_t>(gridDim.x) * kTile) {
    if (kVec && base + kTile <= n) {
      const float4 a = reinterpret_cast<const float4*>(x + base)[threadIdx.x];
      reinterpret_cast<float4*>(o + base)[threadIdx.x] =
          make_float4(a.x + 1.0f, a.y + 1.0f, a.z + 1.0f, a.w + 1.0f);
    } else {
      const int64_t end = base + kTile < n ? base + kTile : n;
      for (int64_t i = base + threadIdx.x; i < end; i += kThreads) o[i] = x[i] + 1.0f;
    }
  }
}

}  // namespace

// Launches o = x + 1 over n floats on `stream`: one thread block per tile of
// 1,024 elements (grid != 0), or one block per SM of the current device, each
// striding over the tiles (grid == 0).  Returns the CUDA error (0 = none).
extern "C" int add_one_launch(const void* x, void* o, int n, int grid, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + kTile - 1) / kTile;
  if (!grid) {
    static int sms = 0;  // read once: the probe runs on one device
    if (sms == 0) {
      int dev = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (blocks > sms) blocks = sms;
  }
  const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) % 16 == 0;
  auto kernel = vec ? add_one_kernel<true> : add_one_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return static_cast<int>(cudaGetLastError());
}
