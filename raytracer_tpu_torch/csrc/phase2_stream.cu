// Phase 2 of the block-candidate traversal as one early-ending candidate loop
// per ray block: the kernel of the `sorted-pallas` traversal mode.
//
// Hand-written Hopper (sm_90a) port of the Pallas TPU kernel
// raytracer_tpu/ops/pallas_traverse.py::_phase2_stream_kernel (launched by
// _pallas_stream_trace).  It computes what that kernel computes, not how.
// The TPU kernel is one program per ray block with a while-loop over the
// candidates and a double-buffered DMA of each candidate's packed tile into
// scalar memory; here ONE thread block of 1,024 threads owns one ray block
// (thread i owns ray i), stages candidate j's tile in shared memory, and
// keeps the running (t, tri, u, v) in registers.
//
// Per ray block b: while j < kb and entry[b, j] < max over ALL 1,024 rays of
// the running t (pads carry t = 0), the loop takes candidate cand[b, j]:
//   - every ray slab-tests the cluster's box (1e-12 inverse floor) against its
//     running t; the block-wide OR of these tests (__syncthreads_or) decides
//     whether ALL rays run the triangle loop.  The gate is per block, not per
//     ray: a ray whose own box test fails still meets the triangles when
//     another ray of its block passes, and may take a grazing hit.
//   - the triangle loop visits the K slots in order with strict t < best_t
//     and tid >= 0; ids travel as float32 values in the tile and are
//     converted with a cast.  In any-hit mode a hit parks the lane at t = 0
//     and keeps the first hit's id; the block leaves the loop once all its
//     lanes are parked.
// The loop ENDS at the first candidate that fails the entry test.
//
// Bound on the card: operations.  A step that passes the gate moves one tile
// (10*K + 6 floats, 2.6 KiB at K = 64) for 1,024 x K tests of ~54 fp32
// operations each; a step that fails it still costs the tile, one box test
// per ray, a reduction and three barriers, which is what coherent blocks with
// many candidates pay.  The design keeps the operands in shared memory, read
// by all threads at one address (a broadcast), and the state in registers;
// the tile copy is a plain cooperative load (no cp.async yet).
//
// Built with -fmad=false and without fast math so that the kernel and its
// plain PyTorch version (ops/pallas_traverse.py::phase2_stream_reference)
// agree bit for bit.

#include "mt_test.cuh"

namespace {

using namespace rt;

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlockRays, 1) phase2_stream_kernel(
    const int32_t* __restrict__ cand, const float* __restrict__ entry,
    const float* __restrict__ stream_block, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, const float* __restrict__ tm,
    float* __restrict__ t_out, int32_t* __restrict__ tri_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int kb, int k, int tile_floats) {
  __shared__ float s_tile[kMaxK * 10 + 8];  // [0:9k) geometry, [9k:10k) ids, [10k:10k+6) box
  __shared__ float s_red[2][kWarps];

  const int i = threadIdx.x;
  const size_t p = static_cast<size_t>(blockIdx.x) * kBlockRays + i;
  const size_t row = static_cast<size_t>(blockIdx.x) * kb;
  const Ray r = {ox[p], oy[p], oz[p], dx[p], dy[p], dz[p]};
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  Best best = {tm[p], -1, 0.0f, 0.0f};
  const int used = 10 * k + 6;

  for (int j = 0; j < kb; ++j) {
    // the barrier inside block_max also orders this step's staging after the
    // previous step's reads of the shared tile
    const float m = block_max(best.t, s_red[j & 1]);
    if (!(entry[row + j] < m)) break;  // uniform over the block: the loop ends
    const float* tile = stream_block + static_cast<size_t>(cand[row + j]) * tile_floats;
    for (int e = i; e < used; e += kBlockRays) s_tile[e] = tile[e];
    __syncthreads();

    const float* box = s_tile + 10 * k;
    const float t1x = (box[0] - r.ox) * ix, t2x = (box[3] - r.ox) * ix;
    const float t1y = (box[1] - r.oy) * iy, t2y = (box[4] - r.oy) * iy;
    const float t1z = (box[2] - r.oz) * iz, t2z = (box[5] - r.oz) * iz;
    const float bmin = nmax(nmax(nmin(t1x, t2x), nmin(t1y, t2y)), nmin(t1z, t2z));
    const float bmax = nmin(nmin(nmax(t1x, t2x), nmax(t1y, t2y)), nmax(t1z, t2z));
    const int box_hit = (bmax >= nmax(bmin, 0.0f)) && (bmin < best.t);
    if (!__syncthreads_or(box_hit)) continue;  // no ray of the block touches the box

    const float* ids = s_tile + 9 * k;
    for (int s = 0; s < k; ++s)
      mt_test<kAnyHit>(s_tile + 9 * s, static_cast<int32_t>(ids[s]), r, best);
  }

  t_out[p] = best.t;
  tri_out[p] = best.tri;
  u_out[p] = best.u;
  v_out[p] = best.v;
}

}  // namespace

// Launches the kernel over b ray blocks on `stream`; returns
// cudaGetLastError().  cand (b, kb) int32 and entry (b, kb) f32; stream_block
// (C, tile_floats) f32 with 10*k + 6 <= tile_floats and k <= 128; ray arrays
// and outputs (b, 8, 128) contiguous.
extern "C" int phase2_stream_launch(const void* cand, const void* entry,
                                    const void* stream_block, const void* ox, const void* oy,
                                    const void* oz, const void* dx, const void* dy,
                                    const void* dz, const void* tm, void* t_out, void* tri_out,
                                    void* u_out, void* v_out, int b, int kb, int k,
                                    int tile_floats, int any_hit, void* stream) {
  if (b <= 0) return 0;
  if (k <= 0 || k > kMaxK || kb <= 0 || 10 * k + 6 > tile_floats)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = any_hit ? phase2_stream_kernel<true> : phase2_stream_kernel<false>;
  kernel<<<b, kBlockRays, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cand), static_cast<const float*>(entry),
      static_cast<const float*>(stream_block), static_cast<const float*>(ox),
      static_cast<const float*>(oy), static_cast<const float*>(oz), static_cast<const float*>(dx),
      static_cast<const float*>(dy), static_cast<const float*>(dz), static_cast<const float*>(tm),
      static_cast<float*>(t_out), static_cast<int32_t*>(tri_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), kb, k, tile_floats);
  return static_cast<int>(cudaGetLastError());
}
