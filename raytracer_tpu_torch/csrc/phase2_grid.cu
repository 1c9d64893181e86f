// Phase 2 of the block-candidate traversal over a (B, kb) candidate table,
// every candidate visited or skipped.
//
// Hand-written Hopper (sm_90a) port of the Pallas TPU kernel
// raytracer_tpu/ops/pallas_traverse.py::_phase2_kernel (launched by
// _pallas_closest_hit_padded and by _pallas_sorted_closest_hit).  It computes
// what that kernel computes, not how.  The TPU kernel runs a (B, kb) grid
// whose steps execute in order on one core and carry (t, tri, u, v) in the
// revisited output block from one candidate j to the next; CUDA blocks run in
// parallel and carry nothing, so here ONE thread block of 1,024 threads owns
// one ray block (thread i owns ray i), the candidate loop runs inside it, and
// the running best stays in registers until the single write at the end.
//
// Per ray block b, for j = 0 .. kb-1 in table order:
//   live = entry[b, j] < max over ALL 1,024 rays of the running t (pad rays
//   included: they carry t = tm = 0), a block-wide reduction; a dead step is
//   skipped, a live one tests cluster cand[b, j]'s K triangles, slot by slot,
//   against every ray with strict t < best_t and tid >= 0.
//
// Bound on the card: operations.  A live step moves 2.5 KiB of geometry
// (K = 64) for 1,024 x 64 tests of ~54 fp32 operations each; the rays are
// read once and the results written once per block (44 KiB).  The design
// keeps the tests' operands out of device memory: the candidate's K*9 floats
// and K ids are staged in shared memory once per live step and read at one
// address by all threads (a broadcast), and the per-step cost beyond the
// tests is one warp-shuffle reduction and two barriers.
//
// Built with -fmad=false and without fast math so that the kernel and its
// plain PyTorch version (ops/pallas_traverse.py::phase2_grid_reference) agree
// bit for bit.

#include "mt_test.cuh"

namespace {

using namespace rt;

__global__ void __launch_bounds__(kBlockRays, 1) phase2_grid_kernel(
    const int32_t* __restrict__ cand, const float* __restrict__ entry,
    const float* __restrict__ tri_block, const int32_t* __restrict__ tri_id,
    const float* __restrict__ ox, const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tm, float* __restrict__ t_out, int32_t* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out, int kb, int k) {
  __shared__ float s_geom[kMaxK * 9];
  __shared__ int32_t s_id[kMaxK];
  __shared__ float s_red[2][kWarps];

  const int i = threadIdx.x;
  const size_t p = static_cast<size_t>(blockIdx.x) * kBlockRays + i;
  const size_t row = static_cast<size_t>(blockIdx.x) * kb;
  const Ray r = {ox[p], oy[p], oz[p], dx[p], dy[p], dz[p]};
  Best best = {tm[p], -1, 0.0f, 0.0f};

  for (int j = 0; j < kb; ++j) {
    // the barrier inside block_max also orders this step's staging after the
    // previous step's reads of the shared tile
    const float m = block_max(best.t, s_red[j & 1]);
    if (!(entry[row + j] < m)) continue;  // uniform over the block
    const size_t c = static_cast<size_t>(cand[row + j]);
    for (int e = i; e < k * 9; e += kBlockRays) s_geom[e] = tri_block[c * k * 9 + e];
    if (i < k) s_id[i] = tri_id[c * k + i];
    __syncthreads();
    for (int s = 0; s < k; ++s) mt_test<false>(s_geom + 9 * s, s_id[s], r, best);
  }

  t_out[p] = best.t;
  tri_out[p] = best.tri;
  u_out[p] = best.u;
  v_out[p] = best.v;
}

}  // namespace

// Launches the kernel over b ray blocks on `stream`; returns
// cudaGetLastError().  cand (b, kb) int32 and entry (b, kb) f32; tri_block
// (C, k*9) f32 and tri_id (C, k) int32 with k <= 128; ray arrays and outputs
// (b, 8, 128) contiguous.
extern "C" int phase2_grid_launch(const void* cand, const void* entry, const void* tri_block,
                                  const void* tri_id, const void* ox, const void* oy,
                                  const void* oz, const void* dx, const void* dy, const void* dz,
                                  const void* tm, void* t_out, void* tri_out, void* u_out,
                                  void* v_out, int b, int kb, int k, void* stream) {
  if (b <= 0) return 0;
  if (k <= 0 || k > kMaxK || kb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  phase2_grid_kernel<<<b, kBlockRays, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cand), static_cast<const float*>(entry),
      static_cast<const float*>(tri_block), static_cast<const int32_t*>(tri_id),
      static_cast<const float*>(ox), static_cast<const float*>(oy), static_cast<const float*>(oz),
      static_cast<const float*>(dx), static_cast<const float*>(dy), static_cast<const float*>(dz),
      static_cast<const float*>(tm), static_cast<float*>(t_out), static_cast<int32_t*>(tri_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out), kb, k);
  return static_cast<int>(cudaGetLastError());
}
