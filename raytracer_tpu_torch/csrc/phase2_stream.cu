// Phase 2 of the block-candidate traversal as one early-ending candidate loop
// per ray block: the kernel of the `sorted-pallas` traversal mode.
//
// Hand-written Hopper (sm_90a) port of the Pallas TPU kernel
// raytracer_tpu/ops/pallas_traverse.py::_phase2_stream_kernel (launched by
// _pallas_stream_trace).  It computes what that kernel computes, not how.
//
// Per ray block b: while j < kb and entry[b, j] < max over ALL 1,024 rays of
// the running t (pads carry t = 0), the loop takes candidate cand[b, j]:
//   - every ray slab-tests the cluster's box (1e-12 inverse floor) against its
//     running t; the OR of these tests over the ray block decides whether ALL
//     rays run the triangle loop.  The gate is per ray block, not per ray: a
//     ray whose own box test fails still meets the triangles when another ray
//     of its block passes, and may take a grazing hit.
//   - the triangle loop visits the K slots in order with strict t < best_t
//     and tid >= 0; ids travel as float32 values in the tile.  In any-hit
//     mode a hit parks the lane at t = 0 and keeps the first hit's id; the
//     block leaves the loop once all its lanes are parked.
// The loop ENDS at the first candidate that fails the entry test.
//
// What bounds it on the card: the float32 instruction rate (-fmad=false: a
// multiply and its add are two, about 75 a test), and before it the slowest ray
// block: a ray block's steps are sequential, coherent blocks run 43 steps on
// average and the longest 256, and about half their steps fail the box gate
// and pay only the step's chain of waits.
//
// What the design does about it (the shared pieces are in mt_test.cuh):
//   - A ray block is a cluster of 8 thread blocks, at most 64 registers a
//     thread: the ray blocks spread over all SMs and the block scheduler
//     balances uneven ones.  (One 1,024-thread block per ray block, one per
//     SM, kept 64 of 132 SMs busy on a 64-block window.)
//   - Two lanes share a ray and fold half of a candidate's slots each, which
//     halves the sequential unit the slowest ray block is made of; one lane a
//     ray where two would push the launch into a second wave (pick_split).
//   - ONE exchange and ONE cluster barrier per step.  Both block-wide values
//     of step j depend only on the state after step j-1 and on candidate j's
//     box, and cand[b, j] is readable whether or not its entry test holds, so
//     the max of t and the OR of the box tests travel together.
//   - Nothing is fetched on that chain: the row of the candidate table sits
//     in shared memory, and candidate j + kAhead's tile is asked of the
//     bulk-copy engine right after step j's barrier, into a ring of kSlots
//     slots, so a step finds its tile landed.  Tiles asked for beyond the
//     loop's end are waited for before the block exits.
//   - The test is straight-line: it folds into the running best by selects,
//     the reciprocal is the division's fast path spelled out (no branch
//     between two tests), four slots come from nine 16-byte loads, and ids
//     stay floats until the single write at the end.
//
// Built with -fmad=false and without fast math so that the kernel and its
// plain PyTorch version (ops/pallas_traverse.py::phase2_stream_reference)
// agree bit for bit.

#include "mt_test.cuh"

namespace {

using namespace rt;

constexpr int kSlots = 4;  // tile slots in the ring (a power of two)
constexpr int kAhead = 3;  // tiles in flight ahead of the step under test
static_assert((kSlots & (kSlots - 1)) == 0 && kAhead >= 1 && kAhead < kSlots, "ring shape");

// bytes of a tile the kernel reads, rounded up to the copy engine's 16
__host__ __device__ constexpr uint32_t tile_bytes(int k) { return (static_cast<uint32_t>(10 * k + 6) * 4u + 15u) & ~15u; }
// floats from one ring slot to the next (128-byte aligned slots)
__host__ __device__ constexpr int slot_floats(int k) { return static_cast<int>((tile_bytes(k) + 127u) & ~127u) / 4; }

template <bool kAnyHit, int kSplit>
__global__ void __launch_bounds__(Shape<kSplit>::kThreads, Shape<kSplit>::kMinBlocks) phase2_stream_kernel(
    const int32_t* __restrict__ cand, const float* __restrict__ entry,
    const float* __restrict__ stream_block, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, const float* __restrict__ tm,
    float* __restrict__ t_out, int32_t* __restrict__ tri_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int kb, int k, int tile_floats) {
  extern __shared__ __align__(128) float s_ring[];  // kSlots tiles: [0:9k) geometry, [9k:10k) ids, [10k:10k+6) box
  __shared__ __align__(8) uint64_t s_bar[kSlots];
  __shared__ __align__(8) Exchange s_x;
  __shared__ float s_entry[kChunk + kAhead];
  __shared__ int32_t s_cand[kChunk + kAhead];

  const uint32_t rank = cluster_rank();
  const size_t block = blockIdx.x / kCluster;
  const size_t p = block * kBlockRays + (rank * Shape<kSplit>::kThreads + threadIdx.x) / kSplit;  // this thread's ray
  const int sub = threadIdx.x % kSplit;                                            // and its place among the ray's lanes
  const size_t row = block * kb;
  const Ray r = {ox[p], oy[p], oz[p], dx[p], dy[p], dz[p]};
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  Best<float> best = {tm[p], -1.0f, 0.0f, 0.0f};
  const uint32_t bytes = tile_bytes(k);
  const int stride = slot_floats(k);
  const float inf = pos_inf();

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(&s_bar[s], 1);
    mbar_init_fence();
  }
  int base = 0;
  stage_row(cand, entry, row, kb, base, kChunk + kAhead, s_entry, s_cand);  // its barriers publish s_bar too
  cluster_sync();  // every block of the cluster runs before a peer writes into its shared memory

  // thread 0 asks for candidate jj's tile, staged at offset o; an entry of
  // +inf ends the loop before its tile is looked at, so none is asked for
  auto fetch = [&](int jj, int o) {
    if (threadIdx.x == 0 && s_entry[o] < inf) {
      const int s = jj & (kSlots - 1);
      mbar_expect(&s_bar[s], bytes);
      bulk_load(s_ring + s * stride, stream_block + static_cast<size_t>(s_cand[o]) * tile_floats, bytes, &s_bar[s]);
    }
  };
  for (int jj = 0; jj < kAhead; ++jj) fetch(jj, jj);

  uint32_t phases = 0;  // bit s: the parity of slot s's next phase
  auto wait_tile = [&](int jj) {
    const int s = jj & (kSlots - 1);
    mbar_wait(&s_bar[s], (phases >> s) & 1u);
    phases ^= 1u << s;
  };

  int j = 0;        // the step; tiles below `waited` have been waited for
  int waited = 0;   // (or were never asked for)
  int asked = kAhead;  // tiles below `asked` have been asked for, where their entry is finite
  for (; j < kb; ++j) {
    if (j - base == kChunk) {
      base = j;
      stage_row(cand, entry, row, kb, base, kChunk + kAhead, s_entry, s_cand);
    }
    const int o = j - base;
    const float e = s_entry[o];
    if (!(e < inf)) break;  // uniform over the cluster: no max of t is above +inf
    wait_tile(j);
    waited = j + 1;
    const float* tile = s_ring + (j & (kSlots - 1)) * stride;

    const float* box = tile + 10 * k;
    const float t1x = (box[0] - r.ox) * ix, t2x = (box[3] - r.ox) * ix;
    const float t1y = (box[1] - r.oy) * iy, t2y = (box[4] - r.oy) * iy;
    const float t1z = (box[2] - r.oz) * iz, t2z = (box[5] - r.oz) * iz;
    const float bmin = nmax(nmax(nmin(t1x, t2x), nmin(t1y, t2y)), nmin(t1z, t2z));
    const float bmax = nmin(nmin(nmax(t1x, t2x), nmax(t1y, t2y)), nmax(t1z, t2z));
    const bool box_hit = (bmax >= nmax(bmin, 0.0f)) && (bmin < best.t);

    // the step's one exchange: max of t and OR of the box tests over the ray
    // block.  Its barrier also says that every thread of this block is done
    // with step j - 1's tile, whose slot the next fetch may fill.
    exchange_post<kSplit>(&s_x, j & 1, rank, best.t, box_hit);
    bool any_box;
    const float m = exchange_read<kSplit>(&s_x, j & 1, any_box);
    fetch(j + kAhead, o + kAhead);
    asked = j + kAhead + 1;
    if (!(e < m)) break;     // the loop ends; uniform over the cluster
    if (!any_box) continue;  // no ray of the ray block touches the box

    test_slots<kAnyHit, kSplit>(tile, tile + 9 * k, k, sub, r, best);
  }

  if (sub == 0) {
    t_out[p] = best.t;
    tri_out[p] = static_cast<int32_t>(best.tri);
    u_out[p] = best.u;
    v_out[p] = best.v;
  }

  // tiles still in flight land before this block's shared memory goes
  for (int jj = waited; jj < asked; ++jj)
    if (s_entry[jj - base] < inf) wait_tile(jj);
  cluster_sync();  // no block exits while a peer may still write into it
}

size_t ring_bytes(int k) { return static_cast<size_t>(kSlots) * slot_floats(k) * sizeof(float); }

template <bool kAnyHit, int kSplit>
int active_clusters(int k) {
  return max_active_clusters(phase2_stream_kernel<kAnyHit, kSplit>, Shape<kSplit>::kThreads, ring_bytes(k));
}

template <bool kAnyHit, int kSplit, typename... Args>
cudaError_t launch(int b, int k, cudaStream_t stream, Args... args) {
  ClusterLaunch shape(b, Shape<kSplit>::kThreads, ring_bytes(k), stream);
  return cudaLaunchKernelEx(&shape.cfg, phase2_stream_kernel<kAnyHit, kSplit>, args...);
}

template <bool kAnyHit, typename... Args>
cudaError_t launch_any_split(int b, int k, cudaStream_t stream, Args... args) {
  static int fit[kMaxSplit][kMaxK + 1];  // clusters the card holds at once, asked once per k
  if (fit[0][k] == 0) {
    fit[0][k] = active_clusters<kAnyHit, 1>(k);
    fit[1][k] = active_clusters<kAnyHit, 2>(k);
  }
  return pick_split(b, fit[0][k], fit[1][k]) == 1 ? launch<kAnyHit, 1>(b, k, stream, args...)
                                                  : launch<kAnyHit, 2>(b, k, stream, args...);
}

}  // namespace

// Launches the kernel over b ray blocks on `stream`; returns the CUDA error
// of the launch (0 = none).  cand (b, kb) int32 and entry (b, kb) f32;
// stream_block (C, tile_floats) f32, 16-byte aligned with tile_floats a
// multiple of 4, 10*k + 6 <= tile_floats and k <= 128; cand holds valid
// cluster ids in every slot; ray arrays and outputs (b, 8, 128) contiguous.
extern "C" int phase2_stream_launch(const void* cand, const void* entry,
                                    const void* stream_block, const void* ox, const void* oy,
                                    const void* oz, const void* dx, const void* dy,
                                    const void* dz, const void* tm, void* t_out, void* tri_out,
                                    void* u_out, void* v_out, int b, int kb, int k,
                                    int tile_floats, int any_hit, void* stream) {
  if (b <= 0) return 0;
  if (k <= 0 || k > kMaxK || kb <= 0 || 10 * k + 6 > tile_floats || tile_floats % 4 != 0 ||
      reinterpret_cast<uintptr_t>(stream_block) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t on = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto... args) {
    return any_hit ? launch_any_split<true>(b, k, on, args...) : launch_any_split<false>(b, k, on, args...);
  };
  const cudaError_t err =
      go(static_cast<const int32_t*>(cand), static_cast<const float*>(entry), static_cast<const float*>(stream_block), static_cast<const float*>(ox),
         static_cast<const float*>(oy), static_cast<const float*>(oz), static_cast<const float*>(dx),
         static_cast<const float*>(dy), static_cast<const float*>(dz), static_cast<const float*>(tm),
         static_cast<float*>(t_out), static_cast<int32_t*>(tri_out), static_cast<float*>(u_out),
         static_cast<float*>(v_out), kb, k, tile_floats);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Clusters (ray blocks) of the kernel the card holds at once at `k` slots a
// cluster with `split` lanes a ray, or minus the CUDA error.
extern "C" int phase2_stream_max_active_clusters(int k, int any_hit, int split) {
  if (k <= 0 || k > kMaxK || split < 1 || split > kMaxSplit) return -static_cast<int>(cudaErrorInvalidValue);
  if (any_hit) return split == 1 ? active_clusters<true, 1>(k) : active_clusters<true, 2>(k);
  return split == 1 ? active_clusters<false, 1>(k) : active_clusters<false, 2>(k);
}
