// Phase 2 of the block-candidate traversal over a (B, kb) candidate table,
// every candidate visited or skipped.
//
// Hand-written Hopper (sm_90a) port of the Pallas TPU kernel
// raytracer_tpu/ops/pallas_traverse.py::_phase2_kernel (launched by
// _pallas_closest_hit_padded and by _pallas_sorted_closest_hit).  It computes
// what that kernel computes, not how.  The TPU kernel runs a (B, kb) grid
// whose steps execute in order on one core and carry (t, tri, u, v) in the
// revisited output block from one candidate j to the next; CUDA blocks run in
// parallel and carry nothing, so the candidate loop runs inside the threads
// that own the ray block and the running best stays in registers until the
// single write at the end.
//
// Per ray block b, for j = 0 .. kb-1 in table order:
//   live = entry[b, j] < max over ALL 1,024 rays of the running t (pad rays
//   included: they carry t = tm = 0); a dead step is skipped, a live one
//   tests cluster cand[b, j]'s K triangles, slot by slot, against every ray
//   with strict t < best_t and tid >= 0.
//
// What bounds it on the card: the float32 instruction rate (-fmad=false: a
// multiply and its add are two, about 75 a test) over the live steps, which are
// sequential within a ray block, so the ray block with the most live steps
// sets the time; at the dense table three steps in four are dead.
//
// What the design does about it (the shared pieces are in mt_test.cuh):
//   - A ray block is a cluster of 8 thread blocks, at most 64 registers a
//     thread, so that the block scheduler balances uneven ray blocks; two
//     lanes share a ray and fold half of a candidate's slots each, which
//     halves the sequential unit (one lane a ray where two would push the
//     launch into a second wave, pick_split).
//   - Dead steps cost no barrier.  The max of t changes only in a live step,
//     so it is exchanged once after each (one cluster barrier), and the next
//     live step is found by a ballot over 32 staged entries at a time.  The
//     max never rises, so a step that is dead now stays dead: exactly the
//     live steps of the plain version run, in order.
//   - The next live candidate under the CURRENT max is fetched by the
//     bulk-copy engine (geometry and ids, one mbarrier) while this one is
//     tested, into the other of two slots.  If the new max kills it, its tile
//     is waited for and dropped, and the scan goes on from there.
//   - The test is straight-line (selects, the division's fast path spelled
//     out, four slots from nine 16-byte loads).
//
// Built with -fmad=false and without fast math so that the kernel and its
// plain PyTorch version (ops/pallas_traverse.py::phase2_grid_reference) agree
// bit for bit.

#include "mt_test.cuh"

namespace {

using namespace rt;

// floats from one ring slot to the next: 9k of geometry, k ids, 128-byte aligned
__host__ __device__ constexpr int slot_floats(int k) { return (10 * k + 31) & ~31; }

template <int kSplit>
__global__ void __launch_bounds__(Shape<kSplit>::kThreads, Shape<kSplit>::kMinBlocks) phase2_grid_kernel(
    const int32_t* __restrict__ cand, const float* __restrict__ entry,
    const float* __restrict__ tri_block, const int32_t* __restrict__ tri_id,
    const float* __restrict__ ox, const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tm, float* __restrict__ t_out, int32_t* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out, int kb, int k) {
  extern __shared__ __align__(128) float s_ring[];  // two slots: [0:9k) geometry, [9k:10k) ids
  __shared__ __align__(8) uint64_t s_bar[2];
  __shared__ __align__(8) Exchange s_x;
  __shared__ float s_entry[kChunk];
  __shared__ int32_t s_cand[kChunk];

  const uint32_t rank = cluster_rank();
  const size_t block = blockIdx.x / kCluster;
  const size_t p = block * kBlockRays + (rank * Shape<kSplit>::kThreads + threadIdx.x) / kSplit;  // this thread's ray
  const int sub = threadIdx.x % kSplit;                                            // and its place among the ray's lanes
  const size_t row = block * kb;
  const int lane = threadIdx.x & 31;
  const Ray r = {ox[p], oy[p], oz[p], dx[p], dy[p], dz[p]};
  Best<int32_t> best = {tm[p], -1, 0.0f, 0.0f};
  const int stride = slot_floats(k);

  if (threadIdx.x == 0) {
    mbar_init(&s_bar[0], 1);
    mbar_init(&s_bar[1], 1);
    mbar_init_fence();
  }
  int base = 0;
  stage_row(cand, entry, row, kb, base, kChunk, s_entry, s_cand);  // its barriers publish s_bar too
  cluster_sync();  // every block of the cluster runs before a peer writes into its shared memory

  // The first j >= from with entry[b, j] < m, or kb; its entry goes to `e`.
  // Every warp scans alike, so the result is uniform; the staged chunk moves
  // forward with the scan.
  auto next_live = [&](int from, float m, float& e) {
    while (from < kb) {
      if (from >= base + kChunk) {
        base = from;
        stage_row(cand, entry, row, kb, base, kChunk, s_entry, s_cand);
      }
      const int o = from - base + lane;
      const float mine = o < kChunk ? s_entry[o] : pos_inf();
      const unsigned live = __ballot_sync(kFull, mine < m);
      if (live) {
        const int first = __ffs(live) - 1;
        e = __shfl_sync(kFull, mine, first);
        return from + first;
      }
      from = min(from + 32, base + kChunk);
    }
    return kb;
  };
  // thread 0 asks for candidate j's geometry and ids (j is in the staged chunk)
  auto fetch = [&](int j, int slot) {
    if (threadIdx.x == 0 && j < kb) {
      const size_t c = static_cast<size_t>(s_cand[j - base]);
      float* dst = s_ring + slot * stride;
      mbar_expect(&s_bar[slot], static_cast<uint32_t>(k) * 40u);
      bulk_load(dst, tri_block + c * k * 9, static_cast<uint32_t>(k) * 36u, &s_bar[slot]);
      bulk_load(dst + 9 * k, tri_id + c * k, static_cast<uint32_t>(k) * 4u, &s_bar[slot]);
    }
  };
  uint32_t phases = 0;  // bit s: the parity of slot s's next phase
  auto wait_tile = [&](int slot) {
    mbar_wait(&s_bar[slot], (phases >> slot) & 1u);
    phases ^= 1u << slot;
  };
  int exchanges = 0;
  auto block_max = [&]() {
    bool unused;
    exchange_post<kSplit>(&s_x, exchanges & 1, rank, best.t, false);
    const float m = exchange_read<kSplit>(&s_x, exchanges & 1, unused);
    ++exchanges;
    return m;
  };

  float m = block_max();
  float e_next = 0.0f;
  int slot = 0;
  int cur = next_live(0, m, e_next);
  fetch(cur, slot);
  while (cur < kb) {
    // the next live step if this one leaves the max as it is
    int next = next_live(cur + 1, m, e_next);
    fetch(next, slot ^ 1);
    wait_tile(slot);
    const float* geom = s_ring + slot * stride;
    test_slots<false, kSplit>(geom, reinterpret_cast<const int32_t*>(geom + 9 * k), k, sub, r, best);
    // its barrier also says that every thread of this block is done with the
    // slot, which the fetch after next may fill
    m = block_max();
    while (next < kb && !(e_next < m)) {  // the new max killed the step that was fetched
      wait_tile(slot ^ 1);
      __syncthreads();  // every thread has seen that phase before thread 0 arms the barrier again
      next = next_live(next + 1, m, e_next);
      fetch(next, slot ^ 1);
    }
    cur = next;
    slot ^= 1;
  }

  if (sub == 0) {
    t_out[p] = best.t;
    tri_out[p] = best.tri;
    u_out[p] = best.u;
    v_out[p] = best.v;
  }
  cluster_sync();  // no block exits while a peer may still write into it
}

size_t ring_bytes(int k) { return 2 * static_cast<size_t>(slot_floats(k)) * sizeof(float); }

template <int kSplit>
int active_clusters(int k) {
  return max_active_clusters(phase2_grid_kernel<kSplit>, Shape<kSplit>::kThreads, ring_bytes(k));
}

template <int kSplit, typename... Args>
cudaError_t launch(int b, int k, cudaStream_t stream, Args... args) {
  ClusterLaunch shape(b, Shape<kSplit>::kThreads, ring_bytes(k), stream);
  return cudaLaunchKernelEx(&shape.cfg, phase2_grid_kernel<kSplit>, args...);
}

}  // namespace

// Launches the kernel over b ray blocks on `stream`; returns the CUDA error
// of the launch (0 = none).  cand (b, kb) int32 and entry (b, kb) f32;
// tri_block (C, k*9) f32 and tri_id (C, k) int32, both 16-byte aligned, with
// k <= 128 a multiple of 4 (the copy engine moves 16 bytes at a time); cand
// holds valid cluster ids in every slot; ray arrays and outputs (b, 8, 128)
// contiguous.
extern "C" int phase2_grid_launch(const void* cand, const void* entry, const void* tri_block,
                                  const void* tri_id, const void* ox, const void* oy,
                                  const void* oz, const void* dx, const void* dy, const void* dz,
                                  const void* tm, void* t_out, void* tri_out, void* u_out,
                                  void* v_out, int b, int kb, int k, void* stream) {
  if (b <= 0) return 0;
  if (k <= 0 || k > kMaxK || k % 4 != 0 || kb <= 0 || reinterpret_cast<uintptr_t>(tri_block) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(tri_id) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static int fit[kMaxSplit][kMaxK + 1];  // clusters the card holds at once, asked once per k
  if (fit[0][k] == 0) {
    fit[0][k] = active_clusters<1>(k);
    fit[1][k] = active_clusters<2>(k);
  }
  const cudaStream_t on = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto... args) {
    return pick_split(b, fit[0][k], fit[1][k]) == 1 ? launch<1>(b, k, on, args...) : launch<2>(b, k, on, args...);
  };
  const cudaError_t err =
      go(static_cast<const int32_t*>(cand), static_cast<const float*>(entry), static_cast<const float*>(tri_block),
         static_cast<const int32_t*>(tri_id), static_cast<const float*>(ox), static_cast<const float*>(oy),
         static_cast<const float*>(oz), static_cast<const float*>(dx), static_cast<const float*>(dy),
         static_cast<const float*>(dz), static_cast<const float*>(tm), static_cast<float*>(t_out),
         static_cast<int32_t*>(tri_out), static_cast<float*>(u_out), static_cast<float*>(v_out), kb, k);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Clusters (ray blocks) of the kernel the card holds at once at `k` slots a
// cluster with `split` lanes a ray, or minus the CUDA error.
extern "C" int phase2_grid_max_active_clusters(int k, int split) {
  if (k <= 0 || k > kMaxK || split < 1 || split > kMaxSplit) return -static_cast<int>(cudaErrorInvalidValue);
  return split == 1 ? active_clusters<1>(k) : active_clusters<2>(k);
}
