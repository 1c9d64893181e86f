// Möller-Trumbore over sort-joined (ray, super-cluster) pair chunks.
//
// Hand-written Hopper (sm_90a) port of the Pallas TPU kernel
// raytracer_tpu/ops/wave2_traverse.py::_mt_kernel.  It computes what that
// kernel computes, not how.
//
// Per chunk b with super id c = block_cluster[b]:
//   - c == Cs (sentinel): t = |tl|, tri = -1, u = v = 0, done = 0.
//   - otherwise done = (|tl| > 0).  For each row of 128 pairs, a sub-cluster
//     is opened for ALL pairs of the row when ANY pair overlaps its box with
//     bmin < |tl|; the opened subs' K triangles are then tested per pair.
//     The TPU kernel keeps a running best per triangle slot (tri row
//     s*K + g*8 + i updates slot i, strict t < best), parks the slot of an
//     any-hit lane (tl < 0) at t = 0 on a hit, and folds the 8 slots to the
//     least t, ties to the lowest tri id.  Filler lanes (tl == 0) never hit.
//
// What bounds it on the card: the float32 instruction rate, and before that
// the longest row.  A test is ~55 float operations and ~15 compares and
// selects on operands that never leave the SM; the bytes (4 KiB of geometry
// per opened sub at K = 64, 6 KiB of pair payloads and results per row) are
// small beside them.  The build keeps -fmad=false, so a multiply and its add
// are two instructions: the instruction bound is twice the operation bound.
// The work is uneven: a row opens 0 to 8 subs (4.5 on average in a render's
// window, and in nearly every chunk one row opens all 8), and a row's subs
// must be folded in order, so the kernel lasts at least as long as its
// slowest row.
//
// What the design does about it:
//   - One thread block of 128 threads per ROW, one pair per thread: rows x b2
//     small blocks (rows = CHUNK / 128, 8 at the default CHUNK of 1,024,
//     an argument of the launch) that the card's block scheduler hands out as SMs fall
//     free, so no warp waits on another row, and a row's 128 pairs advance
//     on four warps at once, which keeps the slowest row short.  (One warp
//     per row with four pairs a thread reads each triangle once for four
//     tests but makes the slowest row four times as long: it lost, see
//     PERF.md.)  48 registers a thread keep 40 warps on an SM.
//   - The row gate is one vote: each warp ORs its lanes' 8-bit result
//     (__any_sync per sub) into one shared word, one barrier, no barrier per
//     sub.
//   - Only the opened subs' geometry is read, as it lies in memory (K rows
//     of 64 bytes): 16-byte cp.async copies into a two-slot ring in shared
//     memory, the next opened sub in flight while this one is tested; a
//     triangle is then three 16-byte broadcast loads.
//   - One running best per pair instead of 8 slots: (t, tri, u, v) and a
//     mask of the slots that have reached the current t.  A slot above the
//     best t can never win the fold, and within a slot only the first
//     triangle at its least t counts, so t < best replaces the state and
//     restarts the mask, while t == best from a slot not yet in the mask
//     joins it and takes over when its tri id is lower.  An any-hit lane's
//     slots each keep their first hit below |tl|; the lowest id of those
//     wins and t reads 0.  With tri ids unique among the rows that are not
//     padding (the cluster build numbers them so) this gives the 8-slot
//     fold's answer with 5 registers instead of 32
//     (tests/test_torch_mt_ties.py holds it against the 8 slots on ties
//     within a slot, across slots and across subs).
//   - Rows of padding (tri id < 0) are skipped for the whole block.
//
// Built with -fmad=false and without fast math, so every product and sum
// rounds as the plain PyTorch twin's separate ops round them: the kernel and
// its twin agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;     // pairs per row == threads per block
constexpr int kMinBlocks = 10;  // blocks per SM the register budget allows for (48 registers)
constexpr int kSubs = 8;        // sub-clusters per super-cluster
constexpr int kGeomVecs = 4;    // 16-byte pieces per triangle row [v0.xyz, e1.xyz, e2.xyz, tri_id, pad]
constexpr int kBoxVecs = 2;     // 16-byte pieces per sub box [min.xyz, max.xyz, 0, 0]
constexpr float kTriEps = 1e-7f;
constexpr float kHitEps = 1e-4f;
constexpr float kTiny = 1e-12f;

// NaN-propagating min / max, as torch.minimum / jnp.minimum
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// slab-test inverse with the reference's 1e-12 floor
__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) > kTiny ? d : (d >= 0.0f ? kTiny : -kTiny);
  return 1.0f / s;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// waits until at most kPending of this thread's committed copy groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kLanes, kMinBlocks) wave2_mt_kernel(
    const int32_t* __restrict__ block_cluster, const float* __restrict__ super_geom,
    const float* __restrict__ super_sbox, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, const float* __restrict__ tl,
    float* __restrict__ t_out, int32_t* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int32_t* __restrict__ done_out, int rows, int cs, int k) {
  extern __shared__ float4 ring[];  // two slots of one sub's K triangle rows, 4 pieces each
  __shared__ unsigned row_open;
  const int c = block_cluster[blockIdx.x / rows];  // uniform over the block
  const size_t p = static_cast<size_t>(blockIdx.x) * kLanes + threadIdx.x;  // this thread's pair

  const float tls = tl[p];
  const bool rah = kAnyHit || tls < 0.0f;  // any-hit lane: occlusion query, limit |tl|
  const float rtl = fabsf(tls);
  if (c >= cs) {  // sentinel chunk: nothing to test
    t_out[p] = rtl;
    tri_out[p] = -1;
    u_out[p] = 0.0f;
    v_out[p] = 0.0f;
    done_out[p] = 0;
    return;
  }
  if (threadIdx.x == 0) row_open = 0;
  __syncthreads();
  const float rox = ox[p], roy = oy[p], roz = oz[p];
  const float rdx = dx[p], rdy = dy[p], rdz = dz[p];

  // row gate: sub s is tested for the whole row if any of its 128 pairs
  // touches the sub's box (filler lanes carry tl == 0 and never do)
  unsigned open = 0;
  {
    const float rix = safe_inv(rdx), riy = safe_inv(rdy), riz = safe_inv(rdz);
    const float4* sb = reinterpret_cast<const float4*>(super_sbox) + static_cast<size_t>(c) * kSubs * kBoxVecs;
    for (int s = 0; s < kSubs; ++s) {
      const float4 lo = __ldg(sb + s * kBoxVecs);      // min.xyz, max.x
      const float4 hi = __ldg(sb + s * kBoxVecs + 1);  // max.yz, 0, 0
      const float t1x = (lo.x - rox) * rix, t2x = (lo.w - rox) * rix;
      const float t1y = (lo.y - roy) * riy, t2y = (hi.x - roy) * riy;
      const float t1z = (lo.z - roz) * riz, t2z = (hi.y - roz) * riz;
      const float bmin = nmax(nmax(nmin(t1x, t2x), nmin(t1y, t2y)), nmin(t1z, t2z));
      const float bmax = nmin(nmin(nmax(t1x, t2x), nmax(t1y, t2y)), nmax(t1z, t2z));
      const bool hit = (bmax >= nmax(bmin, 0.0f)) && (bmin < rtl) && (rtl > 0.0f);
      if (__any_sync(0xffffffffu, hit)) open |= 1u << s;
    }
  }
  if ((threadIdx.x & 31) == 0 && open) atomicOr(&row_open, open);
  __syncthreads();
  open = row_open;

  // running best: bt stays |tl| on an any-hit lane (its slots park one by
  // one, recorded in `slots`), else the least t so far; `slots` marks the
  // triangle slots that have reached it
  float bt = rtl, btid = -1.0f, bu = 0.0f, bv = 0.0f;
  unsigned slots = 0;

  // the opened subs in order, each copied as it lies in memory (K rows of
  // 64 bytes) into one slot of the ring while the one before is tested
  const int nvec = k * kGeomVecs;
  const float4* geom = reinterpret_cast<const float4*>(super_geom) + static_cast<size_t>(c) * kSubs * nvec;
  auto fetch = [&](unsigned subs, int slot) {  // starts the copy of the lowest sub of `subs`, if any
    if (subs) {
      const float4* src = geom + (__ffs(subs) - 1) * nvec;
      for (int i = threadIdx.x; i < nvec; i += kLanes) cp_async16(ring + slot * nvec + i, src + i);
    }
    cp_async_commit();
  };
  fetch(open, 0);
  for (int slot = 0; open; slot ^= 1) {
    open &= open - 1;
    fetch(open, slot ^ 1);
    cp_async_wait<1>();  // all but the copy just started have landed
    __syncthreads();
    const float4* sub = ring + slot * nvec;
#pragma unroll 4
    for (int row = 0; row < k; ++row) {
      const float4 ga = sub[row * kGeomVecs];      // v0.xyz, e1.x
      const float4 gb = sub[row * kGeomVecs + 1];  // e1.yz, e2.xy
      const float4 gc = sub[row * kGeomVecs + 2];  // e2.z, tri id
      const float v0x = ga.x, v0y = ga.y, v0z = ga.z;
      const float e1x = ga.w, e1y = gb.x, e1z = gb.y;
      const float e2x = gb.z, e2y = gb.w, e2z = gc.x;
      const float tid = gc.y;
      if (!(tid >= 0.0f)) continue;  // a row of padding can never hit; uniform over the block
      const unsigned bit = 1u << (row & 7);
      const float px = rdy * e2z - rdz * e2y;
      const float py = rdz * e2x - rdx * e2z;
      const float pz = rdx * e2y - rdy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const bool okd = fabsf(det) > kTriEps;
      const float inv_det = 1.0f / (okd ? det : 1.0f);
      const float tx = rox - v0x, ty = roy - v0y, tz = roz - v0z;
      const float uu = (tx * px + ty * py + tz * pz) * inv_det;
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float vv = (rdx * qx + rdy * qy + rdz * qz) * inv_det;
      const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      if (okd && (uu >= 0.0f) && (vv >= 0.0f) && (uu + vv <= 1.0f) && (tt > kHitEps) && (tt <= bt)) {
        const bool below = tt < bt;  // else equal
        const bool seen = slots != 0;
        const bool fresh = !(slots & bit);
        // a closest lane: a lower t restarts the state
        const bool replace = below & !rah;
        // the slot reaches the state's t for the first time: an any-hit
        // lane's first hit in this slot, or a closest lane's equal t
        const bool join = fresh & (rah ? below : (!below & seen));
        const bool take = replace | (join & (!seen | (tid < btid)));
        if (!kAnyHit) {
          bu = take ? uu : bu;
          bv = take ? vv : bv;
        }
        btid = take ? tid : btid;
        bt = replace ? tt : bt;
        slots = replace ? bit : (join ? (slots | bit) : slots);
      }
    }
    __syncthreads();  // every thread is done with this slot before the next copy into it starts
  }

  const bool any = slots != 0;
  t_out[p] = any ? nmin(rah ? 0.0f : bt, rtl) : rtl;
  tri_out[p] = any ? static_cast<int32_t>(btid) : -1;
  u_out[p] = bu;
  v_out[p] = bv;
  done_out[p] = rtl > 0.0f ? 1 : 0;
}

}  // namespace

// Launches the kernel over b2 chunks of `rows` rows of 128 pairs on
// `stream`, one block a row; returns the CUDA error of the launch (0 =
// none).  Pair arrays and outputs are (b2, rows, 128) contiguous; super_geom (cs, 8k, 16) and super_sbox (cs, 8, 8) are f32,
// contiguous and 16-byte aligned; block_cluster is (b2,) int32.
extern "C" int wave2_mt_launch(const void* block_cluster, const void* super_geom,
                               const void* super_sbox, const void* ox, const void* oy,
                               const void* oz, const void* dx, const void* dy,
                               const void* dz, const void* tl, void* t_out, void* tri_out,
                               void* u_out, void* v_out, void* done_out, int b2, int rows,
                               int cs, int k, int any_hit, void* stream) {
  if (b2 <= 0) return 0;
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = 2 * static_cast<size_t>(k) * kGeomVecs * sizeof(float4);  // k <= 128: 16 KiB at most
  auto kernel = any_hit ? wave2_mt_kernel<true> : wave2_mt_kernel<false>;
  kernel<<<b2 * rows, kLanes, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(block_cluster), static_cast<const float*>(super_geom),
      static_cast<const float*>(super_sbox), static_cast<const float*>(ox),
      static_cast<const float*>(oy), static_cast<const float*>(oz),
      static_cast<const float*>(dx), static_cast<const float*>(dy),
      static_cast<const float*>(dz), static_cast<const float*>(tl),
      static_cast<float*>(t_out), static_cast<int32_t*>(tri_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<int32_t*>(done_out), rows, cs, k);
  return static_cast<int>(cudaGetLastError());
}
