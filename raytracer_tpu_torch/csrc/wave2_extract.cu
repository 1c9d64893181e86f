// Candidate extraction of the wave2 engine: for each ray, the first kc
// super-clusters in id order whose box it enters before its limit, above its
// cursor, and how many more there are.
//
// It replaces no Pallas kernel.  The JAX package computes this stage with
// XLA (raytracer_tpu/ops/wave2_traverse.py:116-160): a dense (rays x Cs) slab
// test, the hit matrix packed into 32-bit words by a bf16 matmul on the
// matrix unit, and a find-first-set loop over the words.  The port's plain
// twin, ops/wave2_traverse.py::p1_extract_reference, runs the slab test as
// elementwise tensors over (rays x Cs) blocks, then topk and a sum.
//
// Per ray r with limit |tl[r]| and cursor c[r], super s is a hit when, with
// inv = the slab inverse of the direction (1e-12 floor) and every product
// and difference rounded on its own,
//   tmin = max(max(min(t1x, t2x), min(t1y, t2y)), min(t1z, t2z)),
//   tmax = min(min(max(t1x, t2x), max(t1y, t2y)), max(t1z, t2z)),
//   t1 = (box.min - o) * inv, t2 = (box.max - o) * inv,
//   ent = max(tmin, 0):  tmax >= ent, ent < |tl|, and s > c,
// min and max propagating NaN as torch.minimum / torch.maximum do.
//   cand[r, 0:kc] = the first kc hit ids, ascending, padded with Cs;
//   rem[r]        = max(hits - kc, 0).
// That is the twin's topk(largest=False, sorted=True) and its clamped count,
// bit for bit.
//
// What bounds it on the card: operations.  A box test is 25 float
// operations on 24 bytes of box that every ray of a launch shares; the rays
// and the outputs are 32 + 4 (kc + 1) bytes a ray.  The hit matrix is one
// bit a test and is what the plain version carries through device memory,
// as a float, bool or int32 tensor per elementwise step.
//
// What the design does about it:
//   - One warp per ray.  Each step the 32 lanes test 32 consecutive supers
//     against the ray (its data is the same in every lane), __ballot_sync
//     gives the step's word of the hit matrix, __popc of it adds to the
//     count, and a lane whose bit is set writes its id to cand[r, found +
//     popc(word & lanes below it)] while that slot is below kc.  The hit
//     matrix never leaves the registers, no candidate is held in a register
//     array (any kc works), and a 16,384-ray continuation round still gives
//     the card 16,384 warps.
//   - The walk starts at the word that holds cursor + 1, so a continuation
//     round tests only the supers above its cursor; a ray with no limit
//     (padding, tl = 0) tests nothing.
//   - The boxes are staged in shared memory as three planes of (min, max)
//     pairs, one per axis: a lane reads its box with three 8-byte loads,
//     and a warp's load is 256 consecutive bytes, free of bank conflicts.
//     Up to kMaxTile boxes are staged at once; a larger Cs is walked tile by
//     tile.  The ids past Cs in the last tile are NaN boxes, which no ray
//     enters.
//   - The grid holds as many blocks as the card keeps resident, and each
//     warp walks ray after ray: a block stages its boxes once for all of
//     its rays when Cs fits one tile (the hall's 1,563 supers take 37.5
//     KiB).
//   - min.NaN / max.NaN give the NaN-propagating min and max in one
//     instruction each.
//
// Built with -fmad=false and without fast math, so every product and
// difference rounds as the plain twin's separate ops round them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;            // threads a block
constexpr int kWarps = kThreads / 32;    // rays a block has in flight, one a warp
constexpr int kMinBlocks = 3;            // 1,536 threads an SM: at most 40 registers a thread
constexpr int kMaxTile = 4096;           // boxes staged at a time: 96 KiB of shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = 1e-12f;

// NaN-propagating min / max, as torch.minimum / torch.maximum
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// slab-test inverse with the reference's 1e-12 floor
__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) > kTiny ? d : (d >= 0.0f ? kTiny : -kTiny);
  return 1.0f / s;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) wave2_extract_kernel(
    const float* __restrict__ box, const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, const float* __restrict__ tl, const int32_t* __restrict__ cursor,
    int32_t* __restrict__ cand, int32_t* __restrict__ rem, int n, int cs, int kc, int tile) {
  extern __shared__ float2 planes[];  // (min, max) of x, then of y, then of z: `tile` each
  float2* const px = planes;
  float2* const py = planes + tile;
  float2* const pz = planes + 2 * tile;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  int staged = -1;                           // the tile now in shared memory

  for (int base = blockIdx.x * kWarps; base < n; base += gridDim.x * kWarps) {  // uniform over the block
    const int r = base + (threadIdx.x >> 5);
    float rox = 0.0f, roy = 0.0f, roz = 0.0f, rix = 0.0f, riy = 0.0f, riz = 0.0f, lim = 0.0f;
    int lo = cs;  // the least id above the cursor
    if (r < n) {
      rox = ox[r], roy = oy[r], roz = oz[r];
      rix = safe_inv(dx[r]), riy = safe_inv(dy[r]), riz = safe_inv(dz[r]);
      lim = fabsf(tl[r]);  // tl's sign marks an any-hit ray; the limit is |tl|
      lo = static_cast<int>(min(max(static_cast<long long>(cursor[r]) + 1, 0LL), static_cast<long long>(cs)));
    }
    // ent >= 0 (or NaN), so a ray whose limit is not above 0 enters nothing
    const bool work = lim > 0.0f && lo < cs;  // uniform over the warp
    int found = 0;                            // hits so far, uniform over the warp

    for (int t0 = 0; t0 < cs; t0 += tile) {
      if (t0 != staged) {  // uniform over the block
        __syncthreads();   // nobody still reads the tile before
        const int m = min(tile, cs - t0);
        for (int i = threadIdx.x; i < tile; i += kThreads) {
          float2 x = make_float2(__int_as_float(0x7fc00000), __int_as_float(0x7fc00000));
          float2 y = x, z = x;
          if (i < m) {
            const float* b = box + static_cast<size_t>(t0 + i) * 6;  // min.xyz, max.xyz
            x = make_float2(b[0], b[3]);
            y = make_float2(b[1], b[4]);
            z = make_float2(b[2], b[5]);
          }
          px[i] = x, py[i] = y, pz[i] = z;
        }
        __syncthreads();
        staged = t0;
      }
      if (!work) continue;
      const int t1 = min(t0 + tile, cs);
      for (int w = max(lo, t0) & ~31; w < t1; w += 32) {  // tile is a multiple of 32, so t0 is a word's start
        const int id = w + lane;
        const int j = id - t0;
        const float2 bx = px[j], by = py[j], bz = pz[j];
        const float t1x = (bx.x - rox) * rix, t2x = (bx.y - rox) * rix;
        const float t1y = (by.x - roy) * riy, t2y = (by.y - roy) * riy;
        const float t1z = (bz.x - roz) * riz, t2z = (bz.y - roz) * riz;
        const float tmin = nmax(nmax(nmin(t1x, t2x), nmin(t1y, t2y)), nmin(t1z, t2z));
        const float tmax = nmin(nmin(nmax(t1x, t2x), nmax(t1y, t2y)), nmax(t1z, t2z));
        const float ent = nmax(tmin, 0.0f);
        const bool hit = (tmax >= ent) & (ent < lim) & (id >= lo);
        const unsigned word = __ballot_sync(kFull, hit);
        if (hit) {
          const int slot = found + __popc(word & below);
          if (slot < kc) cand[static_cast<size_t>(r) * kc + slot] = id;
        }
        found += __popc(word);
      }
    }
    if (r < n) {
      for (int slot = found + lane; slot < kc; slot += 32) cand[static_cast<size_t>(r) * kc + slot] = cs;
      if (lane == 0) rem[r] = max(found - kc, 0);
    }
  }
}

int g_tile = -1, g_grid = 0;  // the grid last computed, for the tile it was computed for

}  // namespace

// Launches the extraction of n rays against cs super-cluster boxes on
// `stream`; returns the CUDA error of the launch (0 = none).  box is (cs, 6)
// f32 [min.xyz, max.xyz]; ox .. tl are (n,) f32 and cursor (n,) int32; cand
// is (n, kc) int32 and rem (n,) int32; all contiguous.
extern "C" int wave2_extract_launch(const void* box, const void* ox, const void* oy, const void* oz,
                                    const void* dx, const void* dy, const void* dz, const void* tl,
                                    const void* cursor, void* cand, void* rem, int n, int cs, int kc,
                                    void* stream) {
  if (n <= 0) return 0;
  if (cs <= 0 || kc <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = min((cs + 31) & ~31, kMaxTile);
  const size_t shmem = static_cast<size_t>(tile) * 3 * sizeof(float2);
  if (tile != g_tile) {
    cudaError_t err = cudaFuncSetAttribute(wave2_extract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(shmem));
    int device = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wave2_extract_kernel, kThreads, shmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_grid = max(sms * per_sm, 1);
    g_tile = tile;
  }
  const int grid = min((n + kWarps - 1) / kWarps, g_grid);
  wave2_extract_kernel<<<grid, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(box), static_cast<const float*>(ox), static_cast<const float*>(oy),
      static_cast<const float*>(oz), static_cast<const float*>(dx), static_cast<const float*>(dy),
      static_cast<const float*>(dz), static_cast<const float*>(tl), static_cast<const int32_t*>(cursor),
      static_cast<int32_t*>(cand), static_cast<int32_t*>(rem), n, cs, kc, tile);
  return static_cast<int>(cudaGetLastError());
}
