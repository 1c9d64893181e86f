// Möller-Trumbore over sort-joined (ray, super-cluster) pair chunks.
//
// Hand-written Hopper (sm_90a) port of the Pallas TPU kernel
// raytracer_tpu/ops/wave2_traverse.py::_mt_kernel.  It computes what that
// kernel computes, not how: one thread block of 128 threads per 1024-pair
// chunk, looping over the chunk's 8 rows of 128 pairs; thread j owns pair j
// of every row.
//
// Per chunk b with super id c = block_cluster[b]:
//   - c == Cs (sentinel): t = |tl|, tri = -1, u = v = 0, done = 0.
//   - otherwise done = (|tl| > 0).  For each row, a sub-cluster is opened for
//     ALL 128 pairs of the row when ANY pair overlaps its box with
//     bmin < |tl| (block-wide vote, __syncthreads_or); the opened subs' K
//     triangles are then tested per pair.  The running best is kept per
//     triangle slot (tri row s*K + g*8 + i updates slot i, strict t < bt),
//     any-hit lanes (tl < 0) collapse the slot's t to 0 on a hit, and the
//     8 slots fold to the least t, ties to the lowest tri id.  Filler lanes
//     (tl == 0) can never hit.
//
// Bound on the card: arithmetic.  Each opened (pair, triangle) test is ~40
// fp32 operations on operands that are broadcast from shared memory, so the
// bytes per chunk (20 KiB of geometry at K = 64, 28 KiB of pair payloads
// and 20 KiB of results) are small next to the 128 threads x up to 512
// triangles x 8 rows of tests.  The design keeps every test's operands out
// of device memory: the super's 8*K*10 used floats are staged once per
// block in shared memory, component-major, so all 128 threads read the same
// address (a broadcast, no bank conflicts), and each thread keeps its 8
// slots in registers.  The row vote culls sub-clusters exactly where the
// TPU kernel does, which keeps the tri ids bit-equal to the reference.
//
// Built with -fmad=false and without fast math, so every product and sum
// rounds as the plain PyTorch twin's separate ops round them: the kernel and
// its twin agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;         // rows of 128 pairs per 1024-pair chunk
constexpr int kLanes = 128;      // pairs per row == threads per block
constexpr int kSubs = 8;         // sub-clusters per super-cluster
constexpr int kGeomLanes = 16;   // [v0.xyz, e1.xyz, e2.xyz, tri_id, pad]
constexpr int kUsed = 10;        // geometry lanes the test reads
constexpr int kBoxLanes = 8;     // sub box lanes [min.xyz, max.xyz, 0, 0]
constexpr float kTriEps = 1e-7f;
constexpr float kHitEps = 1e-4f;
constexpr float kTiny = 1e-12f;
constexpr float kBig = 3.0e38f;

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

template <bool kAnyHit>
__global__ void __launch_bounds__(kLanes) wave2_mt_kernel(
    const int32_t* __restrict__ block_cluster, const float* __restrict__ super_geom,
    const float* __restrict__ super_sbox, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, const float* __restrict__ tl,
    float* __restrict__ t_out, int32_t* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int32_t* __restrict__ done_out, int cs, int k) {
  extern __shared__ float smem[];
  const int j = threadIdx.x;
  const int c = block_cluster[blockIdx.x];  // uniform over the block
  const size_t base = static_cast<size_t>(blockIdx.x) * kRows * kLanes;

  if (c >= cs) {  // sentinel chunk: nothing to test
    for (int r = 0; r < kRows; ++r) {
      const size_t p = base + r * kLanes + j;
      t_out[p] = fabsf(tl[p]);
      tri_out[p] = -1;
      u_out[p] = 0.0f;
      v_out[p] = 0.0f;
      done_out[p] = 0;
    }
    return;
  }

  // stage the super's geometry component-major: sg[comp * nrow + row]
  const int nrow = kSubs * k;
  float* sg = smem;
  float* sb = smem + kUsed * nrow;  // sb[s * 6 + comp]
  const float* g = super_geom + static_cast<size_t>(c) * nrow * kGeomLanes;
  for (int i = j; i < nrow * kUsed; i += kLanes) {
    const int row = i / kUsed, comp = i - row * kUsed;
    sg[comp * nrow + row] = g[row * kGeomLanes + comp];
  }
  if (j < kSubs * 6) {
    const int s = j / 6, comp = j - s * 6;
    sb[j] = super_sbox[(static_cast<size_t>(c) * kSubs + s) * kBoxLanes + comp];
  }
  __syncthreads();

  for (int r = 0; r < kRows; ++r) {
    const size_t p = base + r * kLanes + j;
    const float rox = ox[p], roy = oy[p], roz = oz[p];
    const float rdx = dx[p], rdy = dy[p], rdz = dz[p];
    const float tls = tl[p];
    const bool rah = tls < 0.0f;  // any-hit lane: occlusion query, limit |tl|
    const float rtl = fabsf(tls);
    const bool rmask = rtl > 0.0f;  // filler / pad lanes carry tl == 0
    const float rix = safe_inv(rdx), riy = safe_inv(rdy), riz = safe_inv(rdz);

    // row gate: sub s is tested for the whole row if any pair touches it
    unsigned open = 0;
    for (int s = 0; s < kSubs; ++s) {
      const float* bs = sb + s * 6;
      const float t1x = (bs[0] - rox) * rix, t2x = (bs[3] - rox) * rix;
      const float t1y = (bs[1] - roy) * riy, t2y = (bs[4] - roy) * riy;
      const float t1z = (bs[2] - roz) * riz, t2z = (bs[5] - roz) * riz;
      const float bmin = nmax(nmax(nmin(t1x, t2x), nmin(t1y, t2y)), nmin(t1z, t2z));
      const float bmax = nmin(nmin(nmax(t1x, t2x), nmax(t1y, t2y)), nmax(t1z, t2z));
      const int hit = (bmax >= nmax(bmin, 0.0f)) && (bmin < rtl) && rmask;
      if (__syncthreads_or(hit)) open |= 1u << s;
    }

    float bt[8], btid[8], bu[8], bv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      bt[i] = rtl;
      btid[i] = -1.0f;
      bu[i] = 0.0f;
      bv[i] = 0.0f;
    }

    for (int s = 0; s < kSubs; ++s) {
      if (!((open >> s) & 1u)) continue;
      for (int g8 = 0; g8 < k; g8 += 8) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = s * k + g8 + i;
          const float v0x = sg[0 * nrow + row], v0y = sg[1 * nrow + row], v0z = sg[2 * nrow + row];
          const float e1x = sg[3 * nrow + row], e1y = sg[4 * nrow + row], e1z = sg[5 * nrow + row];
          const float e2x = sg[6 * nrow + row], e2y = sg[7 * nrow + row], e2z = sg[8 * nrow + row];
          const float tid = sg[9 * nrow + row];
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
          const bool hit = okd && (uu >= 0.0f) && (vv >= 0.0f) && (uu + vv <= 1.0f) &&
                           (tt > kHitEps) && (tid >= 0.0f) && (tt < bt[i]);
          if (hit) {
            if (kAnyHit) {
              bt[i] = 0.0f;
              btid[i] = tid;
            } else {
              bt[i] = rah ? 0.0f : tt;
              btid[i] = tid;
              bu[i] = uu;
              bv[i] = vv;
            }
          }
        }
      }
    }

    // fold the 8 slots: least t, then the lowest tri id, then its u, v
    float t_row = kBig;
#pragma unroll
    for (int i = 0; i < 8; ++i) t_row = nmin(t_row, btid[i] >= 0.0f ? bt[i] : kBig);
    float tid_row = kBig;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool w = btid[i] >= 0.0f && bt[i] == t_row;
      tid_row = nmin(tid_row, w ? btid[i] : kBig);
    }
    float u_row = -kBig, v_row = -kBig;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool w = btid[i] >= 0.0f && bt[i] == t_row && btid[i] == tid_row;
      u_row = nmax(u_row, w ? bu[i] : -kBig);
      v_row = nmax(v_row, w ? bv[i] : -kBig);
    }
    const bool any_row = tid_row < kBig;
    t_out[p] = any_row ? nmin(t_row, rtl) : rtl;
    tri_out[p] = any_row ? static_cast<int32_t>(tid_row) : -1;
    u_out[p] = any_row ? u_row : 0.0f;
    v_out[p] = any_row ? v_row : 0.0f;
    done_out[p] = rmask ? 1 : 0;
  }
}

}  // namespace

// Launches the kernel over b2 chunks on `stream`; returns cudaGetLastError().
// Pair arrays and outputs are (b2, 8, 128) contiguous; super_geom is
// (cs, 8k, 16) and super_sbox (cs, 8, 8) f32; block_cluster (b2,) int32.
extern "C" int wave2_mt_launch(const void* block_cluster, const void* super_geom,
                               const void* super_sbox, const void* ox, const void* oy,
                               const void* oz, const void* dx, const void* dy,
                               const void* dz, const void* tl, void* t_out, void* tri_out,
                               void* u_out, void* v_out, void* done_out, int b2, int cs,
                               int k, int any_hit, void* stream) {
  if (b2 <= 0) return 0;
  // k <= 128 (checked by the wrapper) keeps this under the 48 KB default
  const size_t shmem = static_cast<size_t>(kUsed * kSubs * k + kSubs * 6) * sizeof(float);
  auto kernel = any_hit ? wave2_mt_kernel<true> : wave2_mt_kernel<false>;
  kernel<<<b2, kLanes, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(block_cluster), static_cast<const float*>(super_geom),
      static_cast<const float*>(super_sbox), static_cast<const float*>(ox),
      static_cast<const float*>(oy), static_cast<const float*>(oz),
      static_cast<const float*>(dx), static_cast<const float*>(dy),
      static_cast<const float*>(dz), static_cast<const float*>(tl),
      static_cast<float*>(t_out), static_cast<int32_t*>(tri_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<int32_t*>(done_out), cs, k);
  return static_cast<int>(cudaGetLastError());
}
