// The skip-link BVH walk: closest hit and any-hit, one thread a ray.
//
// A hand-written Hopper (sm_90a) kernel for a stage that the JAX package
// runs as plain XLA, not as a Pallas kernel:
// raytracer_tpu/ops/bvh_traverse.py::_bvh_closest_hit_impl and
// _bvh_any_hit_impl, a lock-step walk of the whole wavefront in chunks of 16
// steps.  In plain PyTorch that walk costs about 100 small launches a step
// and thousands of steps a query; here each ray walks on its own.
//
// Per ray: octant = sign bits of the direction; node = 0; best t = the
// ray's limit.  A step reads the node's packed row (packed_nodes[octant * M
// + node], 9 floats: box min, box max, then leaf row, hit link and miss link
// as int32 bit patterns), slab-tests the box against the running best t,
// and, when the box is hit at a leaf, runs Möller-Trumbore on the leaf's 4
// slots in order j = 0..3 (leaf_geom rows of 40 floats: 4 x (v0, e1, e2),
// then 4 int32 triangle ids, -1 for a pad).  Closest hit keeps a strict
// t < best; any-hit stops at the first hit below the limit.  Then the hit
// link (box hit) or the miss link (box missed) names the next node; -1 ends
// the walk.  A ray takes at most `budget` steps, the reference's chunked
// loop's count, and returns what it has found by then.
//
// What bounds it on the card: per step a 36-byte node row and, at a leaf,
// a 160-byte leaf row, read from device memory (or L2) at an address that
// depends on the previous step.  So a step's latency, not the card's
// arithmetic or its memory rate, sets the time: each ray walks a dependent
// chain of loads, and the card hides it only by holding many rays at once.
// The operation bound (25 float operations a box, 55 a triangle test) and
// the byte bound (36 B a visit, 160 B a leaf) are both well below what a
// divergent chain of dependent loads achieves.
//
// What the design does about it: the simplest kernel that is right.  One
// thread a ray and small blocks of 128 threads, so that the block scheduler
// keeps every SM full while the longest rays finish; no shared memory, few
// registers (the leaf row is 10 16-byte loads into registers), so that many
// warps are resident to overlap their loads.  Persistent threads, ray
// sorting and treelets in shared memory are left for a later change.
//
// Built with -fmad=false and without fast math: every product and sum
// rounds on its own, in the order of the plain PyTorch twin
// (ops/bvh_traverse.py::bvh_walk_reference); min and max propagate NaN as
// torch.minimum / torch.maximum do; the reciprocal floor is the reference's
// 1e-20.  Kernel and twin agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // rays per thread block
constexpr int kLeafSize = 4;     // triangle slots per leaf
constexpr int kNodeFloats = 9;   // floats per packed node row
constexpr int kLeafVecs = 10;    // 16-byte pieces per 40-float leaf row
constexpr float kTriEps = 1e-7f;
constexpr float kHitEps = 1e-4f;
constexpr float kTiny = 1e-20f;  // the walk's reciprocal floor (the reference's _safe_inv)
constexpr float kBig = 3.0e38f;  // t of a miss

// NaN-propagating min / max, as torch.minimum / torch.maximum
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) > kTiny ? d : (d >= 0.0f ? kTiny : -kTiny);
  return 1.0f / s;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float* __restrict__ packed, const float4* __restrict__ leaf_geom, int m,
                int budget, const float* __restrict__ ox_, const float* __restrict__ oy_,
                const float* __restrict__ oz_, const float* __restrict__ dx_,
                const float* __restrict__ dy_, const float* __restrict__ dz_,
                const float* __restrict__ tm_, float* __restrict__ t_out,
                int32_t* __restrict__ tri_out, float* __restrict__ u_out,
                float* __restrict__ v_out, int32_t* __restrict__ occ_out,
                int32_t* __restrict__ steps_out, int n) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const float ox = ox_[r], oy = oy_[r], oz = oz_[r];
  const float dx = dx_[r], dy = dy_[r], dz = dz_[r];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const int octant = (dx < 0.0f ? 1 : 0) + 2 * (dy < 0.0f ? 1 : 0) + 4 * (dz < 0.0f ? 1 : 0);
  const float* rows = packed + static_cast<size_t>(octant) * m * kNodeFloats;

  float bt = tm_[r];  // closest: the running best t; any-hit: the limit
  int32_t btri = -1;
  float bu = 0.0f, bv = 0.0f;
  bool occluded = false;
  int node = 0;
  int steps = 0;
  while (node >= 0 && steps < budget) {
    const float* row = rows + static_cast<size_t>(node) * kNodeFloats;
    const float bx0 = __ldg(row + 0), by0 = __ldg(row + 1), bz0 = __ldg(row + 2);
    const float bx1 = __ldg(row + 3), by1 = __ldg(row + 4), bz1 = __ldg(row + 5);
    const int leaf_row = __float_as_int(__ldg(row + 6));
    const int hit_next = __float_as_int(__ldg(row + 7));
    const int miss_next = __float_as_int(__ldg(row + 8));

    const float t1x = (bx0 - ox) * ix, t2x = (bx1 - ox) * ix;
    const float t1y = (by0 - oy) * iy, t2y = (by1 - oy) * iy;
    const float t1z = (bz0 - oz) * iz, t2z = (bz1 - oz) * iz;
    const float tmin = nmax(nmax(nmin(t1x, t2x), nmin(t1y, t2y)), nmin(t1z, t2z));
    const float tmax = nmin(nmin(nmax(t1x, t2x), nmax(t1y, t2y)), nmax(t1z, t2z));
    const bool hit_box = (tmax >= nmax(tmin, 0.0f)) && (tmin < bt);

    if (hit_box && leaf_row >= 0) {
      float g[kLeafVecs * 4];
      const float4* src = leaf_geom + static_cast<size_t>(leaf_row) * kLeafVecs;
#pragma unroll
      for (int q = 0; q < kLeafVecs; ++q) {
        const float4 p = __ldg(src + q);
        g[4 * q] = p.x;
        g[4 * q + 1] = p.y;
        g[4 * q + 2] = p.z;
        g[4 * q + 3] = p.w;
      }
#pragma unroll
      for (int j = 0; j < kLeafSize; ++j) {
        const float* tri = g + 9 * j;
        const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
        const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
        const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
        const int32_t tid = __float_as_int(g[36 + j]);
        // pvec = d x e2, det = e1 . pvec
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool ok = fabsf(det) > kTriEps;
        const float inv_det = 1.0f / (ok ? det : 1.0f);
        const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
        const float uu = (tx * px + ty * py + tz * pz) * inv_det;
        // qvec = tvec x e1
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float vv = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool hit = ok && (uu >= 0.0f) && (vv >= 0.0f) && (uu + vv <= 1.0f) && (tt > kHitEps);
        if (hit && tid >= 0 && tt < bt) {
          if (kAnyHit) {
            occluded = true;
          } else {
            bt = tt;
            btri = tid;
            bu = uu;
            bv = vv;
          }
        }
      }
    }
    node = hit_box ? hit_next : miss_next;
    if (kAnyHit && occluded) node = -1;  // an occluded ray parks
    ++steps;
  }

  if (kAnyHit) {
    occ_out[r] = occluded ? 1 : 0;
  } else {
    t_out[r] = btri < 0 ? kBig : bt;
    tri_out[r] = btri;
    u_out[r] = bu;
    v_out[r] = bv;
  }
  if (steps_out != nullptr) steps_out[r] = steps;
}

}  // namespace

// Launches the walk of n rays on `stream`; returns the CUDA error of the
// launch (0 = none).  packed_nodes is (8 * m, 9) f32, leaf_geom (L, 40) f32
// and 16-byte aligned, the seven ray arrays (n,) f32; all contiguous.
// Closest hit writes t, tri, u, v; any-hit writes occ (int32 0 / 1).
// steps_out, when not null, receives each ray's step count.
extern "C" int bvh_walk_launch(const void* packed_nodes, const void* leaf_geom, int m, int budget,
                               const void* ox, const void* oy, const void* oz, const void* dx,
                               const void* dy, const void* dz, const void* tm, void* t_out,
                               void* tri_out, void* u_out, void* v_out, void* occ_out,
                               void* steps_out, int n, int any_hit, void* stream) {
  if (n <= 0) return 0;
  auto kernel = any_hit ? bvh_walk_kernel<true> : bvh_walk_kernel<false>;
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed_nodes), static_cast<const float4*>(leaf_geom), m, budget,
      static_cast<const float*>(ox), static_cast<const float*>(oy), static_cast<const float*>(oz),
      static_cast<const float*>(dx), static_cast<const float*>(dy), static_cast<const float*>(dz),
      static_cast<const float*>(tm), static_cast<float*>(t_out), static_cast<int32_t*>(tri_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out), static_cast<int32_t*>(occ_out),
      static_cast<int32_t*>(steps_out), n);
  return static_cast<int>(cudaGetLastError());
}
