// The texture stack: one texture sample a lane over a table of mixed kinds
// (bitmap, checkerboard, simplex-noise FBM, constant, and a mix of three
// non-mix textures), INVALID_ID lanes reading (1, 1, 1).
//
// It replaces no Pallas kernel.  The JAX package leaves
// raytracer_tpu/ops/textures.py::sample_texture_many to XLA's fusion.  The
// port's plain twin, ops/textures.py::sample_texture_many_reference, runs it
// as ~3,800 elementwise and gather launches a call over every lane, with
// every kind, every filter mode and all of the table's octaves evaluated on
// every lane whatever its id.
//
// Per lane i, with id = ids[i]:
//   id == INVALID_ID (-1): (1, 1, 1);
//   otherwise the table's row r = max(id, 0), by its kind:
//     mix (when the table has one): va + (vb - va) * vw.x, with va, vb, vw
//       the non-mix samples of rows sub_a[r], sub_b[r], sub_w[r] (a negative
//       sub id counts from the end of the table, as the twin's index does);
//     checkerboard: color_a where (rem(u) > 0.5) xor (rem(v) > 0.5), else
//       color_b, rem(x) = torch.remainder(x, 1.0);
//     noise: color_a * w + color_b * (1 - w), w the FBM of 2-D simplex noise
//       over the row's own octaves;
//     constant: color_a;
//     anything else (a bitmap, or a mix met as a sub): the bitmap at the
//       row's y0, height, width and filter, with the texel-corner
//       convention, the secondary coordinates wrapped and every index
//       clipped to the bitmap.
//   Ids at or past the table's end read NaN (the twin's index raises).
// Every float operation is the twin's, in the twin's order, each rounded on
// its own (the build's -fmad=false, no fast math): torch.remainder's fmod
// form, truncating float-to-int casts, floorf, NaN-propagating clamps, the
// lattice hash as uint32 wrapping multiplies.  So kernel and twin agree bit
// for bit.  The early exits add nothing the twin adds: past a row's own
// octave count the twin adds 0 * amp * simplex, which is 0 unless the
// simplex value is not finite; that needs |u| or |v| of 1e30 or more (or a
// NaN), and such lanes run the twin's remaining octaves too.  An INVALID_ID
// lane reads 1 in the twin whatever its id.
//
// What bounds it on the card, for the textured hall's 2,073,600-lane calls:
//   - bytes: 12 B a lane in (id, u, v) and 12 B out: ~15 us a call at
//     3.35 TB/s, plus 4 scattered 12-byte taps a bilinear lane (1 a nearest
//     one), 8 for a mix over two bitmaps, from a 56.6 MB atlas that does not
//     fit the 50 MB L2;
//   - operations: ~60 float operations an octave of noise (3 simplex
//     corners, each with a lattice hash of ~8 integer operations), so ~255
//     a 4-octave noise lane; ~40 a bilinear lane: ~1.4 us of float work at
//     67 TFLOP/s for a call over the textured hall's table, so bytes bound it.
// What the design does about it:
//   - one thread a lane and one pass over the lanes: the result is written
//     once, and nothing in between goes through device memory;
//   - no work on an INVALID_ID lane, and a lane evaluates only its own kind,
//     its own filter and its own octaves;
//   - the table (a few dozen rows) is staged in shared memory once a block,
//     as 15 planes of 32-bit words; a table of more than kMaxStaged rows is
//     read from device memory instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPlanes = 15;       // 9 int32 columns and 6 float columns a row
constexpr int kMaxStaged = 768;   // rows staged in shared memory: 45 KiB, under the 48 KiB default
constexpr int kInvalidId = -1;    // scene/types.py::INVALID_ID
constexpr int kMaxOctaves = 8;    // ops/textures.py::MAX_NOISE_OCTAVES

// scene/types.py's TEX_* kinds and ops/textures.py's FILTER_* modes
constexpr int kChecker = 1, kNoise = 2, kMix = 3, kConst = 4;
constexpr int kNearest = 0, kSmooth = 2;

// the twin's float32 scalars: np.float32 of the Python constants
constexpr float kF2 = 0x1.76cf5cp-2f;    // 0.366025403
constexpr float kG2 = 0x1.b0cb18p-3f;    // 0.211324865
constexpr float kG2x2 = 0x1.b0cb18p-2f;  // 2.0 * 0.211324865
constexpr float kNorm = 0x1.69d86p+5f;   // 45.23065
constexpr float kAmpFloor = 0x1.0c6f7ap-20f;  // 1e-6

struct Table {
  const int32_t *kind, *y0, *height, *width, *filter, *octaves, *sub_a, *sub_b, *sub_w;
  const float *ax, *ay, *az, *bx, *by, *bz;
};

struct Rgb {
  float x, y, z;
};

// torch.remainder(a, 1.0) on float32: fmod, then + 1 where it is negative
__device__ __forceinline__ float rem1(float a) {
  float m = fmodf(a, 1.0f);
  if (m != 0.0f && m < 0.0f) m = m + 1.0f;
  return m;
}

// torch.clamp_min(t, 0.0): NaN passes
__device__ __forceinline__ float clamp_min0(float t) { return isnan(t) ? t : fmaxf(t, 0.0f); }

// ops/textures.py::_clip_index
__device__ __forceinline__ int clip_index(int x, int size) { return min(max(x, 0), size - 1); }

// ops/textures.py::_hash2: int32 lattice coordinates as uint32, wrapping multiplies
__device__ __forceinline__ int hash2(uint32_t ix, uint32_t iy) {
  uint32_t h = ix * 0x8DA6B343u + iy * 0xD8163841u;
  h = h ^ (h >> 13);
  h = h * 0x9E3779B1u;
  return static_cast<int>(h >> 24);
}

// ops/textures.py::_gradient_dot
__device__ __forceinline__ float gradient_dot(int hash8, float x, float y) {
  const int h = hash8 & 0x3F;
  const float u = h < 4 ? x : y;
  const float v = h < 4 ? y : x;
  const float a = (h & 1) != 0 ? -u : u;
  const float b = (h & 2) != 0 ? -2.0f * v : 2.0f * v;
  return a + b;
}

// the twin's int32 lattice sums wrap: they are taken as uint32 here
__device__ __forceinline__ float corner(float cx, float cy, uint32_t gi, uint32_t gj) {
  const float tt = (0.5f - cx * cx) - cy * cy;
  const float m = clamp_min0(tt);
  const float m2 = m * m;
  return (m2 * m2) * gradient_dot(hash2(gi, gj), cx, cy);
}

// ops/textures.py::_simplex2
__device__ float simplex2(float x, float y) {
  const float s = (x + y) * kF2;
  const float i = floorf(x + s);
  const float j = floorf(y + s);
  const float t = (i + j) * kG2;
  const float x0 = x - (i - t);
  const float y0 = y - (j - t);
  const float i1 = x0 > y0 ? 1.0f : 0.0f;
  const float j1 = 1.0f - i1;
  const float x1 = (x0 - i1) + kG2;
  const float y1 = (y0 - j1) + kG2;
  const float x2 = (x0 - 1.0f) + kG2x2;
  const float y2 = (y0 - 1.0f) + kG2x2;
  const uint32_t ii = static_cast<uint32_t>(static_cast<int>(i));
  const uint32_t jj = static_cast<uint32_t>(static_cast<int>(j));
  const uint32_t di = static_cast<uint32_t>(i1), dj = static_cast<uint32_t>(j1);
  const float n = (corner(x0, y0, ii, jj) + corner(x1, y1, ii + di, jj + dj)) + corner(x2, y2, ii + 1u, jj + 1u);
  return kNorm * n;
}

// ops/textures.py::_noise_fbm for one lane: the row's own `count` octaves,
// of the `loop` the twin runs on every lane
__device__ float noise_fbm(float u, float v, int count, int loop) {
  const int active = min(max(count, 0), loop);
  float total = 0.0f, amp_sum = 0.0f;
  for (int o = 0; o < active; ++o) {
    const float freq = static_cast<float>(1 << o);
    const float amp = ldexpf(1.0f, -o);
    total = total + amp * simplex2(u * freq, v * freq);
    amp_sum = amp_sum + amp;
  }
  if (active < loop && !(fabsf(u) < 1e30f && fabsf(v) < 1e30f)) {
    // the twin's 0 * amp * simplex past the count: not 0 where simplex is not finite
    for (int o = active; o < loop; ++o) {
      const float freq = static_cast<float>(1 << o);
      total = total + 0.0f * simplex2(u * freq, v * freq);
      amp_sum = amp_sum + 0.0f;
    }
  }
  const float d = amp_sum < kAmpFloor ? kAmpFloor : amp_sum;  // clamp_min: amp_sum is never NaN
  const float val = 0.5f + (0.5f * total) / d;
  return isnan(val) ? val : fminf(fmaxf(val, 0.0f), 1.0f);
}

__device__ __forceinline__ Rgb texel(const float* __restrict__ data, int atlas_w, int row, int col) {
  const float* p = data + (static_cast<size_t>(row) * atlas_w + col) * 3;
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

// ops/textures.py::_bitmap_eval for one lane of row r
__device__ Rgb bitmap(const Table& t, int r, const float* __restrict__ data, int atlas_w, float u, float v) {
  const int y0 = t.y0[r], h = t.height[r], w = t.width[r], mode = t.filter[r];
  const float uu = rem1(u) * static_cast<float>(w);
  const float vv = rem1(v) * static_cast<float>(h);
  if (mode == kNearest) {
    return texel(data, atlas_w, y0 + clip_index(static_cast<int>(vv), h), clip_index(static_cast<int>(uu), w));
  }
  const float fl_u = floorf(uu), fl_v = floorf(vv);
  const int ix0 = clip_index(static_cast<int>(fl_u), w);
  const int iy0 = clip_index(static_cast<int>(fl_v), h);
  float fu = uu - fl_u, fv = vv - fl_v;
  if (mode == kSmooth) {
    fu = (fu * fu) * (3.0f - 2.0f * fu);
    fv = (fv * fv) * (3.0f - 2.0f * fv);
  }
  const int ix1 = ix0 + 1 >= w ? 0 : ix0 + 1;  // wrap secondary coords
  const int iy1 = iy0 + 1 >= h ? 0 : iy0 + 1;
  const Rgb c00 = texel(data, atlas_w, y0 + iy0, ix0);
  const Rgb c10 = texel(data, atlas_w, y0 + iy0, ix1);
  const Rgb c01 = texel(data, atlas_w, y0 + iy1, ix0);
  const Rgb c11 = texel(data, atlas_w, y0 + iy1, ix1);
  const float w00 = (1.0f - fu) * (1.0f - fv);
  const float w10 = fu * (1.0f - fv);
  const float w01 = (1.0f - fu) * fv;
  const float w11 = fu * fv;
  return {((c00.x * w00 + c10.x * w10) + c01.x * w01) + c11.x * w11,
          ((c00.y * w00 + c10.y * w10) + c01.y * w01) + c11.y * w11,
          ((c00.z * w00 + c10.z * w10) + c01.z * w01) + c11.z * w11};
}

// ops/textures.py::_eval_non_mix for one lane of row r; `kinds` has bit k
// set where the table holds kind k (TextureAtlas.kinds_present)
__device__ Rgb non_mix(const Table& t, int r, const float* __restrict__ data, int atlas_w, int kinds, int loop,
                       float u, float v) {
  const int kind = t.kind[r];
  if (kind == kChecker && (kinds & (1 << kChecker))) {
    const bool a = (rem1(u) > 0.5f) != (rem1(v) > 0.5f);
    return a ? Rgb{t.ax[r], t.ay[r], t.az[r]} : Rgb{t.bx[r], t.by[r], t.bz[r]};
  }
  if (kind == kNoise && (kinds & (1 << kNoise))) {
    const float w = noise_fbm(u, v, t.octaves[r], loop);
    const float q = 1.0f - w;
    return {t.ax[r] * w + t.bx[r] * q, t.ay[r] * w + t.by[r] * q, t.az[r] * w + t.bz[r] * q};
  }
  if (kind == kConst) return {t.ax[r], t.ay[r], t.az[r]};
  return bitmap(t, r, data, atlas_w, u, v);
}

__global__ void __launch_bounds__(kThreads) textures_kernel(
    const int32_t* __restrict__ ids, const float* __restrict__ us, const float* __restrict__ vs,
    const float* __restrict__ data, Table g, float* __restrict__ out, int n, int k, int atlas_w, int kinds,
    int loop) {
  extern __shared__ int32_t planes[];  // kPlanes planes of k words when the table is staged
  Table t = g;
  if (k <= kMaxStaged) {  // uniform over the grid
    int p = 0;
    const auto stage = [&](const void* column) {
      const int32_t* src = static_cast<const int32_t*>(column);
      for (int i = threadIdx.x; i < k; i += kThreads) planes[p * k + i] = src[i];
      ++p;
    };
    stage(g.kind), stage(g.y0), stage(g.height), stage(g.width), stage(g.filter), stage(g.octaves);
    stage(g.sub_a), stage(g.sub_b), stage(g.sub_w), stage(g.ax), stage(g.ay), stage(g.az);
    stage(g.bx), stage(g.by), stage(g.bz);
    __syncthreads();
    const float* f = reinterpret_cast<const float*>(planes);
    t = Table{planes, planes + k, planes + 2 * k, planes + 3 * k, planes + 4 * k, planes + 5 * k,
              planes + 6 * k, planes + 7 * k, planes + 8 * k, f + 9 * k, f + 10 * k, f + 11 * k,
              f + 12 * k, f + 13 * k, f + 14 * k};
  }
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int id = ids[i];
  const float nan = __int_as_float(0x7fc00000);
  Rgb c{1.0f, 1.0f, 1.0f};
  if (id != kInvalidId) {
    const float u = us[i], v = vs[i];
    const int r = max(id, 0);
    if (r >= k) {
      c = {nan, nan, nan};
    } else if (t.kind[r] == kMix && (kinds & (1 << kMix))) {
      int sub[3] = {t.sub_a[r], t.sub_b[r], t.sub_w[r]};
      for (int s = 0; s < 3; ++s) sub[s] += sub[s] < 0 ? k : 0;  // the twin's index counts from the end
      if (min(sub[0], min(sub[1], sub[2])) < 0 || max(sub[0], max(sub[1], sub[2])) >= k) {
        c = {nan, nan, nan};
      } else {
        const Rgb va = non_mix(t, sub[0], data, atlas_w, kinds, loop, u, v);
        const Rgb vb = non_mix(t, sub[1], data, atlas_w, kinds, loop, u, v);
        const float w = non_mix(t, sub[2], data, atlas_w, kinds, loop, u, v).x;
        c = {va.x + (vb.x - va.x) * w, va.y + (vb.y - va.y) * w, va.z + (vb.z - va.z) * w};
      }
    } else {
      c = non_mix(t, r, data, atlas_w, kinds, loop, u, v);
    }
  }
  out[i] = c.x;
  out[static_cast<size_t>(n) + i] = c.y;
  out[2 * static_cast<size_t>(n) + i] = c.z;
}

}  // namespace

// ids (n,) int32, u and v (n,) float32, data (rows, atlas_w, 3) float32; the
// table's kind .. sub_w (k,) int32 and its colors a.x .. b.z (k,) float32;
// out (3, n) float32; all contiguous.  kinds: bit k set where the table
// holds kind k; loop: the octaves the twin runs (min(max_octaves, 8)).
extern "C" int textures_launch(const void* ids, const void* u, const void* v, const void* data, const void* kind,
                               const void* y0, const void* height, const void* width, const void* filter,
                               const void* octaves, const void* sub_a, const void* sub_b, const void* sub_w,
                               const void* ax, const void* ay, const void* az, const void* bx, const void* by,
                               const void* bz, void* out, int n, int k, int atlas_w, int kinds, int loop,
                               void* stream) {
  if (n <= 0) return 0;
  if (k <= 0 || atlas_w <= 0 || loop < 0 || loop > kMaxOctaves) return static_cast<int>(cudaErrorInvalidValue);
  const Table g{static_cast<const int32_t*>(kind),    static_cast<const int32_t*>(y0),
                static_cast<const int32_t*>(height),  static_cast<const int32_t*>(width),
                static_cast<const int32_t*>(filter),  static_cast<const int32_t*>(octaves),
                static_cast<const int32_t*>(sub_a),   static_cast<const int32_t*>(sub_b),
                static_cast<const int32_t*>(sub_w),   static_cast<const float*>(ax),
                static_cast<const float*>(ay),        static_cast<const float*>(az),
                static_cast<const float*>(bx),        static_cast<const float*>(by),
                static_cast<const float*>(bz)};
  const size_t shmem = k <= kMaxStaged ? static_cast<size_t>(kPlanes) * k * sizeof(int32_t) : 0;
  textures_kernel<<<(n + kThreads - 1) / kThreads, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(data), g, static_cast<float*>(out), n, k, atlas_w, kinds, loop);
  return static_cast<int>(cudaGetLastError());
}
