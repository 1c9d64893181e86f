// Pair placement of the wave2 engine: the (ray, candidate super) pairs of a
// round are put into single-super chunks of CHUNK slots for wave2_mt, and
// each ray reads its results back through the same slot map.
//
// It replaces no Pallas kernel.  The JAX package computes this stage with
// XLA (raytracer_tpu/ops/wave2_traverse.py::_round): a stable sort of the
// pair keys, a cummax and a cumsum for the run paddings, a second stable
// sort that interleaves the pairs with the fillers, and a third sort that
// returns the results to ray order.  The port's plain twins,
// ops/wave2_traverse.py::pair_join_reference and select_reference, do the
// same in PyTorch.  Here only the first sort stays (torch.sort, between the
// key and the runs launches); everything else is index arithmetic:
//
//   key:   key[i] = cand < Cs ? cand << shift | octant << mbits | Morton(origin)
//          : Cs << shift, for pair i = ray * kc + j, and Cs << shift for the
//          pads up to p_pad.  The origin is quantized to bpa = mbits / 3 bits
//          an axis over the bounds of the valid super boxes, as
//          clamp((x - lo) / max(hi - lo, 1e-9) * top, 0, top), each step
//          rounded on its own (-fmad=false), truncated to an int.
//   runs:  start[s] = the first sorted position whose key is >= s << shift,
//          s = 0 .. Cs (start[Cs] counts the real pairs); the padded start
//          dstart[s] = sum over s' < s of len + (-len mod CHUNK), len =
//          start[s' + 1] - start[s'].  The sentinel super Cs comes last and
//          is not padded.
//   place: chunk b lies in the region of the last super s with dstart[s] <=
//          b * CHUNK (block_cluster[b] = s; Cs past the last real run).  Its
//          slot d = dstart[s] + off holds the sorted pair start[s] + off
//          while off is below the run's length, else a filler: fidx =
//          p_pad, o = 0, d = +x, tl = 0.  A sorted position holding a pad
//          (perm >= p) gives fidx = p and the filler's rays; a real pair
//          (perm < p) gives fidx = perm, its ray's 7 floats, and
//          slot_of_pair[perm] = d.
//   select: ray r reads its kc results (t, tri, u, v, done) at
//          slot_of_pair[r * kc + j] for its valid candidates and keeps the
//          least t, ties to the lowest tri, u and v the largest over the
//          slots at that (t, tri); then its new cursor and whether it is
//          resolved, in id order or front to back, with the any-hit rules.
//
// The twins' results, bit for bit: the fillers' budget f and so d_len, the
// chunk contents and block_cluster are the same tensors, so wave2_mt sees
// the same work.  (Where no pair is a sentinel, the twin's padded starts of
// the empty supers after the last run read that run's end without its
// padding, and the scan here reads it with; no chunk starts between the two,
// so block_cluster is the same.)
//
// What bounds it on the card: bytes, and the launches.  A round of the
// hall's 65,536-ray window sorts 1,048,576 keys and writes 2,648,064 slots
// of 7 floats and an index: about 100 MB, some 30 us at 3.35 TB/s.  The
// twin takes some 270 launches for it, each dispatched by the host.
//
// What the design does about it:
//   - Four launches a round and the library sort; every slot, pair and ray
//     is written once, in the order the next stage reads it (the pair planes
//     slot by slot, coalesced).
//   - The key launch reduces the super boxes' bounds in each block (the
//     hall's 1,563 boxes are 37.5 KiB, from L2) on a grid capped at four
//     blocks an SM, so no launch computes the bounds alone.
//   - The runs launch is one block: Cs + 1 binary searches in the sorted
//     keys and a block-wide scan of Cs + 1 run widths.
//   - The place launch is one block a chunk: one thread finds the chunk's
//     super by a binary search in dstart, the block writes its CHUNK slots
//     row by row.  A slot is a pair or a filler by its offset alone.
//   - The select launch is one thread a ray; it reads only the slots of its
//     valid candidates, so no third sort and no dense (rays x kc) tensors.
//
// Built with -fmad=false and without fast math (cuda_build.NVCC_FLAGS), so
// the quantization rounds as the twin's separate ops round it.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kKeyThreads = 256;
constexpr int kKeyBlocksPerSm = 4;
constexpr int kRunThreads = 1024;
constexpr int kPlaceThreads = 128;  // one row of a chunk a step
constexpr int kSelectThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// NaN-propagating min / max, as torch.minimum / torch.maximum and the
// reductions amin / amax
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

// torch.clamp((x - lo) / rng * top, 0, top).to(int32); a NaN converts to 0
// on the card, which fmaxf gives too
__device__ __forceinline__ int quantize(float x, float lo, float rng, float top) {
  const float v = (x - lo) / rng * top;
  return static_cast<int>(fminf(fmaxf(v, 0.0f), top));
}

__global__ void __launch_bounds__(kKeyThreads) wave2_join_key_kernel(
    const float* __restrict__ box, const int32_t* __restrict__ cand, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz, int32_t* __restrict__ key, int n, int kc,
    int cs, int p_pad, int key_shift) {
  __shared__ float part[6][kKeyThreads / 32];
  const int mbits = max(0, key_shift - 3);
  const int bpa = mbits / 3;  // Morton bits an axis
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  if (bpa > 0) {  // uniform: the bounds of the valid super boxes, reduced in this block
    for (int s = threadIdx.x; s < cs; s += kKeyThreads) {
      const float* b = box + static_cast<size_t>(s) * 6;  // min.xyz, max.xyz; empty: min > max
      const bool valid = b[0] <= b[3];
      for (int q = 0; q < 3; ++q) {
        lo[q] = nmin(lo[q], valid ? b[q] : CUDART_INF_F);
        hi[q] = nmax(hi[q], valid ? b[3 + q] : -CUDART_INF_F);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      for (int q = 0; q < 3; ++q) {
        lo[q] = nmin(lo[q], __shfl_xor_sync(kFull, lo[q], o));
        hi[q] = nmax(hi[q], __shfl_xor_sync(kFull, hi[q], o));
      }
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      for (int q = 0; q < 3; ++q) part[q][warp] = lo[q], part[3 + q][warp] = hi[q];
    }
    __syncthreads();
    for (int q = 0; q < 3; ++q) {
      lo[q] = part[q][0], hi[q] = part[3 + q][0];
      for (int w = 1; w < kKeyThreads / 32; ++w) lo[q] = nmin(lo[q], part[q][w]), hi[q] = nmax(hi[q], part[3 + q][w]);
    }
  }
  const float top = static_cast<float>((1 << bpa) - 1);
  const float kMinRange = static_cast<float>(1e-9);  // the twin's clamp_min(hi - lo, 1e-9), as torch casts it
  const float rx = nmax(hi[0] - lo[0], kMinRange), ry = nmax(hi[1] - lo[1], kMinRange),
              rz = nmax(hi[2] - lo[2], kMinRange);
  const int sentinel = cs << key_shift;
  const int p = n * kc;
  for (int i = blockIdx.x * kKeyThreads + threadIdx.x; i < p_pad; i += gridDim.x * kKeyThreads) {
    int k = sentinel;
    const int c = i < p ? cand[i] : cs;
    if (c < cs) {
      int okey = 0;
      if (key_shift >= 3) {
        const int r = i / kc;
        int morton = 0;
        if (bpa > 0) {
          const int qx = quantize(ox[r], lo[0], rx, top), qy = quantize(oy[r], lo[1], ry, top),
                    qz = quantize(oz[r], lo[2], rz, top);
          for (int b = 0; b < bpa; ++b)
            morton |= (((qx >> b) & 1) << (3 * b)) | (((qy >> b) & 1) << (3 * b + 1)) | (((qz >> b) & 1) << (3 * b + 2));
        }
        const int octant = (dx[r] < 0.0f) | ((dy[r] < 0.0f) << 1) | ((dz[r] < 0.0f) << 2);
        okey = (octant << mbits) | morton;
      }
      k = (c << key_shift) | okey;
    }
    key[i] = k;
  }
}

__global__ void __launch_bounds__(kRunThreads) wave2_join_runs_kernel(const int32_t* __restrict__ sk, int p_pad,
                                                                      int cs, int key_shift, int chunk,
                                                                      int32_t* start, int32_t* __restrict__ dstart) {
  __shared__ int warp_sum[kRunThreads / 32];
  const int m = cs + 1;
  const int per = (m + kRunThreads - 1) / kRunThreads;
  const int a = min(static_cast<int>(threadIdx.x) * per, m), e = min(a + per, m);
  for (int s = a; s < e; ++s) {  // the first sorted position at or above super s
    const int target = s << key_shift;
    int lo = 0, hi = p_pad;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sk[mid] < target) lo = mid + 1;
      else hi = mid;
    }
    start[s] = lo;
  }
  __syncthreads();  // start[] of every thread is written and visible
  int sum = 0;      // this thread's padded run widths
  for (int s = a; s < min(e, cs); ++s) {
    const int len = start[s + 1] - start[s];
    sum += len + (chunk - len % chunk) % chunk;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_sum[lane];
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += v;
    }
    warp_sum[lane] = wi - w;  // the warps before this one
  }
  __syncthreads();
  int run = warp_sum[warp] + incl - sum;
  for (int s = a; s < e; ++s) {
    dstart[s] = run;
    if (s < cs) {
      const int len = start[s + 1] - start[s];
      run += len + (chunk - len % chunk) % chunk;
    }
  }
}

__global__ void __launch_bounds__(kPlaceThreads) wave2_join_place_kernel(
    const int64_t* __restrict__ perm, const int32_t* __restrict__ start, const int32_t* __restrict__ dstart,
    const float* __restrict__ ox, const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tl, int32_t* __restrict__ sidx, int32_t* __restrict__ fidx,
    float* __restrict__ pairs, int32_t* __restrict__ block_cluster, int32_t* __restrict__ slot_of_pair, int kc,
    int p, int p_pad, int cs, int chunk) {
  __shared__ int region[3];  // the chunk's padded start, its first sorted position, its sorted length
  const int x = blockIdx.x * chunk;
  if (threadIdx.x == 0) {
    int lo = 0, hi = cs;  // the last super whose padded start is <= x
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (dstart[mid] <= x) lo = mid;
      else hi = mid - 1;
    }
    block_cluster[blockIdx.x] = lo;
    region[0] = dstart[lo];
    region[1] = start[lo];
    region[2] = (lo < cs ? start[lo + 1] : p_pad) - start[lo];
  }
  __syncthreads();
  const int e = region[0], first = region[1], len = region[2];
  const size_t plane = static_cast<size_t>(gridDim.x) * chunk;
  for (int k = threadIdx.x; k < chunk; k += kPlaceThreads) {
    const int d = x + k;
    const int off = d - e;
    int fi = p_pad;  // a filler
    float v[7] = {0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f};
    if (off < len) {
      const int j = first + off;
      const int64_t i = perm[j];
      fi = i < p ? static_cast<int>(i) : p;  // a pad rides as p
      sidx[j] = fi;
      if (i < p) {
        slot_of_pair[fi] = d;
        const int r = fi / kc;
        v[0] = ox[r], v[1] = oy[r], v[2] = oz[r], v[3] = dx[r], v[4] = dy[r], v[5] = dz[r], v[6] = tl[r];
      }
    }
    fidx[d] = fi;
    for (int q = 0; q < 7; ++q) pairs[q * plane + d] = v[q];
  }
}

__global__ void __launch_bounds__(kSelectThreads) wave2_join_select_kernel(
    const int32_t* __restrict__ cand, const int32_t* __restrict__ slot_of_pair, const float* __restrict__ t,
    const int32_t* __restrict__ tri, const float* __restrict__ u, const float* __restrict__ v,
    const int32_t* __restrict__ done, const float* __restrict__ tl, const int32_t* __restrict__ cursor,
    const int32_t* __restrict__ remaining, const float* __restrict__ next_t, const int32_t* __restrict__ new_key,
    float* __restrict__ t_out, int32_t* __restrict__ tri_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int32_t* __restrict__ cursor_out, bool* __restrict__ unresolved, int n, int kc,
    int cs, int ftb, int any_hit) {
  const int r = blockIdx.x * kSelectThreads + threadIdx.x;
  if (r >= n) return;
  float bt = CUDART_INF_F, bu = -CUDART_INF_F, bv = -CUDART_INF_F;
  int btri = 0x7fffffff;
  bool any_unproc = false;
  int min_unproc = cs + 1, max_extracted = -1;
  for (int j = 0; j < kc; ++j) {
    const size_t i = static_cast<size_t>(r) * kc + j;
    const int c = cand[i];
    if (c >= cs) continue;  // an empty candidate slot
    max_extracted = max(max_extracted, c);
    const int d = slot_of_pair[i];
    if (done[d] == 0) {
      any_unproc = true;
      min_unproc = min(min_unproc, c);
      continue;
    }
    const int h = tri[d];
    if (h < 0) continue;
    const float th = t[d];
    if (th < bt || (th == bt && h < btri)) {
      bt = th, btri = h, bu = u[d], bv = v[d];
    } else if (th == bt && h == btri) {
      bu = nmax(bu, u[d]), bv = nmax(bv, v[d]);
    }
  }
  const bool got = isfinite(bt);
  const float lim = tl[r];
  const int best_tri = got ? btri : -1;
  const float t_round = got ? bt : fabsf(lim);
  bool unres;
  int cur;
  if (ftb) {
    cur = any_unproc ? cursor[r] : new_key[r];
    unres = any_unproc || next_t[r] < t_round;
  } else {
    cur = any_unproc ? min_unproc - 1 : max(max_extracted, cursor[r]);
    unres = any_unproc || remaining[r] > 0;
  }
  if (any_hit) unres = unres && best_tri < 0;
  unres = unres && !(lim < 0.0f && best_tri >= 0);
  t_out[r] = t_round;
  tri_out[r] = best_tri;
  u_out[r] = got ? bu : 0.0f;
  v_out[r] = got ? bv : 0.0f;
  cursor_out[r] = cur;
  unresolved[r] = unres;
}

int g_key_grid = 0;  // kKeyBlocksPerSm blocks on every SM of the device of the first launch

}  // namespace

// Each launch function returns the CUDA error of its launch (0 = none).  All
// tensors are contiguous; int tensors are int32 but perm (int64).

// key (p_pad,) from cand (n, kc), the rays' origins and directions (n,) f32
// and the super boxes (cs, 6) f32.
extern "C" int wave2_join_key_launch(const void* box, const void* cand, const void* ox, const void* oy,
                                     const void* oz, const void* dx, const void* dy, const void* dz, void* key,
                                     int n, int kc, int cs, int p_pad, int key_shift, void* stream) {
  if (p_pad <= 0) return 0;
  if (cs <= 0 || kc <= 0 || key_shift < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (g_key_grid == 0) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_key_grid = max(sms * kKeyBlocksPerSm, 1);
  }
  const int grid = min((p_pad + kKeyThreads - 1) / kKeyThreads, g_key_grid);
  wave2_join_key_kernel<<<grid, kKeyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(box), static_cast<const int32_t*>(cand), static_cast<const float*>(ox),
      static_cast<const float*>(oy), static_cast<const float*>(oz), static_cast<const float*>(dx),
      static_cast<const float*>(dy), static_cast<const float*>(dz), static_cast<int32_t*>(key), n, kc, cs, p_pad,
      key_shift);
  return static_cast<int>(cudaGetLastError());
}

// start (cs + 1,) and dstart (cs + 1,) from the sorted keys sk (p_pad,).
extern "C" int wave2_join_runs_launch(const void* sk, void* start, void* dstart, int p_pad, int cs, int key_shift,
                                      int chunk, void* stream) {
  if (cs <= 0 || p_pad <= 0 || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  wave2_join_runs_kernel<<<1, kRunThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sk), p_pad, cs, key_shift, chunk, static_cast<int32_t*>(start),
      static_cast<int32_t*>(dstart));
  return static_cast<int>(cudaGetLastError());
}

// sidx (p_pad,), fidx (b2 * chunk,), pairs (7, b2 * chunk) f32, block_cluster
// (b2,) and slot_of_pair (p,) from perm (p_pad,) int64, start, dstart and the
// rays (n,) f32.
extern "C" int wave2_join_place_launch(const void* perm, const void* start, const void* dstart, const void* ox,
                                       const void* oy, const void* oz, const void* dx, const void* dy,
                                       const void* dz, const void* tl, void* sidx, void* fidx, void* pairs,
                                       void* block_cluster, void* slot_of_pair, int b2, int kc, int p, int p_pad,
                                       int cs, int chunk, void* stream) {
  if (b2 <= 0) return 0;
  if (kc <= 0 || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  wave2_join_place_kernel<<<b2, kPlaceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(perm), static_cast<const int32_t*>(start), static_cast<const int32_t*>(dstart),
      static_cast<const float*>(ox), static_cast<const float*>(oy), static_cast<const float*>(oz),
      static_cast<const float*>(dx), static_cast<const float*>(dy), static_cast<const float*>(dz),
      static_cast<const float*>(tl), static_cast<int32_t*>(sidx), static_cast<int32_t*>(fidx),
      static_cast<float*>(pairs), static_cast<int32_t*>(block_cluster), static_cast<int32_t*>(slot_of_pair), kc, p,
      p_pad, cs, chunk);
  return static_cast<int>(cudaGetLastError());
}

// The round's (n,) results from cand (n, kc), slot_of_pair (n * kc,), the
// chunk results t, tri, u, v, done (b2 * chunk,) and the rays' tl and cursor
// (n,); remaining (n,) in id order (ftb 0), next_t and new_key (n,) front to
// back (ftb 1), the others may be null.  unresolved is (n,) bool.
extern "C" int wave2_join_select_launch(const void* cand, const void* slot_of_pair, const void* t, const void* tri,
                                        const void* u, const void* v, const void* done, const void* tl,
                                        const void* cursor, const void* remaining, const void* next_t,
                                        const void* new_key, void* t_out, void* tri_out, void* u_out, void* v_out,
                                        void* cursor_out, void* unresolved, int n, int kc, int cs, int ftb,
                                        int any_hit, void* stream) {
  if (n <= 0) return 0;
  if (kc <= 0 || cs <= 0) return static_cast<int>(cudaErrorInvalidValue);
  wave2_join_select_kernel<<<(n + kSelectThreads - 1) / kSelectThreads, kSelectThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cand), static_cast<const int32_t*>(slot_of_pair), static_cast<const float*>(t),
      static_cast<const int32_t*>(tri), static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const int32_t*>(done), static_cast<const float*>(tl), static_cast<const int32_t*>(cursor),
      static_cast<const int32_t*>(remaining), static_cast<const float*>(next_t),
      static_cast<const int32_t*>(new_key), static_cast<float*>(t_out), static_cast<int32_t*>(tri_out),
      static_cast<float*>(u_out), static_cast<float*>(v_out), static_cast<int32_t*>(cursor_out),
      static_cast<bool*>(unresolved), n, kc, cs, ftb, any_hit);
  return static_cast<int>(cudaGetLastError());
}
