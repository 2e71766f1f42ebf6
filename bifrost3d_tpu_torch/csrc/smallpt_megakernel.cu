// SmallPT megakernel for Hopper (sm_90a): one whole path per pixel, one
// launch per progressive frame.
//
// Replaces the TPU kernel bifrost3d_tpu/integrator/pallas_smallpt.py
// ::_make_kernel (driven by render_smallpt_megakernel). It computes what
// that kernel computes — for every pixel one progressive SmallPT sample:
// tent-jittered camera ray, nearest-sphere scan, diffuse / mirror / glass
// bounce, Russian roulette, at most 20 bounces, all on one LCG chain — but
// not in its (8, 128)-tile shape:
//
//   - the whole path of a pixel in one thread's registers;
//   - the sphere table (n x 10 floats: centre, radius, emission, colour;
//     n BSDF ids) is staged once per block in shared memory and read as
//     broadcasts;
//   - the thread branches on the hit sphere's BSDF instead of computing all
//     three lobes under masks, and its path ends when it dies (a miss, a
//     lost roulette, a black throughput), where the TPU kernel runs all 20
//     iterations for every lane;
//   - persistent lanes with path regeneration: a grid of as many blocks as
//     the SMs hold at once; a lane whose path ends writes its pixel and takes
//     the next unclaimed one from a counter (one warp-aggregated atomicAdd
//     per claim round; the counter is zeroed by a memset on the same stream);
//   - a sphere that the ray clearly misses is rejected before its two square
//     roots, by a margin under which the full test's det < 0 exactly;
//   - with inv_n set, the lane lerps its radiance into the running mean in
//     place (the app's `buffer + (frame - buffer) / n`, rounded as torch
//     rounds it on the card), so a progressive frame is this one launch.
//
// The sample chain is that of the eager wavefront (integrator/smallpt.py),
// which is this kernel's plain version: seed jenkins(2x2 sub-pixel index) ^
// brev(accumulation); u = float(state) * 2^-32 with a rounded u32 -> f32
// conversion; two draws for the tent jitter; per bounce one roulette draw
// once depth + 1 > 5 on a hit, two draws for diffuse, one for glass outside
// total internal reflection, none for the mirror. A pixel's chain does not
// depend on which lane renders it, so the frame is bit for bit that of one
// thread per pixel. The arithmetic follows the wavefront's formulas term
// by term (the stable (r - d_perp)(r + d_perp) discriminant, IEEE sqrt and
// division); nvcc's FMA contraction is the one difference, and on the
// 1e5-radius wall spheres it moves a few grazing hits and roulette draws,
// which the comparison gates count.
//
// What bounds it on an H100: operations. A pixel reads nothing but the
// 396-byte table and writes 12 bytes (24 more with the running mean); a
// bounce costs about 9 x 30 flops of sphere tests plus about a hundred for
// shading. Paths end after 1 to 20 bounces (6.6 on average at 1024 x 768),
// so with one pixel per thread a warp runs until its longest path ends and
// most of its lanes idle; regeneration keeps the lanes on bounces until the
// frame runs out of pixels, and the idle tail is one path per lane. On an
// H100 80GB HBM3 at 700 W that made a 1024 x 768 frame about 1.35 times
// faster; it stays about ten times its operation bound (PERF.md): every
// lane tests all nine spheres per bounce and branches on its hit sphere's
// BSDF, so the warps diverge within a bounce.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // the largest block the kernel is built for
constexpr int kMaxSpheres = 64;
constexpr int kMaxDepth = 20;
constexpr int kRrStartDepth = 5;
constexpr float kEps = 1e-2f;
constexpr float kOriginOffset = 0.05f;
constexpr float kUintNorm = 2.3283064365386963e-10f;  // 2^-32
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kBsdfDiffuse = 0;
constexpr int kBsdfGlass = 2;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float max3(V3 a) { return fmaxf(fmaxf(a.x, a.y), a.z); }

// math.vec.normalize: v * (|v|^2 > 1e-20 ? 1 : 0) / sqrt(max(|v|^2, 1e-12)).
__device__ __forceinline__ V3 normalize(V3 a) {
  const float l2 = dot(a, a);
  const float inv = __fdiv_rn(l2 > 1e-20f ? 1.0f : 0.0f, __fsqrt_rn(fmaxf(l2, 1e-12f)));
  return a * inv;
}

// math.vec.reflect: d - (2 dot(d, n)) n.
__device__ __forceinline__ V3 reflect(V3 d, V3 n) { return d - n * (2.0f * dot(d, n)); }

__device__ __forceinline__ uint32_t jenkins(uint32_t x) {
  x += x << 10;
  x ^= x >> 6;
  x += x << 3;
  x ^= x >> 11;
  x += x << 15;
  return x;
}

__device__ __forceinline__ float lcg_next(uint32_t& state) {
  state = state * 1664525u + 1013904223u;
  return __uint2float_rn(state) * kUintNorm;
}

__device__ __forceinline__ uint32_t pixel_seed(uint32_t x, uint32_t y, uint32_t width,
                                               uint32_t accumulation) {
  const uint32_t sx = accumulation % 2u;
  const uint32_t sy = (accumulation >> 1) % 2u;
  const uint32_t index = (y * 2u + sy) * (width * 2u) + x * 2u + sx;
  return jenkins(index) ^ __brev(accumulation);
}

__device__ __forceinline__ float tent(float u) {
  const float r = 2.0f * u;
  return r < 1.0f ? __fsqrt_rn(r) - 1.0f : 1.0f - __fsqrt_rn(fmaxf(2.0f - r, 0.0f));
}

// A fresh path for pixel `pixel`: the tent-jittered camera ray and the
// pixel's LCG chain. cam: cam_o, cam_d (unit), cx, cy — 12 floats made by
// the wrapper with the plain version's own arithmetic.
__device__ __forceinline__ void start_path(const float* s_cam, int pixel, int width, int height,
                                           uint32_t accumulation, V3& origin, V3& direction,
                                           uint32_t& rng) {
  const uint32_t x = pixel % width;
  const uint32_t y = pixel / width;
  rng = pixel_seed(x, y, width, accumulation);
  const float u1 = lcg_next(rng);
  const float u2 = lcg_next(rng);
  const float sx = static_cast<float>(accumulation % 2u);
  const float sy = static_cast<float>((accumulation >> 1) % 2u);
  const float u = __fdiv_rn(__fdiv_rn(sx + 0.5f + tent(u1), 2.0f) + static_cast<float>(x),
                            static_cast<float>(width));
  const float v = __fdiv_rn(__fdiv_rn(sy + 0.5f + tent(u2), 2.0f) + static_cast<float>(y),
                            static_cast<float>(height));
  const V3 cam_o = v3(s_cam[0], s_cam[1], s_cam[2]);
  const V3 cam_d = v3(s_cam[3], s_cam[4], s_cam[5]);
  const V3 cx = v3(s_cam[6], s_cam[7], s_cam[8]);
  const V3 cy = v3(s_cam[9], s_cam[10], s_cam[11]);
  const V3 d0 = cx * (u - 0.5f) + cy * (v - 0.5f) + cam_d;
  origin = cam_o + d0 * 140.0f;
  direction = normalize(d0);
}

// One bounce of the path at `depth`: the nearest sphere, its emission, the
// roulette and the BSDF sample → false when the path ends here (a miss, a
// lost roulette, a black throughput).
__device__ __forceinline__ bool bounce(const float* s_sph, const int* s_bsdf, int n_spheres,
                                       int depth, V3& origin, V3& direction, V3& throughput,
                                       V3& radiance, uint32_t& rng) {
  // Nearest sphere: strict '<' over ascending ids, so the lowest id wins a
  // tie, as argmin does.
  float best_t = INFINITY;
  int best = -1;
  for (int k = 0; k < n_spheres; ++k) {
    const float* s = &s_sph[k * 10];
    const V3 op = v3(s[0], s[1], s[2]) - origin;
    const float radius = s[3];
    const float b = dot(op, direction);
    const V3 perp = op - direction * b;
    const float perp2 = dot(perp, perp);
    // A clear miss, decided without the two square roots. perp2 > thr
    // with thr = fl(fl(r^2) (1 + 2^-20)) >= r^2 (1 + 2^-20)(1 - 2^-24)^2
    // > r^2 (1 + 2^-22 + 2^-46) >= (r + ulp(r))^2, so sqrt(perp2) >= the
    // float above |r|, and the correctly rounded d_perp = fsqrt(perp2) > |r|
    // (perp2 > 1e-12 as well, so the full test takes that branch). Then
    // r - d_perp < 0 and r + d_perp > 0 exactly, and their product, at
    // least r^2 2^-24 in size, is negative for |r| > 1e-15 (the scene's
    // radii are 16.5 to 1e5): the full test's det < 0, t = inf.
    const float thr = (radius * radius) * (1.0f + 9.5367431640625e-7f);
    if (perp2 > 1e-12f && perp2 > thr) continue;
    const float d_perp = perp2 > 1e-12f ? __fsqrt_rn(perp2) : 0.0f;
    const float det = (radius - d_perp) * (radius + d_perp);
    const float sqrt_det = __fsqrt_rn(fmaxf(det, 0.0f));
    const float t_near = b - sqrt_det;
    const float t_far = b + sqrt_det;
    float t = t_near > kEps ? t_near : (t_far > kEps ? t_far : INFINITY);
    if (!(det >= 0.0f)) t = INFINITY;
    if (t < best_t) {
      best_t = t;
      best = k;
    }
  }
  if (best < 0) return false;  // a miss ends the path

  const float* s = &s_sph[best * 10];
  const V3 centre = v3(s[0], s[1], s[2]);
  const V3 emission = v3(s[4], s[5], s[6]);
  V3 f = v3(s[7], s[8], s[9]);
  const int bsdf = s_bsdf[best];

  radiance = radiance + throughput * emission;

  const V3 pos = origin + direction * best_t;
  const V3 norm = normalize(pos - centre);
  const float n_dot_d = dot(norm, direction);
  const V3 nl = n_dot_d < 0.0f ? norm : -norm;

  // Russian roulette on the hit sphere's max reflectance.
  if (depth + 1 > kRrStartDepth) {
    const float max_refl = max3(f);
    const float u_rr = lcg_next(rng);
    if (!(u_rr < max_refl)) return false;
    const float denom = fmaxf(max_refl, 1e-6f);
    f = v3(__fdiv_rn(f.x, denom), __fdiv_rn(f.y, denom), __fdiv_rn(f.z, denom));
  }

  V3 new_dir;
  float weight = 1.0f;
  if (bsdf == kBsdfDiffuse) {
    const float ud1 = lcg_next(rng);
    const float ud2 = lcg_next(rng);
    const float r1 = kTwoPi * ud1;
    const float r2s = __fsqrt_rn(ud2);
    const V3 up = fabsf(nl.x) > 0.1f ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
    const V3 ub = normalize(cross(up, nl));
    const V3 vb = cross(nl, ub);
    new_dir = normalize(ub * (cosf(r1) * r2s) + vb * (sinf(r1) * r2s) +
                        nl * __fsqrt_rn(fmaxf(1.0f - ud2, 0.0f)));
  } else if (bsdf == kBsdfGlass) {
    const V3 refl_dir = reflect(direction, norm);
    const bool into = dot(norm, nl) > 0.0f;
    const float nnt = into ? (1.0f / 1.5f) : 1.5f;
    const float ddn = dot(direction, nl);
    const float cos2t = 1.0f - nnt * nnt * (1.0f - ddn * ddn);
    if (cos2t < 0.0f) {  // total internal reflection: no draw
      new_dir = refl_dir;
    } else {
      const float sqrt_cos2t = __fsqrt_rn(fmaxf(cos2t, 0.0f));
      const V3 tdir = normalize(
          direction * nnt - norm * ((into ? 1.0f : -1.0f) * (ddn * nnt + sqrt_cos2t)));
      const float r0 = 0.04f;
      const float c = 1.0f - (into ? -ddn : dot(tdir, norm));
      const float c2 = c * c;
      const float re = r0 + (1.0f - r0) * (c2 * c2 * c);
      const float tr = 1.0f - re;
      const float p = 0.25f + 0.5f * re;
      const float u_g = lcg_next(rng);
      if (u_g < p) {
        new_dir = refl_dir;
        weight = __fdiv_rn(re, p);
      } else {
        new_dir = tdir;
        weight = __fdiv_rn(tr, 1.0f - p);
      }
    }
  } else {  // mirror
    new_dir = reflect(direction, nl);
  }

  throughput = throughput * f * weight;
  if (!(max3(throughput) > 0.0f)) return false;

  // Off the surface, on the side the new direction leaves through.
  const float side = dot(new_dir, norm);
  const float leave = side > 0.0f ? 1.0f : (side < 0.0f ? -1.0f : 0.0f);
  origin = pos + norm * leave * kOriginOffset;
  direction = new_dir;
  return true;
}

// Persistent lanes with path regeneration: every lane of the grid holds one
// path; a lane whose path ends writes its pixel and takes the next unclaimed
// pixel from `counter` (one atomicAdd per warp and claim round), so a warp
// runs bounces until the frame's pixels run out instead of waiting for its
// longest path. With inv_n == 0 the lane writes the radiance; otherwise it
// lerps it into the running mean in place, out = out + (radiance - out) *
// inv_n, rounded op by op as torch's eager `buffer + (frame - buffer) / n`
// is on the card (a division by a host scalar is a multiplication by its
// float reciprocal there).
__global__ void __launch_bounds__(kThreads)
smallpt_kernel(const float* __restrict__ spheres, const int* __restrict__ bsdfs, int n_spheres,
               const float* __restrict__ cam, int width, int height, uint32_t accumulation,
               float inv_n, float* __restrict__ out, int* __restrict__ counter) {
  __shared__ float s_sph[kMaxSpheres * 10];
  __shared__ int s_bsdf[kMaxSpheres];
  __shared__ float s_cam[12];
  for (int k = threadIdx.x; k < n_spheres * 10; k += blockDim.x) s_sph[k] = spheres[k];
  for (int k = threadIdx.x; k < n_spheres; k += blockDim.x) s_bsdf[k] = bsdfs[k];
  for (int k = threadIdx.x; k < 12; k += blockDim.x) s_cam[k] = cam[k];
  __syncthreads();

  const int n = width * height;
  const unsigned lane = threadIdx.x & 31u;
  int pixel = -1;  // -1: wants a pixel; n: the frame has none left
  int depth = 0;
  uint32_t rng = 0u;
  V3 origin = v3(0.0f, 0.0f, 0.0f), direction = origin, throughput = origin, radiance = origin;
  for (;;) {
    const unsigned want = __ballot_sync(0xffffffffu, pixel < 0);
    if (want) {
      const int leader = __ffs(want) - 1;
      int base = 0;
      if (lane == static_cast<unsigned>(leader)) base = atomicAdd(counter, __popc(want));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (pixel < 0) {
        pixel = min(base + __popc(want & ((1u << lane) - 1u)), n);
        if (pixel < n) {
          start_path(s_cam, pixel, width, height, accumulation, origin, direction, rng);
          throughput = v3(1.0f, 1.0f, 1.0f);
          radiance = v3(0.0f, 0.0f, 0.0f);
          depth = 0;
        }
      }
    }
    if (__all_sync(0xffffffffu, pixel >= n)) break;
    if (pixel >= n) continue;
    if (bounce(s_sph, s_bsdf, n_spheres, depth, origin, direction, throughput, radiance, rng) &&
        ++depth < kMaxDepth)
      continue;
    float* o = out + 3 * pixel;
    if (inv_n == 0.0f) {
      o[0] = radiance.x;
      o[1] = radiance.y;
      o[2] = radiance.z;
    } else {
      o[0] = __fadd_rn(o[0], __fmul_rn(__fsub_rn(radiance.x, o[0]), inv_n));
      o[1] = __fadd_rn(o[1], __fmul_rn(__fsub_rn(radiance.y, o[1]), inv_n));
      o[2] = __fadd_rn(o[2], __fmul_rn(__fsub_rn(radiance.z, o[2]), inv_n));
    }
    pixel = -1;
  }
}

__global__ void rng_probe_kernel(const int* __restrict__ xs, const int* __restrict__ ys,
                                 int n, int width, uint32_t accumulation, int steps,
                                 uint32_t* __restrict__ states, float* __restrict__ floats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t rng = pixel_seed(xs[i], ys[i], width, accumulation);
  for (int k = 0; k < steps; ++k) {
    const float u = lcg_next(rng);
    states[k * n + i] = rng;
    floats[k * n + i] = u;
  }
}

int blocks_per_sm(int threads) {
  int blocks = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, smallpt_kernel, threads, 0);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return blocks;
}

}  // namespace

// spheres: [n_spheres, 10] float32; bsdfs: [n_spheres] int32; cam: [12]
// float32; out: [height * width, 3] float32, row 0 at the bottom: the frame
// (inv_n == 0) or the running mean that the frame is lerped into with 1/n =
// inv_n; counter: one int32 of scratch, zeroed here by a memset on `stream`.
// Launches a persistent grid of `threads`-thread blocks, as many as the SMs
// hold at once; returns the first CUDA error (0 = launched).
extern "C" int smallpt_megakernel(const float* spheres, const int* bsdfs, int n_spheres,
                                  const float* cam, int width, int height,
                                  unsigned int accumulation, float inv_n, float* out,
                                  int* counter, int threads, void* stream) {
  const int n = width * height;
  if (n <= 0) return 0;
  if (n_spheres > kMaxSpheres) return static_cast<int>(cudaErrorInvalidValue);
  // __launch_bounds__ caps the block size at kThreads: a larger `threads`
  // has no occupancy and comes back as a launch error.
  const int per_sm = blocks_per_sm(threads);
  if (per_sm < 0) return -per_sm;
  if (per_sm == 0 || threads % 32 != 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int blocks = min((n + threads - 1) / threads, per_sm * sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  smallpt_kernel<<<blocks, threads, 0, s>>>(spheres, bsdfs, n_spheres, cam, width, height,
                                            accumulation, inv_n, out, counter);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of `threads` that one SM holds at once (the persistent grid's width
// per SM), or minus the CUDA error.
extern "C" int smallpt_blocks_per_sm(int threads) { return blocks_per_sm(threads); }

// The pixel seed and the first `steps` LCG states and floats of pixels
// (xs[i], ys[i]): states and floats are [steps, n].
extern "C" int smallpt_rng_probe(const int* xs, const int* ys, int n, int width,
                                 unsigned int accumulation, int steps,
                                 unsigned int* states, float* floats, void* stream) {
  if (n <= 0) return 0;
  rng_probe_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      xs, ys, n, width, accumulation, steps, states, floats);
  return static_cast<int>(cudaGetLastError());
}
