// SmallPT megakernel for Hopper (sm_90a): one whole path per pixel.
//
// Replaces the TPU kernel bifrost3d_tpu/integrator/pallas_smallpt.py
// ::_make_kernel (driven by render_smallpt_megakernel). It computes what
// that kernel computes — for every pixel one progressive SmallPT sample:
// tent-jittered camera ray, nearest-sphere scan, diffuse / mirror / glass
// bounce, Russian roulette, at most 20 bounces, all on one LCG chain — but
// not in its (8, 128)-tile shape:
//
//   - one thread per pixel, the whole path in registers;
//   - the sphere table (n x 10 floats: centre, radius, emission, colour;
//     n BSDF ids) is staged once per block in shared memory and read as
//     broadcasts;
//   - the thread branches on the hit sphere's BSDF instead of computing all
//     three lobes under masks, and leaves the loop when its path dies (a
//     miss, a lost roulette, a black throughput), where the TPU kernel runs
//     all 20 iterations for every lane.
//
// The sample chain is that of the eager wavefront (integrator/smallpt.py),
// which is this kernel's plain version: seed jenkins(2x2 sub-pixel index) ^
// brev(accumulation); u = float(state) * 2^-32 with a rounded u32 -> f32
// conversion; two draws for the tent jitter; per bounce one roulette draw
// once depth + 1 > 5 on a hit, two draws for diffuse, one for glass outside
// total internal reflection, none for the mirror. The arithmetic follows the
// wavefront's formulas term by term (the stable (r - d_perp)(r + d_perp)
// discriminant, IEEE sqrt and division); nvcc's FMA contraction is the one
// difference, and on the 1e5-radius wall spheres it moves a few grazing hits
// and roulette draws, which the comparison gates count.
//
// What bounds it on an H100: operations. A pixel reads nothing but the
// 396-byte table and writes 12 bytes; a bounce costs about 9 x 40 flops of
// sphere tests plus a few dozen for shading, with two sqrt per sphere. The
// average path is a handful of bounces long, so warps diverge after the
// first bounces; this simple design does nothing about that (no path
// regeneration, no sorting).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// cam: cam_o, cam_d (unit), cx, cy — 12 floats made by the wrapper with the
// plain version's own arithmetic.
__global__ void smallpt_kernel(const float* __restrict__ spheres,
                               const int* __restrict__ bsdfs, int n_spheres,
                               const float* __restrict__ cam, int width, int height,
                               uint32_t accumulation, float* __restrict__ out) {
  __shared__ float s_sph[kMaxSpheres * 10];
  __shared__ int s_bsdf[kMaxSpheres];
  __shared__ float s_cam[12];
  for (int k = threadIdx.x; k < n_spheres * 10; k += blockDim.x) s_sph[k] = spheres[k];
  for (int k = threadIdx.x; k < n_spheres; k += blockDim.x) s_bsdf[k] = bsdfs[k];
  for (int k = threadIdx.x; k < 12; k += blockDim.x) s_cam[k] = cam[k];
  __syncthreads();

  const int pixel = blockIdx.x * blockDim.x + threadIdx.x;
  if (pixel >= width * height) return;
  const uint32_t x = pixel % width;
  const uint32_t y = pixel / width;

  uint32_t rng = pixel_seed(x, y, width, accumulation);
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
  V3 origin = cam_o + d0 * 140.0f;
  V3 direction = normalize(d0);

  V3 throughput = v3(1.0f, 1.0f, 1.0f);
  V3 radiance = v3(0.0f, 0.0f, 0.0f);

  for (int depth = 0; depth < kMaxDepth; ++depth) {
    // Nearest sphere: strict '<' over ascending ids, so the lowest id wins
    // a tie, as argmin does.
    float best_t = INFINITY;
    int best = -1;
    for (int k = 0; k < n_spheres; ++k) {
      const float* s = &s_sph[k * 10];
      const V3 op = v3(s[0], s[1], s[2]) - origin;
      const float radius = s[3];
      const float b = dot(op, direction);
      const V3 perp = op - direction * b;
      const float perp2 = dot(perp, perp);
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
    if (best < 0) break;  // a miss ends the path

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
      if (!(u_rr < max_refl)) break;
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
    if (!(max3(throughput) > 0.0f)) break;

    // Off the surface, on the side the new direction leaves through.
    const float side = dot(new_dir, norm);
    const float leave = side > 0.0f ? 1.0f : (side < 0.0f ? -1.0f : 0.0f);
    origin = pos + norm * leave * kOriginOffset;
    direction = new_dir;
  }

  out[pixel * 3 + 0] = radiance.x;
  out[pixel * 3 + 1] = radiance.y;
  out[pixel * 3 + 2] = radiance.z;
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

}  // namespace

// spheres: [n_spheres, 10] float32; bsdfs: [n_spheres] int32; cam: [12]
// float32; out: [height * width, 3] float32, row 0 at the bottom. Launches
// on `stream` with `threads` per block; returns cudaGetLastError().
extern "C" int smallpt_megakernel(const float* spheres, const int* bsdfs, int n_spheres,
                                  const float* cam, int width, int height,
                                  unsigned int accumulation, float* out, int threads,
                                  void* stream) {
  const int n = width * height;
  if (n <= 0) return 0;
  if (n_spheres > kMaxSpheres) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + threads - 1) / threads;
  smallpt_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      spheres, bsdfs, n_spheres, cam, width, height, accumulation, out);
  return static_cast<int>(cudaGetLastError());
}

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
