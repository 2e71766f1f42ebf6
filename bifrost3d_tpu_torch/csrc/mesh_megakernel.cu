// The mesh path tracer as one kernel: a whole progressive sample per pixel,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel bifrost3d_tpu/integrator/pallas_mesh.py
// ::_make_kernel (driven by render_mesh_megakernel / _render_packed): its
// dense branch (at most 1,024 triangles) and its BVH branch (_hier_tracers,
// up to 262,144 triangles). It computes what that kernel computes for every
// pixel lane, iteration by iteration in the same order: the closest hit of
// the trace (dense Möller–Trumbore, or a BVH walk); the nearest sphere-light
// or spot-disk hit; background tint on a miss; the light's radiance with
// balance-heuristic MIS on a light hit; attributes of the hit triangle;
// passthrough of a culled back face; Default shading (EON diffuse + GGX
// specular with rho-table energy compensation, optional coat lobe) or
// Diffuse shading (EON only) by the material's model; emission; RIS over up
// to 8 NEE candidates with one binary any-hit shadow ray; a BSDF sample; the
// Owen-scrambled Sobol RNG keyed by (accumulation, pixel hash, 8·bounce +
// dimension). And, behind the template flag kExtras, the kernel's three
// further branches: the environment map (bilinear latlong evaluation with
// MIS against the per-pixel pdf grid on a miss, the presampled pool as NEE
// candidate n_lights), NEAREST textures (tint-roughness and coverage) and
// cutouts with stochastic coverage and the coverage-aware shadow march.
//
// The TPU layout does not carry over. There, (8, 128) pixel tiles run every
// branch as masked vector math, the triangle trace is a (T, 128) broadcast,
// and attribute, material and rho-table fetches are one-hot MXU
// contractions. Here:
//
//   - one thread per pixel, the reference's own structure (OptiX,
//     SimpleRGPs.cu + MonteCarlo.cu); the path state stays in registers and
//     a thread leaves its loop when its path ends (a dead lane's state never
//     changes again, so the result is the TPU kernel's);
//   - a thread makes its own camera lane: its pixel (raster order, or on the
//     BVH branch one small tile per warp), the pcg2d pixel hash, the Sobol
//     camera jitter and the ray through the camera's matrices, as
//     path_tracer._camera_lanes does; it writes its radiance at its pixel in
//     raster order, or lerps it into the progressive running mean there in
//     place, so an accumulation is this one launch;
//   - the triangle table (v0, e1, e2 as three float4 records, ≤ 1024
//     triangles, at most 48 KB, copied with cp.async) with one padded box
//     per chunk of 32 consecutive triangles, the two 32×32 rho tables, the
//     material and light tables, the light kinds, the RIS offsets and the
//     4×32 Sobol direction numbers are staged in shared memory once per
//     block (≤ 60 KB in all, above the 48 KB that needs the opt-in);
//   - the dense trace visits the chunks in index order and skips one whose
//     box the ray misses or enters no nearer than its best hit, so a shadow
//     ray towards the open sky tests a few chunks' triangles instead of all
//     of them; skipped chunks hold nothing strict '<' would take, so the hit
//     is the full scan's, and a triangle test takes its reciprocal only when
//     its numerators leave it a chance;
//   - attributes are read from global memory by triangle index, materials
//     and the rho tables by index (a 4-tap bilinear fetch);
//   - only the selected branch of each select is computed (the chosen light,
//     the chosen lobe, the lane's shading model);
//   - templates cover the coat lobe, the Diffuse model and the trace (kHier);
//     light kinds are a runtime switch, uniform across a warp.
//
// The environment, texture and coverage branches (kExtras). The TPU kernel
// reads texels, the map, its pdf grid and the pool with a one-hot product on
// the MXU over tables packed (A·R, 128), and does its index arithmetic in
// float32. Here each is a table of plain records in global memory (texels
// [n, 4], map [h·w, 3], pdf [ph·pw], pool [n, 7]: 64 + 48 + 32 + 224 KB at
// the caps, too much to stage beside the triangles), read with one indexed
// load per lane through the read-only path, and indices are integers, which
// give the same cell below the caps. Which textures a material binds, and
// whether it is a cutout, is static on the TPU; here it is a small int table
// beside the material table, staged in shared memory. The shadow march makes
// up to shadow_steps closest-hit traces in place of the one any-hit trace,
// multiplying the transmittance by 1 − coverage at each surface, and, where
// the TPU kernel runs every step for every lane, a thread stops at the first
// step that hits nothing (a later step searches a part of the same segment)
// or at zero transmittance. atan2f and asinf take the place of the TPU
// kernel's Cephes polynomials; texel and cell coordinates are computed
// without FMA contraction, so that a fetch lands on the plain version's
// texel. All of it sits behind one flag with run-time branches inside, in
// two instantiations (one per trace, with the coat lobe and the Diffuse model
// compiled in and chosen per material at run time): a scene with no map, no
// bound texture, no cutout and binary shadows launches the instantiation it
// launched before this code existed.
//
// The BVH branch (kHier). The TPU kernel walks a BVH of 128-triangle clusters
// once per (8, 128) pixel block with a scalar stack, copies each entered leaf
// and its attribute columns into fast memory, tests it densely and merges the
// winner's attributes by a one-hot matrix product; dead lanes enter with
// t_max = 0. None of that carries over. Here each thread walks the port's
// triangle BVH (geometry/pallas_bvh.py::HierTriangles, leaves of at most 4
// triangles) in global memory with a private stack, so the dense
// instantiations keep their registers and their shared-memory table, and a
// dead lane has left its loop and traces nothing. The walk is
// csrc/bvh_walk.cuh's, shared with csrc/bvh_intersect.cu, over the tree's
// child records (pack_child_records: per internal node one 64-byte row with
// both children's boxes and references, rows depth-first): a step is one
// row, four independent float4 loads. Staging the top rows in shared memory
// (255 or 511 of them, with cp.async) was no faster on an H100: they stay
// in L1 (PERF.md). After a closest hit the attributes are read by SLOT:
// the wrapper packs the attribute table in the tree's leaf order (as the
// TPU kernel's does), so the hit's slot indexes it directly, neighbouring
// hits read neighbouring columns, and no slot → id table is read. Shadow rays take the walk's any-hit mode with
// t_max = dist * 0.9999. The wrapper chooses which thread renders which
// pixel (the pixel hash comes from x and y): on this branch small 2-D tiles,
// one per warp, so that a warp's rays stay close in the tree; the TPU
// kernel's 32 x 32 tile remap is the same idea at its size.
//
// Ties: the dense trace keeps the lowest triangle index on equal t (strict
// '<' over ascending indices, chunks in index order), as the TPU kernel's
// column-min does; the BVH
// walk keeps the first-found hit, leaves visited near-first, where the TPU
// kernel keeps the lowest slot of a 128-triangle cluster. RNG is bit-exact
// with the JAX package: uint32 hashes, __brev for the bit reversal, and
// __uint2float_rn(x) * 2^-32 for the conversion, which the TPU kernel's
// _u2f is defined to equal. megakernel_rng_probe exports the RNG so that a
// test can hold it bit for bit against the port's torch path_rng_4d,
// megakernel_camera_probe the camera lanes, megakernel_trace_probe the
// culled dense trace, for holding against csrc/dense_intersect.cu, and
// megakernel_hier_trace_probe the BVH walk as this file builds it, for
// holding bit for bit against csrc/bvh_intersect.cu.
//
// What bounds it on an H100: per trace the dense branch tests every chunk
// box (~24 flops each) and every triangle of the chunks it enters (~50
// flops per test), so at hundreds of triangles it is FP32-issue-bound in
// the trace; at Cornell's 34 triangles the shading math (transcendentals,
// RIS) dominates.
// The BVH branch is bound by memory latency: about 27 dependent 64-byte row
// reads (one per step) and a few 48-byte triangle reads per ray, mostly L2
// hits, rays of a warp diverging after the first bounce, at 116-127
// registers (4 blocks of 128 per SM). On the 49,678-triangle bridge at 512²
// the walks, at the walk probe's rates, are under half of the kernel's time
// and shading the rest. Reading both children's boxes from the parent's row
// did not make a step cheaper than a walk over node records, which reads
// the node's own record before its children's boxes: that record is the
// box the step before read, an L1 hit, so both walks wait for one L2 round
// trip per step.
// Divergence (paths end at different iterations; lanes pick different
// lights and lobes) and register pressure (spills are reported by ptxas)
// bound the achieved rate. This design does nothing about either: no path
// regeneration, no ray packets.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: IEEE division and square root,
// full-precision sinf/cosf/powf). nvcc contracts a*b+c into FMA, which the
// plain version does not; that moves values by an ulp and flips a few
// stochastic decisions, which the statistical gate allows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh_walk.cuh"
#include "dense_trace.cuh"

namespace {

constexpr int kMaxLights = 8;
constexpr int kMaxRis = 8;
constexpr int kRho = 32;
constexpr float kBig = 3.0e38f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kInvPi = 0.31830988618379067154f;
constexpr float kMinAlpha = 1e-4f;
constexpr float kMinCos = 1e-6f;
constexpr float kMinSpotCone = 1e-5f;
constexpr float kCoatIor = 1.5f;
constexpr float kCoatSpecularity = 0.04f;
// EON constants (bsdf/oren_nayar.py), rounded from double as JAX does.
constexpr float kC1Fon = (float)(0.5 - 2.0 / (3.0 * 3.14159265358979323846));
constexpr float kC2Fon = (float)(2.0 / 3.0 - 28.0 / (15.0 * 3.14159265358979323846));
constexpr float kXCoat = (float)(1.0 - 1.0 / 1.5);

constexpr int kSphere = 0;
constexpr int kSpot = 1;   // any other kind is directional

}  // namespace

struct MegakernelParams {
  const float* tri;          // dense: [t_pad, 16]: v0 0-2, e1 3-5, e2 6-8;
                             // hier: [t_pad, 12] records in slot order
  const float* records;      // hier: [n_records, 16] child records
                             // (pack_child_records); dense: unused
  const float* attr;         // [24, t_pad] (hier: columns in slot order)
  const float* mats;         // [n_mats, 16]
  const float* lights;       // [>= n_lights, 12]
  const float* rho_ggx;      // [32, 32], [roughness][cos_theta]
  const float* rho_fres;     // [32, 32]
  const uint32_t* sobol;     // [4, 32] direction numbers
  // The camera (scene/camera.PinholeCamera), on the device:
  const float* cam_inv_proj;     // [4, 4] inverse projection, row-major
  const float* cam_translation;  // [3]
  const float* cam_rotation;     // [4] quaternion x, y, z, w
  const float* cam_scale;        // [1]
  const float* scalars;      // epsilon, background rgb
  float* out;                // [n_pixels, 3] radiance, then [n_pixels] rays,
                             // both in raster order
  // kExtras only (null otherwise):
  const float* texels;       // [n_texels, 4]: level 0 of every texture in turn
  const int* tex_meta;       // [n_tex, 6]: first texel, width, height, wrap_u,
                             // wrap_v (1 = repeat, 0 = clamp), filter
  const int* mat_tex;        // [n_mats, 4]: tint-roughness texture, coverage
                             // texture (-1 = none), is cutout
  const float* env_img;      // [env_h * env_w, 3] latlong radiance
  const float* env_pdf;      // [env_ph * env_pw] solid-angle pdf without 1/sin
  const float* env_pool;     // [env_pool_n, 7]: direction, radiance, pdf
  int width, height;         // the frame; n_pixels = width * height
  int tile_w, tile_h;        // pixel tile per warp, or 0 = raster order
  int n_pixels, n_tris, t_pad, n_mats, n_lights;
  int light_kinds[kMaxLights];
  uint32_t accumulation;
  int n_iters, max_bounce, ris_count;
  float firefly_clamp, delta_light_clamp;
  float ris_offsets[kMaxRis * 4];
  int has_coat, has_diffuse, hier;
  int extras;                // launch the kExtras instantiation
  int n_tex;
  int any_coverage;          // discard hits by coverage
  int shadow_steps;          // 0 = one binary any-hit shadow ray
  int has_env;               // scalars[1:4] is then the map's tint
  int env_w, env_h, env_pw, env_ph, env_pool_n;
  int n_nee_total;           // n_lights, + 1 when the pool holds > 1 sample
  // Last, so that the fields above keep their offsets: placed among them,
  // these two gave the kHier + kExtras instantiation 3 more registers.
  float* accum;              // null, or the running mean [n_pixels, 3] in
                             // raster order, which the frame is lerped into
                             // in place (out is then unused)
  float inv_n;               // with accum: the lerp's weight, 1 / (n + 1)
};

namespace {

// -- vec3 -------------------------------------------------------------------

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 mk(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ float max3(V3 a) { return fmaxf(fmaxf(a.x, a.y), a.z); }
__device__ __forceinline__ V3 vmin(V3 a, float m) {
  return {fminf(a.x, m), fminf(a.y, m), fminf(a.z, m)};
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 normalize(V3 a) {
  return scale(a, 1.0f / sqrtf(fmaxf(dot(a, a), 1e-30f)));
}
__device__ __forceinline__ float lerp(float a, float b, float t) { return a + (b - a) * t; }
__device__ __forceinline__ float gsafe(float x) { return fmaxf(x, 1e-12f); }
__device__ __forceinline__ float sq(float x) { return x * x; }

// Duff et al. branch-free tangent basis (math/vec.py orthonormal_basis).
__device__ __forceinline__ void onb(V3 n, V3& t, V3& b) {
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + n.z);
  const float bb = n.x * n.y * a;
  t = mk(1.0f + sign * n.x * n.x * a, sign * bb, -sign * n.x);
  b = mk(bb, sign + n.y * n.y * a, -n.y);
}
__device__ __forceinline__ V3 to_local(V3 v, V3 n) {
  V3 t, b;
  onb(n, t, b);
  return mk(dot(v, t), dot(v, b), dot(v, n));
}
__device__ __forceinline__ V3 to_world(V3 v, V3 n) {
  V3 t, b;
  onb(n, t, b);
  return mk(v.x * t.x + v.y * b.x + v.z * n.x, v.x * t.y + v.y * b.y + v.z * n.y,
            v.x * t.z + v.y * b.z + v.z * n.z);
}
__device__ __forceinline__ V3 reflect(V3 d, V3 n) { return sub(d, scale(n, 2.0f * dot(d, n))); }

// RT Gems integer ray offset (math/ray_offset.py): float bits as int32,
// float -> int truncation toward zero as astype(int32).
__device__ __forceinline__ float offset_c(float p, float n) {
  const int of_i = static_cast<int>(256.0f * n);
  const int p_i = __float_as_int(p) + (p < 0.0f ? -of_i : of_i);
  return fabsf(p) < 1.0f / 32.0f ? p + (1.0f / 65536.0f) * n : __int_as_float(p_i);
}
__device__ __forceinline__ V3 offset_ray_origin(V3 p, V3 n) {
  return mk(offset_c(p.x, n.x), offset_c(p.y, n.y), offset_c(p.z, n.z));
}

// -- RNG (sampling/hashes.py + sobol.py) --------------------------------------

__device__ __forceinline__ uint32_t cessen_owen_hash(uint32_t x, uint32_t seed) {
  x ^= x * 0x3D20ADEAu;
  x += seed;
  x *= (seed >> 16) | 1u;
  x ^= x * 0x05526C56u;
  x ^= x * 0x53A22864u;
  return x;
}

__device__ __forceinline__ uint32_t nested_uniform_scramble(uint32_t x, uint32_t seed) {
  return __brev(cessen_owen_hash(__brev(x), seed));
}

__device__ __forceinline__ uint32_t pcg2d_x(uint32_t x, uint32_t y) {
  x = x * 1664525u + 1013904223u;
  y = y * 1664525u + 1013904223u;
  x += y * 1664525u;
  y += x * 1664525u;
  x ^= x >> 16;
  y ^= y >> 16;
  x += y * 1664525u;
  return x ^ (x >> 16);
}

// path_rng_4d: seed = pcg2d(pixel_hash, dimension).x; 4 Owen-scrambled
// Sobol coordinates of point `accumulation`, each in [0, 1].
__device__ void path_rng_4d(uint32_t accumulation, uint32_t pixel_hash, uint32_t dimension,
                            const uint32_t* __restrict__ dirs, float u[4]) {
  const uint32_t seed = pcg2d_x(pixel_hash, dimension);
  const uint32_t index = nested_uniform_scramble(accumulation, seed);
  uint32_t res[4] = {0u, 0u, 0u, 0u};
  for (int b = 0; b < 32; ++b) {
    const uint32_t m = 0u - ((index >> b) & 1u);
#pragma unroll
    for (int d = 0; d < 4; ++d) res[d] ^= dirs[d * 32 + b] & m;
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const uint32_t dseed = seed ^ (static_cast<uint32_t>(d) + (seed << 6) + (seed >> 2));
    u[d] = __uint2float_rn(nested_uniform_scramble(res[d], dseed)) * 2.3283064365386963e-10f;
  }
}

__device__ __forceinline__ float toroidal_shift(float u, float off) {
  const float s = u + off;
  return s - floorf(s);
}

// -- MIS and the rho lookups --------------------------------------------------

__device__ __forceinline__ float mis_weight(float p1, float p2) {
  const float divisor = p1 + p2;
  const float r = p1 / (divisor == 0.0f ? 1.0f : divisor);
  const bool invalid = isinf(divisor) || isnan(r);
  return invalid ? (p1 <= p2 ? 0.0f : 1.0f) : r;
}

// Bilinear fetch of table[y][x], coordinates clipped to [0, 1] and scaled to
// the 32-entry axes, with the hat weights max(0, 1 - |f - i|) of
// shading/fittings._bilinear_2d (only two are non-zero per axis).
__device__ float rho_lookup(const float* __restrict__ tab, float x, float y) {
  const float fx = fminf(fmaxf(x, 0.0f), 1.0f) * 31.0f;
  const float fy = fminf(fmaxf(y, 0.0f), 1.0f) * 31.0f;
  const int ix = min(static_cast<int>(floorf(fx)), kRho - 2);
  const int iy = min(static_cast<int>(floorf(fy)), kRho - 2);
  const float wx0 = fmaxf(0.0f, 1.0f - fabsf(fx - static_cast<float>(ix)));
  const float wx1 = fmaxf(0.0f, 1.0f - fabsf(fx - static_cast<float>(ix + 1)));
  const float wy0 = fmaxf(0.0f, 1.0f - fabsf(fy - static_cast<float>(iy)));
  const float wy1 = fmaxf(0.0f, 1.0f - fabsf(fy - static_cast<float>(iy + 1)));
  const float c0 = wy0 * tab[iy * kRho + ix] + wy1 * tab[(iy + 1) * kRho + ix];
  const float c1 = wy0 * tab[iy * kRho + ix + 1] + wy1 * tab[(iy + 1) * kRho + ix + 1];
  return wx0 * c0 + wx1 * c1;
}

// -- GGX reflection (bsdf/ggx.py) -----------------------------------------------

__device__ __forceinline__ float ggx_ndf(float alpha, float abs_cos) {
  const float a2 = alpha * alpha;
  const float c2 = abs_cos * abs_cos;
  const float s2 = fmaxf(1.0f - c2, 0.0f);
  const float q = fmaxf(c2 * a2 + s2, 1e-9f);
  return a2 / (kPi * q * q);
}

__device__ __forceinline__ float ggx_lambda(float alpha, V3 w) {
  const float z2 = fmaxf(w.z * w.z, 1e-12f);
  return 0.5f * (-1.0f + sqrtf(1.0f + (sq(alpha * w.x) + sq(alpha * w.y)) / z2));
}

__device__ __forceinline__ V3 schlick(V3 spec, float abs_cos) {
  const float t = fmaxf(1.0f - abs_cos, 0.0f);
  const float t2 = t * t;
  const float t5 = t2 * t2 * t;
  return mk((1.0f - t5) * spec.x + t5, (1.0f - t5) * spec.y + t5, (1.0f - t5) * spec.z + t5);
}

__device__ __forceinline__ float bounded_k(float alpha, V3 wo) {
  const float a2 = alpha * alpha;
  const float s = 1.0f + sqrtf(gsafe(wo.x * wo.x + wo.y * wo.y));
  const float s2 = s * s;
  return (1.0f - a2) * s2 / (s2 + a2 * wo.z * wo.z);
}

__device__ float ggx_bounded_vndf_pdf(float alpha, V3 wo, V3 wi) {
  const V3 h = normalize(add(wo, wi));
  const float ndf = ggx_ndf(alpha, fabsf(h.z));
  const float ao2 = sq(alpha * wo.x) + sq(alpha * wo.y);
  const float t = sqrtf(gsafe(ao2 + wo.z * wo.z));
  if (wo.z < 0.0f) return ndf * (t - wo.z) / fmaxf(2.0f * ao2, 1e-10f);
  const float k = bounded_k(alpha, wo);
  return ndf / (2.0f * (k * wo.z + t));
}

__device__ V3 ggx_r_evaluate(float alpha, V3 spec, V3 wo, V3 wi) {
  if (alpha <= kMinAlpha || !(wo.z * wi.z > 0.0f)) return mk(0.0f, 0.0f, 0.0f);
  const V3 h = normalize(add(wo, wi));
  const float g = 1.0f / (1.0f + ggx_lambda(alpha, wo) + ggx_lambda(alpha, wi));
  const float d = ggx_ndf(alpha, fabsf(h.z));
  const V3 f = schlick(spec, fabsf(dot(wo, h)));
  const float denom = 4.0f * wo.z * wi.z;
  return scale(f, d * g / (fabsf(denom) > 1e-10f ? denom : 1.0f));
}

__device__ float ggx_r_pdf(float alpha, V3 wo, V3 wi) {
  if (alpha <= kMinAlpha || !(wo.z * wi.z > 0.0f)) return 0.0f;
  return ggx_bounded_vndf_pdf(alpha, wo, wi);
}

// → wi, and pdf / delta flag / f of the lobe's own sample.
__device__ V3 ggx_r_sample(float alpha, V3 spec, V3 wo, float u0, float u1, float& pdf,
                           bool& is_delta, V3& f) {
  if (alpha <= kMinAlpha) {
    is_delta = true;
    pdf = 1.0f;
    f = scale(schlick(spec, fabsf(wo.z)), 1.0f / fmaxf(fabsf(wo.z), 1e-7f));
    return mk(-wo.x, -wo.y, wo.z);
  }
  is_delta = false;
  const V3 wo_std = normalize(mk(wo.x * alpha, wo.y * alpha, wo.z));
  const float phi = kTwoPi * u1;
  const float k = bounded_k(alpha, wo);
  const float b = wo.z >= 0.0f ? k * wo_std.z : wo_std.z;
  const float z = (1.0f - u0) * (1.0f + b) - b;
  const float sin_theta = sqrtf(fminf(fmaxf(1.0f - z * z, 1e-12f), 1.0f));
  const V3 h_std = add(wo_std, mk(sin_theta * cosf(phi), sin_theta * sinf(phi), z));
  const V3 h = normalize(mk(h_std.x * alpha, h_std.y * alpha, h_std.z));
  const V3 wi = reflect(neg(wo), h);
  if (wi.z < 0.0f) {
    pdf = 0.0f;
    f = mk(0.0f, 0.0f, 0.0f);
  } else {
    pdf = ggx_bounded_vndf_pdf(alpha, wo, wi);
    f = ggx_r_evaluate(alpha, spec, wo, wi);
  }
  return wi;
}

// -- EON Oren-Nayar (bsdf/oren_nayar.py + its CLTC sampler) ---------------------

__device__ float eon_evaluate_scalar(float roughness, V3 wo, V3 wi) {
  const float cos_i = wi.z, cos_o = wo.z;
  const float s = dot(wi, wo) - cos_i * cos_o;
  const float s_over_t = s > 0.0f ? s / fmaxf(fmaxf(cos_i, cos_o), 1e-7f) : s;
  const float a = 1.0f / (1.0f + kC1Fon * roughness);
  const float b = roughness * a;
  const float f_single = kInvPi * a * (1.0f + roughness * s_over_t);
  float g_o = 0.0f, g_i = 0.0f;
  const float mo = 1.0f - cos_o, mi = 1.0f - cos_i;
  const float coeffs[4] = {0.0714429953f, -0.332181442f, 0.491881867f, 0.0571085289f};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    g_o = mo * (coeffs[c] + g_o);
    g_i = mi * (coeffs[c] + g_i);
  }
  const float ef_o = a + b * g_o;
  const float ef_i = a + b * g_i;
  const float avg_ef = a * (1.0f + kC2Fon * roughness);
  const float f_multi =
      kInvPi * fabsf(1.0f - ef_o) * fabsf(1.0f - ef_i) / fmaxf(1e-7f, 1.0f - avg_ef);
  return f_single + f_multi;
}

__device__ __forceinline__ float eon_uniform_probability(float roughness, float c) {
  return powf(fmaxf(roughness, 1e-7f), 0.1f) *
         (0.162925f + c * (-0.372058f + (0.538233f - 0.290822f * c) * c));
}

__device__ __forceinline__ void cltc_coeffs(float mu, float r, float& a, float& b, float& c,
                                            float& d) {
  a = 1.0f + r * (0.303392f + (-0.518982f + 0.111709f * mu) * mu +
                  (-0.276266f + 0.335918f * mu) * r);
  b = r * (-1.16407f + 1.15859f * mu + (0.150815f - 0.150105f * mu) * r) /
      (mu * mu * mu - 1.43545f);
  c = 1.0f + (0.20013f + (-0.506373f + 0.261777f * mu) * mu) * r;
  d = ((0.540852f + (-1.01625f + 0.475392f * mu) * mu) * r) / (-1.0743f + mu * (0.0725628f + mu));
}

__device__ __forceinline__ void ltc_tangent(V3 wo, float& cx, float& sx) {
  const float len2 = wo.x * wo.x + wo.y * wo.y;
  const float inv = 1.0f / sqrtf(fmaxf(len2, 1e-20f));
  cx = len2 > 0.0f ? wo.x * inv : 1.0f;
  sx = len2 > 0.0f ? wo.y * inv : 0.0f;
}

__device__ float eon_pdf(float roughness, V3 wo, V3 wi) {
  const float u_prob = eon_uniform_probability(roughness, wo.z);
  float cx, sx;
  ltc_tangent(wo, cx, sx);
  const float lx = cx * wi.x + sx * wi.y;
  const float ly = -sx * wi.x + cx * wi.y;
  const float lz = wi.z;
  float a, b, c, d;
  cltc_coeffs(wo.z, roughness, a, b, c, d);
  const float det_m = c * (a - b * d);
  const float whx = c * (lx - b * lz);
  const float why = (a - b * d) * ly;
  const float whz = -c * (d * lx - a * lz);
  const float wh_mag2 = whx * whx + why * why + whz * whz;
  const float vz = 1.0f / sqrtf(d * d + 1.0f);
  const float s = 0.5f * (1.0f + vz);
  const float cltc =
      det_m * det_m / fmaxf(sq(wh_mag2), 1e-10f) * fmaxf(whz, 0.0f) / (kPi * s);
  return u_prob * (0.5f * kInvPi) + (1.0f - u_prob) * cltc;
}

__device__ V3 eon_sample(float roughness, V3 wo, float u0, float u1) {
  const float u_prob = eon_uniform_probability(roughness, wo.z);
  const bool pick_uniform = u0 <= u_prob;
  const float ux = fminf(fmaxf(pick_uniform ? u0 / fmaxf(u_prob, 1e-7f)
                                            : (u0 - u_prob) / fmaxf(1.0f - u_prob, 1e-7f),
                               0.0f),
                         0.9999999f);
  const float phi = kTwoPi * u1;
  if (pick_uniform) {
    const float r = sqrtf(gsafe(1.0f - ux * ux));
    return mk(r * cosf(phi), r * sinf(phi), ux);
  }
  float a, b, c, d;
  cltc_coeffs(wo.z, roughness, a, b, c, d);
  const float radius = sqrtf(ux);
  float x = radius * cosf(phi);
  const float y = radius * sinf(phi);
  const float vz = 1.0f / sqrtf(d * d + 1.0f);
  const float s = 0.5f * (1.0f + vz);
  x = -lerp(sqrtf(gsafe(1.0f - y * y)), x, s);
  const float whz = sqrtf(gsafe(1.0f - (x * x + y * y)));
  const V3 wi = mk(a * x + b * whz, c * y, d * x + whz);
  float cx, sx;
  ltc_tangent(wo, cx, sx);
  return normalize(mk(cx * wi.x - sx * wi.y, sx * wi.x + cx * wi.y, wi.z));
}

// -- shading models (shading/default_shading.py, diffuse_shading.py) ---------

// A conductor's specularity re-based under the coat medium (bsdf/fresnel.py,
// exterior IOR 1.5; NaN → 1).
__device__ __forceinline__ float coated_conductor(float tint, float coat) {
  const float s = fminf(fmaxf(tint, 0.0f), 0.9999f);
  const float a = s - 1.0f;
  const float b = 2.0f * s + 2.0f;
  const float d = b * b - 4.0f * a * a;
  const float ior = (-b + sqrtf(fmaxf(d, 0.0f))) / (2.0f * a);
  float cs = sq((kCoatIor - ior) / (kCoatIor + ior));
  if (isnan(cs)) cs = 1.0f;
  return lerp(tint, cs, coat);
}

struct Shading {
  V3 tint;        // the material's tint (the Diffuse model's albedo)
  V3 diffuse_tint;
  V3 specularity;
  float roughness, alpha, specular_scale, specular_probability;
  float coat_scale, coat_alpha, coat_probability;
  bool diffuse_model;
};

template <bool kCoat>
__device__ Shading shading_create(const float* __restrict__ rho_ggx,
                                  const float* __restrict__ rho_fres, V3 tint, float roughness,
                                  float specularity, float metallic, float abs_cos_o, float coat,
                                  float coat_roughness) {
  Shading sh;
  sh.tint = tint;
  sh.diffuse_model = false;
  V3 conductor = tint;
  const bool has_coat = kCoat && coat > 0.0f;
  if (has_coat) {
    // Coat-modulated base roughness (OpenPBR eq. 86, Utils.h:363-367).
    const float r4 = fminf(1.0f, powf(roughness, 4.0f) + 2.0f * kXCoat * powf(coat_roughness, 4.0f));
    roughness = lerp(roughness, powf(r4, 0.25f), coat);
    // Specularities re-based under the coat medium (bsdf/fresnel.py).
    if (specularity < 1.0f) {
      const float base_ior = 2.0f / (1.0f - sqrtf(fminf(specularity, 0.9999f))) - 1.0f;
      specularity = lerp(specularity, sq((kCoatIor - base_ior) / (kCoatIor + base_ior)), coat);
    }
    conductor = mk(coated_conductor(tint.x, coat), coated_conductor(tint.y, coat),
                   coated_conductor(tint.z, coat));
  }
  const float base = rho_lookup(rho_fres, abs_cos_o, roughness);
  const float full = rho_lookup(rho_ggx, abs_cos_o, roughness);
  float reflection_scale = 1.0f / fmaxf(full, 1e-5f);
  const float rho = lerp(base, full, specularity) * reflection_scale;
  V3 diffuse_tint = scale(scale(tint, 1.0f - rho), 1.0f - metallic);
  sh.specularity = mk(lerp(specularity, conductor.x, metallic),
                      lerp(specularity, conductor.y, metallic),
                      lerp(specularity, conductor.z, metallic));
  float coat_rho = 0.0f;
  sh.coat_scale = 0.0f;
  sh.coat_alpha = 0.0f;
  if (has_coat) {
    // Coat layer: GGX with fixed IOR 1.5 / specularity 0.04.
    const float cbase = rho_lookup(rho_fres, abs_cos_o, coat_roughness);
    const float cfull = rho_lookup(rho_ggx, abs_cos_o, coat_roughness);
    const float coat_refl_scale = coat / fmaxf(cfull, 1e-5f);
    coat_rho = lerp(cbase, cfull, kCoatSpecularity) * coat_refl_scale;
    const float coat_transmission = 1.0f - coat_rho;
    sh.coat_scale = coat_refl_scale;
    sh.coat_alpha = fmaxf(kMinAlpha, coat_roughness * coat_roughness);
    reflection_scale *= coat_transmission;
    diffuse_tint = scale(diffuse_tint, coat_transmission);
  }
  const float spec_rho_sum = lerp(base, full, sh.specularity.x) * reflection_scale +
                             lerp(base, full, sh.specularity.y) * reflection_scale +
                             lerp(base, full, sh.specularity.z) * reflection_scale;
  const float diffuse_rho_sum = diffuse_tint.x + diffuse_tint.y + diffuse_tint.z;
  const float coat_rho_sum = 3.0f * coat_rho;
  const float recip = 1.0f / fmaxf(diffuse_rho_sum + spec_rho_sum + coat_rho_sum, 1e-9f);
  sh.diffuse_tint = diffuse_tint;
  sh.roughness = roughness;
  sh.alpha = fmaxf(kMinAlpha, roughness * roughness);
  sh.specular_scale = reflection_scale;
  sh.specular_probability = spec_rho_sum * recip;
  sh.coat_probability = coat_rho_sum * recip;
  return sh;
}

template <bool kCoat>
__device__ V3 shading_evaluate(const Shading& sh, V3 wo, V3 wi, float& pdf) {
  pdf = 0.0f;
  if (!(wo.z > kMinCos && wi.z > kMinCos)) return mk(0.0f, 0.0f, 0.0f);
  const float d_scalar = eon_evaluate_scalar(sh.roughness, wo, wi);
  const float d_pdf = eon_pdf(sh.roughness, wo, wi);
  if (sh.diffuse_model) {
    pdf = d_pdf;
    return scale(sh.tint, d_scalar);
  }
  const V3 s_f = ggx_r_evaluate(sh.alpha, sh.specularity, wo, wi);
  const float s_pdf = ggx_r_pdf(sh.alpha, wo, wi);
  const float sp = sh.specular_probability;
  V3 f = add(scale(sh.diffuse_tint, d_scalar), scale(s_f, sh.specular_scale));
  if (kCoat) {
    const V3 spec04 = mk(kCoatSpecularity, kCoatSpecularity, kCoatSpecularity);
    const V3 c_f = ggx_r_evaluate(sh.coat_alpha, spec04, wo, wi);
    const float c_pdf = ggx_r_pdf(sh.coat_alpha, wo, wi);
    const float cp = sh.coat_probability;
    f = add(f, scale(c_f, sh.coat_scale));
    pdf = d_pdf * (1.0f - sp - cp) + s_pdf * sp + c_pdf * cp;
  } else {
    pdf = d_pdf * (1.0f - sp) + s_pdf * sp;
  }
  return f;
}

// → wi; pdf, is_delta and f of the sample (DefaultShading.h:218-280, or
// the Diffuse model's EON sample).
template <bool kCoat>
__device__ V3 shading_sample(const Shading& sh, V3 wo, float u0, float u1, float u2, float& pdf,
                             bool& is_delta, V3& f) {
  const bool frontside = wo.z > kMinCos;
  is_delta = false;
  if (sh.diffuse_model) {
    const V3 wi = eon_sample(sh.roughness, wo, u0, u1);
    f = frontside ? scale(sh.tint, eon_evaluate_scalar(sh.roughness, wo, wi)) : mk(0.0f, 0.0f, 0.0f);
    pdf = frontside ? eon_pdf(sh.roughness, wo, wi) : 0.0f;
    return wi;
  }
  const float cp = kCoat ? sh.coat_probability : 0.0f;
  const bool sample_coat = kCoat && u2 < cp;
  const bool sample_specular = !sample_coat && u2 < cp + sh.specular_probability;
  V3 wi;
  V3 lobe_f = mk(0.0f, 0.0f, 0.0f);
  float lobe_pdf = 0.0f;
  bool lobe_delta = false;
  if (sample_coat) {
    const V3 spec04 = mk(kCoatSpecularity, kCoatSpecularity, kCoatSpecularity);
    wi = ggx_r_sample(sh.coat_alpha, spec04, wo, u0, u1, lobe_pdf, lobe_delta, lobe_f);
  } else if (sample_specular) {
    wi = ggx_r_sample(sh.alpha, sh.specularity, wo, u0, u1, lobe_pdf, lobe_delta, lobe_f);
  } else {
    wi = eon_sample(sh.roughness, wo, u0, u1);
  }
  if (lobe_delta) {
    // A smooth lobe is a delta mirror: keep the lobe's own sample.
    pdf = sample_coat ? cp : sh.specular_probability;
    f = scale(lobe_f, sample_coat ? sh.coat_scale : sh.specular_scale);
    is_delta = frontside;
    return wi;
  }
  f = shading_evaluate<kCoat>(sh, wo, wi, pdf);
  return wi;
}

// -- lights (lights/analytic.py; a row of 12: position 0-2, radius 3,
//    power 4-6, direction 7-9, cos_angle 10) ---------------------------------

struct Light {
  V3 pos, power, dir;
  float radius, cos_angle;
};

__device__ __forceinline__ Light load_light(const float* __restrict__ row) {
  Light l;
  l.pos = mk(row[0], row[1], row[2]);
  l.radius = row[3];
  l.power = mk(row[4], row[5], row[6]);
  l.dir = mk(row[7], row[8], row[9]);
  l.cos_angle = row[10];
  return l;
}

__device__ __forceinline__ float ray_plane_t(V3 o, V3 d, V3 p, V3 n) {
  const float denom = dot(d, n);
  return (dot(p, n) - dot(o, n)) / (fabsf(denom) > 1e-9f ? denom : 1e-9f);
}

__device__ float ray_sphere_t(V3 o, V3 d, const Light& l) {
  const V3 op = sub(l.pos, o);
  const float b = dot(op, d);
  const float det = l.radius * l.radius - (dot(op, op) - b * b);
  const float sqrt_det = sqrtf(gsafe(det));
  const float t = b - sqrt_det > 0.0f ? b - sqrt_det : b + sqrt_det;
  return (det >= 0.0f && t > 0.0f && l.radius > 0.0f) ? t : kBig;
}

__device__ float ray_spot_disk_t(V3 o, V3 d, const Light& l) {
  const float denom = dot(d, l.dir);
  const float t = ray_plane_t(o, d, l.pos, l.dir);
  const V3 off = sub(add(o, scale(d, t)), l.pos);
  const bool on_disk = dot(off, off) <= l.radius * l.radius;
  return (on_disk && fabsf(denom) > 1e-9f && t > 0.0f && l.radius > 0.0f) ? t : kBig;
}

__device__ __forceinline__ V3 sphere_light_evaluate(const Light& l) {
  const float area = 4.0f * kPi * l.radius * l.radius;
  return scale(l.power, 1.0f / fmaxf(kPi * area, 1e-10f));
}

__device__ float sphere_light_pdf(const Light& l, V3 lit, V3 direction) {
  const V3 to_center = sub(l.pos, lit);
  const float sin2 = l.radius * l.radius / fmaxf(dot(to_center, to_center), 1e-10f);
  const float cos_theta_max = sqrtf(gsafe(1.0f - sin2));
  const float cos_theta = dot(direction, normalize(to_center));
  return (cos_theta >= cos_theta_max && sin2 > 0.0f)
             ? 1.0f / (kTwoPi * fmaxf(1.0f - cos_theta_max, 1e-10f))
             : 0.0f;
}

__device__ V3 spot_light_evaluate(const Light& l, V3 lit, V3 direction) {
  const float cos_theta = -dot(l.dir, direction);
  const V3 diff = sub(l.pos, lit);
  const float norm = kTwoPi * (1.0f - l.cos_angle) *
                     (l.radius == 0.0f ? dot(diff, diff) : kPi * l.radius * l.radius * cos_theta);
  const float inv = 1.0f / fmaxf(norm, 1e-10f);
  return cos_theta > l.cos_angle ? scale(l.power, inv) : mk(0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ bool spot_use_cone(const Light& l, V3 lit) {
  const float t_plane = ray_plane_t(lit, neg(l.dir), l.pos, l.dir);
  const float cone_radius_at =
      t_plane * sqrtf(gsafe(1.0f - l.cos_angle * l.cos_angle)) / fmaxf(l.cos_angle, 1e-9f);
  return l.radius > cone_radius_at && l.cos_angle > kMinSpotCone;
}

__device__ float spot_light_pdf(const Light& l, V3 lit, V3 direction) {
  const float cos_theta = -dot(l.dir, direction);
  if (!(cos_theta > 0.0f && l.radius > 0.0f)) return 0.0f;
  if (spot_use_cone(l, lit)) return 1.0f / (kTwoPi * fmaxf(1.0f - l.cos_angle, 1e-10f));
  const float t = ray_plane_t(lit, direction, l.pos, l.dir);
  const V3 off = sub(add(lit, scale(direction, t)), l.pos);
  const bool on_disk = t >= 0.0f && dot(off, off) < l.radius * l.radius;
  return on_disk ? (1.0f / (kPi * fmaxf(l.radius * l.radius, 1e-18f))) * t * t /
                       fmaxf(cos_theta, 1e-9f)
                 : 0.0f;
}

struct LightSample {
  V3 dir, radiance;
  float dist, pdf;
  bool is_delta;
};

__device__ LightSample sphere_light_sample(const Light& l, V3 lit, float u0, float u1) {
  LightSample s;
  const V3 to_center = sub(l.pos, lit);
  const float dist2 = dot(to_center, to_center);
  const float sin2 = l.radius * l.radius / fmaxf(dist2, 1e-10f);
  if (sin2 <= 0.0f) {   // a point light
    const float dist = sqrtf(gsafe(dist2));
    s.dir = scale(to_center, 1.0f / fmaxf(dist, 1e-10f));
    s.dist = (dist - l.radius) * 0.999999f;
    s.radiance = scale(l.power, 1.0f / (4.0f * kPi * dist2));
    s.pdf = 1.0f;
    s.is_delta = true;
    return s;
  }
  const float cos_theta_max = sqrtf(gsafe(1.0f - sin2));
  const float cos_theta = (1.0f - u0) + u0 * cos_theta_max;
  const float sin_theta = sqrtf(gsafe(1.0f - cos_theta * cos_theta));
  const float phi = kTwoPi * u1;
  const V3 cone_dir = mk(cosf(phi) * sin_theta, sinf(phi) * sin_theta, cos_theta);
  const V3 direction = to_world(cone_dir, normalize(to_center));
  // The exact sphere distance from the lit point.
  const float b = dot(to_center, direction);
  const float det = l.radius * l.radius - (dist2 - b * b);
  const float sqrt_det = sqrtf(gsafe(det));
  float t = b - sqrt_det > 0.0f ? b - sqrt_det : b + sqrt_det;
  t = (det >= 0.0f && t > 0.0f) ? t : -1.0f;
  if (t <= 0.0f) t = b;
  s.dir = direction;
  s.dist = t * 0.999999f;
  s.radiance = sphere_light_evaluate(l);
  s.pdf = 1.0f / (kTwoPi * fmaxf(1.0f - cos_theta_max, 1e-10f));
  s.is_delta = false;
  return s;
}

__device__ LightSample spot_light_sample(const Light& l, V3 lit, float u0, float u1) {
  LightSample s;
  if (l.radius == 0.0f) {   // a delta spot
    const V3 to_light = sub(l.pos, lit);
    const float dist = sqrtf(gsafe(dot(to_light, to_light)));
    s.dir = scale(to_light, 1.0f / fmaxf(dist, 1e-10f));
    s.dist = dist * 0.999999f;
    s.radiance = spot_light_evaluate(l, lit, s.dir);
    s.pdf = 1.0f;
    s.is_delta = true;
    return s;
  }
  s.is_delta = false;
  if (spot_use_cone(l, lit)) {
    // Sample the cone about the spot axis, pointing backwards.
    const float cos_theta = (1.0f - u0) + u0 * l.cos_angle;
    const float sin_theta = sqrtf(gsafe(1.0f - cos_theta * cos_theta));
    const float phi = kTwoPi * u1;
    const V3 dir_cone =
        neg(to_world(mk(cosf(phi) * sin_theta, sinf(phi) * sin_theta, cos_theta), l.dir));
    const float t_cone = ray_plane_t(lit, dir_cone, l.pos, l.dir);
    const V3 off = sub(add(lit, scale(dir_cone, t_cone)), l.pos);
    const bool on_light = dot(off, off) < l.radius * l.radius;
    s.dir = dir_cone;
    s.dist = t_cone * 0.999999f;
    s.radiance = on_light ? spot_light_evaluate(l, lit, dir_cone) : mk(0.0f, 0.0f, 0.0f);
    s.pdf = 1.0f / (kTwoPi * fmaxf(1.0f - l.cos_angle, 1e-10f));
    return s;
  }
  // Sample the disk (concentric mapping, Distributions.h).
  const float r_safe = fmaxf(l.radius, 1e-9f);
  const float a = 2.0f * u0 - 1.0f;
  float b = 2.0f * u1 - 1.0f;
  if (b == 0.0f) b = 1.0f;
  const bool use_a = a * a > b * b;
  const float rr = (use_a ? a : b) * r_safe;
  const float safe_a = a == 0.0f ? 1.0f : a;
  const float phi_d = use_a ? (kPi / 4.0f) * (b / safe_a) : (kPi / 2.0f) - (kPi / 4.0f) * (a / b);
  const float dx = rr * cosf(phi_d);
  const float dy = rr * sinf(phi_d);
  const float disk_p = 1.0f / (kPi * r_safe * r_safe);
  const bool axis_x = fabsf(l.dir.x) > 0.9f;
  const V3 tangent = normalize(cross(mk(axis_x ? 0.0f : 1.0f, axis_x ? 1.0f : 0.0f, 0.0f), l.dir));
  const V3 bitangent = cross(l.dir, tangent);
  const V3 sampled = add(l.pos, add(scale(tangent, dx), scale(bitangent, dy)));
  const V3 to_s = sub(sampled, lit);
  const float dist_disk = sqrtf(gsafe(dot(to_s, to_s)));
  s.dir = scale(to_s, 1.0f / fmaxf(dist_disk, 1e-10f));
  s.dist = dist_disk * 0.999999f;
  s.radiance = spot_light_evaluate(l, lit, s.dir);
  s.pdf = disk_p * dist_disk * dist_disk / fmaxf(-dot(l.dir, s.dir), 1e-9f);
  return s;
}

// -- trace (dense Möller–Trumbore, culled by chunk) ----------------------------
//
// The staged table holds one 48-byte record per triangle and one padded box
// per chunk of dense_trace::kChunk consecutive triangles; the trace, the
// boxes and why the cull keeps the full scan's answer are in
// csrc/dense_trace.cuh, shared with csrc/dense_intersect.cu and
// csrc/clustered_intersect.cu.

using dense_trace::kChunk;
using dense_trace::trace_dense;

// Stages the first 12 floats of each [n_tris, 16] row of `tri` into s_tri4
// with cp.async, then builds the chunk boxes, one warp per chunk. Ends with
// the block synchronised.
__device__ void stage_triangles(const float* __restrict__ tri, int n_tris, float4* s_tri4,
                                float4* s_box) {
  for (int k = threadIdx.x; k < 3 * n_tris; k += blockDim.x) {
    const float* src = tri + 16 * (k / 3) + 4 * (k % 3);
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s_tri4 + k));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int n_chunks = (n_tris + kChunk - 1) / kChunk;
  for (int c = threadIdx.x >> 5; c < n_chunks; c += blockDim.x >> 5)
    dense_trace::build_chunk_box(s_tri4, n_tris, c, lane, s_box + 2 * c);
  __syncthreads();
}

// -- environment map, textures, coverage (kExtras) ------------------------------

__device__ __forceinline__ int floor_mod(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}
__device__ __forceinline__ int clampi(int i, int lo, int hi) { return min(max(i, lo), hi); }

struct EnvTables {
  const float* img;
  const float* pdf;
  int w, h, pw, ph;
};

// lights/environment.py direction_to_latlong_uv.
__device__ __forceinline__ void dir_to_latlong_uv(V3 d, float& u, float& v) {
  u = (atan2f(d.z, d.x) + kPi) * (0.5f / kPi);
  v = (asinf(fminf(fmaxf(d.y, -1.0f), 1.0f)) + kPi * 0.5f) / kPi;
}

__device__ __forceinline__ V3 env_texel(const float* __restrict__ img, int i) {
  return mk(__ldg(img + 3 * i), __ldg(img + 3 * i + 1), __ldg(img + 3 * i + 2));
}

// Bilinear latlong fetch (u wraps by a floor-mod, v clamps) times the tint.
__device__ V3 env_evaluate(const EnvTables& e, V3 tint, float u, float v) {
  const float x = __fsub_rn(__fmul_rn(u, static_cast<float>(e.w)), 0.5f);
  const float y = __fsub_rn(__fmul_rn(v, static_cast<float>(e.h)), 0.5f);
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x - x0f, fy = y - y0f;
  const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
  const int x0w = floor_mod(x0, e.w), x1w = floor_mod(x0 + 1, e.w);
  const int y0c = clampi(y0, 0, e.h - 1), y1c = clampi(y0 + 1, 0, e.h - 1);
  const V3 p00 = env_texel(e.img, y0c * e.w + x0w), p10 = env_texel(e.img, y0c * e.w + x1w);
  const V3 p01 = env_texel(e.img, y1c * e.w + x0w), p11 = env_texel(e.img, y1c * e.w + x1w);
  const V3 top = add(scale(p00, 1.0f - fx), scale(p10, fx));
  const V3 bot = add(scale(p01, 1.0f - fx), scale(p11, fx));
  return mul(add(scale(top, 1.0f - fy), scale(bot, fy)), tint);
}

// The pdf of the grid cell that holds (u, v), over sin(theta).
__device__ float env_pdf_at(const EnvTables& e, V3 d, float u, float v) {
  const float sin_theta = sqrtf(fmaxf(1.0f - d.y * d.y, 0.0f));
  const int xi = clampi(static_cast<int>(__fmul_rn(u, static_cast<float>(e.pw))), 0, e.pw - 1);
  const int yi = clampi(static_cast<int>(__fmul_rn(v, static_cast<float>(e.ph))), 0, e.ph - 1);
  if (sin_theta == 0.0f) return 0.0f;
  return __ldg(e.pdf + yi * e.pw + xi) / fmaxf(sin_theta, 1e-10f);
}

struct TexTables {
  const float4* texels;
  const int* meta;      // [n_tex, 6]
  const int* s_mat_tex;  // [n_mats, 4], in shared memory
};

// NEAREST fetch, texel for texel io/texture.py sample_texture: v flip, wrap
// in float space, - 0.5, round half to even, then integer wrap or clamp.
__device__ float4 tex_fetch_nearest(const TexTables& t, int tex, float u, float v) {
  const int* m = t.meta + 6 * tex;
  const int base = __ldg(m), w = __ldg(m + 1), h = __ldg(m + 2);
  const bool rep_u = __ldg(m + 3) == 1, rep_v = __ldg(m + 4) == 1;
  const float vv = 1.0f - v;
  const float fu = rep_u ? u - floorf(u) : fminf(fmaxf(u, 0.0f), 1.0f);
  const float fv = rep_v ? vv - floorf(vv) : fminf(fmaxf(vv, 0.0f), 1.0f);
  int x = static_cast<int>(rintf(__fsub_rn(__fmul_rn(fu, static_cast<float>(w)), 0.5f)));
  int y = static_cast<int>(rintf(__fsub_rn(__fmul_rn(fv, static_cast<float>(h)), 0.5f)));
  x = rep_u ? floor_mod(x, w) : clampi(x, 0, w - 1);
  y = rep_v ? floor_mod(y, h) : clampi(y, 0, h - 1);
  return __ldg(t.texels + base + y * w + x);
}

// The hit's texcoords from attribute rows 13-18 of column `a`.
__device__ __forceinline__ void interpolated_uv(const float* __restrict__ a, int ts, float hu,
                                                float hv, float& u, float& v) {
  const float b0 = 1.0f - hu - hv;
  u = a[13 * ts] * b0 + a[14 * ts] * hu + a[15 * ts] * hv;
  v = a[16 * ts] * b0 + a[17 * ts] * hu + a[18 * ts] * hv;
}

// Coverage of material `mat` at (u, v): material coverage times the coverage
// texture's red, or for a cutout the sample binarized against the stored
// threshold (path_tracer._surface_material_params).
__device__ float coverage_at(const TexTables& t, int mat, float cov_base, float u, float v) {
  const int cov_tex = t.s_mat_tex[4 * mat + 1];
  const bool is_cutout = t.s_mat_tex[4 * mat + 2] != 0;
  if (cov_tex < 0 && !is_cutout) return cov_base;
  const float samp = cov_tex >= 0 ? tex_fetch_nearest(t, cov_tex, u, v).x : 1.0f;
  return is_cutout ? (samp < cov_base ? 0.0f : 1.0f) : cov_base * samp;
}

struct TraceTables {
  const float4* s_tri4;  // dense: [n_tris, 3] records in shared memory
  const float4* s_box;   // dense: [n_chunks, 2] padded chunk boxes
  int n_tris;
  const float4* recs4;   // hier: the child records
  const float4* tris4;   // hier
  const float* attr;     // [24, t_pad]
  int t_pad;
  const float* s_mats;   // [n_mats, 16] in shared memory
};

// The coverage-aware shadow march (path_tracer._shadow_transmittance): up
// to `steps` closest hits along the segment, each but the last multiplying
// the transmittance by 1 - coverage and moving the origin past the surface
// by t + eps; what the last step still hits occludes fully. A step that
// hits nothing ends the march: the next would search a part of the same
// segment.
template <bool kHier>
__device__ float shadow_march(const TraceTables& g, const TexTables& tex, V3 o, V3 d, float t_max,
                              float eps, int steps) {
  float trans = 1.0f;
  float t_rem = t_max;
  for (int s = 0; s < steps && trans > 0.0f; ++s) {
    float t, hu, hv;
    int prim;
    if constexpr (kHier) {
      const bvh_walk::Ray ray = bvh_walk::make_ray(o.x, o.y, o.z, d.x, d.y, d.z, eps);
      prim = bvh_walk::walk<false>(g.recs4, g.tris4, ray, t_rem, t, hu, hv);
    } else {
      prim = trace_dense<false>(g.s_tri4, g.s_box, g.n_tris, o, d, eps, t_rem, t, hu, hv);
    }
    if (prim < 0) break;
    if (s == steps - 1) return 0.0f;
    const float* a = g.attr + prim;
    const int mat = static_cast<int>(a[9 * g.t_pad]);
    float u, v;
    interpolated_uv(a, g.t_pad, hu, hv, u, v);
    trans *= 1.0f - coverage_at(tex, mat, g.s_mats[16 * mat + 10], u, v);
    const float advance = t + eps;
    o = add(o, scale(d, advance));
    t_rem -= advance;
  }
  return trans;
}

// -- the kernel -----------------------------------------------------------------

constexpr int kAttrRows = 24;
constexpr int kMatCols = 16;
constexpr int kLightCols = 12;
constexpr int kDimNee = 1, kDimBsdf = 2, kPerBounce = 8;

constexpr int kDimCamera = 0;

// The pixel that thread `i` renders: raster order, or with tile_w > 0 runs of
// tile_w * tile_h threads (one warp) over one tile each, tiles in raster
// order — pallas_mesh.pixel_order, which the wrapper checks divides the frame.
__device__ __forceinline__ void lane_pixel(const MegakernelParams& p, int i, int& x, int& y) {
  if (p.tile_w > 0) {
    const int per_tile = p.tile_w * p.tile_h;
    const int tile = i / per_tile, r = i - tile * per_tile;
    const int tiles_x = p.width / p.tile_w;
    const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
    x = tx * p.tile_w + r % p.tile_w;
    y = ty * p.tile_h + r / p.tile_w;
  } else {
    y = i / p.width;
    x = i - y * p.width;
  }
}

struct CameraRay {
  V3 o, d;
  uint32_t hash;
  bool active;
};

__device__ __forceinline__ V3 quat_rotate(const float* __restrict__ q, V3 v) {
  const V3 qv = mk(q[0], q[1], q[2]);
  const V3 t = scale(cross(qv, v), 2.0f);
  return add(add(v, scale(t, q[3])), cross(qv, t));
}

// path_tracer._camera_lanes for pixel (x, y): the pcg2d pixel hash, the
// Sobol camera jitter (0.5 at accumulation 0) and the viewport point, rounded
// op by op as the torch code is, then scene/camera.camera_ray_directions
// through the inverse projection [4, 4] and the camera's transform
// (translation, quaternion x y z w, scale). nvcc contracts the 4 x 4 product
// and the rotation, so the ray agrees with the torch lanes to a few ulps and
// the hash bit for bit.
__device__ CameraRay camera_ray(const MegakernelParams& p, int x, int y,
                                const uint32_t* __restrict__ sobol) {
  CameraRay r;
  r.hash = pcg2d_x(static_cast<uint32_t>(x), static_cast<uint32_t>(y));
  float xf = static_cast<float>(x), yf = static_cast<float>(y);
  if (p.accumulation == 0u) {
    xf = __fadd_rn(xf, 0.5f);
    yf = __fadd_rn(yf, 0.5f);
  } else {
    float u[4];
    path_rng_4d(p.accumulation, r.hash, kDimCamera, sobol, u);
    xf = __fadd_rn(xf, u[0]);
    yf = __fadd_rn(yf, u[1]);
  }
  const float vx = __fdiv_rn(xf, static_cast<float>(p.width));
  const float vy = __fsub_rn(1.0f, __fdiv_rn(yf, static_cast<float>(p.height)));
  const float nx = __fsub_rn(__fmul_rn(vx, 2.0f), 1.0f);
  const float ny = __fsub_rn(__fmul_rn(vy, 2.0f), 1.0f);
  const float* m = p.cam_inv_proj;
  float sn[4], sf[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    sn[k] = nx * m[4 * k] + ny * m[4 * k + 1] - m[4 * k + 2] + m[4 * k + 3];
    sf[k] = sn[k] + 2.0f * m[4 * k + 2];
  }
  const V3 ray_near = mk(sn[0] / sn[3], sn[1] / sn[3], sn[2] / sn[3]);
  const V3 ray_far = mk(sf[0] / sf[3], sf[1] / sf[3], sf[2] / sf[3]);
  const V3 dv = sub(ray_far, ray_near);
  const float len2 = dot(dv, dv);
  const V3 dir_view = scale(dv, (len2 > 1e-20f ? 1.0f : 0.0f) / sqrtf(fmaxf(len2, 1e-20f)));
  const float* tr = p.cam_translation;
  r.o = add(mk(tr[0], tr[1], tr[2]), quat_rotate(p.cam_rotation, scale(ray_near, p.cam_scale[0])));
  r.d = quat_rotate(p.cam_rotation, dir_view);
  r.active = isfinite(r.o.x);
  return r;
}

// kHier: the trace walks the BVH in global memory, and no triangle is staged.
// kExtras: the environment map, textures, coverage and the shadow march.
template <bool kCoat, bool kDiffuse, bool kHier, bool kExtras>
__global__ void mesh_megakernel_kernel(const MegakernelParams p) {
  extern __shared__ float4 smem4[];
  const int n_staged = kHier ? 0 : p.n_tris;
  const int n_chunks = (n_staged + kChunk - 1) / kChunk;
  float4* s_tri4 = smem4;                            // [n_staged, 3] records
  float4* s_box = s_tri4 + 3 * n_staged;             // [n_chunks, 2] boxes
  float* s_rho_ggx = reinterpret_cast<float*>(s_box + 2 * n_chunks);  // [32, 32]
  float* s_rho_fres = s_rho_ggx + kRho * kRho;       // [32, 32]
  float* s_mats = s_rho_fres + kRho * kRho;          // [n_mats, 16]
  float* s_lights = s_mats + kMatCols * p.n_mats;    // [n_lights, 12]
  float* s_offsets = s_lights + kLightCols * p.n_lights;  // [8, 4] RIS offsets
  uint32_t* s_sobol = reinterpret_cast<uint32_t*>(s_offsets + 4 * kMaxRis);  // [4, 32]
  int* s_kinds = reinterpret_cast<int*>(s_sobol + 128);   // [8] light kinds
  int* s_mat_tex = s_kinds + kMaxLights;                  // kExtras: [n_mats, 4]

  for (int k = threadIdx.x; k < kRho * kRho; k += blockDim.x) {
    s_rho_ggx[k] = p.rho_ggx[k];
    s_rho_fres[k] = p.rho_fres[k];
  }
  for (int k = threadIdx.x; k < kMatCols * p.n_mats; k += blockDim.x) s_mats[k] = p.mats[k];
  for (int k = threadIdx.x; k < kLightCols * p.n_lights; k += blockDim.x) s_lights[k] = p.lights[k];
  for (int k = threadIdx.x; k < 128; k += blockDim.x) s_sobol[k] = p.sobol[k];
  if (threadIdx.x < 4 * kMaxRis) s_offsets[threadIdx.x] = p.ris_offsets[threadIdx.x];
  if (threadIdx.x < kMaxLights) s_kinds[threadIdx.x] = p.light_kinds[threadIdx.x];
  if constexpr (kExtras) {
    for (int k = threadIdx.x; k < 4 * p.n_mats; k += blockDim.x) s_mat_tex[k] = p.mat_tex[k];
  }
  if constexpr (kHier) {
    __syncthreads();
  } else {
    stage_triangles(p.tri, n_staged, s_tri4, s_box);   // ends synchronised
  }

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_pixels) return;

  int px, py;
  lane_pixel(p, i, px, py);
  const CameraRay cam = camera_ray(p, px, py, s_sobol);
  const float eps = p.scalars[0];
  const V3 env_tint = mk(p.scalars[1], p.scalars[2], p.scalars[3]);
  const uint32_t pixel_hash = cam.hash;
  V3 o = cam.o;
  V3 d = cam.d;
  V3 throughput = mk(1.0f, 1.0f, 1.0f);
  V3 radiance = mk(0.0f, 0.0f, 0.0f);
  float bsdf_pdf = 0.0f;
  uint32_t bounce = 0u;
  float rays = 0.0f;
  bool active = cam.active;
  const float4* recs4 = reinterpret_cast<const float4*>(p.records);
  const float4* tris4 = reinterpret_cast<const float4*>(p.tri);
  const EnvTables env = {p.env_img, p.env_pdf, p.env_w, p.env_h, p.env_pw, p.env_ph};
  const TexTables tex = {reinterpret_cast<const float4*>(p.texels), p.tex_meta, s_mat_tex};
  const TraceTables geo = {s_tri4, s_box, p.n_tris, recs4, tris4, p.attr, p.t_pad, s_mats};
  // NEE candidates: the lights, and with kExtras the environment's pool.
  const int n_nee = kExtras ? p.n_nee_total : p.n_lights;

  for (int it = 0; it < p.n_iters && active; ++it) {
    rays += 2.0f;
    float t_hit, hu, hv;
    int prim;
    if constexpr (kHier) {
      const bvh_walk::Ray ray = bvh_walk::make_ray(o.x, o.y, o.z, d.x, d.y, d.z, eps);
      prim = bvh_walk::walk<false>(recs4, tris4, ray, kBig, t_hit, hu, hv);
    } else {
      prim = trace_dense<false>(s_tri4, s_box, p.n_tris, o, d, eps, kBig, t_hit, hu, hv);
    }

    float t_light = kBig;
    int light_idx = -1;
    for (int k = 0; k < p.n_lights; ++k) {
      const int kind = s_kinds[k];
      if (kind != kSphere && kind != kSpot) continue;
      const Light l = load_light(s_lights + kLightCols * k);
      const float tk = kind == kSphere ? ray_sphere_t(o, d, l) : ray_spot_disk_t(o, d, l);
      if (tk < t_light) {
        t_light = tk;
        light_idx = k;
      }
    }
    const bool light_first = t_light < t_hit;
    if (!light_first && prim < 0) {   // miss: the environment map, or the background tint
      if constexpr (kExtras) {
        if (p.has_env) {
          float eu, ev;
          dir_to_latlong_uv(d, eu, ev);
          const float e_pdf = env_pdf_at(env, d, eu, ev);
          const float w = bsdf_pdf > 0.0f ? mis_weight(bsdf_pdf, e_pdf) : 1.0f;
          radiance = add(radiance, mul(throughput, scale(env_evaluate(env, env_tint, eu, ev), w)));
          break;
        }
      }
      radiance = add(radiance, mul(throughput, env_tint));
      break;
    }
    if (light_first) {   // an analytic light, MIS-weighted
      const Light l = load_light(s_lights + kLightCols * light_idx);
      const bool sphere = s_kinds[light_idx] == kSphere;
      const V3 l_rad = sphere ? sphere_light_evaluate(l) : spot_light_evaluate(l, o, d);
      const float l_pdf = sphere ? sphere_light_pdf(l, o, d) : spot_light_pdf(l, o, d);
      const float w = bsdf_pdf > 0.0f ? mis_weight(bsdf_pdf, l_pdf) : 1.0f;
      radiance = add(radiance, scale(mul(vmin(throughput, p.firefly_clamp), l_rad), w));
      break;
    }

    // Mesh hit: attributes, material.
    const float* a = p.attr + prim;
    const int ts = p.t_pad;
    const float bary0 = 1.0f - hu - hv;
    const V3 n0 = mk(a[0 * ts], a[1 * ts], a[2 * ts]);
    const V3 n1 = mk(a[3 * ts], a[4 * ts], a[5 * ts]);
    const V3 n2 = mk(a[6 * ts], a[7 * ts], a[8 * ts]);
    const int mat_idx = static_cast<int>(a[9 * ts]);
    const V3 geo_n = mk(a[10 * ts], a[11 * ts], a[12 * ts]);
    const V3 shading_n = normalize(add(add(scale(n0, bary0), scale(n1, hu)), scale(n2, hv)));
    const V3 position = add(o, scale(d, t_hit));
    const float* m = s_mats + kMatCols * mat_idx;
    const bool thin_walled = m[6] > 0.5f;
    const bool hit_from_front = dot(geo_n, d) < 0.0f;
    const V3 gf = hit_from_front ? geo_n : neg(geo_n);
    if (!hit_from_front && !thin_walled) {   // a culled back face: pass through
      o = offset_ray_origin(position, neg(gf));
      continue;
    }

    float u_bsdf[4], u_nee[4];
    path_rng_4d(p.accumulation, pixel_hash, bounce * kPerBounce + kDimBsdf, s_sobol, u_bsdf);
    path_rng_4d(p.accumulation, pixel_hash, bounce * kPerBounce + kDimNee, s_sobol, u_nee);

    V3 sn = hit_from_front ? shading_n : neg(shading_n);
    // fix_backfacing_shading_normal (Utils.h), target cos 0.002.
    const V3 wo_world = neg(d);
    const float cos_w = dot(wo_world, sn);
    if (cos_w < 0.002f) sn = normalize(sub(sn, scale(wo_world, cos_w - 0.002f)));
    const V3 wo = to_local(wo_world, sn);
    const float cos_theta_o = (hit_from_front || thin_walled) ? wo.z : -wo.z;

    V3 tint = mk(m[0], m[1], m[2]);
    float rough = m[3];
    if constexpr (kExtras) {
      const int tr_tex = s_mat_tex[4 * mat_idx];
      float tu = 0.0f, tv = 0.0f;
      if (tr_tex >= 0 || p.any_coverage) interpolated_uv(a, ts, hu, hv, tu, tv);
      // Stochastic transparency: coverage below the bounce's fourth BSDF
      // number lets the ray pass, as a culled back face does.
      if (p.any_coverage && coverage_at(tex, mat_idx, m[10], tu, tv) < u_bsdf[3]) {
        o = offset_ray_origin(position, neg(gf));
        continue;
      }
      if (tr_tex >= 0) {
        const float4 tr = tex_fetch_nearest(tex, tr_tex, tu, tv);
        tint = mul(tint, mk(tr.x, tr.y, tr.z));
        rough *= tr.w;
      }
    }
    Shading sh;
    if (kDiffuse && m[13] == 1.0f) {
      sh.tint = tint;
      sh.roughness = rough;
      sh.diffuse_model = true;
    } else {
      sh = shading_create<kCoat>(s_rho_ggx, s_rho_fres, tint, rough, m[4], m[5],
                                 fabsf(cos_theta_o), kCoat ? m[11] : 0.0f,
                                 kCoat ? m[12] : 0.0f);
    }

    // Surface emission.
    radiance = add(radiance, mul(throughput, mk(m[7], m[8], m[9])));

    // NEE: RIS over ris_count candidates, then one any-hit shadow ray or
    // the march through semi-transparent surfaces.
    bool nee_valid = false;
    if (n_nee > 0 && p.ris_count > 0) {
      V3 res_dir = mk(0.0f, 0.0f, 0.0f), res_rad = mk(0.0f, 0.0f, 0.0f);
      float res_dist = 0.0f;
      const float n_total = static_cast<float>(n_nee);
      for (int s = 0; s < p.ris_count; ++s) {
        const float* off = s_offsets + 4 * s;
        const float c0 = toroidal_shift(u_nee[0], off[0]);
        const float c1 = toroidal_shift(u_nee[1], off[1]);
        const float c2 = toroidal_shift(u_nee[2], off[2]);
        const float c3 = toroidal_shift(u_nee[3], off[3]);
        const int pick = static_cast<int>(fminf(floorf(c2 * n_total), n_total - 1.0f));
        LightSample ls;
        if (kExtras && pick == p.n_lights) {
          // The environment: entry floor(c0 * n) of the presampled pool,
          // whose radiance holds the tint already.
          const int n_pool = p.env_pool_n;
          const int idx =
              clampi(static_cast<int>(floorf(__fmul_rn(c0, static_cast<float>(n_pool)))), 0,
                     n_pool - 1);
          const float* rec = p.env_pool + 7 * idx;
          ls.dir = mk(__ldg(rec), __ldg(rec + 1), __ldg(rec + 2));
          ls.dist = 1e30f;
          ls.radiance = mk(__ldg(rec + 3), __ldg(rec + 4), __ldg(rec + 5));
          ls.pdf = __ldg(rec + 6);
          ls.is_delta = false;
        } else {
          const int kind = s_kinds[pick];
          const Light l = load_light(s_lights + kLightCols * pick);
          if (kind == kSphere) {
            ls = sphere_light_sample(l, position, c0, c1);
          } else if (kind == kSpot) {
            ls = spot_light_sample(l, position, c0, c1);
          } else {   // directional
            ls.dir = neg(l.dir);
            ls.dist = 1e30f;
            ls.radiance = l.power;
            ls.pdf = 1.0f;
            ls.is_delta = true;
          }
        }
        // Uniform light pick, |N·L| / pdf, MIS and the material's f.
        V3 cand = scale(scale(ls.radiance, n_total), fabsf(dot(sn, ls.dir)) / fmaxf(ls.pdf, 1e-12f));
        if (!(ls.pdf > 0.0f)) cand = mk(0.0f, 0.0f, 0.0f);
        float bsdf_pdf_c;
        V3 f_c = shading_evaluate<kCoat>(sh, wo, to_local(ls.dir, sn), bsdf_pdf_c);
        float w = 1.0f;
        if (ls.is_delta) {
          f_c = vmin(f_c, p.delta_light_clamp);
        } else {
          w = mis_weight(ls.pdf, bsdf_pdf_c);
        }
        cand = scale(mul(cand, f_c), w);
        // Reservoir update (path_tracer._reestimated_light_samples).
        const float w_old = res_rad.x + res_rad.y + res_rad.z;
        const float w_new = cand.x + cand.y + cand.z;
        const bool any_w = w_old + w_new > 0.0f;
        const float p_new = w_new / (any_w ? w_old + w_new : 1.0f);
        const bool take = c3 < p_new;
        if (take) {
          res_dir = ls.dir;
          res_dist = ls.dist;
          nee_valid = ls.pdf > 1e-6f;
        }
        float denom = take ? p_new : 1.0f - p_new;
        denom = (any_w && denom > 1e-20f) ? denom : 1.0f;
        res_rad = any_w ? scale(take ? cand : res_rad, 1.0f / denom) : mk(0.0f, 0.0f, 0.0f);
      }
      res_rad = scale(res_rad, 1.0f / static_cast<float>(p.ris_count));
      const V3 l_radiance = mul(res_rad, throughput);
      if (max3(l_radiance) > 0.0f) {
        const float side = dot(res_dir, gf) >= 0.0f ? 1.0f : -1.0f;
        const V3 shadow_origin = offset_ray_origin(position, scale(gf, side));
        if (kExtras && p.shadow_steps > 0) {
          const float trans = shadow_march<kHier>(geo, tex, shadow_origin, res_dir,
                                                  res_dist * 0.9999f, eps, p.shadow_steps);
          radiance = add(radiance, scale(l_radiance, trans));
        } else {
          bool occluded;
          if constexpr (kHier) {
            const bvh_walk::Ray ray = bvh_walk::make_ray(shadow_origin.x, shadow_origin.y,
                                                         shadow_origin.z, res_dir.x, res_dir.y,
                                                         res_dir.z, eps);
            float t_any, u_any, v_any;
            occluded = bvh_walk::walk<true>(recs4, tris4, ray, res_dist * 0.9999f, t_any, u_any,
                                            v_any) >= 0;
          } else {
            float t_any, u_any, v_any;
            occluded = trace_dense<true>(s_tri4, s_box, p.n_tris, shadow_origin, res_dir, eps,
                                         res_dist * 0.9999f, t_any, u_any, v_any) >= 0;
          }
          if (!occluded) radiance = add(radiance, l_radiance);
        }
      }
    }

    // BSDF sampling; mirror directions that point into the geometry.
    float s_pdf;
    bool s_delta;
    V3 s_f;
    const V3 wi = shading_sample<kCoat>(sh, wo, u_bsdf[0], u_bsdf[1], u_bsdf[2], s_pdf, s_delta, s_f);
    V3 new_dir = to_world(wi, sn);
    const bool is_reflection = wi.z >= 0.0f;
    const float cos_geo = dot(new_dir, gf);
    if ((is_reflection && cos_geo < 0.0f) || (!is_reflection && cos_geo >= 0.0f))
      new_dir = reflect(new_dir, gf);
    throughput = s_pdf > 0.0f ? scale(mul(throughput, s_f), fabsf(wi.z) / fmaxf(s_pdf, 1e-12f))
                              : mk(0.0f, 0.0f, 0.0f);
    o = offset_ray_origin(position, scale(gf, dot(new_dir, gf) >= 0.0f ? 1.0f : -1.0f));
    d = new_dir;
    bsdf_pdf = (s_delta || !nee_valid) ? 0.0f : s_pdf;
    bounce += 1u;
    active = max3(throughput) > 0.0f && bounce <= static_cast<uint32_t>(p.max_bounce);
  }

  // Raster order: the image [height, width, 3], then the rays [height, width];
  // or the radiance lerped into the running mean in place, a = a + (r - a) *
  // inv_n, rounded op by op as torch's eager `buffer + (frame - buffer) / (n +
  // 1)` is on the card (a division by a host scalar is a multiplication by
  // its float reciprocal there), and no ray tally.
  const int pix = py * p.width + px;
  if (p.accum != nullptr) {
    float* a = p.accum + 3 * pix;
    a[0] = __fadd_rn(a[0], __fmul_rn(__fsub_rn(radiance.x, a[0]), p.inv_n));
    a[1] = __fadd_rn(a[1], __fmul_rn(__fsub_rn(radiance.y, a[1]), p.inv_n));
    a[2] = __fadd_rn(a[2], __fmul_rn(__fsub_rn(radiance.z, a[2]), p.inv_n));
    return;
  }
  p.out[3 * pix] = radiance.x;
  p.out[3 * pix + 1] = radiance.y;
  p.out[3 * pix + 2] = radiance.z;
  p.out[3 * p.n_pixels + pix] = rays;
}

__global__ void rng_probe_kernel(const uint32_t* __restrict__ pixel_hash,
                                 const uint32_t* __restrict__ dims, int n, uint32_t accumulation,
                                 const uint32_t* __restrict__ sobol, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float u[4];
  path_rng_4d(accumulation, pixel_hash[i], dims[i], sobol, u);
#pragma unroll
  for (int d = 0; d < 4; ++d) out[4 * i + d] = u[d];
}

// Camera-lane probe: the ray, hash and active flag that thread i's prologue
// makes, written at its pixel in raster order → out[pix, 0:8] = origin,
// direction, active (0/1), hash (uint32 bits).
__global__ void camera_probe_kernel(const MegakernelParams p, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_pixels) return;
  int x, y;
  lane_pixel(p, i, x, y);
  const CameraRay r = camera_ray(p, x, y, p.sobol);
  float* row = out + 8 * (y * p.width + x);
  row[0] = r.o.x;
  row[1] = r.o.y;
  row[2] = r.o.z;
  row[3] = r.d.x;
  row[4] = r.d.y;
  row[5] = r.d.z;
  row[6] = r.active ? 1.0f : 0.0f;
  row[7] = __uint_as_float(r.hash);
}

// Trace probe: the dense branch's staged, chunk-culled trace for rays [n, 3]
// over a [n_tris, 16] table → out [4, n]: t (3e38 on a miss), prim (int
// bits), u, v.
template <bool kAnyHit>
__global__ void trace_probe_kernel(const float* __restrict__ tri, int n_tris,
                                   const float* __restrict__ origin,
                                   const float* __restrict__ direction, int n_rays, float t_min,
                                   float t_max, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float4* s_box = smem4 + 3 * n_tris;
  stage_triangles(tri, n_tris, smem4, s_box);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const V3 o = mk(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]);
  const V3 d = mk(direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
  float t, u, v;
  const int prim = trace_dense<kAnyHit>(smem4, s_box, n_tris, o, d, t_min, t_max, t, u, v);
  out[i] = prim < 0 ? kBig : t;
  out[n_rays + i] = __int_as_float(prim);
  out[2 * n_rays + i] = prim < 0 ? 0.0f : u;
  out[3 * n_rays + i] = prim < 0 ? 0.0f : v;
}

// Walk probe: the BVH branch's walk over the child records for rays [n, 3]
// from t_min to t_max[i] → out [4, n] as csrc/bvh_intersect.cu writes it:
// t (+inf on a miss), order[slot] (int bits, -1 on a miss), u, v (0 on a
// miss).
template <bool kAnyHit>
__global__ void hier_trace_probe_kernel(const float* __restrict__ records,
                                        const float* __restrict__ tri,
                                        const int* __restrict__ order,
                                        const float* __restrict__ origin,
                                        const float* __restrict__ direction, int n_rays,
                                        float t_min, const float* __restrict__ t_max,
                                        float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const bvh_walk::Ray r =
      bvh_walk::make_ray(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2], direction[3 * i],
                         direction[3 * i + 1], direction[3 * i + 2], t_min);
  float t, u, v;
  const int slot =
      bvh_walk::walk<kAnyHit>(reinterpret_cast<const float4*>(records),
                              reinterpret_cast<const float4*>(tri), r, t_max[i], t, u, v);
  const bool miss = slot < 0;
  out[i] = miss ? __int_as_float(0x7f800000) : t;
  out[n_rays + i] = __int_as_float(miss ? -1 : __ldg(order + slot));
  out[2 * n_rays + i] = miss ? 0.0f : u;
  out[3 * n_rays + i] = miss ? 0.0f : v;
}

// Dynamic shared memory of the dense trace's tables: the records and the
// chunk boxes.
__host__ __device__ constexpr size_t staged_bytes(int n_tris) {
  return sizeof(float4) * (3 * static_cast<size_t>(n_tris) + 2 * ((n_tris + kChunk - 1) / kChunk));
}

// Above 48 KB a kernel's dynamic shared memory needs the opt-in, per
// instantiation; a refused opt-in comes back as its error.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kCoat, bool kDiffuse, bool kHier, bool kExtras = false>
int launch(const MegakernelParams& p, int threads, cudaStream_t stream) {
  const size_t smem = staged_bytes(kHier ? 0 : p.n_tris) +
                      sizeof(float) * (2 * kRho * kRho + kMatCols * p.n_mats +
                                       kLightCols * p.n_lights + 4 * kMaxRis) +
                      sizeof(uint32_t) * 128 + sizeof(int) * kMaxLights +
                      (kExtras ? sizeof(int) * 4 * p.n_mats : 0);
  auto kernel = mesh_megakernel_kernel<kCoat, kDiffuse, kHier, kExtras>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (p.n_pixels + threads - 1) / threads;
  kernel<<<blocks, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kHier>
int launch_models(const MegakernelParams& p, int threads, cudaStream_t s) {
  // The one kExtras instantiation per trace compiles the coat lobe and the
  // Diffuse model in: both are chosen per material at run time.
  if (p.extras) return launch<true, true, kHier, true>(p, threads, s);
  if (p.has_coat) {
    return p.has_diffuse ? launch<true, true, kHier>(p, threads, s)
                         : launch<true, false, kHier>(p, threads, s);
  }
  return p.has_diffuse ? launch<false, true, kHier>(p, threads, s)
                       : launch<false, false, kHier>(p, threads, s);
}

}  // namespace

extern "C" int megakernel_params_size() { return static_cast<int>(sizeof(MegakernelParams)); }

// Launches one frame on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int mesh_megakernel(const MegakernelParams* params, int threads, void* stream) {
  const MegakernelParams& p = *params;
  if (p.n_pixels <= 0) return 0;
  if (threads <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.hier ? launch_models<true>(p, threads, s) : launch_models<false>(p, threads, s);
}

// path_rng_4d(accumulation, pixel_hash[i], dims[i]) → out[i, 0:4].
extern "C" int megakernel_rng_probe(const uint32_t* pixel_hash, const uint32_t* dims, int n,
                                    uint32_t accumulation, const uint32_t* sobol, float* out,
                                    void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  rng_probe_kernel<<<(n + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      pixel_hash, dims, n, accumulation, sobol, out);
  return static_cast<int>(cudaGetLastError());
}

// The camera lanes of a frame → out [n_pixels, 8] (camera_probe_kernel).
extern "C" int megakernel_camera_probe(const MegakernelParams* params, float* out, void* stream) {
  const MegakernelParams& p = *params;
  if (p.n_pixels <= 0) return 0;
  const int threads = 128;
  camera_probe_kernel<<<(p.n_pixels + threads - 1) / threads, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p, out);
  return static_cast<int>(cudaGetLastError());
}

// The BVH branch's walk on its own (hier_trace_probe_kernel): records
// [n_records, 16], tri [n_slots, 12], order [n_slots], rays [n_rays, 3],
// t_max [n_rays], out [4, n_rays].
extern "C" int megakernel_hier_trace_probe(const float* records, const float* tri,
                                           const int* order, const float* origin,
                                           const float* direction, int n_rays, float t_min,
                                           const float* t_max, int any_hit, float* out,
                                           void* stream) {
  if (n_rays <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    hier_trace_probe_kernel<true><<<blocks, threads, 0, s>>>(records, tri, order, origin,
                                                             direction, n_rays, t_min, t_max, out);
  else
    hier_trace_probe_kernel<false><<<blocks, threads, 0, s>>>(records, tri, order, origin,
                                                              direction, n_rays, t_min, t_max, out);
  return static_cast<int>(cudaGetLastError());
}

// The dense branch's trace on its own (trace_probe_kernel): rays [n_rays, 3],
// tri [n_tris, 16] (n_tris <= 1024), out [4, n_rays].
extern "C" int megakernel_trace_probe(const float* tri, int n_tris, const float* origin,
                                      const float* direction, int n_rays, float t_min,
                                      float t_max, int any_hit, float* out, void* stream) {
  if (n_rays <= 0) return 0;
  const int threads = 128;
  const size_t smem = staged_bytes(n_tris);
  const int blocks = (n_rays + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (any_hit) {
    e = allow_smem(trace_probe_kernel<true>, smem);
    if (e == cudaSuccess)
      trace_probe_kernel<true><<<blocks, threads, smem, s>>>(tri, n_tris, origin, direction,
                                                             n_rays, t_min, t_max, out);
  } else {
    e = allow_smem(trace_probe_kernel<false>, smem);
    if (e == cudaSuccess)
      trace_probe_kernel<false><<<blocks, threads, smem, s>>>(tri, n_tris, origin, direction,
                                                              n_rays, t_min, t_max, out);
  }
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
