// Dense streaming Möller–Trumbore nearest hit, for Hopper (sm_90a).
//
// Replaces the TPU kernel bifrost3d_tpu/geometry/pallas_intersect.py
// ::_intersect_kernel (driven by pallas_intersect, packing in
// pack_triangles). It computes what that kernel computes — for every ray the
// nearest triangle hit (t, prim, u, v) in (t_min, t_max) — without copying
// its block structure:
//
//   - one thread per ray, 256 threads per block;
//   - the triangle table (v0, e1, e2 component-major, 9 rows of a
//     [16, tri_stride] float32 array) is walked in tiles of 256 triangles
//     staged in shared memory, 9 floats per triangle, SoA;
//   - a running (t, prim, u, v) stays in registers; the comparison is a
//     strict '<' over ascending triangle indices, so the lowest index wins
//     a tie, as the Pallas column-min and jnp.argmin do;
//   - the validity test is the Pallas one: |det| > 1e-9, u >= 0, v >= 0,
//     u + v <= 1, t > t_min, t < t_max, t < best, with inv_det = 1/det as a
//     true IEEE division;
//   - a ray at an index >= n_live writes a miss and tests no triangle
//     (per ray here, per 256-ray block on the TPU);
//   - any-hit queries run the same closest-hit loop without an early exit,
//     as on the TPU.
//
// A miss writes t = 3e38, prim = -1, u = v = 0; the wrapper turns t into inf.
//
// What bounds it on an H100: at Cornell's 34 triangles the work per ray is
// ~1.7 k flops against 32 B of ray read and 16 B of hit written, so the
// kernel is bound by launch latency and ray I/O. At tens of thousands of
// triangles it is bound by FP32 issue, at about 50 flops per ray-triangle
// test (the shared-memory tile reads are broadcasts). This simple design
// does nothing about either yet: no ray packets, no persistent blocks, no
// culling. Making it fast is later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math). nvcc contracts a*b+c into FMA,
// which the CPU reference does not; near edges and ties that flips a few
// hits, which the comparison gates allow.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;
constexpr float kBig = 3.0e38f;
constexpr float kEpsDet = 1e-9f;

__global__ void __launch_bounds__(kThreads)
dense_intersect_kernel(const float* __restrict__ rays, int n_rays, int n_live,
                       const float* __restrict__ tris, int tri_stride,
                       int n_tris, float* __restrict__ t_out,
                       int* __restrict__ prim_out, float* __restrict__ u_out,
                       float* __restrict__ v_out) {
  __shared__ float tile[9][kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int n_active = min(n_rays, n_live);
  const bool live = i < n_active;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float t_min = 0.f, t_max = 0.f;
  if (live) {
    ox = rays[0 * n_rays + i];
    oy = rays[1 * n_rays + i];
    oz = rays[2 * n_rays + i];
    dx = rays[3 * n_rays + i];
    dy = rays[4 * n_rays + i];
    dz = rays[5 * n_rays + i];
    t_min = rays[6 * n_rays + i];
    t_max = rays[7 * n_rays + i];
  }

  float best_t = kBig, best_u = 0.f, best_v = 0.f;
  int best_prim = -1;

  // The block-wide condition keeps every __syncthreads uniform.
  if (blockIdx.x * kThreads < n_active) {
    for (int base = 0; base < n_tris; base += kTile) {
      const int count = min(kTile, n_tris - base);
      for (int k = threadIdx.x; k < count; k += kThreads) {
#pragma unroll
        for (int c = 0; c < 9; ++c) tile[c][k] = tris[c * tri_stride + base + k];
      }
      __syncthreads();
      if (live) {
        for (int k = 0; k < count; ++k) {
          const float v0x = tile[0][k], v0y = tile[1][k], v0z = tile[2][k];
          const float e1x = tile[3][k], e1y = tile[4][k], e1z = tile[5][k];
          const float e2x = tile[6][k], e2y = tile[7][k], e2z = tile[8][k];
          // pvec = d x e2
          const float px = dy * e2z - dz * e2y;
          const float py = dz * e2x - dx * e2z;
          const float pz = dx * e2y - dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const bool det_ok = fabsf(det) > kEpsDet;
          const float inv_det =
              __fdiv_rn(det_ok ? 1.0f : 0.0f, det == 0.0f ? 1.0f : det);
          // tvec = o - v0
          const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
          const float u = (tx * px + ty * py + tz * pz) * inv_det;
          // qvec = tvec x e1
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
          const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          const bool valid = det_ok && u >= 0.0f && v >= 0.0f &&
                             u + v <= 1.0f && t > t_min && t < t_max &&
                             t < best_t;
          if (valid) {
            best_t = t;
            best_prim = base + k;
            best_u = u;
            best_v = v;
          }
        }
      }
      __syncthreads();
    }
  }

  if (i < n_rays) {
    t_out[i] = best_t;
    prim_out[i] = best_prim;
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
}

}  // namespace

// rays: [8, n_rays] float32 component-major (ox oy oz dx dy dz t_min t_max).
// tris: [>= 9, tri_stride] float32 (v0.xyz, e1.xyz, e2.xyz rows).
// Outputs: [n_rays] each. Launches on `stream`; returns cudaGetLastError().
extern "C" int dense_intersect(const float* rays, int n_rays, int n_live,
                               const float* tris, int tri_stride, int n_tris,
                               float* t_out, int* prim_out, float* u_out,
                               float* v_out, void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  dense_intersect_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      rays, n_rays, n_live, tris, tri_stride, n_tris, t_out, prim_out, u_out,
      v_out);
  return static_cast<int>(cudaGetLastError());
}
