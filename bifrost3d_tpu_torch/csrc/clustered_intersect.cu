// Cluster-scan ray trace (nearest hit) for Hopper (sm_90a).
//
// Replaces the TPU kernel bifrost3d_tpu/geometry/pallas_clustered.py
// ::_clustered_kernel (driven by clustered_intersect). It computes the same
// function: triangles are in BVH leaf order, cut into clusters of 512 with
// one bounding box each; a block of rays scans all clusters in slot order,
// slab-tests every ray against the cluster's box with the ray's running best
// t, and only where some ray of the block passes fetches the cluster and runs
// dense Möller–Trumbore for every ray of the block. Closest hit only; the
// wrapper maps the winning slot back through `order`.
//
// The TPU kernel's shape is kept on purpose (it is the linear baseline the
// BVH kernels are measured against), translated to the card:
//
//   - one thread block per block of rays (256, the TPU's BLOCK_R), one ray
//     per thread, the ray and its best hit in registers;
//   - the box test is per thread with the TPU kernel's safe_inv
//     (sign(d) / max(|d|, 1e-12)) and box rule (near <= far, far > 0,
//     near < best_t, near clamped to t_min); __syncthreads_or is the
//     block-level "any ray passes" that the TPU kernel takes with pl.when;
//   - a fetched cluster's 512 x 9 floats (18 KB) are loaded by the whole
//     block into shared memory, coalesced along each component row, where
//     the TPU kernel starts one DMA; then every thread tests its ray against
//     all of them, each read a broadcast;
//   - the last cluster stops at n_tris (the TPU kernel's tri_ids < n_tris).
//
// Ties: inside a cluster the lowest slot wins and across clusters the first
// one scanned (strict '<' in slot order), as the TPU kernel's column-min and
// `row_best < best` do.
//
// A miss writes t = 3e38, prim = -1, u = v = 0; the wrapper turns t into inf.
//
// What bounds it on an H100: float32 operations. A block that fetches a
// cluster spends 256 x 512 x ~50 flops on 18 KB of loads, and coherent camera
// rays still fetch every cluster along their frustum, incoherent rays nearly
// all of them. The design does nothing about that beyond the box cull: it is
// O(clusters) per block where a BVH walk is O(log).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>

namespace {

constexpr int kBlockR = 256;    // the largest block the kernel is built for
constexpr int kClusterT = 512;
constexpr float kBig = 3.0e38f;
constexpr float kEpsDet = 1e-9f;

__device__ __forceinline__ float safe_inv(float x) {
  return __fdiv_rn(x < 0.0f ? -1.0f : 1.0f, fmaxf(fabsf(x), 1e-12f));
}

__global__ void __launch_bounds__(kBlockR)
clustered_intersect_kernel(const float* __restrict__ rays, int n_rays,
                           const float4* __restrict__ boxes, int n_clusters,
                           const float* __restrict__ tris, int t_pad, int n_tris,
                           const int* __restrict__ order, float* __restrict__ t_out,
                           int* __restrict__ prim_out, float* __restrict__ u_out,
                           float* __restrict__ v_out) {
  __shared__ float s_tri[9][kClusterT];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // A thread past the last ray stays for the barriers with a ray that passes
  // no box (best_t = 0).
  const bool in_range = i < n_rays;
  const int j = in_range ? i : 0;
  const float ox = rays[0 * n_rays + j], oy = rays[1 * n_rays + j], oz = rays[2 * n_rays + j];
  const float dx = rays[3 * n_rays + j], dy = rays[4 * n_rays + j], dz = rays[5 * n_rays + j];
  const float t_min = rays[6 * n_rays + j];
  const float t_max = rays[7 * n_rays + j];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

  float best_t = in_range ? fminf(t_max, kBig) : 0.0f;
  float best_u = 0.0f, best_v = 0.0f;
  int best_slot = -1;

  for (int c = 0; c < n_clusters; ++c) {
    const float4 a = __ldg(&boxes[2 * c]);       // lo.xyz, hi.x
    const float4 b = __ldg(&boxes[2 * c + 1]);   // hi.yz, 0, 0
    const float x0 = (a.x - ox) * ix, x1 = (a.w - ox) * ix;
    const float y0 = (a.y - oy) * iy, y1 = (b.x - oy) * iy;
    const float z0 = (a.z - oz) * iz, z1 = (b.y - oz) * iz;
    const float t_near = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fmaxf(fminf(z0, z1), t_min));
    const float t_far = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
    const bool box_hit = t_near <= t_far && t_far > 0.0f && t_near < best_t;
    // Also the barrier that keeps the previous cluster's tests ahead of the
    // next load.
    if (!__syncthreads_or(box_hit)) continue;

    const int base = c * kClusterT;
    for (int k = threadIdx.x; k < 9 * kClusterT; k += blockDim.x) {
      const int row = k / kClusterT, col = k % kClusterT;
      s_tri[row][col] = tris[row * t_pad + base + col];
    }
    __syncthreads();

    const int count = min(kClusterT, n_tris - base);
    for (int k = 0; k < count; ++k) {
      const float v0x = s_tri[0][k], v0y = s_tri[1][k], v0z = s_tri[2][k];
      const float e1x = s_tri[3][k], e1y = s_tri[4][k], e1z = s_tri[5][k];
      const float e2x = s_tri[6][k], e2y = s_tri[7][k], e2z = s_tri[8][k];
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const bool det_ok = fabsf(det) > kEpsDet;
      const float inv_det = __fdiv_rn(det_ok ? 1.0f : 0.0f, det == 0.0f ? 1.0f : det);
      const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
      const float u = (tx * px + ty * py + tz * pz) * inv_det;
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
      const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      const bool valid = det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min &&
                         t < t_max && t < best_t;
      if (valid) {
        best_t = t;
        best_slot = base + k;
        best_u = u;
        best_v = v;
      }
    }
  }

  if (!in_range) return;
  const bool miss = best_slot < 0;
  t_out[i] = miss ? kBig : best_t;
  prim_out[i] = miss ? -1 : order[best_slot];
  u_out[i] = miss ? 0.0f : best_u;
  v_out[i] = miss ? 0.0f : best_v;
}

}  // namespace

// rays: [8, n_rays] float32 component-major (ox oy oz dx dy dz t_min t_max).
// boxes: [n_clusters, 8] float32 (lo.xyz hi.xyz 0 0); tris: [>= 9, t_pad]
// float32 component-major (v0, e1, e2) in slot order, t_pad = n_clusters * 512;
// order: [t_pad] int32 → original triangle ids. Outputs: [n_rays] each.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int clustered_intersect(const float* rays, int n_rays, const float* boxes,
                                   int n_clusters, const float* tris, int t_pad, int n_tris,
                                   const int* order, float* t_out, int* prim_out, float* u_out,
                                   float* v_out, int threads, void* stream) {
  if (n_rays <= 0) return 0;
  // __launch_bounds__ caps the block size at kBlockR: a larger `threads` is
  // refused by the launch and comes back as its error.
  const int blocks = (n_rays + threads - 1) / threads;
  clustered_intersect_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays, n_rays, reinterpret_cast<const float4*>(boxes), n_clusters, tris, t_pad, n_tris, order,
      t_out, prim_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}
