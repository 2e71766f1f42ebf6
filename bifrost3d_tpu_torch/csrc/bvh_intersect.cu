// BVH ray trace (nearest hit or any-hit occlusion) for Hopper (sm_90a).
//
// Replaces the TPU kernel bifrost3d_tpu/geometry/pallas_bvh.py
// ::_make_hier_kernel(any_hit) (driven by hierarchical_intersect). It
// computes the same function — for every ray the nearest triangle hit
// (t, original triangle id, u, v) within (t_min, t_max), or with any-hit
// whether some triangle lies there; rays at an index >= *n_live report
// misses untraversed — but not by the same walk. The TPU kernel raises the
// traversal from ray to ray block: one scalar stack per 32-ray sub-group over
// a BVH of 512-triangle clusters, dense Möller–Trumbore inside a cluster,
// because a per-lane stack is hostile to a vector machine. A GPU thread has
// its own registers and local memory, so here:
//
//   - one thread per ray walks the triangle BVH itself (leaves of at most 4
//     triangles) with a private stack: the walk, its records and its tie
//     rule are in csrc/bvh_walk.cuh, which the mesh megakernel's BVH branch
//     shares;
//   - `order` maps the hit's slot back to the original triangle id.
//
// Ties: the walk visits leaves near-first, the plain version left-first and
// the TPU kernel cluster by cluster, so two triangles at the same t (a shared
// edge, coplanar faces) may answer with either id; comparisons allow that.
//
// A miss writes t = 3e38, prim = -1, u = v = 0; the wrapper turns t into inf.
//
// What bounds it on an H100: memory latency, not bytes or flops. A ray reads
// 32 B and writes 16 B, and visits some tens of nodes (64 B per child pair)
// and a few leaves (48 B per triangle) through L2/L1 with dependent loads;
// incoherent rays diverge within the warp. This simple design does nothing
// about that (no ray packets, no wide nodes, no compressed boxes, no
// persistent threads); sorting rays (hierarchical_intersect_sorted, the
// pool's sort) is what keeps neighbouring threads in neighbouring subtrees.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace {

constexpr int kThreads = 128;  // the largest block the kernel is built for
constexpr float kBig = bvh_walk::kBig;

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
bvh_intersect_kernel(const float* __restrict__ rays, int n_rays,
                     const int* __restrict__ n_live_ptr,
                     const float4* __restrict__ nodes,
                     const float4* __restrict__ tris, const int* __restrict__ order,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;

  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_slot = -1;

  if (i < *n_live_ptr) {
    const bvh_walk::Ray r = bvh_walk::make_ray(
        rays[0 * n_rays + i], rays[1 * n_rays + i], rays[2 * n_rays + i], rays[3 * n_rays + i],
        rays[4 * n_rays + i], rays[5 * n_rays + i], rays[6 * n_rays + i]);
    best_slot = bvh_walk::walk<kAnyHit>(nodes, tris, r, rays[7 * n_rays + i], best_t, best_u,
                                        best_v);
  }

  const bool miss = best_slot < 0;
  t_out[i] = miss ? kBig : best_t;
  prim_out[i] = miss ? -1 : order[best_slot];
  u_out[i] = miss ? 0.0f : best_u;
  v_out[i] = miss ? 0.0f : best_v;
}

}  // namespace

// rays: [8, n_rays] float32 component-major (ox oy oz dx dy dz t_min t_max).
// n_live: one int32 on the device (rays at an index >= it miss untraversed).
// nodes: [n_nodes, 8] float32 records; tris: [n_slots, 12] float32 records
// in leaf order; order: [n_slots] int32 → original triangle ids.
// Outputs: [n_rays] each. Launches on `stream`; returns cudaGetLastError().
extern "C" int bvh_intersect(const float* rays, int n_rays, const int* n_live,
                             const float* nodes, const float* tris, const int* order,
                             int any_hit, float* t_out, int* prim_out, float* u_out,
                             float* v_out, int threads, void* stream) {
  if (n_rays <= 0) return 0;
  // __launch_bounds__ caps the block size at kThreads: a larger `threads`
  // is refused by the launch and comes back as its error.
  const int blocks = (n_rays + threads - 1) / threads;
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    bvh_intersect_kernel<true><<<blocks, threads, 0, s>>>(
        rays, n_rays, n_live, n4, t4, order, t_out, prim_out, u_out, v_out);
  } else {
    bvh_intersect_kernel<false><<<blocks, threads, 0, s>>>(
        rays, n_rays, n_live, n4, t4, order, t_out, prim_out, u_out, v_out);
  }
  return static_cast<int>(cudaGetLastError());
}
