// Resident-cluster BVH ray trace (nearest hit or any-hit occlusion) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel bifrost3d_tpu/geometry/pallas_bvh_vmem.py
// ::_make_vmem_kernel(any_hit) (driven by vmem_intersect). It computes the
// same function by the same walk: rays are taken in groups of 32, each group
// walks a BVH over 512-triangle clusters with ONE stack shared by the group
// (a node is entered when any ray of the group passes its box, the child
// whose nearest entry over the group is smaller is visited first), and at a
// leaf every ray of the group is tested against the cluster's triangles,
// which are read in place from the component-planar table — no per-leaf copy.
// Groups that start at or past *n_live report misses untraversed. With
// any-hit a ray that found an occluder is frozen (best t = t_min, so it
// passes no further box) and the group stops when all its rays are done.
//
// Translated to the card:
//
//   - a group is a warp: one ray per lane, the ray and its best hit in
//     registers; control flow is uniform across the warp;
//   - the group's stack of 64 node ids lives in shared memory, one per warp
//     (the tree's depth is checked against it when it is packed);
//   - "any ray passes" is __any_sync, the group's nearest entry a shuffle
//     min-reduction, "all rays done" __all_sync;
//   - node records are 32 bytes (lo.xyz hi.xyz 0 0) read as two float4 by
//     every lane (one broadcast transaction); `meta` is the TPU kernel's:
//     internal → right child (left = node + 1), leaf → -(cluster + 1);
//   - at a leaf all lanes read the same triangle's nine components from the
//     planar table [16, T_pad] (uniform loads, served by L1/L2) and test
//     their own ray; the last cluster stops at n_tris.
//
// "Resident in VMEM" has no equal here: a block has 227 KB of shared memory,
// the table may be 12 MiB. What holds the table close is the 50 MB L2; the
// packing's 12 MiB cap (fits_vmem) keeps it well inside, beside the rays.
//
// Ties: inside a leaf the lowest slot wins, across leaves the first one
// visited (strict '<'), as in the TPU kernel; the visit order is the TPU
// kernel's too, so on the same packing both answer a tie alike.
//
// A miss writes t = 3e38, prim = -1, u = v = 0; the wrapper turns t into inf.
//
// What bounds it on an H100: float32 operations in the leaves. Every leaf a
// warp enters costs 32 x 512 x ~50 flops whether one lane or all of them
// needed it, so incoherent groups pay for the union of their rays' leaves.
// The design does nothing about that; a per-ray walk over 4-triangle leaves
// (csrc/bvh_intersect.cu) tests two orders of magnitude fewer triangles.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // the largest block the kernel is built for
constexpr int kGroup = 32;      // rays per walk: a warp
constexpr int kClusterT = 512;
constexpr int kStack = 64;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kBig = 3.0e38f;
constexpr float kEpsDet = 1e-9f;

__device__ __forceinline__ float safe_inv(float x) {
  return __fdiv_rn(x < 0.0f ? -1.0f : 1.0f, fmaxf(fabsf(x), 1e-12f));
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int offset = kGroup / 2; offset > 0; offset >>= 1)
    x = fminf(x, __shfl_xor_sync(kFull, x, offset));
  return x;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, t_min, t_max;
};

// Slab test of node `n` for this lane → hit and entry distance.
__device__ __forceinline__ bool probe(const float4* __restrict__ nodes, int n, const Ray& r,
                                      float best_t, float& t_near) {
  const float4 a = __ldg(&nodes[2 * n]);
  const float4 b = __ldg(&nodes[2 * n + 1]);
  const float x0 = (a.x - r.ox) * r.ix, x1 = (a.w - r.ox) * r.ix;
  const float y0 = (a.y - r.oy) * r.iy, y1 = (b.x - r.oy) * r.iy;
  const float z0 = (a.z - r.oz) * r.iz, z1 = (b.y - r.oz) * r.iz;
  t_near = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fmaxf(fminf(z0, z1), r.t_min));
  const float t_far = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  return t_near <= t_far && t_far > 0.0f && t_near < best_t;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
vmem_intersect_kernel(const float* __restrict__ rays, int n_rays,
                      const int* __restrict__ n_live_ptr, const float4* __restrict__ nodes,
                      const int* __restrict__ meta, const float* __restrict__ planes, int t_pad,
                      int n_tris, const int* __restrict__ order, float* __restrict__ t_out,
                      int* __restrict__ prim_out, float* __restrict__ u_out,
                      float* __restrict__ v_out) {
  __shared__ int s_stack[kThreads / kGroup][kStack];

  const int lane = threadIdx.x % kGroup;
  const int group_start = blockIdx.x * blockDim.x + threadIdx.x - lane;
  if (group_start >= n_rays) return;   // the whole warp
  const int i = group_start + lane;
  const bool in_range = i < n_rays;

  float best_t = kBig, best_u = 0.0f, best_v = 0.0f;
  int best_slot = -1;

  if (group_start < *n_live_ptr) {     // the whole warp
    const int j = in_range ? i : group_start;
    Ray r;
    r.ox = rays[0 * n_rays + j];
    r.oy = rays[1 * n_rays + j];
    r.oz = rays[2 * n_rays + j];
    r.dx = rays[3 * n_rays + j];
    r.dy = rays[4 * n_rays + j];
    r.dz = rays[5 * n_rays + j];
    r.t_min = rays[6 * n_rays + j];
    r.t_max = rays[7 * n_rays + j];
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    // A lane past the last ray walks along with a ray that passes no box.
    best_t = in_range ? fminf(r.t_max, kBig) : r.t_min;

    int* stack = s_stack[threadIdx.x / kGroup];
    if (lane == 0) stack[0] = 0;
    __syncwarp();
    int sp = 1;
    while (sp > 0) {
      const int node = stack[--sp];
      __syncwarp();   // every lane has read the slot before it is reused
      const int m = __ldg(&meta[node]);
      if (m < 0) {
        float near_leaf;
        if (__any_sync(kFull, probe(nodes, node, r, best_t, near_leaf))) {
          const int base = (-m - 1) * kClusterT;
          const int count = min(kClusterT, n_tris - base);
          const float* tri = planes + base;
          for (int k = 0; k < count; ++k) {
            const float v0x = __ldg(tri + 0 * t_pad + k), v0y = __ldg(tri + 1 * t_pad + k);
            const float v0z = __ldg(tri + 2 * t_pad + k), e1x = __ldg(tri + 3 * t_pad + k);
            const float e1y = __ldg(tri + 4 * t_pad + k), e1z = __ldg(tri + 5 * t_pad + k);
            const float e2x = __ldg(tri + 6 * t_pad + k), e2y = __ldg(tri + 7 * t_pad + k);
            const float e2z = __ldg(tri + 8 * t_pad + k);
            const float px = r.dy * e2z - r.dz * e2y;
            const float py = r.dz * e2x - r.dx * e2z;
            const float pz = r.dx * e2y - r.dy * e2x;
            const float det = e1x * px + e1y * py + e1z * pz;
            const bool det_ok = fabsf(det) > kEpsDet;
            const float inv_det = __fdiv_rn(det_ok ? 1.0f : 0.0f, det == 0.0f ? 1.0f : det);
            const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
            const float u = (tx * px + ty * py + tz * pz) * inv_det;
            const float qx = ty * e1z - tz * e1y;
            const float qy = tz * e1x - tx * e1z;
            const float qz = tx * e1y - ty * e1x;
            const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
            const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
            const bool valid = det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                               t > r.t_min && t < r.t_max && t < best_t;
            if (valid) {
              best_slot = base + k;
              best_u = u;
              best_v = v;
              best_t = kAnyHit ? r.t_min : t;   // any-hit: freeze the lane
            }
          }
        }
      } else {
        const int left = node + 1, right = m;
        float near_l, near_r;
        const bool hit_l = probe(nodes, left, r, best_t, near_l);
        const bool hit_r = probe(nodes, right, r, best_t, near_r);
        const bool any_l = __any_sync(kFull, hit_l);
        const bool any_r = __any_sync(kFull, hit_r);
        const float est_l = warp_min(hit_l ? near_l : kBig);
        const float est_r = warp_min(hit_r ? near_r : kBig);
        // The child pushed last is popped first: the nearer one.
        const bool swap = est_l > est_r;
        const int first = swap ? right : left, second = swap ? left : right;
        const bool push_first = swap ? any_r : any_l, push_second = swap ? any_l : any_r;
        if (lane == 0) {
          int top = sp;
          if (push_second) stack[top++] = second;
          if (push_first) stack[top++] = first;
        }
        sp += static_cast<int>(push_second) + static_cast<int>(push_first);
        __syncwarp();
      }
      if (kAnyHit && __all_sync(kFull, best_slot >= 0 || !in_range)) sp = 0;
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
// n_live: one int32 on the device (groups of 32 rays that start at an index
// >= it miss untraversed). nodes: [n_nodes, 8] float32 (lo.xyz hi.xyz 0 0);
// meta: [n_nodes] int32; planes: [>= 9, t_pad] float32 component-planar
// (v0, e1, e2) in slot order; order: [t_pad] int32 → original triangle ids.
// Outputs: [n_rays] each. Launches on `stream`; returns cudaGetLastError().
extern "C" int vmem_intersect(const float* rays, int n_rays, const int* n_live,
                              const float* nodes, const int* meta, const float* planes, int t_pad,
                              int n_tris, const int* order, int any_hit, float* t_out,
                              int* prim_out, float* u_out, float* v_out, int threads,
                              void* stream) {
  if (n_rays <= 0) return 0;
  if (threads <= 0 || threads % kGroup != 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  // __launch_bounds__ caps the block size at kThreads: a larger `threads` is
  // refused by the launch and comes back as its error.
  const int blocks = (n_rays + threads - 1) / threads;
  const float4* n4 = reinterpret_cast<const float4*>(nodes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    vmem_intersect_kernel<true><<<blocks, threads, 0, s>>>(
        rays, n_rays, n_live, n4, meta, planes, t_pad, n_tris, order, t_out, prim_out, u_out,
        v_out);
  } else {
    vmem_intersect_kernel<false><<<blocks, threads, 0, s>>>(
        rays, n_rays, n_live, n4, meta, planes, t_pad, n_tris, order, t_out, prim_out, u_out,
        v_out);
  }
  return static_cast<int>(cudaGetLastError());
}
