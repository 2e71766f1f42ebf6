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
//   - one thread per ray with a private stack of 64 node ids and entry
//     distances (the tree's depth is checked against it when it is built);
//   - the tree is the triangle BVH itself (leaves of at most 4 triangles),
//     one 32-byte record per node: lo.xyz hi.xyz, then node_a and node_count
//     as int bits (leaf: first triangle slot and count; internal: right
//     child and 0; the left child is node + 1), read as two float4;
//   - triangles are in leaf order as 48-byte records (v0, e1, e2, padding),
//     read as three float4; `order` maps a slot back to the original id;
//   - an internal node slab-tests both children with the TPU kernel's
//     safe_inv (sign(d) / max(|d|, 1e-12)) and box rule (near <= far, far > 0,
//     near < best_t, near clamped to t_min), descends into the nearer child
//     and pushes the farther; a popped entry whose entry distance is no
//     longer below best_t is dropped;
//   - a leaf runs the dense kernel's Möller–Trumbore (|det| > 1e-9 with a
//     true IEEE division, u >= 0, v >= 0, u + v <= 1, t > t_min, t < t_max,
//     t < best_t) in slot order, so a degenerate padded triangle
//     (e1 = e2 = 0) is rejected by its determinant;
//   - with kAnyHit the thread returns at its first valid hit.
//
// Ties: among equal t the first-found hit stays (strict '<'). The walk
// visits leaves near-first, the plain version left-first and the TPU kernel
// cluster by cluster, so two triangles at the same t (a shared edge, coplanar
// faces) may answer with either id; comparisons allow that.
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

namespace {

constexpr int kThreads = 128;  // the largest block the kernel is built for
constexpr int kStack = 64;
constexpr float kBig = 3.0e38f;
constexpr float kEpsDet = 1e-9f;

__device__ __forceinline__ float safe_inv(float x) {
  return __fdiv_rn(x < 0.0f ? -1.0f : 1.0f, fmaxf(fabsf(x), 1e-12f));
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, t_min;
};

// Slab test of node `n` → hit and entry distance.
__device__ __forceinline__ bool box_hit(const float4* __restrict__ nodes, int n,
                                        const Ray& r, float best_t, float& t_near) {
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
    Ray r;
    r.ox = rays[0 * n_rays + i];
    r.oy = rays[1 * n_rays + i];
    r.oz = rays[2 * n_rays + i];
    r.dx = rays[3 * n_rays + i];
    r.dy = rays[4 * n_rays + i];
    r.dz = rays[5 * n_rays + i];
    r.t_min = rays[6 * n_rays + i];
    const float t_max = rays[7 * n_rays + i];
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    best_t = fminf(t_max, kBig);

    int stack_node[kStack];
    float stack_near[kStack];
    int sp = 0;
    float near_root;
    int node = box_hit(nodes, 0, r, best_t, near_root) ? 0 : -1;

    while (node >= 0) {
      const float4 rec = __ldg(&nodes[2 * node + 1]);
      const int a = __float_as_int(rec.z);
      const int count = __float_as_int(rec.w);
      int next = -1;
      if (count > 0) {
        for (int k = 0; k < count; ++k) {
          const int slot = a + k;
          const float4 q0 = __ldg(&tris[3 * slot]);
          const float4 q1 = __ldg(&tris[3 * slot + 1]);
          const float4 q2 = __ldg(&tris[3 * slot + 2]);
          const float v0x = q0.x, v0y = q0.y, v0z = q0.z;
          const float e1x = q0.w, e1y = q1.x, e1z = q1.y;
          const float e2x = q1.z, e2y = q1.w, e2z = q2.x;
          // pvec = d x e2
          const float px = r.dy * e2z - r.dz * e2y;
          const float py = r.dz * e2x - r.dx * e2z;
          const float pz = r.dx * e2y - r.dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const bool det_ok = fabsf(det) > kEpsDet;
          const float inv_det = __fdiv_rn(det_ok ? 1.0f : 0.0f, det == 0.0f ? 1.0f : det);
          // tvec = o - v0
          const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
          const float u = (tx * px + ty * py + tz * pz) * inv_det;
          // qvec = tvec x e1
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
          const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          const bool valid = det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                             t > r.t_min && t < t_max && t < best_t;
          if (valid) {
            best_t = t;
            best_slot = slot;
            best_u = u;
            best_v = v;
            if (kAnyHit) break;
          }
        }
        if (kAnyHit && best_slot >= 0) break;
      } else {
        const int left = node + 1, right = a;
        float near_l, near_r;
        const bool hit_l = box_hit(nodes, left, r, best_t, near_l);
        const bool hit_r = box_hit(nodes, right, r, best_t, near_r);
        if (hit_l && hit_r) {
          const bool right_first = near_r < near_l;
          next = right_first ? right : left;
          // Never false: the wrapper refuses a tree deeper than kStack.
          if (sp < kStack) {
            stack_node[sp] = right_first ? left : right;
            stack_near[sp] = right_first ? near_l : near_r;
            ++sp;
          }
        } else if (hit_l) {
          next = left;
        } else if (hit_r) {
          next = right;
        }
      }
      // Pop until an entry can still improve the hit.
      while (next < 0 && sp > 0) {
        --sp;
        if (stack_near[sp] < best_t) next = stack_node[sp];
      }
      node = next;
    }
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
