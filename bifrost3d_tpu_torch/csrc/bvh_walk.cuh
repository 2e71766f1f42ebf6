// Per-thread walk of the packed triangle BVH (nearest hit or any-hit), shared
// by csrc/bvh_intersect.cu (the wavefront's trace kernel) and
// csrc/mesh_megakernel.cu (the megakernel's BVH branch). The library cache
// hashes this header with each source that includes it.
//
// The tree is geometry/pallas_bvh.py::HierTriangles: one 32-byte record per
// node (lo.xyz hi.xyz, then node_a and node_count as int bits; leaf: first
// triangle slot and count, internal: right child and 0, the left child is
// node + 1), read as two float4, and one 48-byte record per triangle slot in
// leaf order (v0, e1, e2, padding), read as three float4.
//
//   - one private stack of 64 node ids and entry distances per thread (the
//     tree's depth is checked against it when it is packed);
//   - an internal node slab-tests both children with the TPU kernels'
//     safe_inv (sign(d) / max(|d|, 1e-12)) and box rule (near <= far, far > 0,
//     near < best_t, near clamped to t_min), descends into the nearer child
//     and pushes the farther; a popped entry whose entry distance is no
//     longer below best_t is dropped;
//   - a leaf runs the dense kernel's Möller–Trumbore (|det| > 1e-9 with a
//     true IEEE division, u >= 0, v >= 0, u + v <= 1, t > t_min, t < t_max,
//     t < best_t) in slot order, so a degenerate padded triangle
//     (e1 = e2 = 0) is rejected by its determinant;
//   - with kAnyHit the walk returns at its first valid hit.
//
// Ties: among equal t the first-found hit stays (strict '<'); leaves are
// visited near-first.

#pragma once

#include <cuda_runtime.h>

namespace bvh_walk {

constexpr int kStack = 64;
constexpr float kBig = 3.0e38f;
constexpr float kEpsDet = 1e-9f;

__device__ __forceinline__ float safe_inv(float x) {
  return __fdiv_rn(x < 0.0f ? -1.0f : 1.0f, fmaxf(fabsf(x), 1e-12f));
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, t_min;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx, float dy, float dz,
                                        float t_min) {
  Ray r;
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  r.dx = dx;
  r.dy = dy;
  r.dz = dz;
  r.ix = safe_inv(dx);
  r.iy = safe_inv(dy);
  r.iz = safe_inv(dz);
  r.t_min = t_min;
  return r;
}

// Slab test of node `n` → hit and entry distance.
__device__ __forceinline__ bool box_hit(const float4* __restrict__ nodes, int n, const Ray& r,
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

// Walks the tree for one ray within (r.t_min, t_max) → the hit's triangle
// slot, or -1 on a miss; best_t (kBig-clamped t_max on a miss), best_u and
// best_v are written either way. With kAnyHit only "slot >= 0" is defined.
template <bool kAnyHit>
__device__ int walk(const float4* __restrict__ nodes, const float4* __restrict__ tris, const Ray& r,
                    float t_max, float& best_t, float& best_u, float& best_v) {
  best_t = fminf(t_max, kBig);
  best_u = 0.0f;
  best_v = 0.0f;
  int best_slot = -1;

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
        const bool valid = det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > r.t_min &&
                           t < t_max && t < best_t;
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
        // Never false: the packing refuses a tree deeper than kStack.
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
  return best_slot;
}

}  // namespace bvh_walk
