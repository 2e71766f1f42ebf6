// The per-thread walk of the packed triangle BVH (nearest hit or any-hit),
// shared by csrc/bvh_intersect.cu (the wavefront's trace kernel) and
// csrc/mesh_megakernel.cu (the megakernel's BVH branch). The library cache
// hashes this header with each source that includes it.
//
// The walk reads the tree's child records (geometry/pallas_bvh.py
// ::pack_child_records): per internal node one 64-byte row holding both
// children's boxes and references (an internal row, or a leaf's first slot
// and count), four independent float4. A step is one read: the node's own
// box was tested from its parent's row. HierTriangles' node table (32 bytes
// per node, the right child in the node's own record) is the plain
// version's layout. A walk over it reads the node's own record before its
// children's boxes, two dependent reads per step; on an H100 it was 3-7%
// slower than this one on the same rays (PERF.md). Rows follow the node
// table's depth-first order, so an internal left child's row follows its
// parent's: breadth-first rows, one new cache line a step, were 8-15%
// slower than the node walk.
//
// The walk:
//
//   - one private stack of 64 entries and entry distances per thread (the
//     tree's depth is checked against it when it is packed);
//   - an internal node slab-tests both children with the TPU kernels'
//     safe_inv (sign(d) / max(|d|, 1e-12)) and box rule (near <= far, far > 0,
//     near < best_t, near clamped to t_min), descends into the nearer child
//     and pushes the farther; a popped entry whose entry distance is no
//     longer below best_t is dropped;
//   - a leaf runs the dense kernel's Möller–Trumbore (|det| > 1e-9 with a
//     true IEEE division, u >= 0, v >= 0, u + v <= 1, t > t_min, t < t_max,
//     t < best_t) in slot order, so a degenerate padded triangle
//     (e1 = e2 = 0) is rejected by its determinant; triangles are one
//     48-byte record per slot in leaf order (v0, e1, e2, padding), three
//     float4;
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

// Slab test of the box (lo, hi) → hit and entry distance.
__device__ __forceinline__ bool slab(float lx, float ly, float lz, float hx, float hy, float hz,
                                     const Ray& r, float best_t, float& t_near) {
  const float x0 = (lx - r.ox) * r.ix, x1 = (hx - r.ox) * r.ix;
  const float y0 = (ly - r.oy) * r.iy, y1 = (hy - r.oy) * r.iy;
  const float z0 = (lz - r.oz) * r.iz, z1 = (hz - r.oz) * r.iz;
  t_near = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fmaxf(fminf(z0, z1), r.t_min));
  const float t_far = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  return t_near <= t_far && t_far > 0.0f && t_near < best_t;
}

// Möller–Trumbore over the `count` triangles from slot `first`, in slot
// order → whether one was taken (with kAnyHit the first valid one).
template <bool kAnyHit>
__device__ __forceinline__ bool leaf_hit(const float4* __restrict__ tris, int first, int count,
                                         const Ray& r, float t_max, float& best_t, float& best_u,
                                         float& best_v, int& best_slot) {
  bool taken = false;
  for (int k = 0; k < count; ++k) {
    const int slot = first + k;
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
      taken = true;
      if (kAnyHit) break;
    }
  }
  return taken;
}

// Leaf references of a child record: ~(first slot << 3 | count - 1).
constexpr int kLeafCountBits = 3;

// Row `i` of the child records: left box (a.xyz, a.w b.xy), right box
// (b.zw c.x, c.yzw), references.
__device__ __forceinline__ void child_record(const float4* __restrict__ recs, int i, float4& a,
                                             float4& b, float4& c, int2& refs) {
  a = __ldg(&recs[4 * i]);
  b = __ldg(&recs[4 * i + 1]);
  c = __ldg(&recs[4 * i + 2]);
  refs = __ldg(reinterpret_cast<const int2*>(recs + 4 * i + 3));
}

// Walks the tree's child records `recs` for one ray within (r.t_min,
// t_max) → the hit's triangle slot, or -1 on a miss; best_t (kBig-clamped
// t_max on a miss), best_u and best_v are written either way. With kAnyHit
// only "slot >= 0" is defined. A reference is an internal row (> 0), a leaf
// (< 0) or none (0).
template <bool kAnyHit>
__device__ int walk(const float4* __restrict__ recs, const float4* __restrict__ tris, const Ray& r,
                    float t_max, float& best_t, float& best_u, float& best_v) {
  best_t = fminf(t_max, kBig);
  best_u = 0.0f;
  best_v = 0.0f;
  int best_slot = -1;

  int stack_ref[kStack];
  float stack_near[kStack];
  int sp = 0;
  float4 a, b, c;
  int2 refs;
  child_record(recs, 0, a, b, c, refs);   // row 0: the root
  float near_root;
  int ref = slab(a.x, a.y, a.z, a.w, b.x, b.y, r, best_t, near_root) ? refs.x : 0;

  while (ref != 0) {
    int next = 0;
    if (ref < 0) {
      const int leaf = ~ref;
      if (leaf_hit<kAnyHit>(tris, leaf >> kLeafCountBits, (leaf & ((1 << kLeafCountBits) - 1)) + 1,
                            r, t_max, best_t, best_u, best_v, best_slot) &&
          kAnyHit)
        break;
    } else {
      child_record(recs, ref, a, b, c, refs);
      float near_l, near_r;
      const bool hit_l = slab(a.x, a.y, a.z, a.w, b.x, b.y, r, best_t, near_l);
      const bool hit_r = slab(b.z, b.w, c.x, c.y, c.z, c.w, r, best_t, near_r);
      if (hit_l && hit_r) {
        const bool right_first = near_r < near_l;
        next = right_first ? refs.y : refs.x;
        // Never false: the packing refuses a tree deeper than kStack.
        if (sp < kStack) {
          stack_ref[sp] = right_first ? refs.x : refs.y;
          stack_near[sp] = right_first ? near_l : near_r;
          ++sp;
        }
      } else if (hit_l) {
        next = refs.x;
      } else if (hit_r) {
        next = refs.y;
      }
    }
    // Pop until an entry can still improve the hit.
    while (next == 0 && sp > 0) {
      --sp;
      if (stack_near[sp] < best_t) next = stack_ref[sp];
    }
    ref = next;
  }
  return best_slot;
}

}  // namespace bvh_walk
