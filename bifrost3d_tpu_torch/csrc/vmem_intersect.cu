// Resident-cluster BVH ray trace (nearest hit or any-hit occlusion) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel bifrost3d_tpu/geometry/pallas_bvh_vmem.py
// ::_make_vmem_kernel(any_hit) (driven by vmem_intersect). It computes the
// same function by the same walk: rays are taken in groups of 32, each group
// walks a BVH over 512-triangle clusters with ONE stack shared by the group
// (a node is entered when any ray of the group passes its box, the child
// whose nearest entry over the group is smaller is visited first), and at a
// leaf every ray of the group takes its nearest hit among the cluster's
// triangles. Groups that start at or past the live count report misses
// untraversed. With any-hit a ray that found an occluder is frozen (best t =
// t_min, so it passes no further box) and the group stops when all its rays
// are done.
//
// The walk is the TPU kernel's, translated to the card:
//
//   - a group is a warp: one ray per lane, the ray and its best hit in
//     registers; control flow is uniform across the warp;
//   - the group's stack of 64 node ids lives in shared memory, one per warp
//     (the tree's depth is checked against it when it is packed);
//   - "any ray passes" is __any_sync, the group's nearest entry a shuffle
//     min-reduction, "all rays done" __all_sync;
//   - node boxes are tested unpadded (near clamped to t_min, near <= far,
//     far > 0, near < best t), from 32-byte records (lo.xyz hi.xyz 0 0) that
//     every lane reads (one broadcast transaction); `meta` is the TPU
//     kernel's: internal → right child (left = node + 1), leaf → -(cluster +
//     1). The leaves are visited in the TPU kernel's order.
//
// The leaf test is not the TPU kernel's, where every ray of the group tests
// all 512 triangles of an entered leaf whether one ray needed it or all of
// them. Each lane culls on its own with csrc/dense_trace.cuh's trace, which
// the dense trace, the cluster scan and the mesh megakernel share: first the
// cluster's padded box (the union of its 16 padded chunk boxes), then the
// chunk boxes, then every triangle of an entered chunk with a strict '<' in
// slot order. The header argues why that is the full test's answer bit for
// bit, also for a lane that missed the leaf's unpadded box (which the TPU
// kernel tests too): so after every leaf each lane's best hit, and with it
// every later probe, push and tie, is the TPU design's.
//
//   - trace_span_warp: a thread per ray where the warp's rays enter the
//     same chunks, the warp on one ray at a time (a lane per triangle) where
//     they do not (kWarpShare chooses). Any-hit takes the leaf's nearest hit
//     so, then freezes the lane, as the plain version does: the occlusion
//     is the TPU kernel's, the hit kept is the leaf's nearest. A thread per
//     ray stopping at the first hit in slot order (trace_span<true>) was
//     2.1-4.7x slower on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6);
//   - the leaf's 16 chunk boxes are loaded by the warp into 512 bytes of
//     its own shared memory (one coalesced load, a float4 a lane), only when
//     some lane enters the padded cluster box; the triangles are 48-byte
//     records (an AoS copy of the packing's rows 0-11, made and cached by
//     the wrapper with its boxes) read through the read-only path from L2.
//     Staging the leaf's 24 KiB of records per warp in shared memory with
//     cp.async first was 18-39% faster on the bridge's camera rays and
//     48-75% slower on incoherent and surrounding rays (PERF.md §6).
//
// "Resident in VMEM" has no equal here: a block has 227 KB of shared memory,
// the table may be 12 MiB. What holds the table close is the 50 MB L2; the
// packing's 12 MiB cap (fits_vmem) keeps it well inside, beside the rays.
//
// The kernel reads the rays as the wavefront holds them (origin and
// direction [r, 3]; t_min and t_max each a value, one device value or one
// per ray; the live count a value or one int32 / int64 on the device, so a
// pool's live sum costs no host sync) and writes the final hit — t = +inf,
// prim = -1 (mapped through `order`), u = v = 0 on a miss — into one [4, r]
// allocation.
//
// What bounds it on an H100: the walk's dependent node reads (one pop, two
// probes, three warp votes a step) and the chunk-box and triangle tests of
// the chunks a ray enters in the leaves its group enters.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>

#include "dense_trace.cuh"

namespace {

using dense_trace::Bound;
using dense_trace::kBig;
using dense_trace::kChunk;
using dense_trace::kGroupChunks;
using dense_trace::Live;

constexpr int kThreads = 128;   // the largest block the kernel is built for
constexpr int kWarps = kThreads / 32;
constexpr int kClusterT = dense_trace::kGroupTris;   // 512
constexpr int kStack = 64;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    x = fminf(x, __shfl_xor_sync(kFull, x, offset));
  return x;
}

// Slab test of node `n`'s unpadded box for this lane → hit and entry
// distance: the TPU kernel's rule.
__device__ __forceinline__ bool probe(const float4* __restrict__ nodes, int n, float3 o,
                                      float3 inv, float t_min, float best_t, float& t_near) {
  const float4 a = __ldg(&nodes[2 * n]);
  const float4 b = __ldg(&nodes[2 * n + 1]);
  const float x0 = (a.x - o.x) * inv.x, x1 = (a.w - o.x) * inv.x;
  const float y0 = (a.y - o.y) * inv.y, y1 = (b.x - o.y) * inv.y;
  const float z0 = (a.z - o.z) * inv.z, z1 = (b.y - o.z) * inv.z;
  t_near = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fmaxf(fminf(z0, z1), t_min));
  const float t_far = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  return t_near <= t_far && t_far > 0.0f && t_near < best_t;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
vmem_intersect_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                      int n_rays, Bound t_min, Bound t_max, Live live,
                      const float4* __restrict__ nodes, const int* __restrict__ meta,
                      const float4* __restrict__ recs, const float4* __restrict__ chunk_boxes,
                      const float4* __restrict__ cluster_boxes, int n_tris,
                      const int* __restrict__ order, float* __restrict__ out) {
  __shared__ int s_stack[kWarps][kStack];
  __shared__ float4 s_boxes[kWarps][2 * kGroupChunks];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group_start = blockIdx.x * blockDim.x + threadIdx.x - lane;
  if (group_start >= n_rays) return;   // the whole warp
  const int i = group_start + lane;
  const bool in_range = i < n_rays;

  float best_t = 0.0f, best_u = 0.0f, best_v = 0.0f;
  int best = -1;

  if (group_start < live.get(n_rays)) {   // the whole warp
    // A lane past the last ray walks along with a ray that passes no box:
    // best t = t_min = 0.
    float3 o = make_float3(0.0f, 0.0f, 0.0f), d = o;
    float lo = 0.0f;
    if (in_range) {
      o = make_float3(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]);
      d = make_float3(direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
      lo = t_min.at(i);
      best_t = fminf(t_max.at(i), kBig);
    }
    const float3 inv = make_float3(dense_trace::safe_inv(d.x), dense_trace::safe_inv(d.y),
                                   dense_trace::safe_inv(d.z));
    float4* box = s_boxes[warp];

    int* stack = s_stack[warp];
    if (lane == 0) stack[0] = 0;
    __syncwarp();
    int sp = 1;
    while (sp > 0) {
      const int node = stack[--sp];
      __syncwarp();   // every lane has read the slot before it is reused
      const int m = __ldg(&meta[node]);
      if (m < 0) {
        float near_leaf;
        if (__any_sync(kFull, probe(nodes, node, o, inv, lo, best_t, near_leaf))) {
          const int c = -m - 1;
          const bool enters = in_range && dense_trace::chunk_hit(cluster_boxes, c, o, inv, lo,
                                                                 best_t);
          if (__any_sync(kFull, enters)) {
            const int base = c * kClusterT;
            const int count = min(kClusterT, n_tris - base);
            const int chunks = (count + kChunk - 1) / kChunk;
            if (lane < 2 * chunks) box[lane] = __ldg(&chunk_boxes[2 * kGroupChunks * c + lane]);
            __syncwarp();
            dense_trace::trace_span_warp(recs + 3 * base, box, count, base, enters, o, d, inv,
                                         lo, best_t, best_u, best_v, best);
            if (kAnyHit && best >= 0) best_t = lo;   // freeze the lane
            __syncwarp();   // the boxes are reloaded at the next leaf
          }
        }
      } else {
        const int left = node + 1, right = m;
        float near_l, near_r;
        const bool hit_l = probe(nodes, left, o, inv, lo, best_t, near_l);
        const bool hit_r = probe(nodes, right, o, inv, lo, best_t, near_r);
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
      if (kAnyHit && __all_sync(kFull, best >= 0 || !in_range)) sp = 0;
    }
  }

  if (!in_range) return;
  const bool miss = best < 0;
  out[i] = miss ? __int_as_float(0x7f800000) : best_t;  // +inf on a miss
  out[n_rays + i] = __int_as_float(miss ? -1 : __ldg(order + best));
  out[2 * n_rays + i] = miss ? 0.0f : best_u;
  out[3 * n_rays + i] = miss ? 0.0f : best_v;
}

}  // namespace

// The chunk and cluster boxes of a packing's records: tris [n_tris, 12]
// float32 → chunk_boxes [ceil(n_tris / 32), 8], cluster_boxes
// [ceil(n_tris / 512), 8] float32 (lo.xyz 0 hi.xyz 0). Launches on `stream`;
// returns cudaGetLastError().
extern "C" int vmem_intersect_boxes(const float* tris, int n_tris, float* chunk_boxes,
                                    float* cluster_boxes, void* stream) {
  return dense_trace::build_boxes(reinterpret_cast<const float4*>(tris), n_tris,
                                  reinterpret_cast<float4*>(chunk_boxes),
                                  reinterpret_cast<float4*>(cluster_boxes),
                                  static_cast<cudaStream_t>(stream));
}

// origin, direction: [n_rays, 3] float32. t_min / t_max: the value, or a
// device pointer (stride 0: one value, stride 1: one per ray). The live count:
// n_live, or one device integer of live_bits 32 or 64 (null: n_live); groups
// of 32 rays that start at an index >= it miss untraversed. nodes: [n_nodes,
// 8] float32 (lo.xyz hi.xyz 0 0); meta: [n_nodes] int32; tris: [n_tris, 12]
// float32 records in slot order; chunk_boxes, cluster_boxes: their padded
// boxes as vmem_intersect_boxes builds them; order: [>= n_tris] int32 →
// original triangle ids. out: [4 * n_rays] float32: t, prim (int32 bits), u,
// v. Launches on `stream`; returns the first CUDA error (0 = launched).
extern "C" int vmem_intersect(const float* origin, const float* direction, int n_rays,
                              float t_min, const float* t_min_ptr, int t_min_stride, float t_max,
                              const float* t_max_ptr, int t_max_stride, int n_live,
                              const void* live_ptr, int live_bits, const float* nodes,
                              const int* meta, const float* tris, const float* chunk_boxes,
                              const float* cluster_boxes, int n_tris, const int* order,
                              int any_hit, float* out, int threads, void* stream) {
  if (n_rays <= 0) return 0;
  if (threads <= 0 || threads % 32 != 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Bound lo = {t_min, t_min_ptr, t_min_stride};
  const Bound hi = {t_max, t_max_ptr, t_max_stride};
  const Live live = {n_live, live_bits == 32 ? static_cast<const int*>(live_ptr) : nullptr,
                     live_bits == 64 ? static_cast<const long long*>(live_ptr) : nullptr};
  auto kernel = any_hit ? vmem_intersect_kernel<true> : vmem_intersect_kernel<false>;
  // __launch_bounds__ caps the block size at kThreads: a larger `threads` is
  // refused by the launch and comes back as its error.
  const int blocks = (n_rays + threads - 1) / threads;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      origin, direction, n_rays, lo, hi, live, reinterpret_cast<const float4*>(nodes), meta,
      reinterpret_cast<const float4*>(tris), reinterpret_cast<const float4*>(chunk_boxes),
      reinterpret_cast<const float4*>(cluster_boxes), n_tris, order, out);
  return static_cast<int>(cudaGetLastError());
}
