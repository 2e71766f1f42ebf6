// Cluster-scan ray trace (nearest hit) for Hopper (sm_90a).
//
// Replaces the TPU kernel bifrost3d_tpu/geometry/pallas_clustered.py
// ::_clustered_kernel (driven by clustered_intersect). It computes the same
// function: triangles are in BVH leaf order, cut into clusters of 512 with
// one bounding box each; a block of 256 consecutive rays scans the clusters
// in slot order and fetches a cluster where some ray of the block passes the
// cluster's box with its running best t; every ray of the block takes the
// nearest hit among the fetched clusters' triangles. Closest hit only; the
// kernel maps the winning slot back through `order`.
//
// The block rule is the function and is kept exactly: one thread per ray,
// 256 a block, the TPU kernel's safe_inv (sign(d) / max(|d|, 1e-12)) and
// unpadded box rule (near clamped to t_min, near <= far, far > 0,
// near < best_t), __syncthreads_or as the block's "any ray passes", which
// the TPU kernel takes with pl.when. Inside a fetched cluster the work is
// not the TPU kernel's, where every ray tests all 512 triangles:
//
//   - a ray skips the cluster when it misses the cluster's padded box (the
//     union of its 16 chunk boxes) or enters it no nearer than its best hit,
//     then culls by the 16 padded 32-triangle chunk boxes and tests the
//     chunks it enters: csrc/dense_trace.cuh's trace, shared with the dense
//     kernel and the mesh megakernel, whose answer is the full scan's bit for
//     bit (the header says why; a cull by the unpadded box alone would not
//     give that). So the hits are the TPU design's bit for bit. A warp
//     whose rays enter different chunks traces them one at a time, a lane
//     per triangle, and a warp of coherent rays a thread per ray
//     (trace_span_warp chooses): with a thread per ray always, the slowest
//     ray of each fetch set the block's time on incoherent rays;
//   - clusters are staged as 48-byte records (24 KiB, an AoS copy of the
//     packing's table cached by the wrapper) with their chunk boxes, built
//     once per packing by the header's build_boxes_kernel; the next fetched
//     cluster loads with cp.async while the current one is tested. It is
//     chosen by the block rule with the best hits before the current
//     cluster, which can only pass more clusters; after the current
//     cluster the rule is taken again with the new best hits, and a cluster
//     that no longer passes is dropped (its load cost bytes, not answers);
//   - rays are read as the caller holds them (origin and direction [r, 3],
//     t_min and t_max a value, one device value or one per ray) and the
//     final hit (t = +inf, prim = -1, u = v = 0 on a miss) is written into
//     one [4, r] allocation.
//
// Ties: the lowest slot inside a cluster, the first cluster scanned across
// them (strict '<' in slot order), as the TPU kernel's column-min and
// `row_best < best` do.
//
// What bounds it on an H100: the box tests of every ray against every
// cluster's box (the scan is O(clusters) where a BVH walk is O(log)), and
// the chunk-box and triangle tests of the clusters a ray enters.
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

constexpr int kBlockR = 256;  // rays per block: the granule of the block rule
constexpr int kClusterT = dense_trace::kGroupTris;   // 512
constexpr int kTile = 3 * kClusterT + 2 * kGroupChunks;  // float4 per buffer
constexpr size_t kSmem = 2 * kTile * sizeof(float4);    // 50,176 bytes

__global__ void __launch_bounds__(kBlockR)
clustered_intersect_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                           int n_rays, Bound t_min, Bound t_max, const float4* __restrict__ boxes,
                           int n_clusters, const float4* __restrict__ recs,
                           const float4* __restrict__ chunk_boxes,
                           const float4* __restrict__ cluster_boxes, int n_tris,
                           const int* __restrict__ order, float* __restrict__ out) {
  extern __shared__ float4 s_buf[];  // [2][kTile]: records, then chunk boxes
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // A thread past the last ray stays for the barriers with a ray that passes
  // no box (best_t = 0).
  const bool in_range = i < n_rays;
  float3 o = make_float3(0.0f, 0.0f, 0.0f), d = o;
  float lo = 0.0f, best_t = 0.0f, best_u = 0.0f, best_v = 0.0f;
  if (in_range) {
    o = make_float3(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]);
    d = make_float3(direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
    lo = t_min.at(i);
    best_t = fminf(t_max.at(i), kBig);
  }
  const float3 inv = make_float3(dense_trace::safe_inv(d.x), dense_trace::safe_inv(d.y),
                                 dense_trace::safe_inv(d.z));
  int best = -1;

  // The TPU kernel's block rule for cluster c with the block's best hits now.
  auto fetch = [&](int c) {
    const float4 a = __ldg(&boxes[2 * c]);      // lo.xyz, hi.x
    const float4 b = __ldg(&boxes[2 * c + 1]);  // hi.yz, 0, 0
    const float x0 = (a.x - o.x) * inv.x, x1 = (a.w - o.x) * inv.x;
    const float y0 = (a.y - o.y) * inv.y, y1 = (b.x - o.y) * inv.y;
    const float z0 = (a.z - o.z) * inv.z, z1 = (b.y - o.z) * inv.z;
    const float t_near = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fmaxf(fminf(z0, z1), lo));
    const float t_far = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
    return __syncthreads_or(t_near <= t_far && t_far > 0.0f && t_near < best_t) != 0;
  };
  // The first cluster at or after c that the block fetches.
  auto next_fetched = [&](int c) {
    while (c < n_clusters && !fetch(c)) ++c;
    return c;
  };
  auto load = [&](int c, float4* buf) {
    const int count = min(kClusterT, n_tris - c * kClusterT);
    const int chunks = (count + kChunk - 1) / kChunk;
    dense_trace::copy_async(buf, recs + 3 * c * kClusterT, 3 * count);
    dense_trace::copy_async(buf + 3 * kClusterT, chunk_boxes + 2 * c * kGroupChunks, 2 * chunks);
    dense_trace::commit_async();
  };

  int c = next_fetched(0);
  if (c < n_clusters) load(c, s_buf);
  for (int cur = 0; c < n_clusters; cur ^= 1) {
    // A candidate for the next fetch, loaded while this cluster is tested:
    // chosen with the best hits before it, which can only pass more.
    int next = next_fetched(c + 1);
    if (next < n_clusters) {
      load(next, s_buf + (cur ^ 1) * kTile);
      dense_trace::wait_async<1>();
    } else {
      dense_trace::wait_async<0>();
    }
    __syncthreads();
    const int base = c * kClusterT;
    const float4* buf = s_buf + cur * kTile;
    dense_trace::trace_span_warp(
        buf, buf + 3 * kClusterT, min(kClusterT, n_tris - base), base,
        in_range && dense_trace::chunk_hit(cluster_boxes, c, o, inv, lo, best_t), o, d, inv, lo,
        best_t, best_u, best_v, best);
    __syncthreads();  // the buffer is refilled in the next round
    // The block rule again with this cluster's hits: the TPU kernel fetches
    // `next` only if it still passes.
    if (next < n_clusters && !fetch(next)) {
      dense_trace::wait_async<0>();
      __syncthreads();
      next = next_fetched(next + 1);
      if (next < n_clusters) load(next, s_buf + (cur ^ 1) * kTile);
    }
    c = next;
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
extern "C" int clustered_intersect_boxes(const float* tris, int n_tris, float* chunk_boxes,
                                         float* cluster_boxes, void* stream) {
  return dense_trace::build_boxes(reinterpret_cast<const float4*>(tris), n_tris,
                                  reinterpret_cast<float4*>(chunk_boxes),
                                  reinterpret_cast<float4*>(cluster_boxes),
                                  static_cast<cudaStream_t>(stream));
}

// origin, direction: [n_rays, 3] float32. t_min / t_max: the value, or a
// device pointer (stride 0: one value, stride 1: one per ray). boxes:
// [n_clusters, 8] float32 (lo.xyz hi.xyz 0 0), the packing's unpadded boxes;
// tris: [t_pad, 12] float32 records in slot order; chunk_boxes,
// cluster_boxes: their padded boxes as clustered_intersect_boxes builds them,
// one per 32 slots and one per cluster, n_clusters = ceil(n_tris / 512);
// order: [t_pad] int32 → original triangle ids. out: [4 * n_rays] float32:
// t, prim (int32 bits), u, v. Launches on `stream`; returns the first CUDA
// error (0 = launched).
extern "C" int clustered_intersect(const float* origin, const float* direction, int n_rays,
                                   float t_min, const float* t_min_ptr, int t_min_stride,
                                   float t_max, const float* t_max_ptr, int t_max_stride,
                                   const float* boxes, int n_clusters, const float* tris,
                                   const float* chunk_boxes, const float* cluster_boxes,
                                   int n_tris, const int* order, float* out, int threads,
                                   void* stream) {
  if (n_rays <= 0) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      clustered_intersect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // __launch_bounds__ caps the block size at kBlockR: a larger `threads` is
  // refused by the launch and comes back as its error.
  const int blocks = (n_rays + threads - 1) / threads;
  const Bound lo = {t_min, t_min_ptr, t_min_stride};
  const Bound hi = {t_max, t_max_ptr, t_max_stride};
  clustered_intersect_kernel<<<blocks, threads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      origin, direction, n_rays, lo, hi, reinterpret_cast<const float4*>(boxes), n_clusters,
      reinterpret_cast<const float4*>(tris), reinterpret_cast<const float4*>(chunk_boxes),
      reinterpret_cast<const float4*>(cluster_boxes), n_tris, order, out);
  return static_cast<int>(cudaGetLastError());
}
