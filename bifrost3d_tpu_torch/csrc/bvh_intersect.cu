// BVH ray trace (nearest hit or any-hit occlusion) for Hopper (sm_90a).
//
// Replaces the TPU kernel bifrost3d_tpu/geometry/pallas_bvh.py
// ::_make_hier_kernel(any_hit) (driven by hierarchical_intersect). It
// computes the same function — for every ray the nearest triangle hit
// (t, original triangle id, u, v) within (t_min, t_max), or with any-hit
// whether some triangle lies there; rays at an index >= the live count report
// misses untraversed — but not by the same walk. The TPU kernel raises the
// traversal from ray to ray block: one scalar stack per 32-ray sub-group over
// a BVH of 512-triangle clusters, dense Möller–Trumbore inside a cluster,
// because a per-lane stack is hostile to a vector machine. A GPU thread has
// its own registers and local memory, so here:
//
//   - one thread per ray walks the triangle BVH itself (leaves of at most 4
//     triangles) with a private stack, one 64-byte child record (both
//     children's boxes) per step: the walk, its records and its tie rule
//     are in csrc/bvh_walk.cuh, which the mesh megakernel's BVH branch
//     shares;
//   - the kernel reads the rays as the wavefront holds them (origin and
//     direction [r, 3]; t_min and t_max each a value, one device value, or
//     one per ray; the live count a value or one int32 / int64 on the
//     device, so a pool's live sum costs no host sync) and writes the final
//     hit: t = +inf, prim = -1, u = v = 0 on a miss, `order[slot]` on a hit
//     — into one [4, r] allocation, with nothing left for the wrapper to do;
//   - persistent warps: one grid of as many blocks as the SMs hold at once;
//     each warp takes 32-ray batches from an atomic counter (reset by a
//     memset on the same stream before the launch) until the rays run out,
//     so a warp whose rays end early takes the next batch instead of idling
//     while the slowest warp of its block walks (Aila and Laine's persistent
//     threads, at batch granularity).
//
// Ties: the walk visits leaves near-first, the plain version left-first and
// the TPU kernel cluster by cluster, so two triangles at the same t (a shared
// edge, coplanar faces) may answer with either id; comparisons allow that.
//
// What bounds it on an H100: memory latency, not bytes or flops. A ray reads
// 24 B and writes 16 B, and enters some tens of internal nodes (one
// dependent 64-byte record each) and a few leaves (48 B per triangle)
// through L2/L1; incoherent rays diverge within the warp. Sorting rays
// (hierarchical_intersect_sorted, the pool's sort) is what keeps
// neighbouring threads in neighbouring subtrees.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace {

constexpr int kThreads = 128;  // the largest block the kernel is built for

struct Bound {
  float value;          // used when ptr is null
  const float* ptr;     // one device value (stride 0) or one per ray (stride 1)
  int stride;
  __device__ __forceinline__ float at(int i) const { return ptr ? ptr[i * stride] : value; }
};

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
bvh_intersect_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                     int n_rays, Bound t_min, Bound t_max, int n_live,
                     const int* __restrict__ live32, const long long* __restrict__ live64,
                     const float4* __restrict__ recs, const float4* __restrict__ tris,
                     const int* __restrict__ order, float* __restrict__ out,
                     int* __restrict__ counter) {
  int live = n_live;
  if (live32) live = *live32;
  if (live64) live = static_cast<int>(min(*live64, static_cast<long long>(n_rays)));
  live = min(max(live, 0), n_rays);
  const int lane = threadIdx.x & 31;
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n_rays) break;
    const int i = base + lane;
    if (i < n_rays) {
      float best_t = bvh_walk::kBig, best_u = 0.0f, best_v = 0.0f;
      int slot = -1;
      if (i < live) {
        const bvh_walk::Ray r = bvh_walk::make_ray(
            origin[3 * i], origin[3 * i + 1], origin[3 * i + 2], direction[3 * i],
            direction[3 * i + 1], direction[3 * i + 2], t_min.at(i));
        slot = bvh_walk::walk<kAnyHit>(recs, tris, r, t_max.at(i), best_t, best_u, best_v);
      }
      const bool miss = slot < 0;
      out[i] = miss ? __int_as_float(0x7f800000) : best_t;   // +inf on a miss
      out[n_rays + i] = __int_as_float(miss ? -1 : __ldg(order + slot));
      out[2 * n_rays + i] = miss ? 0.0f : best_u;
      out[3 * n_rays + i] = miss ? 0.0f : best_v;
    }
  }
}

template <bool kAnyHit>
int blocks_per_sm(int threads) {
  int blocks = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bvh_intersect_kernel<kAnyHit>, threads, 0);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return blocks;
}

template <bool kAnyHit>
int launch(const float* origin, const float* direction, int n_rays, Bound t_min, Bound t_max,
           int n_live, const int* live32, const long long* live64, const float4* recs,
           const float4* tris, const int* order, float* out, int threads, cudaStream_t s) {
  // __launch_bounds__ caps the block size at kThreads: a larger `threads`
  // has no occupancy and comes back as a launch error.
  const int per_sm = blocks_per_sm<kAnyHit>(threads);
  if (per_sm < 0) return -per_sm;
  if (per_sm == 0 || threads % 32 != 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int needed = (n_rays + threads - 1) / threads;
  const int blocks = min(needed, per_sm * sms);
  int* counter = reinterpret_cast<int*>(out + 4 * static_cast<size_t>(n_rays));
  cudaError_t e = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  bvh_intersect_kernel<kAnyHit><<<blocks, threads, 0, s>>>(origin, direction, n_rays, t_min, t_max,
                                                           n_live, live32, live64, recs, tris,
                                                           order, out, counter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// origin, direction: [n_rays, 3] float32. t_min / t_max: the value, or a
// device pointer (stride 0: one value, stride 1: one per ray). The live count:
// n_live, or one device integer of live_bits 32 or 64 (null: n_live). recs:
// [n_records, 16] float32 child records (pack_child_records); tris: [n_slots, 12] float32 records in leaf
// order; order: [n_slots] int32 → original triangle ids. out: [4 * n_rays + 1]
// float32: t, prim (int32 bits), u, v, then the work counter. Launches on
// `stream`; returns the first CUDA error (0 = launched).
extern "C" int bvh_intersect(const float* origin, const float* direction, int n_rays, float t_min,
                             const float* t_min_ptr, int t_min_stride, float t_max,
                             const float* t_max_ptr, int t_max_stride, int n_live,
                             const void* live_ptr, int live_bits, const float* recs,
                             const float* tris, const int* order, int any_hit, float* out,
                             int threads, void* stream) {
  if (n_rays <= 0) return 0;
  const Bound lo = {t_min, t_min_ptr, t_min_stride};
  const Bound hi = {t_max, t_max_ptr, t_max_stride};
  const int* live32 = live_bits == 32 ? static_cast<const int*>(live_ptr) : nullptr;
  const long long* live64 = live_bits == 64 ? static_cast<const long long*>(live_ptr) : nullptr;
  const float4* r4 = reinterpret_cast<const float4*>(recs);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return any_hit ? launch<true>(origin, direction, n_rays, lo, hi, n_live, live32, live64, r4, t4,
                                order, out, threads, s)
                 : launch<false>(origin, direction, n_rays, lo, hi, n_live, live32, live64, r4, t4,
                                 order, out, threads, s);
}

// Blocks of `threads` that one SM holds at once (the persistent grid's
// width per SM), or minus the CUDA error.
extern "C" int bvh_intersect_blocks_per_sm(int any_hit, int threads) {
  return any_hit ? blocks_per_sm<true>(threads) : blocks_per_sm<false>(threads);
}
