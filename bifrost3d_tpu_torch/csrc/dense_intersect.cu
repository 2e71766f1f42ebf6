// Dense Möller–Trumbore nearest hit, culled by chunk, for Hopper (sm_90a).
//
// Replaces the TPU kernel bifrost3d_tpu/geometry/pallas_intersect.py
// ::_intersect_kernel (driven by pallas_intersect, packing in
// pack_triangles). It computes what that kernel computes — for every ray the
// nearest triangle hit (t, prim, u, v) in (t_min, t_max), the validity test
// of _mt_block (|det| > 1e-9, u >= 0, v >= 0, u + v <= 1, t > t_min,
// t < t_max), the lowest index winning a tie, a ray at an index >= the live
// count reporting a miss — and not by the TPU kernel's full (R, T) scan:
//
//   - one thread holds each ray and its best hit; the trace is
//     csrc/dense_trace.cuh's, which the mesh megakernel's dense branch
//     shares: triangles are 48-byte records (an AoS copy of the packed
//     table's rows 0-11, made and cached by the wrapper), culled by one
//     padded box per 32 triangles and one per 512 (the union of 16 chunk
//     boxes), visited in index order, each test rejected by its numerators
//     before the reciprocal; its answer is the full scan's bit for bit (the
//     header says why). The boxes are built once per table by the header's
//     build_boxes_kernel. Inside a tile a warp whose rays enter different
//     chunks traces them one at a time, a lane per triangle, and a warp of
//     coherent rays a thread per ray (trace_span_warp chooses from the
//     chunks they enter): with a thread per ray always, the slowest ray of a
//     block set the block's time on incoherent rays;
//   - the kernel reads the rays as the wavefront holds them (origin and
//     direction [r, 3]; t_min and t_max each a value, one device value or one
//     per ray; the live count a value or one int32 / int64 on the device, so
//     a pool's live sum costs no host sync) and writes the final hit — t =
//     +inf, prim = -1, u = v = 0 on a miss — into one [4, r] allocation.
//
// Closest hit only, as the TPU kernel: shadow queries take the closest hit
// and read prim >= 0. An any-hit instantiation that stopped at a ray's
// first hit was measured no faster on bounded rays (PERF.md §6).
//
// The trace is fed tiles: a block streams the table in 512-triangle tiles
// (24 KiB of records and the tile's 16 chunk boxes) through a cp.async
// double buffer, skips a tile that none of its rays enters (a block vote
// over the tile's group box, with each ray's best hit so far), and loads
// the next entered tile while the current one is tested. Staging every
// chunk and group box in shared memory and reading the entered chunks'
// records from L2 instead was measured 12-47% slower on five of six tables
// and ray sets on an NVIDIA H100 80GB HBM3 at 700 W, and 11% faster on the
// sixth (PERF.md).
//
// What bounds it on an H100: the triangle tests, ~50 flops each, and the box
// tests, ~24 flops each, of the chunks a ray enters; at Cornell's 34
// triangles the launch and the ray I/O (24 B in, 16 B out per ray).
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
using dense_trace::kGroupTris;
using dense_trace::Live;

constexpr int kThreads = 256;  // the largest block the kernel is built for

__device__ __forceinline__ void write_hit(float* __restrict__ out, int n_rays, int i, int prim,
                                          float t, float u, float v) {
  const bool miss = prim < 0;
  out[i] = miss ? __int_as_float(0x7f800000) : t;  // +inf on a miss
  out[n_rays + i] = __int_as_float(prim);
  out[2 * n_rays + i] = miss ? 0.0f : u;
  out[3 * n_rays + i] = miss ? 0.0f : v;
}

__device__ __forceinline__ float3 load3(const float* __restrict__ p, int i) {
  return make_float3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}

__device__ __forceinline__ float3 inverse(float3 d) {
  return make_float3(dense_trace::safe_inv(d.x), dense_trace::safe_inv(d.y),
                     dense_trace::safe_inv(d.z));
}

__global__ void __launch_bounds__(kThreads)
dense_intersect_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                       int n_rays, Bound t_min, Bound t_max, Live live,
                       const float4* __restrict__ recs, const float4* __restrict__ boxes,
                       const float4* __restrict__ groups, int n_tris, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  constexpr int kTile = 3 * kGroupTris + 2 * kGroupChunks;  // float4 per buffer
  const int n_chunks = (n_tris + kChunk - 1) / kChunk;
  const int n_groups = (n_chunks + kGroupChunks - 1) / kGroupChunks;
  float4* s_group = smem;                     // [n_groups, 2]
  float4* s_buf = smem + 2 * n_groups;        // [2][kTile]
  const int n_live = live.get(n_rays);
  const int first = blockIdx.x * blockDim.x;
  if (first >= n_rays) return;
  const int i = first + threadIdx.x;
  const bool searching = i < n_live;
  float3 o = make_float3(0.0f, 0.0f, 0.0f), d = o, inv = o;
  float lo = 0.0f, best_t = 0.0f, best_u = 0.0f, best_v = 0.0f;
  int best = -1;
  if (searching) {
    o = load3(origin, i);
    d = load3(direction, i);
    inv = inverse(d);
    lo = t_min.at(i);
    best_t = fminf(t_max.at(i), kBig);
  }
  if (first < n_live) {  // uniform across the block
    dense_trace::copy_async(s_group, groups, 2 * n_groups);
    dense_trace::commit_async();
    dense_trace::wait_async<0>();
    __syncthreads();
    auto enters = [&](int g) {
      return searching && dense_trace::chunk_hit(s_group, g, o, inv, lo, best_t);
    };
    auto load = [&](int g, float4* buf) {
      const int base = g * kGroupTris;
      const int count = min(kGroupTris, n_tris - base);
      const int chunks = (count + kChunk - 1) / kChunk;
      dense_trace::copy_async(buf, recs + 3 * base, 3 * count);
      dense_trace::copy_async(buf + 3 * kGroupTris, boxes + 2 * g * kGroupChunks, 2 * chunks);
      dense_trace::commit_async();
    };
    int g = 0;
    while (g < n_groups && !__syncthreads_or(enters(g))) ++g;
    if (g < n_groups) load(g, s_buf);
    for (int cur = 0; g < n_groups; cur ^= 1) {
      // The next tile some ray enters with its best hit so far; a ray's best
      // only falls, so no tile before it can be entered after this one.
      int next = g + 1;
      while (next < n_groups && !__syncthreads_or(enters(next))) ++next;
      if (next < n_groups) {
        load(next, s_buf + (cur ^ 1) * kTile);
        dense_trace::wait_async<1>();
      } else {
        dense_trace::wait_async<0>();
      }
      __syncthreads();
      const float4* buf = s_buf + cur * kTile;
      const int base = g * kGroupTris;
      dense_trace::trace_span_warp(buf, buf + 3 * kGroupTris, min(kGroupTris, n_tris - base),
                                   base, enters(g), o, d, inv, lo, best_t, best_u, best_v, best);
      __syncthreads();  // the buffer is refilled in the next round
      g = next;
    }
  }
  if (i < n_rays) write_hit(out, n_rays, i, best, best_t, best_u, best_v);
}

}  // namespace

// The chunk and group boxes of a table: tris [n_tris, 12] float32 records →
// boxes [ceil(n_tris / 32), 8], groups [ceil(n_tris / 512), 8] float32 (lo.xyz
// 0 hi.xyz 0). Launches on `stream`; returns cudaGetLastError().
extern "C" int dense_intersect_boxes(const float* tris, int n_tris, float* boxes, float* groups,
                                     void* stream) {
  return dense_trace::build_boxes(reinterpret_cast<const float4*>(tris), n_tris,
                                  reinterpret_cast<float4*>(boxes),
                                  reinterpret_cast<float4*>(groups),
                                  static_cast<cudaStream_t>(stream));
}

// origin, direction: [n_rays, 3] float32. t_min / t_max: the value, or a
// device pointer (stride 0: one value, stride 1: one per ray). The live count:
// n_live, or one device integer of live_bits 32 or 64 (null: n_live). tris,
// boxes, groups: as dense_intersect_boxes. out: [4 * n_rays] float32: t, prim
// (int32 bits), u, v. Launches on `stream`; returns the first CUDA error
// (0 = launched).
extern "C" int dense_intersect(const float* origin, const float* direction, int n_rays,
                               float t_min, const float* t_min_ptr, int t_min_stride, float t_max,
                               const float* t_max_ptr, int t_max_stride, int n_live,
                               const void* live_ptr, int live_bits, const float* tris, int n_tris,
                               const float* boxes, const float* groups, float* out, int threads,
                               void* stream) {
  if (n_rays <= 0) return 0;
  const Bound lo = {t_min, t_min_ptr, t_min_stride};
  const Bound hi = {t_max, t_max_ptr, t_max_stride};
  const Live live = {n_live, live_bits == 32 ? static_cast<const int*>(live_ptr) : nullptr,
                     live_bits == 64 ? static_cast<const long long*>(live_ptr) : nullptr};
  const int n_groups = ((n_tris + kChunk - 1) / kChunk + kGroupChunks - 1) / kGroupChunks;
  const size_t smem = sizeof(float4) * (2 * n_groups + 2 * (3 * kGroupTris + 2 * kGroupChunks));
  // The two tiles take 49 KiB: above 48 KB a kernel's dynamic shared memory
  // needs the opt-in. A refused opt-in, or a `threads` above
  // __launch_bounds__, comes back as its error.
  const cudaError_t e = cudaFuncSetAttribute(
      dense_intersect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (n_rays + threads - 1) / threads;
  dense_intersect_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      origin, direction, n_rays, lo, hi, live, reinterpret_cast<const float4*>(tris),
      reinterpret_cast<const float4*>(boxes), reinterpret_cast<const float4*>(groups), n_tris,
      out);
  return static_cast<int>(cudaGetLastError());
}
