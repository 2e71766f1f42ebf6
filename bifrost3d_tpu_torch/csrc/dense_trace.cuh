// The chunk-culled dense Möller–Trumbore trace, shared by
// csrc/mesh_megakernel.cu (the dense branch of the megakernel, B2),
// csrc/dense_intersect.cu (the wavefront's dense trace, B1),
// csrc/clustered_intersect.cu (the cluster scan, B6) and
// csrc/vmem_intersect.cu (the resident-cluster walk's leaves, B7). The
// library cache hashes this header with each source that includes it.
//
// Layout. One 48-byte record per triangle, three float4: q0 = v0.xyz e1.x,
// q1 = e1.yz e2.xy, q2 = e2.z and padding. One padded box per chunk of
// kChunk consecutive triangles, two float4 (lo.xyz, hi.xyz). Above the
// chunks, optionally, one box per group of kGroupChunks chunks: the union
// of the group's padded chunk boxes.
//
// The trace visits the chunks in index order, skips a chunk whose box the
// ray misses or enters no nearer than its best hit so far, and tests every
// triangle of a chunk it enters with a strict '<' against that best; one
// thread runs it for its ray (trace_span, the megakernel's), or, where a
// warp's rays enter different chunks, the warp for each of its rays in
// turn, a lane per triangle (trace_span_warp, the dense kernel's, the
// cluster scan's and the walk's). For t_min >= 0, as every caller's, its
// answer is the full scan's (every triangle tested, inv_det =
// __fdiv_rn(1, det)) bit for bit, for these reasons:
//
//   - A skipped chunk holds no triangle the full scan would take. A hit at t
//     in (t_min, best) lies on the triangle, up to the rounding of t, u and
//     v, and so inside the unpadded box. The box is padded by kChunkPad
//     times its largest coordinate and extent, far above that rounding and
//     above the rounding of the slab test, so the ray is inside the padded
//     box on both sides of that point: t_near <= t < best. Chunks run in
//     index order and the comparison is strict, so among equal t the lowest
//     index still wins.
//   - A group box contains each of its chunk boxes, and the slab test is
//     monotone in the box: each of (lo - o) * inv and (hi - o) * inv is a
//     correctly rounded, so monotone, function of the corner. A ray that
//     enters a chunk's box before t_lim enters its group's box before t_lim
//     too, so skipping a group skips only chunks the ray would skip.
//   - mt_hit computes the numerators first and rejects a test that they show
//     to fail, with margins (1e-5 relative, 1e-30 absolute) far above their
//     rounding; a survivor takes the correctly rounded reciprocal
//     __frcp_rn(det), which equals __fdiv_rn(1, det), and multiplies by it as
//     the full scan does: t, u, v are the full scan's bit for bit. Keep its
//     expressions as they are: nvcc contracts products into FMAs, and the
//     equality is shown on the card (chip_smoke.py's trace probe) for this
//     exact code.

#pragma once

#include <cuda_runtime.h>

namespace dense_trace {

constexpr int kChunk = 32;
// Box padding, relative to the chunk's largest coordinate and extent: far
// above the rounding of the slab test and of a hit's t, so the cull never
// drops a triangle the full scan would take.
constexpr float kChunkPad = 1e-4f;
// Chunks per group box, and triangles per group (the tile of a streamed
// trace, the cluster of the cluster scan).
constexpr int kGroupChunks = 16;
constexpr int kGroupTris = kGroupChunks * kChunk;
constexpr float kBig = 3.0e38f;
constexpr float kEpsDet = 1e-9f;

__device__ __forceinline__ float safe_inv(float x) {
  return __fdiv_rn(x < 0.0f ? -1.0f : 1.0f, fmaxf(fabsf(x), 1e-12f));
}

// Slab test of box `c` (two float4: lo.xyz, hi.xyz) → whether the ray enters
// it in [t_min, t_far] before t_lim. Vec is any struct of x, y, z floats.
template <class Vec>
__device__ __forceinline__ bool chunk_hit(const float4* __restrict__ s_box, int c, Vec o, Vec inv,
                                          float t_min, float t_lim) {
  const float4 a = s_box[2 * c], b = s_box[2 * c + 1];
  const float x0 = (a.x - o.x) * inv.x, x1 = (b.x - o.x) * inv.x;
  const float y0 = (a.y - o.y) * inv.y, y1 = (b.y - o.y) * inv.y;
  const float z0 = (a.z - o.z) * inv.z, z1 = (b.z - o.z) * inv.z;
  const float t_near = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fmaxf(fminf(z0, z1), t_min));
  const float t_far = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  return t_near <= t_far && t_near < t_lim;
}

// Möller–Trumbore with the full scan's arithmetic → a valid hit in
// (t_min, t_lim): |det| > 1e-9, u >= 0, v >= 0, u + v <= 1.
template <class Vec>
__device__ __forceinline__ bool mt_hit(const float4* __restrict__ rec, Vec o, Vec d, float t_min,
                                       float t_lim, float& t, float& u, float& v) {
  const float4 q0 = rec[0], q1 = rec[1], q2 = rec[2];
  const float v0x = q0.x, v0y = q0.y, v0z = q0.z;
  const float e1x = q0.w, e1y = q1.x, e1z = q1.y;
  const float e2x = q1.z, e2y = q1.w, e2z = q2.x;
  // pvec = d x e2
  const float px = d.y * e2z - d.z * e2y;
  const float py = d.z * e2x - d.x * e2z;
  const float pz = d.x * e2y - d.y * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  // tvec = o - v0
  const float tx = o.x - v0x, ty = o.y - v0y, tz = o.z - v0z;
  const float u_num = tx * px + ty * py + tz * pz;
  // qvec = tvec x e1
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v_num = d.x * qx + d.y * qy + d.z * qz;
  const float t_num = e2x * qx + e2y * qy + e2z * qz;
  const float ad = fabsf(det);
  const float sg = det < 0.0f ? -1.0f : 1.0f;
  const float us = u_num * sg, vs = v_num * sg, ts = t_num * sg;
  const float tiny = ad * 1e-30f;
  if (!(ad > kEpsDet) || us < -tiny || vs < -tiny || us + vs > ad * 1.00001f ||
      ts < t_min * ad * 0.99999f || ts > t_lim * ad * 1.00001f)
    return false;
  const float inv_det = __frcp_rn(det);
  u = u_num * inv_det;
  v = v_num * inv_det;
  t = t_num * inv_det;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min && t < t_lim;
}

// Chunk c of the n triangles at tri4 (chunk boxes at box), if the ray
// enters its box before its best hit: every triangle tested with a strict
// '<' against the running best (best_t is the bound); a hit sets best =
// base + its index → whether kAnyHit's trace is done (a hit found).
template <bool kAnyHit, class Vec>
__device__ __forceinline__ bool trace_chunk(const float4* __restrict__ tri4,
                                            const float4* __restrict__ box, int n, int base, int c,
                                            Vec o, Vec d, Vec inv, float t_min, float& best_t,
                                            float& best_u, float& best_v, int& best) {
  if (!chunk_hit(box, c, o, inv, t_min, best_t)) return false;
  const int end = min(n, (c + 1) * kChunk);
  for (int k = c * kChunk; k < end; ++k) {
    float t, u, v;
    if (mt_hit(tri4 + 3 * k, o, d, t_min, best_t, t, u, v)) {
      best_t = t;
      best_u = u;
      best_v = v;
      best = base + k;
      if (kAnyHit) return true;
    }
  }
  return false;
}

// The chunk-culled trace of the n triangles at tri4, every chunk in index
// order, merged into the running best. With kAnyHit it stops at the first
// hit.
template <bool kAnyHit, class Vec>
__device__ __forceinline__ void trace_span(const float4* __restrict__ tri4,
                                           const float4* __restrict__ box, int n, int base, Vec o,
                                           Vec d, Vec inv, float t_min, float& best_t,
                                           float& best_u, float& best_v, int& best) {
  const int n_chunks = (n + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c)
    if (trace_chunk<kAnyHit>(tri4, box, n, base, c, o, d, inv, t_min, best_t, best_u, best_v,
                             best))
      return;
}

// A warp takes its rays one at a time (below) when their chunk entries
// number fewer than kWarpShare per distinct chunk the warp enters: with a
// thread per ray the warp runs 32 triangle tests for each distinct chunk,
// with the warp on one ray a test, the argmin and the broadcasts for each
// entry. 8 is a measured trade-off, not the best everywhere:
// chip_warp_share.py times 0, 4, 8, 16, 32 and a warp per ray always on the
// dense trace's, the cluster scan's and the resident-cluster walk's
// workloads (PERF.md §6; the walk's camera rays run fastest at 16).
constexpr int kWarpShare = 8;

// trace_span (closest hit) for the rays of a warp's lanes with `active` set,
// over a span of at most 32 chunks (n <= 1024 triangles), in one of two
// ways chosen from the chunks the rays enter with their best hits now (a
// superset of those they will test). Coherent rays, which enter the same
// chunks, take a thread per ray: the warp walks the chunks some ray enters,
// in index order, and each thread runs trace_chunk on those its own ray
// enters. Otherwise the warp takes its rays one at a time: for each chunk
// the ray enters, in index order and still in its box with the ray's best
// hit so far, lane k tests the chunk's triangle k, and a warp argmin of (t,
// index) among the valid tests keeps the lowest index of the least t, which
// is what a strict '<' in index order keeps; no lane then waits for another
// ray's long run of tests. Either way the answer is trace_span's. Every lane
// of the warp must call it.
__device__ __forceinline__ void trace_span_warp(const float4* __restrict__ tri4,
                                                const float4* __restrict__ box, int n, int base,
                                                bool active, float3 o, float3 d, float3 inv,
                                                float t_min, float& best_t, float& best_u,
                                                float& best_v, int& best) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int n_chunks = (n + kChunk - 1) / kChunk;
  unsigned mine = 0;
  if (active) {
    for (int c = 0; c < n_chunks; ++c)
      if (chunk_hit(box, c, o, inv, t_min, best_t)) mine |= 1u << c;
  }
  unsigned any = mine;
  int entries = __popc(mine);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    any |= __shfl_xor_sync(kAll, any, off);
    entries += __shfl_xor_sync(kAll, entries, off);
  }
  if (entries >= kWarpShare * __popc(any)) {
    // A thread per ray, the warp's lanes on one chunk at a time.
    for (unsigned m = any; m; m &= m - 1) {
      const int c = __ffs(m) - 1;
      if ((mine >> c) & 1u)
        trace_chunk<false>(tri4, box, n, base, c, o, d, inv, t_min, best_t, best_u, best_v, best);
    }
    return;
  }
  // The warp on one ray at a time.
  for (unsigned todo = __ballot_sync(kAll, mine != 0); todo; todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const float3 ro = make_float3(__shfl_sync(kAll, o.x, src), __shfl_sync(kAll, o.y, src),
                                  __shfl_sync(kAll, o.z, src));
    const float3 rd = make_float3(__shfl_sync(kAll, d.x, src), __shfl_sync(kAll, d.y, src),
                                  __shfl_sync(kAll, d.z, src));
    const float3 ri = make_float3(__shfl_sync(kAll, inv.x, src), __shfl_sync(kAll, inv.y, src),
                                  __shfl_sync(kAll, inv.z, src));
    const float lo = __shfl_sync(kAll, t_min, src);
    float rt = __shfl_sync(kAll, best_t, src), ru = 0.0f, rv = 0.0f;
    int hit = -1;
    for (unsigned chunks = __shfl_sync(kAll, mine, src); chunks; chunks &= chunks - 1) {
      const int c = __ffs(chunks) - 1;
      if (!chunk_hit(box, c, ro, ri, lo, rt)) continue;  // the same on every lane
      const int k = c * kChunk + lane;
      float t = kBig, u = 0.0f, v = 0.0f;
      const bool ok = k < n && mt_hit(tri4 + 3 * k, ro, rd, lo, rt, t, u, v);
      const unsigned hits = __ballot_sync(kAll, ok);
      if (!hits) continue;
      float bt = ok ? t : kBig;  // a valid t is below rt <= kBig
      int win = lane;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(kAll, bt, off);
        const int ol = __shfl_xor_sync(kAll, win, off);
        if (ot < bt || (ot == bt && ol < win)) {
          bt = ot;
          win = ol;
        }
      }
      rt = __shfl_sync(kAll, t, win);
      ru = __shfl_sync(kAll, u, win);
      rv = __shfl_sync(kAll, v, win);
      hit = c * kChunk + win;
    }
    if (lane == src && hit >= 0) {
      best_t = rt;
      best_u = ru;
      best_v = rv;
      best = base + hit;
    }
  }
}

// Closest hit in (t_min, t_max) over n_tris records → its triangle, or -1
// (best_t = t_max); with kAnyHit the first hit found.
template <bool kAnyHit, class Vec>
__device__ int trace_dense(const float4* __restrict__ s_tri4, const float4* __restrict__ s_box,
                           int n_tris, Vec o, Vec d, float t_min, float t_max, float& best_t,
                           float& best_u, float& best_v) {
  const Vec inv = {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)};
  best_t = t_max;
  best_u = 0.0f;
  best_v = 0.0f;
  int best = -1;
  trace_span<kAnyHit>(s_tri4, s_box, n_tris, 0, o, d, inv, t_min, best_t, best_u, best_v, best);
  return best;
}

// One warp builds the padded box of chunk c of the n_tris records at tri4:
// lane k reads triangle c * kChunk + k, min and max go through shuffles, and
// lane 0 writes the box to out[0] (lo) and out[1] (hi).
__device__ __forceinline__ void build_chunk_box(const float4* __restrict__ tri4, int n_tris, int c,
                                                int lane, float4* out) {
  const int k = c * kChunk + lane;
  float lo[3] = {kBig, kBig, kBig}, hi[3] = {-kBig, -kBig, -kBig};
  if (k < n_tris) {
    const float4 q0 = tri4[3 * k], q1 = tri4[3 * k + 1], q2 = tri4[3 * k + 2];
    const float v0[3] = {q0.x, q0.y, q0.z};
    const float v1[3] = {q0.x + q0.w, q0.y + q1.x, q0.z + q1.y};
    const float v2[3] = {q0.x + q1.z, q0.y + q1.w, q0.z + q2.x};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(fminf(v0[a], v1[a]), v2[a]);
      hi[a] = fmaxf(fmaxf(v0[a], v1[a]), v2[a]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
    }
  }
  if (lane == 0) {
    const float ext = fmaxf(fmaxf(hi[0] - lo[0], hi[1] - lo[1]), hi[2] - lo[2]);
    float mag = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) mag = fmaxf(mag, fmaxf(fabsf(lo[a]), fabsf(hi[a])));
    const float pad = kChunkPad * (mag + ext);
    out[0] = make_float4(lo[0] - pad, lo[1] - pad, lo[2] - pad, 0.0f);
    out[1] = make_float4(hi[0] + pad, hi[1] + pad, hi[2] + pad, 0.0f);
  }
}

// The boxes of a table in device memory: one block of kGroupChunks warps
// per group builds the group's chunk boxes → box [n_chunks, 2] and their
// union → group [n_groups, 2] (n_chunks = ceil(n_tris / kChunk), n_groups =
// ceil(n_chunks / kGroupChunks)). A template, like build_boxes, only so
// that a source which does not launch it does not compile it.
template <int kChunks = kGroupChunks>
__global__ void __launch_bounds__(kChunks * 32)
build_boxes_kernel(const float4* __restrict__ tri4, int n_tris, float4* __restrict__ box,
                   float4* __restrict__ group) {
  __shared__ float4 s_box[2 * kChunks];
  const int n_chunks = (n_tris + kChunk - 1) / kChunk;
  const int first = blockIdx.x * kChunks;
  const int w = threadIdx.x >> 5;
  if (first + w < n_chunks) build_chunk_box(tri4, n_tris, first + w, threadIdx.x & 31, s_box + 2 * w);
  __syncthreads();
  const int count = min(kChunks, n_chunks - first);
  if (threadIdx.x < 2 * count) box[2 * first + threadIdx.x] = s_box[threadIdx.x];
  if (threadIdx.x == 0) {
    float4 lo = s_box[0], hi = s_box[1];
    for (int c = 1; c < count; ++c) {
      const float4 a = s_box[2 * c], b = s_box[2 * c + 1];
      lo = make_float4(fminf(lo.x, a.x), fminf(lo.y, a.y), fminf(lo.z, a.z), 0.0f);
      hi = make_float4(fmaxf(hi.x, b.x), fmaxf(hi.y, b.y), fmaxf(hi.z, b.z), 0.0f);
    }
    group[2 * blockIdx.x] = lo;
    group[2 * blockIdx.x + 1] = hi;
  }
}

// Launches build_boxes_kernel on `s`; returns cudaGetLastError().
template <int kChunks = kGroupChunks>
int build_boxes(const float4* tri4, int n_tris, float4* box, float4* group, cudaStream_t s) {
  if (n_tris <= 0) return 0;
  const int n_groups = ((n_tris + kChunk - 1) / kChunk + kChunks - 1) / kChunks;
  build_boxes_kernel<kChunks><<<n_groups, kChunks * 32, 0, s>>>(tri4, n_tris, box, group);
  return static_cast<int>(cudaGetLastError());
}

// Copies `n` float4 from src to dst (shared) with cp.async, 16 bytes a
// thread and step; the caller commits and waits.
__device__ __forceinline__ void copy_async(float4* dst, const float4* __restrict__ src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst + k));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src + k));
  }
}

__device__ __forceinline__ void commit_async() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most `kPending` of this thread's committed copies are in
// flight.
template <int kPending>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// -- a trace kernel's ray inputs ---------------------------------------------

// A t bound: a value, one device value (stride 0) or one per ray (stride 1).
struct Bound {
  float value;  // used when ptr is null
  const float* ptr;
  int stride;
  __device__ __forceinline__ float at(int i) const { return ptr ? ptr[i * stride] : value; }
};

// The live count: a value, or one int32 / int64 on the device (read by the
// kernel, so a pool's live sum costs the host no sync) → clamped to
// [0, n_rays].
struct Live {
  int value;
  const int* ptr32;
  const long long* ptr64;
  __device__ __forceinline__ int get(int n_rays) const {
    long long n = value;
    if (ptr32) n = *ptr32;
    if (ptr64) n = *ptr64;
    return static_cast<int>(min(max(n, 0LL), static_cast<long long>(n_rays)));
  }
};

}  // namespace dense_trace
