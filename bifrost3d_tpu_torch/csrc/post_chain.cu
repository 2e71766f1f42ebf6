// The camera-effects chain for Hopper (sm_90a): exposure, vignette,
// tonemap and film grain of post/pipeline.py in two kernels, enqueued
// behind the frames with no host synchronisation.
//
// Replaces no TPU kernel: the JAX package's post chain is plain jnp, which
// XLA fuses. The port's eager version of that chain (post/pipeline.py
// _process_plain, its plain version here) launches about 180 small kernels
// an image and copies six host values to the card, each copy a wait for
// the card to drain, so after a progressive render the card idled while
// the host enqueued the chain one launch at a time (ROADMAP queue D,
// item 4). Here the settings are kernel arguments and nothing is copied.
//
//   exposure_kernel  one pass over the HDR image [h, w, 3] float32: the
//                    luminance of each pixel and, by the exposure mode,
//                    - histogram: its log2 bin of 64, counted in shared
//                      memory (warp-aggregated) and added to 64 global bins
//                      that a memset on the stream zeroed;
//                    - log-average: the sum of log luminance, per block in
//                      double, one partial per block;
//                    the last block to finish (a counter in the same
//                    memset) resolves the target exposure from the bins or
//                    the partials, summed in a fixed order, applies eye
//                    adaptation and writes the 0-d exposure. In the fixed
//                    mode one block only resolves exp2(bias).
//   apply_kernel     one pass that reads the HDR image once and writes the
//                    LDR image once: exposure x vignette falloff, the
//                    tonemapper (linear, filmic, AgX or Khronos neutral, a
//                    uniform mode argument), film grain (pcg2d in uint32),
//                    clamp to [0, 1].
//
// The arithmetic follows the eager chain as PyTorch runs it on the card,
// operation by operation: each eager op rounds to float32, so products and
// sums are written with __fmul_rn / __fadd_rn where nvcc would otherwise
// contract them into FMAs; a division by a Python number is PyTorch's
// multiply by the float32 reciprocal (passed in precomputed), number /
// tensor its reciprocal times the number; the 3 x 3 colour matrices are
// the FMA chain of a float32 GEMM over k = 0, 1, 2; a three-channel sum is
// ((x0 + x2) + x1), the order of PyTorch's reduction kernel (each of the
// three seen to match cuBLAS and torch bit for bit on 2^20 pixels of an
// H100). Sums over the image (the log-average, the histogram's weighted
// average) are taken in double, where the eager chain sums in float32 in
// another order: the exposure agrees to float32 rounding.
//
// What bounds it on an H100: bytes. At 512 x 512 the apply pass reads 3.1
// MB and writes 3.1 MB (1.9 us at 3.35 TB/s); the histogram pass reads the
// 3.1 MB again (0.9 us; it stays in the 50 MB L2 for the apply pass). A
// thread takes four pixels, 48 bytes, as three 16-byte loads and stores
// where the image is 16-byte aligned and the group is whole; the ragged
// end goes a float at a time. The filmic tonemapper's two log10f and two
// expf a channel are about 150 operations a pixel, far under the byte
// bound's share of the card's rate.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: log2f, log10f, expf, exp2f and
// powf are the accurate ones PyTorch's eager CUDA kernels call).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 64;

constexpr int kExposureFixed = 0;
constexpr int kExposureLogAverage = 1;
constexpr int kExposureHistogram = 2;

constexpr int kTonemapFilmic = 1;  // 0, linear, leaves the colour as it is
constexpr int kTonemapAgx = 2;
constexpr int kTonemapKhronos = 3;

constexpr uint32_t kLcgMultiplier = 1664525u;
constexpr uint32_t kLcgIncrement = 1013904223u;
constexpr float kUintNorm = 2.3283064365386963e-10f;  // 2^-32

}  // namespace

// Mirrored field for field by post/post_chain.py (ctypes.Structure).
struct ExposureParams {
  const float* previous_ptr;    // device previous exposure, or null
  const float* delta_time_ptr;  // device frame delta, or null
  int mode;
  int n_pixels;
  int aligned;                  // the image is 16-byte aligned
  int adapt;                    // eye adaptation enabled
  float min_log;                // min_log_luminance
  float log_range;              // max - min
  float inv_log_range;          // float32 1 / (max - min)
  float min_percentage;
  float max_percentage;
  float bias;                   // log_luminance_bias
  float bias_scale;             // float32 2 ** bias
  float previous;               // used where previous_ptr is null
  float delta_time;             // used where delta_time_ptr is null
  float brightness;
  float darkness;
};

struct ApplyParams {
  const float* exposure_ptr;    // the exposure kernel's output, or null
  float exposure;               // used where exposure_ptr is null
  int width;
  int height;
  int n_pixels;
  int aligned;
  int vignette_on;
  float vignette;
  float inv_width;              // float32 1 / width
  float inv_height;
  int tonemap;
  float m_in[9];                // row-major: out_j = sum_k c_k m[j][k]
  float m_out[9];
  float rgb2y[3];
  // filmic
  float toe_match;
  float straight_match;
  float shoulder_match;
  float slope;
  float toe_rate;               // -2 slope / toe_scale
  float toe_numerator;          // 2 toe_scale
  float neg_black_clip;
  float shoulder_rate;          // 2 slope / shoulder_scale
  float shoulder_numerator;     // 2 shoulder_scale
  float white_one;              // 1 + white_clip
  float inv_denom;              // float32 1 / (shoulder_match - toe_match)
  int flip;                     // shoulder_match < toe_match
  // AgX
  float min_ev;
  float inv_ev_range;
  // Khronos neutral
  float start_compression;
  float compression_d;
  float compression_dd;
  float desaturation;
  // film grain
  int grain_on;
  float grain_scale;            // 2 film_grain
  uint32_t grain_x;             // frame_index mod 2^32
  uint32_t grain_y;             // 31 frame_index mod 2^32
};

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
// torch.lerp's eager spelling in math/vec.py: a + (b - a) * t.
__device__ __forceinline__ float lerp(float a, float b, float t) {
  return add(a, mul(sub(b, a), t));
}

// torch.sum(c * w, dim=-1) over three channels as PyTorch's CUDA reduction
// orders it: each product rounded, then ((0 + 2) + 1).
__device__ __forceinline__ float dot3(const float* c, const float* w) {
  return add(add(mul(c[0], w[0]), mul(c[2], w[2])), mul(c[1], w[1]));
}

__device__ __forceinline__ float luminance(const float* c) {
  const float luma[3] = {0.2126f, 0.7152f, 0.0722f};
  return dot3(c, luma);
}

// Row j of a float32 GEMM c @ m^T: the FMA chain over k = 0, 1, 2.
__device__ __forceinline__ void mat3(const float* c, const float* m, float* out) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    out[j] = fmaf(c[2], m[3 * j + 2], fmaf(c[1], m[3 * j + 1], mul(c[0], m[3 * j])));
}

// Four pixels (12 floats) of group g; returns how many pixels are real.
__device__ __forceinline__ int load_group(const float* __restrict__ src, int g, int n,
                                          bool aligned, float* v) {
  const int first = 4 * g;
  const int count = min(4, n - first);
  if (aligned && count == 4) {
    const float4* s = reinterpret_cast<const float4*>(src) + 3 * g;
    const float4 a = __ldg(s), b = __ldg(s + 1), c = __ldg(s + 2);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    v[8] = c.x; v[9] = c.y; v[10] = c.z; v[11] = c.w;
  } else {
#pragma unroll
    for (int i = 0; i < 12; ++i) v[i] = i < 3 * count ? src[3 * first + i] : 0.0f;
  }
  return count;
}

__device__ __forceinline__ void store_group(float* __restrict__ dst, int g, int count,
                                            bool aligned, const float* v) {
  const int first = 4 * g;
  if (aligned && count == 4) {
    float4* d = reinterpret_cast<float4*>(dst) + 3 * g;
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
    d[2] = make_float4(v[8], v[9], v[10], v[11]);
  } else {
#pragma unroll
    for (int i = 0; i < 12; ++i)
      if (i < 3 * count) dst[3 * first + i] = v[i];
  }
}

// A block-wide sum in a fixed order (shuffles, then the warps' sums);
// the total is valid in thread 0. Every thread of the block calls it.
__device__ double block_sum(double v, double* s_warp) {
  __syncthreads();
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < kWarps ? s_warp[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// exposure.histogram_exposure from the 64 counts: the percentile clamp and
// the average over bin centres (one thread).
__device__ __forceinline__ float histogram_target(const int* bins, const ExposureParams& p) {
  float hist[kBins];
  float total = 0.0f;  // integers, exact below 2^24
#pragma unroll
  for (int i = 0; i < kBins; ++i) {
    hist[i] = static_cast<float>(__ldcg(bins + i));
    total = add(total, hist[i]);
  }
  const float lo = mul(total, p.min_percentage);
  const float hi = mul(total, p.max_percentage);
  float before = 0.0f;
  double weighted = 0.0, weight = 0.0;
#pragma unroll
  for (int i = 0; i < kBins; ++i) {
    const float after = add(before, hist[i]);
    const float c = sub(fminf(fmaxf(hi, before), after), fminf(fmaxf(lo, before), after));
    const float centre = mul(add(static_cast<float>(i), 0.5f), 1.0f / kBins);
    const float bin_lum = exp2f(add(mul(centre, p.log_range), p.min_log));
    weighted += static_cast<double>(mul(c, bin_lum));
    weight += static_cast<double>(c);
    before = after;
  }
  const float avg = static_cast<float>(weighted) / fmaxf(static_cast<float>(weight), 1e-6f);
  return mul(__frcp_rn(fmaxf(avg, 1e-6f)), p.bias_scale);
}

// exposure.log_average_exposure from the mean of log luminance.
__device__ __forceinline__ float log_average_target(double mean_log, const ExposureParams& p) {
  const float log_avg = expf(static_cast<float>(mean_log));
  const float key = sub(1.03f, mul(__frcp_rn(add(2.0f, log10f(add(log_avg, 1.0f)))), 2.0f));
  return mul(key / fmaxf(log_avg, 1e-6f), p.bias_scale);
}

// pipeline._process's eye adaptation: lerp toward the target at the
// brightening or darkening rate; a previous exposure < 0 snaps.
__device__ __forceinline__ float adapt(float target, const ExposureParams& p) {
  if (!p.adapt) return target;
  const float previous = p.previous_ptr ? *p.previous_ptr : p.previous;
  const float dt = p.delta_time_ptr ? *p.delta_time_ptr : p.delta_time;
  const float delta = sub(target, previous);
  const float speed = delta > 0.0f ? p.brightness : p.darkness;
  const float factor = sub(1.0f, exp2f(mul(-dt, speed)));
  const float adapted = add(previous, mul(delta, factor));
  return previous >= 0.0f ? adapted : target;
}

__device__ __forceinline__ int histogram_bin(float lum, const ExposureParams& p) {
  const float log_lum = log2f(fmaxf(lum, 1e-10f));
  const float x = mul(mul(sub(log_lum, p.min_log), p.inv_log_range), static_cast<float>(kBins));
  return static_cast<int>(fminf(fmaxf(x, 0.0f), static_cast<float>(kBins - 1)));
}

__global__ void __launch_bounds__(kThreads)
exposure_kernel(const float* __restrict__ hdr, ExposureParams p, int* bins,
                unsigned* counter, double* partials, float* exposure_out) {
  __shared__ int s_bins[kBins];
  __shared__ double s_warp[kWarps];
  __shared__ bool s_last;
  const bool histogram = p.mode == kExposureHistogram;
  double log_sum = 0.0;

  if (p.mode != kExposureFixed) {
    for (int i = threadIdx.x; i < kBins; i += blockDim.x) s_bins[i] = 0;
    __syncthreads();
    const int groups = (p.n_pixels + 3) >> 2;
    const int lane = threadIdx.x & 31;
    for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < groups;
         g += gridDim.x * blockDim.x) {
      float v[12];
      const int count = load_group(hdr, g, p.n_pixels, p.aligned, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float lum = luminance(v + 3 * k);
        if (histogram) {
          const int bin = k < count ? histogram_bin(lum, p) : -1;
          const unsigned peers = __match_any_sync(__activemask(), bin);
          if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&s_bins[bin], __popc(peers));
        } else if (k < count) {
          log_sum += static_cast<double>(logf(fmaxf(lum, 1e-6f)));
        }
      }
    }
    if (histogram) {
      __syncthreads();
      for (int i = threadIdx.x; i < kBins; i += blockDim.x)
        if (s_bins[i] != 0) atomicAdd(bins + i, s_bins[i]);
    } else {
      log_sum = block_sum(log_sum, s_warp);
      if (threadIdx.x == 0) partials[blockIdx.x] = log_sum;
    }
    // The last block to finish sees every block's bins or partial.
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
  }

  float target;
  if (p.mode == kExposureLogAverage) {
    double s = 0.0;
    for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += blockDim.x)
      s += __ldcg(partials + i);
    s = block_sum(s, s_warp);
    if (threadIdx.x != 0) return;
    target = log_average_target(s / static_cast<double>(p.n_pixels), p);
  } else {
    if (threadIdx.x != 0) return;
    target = histogram ? histogram_target(bins, p) : exp2f(p.bias);
  }
  *exposure_out = adapt(target, p);
}

// tonemap.filmic, one channel triple in place.
__device__ __forceinline__ void filmic(float* c, const ApplyParams& p) {
  float w[3], tone[3];
  mat3(c, p.m_in, w);
#pragma unroll
  for (int j = 0; j < 3; ++j) w[j] = fmaxf(w[j], 0.0f);
  const float gray = dot3(w, p.rgb2y);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float working = lerp(gray, w[j], 0.96f);
    const float lc = log10f(fmaxf(working, 1e-10f));
    const float straight = mul(add(lc, p.straight_match), p.slope);
    float toe = add(p.neg_black_clip,
                    mul(__frcp_rn(add(1.0f, expf(mul(sub(lc, p.toe_match), p.toe_rate)))),
                        p.toe_numerator));
    toe = lc < p.toe_match ? toe : straight;
    float shoulder =
        sub(p.white_one,
            mul(__frcp_rn(add(1.0f, expf(mul(sub(lc, p.shoulder_match), p.shoulder_rate)))),
                p.shoulder_numerator));
    shoulder = lc > p.shoulder_match ? shoulder : straight;
    float t = clamp01(mul(sub(lc, p.toe_match), p.inv_denom));
    if (p.flip) t = sub(1.0f, t);
    t = mul(mul(sub(3.0f, mul(2.0f, t)), t), t);
    tone[j] = lerp(toe, shoulder, t);
  }
  const float gray2 = dot3(tone, p.rgb2y);
#pragma unroll
  for (int j = 0; j < 3; ++j) tone[j] = fmaxf(lerp(gray2, tone[j], 0.93f), 0.0f);
  mat3(tone, p.m_out, c);
}

// tonemap.agx.
__device__ __forceinline__ void agx(float* c, const ApplyParams& p) {
  float a[3];
  mat3(c, p.m_in, a);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float x = log2f(fmaxf(a[j], 1e-10f));
    x = clamp01(mul(sub(x, p.min_ev), p.inv_ev_range));
    float y = mul(x, 15.5f);
    y = mul(x, add(y, -40.14f));
    y = mul(x, add(y, 31.96f));
    y = mul(x, add(y, -6.868f));
    y = mul(x, add(y, 0.4298f));
    y = mul(x, add(y, 0.1191f));
    a[j] = add(y, -0.00232f);
  }
  mat3(a, p.m_out, c);
#pragma unroll
  for (int j = 0; j < 3; ++j) c[j] = powf(fmaxf(c[j], 0.0f), 2.2f);
}

// tonemap.khronos_neutral.
__device__ __forceinline__ void khronos(float* c, const ApplyParams& p) {
  const float x = fminf(fminf(c[0], c[1]), c[2]);
  const float offset = x < 0.08f ? sub(x, mul(mul(x, 6.25f), x)) : 0.04f;
  float d[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) d[j] = sub(c[j], offset);
  const float peak = fmaxf(fmaxf(d[0], d[1]), d[2]);
  const float new_peak = sub(1.0f, mul(__frcp_rn(sub(add(peak, p.compression_d),
                                                     p.start_compression)),
                                       p.compression_dd));
  const float g = sub(1.0f, __frcp_rn(add(mul(sub(peak, new_peak), p.desaturation), 1.0f)));
  const float safe_peak = fmaxf(peak, 1e-10f);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float compressed = lerp(mul(d[j], new_peak) / safe_peak, new_peak, g);
    c[j] = peak < p.start_compression ? d[j] : compressed;
  }
}

__device__ __forceinline__ float grain_noise(int x, int y, const ApplyParams& p) {
  uint32_t hx = static_cast<uint32_t>(x) * 9781u + p.grain_x;
  uint32_t hy = static_cast<uint32_t>(y) * 6271u + p.grain_y;
  hx = hx * kLcgMultiplier + kLcgIncrement;
  hy = hy * kLcgMultiplier + kLcgIncrement;
  hx += hy * kLcgMultiplier;
  hy += hx * kLcgMultiplier;
  hx ^= hx >> 16;
  hy ^= hy >> 16;
  hx += hy * kLcgMultiplier;
  hy += hx * kLcgMultiplier;
  hx ^= hx >> 16;
  return sub(mul(__uint2float_rn(hx), kUintNorm), 0.5f);
}

__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ hdr, float* __restrict__ ldr, ApplyParams p) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= ((p.n_pixels + 3) >> 2)) return;
  const float exposure = p.exposure_ptr ? __ldg(p.exposure_ptr) : p.exposure;
  float v[12];
  const int count = load_group(hdr, g, p.n_pixels, p.aligned, v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k >= count) break;
    float* c = v + 3 * k;
    const int pixel = 4 * g + k;
    const int y = pixel / p.width, x = pixel - y * p.width;
#pragma unroll
    for (int j = 0; j < 3; ++j) c[j] = mul(c[j], exposure);
    if (p.vignette_on) {
      const float xs = sub(mul(add(static_cast<float>(x), 0.5f), p.inv_width), 0.5f);
      const float ys = sub(mul(add(static_cast<float>(y), 0.5f), p.inv_height), 0.5f);
      const float r2 = mul(add(mul(xs, xs), mul(ys, ys)), 2.0f);
      const float falloff = clamp01(sub(1.0f, mul(r2, p.vignette)));
#pragma unroll
      for (int j = 0; j < 3; ++j) c[j] = mul(c[j], falloff);
    }
    if (p.tonemap == kTonemapFilmic) {
      filmic(c, p);
    } else if (p.tonemap == kTonemapAgx) {
      agx(c, p);
    } else if (p.tonemap == kTonemapKhronos) {
      khronos(c, p);
    }
    if (p.grain_on) {
      const float noise = mul(grain_noise(x, y, p), p.grain_scale);
#pragma unroll
      for (int j = 0; j < 3; ++j) c[j] = add(c[j], noise);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) c[j] = clamp01(c[j]);
  }
  store_group(ldr, g, count, p.aligned, v);
}

}  // namespace

// Zero the 64 bins and the block counter at the head of `workspace` (65
// int32, then one double per block from double index 33), then launch the
// exposure pass over `blocks` blocks (one block and no memset in the fixed
// mode). Returns the launch's cudaError.
extern "C" int post_exposure(const float* hdr, const ExposureParams* params, void* workspace,
                             float* exposure_out, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* bins = static_cast<int*>(workspace);
  unsigned* counter = reinterpret_cast<unsigned*>(bins + kBins);
  double* partials = static_cast<double*>(workspace) + 33;
  if (params->mode == kExposureFixed) {
    blocks = 1;
  } else {
    const cudaError_t err = cudaMemsetAsync(workspace, 0, (kBins + 1) * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  exposure_kernel<<<blocks, kThreads, 0, s>>>(hdr, *params, bins, counter, partials,
                                               exposure_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int post_apply(const float* hdr, float* ldr, const ApplyParams* params,
                          void* stream) {
  const int groups = (params->n_pixels + 3) / 4;
  apply_kernel<<<(groups + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(hdr, ldr, *params);
  return static_cast<int>(cudaGetLastError());
}
