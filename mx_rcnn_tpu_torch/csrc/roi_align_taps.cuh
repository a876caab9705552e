// Bilinear sample taps, the two tap rules and float4 arithmetic shared by
// the ROIAlign kernels (roi_align.cu: kernels 2 and 3; roi_align_stream.cu:
// kernels 4 and 5; the forward template roi_align_fwd.cuh and the backward's
// roi_align_table.cuh), so every kernel puts its samples at bit-identical
// positions.
//
// A roi edge c1 (scaled to the map) and a bin size give sample k of an axis
// at c1 + (k + 0.5) / s * bin, clamped to [0, lim - 1]; its lower tap is the
// floor and its upper tap min(lo + 1, lim - 1), weighted by the fraction.
//
// Features and cotangents come in float32 or bfloat16 (the compute dtype),
// four channels a lane: a float4 (16 bytes) or a uint2 holding four bf16
// (8 bytes), widened to a float4 as they are loaded (exact: a bf16 is the
// top half of a float32), so every sum is taken in float32; a bf16 output
// rounds the float32 value once, to nearest even, as it is stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Tap {
  int lo, hi;
  float w_lo, w_hi;
};

__device__ __forceinline__ Tap sample_tap(float c1, float bin, int k, int s,
                                          float lim_f, int lim_i, int size) {
  float g = c1 + ((float)k + 0.5f) / (float)s * bin;
  g = fminf(fmaxf(g, 0.0f), lim_f - 1.0f);
  const float lo_f = floorf(g);
  Tap t;
  t.lo = (int)lo_f;
  t.hi = min(t.lo + 1, lim_i - 1);
  t.w_hi = g - lo_f;
  t.w_lo = 1.0f - t.w_hi;
  // never touch a cell outside the map, whatever valid_hw says
  t.lo = max(0, min(t.lo, size - 1));
  t.hi = max(0, min(t.hi, size - 1));
  return t;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 scale4(float4 a, float k) {
  return make_float4(a.x * k, a.y * k, a.z * k, a.w * k);
}

__device__ __forceinline__ float4 lerp4(float4 a, float wa, float4 b, float wb) {
  return make_float4(a.x * wa + b.x * wb, a.y * wa + b.y * wb,
                     a.z * wa + b.z * wb, a.w * wa + b.w * wb);
}

constexpr int kLanes = 32;  // 4-channel lanes: one warp spans 128 channels

// Four channels of the element type: float4 (float32) or uint2 (bfloat16).
__device__ __forceinline__ float4 load4(const float4* p) { return *p; }

__device__ __forceinline__ float4 load4(const uint2* p) {
  const uint2 u = *p;
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Streaming stores (st.global.cs) of four channels.
__device__ __forceinline__ void store4_cs(float4* p, float4 v) { __stcs(p, v); }

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

__device__ __forceinline__ void store4_cs(uint2* p, float4 v) {
  __stcs(p, make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                       bf16_bits(v.z) | (bf16_bits(v.w) << 16)));
}

struct Roi {
  float x1, y1, x2, y2;
};

__device__ __forceinline__ Roi scaled_roi(const float* __restrict__ rois, int b,
                                          int r, int r_count, float scale) {
  const float* roi = rois + ((size_t)b * r_count + r) * 4;
  return Roi{roi[0] * scale, roi[1] * scale, roi[2] * scale, roi[3] * scale};
}

// The clamp limits of image b: the canvas (valid_hw == NULL) or
// min(ceil(valid * scale), extent), the gather path's _feat_limits.
__device__ __forceinline__ void tap_limits(const float* __restrict__ valid_hw, int b,
                                           float scale, int h, int w, float* lim_hf,
                                           float* lim_wf) {
  *lim_hf = (float)h;
  *lim_wf = (float)w;
  if (valid_hw != nullptr) {
    *lim_hf = fminf(ceilf(valid_hw[b * 2 + 0] * scale), (float)h);
    *lim_wf = fminf(ceilf(valid_hw[b * 2 + 1] * scale), (float)w);
  }
}

// The roi's x taps xt[pw * s] and y taps yt[ph * s], into shared memory
// (the caller syncs); samples clamp to [0, lim - 1].
__device__ __forceinline__ void roi_taps(const Roi& q, float lim_hf, float lim_wf, int h,
                                         int w, int ph_count, int pw_count, int s, Tap* xt,
                                         Tap* yt, int tid, int nthreads) {
  const float bin_w = fmaxf(q.x2 - q.x1, 1.0f) / (float)pw_count;
  const float bin_h = fmaxf(q.y2 - q.y1, 1.0f) / (float)ph_count;
  const int nx = pw_count * s, ny = ph_count * s;
  for (int t = tid; t < nx + ny; t += nthreads) {
    if (t < nx) {
      xt[t] = sample_tap(q.x1, bin_w, t, s, lim_wf, (int)lim_wf, w);
    } else {
      yt[t - nx] = sample_tap(q.y1, bin_h, t - nx, s, lim_hf, (int)lim_hf, h);
    }
  }
}

// The tap rules, as types, so that a profile names the kernel of each rule.
// Kernels 4 and 5's: canvas clamp, an inverted roi (scaled x2 < x1) pools to
// zeros and adds nothing.
struct StreamTaps {
  static constexpr bool kResident = false;
};
// Kernels 2 and 3's: the valid_hw clamp when given, every roi taps (width
// and height floored at 1).
struct ResidentTaps {
  static constexpr bool kResident = true;
};

// Shared memory above the default 48 KB must be opted into per kernel.
template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace
