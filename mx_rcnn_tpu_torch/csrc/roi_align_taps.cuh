// Bilinear sample taps and float4 arithmetic shared by the ROIAlign kernels
// (roi_align.cu: kernels 2 and 3; roi_align_stream.cu: kernels 4 and 5), so
// every kernel puts its samples at bit-identical positions.
//
// A roi edge c1 (scaled to the map) and a bin size give sample k of an axis
// at c1 + (k + 0.5) / s * bin, clamped to [0, lim - 1]; its lower tap is the
// floor and its upper tap min(lo + 1, lim - 1), weighted by the fraction.
#pragma once

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

}  // namespace
