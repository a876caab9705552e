// The separable ROIAlign forward on float32 NHWC features, shared by kernel
// 2 (roi_align.cu, the resident maps, under ResidentTaps) and kernel 4
// (roi_align_stream.cu, FPN's P2/P3 in the train step, under StreamTaps).
// bf16 features have their own forward, roi_align_fwd_bf16.cuh, which
// computes what an instance of this template on them would, bit for bit.
//
// Contract: feat (B, H, W, C) f32, C % 4 == 0, rois (B, R, 4) f32 image
// coordinates, valid_hw (B, 2) f32 or NULL (read under ResidentTaps only)
// -> out (B, R, PH, PW, C) f32, any PH, PW and sample ratio s >= 1.  The
// element type is a template parameter, V, four channels a lane
// (roi_align_taps.cuh); the launchers instantiate it for float4.  Each bin
// averages s x s bilinear samples at (i + 0.5) / s of the roi scaled to the
// map (roi_align_taps.cuh).  The tap rule is a template parameter:
// ResidentTaps floors the roi's width and height at 1 (an inverted roi taps
// the cells at its clamped x1/y1) and clamps to valid_hw when given;
// StreamTaps clamps to the canvas, and a block whose roi is inverted (scaled
// x2 < x1, or NaN) writes zeros with streaming stores and reads no feature.
// That branch is uniform over the block.  On every other roi the two rules
// give the same bits.
//
// Design.  One block per (roi, 128-channel slice, image) computes the roi's
// taps once into shared memory; after that one barrier each of its 14 warps
// works alone on one output row (every 14th for taller pools), a lane on one
// float4 of channels, so every feature load and output store is a coalesced
// 512-byte access.  A warp walks its row's bins in order, holding in
// registers the y lerps (one per sample row) at the last sample's two
// columns: the samples' columns never move left, so a column is either one
// of those two or new, and a new one costs 2 loads a sample row.  A roi
// narrower than its 2 * s * pw sample columns loads each column once a row
// instead of 4 s^2 loads per output.  The output is written with streaming
// stores (st.global.cs), so it evicts less of the maps from the 50 MB L2.
// The arithmetic and its order are the plain version's: along y at both x
// taps, then along x, then the sum over the samples (sample rows outer),
// divided by s * s; so the kernels agree with it bit for bit where its mean
// sums in that order.
//
// Instances: s = 1..4 are compiled in (roi_align_fwd_kernel<S, Rule, V>; the
// sample rows' state in register arrays); any larger s takes
// roi_align_fwd_any_s_kernel<Rule, V>, the same walk without the column reuse,
// 4 loads a sample, in the same arithmetic order.  No configuration of the
// repository uses s > 4 (ROI_SAMPLE_RATIO is 2).
//
// Bound: the output writes, B*R*PH*PW*C*4 bytes, and the feature
// cells the samples read once, over the card's memory rate.  About 40 flops an output,
// so the f32 rate is never the limit and tensor cores have no role: there is
// no product to give them.  What sets the time is the chain of dependent loads
// of each warp's row, bin after bin, and how evenly the rois' unequal loads
// spread over the SMs.  Tried under StreamTaps and dropped: reusing the
// feature rows that consecutive sample rows share (slower at S = 2, spills at
// S = 3, 4), and splitting a roi's rows over two blocks (faster only on rois
// of very mixed sizes, not on the FPN train step's).  The bounds and the
// measured times are in PERF.md, section 6.
#pragma once

#include <climits>

#include <cuda_runtime.h>

#include "roi_align_taps.cuh"

namespace {

constexpr int kMaxS = 4;       // sample ratios with a compiled-in instance
constexpr int kRowWarps = 14;  // warps on a roi's rows, one output row each

// Under StreamTaps an inverted roi's block writes zeros over its warp's rows
// with streaming stores and reads nothing.
template <typename V>
__device__ __forceinline__ void zero_rows(V* __restrict__ ob, int c4, int warp, int ph_count,
                                          int pw_count) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int ph = warp; ph < ph_count; ph += kRowWarps) {
    for (int pw = 0; pw < pw_count; ++pw) store4_cs(ob + ((size_t)ph * pw_count + pw) * c4, zero);
  }
}

// s = S, the sample rows' state in register arrays.  At most 73 registers,
// so that 28 warps share an SM.
template <int S, typename Rule, typename V>
__global__ void __launch_bounds__(kLanes * kRowWarps, 2)
roi_align_fwd_kernel(const V* __restrict__ feat, const float* __restrict__ rois,
                     const float* __restrict__ valid_hw, int h, int w, int c4, int r_count,
                     int ph_count, int pw_count, float scale, V* __restrict__ out) {
  const int r = blockIdx.x, b = blockIdx.z;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int c = blockIdx.y * kLanes + lane;  // this thread's float4 channel
  extern __shared__ Tap taps[];
  Tap* xt = taps;                 // [pw_count * S]
  Tap* yt = taps + pw_count * S;  // [ph_count * S]
  float lim_hf, lim_wf;
  tap_limits(Rule::kResident ? valid_hw : nullptr, b, scale, h, w, &lim_hf, &lim_wf);
  const Roi q = scaled_roi(rois, b, r, r_count, scale);
  if constexpr (!Rule::kResident) {
    if (!(q.x2 >= q.x1)) {  // the same for the whole block
      if (c < c4) {
        zero_rows(out + ((size_t)b * r_count + r) * ph_count * pw_count * c4 + c, c4, warp,
                  ph_count, pw_count);
      }
      return;
    }
  }
  roi_taps(q, lim_hf, lim_wf, h, w, ph_count, pw_count, S, xt, yt, warp * kLanes + lane,
           kLanes * kRowWarps);
  __syncthreads();
  if (c >= c4) return;  // past the only barrier

  const V* fb = feat + (size_t)b * h * w * c4 + c;
  V* ob = out + ((size_t)b * r_count + r) * ph_count * pw_count * c4 + c;
  const float count = (float)(S * S);
  for (int ph = warp; ph < ph_count; ph += kRowWarps) {
    // the sample rows' feature rows, as float4 offsets into the image
    int row_lo[S], row_hi[S];
    float wy_lo[S], wy_hi[S];
#pragma unroll
    for (int iy = 0; iy < S; ++iy) {
      const Tap ty = yt[ph * S + iy];
      row_lo[iy] = ty.lo * w * c4;
      row_hi[iy] = ty.hi * w * c4;
      wy_lo[iy] = ty.w_lo;
      wy_hi[iy] = ty.w_hi;
    }
    // the y lerps of each sample row at the last sample's two columns
    int col_lo = -1, col_hi = -1;
    float4 at_lo[S], at_hi[S];
    for (int pw = 0; pw < pw_count; ++pw) {
      float4 xl[S][S];  // the x lerp of sample (iy, ix)
#pragma unroll
      for (int ix = 0; ix < S; ++ix) {
        const Tap tx = xt[pw * S + ix];  // the same for every lane: no divergence
        float4 lo[S], hi[S];
        if (tx.lo == col_hi) {
#pragma unroll
          for (int iy = 0; iy < S; ++iy) lo[iy] = at_hi[iy];
        } else if (tx.lo == col_lo) {
#pragma unroll
          for (int iy = 0; iy < S; ++iy) lo[iy] = at_lo[iy];
        } else {
          const int x = tx.lo * c4;
#pragma unroll
          for (int iy = 0; iy < S; ++iy) {
            lo[iy] = lerp4(load4(fb + row_lo[iy] + x), wy_lo[iy], load4(fb + row_hi[iy] + x),
                           wy_hi[iy]);
          }
        }
        if (tx.hi == tx.lo) {
#pragma unroll
          for (int iy = 0; iy < S; ++iy) hi[iy] = lo[iy];
        } else if (tx.hi == col_hi) {
#pragma unroll
          for (int iy = 0; iy < S; ++iy) hi[iy] = at_hi[iy];
        } else {
          const int x = tx.hi * c4;
#pragma unroll
          for (int iy = 0; iy < S; ++iy) {
            hi[iy] = lerp4(load4(fb + row_lo[iy] + x), wy_lo[iy], load4(fb + row_hi[iy] + x),
                           wy_hi[iy]);
          }
        }
        col_lo = tx.lo;
        col_hi = tx.hi;
#pragma unroll
        for (int iy = 0; iy < S; ++iy) {
          at_lo[iy] = lo[iy];
          at_hi[iy] = hi[iy];
          xl[iy][ix] = lerp4(lo[iy], tx.w_lo, hi[iy], tx.w_hi);
        }
      }
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int iy = 0; iy < S; ++iy) {
#pragma unroll
        for (int ix = 0; ix < S; ++ix) acc = add4(acc, xl[iy][ix]);
      }
      store4_cs(ob + ((size_t)ph * pw_count + pw) * c4,
                make_float4(acc.x / count, acc.y / count, acc.z / count, acc.w / count));
    }
  }
}

// Any s (the launchers send s > kMaxS here): the walk of
// roi_align_fwd_kernel without the column reuse: each
// sample's 4 cells loaded, in the same arithmetic order.
template <typename Rule, typename V>
__global__ void __launch_bounds__(kLanes * kRowWarps, 2)
roi_align_fwd_any_s_kernel(const V* __restrict__ feat, const float* __restrict__ rois,
                           const float* __restrict__ valid_hw, int h, int w, int c4,
                           int r_count, int ph_count, int pw_count, int s, float scale,
                           V* __restrict__ out) {
  const int r = blockIdx.x, b = blockIdx.z;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int c = blockIdx.y * kLanes + lane;
  V* ob = out + ((size_t)b * r_count + r) * ph_count * pw_count * c4 + c;
  extern __shared__ Tap taps[];
  Tap* xt = taps;                 // [pw_count * s]
  Tap* yt = taps + pw_count * s;  // [ph_count * s]
  float lim_hf, lim_wf;
  tap_limits(Rule::kResident ? valid_hw : nullptr, b, scale, h, w, &lim_hf, &lim_wf);
  const Roi q = scaled_roi(rois, b, r, r_count, scale);
  if constexpr (!Rule::kResident) {
    if (!(q.x2 >= q.x1)) {
      if (c < c4) zero_rows(ob, c4, warp, ph_count, pw_count);
      return;
    }
  }
  roi_taps(q, lim_hf, lim_wf, h, w, ph_count, pw_count, s, xt, yt, warp * kLanes + lane,
           kLanes * kRowWarps);
  __syncthreads();
  if (c >= c4) return;

  const V* fb = feat + (size_t)b * h * w * c4 + c;
  const float count = (float)(s * s);
  for (int ph = warp; ph < ph_count; ph += kRowWarps) {
    for (int pw = 0; pw < pw_count; ++pw) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int iy = 0; iy < s; ++iy) {
        const Tap ty = yt[ph * s + iy];
        const int row_lo = ty.lo * w * c4, row_hi = ty.hi * w * c4;
        for (int ix = 0; ix < s; ++ix) {
          const Tap tx = xt[pw * s + ix];
          const int x_lo = tx.lo * c4, x_hi = tx.hi * c4;
          const float4 lo = lerp4(load4(fb + row_lo + x_lo), ty.w_lo,
                                  load4(fb + row_hi + x_lo), ty.w_hi);
          const float4 hi = lerp4(load4(fb + row_lo + x_hi), ty.w_lo,
                                  load4(fb + row_hi + x_hi), ty.w_hi);
          acc = add4(acc, lerp4(lo, tx.w_lo, hi, tx.w_hi));
        }
      }
      store4_cs(ob + ((size_t)ph * pw_count + pw) * c4,
                make_float4(acc.x / count, acc.y / count, acc.z / count, acc.w / count));
    }
  }
}

template <int S, typename Rule, typename V>
int launch_fwd_s(const V* feat, const float* rois, const float* valid_hw, int b, int h, int w,
                 int c4, int r, int ph, int pw, float scale, V* out, cudaStream_t stream) {
  auto kernel = roi_align_fwd_kernel<S, Rule, V>;
  const size_t smem = sizeof(Tap) * (size_t)(pw + ph) * S;
  if (const int rc = set_smem(kernel, smem)) return rc;
  const dim3 grid(r, (c4 + kLanes - 1) / kLanes, b);
  kernel<<<grid, dim3(kLanes, kRowWarps), smem, stream>>>(
      feat, rois, valid_hw, h, w, c4, r, ph, pw, scale, out);
  return static_cast<int>(cudaGetLastError());
}

// The forward under the tap rule Rule on `stream` (valid_hw is read under
// ResidentTaps only), on features of the element type V (float4: f32):
// s = 1..kMaxS to its compiled-in instance, larger s to the run-time one.
// Returns a cudaError_t.
template <typename Rule, typename V>
int roi_align_fwd_launch(const void* feat, const float* rois, const float* valid_hw, int b,
                         int h, int w, int c, int r, int ph, int pw, int s, float scale,
                         void* out, cudaStream_t stream) {
  if (s < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || r == 0 || c == 0) return 0;
  const int c4 = c / 4;
  // the kernels address an image's cells with 32-bit offsets
  if ((long long)h * w * c4 > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const V* f4 = static_cast<const V*>(feat);
  V* o4 = static_cast<V*>(out);
#define FWD_S(S)                                                                         \
  case S:                                                                                \
    return launch_fwd_s<S, Rule, V>(f4, rois, valid_hw, b, h, w, c4, r, ph, pw, scale, o4, \
                                    stream);
  switch (s) {
    FWD_S(1)
    FWD_S(2)
    FWD_S(3)
    FWD_S(4)
    default: break;
  }
#undef FWD_S
  static_assert(kMaxS == 4, "roi_align_fwd_launch compiles in s = 1..4");
  auto kernel = roi_align_fwd_any_s_kernel<Rule, V>;
  const size_t smem = sizeof(Tap) * (size_t)(pw + ph) * s;
  if (const int rc = set_smem(kernel, smem)) return rc;
  const dim3 grid(r, (c4 + kLanes - 1) / kLanes, b);
  kernel<<<grid, dim3(kLanes, kRowWarps), smem, stream>>>(f4, rois, valid_hw, h, w, c4, r, ph,
                                                          pw, s, scale, o4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
