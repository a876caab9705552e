// ROIAlign forward and backward on NHWC features.
//
// Replaces the Pallas TPU kernels mx_rcnn_tpu/ops/pallas/roi_align.py::
// _fwd_kernel (forward, entry roi_align_pallas) and ::_bwd_kernel (its
// custom_vjp backward, _roi_align_bwd_impl).  The forward also serves the
// eval path, whose JAX reference is the gather twin
// mx_rcnn_tpu/ops/roi_align.py::roi_align with valid_hw.
// Contract: feat (B, H, W, C) f32, rois (B, R, 4) f32 image coordinates,
// optional valid_hw (B, 2) f32 -> out (B, R, PH, PW, C) f32.  Each roi is
// scaled, its width and height floored at 1; each bin averages s x s
// bilinear samples at (i + 0.5) / s.  Sample coordinates clamp to
// [0, lim - 1] and the upper tap is min(lo + 1, lim - 1), where lim is the
// canvas extent (valid_hw == NULL, the Pallas kernel and the train step) or
// min(ceil(valid * scale), extent) (the gather path's _feat_limits).
//
// Forward design: one block per (output row ph, roi r, image b), threads
// across channels in float4 (C % 4 == 0), so every tap load and every output
// store is a coalesced 16-byte access along C.  The block first puts its
// row's sample indices and weights in shared memory.  The feature map
// (16.8 MB at the serving path's 64 x 64 x 1024) stays in the 50 MB L2, so
// the 16 taps per output come from L2/L1 while HBM sees each output once.
// Bound on the H100: the output writes, B*R*PH*PW*C*4 bytes (241 MB per
// image on the serving path, 72 us at 3.35 TB/s); the arithmetic is ~40
// flops per output, half that time at the f32 rate.
// The interpolation follows the gather twin's order: along y at both x taps,
// then along x, then the mean of the samples.
//
// Backward: the exact adjoint of the forward, built from the same taps
// (block_taps below is shared, so the sample positions are bit-identical).
// dfeat (B, H, W, C) f32, zero-filled by the caller, receives for every
// sample (iy, ix) of every bin and every channel g / (s*s) * w_x * w_y in
// each of its 4 cells (y_lo|y_hi) x (x_lo|x_hi); where a clamp makes
// lo == hi both weights land on one cell.  The TPU kernel contracts
// interpolation matrices on the MXU with a sequential roi sweep; blocks on
// the H100 run in no order, so the sum across rois is a scatter with
// fire-and-forget float4 atomics (RED.128 on sm_90) on the forward's grid.
// Bound at the train shape (g 1x128x14x14x1024, dfeat 1x38x64x1024): g read
// once (102.8 MB) plus dfeat zero-filled and written (2 x 10.0 MB), 123 MB
// = 0.037 ms at 3.35 TB/s; ~32 flops per g element (0.8 GFLOP, 0.012 ms at
// 67 TFLOP/s f32).  What likely sets the time is neither: 16 atomic f32 adds
// per g element (411 M) resolved in L2.  The sum order of the atomics
// changes from run to run, so the result is not bitwise repeatable.

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

// The taps of output row ph of roi r of image b, into shared memory:
// xt[pw_count * s] along x, then yt[s] along y.  The caller syncs.
__device__ __forceinline__ void block_taps(const float* __restrict__ rois,
                                           const float* __restrict__ valid_hw,
                                           int b, int r, int ph, int h, int w,
                                           int r_count, int ph_count, int pw_count,
                                           int s, float scale, Tap* xt, Tap* yt) {
  const float* roi = rois + ((size_t)b * r_count + r) * 4;
  const float x1 = roi[0] * scale, y1 = roi[1] * scale;
  const float x2 = roi[2] * scale, y2 = roi[3] * scale;
  float lim_hf = (float)h, lim_wf = (float)w;
  if (valid_hw != nullptr) {
    lim_hf = fminf(ceilf(valid_hw[b * 2 + 0] * scale), (float)h);
    lim_wf = fminf(ceilf(valid_hw[b * 2 + 1] * scale), (float)w);
  }
  const float bin_w = fmaxf(x2 - x1, 1.0f) / (float)pw_count;
  const float bin_h = fmaxf(y2 - y1, 1.0f) / (float)ph_count;
  const int nx = pw_count * s;
  for (int t = threadIdx.x; t < nx + s; t += blockDim.x) {
    if (t < nx) {
      xt[t] = sample_tap(x1, bin_w, t, s, lim_wf, (int)lim_wf, w);
    } else {
      yt[t - nx] = sample_tap(y1, bin_h, ph * s + (t - nx), s, lim_hf, (int)lim_hf, h);
    }
  }
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

// dst += v without reading the old value back (compiles to RED).  sm_90 has
// a 16-byte float4 atomic add on global memory (CUDA 12.1 and later).
__device__ __forceinline__ void red_add4(float4* dst, float4 v) {
#if (__CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)) && \
    defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(dst, v);
#else
  atomicAdd(&dst->x, v.x);
  atomicAdd(&dst->y, v.y);
  atomicAdd(&dst->z, v.z);
  atomicAdd(&dst->w, v.w);
#endif
}

__global__ void roi_align_fwd_kernel(const float4* __restrict__ feat,
                                     const float* __restrict__ rois,
                                     const float* __restrict__ valid_hw, int h,
                                     int w, int c4, int r_count, int ph_count,
                                     int pw_count, int s, float scale,
                                     float4* __restrict__ out) {
  const int ph = blockIdx.x;
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  extern __shared__ Tap taps[];  // pw_count * s x taps, then s y taps
  Tap* xt = taps;
  Tap* yt = taps + pw_count * s;
  block_taps(rois, valid_hw, b, r, ph, h, w, r_count, ph_count, pw_count, s,
             scale, xt, yt);
  __syncthreads();

  const float4* fb = feat + (size_t)b * h * w * c4;
  float4* ob = out + (((size_t)b * r_count + r) * ph_count + ph) * pw_count * c4;
  const float count = (float)(s * s);
  for (int c = threadIdx.x; c < c4; c += blockDim.x) {
    for (int pw = 0; pw < pw_count; ++pw) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int iy = 0; iy < s; ++iy) {
        const Tap ty = yt[iy];
        const float4* row_lo = fb + (size_t)ty.lo * w * c4 + c;
        const float4* row_hi = fb + (size_t)ty.hi * w * c4 + c;
        for (int ix = 0; ix < s; ++ix) {
          const Tap tx = xt[pw * s + ix];
          const float4 at_lo = lerp4(row_lo[(size_t)tx.lo * c4], ty.w_lo,
                                     row_hi[(size_t)tx.lo * c4], ty.w_hi);
          const float4 at_hi = lerp4(row_lo[(size_t)tx.hi * c4], ty.w_lo,
                                     row_hi[(size_t)tx.hi * c4], ty.w_hi);
          acc = add4(acc, lerp4(at_lo, tx.w_lo, at_hi, tx.w_hi));
        }
      }
      ob[(size_t)pw * c4 + c] = make_float4(acc.x / count, acc.y / count,
                                            acc.z / count, acc.w / count);
    }
  }
}

__global__ void roi_align_bwd_kernel(const float4* __restrict__ g,
                                     const float* __restrict__ rois,
                                     const float* __restrict__ valid_hw, int h,
                                     int w, int c4, int r_count, int ph_count,
                                     int pw_count, int s, float scale,
                                     float4* __restrict__ dfeat) {
  const int ph = blockIdx.x;
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  extern __shared__ Tap taps[];
  Tap* xt = taps;
  Tap* yt = taps + pw_count * s;
  block_taps(rois, valid_hw, b, r, ph, h, w, r_count, ph_count, pw_count, s,
             scale, xt, yt);
  __syncthreads();

  float4* db = dfeat + (size_t)b * h * w * c4;
  const float4* gb = g + (((size_t)b * r_count + r) * ph_count + ph) * pw_count * c4;
  const float count = (float)(s * s);
  for (int c = threadIdx.x; c < c4; c += blockDim.x) {
    for (int pw = 0; pw < pw_count; ++pw) {
      // the mean's adjoint, then x, then y: autograd's order through the
      // forward's lerps
      float4 gv = gb[(size_t)pw * c4 + c];
      gv = make_float4(gv.x / count, gv.y / count, gv.z / count, gv.w / count);
      for (int iy = 0; iy < s; ++iy) {
        const Tap ty = yt[iy];
        float4* row_lo = db + (size_t)ty.lo * w * c4 + c;
        float4* row_hi = db + (size_t)ty.hi * w * c4 + c;
        for (int ix = 0; ix < s; ++ix) {
          const Tap tx = xt[pw * s + ix];
          const float4 at_lo = scale4(gv, tx.w_lo);
          const float4 at_hi = scale4(gv, tx.w_hi);
          red_add4(row_lo + (size_t)tx.lo * c4, scale4(at_lo, ty.w_lo));
          red_add4(row_hi + (size_t)tx.lo * c4, scale4(at_lo, ty.w_hi));
          red_add4(row_lo + (size_t)tx.hi * c4, scale4(at_hi, ty.w_lo));
          red_add4(row_hi + (size_t)tx.hi * c4, scale4(at_hi, ty.w_hi));
        }
      }
    }
  }
}

int launch_config(int c, int pw, int s, int* threads, size_t* smem) {
  const int c4 = c / 4;
  *threads = c4 >= 256 ? 256 : ((c4 + 31) / 32) * 32;
  *smem = sizeof(Tap) * (size_t)(pw * s + s);
  return c4;
}

}  // namespace

// feat (B, H, W, C) f32 with C % 4 == 0, rois (B, R, 4) f32, valid_hw (B, 2)
// f32 or NULL, out (B, R, PH, PW, C) f32; launches on `stream`, returns
// cudaGetLastError().
extern "C" int roi_align_fwd(const float* feat, const float* rois,
                             const float* valid_hw, int b, int h, int w, int c,
                             int r, int ph, int pw, int s, float scale,
                             float* out, void* stream) {
  if (b == 0 || r == 0 || c == 0) return 0;
  int threads;
  size_t smem;
  const int c4 = launch_config(c, pw, s, &threads, &smem);
  const dim3 grid(ph, r, b);
  roi_align_fwd_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(feat), rois, valid_hw, h, w, c4, r, ph, pw,
      s, scale, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// g (B, R, PH, PW, C) f32 with C % 4 == 0, rois (B, R, 4) f32, valid_hw
// (B, 2) f32 or NULL; accumulates into dfeat (B, H, W, C) f32, which the
// caller has zero-filled on `stream`; returns cudaGetLastError().
extern "C" int roi_align_bwd(const float* g, const float* rois,
                             const float* valid_hw, int b, int h, int w, int c,
                             int r, int ph, int pw, int s, float scale,
                             float* dfeat, void* stream) {
  if (b == 0 || r == 0 || c == 0) return 0;
  int threads;
  size_t smem;
  const int c4 = launch_config(c, pw, s, &threads, &smem);
  const dim3 grid(ph, r, b);
  roi_align_bwd_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(g), rois, valid_hw, h, w, c4, r, ph, pw,
      s, scale, reinterpret_cast<float4*>(dfeat));
  return static_cast<int>(cudaGetLastError());
}
