// Streamed ROIAlign forward and backward on NHWC features: the maps the
// resident kernels (roi_align.cu) are not routed to, FPN's P2 and P3 in the
// train step.
//
// Replaces the Pallas TPU kernels mx_rcnn_tpu/ops/pallas/roi_align_stream.py::
// _fwd_kernel (entry _fwd_impl, kernel 4) and ::_bwd_kernel (entry
// _bwd_impl, kernel 5).  Contract: feat (B, H, W, C) f32 or bf16, C % 4 ==
// 0, rois (B, R, 4) f32 image coordinates -> out (B, R, PH, PW, C) of feat's
// dtype; the backward reads g of that dtype and writes dfeat of that dtype,
// summed in f32 (the JAX kernels' f32 accumulator and cast,
// roi_align_stream.py:174-181, 316).  The _bf16 exports are
// roi_align_fwd_bf16.cuh's forward and roi_align_bwd_bf16.cuh's backward
// (see roi_align.cu).  The samples
// are kernel 2's, clamped to the canvas (roi_align_taps.cuh: bit-identical
// positions).  A roi whose scaled x2 < x1 is invalid (the TPU kernels' filler
// rule): its output is zeros and it adds nothing to dfeat.
//
// Kernel 4, forward in float32: roi_align_fwd.cuh's separable template under
// StreamTaps, kernel 2's code: a block whose roi is inverted writes zeros
// with streaming stores and reads nothing; the rest agree with kernel 2 bit
// for bit, with kernel 2's launch shape (a block of 14 warps a roi).  Bound:
// the output writes plus the feature cells the samples read once (25.7 MB
// of output per level at 128 rois, 14 x 14, C = 256) over the card's memory
// rate.  About 40 flops an output: byte-bound, and tensor cores have no
// product to compute.  The bound and the measured times at FPN's P2/P3 are
// in PERF.md, section 6.
//
// Kernel 5, backward, deterministic and without atomics: owner computes, with
// the table and tile kernels of roi_align_table.cuh (shared with kernel 3)
// under kernel 5's tap rule, in 2 x 8 tiles with 4 warps a tile row.  Bound on
// the H100: g read once and dfeat written once (25.7 MB + 39.8 MB at P2, 19.6
// us at 3.35 TB/s).  What sets the time is the longest chain of dependent g
// loads from L2 that one warp makes: the train step's rois cluster, so the
// rows under the cluster meet ~100 small rois, each pairing up to ph row
// entries with up to 2 * s * pw column entries.  Narrow tiles cut each visit's
// pairs, four warps a row cut each warp's visits, the walk by bin loads each
// g element a visit needs once, and the batches keep kBatch loads in flight
// in each chain; 40 KB of shared memory a block lets several blocks share an
// SM.

#include <cuda_runtime.h>

#include "roi_align_bwd_bf16.cuh"
#include "roi_align_fwd.cuh"
#include "roi_align_fwd_bf16.cuh"
#include "roi_align_table.cuh"

// feat (B, H, W, C) f32 with C % 4 == 0, rois (B, R, 4) f32, s >= 1 -> out
// (B, R, PH, PW, C) f32; launches on `stream`, returns a cudaError_t.
extern "C" int roi_align_stream_fwd(const float* feat, const float* rois, int b, int h, int w,
                                    int c, int r, int ph, int pw, int s, float scale,
                                    float* out, void* stream) {
  return roi_align_fwd_launch<StreamTaps, float4>(feat, rois, nullptr, b, h, w, c, r, ph, pw,
                                                  s, scale, out,
                                                  static_cast<cudaStream_t>(stream));
}

// roi_align_stream_fwd on bf16 features: out bf16 (roi_align_fwd_bf16.cuh;
// its launch plan is roi_align.cu's roi_align_fwd_bf16_plan).
extern "C" int roi_align_stream_fwd_bf16(const __nv_bfloat16* feat, const float* rois, int b,
                                         int h, int w, int c, int r, int ph, int pw, int s,
                                         float scale, __nv_bfloat16* out, void* stream) {
  return roi_align_fwd_bf16_launch<StreamTaps>(feat, rois, nullptr, b, h, w, c, r, ph, pw, s,
                                               scale, out, static_cast<cudaStream_t>(stream));
}

// Bytes of the scratch roi_align_stream_bwd takes: one table per (image, roi).
extern "C" long long roi_align_stream_bwd_scratch_bytes(int b, int h, int w, int r,
                                                        int ph, int pw, int s) {
  return table_scratch_bytes(b, h, w, r, ph, pw, s);
}

// g (B, R, PH, PW, C) f32 with C % 4 == 0, rois (B, R, 4) f32 -> dfeat
// (B, H, W, C) f32, every element written (no zero fill needed); scratch:
// roi_align_stream_bwd_scratch_bytes of device memory.  Launches on
// `stream`, returns a cudaError_t.
extern "C" int roi_align_stream_bwd(const float* g, const float* rois, int b,
                                    int h, int w, int c, int r, int ph, int pw,
                                    int s, float scale, void* scratch, float* dfeat,
                                    void* stream) {
  return table_bwd<StreamTaps, 4, 8, 1, float4>(g, rois, nullptr, b, h, w, c, r, ph, pw, s,
                                                scale, scratch, dfeat,
                                                static_cast<cudaStream_t>(stream));
}

// roi_align_stream_bwd of a bf16 g -> dfeat (B, H, W, C) bf16, each cell's
// float32 sum rounded once (roi_align_bwd_bf16.cuh).
extern "C" int roi_align_stream_bwd_bf16(const __nv_bfloat16* g, const float* rois, int b,
                                         int h, int w, int c, int r, int ph, int pw, int s,
                                         float scale, void* scratch, __nv_bfloat16* dfeat,
                                         void* stream) {
  return stage_bwd<StreamTaps, false>(g, rois, nullptr, b, h, w, c, r, ph, pw, s, scale,
                                      scratch, dfeat, static_cast<cudaStream_t>(stream));
}

// roi_align_stream_bwd_bf16's float32 epilogue: the same sums, stored
// unrounded in a float32 dfeat.  A measuring aid for the gates, on no path.
extern "C" int roi_align_stream_bwd_bf16_f32(const __nv_bfloat16* g, const float* rois, int b,
                                             int h, int w, int c, int r, int ph, int pw, int s,
                                             float scale, void* scratch, float* dfeat,
                                             void* stream) {
  return stage_bwd<StreamTaps, true>(g, rois, nullptr, b, h, w, c, r, ph, pw, s, scale,
                                     scratch, dfeat, static_cast<cudaStream_t>(stream));
}
