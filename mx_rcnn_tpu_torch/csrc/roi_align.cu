// ROIAlign forward (kernel 2) and backward (kernel 3) on NHWC features: the
// resident maps, C4's and FPN's P4/P5 in the train step, and every map on
// the eval path.
//
// Replaces the Pallas TPU kernels mx_rcnn_tpu/ops/pallas/roi_align.py::
// _fwd_kernel (forward, entry roi_align_pallas) and ::_bwd_kernel (its
// custom_vjp backward, _roi_align_bwd_impl).  The forward also serves the
// eval path, whose JAX reference is the gather twin
// mx_rcnn_tpu/ops/roi_align.py::roi_align with valid_hw.
// Contract: feat (B, H, W, C) f32 or bf16, C % 4 == 0, rois (B, R, 4) f32
// image coordinates, optional valid_hw (B, 2) f32 -> out (B, R, PH, PW, C)
// of feat's dtype; the backward reads g of feat's dtype and writes dfeat of
// that dtype, summed in f32 (the JAX kernel accumulates dfeat in f32 and
// casts it to the feature dtype outside, roi_align.py:367; the bf16
// backward rounds each sum once as it stores it).  Each dtype has its own
// exports: roi_align_fwd / roi_align_bwd and roi_align_fwd_bf16 /
// roi_align_bwd_bf16; the float32 forward is roi_align_fwd.cuh's template,
// the bf16 one roi_align_fwd_bf16.cuh's (16-byte lanes, the feature columns
// staged by cp.async ahead of a walk by column), the bf16 backward
// roi_align_bwd_bf16.cuh's (g staged in shared memory by bulk asynchronous
// copies).  The bf16
// instances keep the taps, weights and sums in f32 and round the forward's
// output once, to nearest even, as it is stored; they do not round the
// interpolation weights or the row sums to bf16 as the TPU kernel's bf16
// branch does (roi_align.py:119-136), so they are the more exact of the two.
// Each roi is scaled, its width and height floored at 1 (an inverted or
// degenerate roi is not empty: it taps the cells at its clamped x1/y1); each
// bin averages s x s bilinear samples at (i + 0.5) / s.  Sample coordinates
// clamp to [0, lim - 1] and the upper tap is min(lo + 1, lim - 1), where lim
// is the canvas extent (valid_hw == NULL, the Pallas kernel and the train
// step) or min(ceil(valid * scale), extent) (the gather path's
// _feat_limits).  roi_align_taps.cuh puts every sample at the same position
// in all four ROIAlign kernels.
//
// Kernel 2, forward in float32: roi_align_fwd.cuh's separable template under
// ResidentTaps (one block per roi, channel slice and image; a warp on an
// output row, holding the y lerps of the last two columns in registers;
// streaming stores, so the 482 MB of the serving call evict less of the two
// 16.8 MB maps from the 50 MB L2).  Timed on the card against it, each of
// these was as fast or slower: 7 warps a block, a register cap of 58
// (spills), warps splitting a row's bins instead of rows, and reusing a
// sample row's feature row loaded by the row above; default-policy stores
// about 1% slower.  Bound on the H100: the output writes, B*R*PH*PW*C*4
// bytes (241 MB per image on the serving path, 72 us at 3.35 TB/s); ~40
// flops per output, half that time at the f32 rate.
//
// Kernel 3, backward, the adjoint of kernel 2, deterministic and without
// atomics: the table and tile kernels of roi_align_table.cuh (kernel 5's
// design, owner computes) under kernel 2's tap rule.  A set-up kernel writes
// each roi's per-axis (cell, bin, weight) table once; each tile block of
// dfeat sums, in roi order, the g of the rois that meet it into its own
// shared memory and writes every cell once: no zero fill, and two launches
// give bit-identical dfeat.  The tiling: one-row tiles of 8 cells, 8 warps a
// row (kernel 5's 2 x 8 tiles, 4 warps a row, took 0.234 ms at C4 on the H100
// against 0.205, and 2 x 16 tiles 0.323); a map with fewer than 1216 tile
// blocks (FPN's P4 and P5) splits each tile's rois over a cluster of 2 or 4
// blocks, which add their partial sums through distributed shared memory in
// block order.  Bound at the C4 train shape (g 1x128x14x14x1024, dfeat
// 1x38x64x1024): g read once (102.8 MB) and dfeat written once (10.0 MB),
// 0.034 ms at 3.35 TB/s.  What sets the time is the longest chain of dependent
// g loads of one warp under the train step's roi cluster, and at C4 the L2
// traffic of g's repeated loads (1024 channels: 103 MB of g, twice the L2).

#include <cuda_runtime.h>

#include "roi_align_bwd_bf16.cuh"
#include "roi_align_fwd.cuh"
#include "roi_align_fwd_bf16.cuh"
#include "roi_align_table.cuh"

namespace {

// A measuring aid on no path: n float4 stores of zeros, streaming.
__global__ void store_floor_kernel(float4* __restrict__ out, size_t n) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    __stcs(out + i, zero);
  }
}

}  // namespace

// feat (B, H, W, C) f32 with C % 4 == 0, rois (B, R, 4) f32, valid_hw (B, 2)
// f32 or NULL, s >= 1, out (B, R, PH, PW, C) f32; launches on `stream`,
// returns a cudaError_t.
extern "C" int roi_align_fwd(const float* feat, const float* rois, const float* valid_hw,
                             int b, int h, int w, int c, int r, int ph, int pw, int s,
                             float scale, float* out, void* stream) {
  return roi_align_fwd_launch<ResidentTaps, float4>(feat, rois, valid_hw, b, h, w, c, r, ph,
                                                    pw, s, scale, out,
                                                    static_cast<cudaStream_t>(stream));
}

// roi_align_fwd on bf16 features: out (B, R, PH, PW, C) bf16, the same
// float32 sums rounded once (roi_align_fwd_bf16.cuh).
extern "C" int roi_align_fwd_bf16(const __nv_bfloat16* feat, const float* rois,
                                  const float* valid_hw, int b, int h, int w, int c, int r,
                                  int ph, int pw, int s, float scale, __nv_bfloat16* out,
                                  void* stream) {
  return roi_align_fwd_bf16_launch<ResidentTaps>(feat, rois, valid_hw, b, h, w, c, r, ph, pw, s,
                                                 scale, out, static_cast<cudaStream_t>(stream));
}

// The launch plan of roi_align_fwd_bf16 and roi_align_stream_fwd_bf16 (one
// plan for both tap rules): into out[0..5] the bytes of a lane's vector, the
// warps of a block, its row groups and channel slices, the blocks and a
// block's dynamic shared memory (bytes).  Returns a cudaError_t.
extern "C" int roi_align_fwd_bf16_plan(int b, int h, int w, int c, int r, int ph, int pw, int s,
                                       long long* out) {
  FwdPlan p;
  if (const int rc = fwd_bf16_plan(b, h, w, c, r, ph, pw, s, &p)) return rc;
  out[0] = p.vec_bytes;
  out[1] = p.warps;
  out[2] = p.groups;
  out[3] = p.slices;
  out[4] = p.blocks;
  out[5] = (long long)p.smem;
  return 0;
}

// n_floats (a multiple of 4) zeros into out: the store floor of a forward
// that writes as many bytes, for tools/kernel_bench.py.
extern "C" int roi_align_store_floor(float* out, long long n_floats, void* stream) {
  const size_t n = (size_t)n_floats / 4;
  if (n == 0) return 0;
  store_floor_kernel<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the scratch roi_align_bwd takes: one table per (image, roi).
extern "C" long long roi_align_bwd_scratch_bytes(int b, int h, int w, int r, int ph, int pw,
                                                 int s) {
  return table_scratch_bytes(b, h, w, r, ph, pw, s);
}

// g (B, R, PH, PW, C) f32 with C % 4 == 0, rois (B, R, 4) f32, valid_hw
// (B, 2) f32 or NULL -> dfeat (B, H, W, C) f32, every element written (no
// zero fill needed); scratch: roi_align_bwd_scratch_bytes of device memory.
// Launches on `stream`, returns a cudaError_t.  One-row tiles, 8 warps a
// row, bin by bin; a map with fewer than 1216 tile blocks (FPN's P4 and P5,
// 128 channels a block) splits each tile's rois over a cluster of 2 or 4
// blocks, so that the card has as many chains of g loads as at C4.
extern "C" int roi_align_bwd(const float* g, const float* rois, const float* valid_hw, int b,
                             int h, int w, int c, int r, int ph, int pw, int s, float scale,
                             void* scratch, float* dfeat, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = (long long)((w + 7) / 8) * h * b * ((c / 4 + kLanes - 1) / kLanes);
  if (blocks >= 1216) {
    return table_bwd<ResidentTaps, 8, 8, 1, float4>(g, rois, valid_hw, b, h, w, c, r, ph, pw, s,
                                                    scale, scratch, dfeat, st);
  }
  if (blocks >= 608) {
    return table_bwd<ResidentTaps, 8, 8, 2, float4>(g, rois, valid_hw, b, h, w, c, r, ph, pw, s,
                                                    scale, scratch, dfeat, st);
  }
  return table_bwd<ResidentTaps, 8, 8, 4, float4>(g, rois, valid_hw, b, h, w, c, r, ph, pw, s,
                                                  scale, scratch, dfeat, st);
}

// roi_align_bwd of a bf16 g (B, R, PH, PW, C) -> dfeat (B, H, W, C) bf16,
// each cell's float32 sum rounded once (roi_align_bwd_bf16.cuh).
extern "C" int roi_align_bwd_bf16(const __nv_bfloat16* g, const float* rois,
                                  const float* valid_hw, int b, int h, int w, int c, int r,
                                  int ph, int pw, int s, float scale, void* scratch,
                                  __nv_bfloat16* dfeat, void* stream) {
  return stage_bwd<ResidentTaps, false>(g, rois, valid_hw, b, h, w, c, r, ph, pw, s, scale,
                                        scratch, dfeat, static_cast<cudaStream_t>(stream));
}

// The launch plan of roi_align_bwd_bf16 and roi_align_stream_bwd_bf16 (one
// plan for both tap rules) for tools/kernel_bench.py: into out[0..4] the
// dynamic shared memory of a block (bytes), the cluster size, the tile's
// rows, the stages and the blocks.  Returns a cudaError_t.
extern "C" int roi_align_bwd_bf16_plan(int b, int h, int w, int c, int r, int ph, int pw, int s,
                                       long long* out) {
  StageArgs a = {};
  size_t smem = 0;
  int groups = 1;
  if (const int rc = stage_plan(b, h, w, c, r, ph, pw, s, a, smem, groups)) return rc;
  out[0] = (long long)smem;
  out[1] = groups;
  out[2] = a.tile_h;
  out[3] = a.stages;
  out[4] = (long long)(w + kCols - 1) / kCols * groups * ((h + a.tile_h - 1) / a.tile_h) * b *
           a.n_cg;
  return 0;
}

// roi_align_bwd_bf16's float32 epilogue: the same sums, stored unrounded in
// a float32 dfeat.  A measuring aid for the gates, on no path.
extern "C" int roi_align_bwd_bf16_f32(const __nv_bfloat16* g, const float* rois,
                                      const float* valid_hw, int b, int h, int w, int c, int r,
                                      int ph, int pw, int s, float scale, void* scratch,
                                      float* dfeat, void* stream) {
  return stage_bwd<ResidentTaps, true>(g, rois, valid_hw, b, h, w, c, r, ph, pw, s, scale,
                                       scratch, dfeat, static_cast<cudaStream_t>(stream));
}
