// Streamed ROIAlign forward and backward on NHWC features: the maps the
// resident kernels (roi_align.cu) are not routed to, FPN's P2 and P3 in the
// train step.
//
// Replaces the Pallas TPU kernels mx_rcnn_tpu/ops/pallas/roi_align_stream.py::
// _fwd_kernel (entry _fwd_impl, kernel 4) and ::_bwd_kernel (entry
// _bwd_impl, kernel 5).  Contract: feat (B, H, W, C) f32, C % 4 == 0, rois
// (B, R, 4) f32 image coordinates -> out (B, R, PH, PW, C) f32.  The samples
// are kernel 2's, clamped to the canvas (roi_align_taps.cuh: bit-identical
// positions).  A roi whose scaled x2 < x1 is invalid (the TPU kernels' filler
// rule): its output is zeros and it adds nothing to dfeat.
//
// Kernel 4, forward.  One block per (roi, 128-channel slice, image); a warp
// spans the slice in float4 lanes, so every feature load and output store is
// a coalesced 512-byte access.  An invalid roi writes zeros and leaves.  The
// block reads only the rows and columns of its roi's sample support, and
// interpolates separably: for each output row and each of its s sample rows,
// pass 1 lerps the two feature rows at every distinct column the x samples
// tap (shared memory, s = 2, 14 bins: at most 56 columns x 128 channels,
// 28 KB), pass 2 lerps those along x into per-thread accumulators.  A small
// roi's samples share columns, so a column's row lerp is loaded once for all
// the bins that tap it, where kernel 2 loads 16 taps per output.  The
// arithmetic and its order are kernel 2's (y lerp, x lerp, sum over the
// samples, divide), so the two agree bit for bit on valid rois.
// Bound on the H100: the output writes, B*R*PH*PW*C*4 bytes (25.7 MB per
// level at 128 rois, 14 x 14, C = 256: 7.7 us at 3.35 TB/s), plus the feature
// cells the samples read once.
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

#include "roi_align_table.cuh"

namespace {

constexpr int kMaxPwPerThread = 4;  // forward: PW <= kWarps * this

__global__ void __launch_bounds__(kLanes * kWarps)
roi_align_stream_fwd_kernel(const float4* __restrict__ feat,
                            const float* __restrict__ rois, int h, int w, int c4,
                            int r_count, int ph_count, int pw_count, int s,
                            float scale, float4* __restrict__ out) {
  const int r = blockIdx.x, b = blockIdx.z;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const int c = blockIdx.y * kLanes + lane;  // this thread's float4 channel
  const bool has_c = c < c4;
  const Roi q = scaled_roi(rois, b, r, r_count, scale);
  float4* ob = out + ((size_t)b * r_count + r) * ph_count * pw_count * c4;
  if (!(q.x2 >= q.x1)) {
    if (has_c) {
      for (int bin = warp; bin < ph_count * pw_count; bin += kWarps) {
        ob[(size_t)bin * c4 + c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    return;
  }

  const int nx = pw_count * s;
  extern __shared__ float4 smem[];
  float4* rowv = smem;                                   // [2 * nx][kLanes]
  Tap* xt = reinterpret_cast<Tap*>(rowv + 2 * nx * kLanes);
  Tap* yt = xt + nx;                                     // [ph_count * s]
  int* cols = reinterpret_cast<int*>(yt + ph_count * s); // [2 * nx]
  int* x_lo = cols + 2 * nx;                             // [nx] index into cols
  int* x_hi = x_lo + nx;                                 // [nx]
  int* ncol = x_hi + nx;

  roi_taps(q, (float)h, (float)w, h, w, ph_count, pw_count, s, xt, yt, tid, kLanes * kWarps);
  __syncthreads();
  if (tid == 0) {
    // the distinct columns the x taps read.  The taps are non-decreasing
    // along the samples, so a column already listed is one of the last two
    // (a repeat that slipped past would only be loaded twice)
    int n = 0;
    for (int k = 0; k < nx; ++k) {
      for (int side = 0; side < 2; ++side) {
        const int col = side ? xt[k].hi : xt[k].lo;
        int j = -1;
        if (n > 0 && cols[n - 1] == col) j = n - 1;
        else if (n > 1 && cols[n - 2] == col) j = n - 2;
        if (j < 0) {
          cols[n] = col;
          j = n++;
        }
        (side ? x_hi : x_lo)[k] = j;
      }
    }
    *ncol = n;
  }
  __syncthreads();
  const int n_cols = *ncol;

  const float4* fb = feat + (size_t)b * h * w * c4;
  const float count = (float)(s * s);
  for (int ph = 0; ph < ph_count; ++ph) {
    float4 acc[kMaxPwPerThread];
#pragma unroll
    for (int i = 0; i < kMaxPwPerThread; ++i) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int iy = 0; iy < s; ++iy) {
      const Tap ty = yt[ph * s + iy];
      // pass 1: the y lerp at every distinct column
      if (has_c) {
        const float4* row_lo = fb + (size_t)ty.lo * w * c4 + c;
        const float4* row_hi = fb + (size_t)ty.hi * w * c4 + c;
        for (int j = warp; j < n_cols; j += kWarps) {
          const size_t x = (size_t)cols[j] * c4;
          rowv[j * kLanes + lane] = lerp4(row_lo[x], ty.w_lo, row_hi[x], ty.w_hi);
        }
      }
      __syncthreads();
      // pass 2: the x lerps of the bins this thread owns
      if (has_c) {
#pragma unroll
        for (int i = 0; i < kMaxPwPerThread; ++i) {
          const int pw = warp + i * kWarps;
          if (pw < pw_count) {
            for (int ix = 0; ix < s; ++ix) {
              const int k = pw * s + ix;
              const Tap tx = xt[k];
              acc[i] = add4(acc[i], lerp4(rowv[x_lo[k] * kLanes + lane], tx.w_lo,
                                          rowv[x_hi[k] * kLanes + lane], tx.w_hi));
            }
          }
        }
      }
      __syncthreads();
    }
    if (has_c) {
#pragma unroll
      for (int i = 0; i < kMaxPwPerThread; ++i) {
        const int pw = warp + i * kWarps;
        if (pw < pw_count) {
          ob[((size_t)ph * pw_count + pw) * c4 + c] =
              make_float4(acc[i].x / count, acc[i].y / count, acc[i].z / count,
                          acc[i].w / count);
        }
      }
    }
  }
}

}  // namespace

// feat (B, H, W, C) f32 with C % 4 == 0, rois (B, R, 4) f32 -> out
// (B, R, PH, PW, C) f32, PW <= 32; launches on `stream`, returns a cudaError_t.
extern "C" int roi_align_stream_fwd(const float* feat, const float* rois, int b,
                                    int h, int w, int c, int r, int ph, int pw,
                                    int s, float scale, float* out, void* stream) {
  if (b == 0 || r == 0 || c == 0) return 0;
  if (pw > kWarps * kMaxPwPerThread) return static_cast<int>(cudaErrorInvalidValue);
  const int c4 = c / 4, nx = pw * s;
  const size_t smem = sizeof(float4) * 2 * nx * kLanes + sizeof(Tap) * (nx + ph * s) +
                      sizeof(int) * (4 * nx + 1);
  if (const int rc = set_smem(roi_align_stream_fwd_kernel, smem)) return rc;
  const dim3 grid(r, (c4 + kLanes - 1) / kLanes, b);
  roi_align_stream_fwd_kernel<<<grid, dim3(kLanes, kWarps), smem,
                                static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(feat), rois, h, w, c4, r, ph, pw, s, scale,
      reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
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
  return table_bwd<StreamTaps, 4, 8>(g, rois, nullptr, b, h, w, c, r, ph, pw, s, scale,
                                     scratch, dfeat, static_cast<cudaStream_t>(stream));
}
