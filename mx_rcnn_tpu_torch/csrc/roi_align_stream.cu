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
// Kernel 5, backward, deterministic and without atomics: owner computes.
// One block per (8-row x 16-column tile of dfeat, 128-channel slice, image);
// warp w owns tile row w, each lane a float4 of channels in its 16 cells,
// accumulated in registers.  The block walks the rois in order, skips those
// that are invalid or whose conservative row/column extent (the TPU
// kernel's _row_matrices bound) misses the tile, and for each other roi
// builds in shared memory the interpolation weights restricted to the tile,
// Ay[ph][y] = sum over the s samples of bin row ph of their weight on row y
// (and Ax likewise), with the range of bins that touch each row and column.
// A cell then adds sum_ph Ay[ph][y] * sum_pw Ax[pw][x] * g[r, ph, pw] over the
// bins that touch it.  Every cell is written once, at the end: no zero fill,
// no atomics, and a fixed sum order, so two launches give bit-identical
// dfeat (the TPU kernel's dfeat-stationary grid gives the same).
// Bound on the H100: g read once and dfeat written once (25.7 MB + 39.8 MB
// at P2, 19.6 us at 3.35 TB/s).  What likely sets the time is the per-roi
// set-up each tile repeats (taps, weights, three barriers) for every roi
// that meets it, and the g reads from L2.

#include <cuda_runtime.h>

#include "roi_align_taps.cuh"

namespace {

constexpr int kLanes = 32;  // float4 lanes: one warp spans 128 channels
constexpr int kWarps = 8;
constexpr int kMaxPwPerThread = 4;  // forward: PW <= kWarps * this
constexpr int kTileH = kWarps;      // backward: one tile row per warp
constexpr int kTileW = 16;

struct Roi {
  float x1, y1, x2, y2;
};

__device__ __forceinline__ Roi scaled_roi(const float* __restrict__ rois, int b,
                                          int r, int r_count, float scale) {
  const float* roi = rois + ((size_t)b * r_count + r) * 4;
  return Roi{roi[0] * scale, roi[1] * scale, roi[2] * scale, roi[3] * scale};
}

// The samples' conservative cell extent along one axis, clamped to the map
// (_row_matrices in the TPU kernel): samples lie in [c1, c1 + max(c2 - c1, 1))
// and touch the floor of each and the cell after it.
__device__ __forceinline__ void extent(float c1, float c2, int size, int* lo,
                                       int* hi) {
  const float top = (float)(size - 1);
  *lo = (int)fminf(fmaxf(floorf(c1), 0.0f), top);
  *hi = (int)fminf(fmaxf(floorf(c1 + fmaxf(c2 - c1, 1.0f)) + 1.0f, 0.0f), top);
}

// The roi's x taps xt[pw * s] and y taps yt[ph * s], into shared memory
// (the caller syncs).  Canvas clamp: lim = the map's extent.
__device__ __forceinline__ void roi_taps(const Roi& q, int h, int w, int ph_count,
                                         int pw_count, int s, Tap* xt, Tap* yt,
                                         int tid, int nthreads) {
  const float bin_w = fmaxf(q.x2 - q.x1, 1.0f) / (float)pw_count;
  const float bin_h = fmaxf(q.y2 - q.y1, 1.0f) / (float)ph_count;
  const int nx = pw_count * s, ny = ph_count * s;
  for (int t = tid; t < nx + ny; t += nthreads) {
    if (t < nx) {
      xt[t] = sample_tap(q.x1, bin_w, t, s, (float)w, w, w);
    } else {
      yt[t - nx] = sample_tap(q.y1, bin_h, t - nx, s, (float)h, h, h);
    }
  }
}

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

  roi_taps(q, h, w, ph_count, pw_count, s, xt, yt, tid, kLanes * kWarps);
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

// The weights of one axis restricted to a tile: m[bin * tile + t] = sum over
// the s samples of `bin` of their weight on cell origin + t, and range[t] =
// the first and last bin with a sample that taps that cell (first > last
// when none does).
__device__ __forceinline__ void tile_weights(const Tap* taps, int nbins, int s,
                                             int origin, int tile, float* m,
                                             int2* range, int tid, int nthreads) {
  for (int i = tid; i < nbins * tile + tile; i += nthreads) {
    if (i < nbins * tile) {
      const int bin = i / tile, cell = origin + i % tile;
      float wsum = 0.0f;
      for (int j = 0; j < s; ++j) {
        const Tap t = taps[bin * s + j];
        if (t.lo == cell) wsum += t.w_lo;
        if (t.hi == cell) wsum += t.w_hi;
      }
      m[i] = wsum;
    } else {
      const int cell = origin + (i - nbins * tile);
      int first = nbins, last = -1;
      for (int k = 0; k < nbins * s; ++k) {
        if (taps[k].lo == cell || taps[k].hi == cell) {
          first = min(first, k / s);
          last = k / s;
        }
      }
      range[i - nbins * tile] = make_int2(first, last);
    }
  }
}

__global__ void __launch_bounds__(kLanes * kWarps)
roi_align_stream_bwd_kernel(const float4* __restrict__ g,
                            const float* __restrict__ rois, int h, int w, int c4,
                            int n_cs, int r_count, int ph_count, int pw_count,
                            int s, float scale, float4* __restrict__ dfeat) {
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z / n_cs;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const int c = (blockIdx.z % n_cs) * kLanes + lane;
  const bool has_c = c < c4;

  extern __shared__ float4 smem[];
  Tap* xt = reinterpret_cast<Tap*>(smem);                 // [pw_count * s]
  Tap* yt = xt + pw_count * s;                            // [ph_count * s]
  float* ay = reinterpret_cast<float*>(yt + ph_count * s); // [ph_count][kTileH]
  float* ax = ay + ph_count * kTileH;                     // [pw_count][kTileW]
  int2* yr = reinterpret_cast<int2*>(ax + pw_count * kTileW);  // [kTileH]
  int2* xr = yr + kTileH;                                 // [kTileW]

  float4 acc[kTileW];
#pragma unroll
  for (int i = 0; i < kTileW; ++i) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  const float4* gb = g + (size_t)b * r_count * ph_count * pw_count * c4;
  for (int r = 0; r < r_count; ++r) {
    // uniform across the block: every thread takes the same branch
    const Roi q = scaled_roi(rois, b, r, r_count, scale);
    if (!(q.x2 >= q.x1)) continue;
    int ylo, yhi, xlo, xhi;
    extent(q.y1, q.y2, h, &ylo, &yhi);
    extent(q.x1, q.x2, w, &xlo, &xhi);
    if (yhi < y0 || ylo >= y0 + kTileH || xhi < x0 || xlo >= x0 + kTileW) continue;

    roi_taps(q, h, w, ph_count, pw_count, s, xt, yt, tid, kLanes * kWarps);
    __syncthreads();
    tile_weights(yt, ph_count, s, y0, kTileH, ay, yr, tid, kLanes * kWarps);
    tile_weights(xt, pw_count, s, x0, kTileW, ax, xr, tid, kLanes * kWarps);
    __syncthreads();
    const int2 rows = yr[warp];
    if (has_c) {
      const float4* gr = gb + (size_t)r * ph_count * pw_count * c4 + c;
      for (int ph = rows.x; ph <= rows.y; ++ph) {
        const float wy = ay[ph * kTileH + warp];
        const float4* gp = gr + (size_t)ph * pw_count * c4;
#pragma unroll
        for (int xl = 0; xl < kTileW; ++xl) {
          const int2 bins = xr[xl];
          for (int pw = bins.x; pw <= bins.y; ++pw) {
            acc[xl] = add4(acc[xl], scale4(gp[(size_t)pw * c4], wy * ax[pw * kTileW + xl]));
          }
        }
      }
    }
    __syncthreads();
  }

  const int y = y0 + warp;
  if (!has_c || y >= h) return;
  const float count = (float)(s * s);
  float4* row = dfeat + ((size_t)b * h + y) * w * c4 + c;
#pragma unroll
  for (int xl = 0; xl < kTileW; ++xl) {
    if (x0 + xl < w) {
      row[(size_t)(x0 + xl) * c4] = make_float4(acc[xl].x / count, acc[xl].y / count,
                                                acc[xl].z / count, acc[xl].w / count);
    }
  }
}

// Shared memory above the default 48 KB must be opted into per kernel.
template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
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

// g (B, R, PH, PW, C) f32 with C % 4 == 0, rois (B, R, 4) f32 -> dfeat
// (B, H, W, C) f32, every element written (no zero fill needed); launches on
// `stream`, returns a cudaError_t.
extern "C" int roi_align_stream_bwd(const float* g, const float* rois, int b,
                                    int h, int w, int c, int r, int ph, int pw,
                                    int s, float scale, float* dfeat, void* stream) {
  if (b == 0 || h == 0 || w == 0 || c == 0) return 0;
  const int c4 = c / 4, n_cs = (c4 + kLanes - 1) / kLanes;
  const size_t smem = sizeof(Tap) * (pw + ph) * s +
                      sizeof(float) * (ph * kTileH + pw * kTileW) +
                      sizeof(int2) * (kTileH + kTileW);
  if (const int rc = set_smem(roi_align_stream_bwd_kernel, smem)) return rc;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b * n_cs);
  roi_align_stream_bwd_kernel<<<grid, dim3(kLanes, kWarps), smem,
                                static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(g), rois, h, w, c4, n_cs, r, ph, pw, s, scale,
      reinterpret_cast<float4*>(dfeat));
  return static_cast<int>(cudaGetLastError());
}
