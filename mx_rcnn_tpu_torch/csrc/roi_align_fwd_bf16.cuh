// The ROIAlign forward on bfloat16 NHWC features, shared by kernel 2's bf16
// instance (roi_align.cu, the resident maps, under ResidentTaps) and kernel
// 4's (roi_align_stream.cu, FPN's P2/P3 in the train step, under StreamTaps).
//
// Replaces mx_rcnn_tpu/ops/pallas/roi_align.py:88 (_fwd_kernel, called by
// _roi_align_fwd_impl, pallas_call at :304; its bf16 branch :113-136) and
// mx_rcnn_tpu/ops/pallas/roi_align_stream.py:100 (_fwd_kernel, called by
// _fwd_impl, pallas_call at :250; bf16 :118-146) on bf16 features.
//
// Contract: feat (B, H, W, C) bf16, C % 4 == 0, rois (B, R, 4) f32 image
// coordinates, valid_hw (B, 2) f32 or NULL (read under ResidentTaps only) ->
// out (B, R, PH, PW, C) bf16, any PH, PW and sample ratio s >= 1.  It
// computes what roi_align_fwd.cuh's template computes on bf16 maps, bit for
// bit: the taps of roi_align_taps.cuh (ResidentTaps floors the roi's width
// and height at 1 and clamps to valid_hw; under StreamTaps an inverted roi,
// scaled x2 < x1 or NaN, writes zeros and reads nothing), then in float32,
// with no contraction: along y at both x taps, along x, the sum over the
// samples with sample rows outer, the division by s * s, and one round to
// nearest even as the value is stored.
//
// Bound on the H100: the output written once in bf16 plus the feature cells
// the samples read, once, over 3.35 TB/s (C4 serving, 2 x 300 rois at 14 x 14
// x 1024 from 2 x 64 x 64 x 1024: 0.0742 ms).  The arithmetic is the other
// limit: at s = 2 about 30 float32 operations an output element, none of
// which may be fused, and the widening of every bf16 cell loaded, at one
// warp instruction a clock on each of the card's 528 SM sub-partitions; the
// kernel is bound by that issue rate, not by bytes (PERF.md, section 6).
//
// Design.  A block of kFwdWarps warps takes one (image, roi, channel slice,
// group of kFwdWarps output rows); a warp takes one output row, a lane one
// 16-byte vector of 8 channels (a warp 256 channels), or of 4 channels (8
// bytes) where C % 8 == 4 and a cell's stride is not 16-byte aligned.  The
// block's first warp lays out the roi's sample columns once, while the
// others compute its rows' y taps: the x taps of the samples are monotone,
// so a prefix sum over the warp lists the distinct feature columns they tap
// in order, and each sample gets the index of its upper column and whether
// its lower one is the column before.  Each warp then walks its row column
// by column.  For column j it holds the S sample rows' y lerps in registers
// (the columns j - 1 and j, in two register sets by parity), and a sample
// whose upper column is j takes its x lerp from them.  A column's 2 S cells
// are loaded into registers a column ahead (two raw buffers by parity),
// each at a 32-bit offset from its feature row's pointer.  The output is
// written with streaming 16-byte stores (st.global.cs), the float32 values
// rounded by one cvt.rn.bf16x2 a pair.
//
// What it does about the costs of the float32 template's bf16 instance
// (roi_align_fwd.cuh with 8-byte lanes, which this replaced; PERF.md,
// section 6): (1) a new column's loads were issued where the column reuse's
// branches found it new, and widened as soon as they returned: here they
// are issued a column ahead, from a list made before the walk, and widened
// when the walk reaches the column; (2) a 4-channel lane paid the
// walk's control, addressing and tap reads for 4 channels: here 8, so the
// call issues fewer instructions for the same arithmetic; (3) the small
// calls (128 rois at C = 256) were one wave of 14-warp blocks: here a block
// takes half a roi's rows, so every row of such a call runs at once.
// Timed on the card and dropped (PERF.md, section 6): the columns staged
// in a shared-memory ring by cp.async (the shared-memory reads add to the
// load path), loading only an output row's distinct feature rows (its
// pattern's branches cost more than the loads and widening they save), and
// 8-byte lanes for the small calls.
//
// Instances: s = 1..4 compiled in (roi_align_fwd_bf16_kernel<S, Rule, V>);
// any larger s takes roi_align_fwd_bf16_any_s_kernel<Rule, V>, the same
// block and lanes, each sample's 4 cells loaded, in the same arithmetic
// order.  No configuration of the repository uses s > 4.
#pragma once

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_align_taps.cuh"

namespace {

constexpr int kFwdWarps = 7;  // output rows a block, one a warp
constexpr int kFwdMaxS = 4;   // sample ratios with a compiled-in instance

// A lane's vector and its bf16 channels.
template <typename V>
struct LaneOf;
template <>
struct LaneOf<uint4> {
  static constexpr int kCh = 8;
};
template <>
struct LaneOf<uint2> {
  static constexpr int kCh = 4;
};

// A sample on its row's column walk: the index of its upper tap's column in
// the roi's list of distinct columns, 1 if its lower tap is the column
// before (0: the same column), and its x weights.
struct XStep {
  int need, two;
  float w_lo, w_hi;
};

// The launch plan, from the shapes only: the lane's vector (16 bytes, or 8
// where C % 8 == 4), the blocks' channel slices (32 lanes each) and row
// groups (kFwdWarps rows each), and a block's shared memory.
struct FwdPlan {
  int vec_bytes, warps, groups, slices;
  long long blocks;
  size_t smem;
};

inline int fwd_bf16_plan(int b, int h, int w, int c, int r, int ph, int pw, int s,
                         FwdPlan* p) {
  if (s < 1 || c % 4 || b < 0 || h < 1 || w < 1 || c < 0 || r < 0 || ph < 0 || pw < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p->vec_bytes = c % 8 == 0 ? 16 : 8;
  const int cv = c / (p->vec_bytes / 2);
  p->warps = kFwdWarps;
  p->groups = (ph + kFwdWarps - 1) / kFwdWarps;
  p->slices = (cv + kLanes - 1) / kLanes;
  p->blocks = (long long)r * p->groups * p->slices * b;
  const size_t nx = (size_t)pw * s;
  p->smem = sizeof(XStep) * nx + sizeof(Tap) * kFwdWarps * s + sizeof(int) * 2 * nx;
  return 0;
}

// bf16 channels to float32 (exact: a bf16 is the top half of a float32).
__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  const unsigned q[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(q[i] << 16);
    f[2 * i + 1] = __uint_as_float(q[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void widen(const uint2& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}

// Two float32 values rounded to nearest even into bf16x2, lo in the low half.
__device__ __forceinline__ unsigned round_pair(float lo, float hi) {
  unsigned u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}

__device__ __forceinline__ void store_cs(uint4* p, const float (&f)[8]) {
  __stcs(p, make_uint4(round_pair(f[0], f[1]), round_pair(f[2], f[3]), round_pair(f[4], f[5]),
                       round_pair(f[6], f[7])));
}

__device__ __forceinline__ void store_cs(uint2* p, const float (&f)[4]) {
  __stcs(p, make_uint2(round_pair(f[0], f[1]), round_pair(f[2], f[3])));
}

template <typename V>
__device__ __forceinline__ void zero_row(V* __restrict__ ob, int cv, int pw_count) {
  V z;
  unsigned* words = reinterpret_cast<unsigned*>(&z);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(V) / 4); ++i) words[i] = 0u;
  for (int pw = 0; pw < pw_count; ++pw) __stcs(ob + (size_t)pw * cv, z);
}

// Warp 0 of a block: the x taps of the roi's samples, laid out for the
// column walk.  cols[] gets the distinct feature columns the samples tap,
// in increasing order (as byte offsets in a row, x * col_bytes), xs[k]
// sample k's step.  The taps are monotone in k and hi is lo or lo + 1, so a
// sample's lower tap is new when it passes the largest column so far (the
// previous sample's hi), its upper one when it passes both; after sample k
// the largest column listed is its hi, at the list's end.
__device__ __forceinline__ void x_schedule(const Roi& q, float lim_wf, int w, int col_bytes,
                                           int pw_count, int s, XStep* xs, int* cols, int lane) {
  const float bin_w = fmaxf(q.x2 - q.x1, 1.0f) / (float)pw_count;
  const int nx = pw_count * s;
  int count = 0, last_hi = -1;
  for (int base = 0; base < nx; base += kLanes) {
    const int k = base + lane;
    const bool valid = k < nx;
    Tap t = {0, 0, 0.0f, 0.0f};
    if (valid) t = sample_tap(q.x1, bin_w, k, s, lim_wf, (int)lim_wf, w);
    int prev_hi = __shfl_up_sync(0xffffffffu, t.hi, 1);
    if (lane == 0) prev_hi = last_hi;
    const int lo_new = valid && t.lo > prev_hi;
    const int hi_new = valid && t.hi > t.lo && t.hi > prev_hi;
    const int n = lo_new + hi_new;
    int incl = n;
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const int pos = count + incl - n;
    if (lo_new) cols[pos] = t.lo * col_bytes;
    if (hi_new) cols[pos + lo_new] = t.hi * col_bytes;
    if (valid) xs[k] = XStep{count + incl - 1, t.hi != t.lo ? 1 : 0, t.w_lo, t.w_hi};
    count += __shfl_sync(0xffffffffu, incl, kLanes - 1);
    last_hi = __shfl_sync(0xffffffffu, t.hi, kLanes - 1);
  }
}

// The other warps: the y taps of the block's rows, yt[row_in_group * s + iy].
__device__ __forceinline__ void y_taps(const Roi& q, float lim_hf, int h, int ph_count, int s,
                                       int group, Tap* yt, int tid, int nthreads) {
  const float bin_h = fmaxf(q.y2 - q.y1, 1.0f) / (float)ph_count;
  for (int t = tid; t < kFwdWarps * s; t += nthreads) {
    const int ph = group * kFwdWarps + t / s;
    if (ph < ph_count) yt[t] = sample_tap(q.y1, bin_h, ph * s + t % s, s, lim_hf, (int)lim_hf, h);
  }
}

// A column's 2 S cells: sample row iy's lower feature row at 2 iy, its
// upper at 2 iy + 1.
template <int kCells, typename V>
__device__ __forceinline__ void load_cells(V (&raw)[kCells], const char* const (&rp)[kCells],
                                           unsigned col) {
#pragma unroll
  for (int k = 0; k < kCells; ++k) raw[k] = __ldg(reinterpret_cast<const V*>(rp[k] + col));
}

// The y lerps of the S sample rows at one column, from its cells.
template <int S, typename V, int kCh>
__device__ __forceinline__ void y_lerps(const V (&raw)[2 * S], const float (&wy_lo)[S],
                                        const float (&wy_hi)[S], float (&v)[S][kCh]) {
#pragma unroll
  for (int iy = 0; iy < S; ++iy) {
    float lo[kCh], hi[kCh];
    widen(raw[2 * iy], lo);
    widen(raw[2 * iy + 1], hi);
#pragma unroll
    for (int e = 0; e < kCh; ++e) v[iy][e] = lo[e] * wy_lo[iy] + hi[e] * wy_hi[iy];
  }
}

// The x lerps of one sample column, for every sample row.
template <int S, int kCh>
__device__ __forceinline__ void x_lerps(const float (&lo)[S][kCh], const float (&hi)[S][kCh],
                                        float w_lo, float w_hi, float (&xl)[S][kCh]) {
#pragma unroll
  for (int iy = 0; iy < S; ++iy) {
#pragma unroll
    for (int e = 0; e < kCh; ++e) xl[iy][e] = lo[iy][e] * w_lo + hi[iy][e] * w_hi;
  }
}

template <int S>
struct FwdOccupancy {
  // blocks an SM: at 2, each thread may hold 128 registers, what s <= 2
  // needs without spilling; the raw cells and lerps of s = 3, 4 take more
  static constexpr int kMinBlocks = S <= 2 ? 2 : 1;
};

template <int S, typename Rule, typename V>
__global__ void __launch_bounds__(kLanes * kFwdWarps, FwdOccupancy<S>::kMinBlocks)
roi_align_fwd_bf16_kernel(const V* __restrict__ feat, const float* __restrict__ rois,
                          const float* __restrict__ valid_hw, int h, int w, int cv, int r_count,
                          int ph_count, int pw_count, int groups, float scale,
                          V* __restrict__ out) {
  constexpr int kCh = LaneOf<V>::kCh;
  constexpr int kCells = 2 * S;  // a column's cells at most: each sample row's two
  constexpr int kHeld = S > 1 ? S - 1 : 1;
  const int r = blockIdx.x, b = blockIdx.z;
  const int slice = blockIdx.y / groups, group = blockIdx.y - slice * groups;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int c = slice * kLanes + lane;  // this lane's vector of channels
  const int ph = group * kFwdWarps + warp;
  const int nx = pw_count * S;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  XStep* xs = reinterpret_cast<XStep*>(fwd_smem);          // [nx]
  Tap* yt = reinterpret_cast<Tap*>(xs + nx);                // [kFwdWarps * S]
  int* cols = reinterpret_cast<int*>(yt + kFwdWarps * S);   // [2 * nx]
  float lim_hf, lim_wf;
  tap_limits(Rule::kResident ? valid_hw : nullptr, b, scale, h, w, &lim_hf, &lim_wf);
  const Roi q = scaled_roi(rois, b, r, r_count, scale);
  V* ob = out + (((size_t)b * r_count + r) * ph_count + ph) * pw_count * cv + c;
  if constexpr (!Rule::kResident) {
    if (!(q.x2 >= q.x1)) {  // the same for the whole block
      if (c < cv && ph < ph_count) zero_row(ob, cv, pw_count);
      return;
    }
  }
  if (warp == 0) {
    x_schedule(q, lim_wf, w, cv * (int)sizeof(V), pw_count, S, xs, cols, lane);
  } else {
    y_taps(q, lim_hf, h, ph_count, S, group, yt, (warp - 1) * kLanes + lane,
           (kFwdWarps - 1) * kLanes);
  }
  __syncthreads();
  if (c >= cv || ph >= ph_count) return;  // past the only barrier

  // this row's feature rows, as byte pointers at this lane's channels
  const char* fb = reinterpret_cast<const char*>(feat + (size_t)b * h * w * cv + c);
  const size_t row_bytes = (size_t)w * cv * sizeof(V);
  const char* rp[kCells];
  float wy_lo[S], wy_hi[S];
#pragma unroll
  for (int iy = 0; iy < S; ++iy) {
    const Tap ty = yt[warp * S + iy];
    rp[2 * iy] = fb + ty.lo * row_bytes;
    rp[2 * iy + 1] = fb + ty.hi * row_bytes;
    wy_lo[iy] = ty.w_lo;
    wy_hi[iy] = ty.w_hi;
  }
  const int ncols = xs[nx - 1].need + 1;

  V ra[kCells], rb[kCells];      // the cells of the even and the odd columns
  float va[S][kCh], vb[S][kCh];  // their y lerps
  int j = -1;                    // the last column walked
  load_cells<kCells, V>(ra, rp, (unsigned)cols[0]);
// column j: load column j + 1's cells into NEXT (column j - 1's buffer,
// lerped a step ago), then lerp column j's cells (RAW) into V_DST
#define FWD_STEP(NEXT, RAW, V_DST)                                                    \
  do {                                                                                \
    if (j + 1 < ncols) load_cells<kCells, V>(NEXT, rp, (unsigned)cols[j + 1]);        \
    y_lerps<S, V, kCh>(RAW, wy_lo, wy_hi, V_DST);                                     \
  } while (0)

  const float count = (float)(S * S);
  for (int pw = 0; pw < pw_count; ++pw) {
    float acc[kCh];
#pragma unroll
    for (int e = 0; e < kCh; ++e) acc[e] = 0.0f;
    float held[kHeld][kHeld][kCh];  // x lerps of rows iy >= 1, columns ix < S - 1
#pragma unroll
    for (int ix = 0; ix < S; ++ix) {
      const XStep st = xs[pw * S + ix];
      while (j < st.need) {
        ++j;
        if (j & 1) {
          FWD_STEP(ra, rb, vb);
        } else {
          FWD_STEP(rb, ra, va);
        }
      }
      // the upper column is j, the lower j - st.two
      float xl[S][kCh];
      if (j & 1) {
        if (st.two) {
          x_lerps<S, kCh>(va, vb, st.w_lo, st.w_hi, xl);
        } else {
          x_lerps<S, kCh>(vb, vb, st.w_lo, st.w_hi, xl);
        }
      } else {
        if (st.two) {
          x_lerps<S, kCh>(vb, va, st.w_lo, st.w_hi, xl);
        } else {
          x_lerps<S, kCh>(va, va, st.w_lo, st.w_hi, xl);
        }
      }
      // the sum's order: sample rows outer, sample columns inner
#pragma unroll
      for (int e = 0; e < kCh; ++e) acc[e] = acc[e] + xl[0][e];
      if (ix < S - 1) {
#pragma unroll
        for (int iy = 1; iy < S; ++iy) {
#pragma unroll
          for (int e = 0; e < kCh; ++e) held[iy - 1][ix][e] = xl[iy][e];
        }
      } else {
#pragma unroll
        for (int iy = 1; iy < S; ++iy) {
#pragma unroll
          for (int i2 = 0; i2 < S - 1; ++i2) {
#pragma unroll
            for (int e = 0; e < kCh; ++e) acc[e] = acc[e] + held[iy - 1][i2][e];
          }
#pragma unroll
          for (int e = 0; e < kCh; ++e) acc[e] = acc[e] + xl[iy][e];
        }
      }
    }
    float o[kCh];
#pragma unroll
    for (int e = 0; e < kCh; ++e) o[e] = acc[e] / count;
    store_cs(ob, o);
    ob += cv;
  }
#undef FWD_STEP
}

// Any s (the launcher sends s > kFwdMaxS here): the block and lanes of
// roi_align_fwd_bf16_kernel, each sample's 4 cells loaded, in the same
// arithmetic order.  xs holds the x taps as Taps.
template <typename Rule, typename V>
__global__ void __launch_bounds__(kLanes * kFwdWarps, 2)
roi_align_fwd_bf16_any_s_kernel(const V* __restrict__ feat, const float* __restrict__ rois,
                                const float* __restrict__ valid_hw, int h, int w, int cv,
                                int r_count, int ph_count, int pw_count, int s, int groups,
                                float scale, V* __restrict__ out) {
  constexpr int kCh = LaneOf<V>::kCh;
  const int r = blockIdx.x, b = blockIdx.z;
  const int slice = blockIdx.y / groups, group = blockIdx.y - slice * groups;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int c = slice * kLanes + lane;
  const int ph = group * kFwdWarps + warp;
  const int nx = pw_count * s;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  Tap* xt = reinterpret_cast<Tap*>(fwd_smem);  // [nx]
  Tap* yt = xt + nx;                       // [kFwdWarps * s]
  float lim_hf, lim_wf;
  tap_limits(Rule::kResident ? valid_hw : nullptr, b, scale, h, w, &lim_hf, &lim_wf);
  const Roi q = scaled_roi(rois, b, r, r_count, scale);
  const size_t row_at = (((size_t)b * r_count + r) * ph_count + ph) * pw_count * cv + c;
  if constexpr (!Rule::kResident) {
    if (!(q.x2 >= q.x1)) {
      if (c < cv && ph < ph_count) zero_row(out + row_at, cv, pw_count);
      return;
    }
  }
  if (warp == 0) {
    const float bin_w = fmaxf(q.x2 - q.x1, 1.0f) / (float)pw_count;
    for (int k = lane; k < nx; k += kLanes) {
      xt[k] = sample_tap(q.x1, bin_w, k, s, lim_wf, (int)lim_wf, w);
    }
  } else {
    y_taps(q, lim_hf, h, ph_count, s, group, yt, (warp - 1) * kLanes + lane,
           (kFwdWarps - 1) * kLanes);
  }
  __syncthreads();
  if (c >= cv || ph >= ph_count) return;

  const V* fb = feat + (size_t)b * h * w * cv + c;
  V* ob = out + row_at;
  const float count = (float)(s * s);
  for (int pw = 0; pw < pw_count; ++pw) {
    float acc[kCh];
#pragma unroll
    for (int e = 0; e < kCh; ++e) acc[e] = 0.0f;
    for (int iy = 0; iy < s; ++iy) {
      const Tap ty = yt[warp * s + iy];
      const V* row_lo = fb + (size_t)ty.lo * w * cv;
      const V* row_hi = fb + (size_t)ty.hi * w * cv;
      for (int ix = 0; ix < s; ++ix) {
        const Tap tx = xt[pw * s + ix];
        float a[kCh], bb[kCh], lo[kCh], hi[kCh];
        widen(__ldg(row_lo + (size_t)tx.lo * cv), a);
        widen(__ldg(row_hi + (size_t)tx.lo * cv), bb);
#pragma unroll
        for (int e = 0; e < kCh; ++e) lo[e] = a[e] * ty.w_lo + bb[e] * ty.w_hi;
        widen(__ldg(row_lo + (size_t)tx.hi * cv), a);
        widen(__ldg(row_hi + (size_t)tx.hi * cv), bb);
#pragma unroll
        for (int e = 0; e < kCh; ++e) hi[e] = a[e] * ty.w_lo + bb[e] * ty.w_hi;
#pragma unroll
        for (int e = 0; e < kCh; ++e) acc[e] = acc[e] + (lo[e] * tx.w_lo + hi[e] * tx.w_hi);
      }
    }
    float o[kCh];
#pragma unroll
    for (int e = 0; e < kCh; ++e) o[e] = acc[e] / count;
    store_cs(ob + (size_t)pw * cv, o);
  }
}

template <int S, typename Rule, typename V>
int launch_fwd_bf16_s(const FwdPlan& p, const V* feat, const float* rois, const float* valid_hw,
                      int b, int h, int w, int cv, int r, int ph, int pw, float scale, V* out,
                      cudaStream_t stream) {
  auto kernel = roi_align_fwd_bf16_kernel<S, Rule, V>;
  if (const int rc = set_smem(kernel, p.smem)) return rc;
  const dim3 grid(r, p.slices * p.groups, b);
  kernel<<<grid, dim3(kLanes, kFwdWarps), p.smem, stream>>>(feat, rois, valid_hw, h, w, cv, r, ph,
                                                            pw, p.groups, scale, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename Rule, typename V>
int launch_fwd_bf16(const FwdPlan& p, const void* feat, const float* rois, const float* valid_hw,
                    int b, int h, int w, int c, int r, int ph, int pw, int s, float scale,
                    void* out, cudaStream_t stream) {
  const int cv = c / LaneOf<V>::kCh;
  const V* fv = static_cast<const V*>(feat);
  V* ov = static_cast<V*>(out);
#define FWD_BF16_S(S)                                                                      \
  case S:                                                                                  \
    return launch_fwd_bf16_s<S, Rule, V>(p, fv, rois, valid_hw, b, h, w, cv, r, ph, pw, scale, \
                                         ov, stream);
  switch (s) {
    FWD_BF16_S(1)
    FWD_BF16_S(2)
    FWD_BF16_S(3)
    FWD_BF16_S(4)
    default: break;
  }
#undef FWD_BF16_S
  static_assert(kFwdMaxS == 4, "launch_fwd_bf16 compiles in s = 1..4");
  auto kernel = roi_align_fwd_bf16_any_s_kernel<Rule, V>;
  if (const int rc = set_smem(kernel, p.smem)) return rc;
  const dim3 grid(r, p.slices * p.groups, b);
  kernel<<<grid, dim3(kLanes, kFwdWarps), p.smem, stream>>>(fv, rois, valid_hw, h, w, cv, r, ph,
                                                            pw, s, p.groups, scale, ov);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 forward under the tap rule Rule on `stream` (valid_hw is read
// under ResidentTaps only).  Returns a cudaError_t.
template <typename Rule>
int roi_align_fwd_bf16_launch(const void* feat, const float* rois, const float* valid_hw, int b,
                              int h, int w, int c, int r, int ph, int pw, int s, float scale,
                              void* out, cudaStream_t stream) {
  FwdPlan p;
  if (const int rc = fwd_bf16_plan(b, h, w, c, r, ph, pw, s, &p)) return rc;
  if (p.blocks == 0 || pw == 0) return 0;
  // the kernels address an image's vectors with 32-bit offsets
  if ((long long)h * w * (c / (p.vec_bytes / 2)) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.vec_bytes == 16) {
    return launch_fwd_bf16<Rule, uint4>(p, feat, rois, valid_hw, b, h, w, c, r, ph, pw, s, scale,
                                        out, stream);
  }
  return launch_fwd_bf16<Rule, uint2>(p, feat, rois, valid_hw, b, h, w, c, r, ph, pw, s, scale,
                                      out, stream);
}

}  // namespace
