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
// Two launches.  roi_table_kernel, one block per (roi, image), writes each
// roi's table once into a scratch the wrapper allocates: for each axis the
// (cell, bin, weight) entries of its taps, a bin's s samples merged per cell
// and sorted by cell (at most 2 * s * bins entries), the offsets of each
// cell's first entry, and the extent of the cells the entries touch (empty
// for an inverted roi, which adds nothing).  The tile kernel gives one block
// a 2-row x 8-column tile of dfeat and a 128-channel slice, four warps a
// row; it ballots once over the rois' extents for those that meet the tile,
// and from then on each warp works alone, with no barrier, on every fourth
// of them (r % 4) for its row: for each such roi in roi order it stages its
// row's entries (ph, wy) and the tile's column entries (x, pw, wx) in its
// own shared memory, then walks the (column entry, row entry) pairs with
// kBatch loads of g in flight, t = sum over the row entries of
// g[r, ph, pw] * wy, and adds t * wx into the float4 of cell x that the
// lane owns in the warp's partial sums (8 cells x 128 channels, 4 KB).
// After one barrier each warp writes two of its row's cells, the four
// partial sums added in warp order.  Every cell is written once: no zero
// fill, no atomics, and a fixed sum order (rois, then column entries, then
// row entries, then parts), so two launches give bit-identical dfeat (the
// TPU kernel's dfeat-stationary grid gives the same).
// Bound on the H100: g read once and dfeat written once (25.7 MB + 39.8 MB
// at P2, 19.6 us at 3.35 TB/s).  What sets the time is the longest chain of
// dependent g loads from L2 that one warp makes: the train step's rois
// cluster, so the rows under the cluster meet ~100 small rois, each pairing
// up to ph row entries with up to 2 * s * pw column entries.  Narrow tiles
// cut each visit's pairs, four warps a row cut each warp's visits, and the
// batches keep kBatch loads in flight in each chain; 37 KB of shared memory
// a block lets several blocks share an SM.

#include <cuda_runtime.h>

#include "roi_align_taps.cuh"

namespace {

constexpr int kLanes = 32;  // float4 lanes: one warp spans 128 channels
constexpr int kWarps = 8;
constexpr int kMaxPwPerThread = 4;  // forward: PW <= kWarps * this
constexpr int kSplit = 4;           // backward: warps a tile row, each taking every kSplit-th roi
constexpr int kTileH = kWarps / kSplit;
constexpr int kTileW = 8;
constexpr int kBatch = 8;           // backward: loads of g in flight a warp

struct Roi {
  float x1, y1, x2, y2;
};

__device__ __forceinline__ Roi scaled_roi(const float* __restrict__ rois, int b,
                                          int r, int r_count, float scale) {
  const float* roi = rois + ((size_t)b * r_count + r) * 4;
  return Roi{roi[0] * scale, roi[1] * scale, roi[2] * scale, roi[3] * scale};
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

// One entry of a roi's table: the summed weight of a bin's samples on a cell.
struct Entry {
  short cell, bin;
  float w;
};

// A roi's table in the scratch, at these byte offsets of its record: the
// entries' cell extent (int4 ylo, yhi, xlo, xhi; yhi < ylo when the roi adds
// nothing), the entries along y then x (2 * s * bins slots each, sorted by
// cell, then bin), and per axis the number of entries before each cell
// (size + 1 shorts).
struct TableLayout {
  size_t ye, xe, yoff, xoff, bytes;
  __host__ __device__ TableLayout(int h, int w, int ph, int pw, int s) {
    ye = sizeof(int4);
    xe = ye + sizeof(Entry) * 2 * s * ph;
    yoff = xe + sizeof(Entry) * 2 * s * pw;
    xoff = yoff + sizeof(short) * (h + 1);
    bytes = (xoff + sizeof(short) * (w + 1) + 15) / 16 * 16;
  }
};

template <typename T>
__device__ __forceinline__ T* at(char* rec, size_t off) {
  return reinterpret_cast<T*>(rec + off);
}

template <typename T>
__device__ __forceinline__ const T* at(const char* rec, size_t off) {
  return reinterpret_cast<const T*>(rec + off);
}

// The entries of one axis from its n = bins * s taps, sorted by (cell, bin)
// with equal keys summed: the taps' lower cells (with w_lo) and upper cells
// (with w_hi) are each sorted by (cell, bin), since the samples' positions
// do not decrease along k, so one merge of the two lists orders them.
__device__ int merge_entries(const Tap* t, int n, int s, Entry* out) {
  int i = 0, j = 0, m = 0;
  while (i < n || j < n) {
    const bool lower = j >= n || (i < n && (t[i].lo < t[j].hi ||
                                            (t[i].lo == t[j].hi && i / s <= j / s)));
    const int cell = lower ? t[i].lo : t[j].hi, bin = lower ? i / s : j / s;
    const float wt = lower ? t[i].w_lo : t[j].w_hi;
    if (lower) ++i; else ++j;
    if (m > 0 && out[m - 1].cell == cell && out[m - 1].bin == bin) {
      out[m - 1].w += wt;
    } else {
      out[m++] = Entry{(short)cell, (short)bin, wt};
    }
  }
  return m;
}

constexpr int kTableThreads = 64;

__global__ void __launch_bounds__(kTableThreads)
roi_table_kernel(const float* __restrict__ rois, int h, int w, int r_count,
                 int ph_count, int pw_count, int s, float scale, char* __restrict__ table) {
  const int r = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const TableLayout lay(h, w, ph_count, pw_count, s);
  char* rec = table + ((size_t)b * r_count + r) * lay.bytes;
  extern __shared__ float4 smem[];
  Tap* yt = reinterpret_cast<Tap*>(smem);                 // [ph_count * s]
  Tap* xt = yt + ph_count * s;                            // [pw_count * s]
  Entry* ye = reinterpret_cast<Entry*>(xt + pw_count * s);  // [2 * s * ph_count]
  Entry* xe = ye + 2 * s * ph_count;                      // [2 * s * pw_count]
  __shared__ int count[2];

  const Roi q = scaled_roi(rois, b, r, r_count, scale);
  const bool valid = q.x2 >= q.x1;  // uniform: every thread takes the same branch
  const int ny = ph_count * s, nx = pw_count * s;
  if (valid) {
    roi_taps(q, h, w, ph_count, pw_count, s, xt, yt, tid, kTableThreads);
    __syncthreads();
    if (tid == 0) count[0] = merge_entries(yt, ny, s, ye);
    if (tid == 32) count[1] = merge_entries(xt, nx, s, xe);
    __syncthreads();
  } else if (tid == 0) {
    count[0] = count[1] = 0;
  }
  __syncthreads();
  const int cy = count[0], cx = count[1];
  for (int i = tid; i < cy; i += kTableThreads) at<Entry>(rec, lay.ye)[i] = ye[i];
  for (int i = tid; i < cx; i += kTableThreads) at<Entry>(rec, lay.xe)[i] = xe[i];
  // offsets: the entries of a cell before it (a lower bound over the cells)
  for (int i = tid; i < h + 1 + w + 1; i += kTableThreads) {
    const bool along_y = i < h + 1;
    const int cell = along_y ? i : i - (h + 1), n = along_y ? cy : cx;
    const Entry* e = along_y ? ye : xe;
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (e[mid].cell < cell) lo = mid + 1; else hi = mid;
    }
    at<short>(rec, along_y ? lay.yoff : lay.xoff)[cell] = (short)lo;
  }
  if (tid == 0) {
    *at<int4>(rec, 0) = (cy > 0 && cx > 0)
                        ? make_int4(ye[0].cell, ye[cy - 1].cell, xe[0].cell, xe[cx - 1].cell)
                        : make_int4(0, -1, 0, -1);
  }
}

static_assert(kWarps % kSplit == 0 && kTileW % kSplit == 0 && 32 % kSplit == 0, "split");

// Shared memory of the tile kernel: the warps' accumulators, their staged
// entries (a row has at most ph entries, the tile's columns at most
// 2 * s * pw), the tile's roi bits.
__host__ __device__ inline size_t stage_entries(int ph, int pw, int s) {
  return ph + 2 * s * pw;
}

__host__ __device__ inline size_t tile_smem(int r, int ph, int pw, int s) {
  return sizeof(float4) * kWarps * kTileW * kLanes +
         sizeof(Entry) * kWarps * stage_entries(ph, pw, s) + sizeof(unsigned) * ((r + 31) / 32);
}

__global__ void __launch_bounds__(kLanes * kWarps, 3)
roi_align_stream_bwd_kernel(const float4* __restrict__ g, const char* __restrict__ table,
                            int h, int w, int c4, int n_cs, int r_count, int ph_count,
                            int pw_count, int s, float4* __restrict__ dfeat) {
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z / n_cs;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int row = warp / kSplit, part = warp % kSplit;
  const int c = (blockIdx.z % n_cs) * kLanes + lane;
  const bool has_c = c < c4;
  const TableLayout lay(h, w, ph_count, pw_count, s);
  const size_t rec_bytes = lay.bytes;
  const char* tb = table + (size_t)b * r_count * rec_bytes;

  extern __shared__ float4 smem[];
  // this warp's part of its row's sums, [kTileW][kLanes]; the row's parts
  // are warps row * kSplit .. row * kSplit + kSplit - 1
  float4* acc = smem + warp * kTileW * kLanes;
  const int n_stage = stage_entries(ph_count, pw_count, s);
  Entry* ys = reinterpret_cast<Entry*>(smem + kWarps * kTileW * kLanes) + warp * n_stage;
  Entry* xs = ys + ph_count;
  unsigned* hits = reinterpret_cast<unsigned*>(
      reinterpret_cast<Entry*>(smem + kWarps * kTileW * kLanes) + kWarps * n_stage);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int xl = 0; xl < kTileW; ++xl) acc[xl * kLanes + lane] = zero;

  // the rois whose entries meet the tile, one bit each
  const int words = (r_count + 31) / 32;
  for (int wd = warp; wd < words; wd += kWarps) {
    const int r = wd * 32 + lane;
    bool hit = false;
    if (r < r_count) {
      const int4 e = *at<int4>(tb + r * rec_bytes, 0);
      hit = e.x < y0 + kTileH && e.y >= y0 && e.z < x0 + kTileW && e.w >= x0;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) hits[wd] = bits;
  }
  __syncthreads();

  const int y = y0 + row;
  const int x_end = min(x0 + kTileW, w);
  // a lane past the channels loads channel c4 - 1 and writes nothing, so
  // that every lane takes part in staging the entries
  const float4* gb = g + (size_t)b * r_count * ph_count * pw_count * c4 + min(c, c4 - 1);
  // this warp's rois: r % kSplit == part (32 % kSplit == 0)
  unsigned mine = 0;
  for (int l = part; l < 32; l += kSplit) mine |= 1u << l;
  for (int wd = 0; wd < words && y < h; ++wd) {
    for (unsigned bits = hits[wd] & mine; bits; bits &= bits - 1) {
      const int r = wd * 32 + __ffs(bits) - 1;
      const char* rec = tb + r * rec_bytes;
      const short* yoff = at<short>(rec, lay.yoff);
      const short* xoff = at<short>(rec, lay.xoff);
      const int ey0 = yoff[y], ny = yoff[y + 1] - ey0;
      const int ex0 = xoff[x0], nx = xoff[x_end] - ex0;
      if (ny == 0 || nx == 0) continue;
      __syncwarp();  // the last visit's reads of the staged entries are done
      for (int k = lane; k < ny; k += kLanes) ys[k] = at<Entry>(rec, lay.ye)[ey0 + k];
      for (int k = lane; k < nx; k += kLanes) xs[k] = at<Entry>(rec, lay.xe)[ex0 + k];
      __syncwarp();
      // the (column entry, row entry) pairs in order, kBatch loads of g in
      // flight at a time: t sums a column entry's terms over the row's
      // entries, then goes into its cell once
      const float4* gr = gb + (size_t)r * ph_count * pw_count * c4;
      const int n = ny * nx;
      int i = 0, j = 0;
      float4 t = zero;
      for (int base = 0; base < n; base += kBatch) {
        float4 v[kBatch];
        int li = i, lj = j;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (base + u < n) {
            v[u] = gr[((size_t)ys[li].bin * pw_count + xs[lj].bin) * c4];
            if (++li == ny) li = 0, ++lj;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (base + u < n) {
            t = add4(t, scale4(v[u], ys[i].w));
            if (++i == ny) {
              float4* a = acc + (xs[j].cell - x0) * kLanes + lane;
              *a = add4(*a, scale4(t, xs[j].w));
              t = zero, i = 0, ++j;
            }
          }
        }
      }
    }
  }

  // each warp of a row writes kTileW / kSplit of its cells, the row's
  // parts summed in order
  __syncthreads();
  if (!has_c || y >= h) return;
  const float count = (float)(s * s);
  const float4* parts = smem + row * kSplit * kTileW * kLanes + lane;
  float4* out = dfeat + ((size_t)b * h + y) * w * c4 + c;
  constexpr int kCells = kTileW / kSplit;
  for (int xl = part * kCells; xl < (part + 1) * kCells && x0 + xl < w; ++xl) {
    float4 v = parts[xl * kLanes];
    for (int k = 1; k < kSplit; ++k) v = add4(v, parts[(k * kTileW + xl) * kLanes]);
    out[(size_t)(x0 + xl) * c4] = make_float4(v.x / count, v.y / count, v.z / count, v.w / count);
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

// Bytes of the scratch roi_align_stream_bwd takes: one table per (image, roi).
extern "C" long long roi_align_stream_bwd_scratch_bytes(int b, int h, int w, int r,
                                                        int ph, int pw, int s) {
  return (long long)b * r * TableLayout(h, w, ph, pw, s).bytes;
}

// g (B, R, PH, PW, C) f32 with C % 4 == 0, rois (B, R, 4) f32 -> dfeat
// (B, H, W, C) f32, every element written (no zero fill needed); scratch:
// roi_align_stream_bwd_scratch_bytes of device memory.  Launches on
// `stream`, returns a cudaError_t.
extern "C" int roi_align_stream_bwd(const float* g, const float* rois, int b,
                                    int h, int w, int c, int r, int ph, int pw,
                                    int s, float scale, void* scratch, float* dfeat,
                                    void* stream) {
  if (b == 0 || h == 0 || w == 0 || c == 0) return 0;
  // the table's cells, bins and offsets are shorts
  if (h >= 32767 || w >= 32767 || 2 * s * max(ph, pw) >= 32767) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* table = static_cast<char*>(scratch);
  if (r > 0) {
    const size_t smem = (sizeof(Tap) + 2 * sizeof(Entry)) * (ph + pw) * s;
    if (const int rc = set_smem(roi_table_kernel, smem)) return rc;
    roi_table_kernel<<<dim3(r, b), kTableThreads, smem, st>>>(rois, h, w, r, ph, pw, s,
                                                              scale, table);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int c4 = c / 4, n_cs = (c4 + kLanes - 1) / kLanes;
  const size_t smem = tile_smem(r, ph, pw, s);
  if (const int rc = set_smem(roi_align_stream_bwd_kernel, smem)) return rc;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b * n_cs);
  roi_align_stream_bwd_kernel<<<grid, dim3(kLanes, kWarps), smem, st>>>(
      reinterpret_cast<const float4*>(g), table, h, w, c4, n_cs, r, ph, pw, s,
      reinterpret_cast<float4*>(dfeat));
  return static_cast<int>(cudaGetLastError());
}
