// The deterministic ROIAlign backward shared by kernel 3 (roi_align.cu, the
// resident maps) and kernel 5 (roi_align_stream.cu, FPN's P2/P3): owner
// computes, no atomics.
//
// Two launches.  roi_table_kernel, one block per (roi, image), writes each
// roi's table once into a scratch the wrapper allocates: for each axis the
// (cell, bin, weight) entries of its taps, a bin's s samples merged per cell
// and sorted by cell (at most 2 * s * bins entries), the offsets of each
// cell's first entry, and the extent of the cells the entries touch.  The
// tap rule is a template parameter: kernel 5's (canvas clamp; an inverted
// roi, scaled x2 < x1, gets an empty table and adds nothing) or kernel 3's
// (no skip: width and height floored at 1, so an inverted roi taps the cells
// at its clamped x1/y1; the optional valid_hw clamp).
//
// The tile kernel gives one block (or a cluster of kGroups blocks) a
// kTileH x kTileW tile of dfeat and a 128-channel slice, kSplit warps a tile
// row (kTileH = 8 / kSplit); it ballots once over the rois' extents for
// those that meet the tile, and from then on each warp works alone, with no
// barrier, on every (kSplit * kGroups)-th of them for its row: for each such
// roi in roi order it stages its row's entries (ph, wy) and the tile's
// column entries (x, pw, wx) in its own shared memory, orders the column
// entries by bin, then walks the (bin, row entry) pairs with kBatch loads of
// g in flight: t = sum over the row entries of g[r, ph, pw] * wy, added as
// t * wx into the float4 of each cell x of the tile that bin pw touches, in
// the warp's partial sums (kTileW cells x 128 channels).  A cell's entries
// are sorted by bin, so it takes its terms in the order of its entries, and
// each g element a visit needs is loaded once.
// The cotangent g is float32 (the element type V, four channels a lane; a
// bfloat16 g goes to roi_align_bwd_bf16.cuh); the sums and dfeat are float32.
// After one barrier (a cluster barrier for kGroups > 1) each cell is
// written once, its partial sums added in block order, then warp order, and
// divided by s * s.  No zero fill, no atomics, and a fixed sum order (rois,
// then column entries, then row entries, then parts), so two launches give
// bit-identical dfeat (the TPU kernels' dfeat-stationary grid gives the
// same).
//
// What sets the time is the longest chain of dependent g loads from L2 that
// one warp makes: the train step's rois cluster, so the rows under the
// cluster meet most of them.  Narrow tiles cut each visit's pairs, more
// warps (and blocks) a row cut each warp's visits, the walk by bin cuts
// the loads, and the batches keep kBatch loads in flight in each chain.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "roi_align_taps.cuh"

namespace {

constexpr int kWarps = 8;   // warps of a tile block
constexpr int kBatch = 8;   // loads of g in flight a warp

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
// do not decrease along k, so one merge of the two lists orders them.  One
// thread runs it: the heads of both lists and the entry being summed stay
// in registers, and the bins are counted, not divided out.
__device__ int merge_entries(const Tap* t, int n, int s, Entry* out) {
  if (n == 0) return 0;
  int i = 0, j = 0, bi = 0, bj = 0, ri = 0, rj = 0, m = 0;
  Tap ti = t[0], tj = t[0];
  Entry cur{-1, -1, 0.0f};
  while (i < n || j < n) {
    const bool lower = j >= n || (i < n && (ti.lo < tj.hi || (ti.lo == tj.hi && bi <= bj)));
    int cell, bin;
    float wt;
    if (lower) {
      cell = ti.lo, bin = bi, wt = ti.w_lo;
      if (++i < n) ti = t[i];
      if (++ri == s) ri = 0, ++bi;
    } else {
      cell = tj.hi, bin = bj, wt = tj.w_hi;
      if (++j < n) tj = t[j];
      if (++rj == s) rj = 0, ++bj;
    }
    if (m > 0 && cur.cell == cell && cur.bin == bin) {
      cur.w += wt;
    } else {
      if (m > 0) out[m - 1] = cur;
      cur = Entry{(short)cell, (short)bin, wt};
      ++m;
    }
  }
  out[m - 1] = cur;
  return m;
}

constexpr int kTableThreads = 64;

template <typename Rule>
__global__ void __launch_bounds__(kTableThreads)
roi_table_kernel(const float* __restrict__ rois, const float* __restrict__ valid_hw, int h,
                 int w, int r_count, int ph_count, int pw_count, int s, float scale,
                 char* __restrict__ table) {
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
  // uniform: every thread takes the same branch
  const bool taps = Rule::kResident || q.x2 >= q.x1;
  const int ny = ph_count * s, nx = pw_count * s;
  if (taps) {
    float lim_hf, lim_wf;
    tap_limits(Rule::kResident ? valid_hw : nullptr, b, scale, h, w, &lim_hf,
               &lim_wf);
    roi_taps(q, lim_hf, lim_wf, h, w, ph_count, pw_count, s, xt, yt, tid, kTableThreads);
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

// Shared memory of the tile kernel: the warps' accumulators, their staged
// entries (a row has at most ph entries, the tile's columns at most
// 2 * s * pw, staged once by cell and once by bin, and the pw + 1 starts of
// their bins' runs), the tile's roi bits.
__host__ __device__ inline size_t stage_entries(int ph, int pw, int s) {
  return ph + 4 * s * pw + (pw + 2) / 2;
}

template <int kTileW>
__host__ __device__ inline size_t tile_smem(int r, int ph, int pw, int s) {
  return sizeof(float4) * kWarps * kTileW * kLanes +
         sizeof(Entry) * kWarps * stage_entries(ph, pw, s) +
         sizeof(unsigned) * ((r + 31) / 32);
}

// Rule only names the instance (the tables hold what it decides).  With
// kGroups > 1 the launch is a thread block cluster of kGroups blocks on one
// tile, each on its own share of the tile's rois; after a cluster barrier the
// cluster's warps of a row each write one of the row's cells, summing the
// blocks' partial sums (read through distributed shared memory) in block
// order, then the row's parts in warp order.
template <typename Rule, int kSplit, int kTileW, int kGroups, typename V>
__global__ void __launch_bounds__(kLanes * kWarps, 3)
roi_align_tile_bwd_kernel(const V* __restrict__ g, const char* __restrict__ table,
                          int h, int w, int c4, int n_cs, int r_count, int ph_count,
                          int pw_count, int s, float4* __restrict__ dfeat) {
  constexpr int kWorkers = kSplit * kGroups;  // warps of the cluster on one tile row
  static_assert(kWarps % kSplit == 0 && kTileW % kSplit == 0 && 32 % kWorkers == 0, "split");
  static_assert(kGroups == 1 || kWorkers >= kTileW, "a cluster's row writes a cell a warp");
  constexpr int kTileH = kWarps / kSplit;
  const int group = kGroups > 1 ? (int)(blockIdx.x % kGroups) : 0;
  const int x0 = blockIdx.x / kGroups * kTileW, y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z / n_cs;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int row = warp / kSplit, part = warp % kSplit;
  const int worker = group * kSplit + part;  // of the row's kWorkers
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
  Entry* xb = xs + 2 * s * pw_count;                        // xs by (bin, cell)
  int* gs = reinterpret_cast<int*>(xb + 2 * s * pw_count);  // the bins' runs' starts
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
  const V* gb = g + (size_t)b * r_count * ph_count * pw_count * c4 + min(c, c4 - 1);
  // this warp's rois: r % kWorkers == worker (32 % kWorkers == 0)
  unsigned mine = 0;
  for (int l = worker; l < 32; l += kWorkers) mine |= 1u << l;
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
      const V* gr = gb + (size_t)r * ph_count * pw_count * c4;
      // xs by (bin, cell): an entry's rank counts the entries before it
      for (int k = lane; k < nx; k += kLanes) {
        const int bk = xs[k].bin;
        int pos = 0;
        for (int e = 0; e < nx; ++e) {
          const int be = xs[e].bin;
          pos += be < bk || (be == bk && e < k);
        }
        xb[pos] = xs[k];
      }
      __syncwarp();
      // where each bin's run starts, in order
      int ng = 0;
      for (int k0 = 0; k0 < nx; k0 += kLanes) {
        const int k = k0 + lane;
        const bool start = k < nx && (k == 0 || xb[k].bin != xb[k - 1].bin);
        const unsigned m = __ballot_sync(0xffffffffu, start);
        if (start) gs[ng + __popc(m & ((1u << lane) - 1))] = k;
        ng += __popc(m);
      }
      if (lane == 0) gs[ng] = nx;
      __syncwarp();
      // the (bin, row entry) pairs in order, kBatch loads of g in flight
      // at a time: t sums a bin's terms over the row's entries, then goes
      // into each of the bin's cells once
      const int n = ny * ng;
      int i = 0, j = 0;
      float4 t = zero;
      for (int base = 0; base < n; base += kBatch) {
        float4 v[kBatch];
        int li = i, lj = j;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (base + u < n) {
            v[u] = load4(gr + ((size_t)ys[li].bin * pw_count + xb[gs[lj]].bin) * c4);
            if (++li == ny) li = 0, ++lj;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (base + u < n) {
            t = add4(t, scale4(v[u], ys[i].w));
            if (++i == ny) {
              for (int e = gs[j]; e < gs[j + 1]; ++e) {
                float4* a = acc + (xb[e].cell - x0) * kLanes + lane;
                *a = add4(*a, scale4(t, xb[e].w));
              }
              t = zero, i = 0, ++j;
            }
          }
        }
      }
    }
  }

  const float count = (float)(s * s);
  float4* out = dfeat + ((size_t)b * h + y) * w * c4 + c;
  const int row_parts = row * kSplit * kTileW * kLanes + lane;
  if constexpr (kGroups == 1) {
    // each warp of a row writes kTileW / kSplit of its cells, the row's
    // parts summed in order
    __syncthreads();
    if (!has_c || y >= h) return;
    const float4* parts = smem + row_parts;
    constexpr int kCells = kTileW / kSplit;
    for (int xl = part * kCells; xl < (part + 1) * kCells && x0 + xl < w; ++xl) {
      float4 v = parts[xl * kLanes];
      for (int k = 1; k < kSplit; ++k) v = add4(v, parts[(k * kTileW + xl) * kLanes]);
      out[(size_t)(x0 + xl) * c4] = make_float4(v.x / count, v.y / count, v.z / count, v.w / count);
    }
  } else {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's partial sums are done
    const int xl = worker;
    if (has_c && y < h && xl < kTileW && x0 + xl < w) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        const float4* parts = cluster.map_shared_rank(smem, gi) + row_parts;
#pragma unroll
        for (int k = 0; k < kSplit; ++k) {
          const float4 p = parts[(k * kTileW + xl) * kLanes];
          v = gi == 0 && k == 0 ? p : add4(v, p);
        }
      }
      out[(size_t)(x0 + xl) * c4] = make_float4(v.x / count, v.y / count, v.z / count, v.w / count);
    }
    cluster.sync();  // no block leaves while another reads its shared memory
  }
}

// Bytes of the scratch table_bwd takes: one table per (image, roi).
inline long long table_scratch_bytes(int b, int h, int w, int r, int ph, int pw, int s) {
  return (long long)b * r * TableLayout(h, w, ph, pw, s).bytes;
}

// The table launch on `stream`: one table per (image, roi) into `table`
// (valid_hw is read under ResidentTaps only).  Returns a cudaError_t.
template <typename Rule>
int launch_roi_tables(const float* rois, const float* valid_hw, int b, int h, int w, int r,
                      int ph, int pw, int s, float scale, char* table, cudaStream_t stream) {
  const size_t smem = (sizeof(Tap) + 2 * sizeof(Entry)) * (ph + pw) * s;
  if (const int rc = set_smem(roi_table_kernel<Rule>, smem)) return rc;
  roi_table_kernel<Rule><<<dim3(r, b), kTableThreads, smem, stream>>>(
      rois, valid_hw, h, w, r, ph, pw, s, scale, table);
  return static_cast<int>(cudaGetLastError());
}

// Both launches of the backward on `stream`: the tables (valid_hw is read
// under ResidentTaps only), then the tiles, in clusters of kGroups blocks a
// tile when kGroups > 1, reading g of the element type V (float4: f32).
// Every dfeat element is written.  Returns a cudaError_t.
template <typename Rule, int kSplit, int kTileW, int kGroups, typename V>
int table_bwd(const void* g, const float* rois, const float* valid_hw, int b, int h, int w,
              int c, int r, int ph, int pw, int s, float scale, void* scratch, float* dfeat,
              cudaStream_t stream) {
  if (b == 0 || h == 0 || w == 0 || c == 0) return 0;
  // the table's cells, bins and offsets are shorts
  if (h >= 32767 || w >= 32767 || 2 * s * max(ph, pw) >= 32767) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  char* table = static_cast<char*>(scratch);
  if (r > 0) {
    if (const int rc = launch_roi_tables<Rule>(rois, valid_hw, b, h, w, r, ph, pw, s, scale,
                                               table, stream)) {
      return rc;
    }
  }
  constexpr int kTileH = kWarps / kSplit;
  const int c4 = c / 4, n_cs = (c4 + kLanes - 1) / kLanes;
  const size_t smem = tile_smem<kTileW>(r, ph, pw, s);
  auto kernel = roi_align_tile_bwd_kernel<Rule, kSplit, kTileW, kGroups, V>;
  if (const int rc = set_smem(kernel, smem)) return rc;
  const dim3 grid((w + kTileW - 1) / kTileW * kGroups, (h + kTileH - 1) / kTileH, b * n_cs);
  const V* g4 = static_cast<const V*>(g);
  float4* d4 = reinterpret_cast<float4*>(dfeat);
  if constexpr (kGroups == 1) {
    kernel<<<grid, dim3(kLanes, kWarps), smem, stream>>>(g4, table, h, w, c4, n_cs, r, ph, pw,
                                                         s, d4);
    return static_cast<int>(cudaGetLastError());
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kLanes, kWarps);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kGroups;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, g4, table, h, w, c4, n_cs, r, ph,
                                               pw, s, d4));
  }
}

}  // namespace
