// The deterministic ROIAlign backward of a bfloat16 cotangent, shared by
// kernel 3's bf16 instance (roi_align.cu, the resident maps, ResidentTaps)
// and kernel 5's (roi_align_stream.cu, FPN's P2/P3, StreamTaps).
//
// Replaces mx_rcnn_tpu/ops/pallas/roi_align.py:148 (_bwd_kernel, called by
// _roi_align_bwd_impl, pallas_call at :342) and
// mx_rcnn_tpu/ops/pallas/roi_align_stream.py:164 (_bwd_kernel, called by
// _bwd_impl, pallas_call at :297) on a bf16 g: dfeat = (1 / s^2) sum over
// rois r and bins (ph, pw) of Wy_r[y, ph] * Wx_r[x, pw] * g[r, ph, pw, c],
// under the tap rules of roi_align_taps.cuh (the per-roi tables of
// roi_table_kernel, roi_align_table.cuh, hold what a rule decides).  The
// sums are float32, taken in a fixed order, with no atomics; dfeat is bf16,
// each cell's float32 sum rounded once, to nearest even, as it is stored
// (the TPU kernel casts its float32 accumulator outside, roi_align.py:367,
// roi_align_stream.py:316).  An instance with a float32 epilogue stores the
// same sums unrounded: a measuring aid for the gates, on no path.
//
// Bound on the H100: g read once and the bf16 dfeat written once over
// 3.35 TB/s (C4 train, g 1x128x14x14x1024 and dfeat 1x38x64x1024: 56.4 MB,
// 0.0168 ms; mask P2, R = 128: 32.8 MB, 0.0098 ms).
//
// Design.  A block owns a tile of dfeat, tile_h x kCols cells and up to 1024
// channels (all of them at C <= 1024), and sums the rois that meet it in roi
// order; with kGroups > 1 a cluster of kGroups blocks shares a tile, block k
// taking the rois r % kGroups == k, and the blocks add their partial sums
// through distributed shared memory in block order.  Eight consumer warps
// each hold kRows x kCols cells of one 128-channel slice in registers (a
// lane: four channels); a ninth warp, the producer, runs ahead of them:
//  - it copies each roi's table record (its entries by cell and the cells'
//    offsets) into a ring of shared-memory slots with bulk asynchronous
//    copies, kRecSlots rois ahead, and works out the roi's part in the tile
//    from shared memory once per (roi, tile): the rows' entries, the columns'
//    compact weights and the bins they span (a cell's bins are contiguous,
//    so its entries sorted by cell, then bin, need no sort);
//  - it stages the roi's sub-block the tile needs, g[r, ph0..ph1, pw0..pw1,
//    the channels] (the bin rows the tile's rows touch, the bins its
//    columns touch), into a ring of shared-memory stages, as many bin rows
//    a stage as fit, by bulk asynchronous copies (cp.async.bulk: one a bin
//    row, whose bins are one run with all channels in the block), with the
//    stage's weights in a header; completion is signalled on an mbarrier
//    (full), the consumers free a stage on another (empty).
// A consumer warp takes each staged bin row its cells' rows touch: it
// first contracts over pw, u[x] = sum of Wx[x, pw] g[ph, pw] over the
// column's bins, then adds Wy[y, ph] u[x] into each of its cells, both
// with explicit fused multiply-adds (__fmaf_rn; the build keeps -fmad=false
// for the NMS): per cell, rois in order, then bin rows in order, then
// columns' bins in order.  The epilogue writes every cell once.  A tile no
// roi meets writes zeros and stages nothing.  C % 8 != 0 breaks the 16-byte
// alignment bulk copies need: there the producer copies the rows with
// 8-byte loads and stores, still ahead of the consumers.  A consumer on the
// tensor cores (mma.sync m16n8k16 of the staged g and the weights split
// into bf16 hi + lo) was timed against this one on the card: as fast at
// C = 1024, slower at C = 256 (PERF.md, section 6).
//
// What the design does about the costs of roi_align_table.cuh's tile walk
// (whose float4 instances stay the float32 backward): (1) no consumer waits on a
// dependent chain of global loads: the g rows and the table records arrive
// by asynchronous copies issued ahead, and the consumers read shared memory
// only; (2) g is widened from bf16 in registers after a shared-memory load,
// off any global load's path; (3) the bf16 rounding is the epilogue's, so no
// float32 dfeat is written and cast in a second pass, and tiles no roi meets
// cost their stores only; (4) the products are fused multiply-adds.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_align_table.cuh"

namespace {

constexpr int kStageWarps = 8;                   // consumer warps
constexpr int kStageThreads = (kStageWarps + 1) * kLanes;
constexpr int kRows = 2, kCols = 4;              // a consumer warp's cells
constexpr int kWarpCells = kRows * kCols;
constexpr int kMaxTileH = kRows * kStageWarps;   // one slice: 8 row groups
constexpr int kMaxStages = 8;
constexpr int kRecSlots = 4;                     // table records in flight
constexpr int kRingBudget = 96 * 1024;           // bytes of g stages a block
constexpr int kSmemLimit = 232448;               // a block's shared memory
constexpr long long kBlockTarget = 1024;         // blocks before clusters stop

// A stage's header: the roi (-1: no more), the bin rows staged (ph0 ..
// ph0 + nph - 1) and the bins (pw0 .. pw0 + npw - 1), and per column its
// first bin (from pw0), its count and where its weights start in the
// compact list.  After it: the tile rows' weights of the staged bin rows,
// wy[row * ph + k] (kMaxTileH * ph floats), then the compact list of the
// columns' weights (2 * s * pw floats at most).
struct StageHead {
  int r, ph0, nph, npw;
  int xs[kCols], xn[kCols], xo[kCols];
};

struct StageArgs {
  const __nv_bfloat16* g;
  const char* table;
  void* dfeat;
  int h, w, c, r, ph, pw, s;
  int n_sl;        // 128-channel slices a block (1, 2, 4 or 8)
  int tile_h;      // kRows * (kStageWarps / n_sl)
  int cb, cs;      // channels a block's group; a staged (ph, pw) row's stride
  int n_cg;        // channel groups
  int stages, stage_bytes, head_bytes;
  int rows_max;    // bin rows a stage holds at most, at npw = 1
  int off_hits, off_heads, off_recs, off_ring;
  int bulk;        // C % 8 == 0: bulk asynchronous copies of the g rows
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of this parity has completed; a phase
// that never completes (a fault in the protocol) traps after about 2^34
// cycles (~10 s) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One bulk asynchronous copy global -> shared (16-byte aligned, a multiple
// of 16 bytes), completing `bytes` of the barrier's expected transactions.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's earlier shared-memory reads before a later bulk copy
// into the same bytes.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ float4 fma4(float w, float4 v, float4 a) {
  return make_float4(__fmaf_rn(w, v.x, a.x), __fmaf_rn(w, v.y, a.y), __fmaf_rn(w, v.z, a.z),
                     __fmaf_rn(w, v.w, a.w));
}

// The tile's rois of this block, in roi order: those whose extent meets the
// tile and r % groups == group.
struct RoiCursor {
  const unsigned* hits;
  int words, wd;
  unsigned mine, bits;
  __device__ RoiCursor(const unsigned* h, int n, int group, int groups)
      : hits(h), words(n), wd(-1), mine(0), bits(0) {
    for (int l = group; l < 32; l += groups) mine |= 1u << l;
  }
  __device__ int next() {
    while (bits == 0) {
      if (++wd >= words) return -1;
      bits = hits[wd] & mine;
    }
    const int r = wd * 32 + __ffs(bits) - 1;
    bits &= bits - 1;
    return r;
  }
};

template <bool kF32Out>
__device__ __forceinline__ void store_cell(void* dfeat, size_t at4, float4 v) {
  if constexpr (kF32Out) {
    store4_cs(reinterpret_cast<float4*>(dfeat) + at4, v);
  } else {
    store4_cs(reinterpret_cast<uint2*>(dfeat) + at4, v);
  }
}

template <typename Rule, int kGroups, bool kF32Out>
__global__ void __launch_bounds__(kStageThreads, 2)
roi_align_stage_bwd_kernel(const StageArgs a) {
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int group = kGroups > 1 ? (int)(blockIdx.x % kGroups) : 0;
  const int x0 = blockIdx.x / kGroups * kCols, y0 = blockIdx.y * a.tile_h;
  const int b = blockIdx.z / a.n_cg, cg = blockIdx.z % a.n_cg;
  const int cbe = min(a.cb, a.c - cg * a.cb);  // this group's channels
  const TableLayout lay(a.h, a.w, a.ph, a.pw, a.s);
  const int rec_bytes = (int)lay.bytes;
  const char* tb = a.table + (size_t)b * a.r * lay.bytes;

  extern __shared__ float4 smem4[];  // the dynamic shared memory, as bytes below
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint64_t* rec_full = empty + kMaxStages;
  unsigned* hits = reinterpret_cast<unsigned*>(smem + a.off_hits);
  unsigned char* recs = smem + a.off_recs;
  unsigned char* ring = smem + a.off_ring;
  auto head = [&](int stage) {
    return reinterpret_cast<StageHead*>(smem + a.off_heads + stage * a.head_bytes);
  };

  if (warp == 0 && lane == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kStageWarps);
    }
    for (int i = 0; i < kRecSlots; ++i) mbar_init(rec_full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the rois whose entries' extent meets the tile, one bit each
  const int words = (a.r + 31) / 32;
  int hit_any = 0;
  for (int wd = warp; wd < words; wd += kStageWarps + 1) {
    const int r = wd * 32 + lane;
    bool hit = false;
    if (r < a.r) {
      const int4 e = *reinterpret_cast<const int4*>(tb + (size_t)r * lay.bytes);
      hit = e.x < y0 + a.tile_h && e.y >= y0 && e.z < x0 + kCols && e.w >= x0;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) hits[wd] = bits;
    hit_any |= bits != 0;
  }
  const bool any_roi = __syncthreads_or(hit_any) != 0;

  const int slice = warp % a.n_sl, row0 = warp / a.n_sl * kRows;
  const int cl = slice * 128 + lane * 4;  // the lane's first channel in the group
  const bool has_c = warp < kStageWarps && cl < cbe;
  const float count = (float)(a.s * a.s);
  auto cell_at = [&](int i, int j) {  // float4 index of cell (i, j), or -1
    const int y = y0 + row0 + i, x = x0 + j;
    if (!has_c || y >= a.h || x >= a.w) return (long long)-1;
    return ((((long long)b * a.h + y) * a.w + x) * a.c + cg * a.cb + cl) / 4;
  };

  if (!any_roi) {  // uniform over the cluster: its blocks share the tile
#pragma unroll
    for (int k = 0; k < kWarpCells; ++k) {
      const long long idx = cell_at(k / kCols, k % kCols);
      if (idx >= 0 && k % kGroups == group) {
        store_cell<kF32Out>(a.dfeat, (size_t)idx, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
      }
    }
    return;
  }

  float4 acc[kWarpCells];
#pragma unroll
  for (int k = 0; k < kWarpCells; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  if (warp == kStageWarps) {
    // ------------------------------------------------------------ producer
    RoiCursor ahead(hits, words, group, kGroups), cur(hits, words, group, kGroups);
    auto fetch = [&](int slot, int r) {  // the roi's table record into a slot
      if (lane == 0) {
        mbar_arrive_tx(rec_full + slot, rec_bytes);
        bulk_copy(recs + (size_t)slot * rec_bytes, tb + (size_t)r * rec_bytes, rec_bytes,
                  rec_full + slot);
      }
    };
    int issued = 0;
    for (; issued < kRecSlots; ++issued) {
      const int r = ahead.next();
      if (r < 0) break;
      fetch(issued, r);
    }
    const int nrows = min(a.tile_h, a.h - y0), ncols = min(kCols, a.w - x0);
    const size_t g_roi = (size_t)a.ph * a.pw * a.c;
    const __nv_bfloat16* gb = a.g + (size_t)b * a.r * g_roi + (size_t)cg * a.cb;
    int stage = 0;
    uint32_t parity = 0;
    for (int k = 0; k < issued; ++k) {
      const int slot = k % kRecSlots;
      mbar_wait(rec_full + slot, (k / kRecSlots) & 1);
      const int r = cur.next();
      const char* rec = reinterpret_cast<const char*>(recs + (size_t)slot * rec_bytes);
      const short* yoff = at<short>(rec, lay.yoff);
      const short* xoff = at<short>(rec, lay.xoff);
      const Entry* ye = at<Entry>(rec, lay.ye);
      const Entry* xe = at<Entry>(rec, lay.xe);
      const int ya = yoff[y0], yb = yoff[y0 + nrows];
      const int xa = xoff[x0], xb = xoff[x0 + ncols];
      if (ya < yb && xa < xb) {
        const int ph0 = ye[ya].bin, ph1 = ye[yb - 1].bin;
        const int pw0 = xe[xa].bin, npw = xe[xb - 1].bin - pw0 + 1;
        // lane i < nrows: tile row i's entries; lane j < ncols: column j's
        int rs = 0, rn = 0, rb0 = 0, cs = 0, cn = 0;
        if (lane < nrows) {
          rs = yoff[y0 + lane];
          rn = yoff[y0 + lane + 1] - rs;
          if (rn > 0) rb0 = ye[rs].bin;
        }
        if (lane < ncols) {
          cs = xoff[x0 + lane];
          cn = xoff[x0 + lane + 1] - cs;
        }
        const __nv_bfloat16* gr = gb + (size_t)r * g_roi;
        // bin rows a stage holds: the roi's sub-block in as few stages as fit
        const int fit = max(1, a.rows_max / npw);
        for (int pa = ph0; pa <= ph1; pa += fit) {
          const int nph = min(fit, ph1 - pa + 1);
          mbar_wait(empty + stage, parity ^ 1);
          StageHead* hd = head(stage);
          float* wyc = reinterpret_cast<float*>(hd + 1);
          float* wxs = wyc + kMaxTileH * a.ph;
          if (lane < kMaxTileH) {
            for (int k = 0; k < nph; ++k) {
              const int p = pa + k;
              const bool has = lane < nrows && p >= rb0 && p - rb0 < rn;
              wyc[lane * a.ph + k] = has ? ye[rs + p - rb0].w : 0.0f;
            }
          }
          if (lane < kCols) {
            hd->xs[lane] = cn > 0 ? xe[cs].bin - pw0 : 0;
            hd->xn[lane] = cn;
            hd->xo[lane] = cs - xa;
          }
          for (int e = xa + lane; e < xb; e += kLanes) wxs[e - xa] = xe[e].w;
          if (lane == 0) {
            hd->r = r;
            hd->ph0 = pa;
            hd->nph = nph;
            hd->npw = npw;
          }
          // staged row (k, q) = g[r, pa + k, pw0 + q] at (k * npw + q) * cs channels;
          // with all channels in the block a bin row's npw bins are one run
          unsigned char* dst = ring + (size_t)stage * a.stage_bytes;
          const __nv_bfloat16* src = gr + ((size_t)pa * a.pw + pw0) * a.c;
          const bool runs = a.n_cg == 1;
          const int units = runs ? nph : nph * npw;
          const int unit_ch = runs ? npw * a.c : cbe;  // channels a copy
          const int unit_at = runs ? npw * a.cs : a.cs;  // and apart in the stage
          auto unit_src = [&](int i) {
            return runs ? src + (size_t)i * a.pw * a.c
                        : src + ((size_t)(i / npw) * a.pw + i % npw) * a.c;
          };
          if (a.bulk) {
            __syncwarp();
            if (lane == 0) mbar_arrive_tx(full + stage, (uint32_t)(units * unit_ch * 2));
            __syncwarp();
            for (int i = lane; i < units; i += kLanes) {
              bulk_copy(dst + (size_t)i * unit_at * 2, unit_src(i), unit_ch * 2, full + stage);
            }
          } else {
            const int words4 = unit_ch / 4;  // 8-byte words a copy
            for (int i = lane; i < units * words4; i += kLanes) {
              const int u = i / words4, e = i % words4;
              reinterpret_cast<uint2*>(dst + (size_t)u * unit_at * 2)[e] =
                  reinterpret_cast<const uint2*>(unit_src(u))[e];
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(full + stage);
          }
          if (++stage == a.stages) stage = 0, parity ^= 1;
        }
      }
      fence_async_shared();  // the slot's reads are done before a copy refills it
      __syncwarp();
      const int rn = ahead.next();
      if (rn >= 0) fetch(slot, rn), ++issued;
    }
    mbar_wait(empty + stage, parity ^ 1);
    if (lane == 0) {
      head(stage)->r = -1;
      mbar_arrive(full + stage);
    }
  } else {
    // ----------------------------------------------------------- consumers
    int stage = 0;
    uint32_t parity = 0;
    while (true) {
      mbar_wait(full + stage, parity);
      const StageHead* hd = head(stage);
      if (hd->r < 0) break;
      if (has_c) {
        const float* wyc = reinterpret_cast<const float*>(hd + 1) + row0 * a.ph;
        const float* wxs = reinterpret_cast<const float*>(hd + 1) + kMaxTileH * a.ph;
        const int nph = hd->nph, npw = hd->npw, step = a.cs / 4;
        int xs[kCols], xn[kCols];
        const float* wj[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          xs[j] = hd->xs[j] * step;
          xn[j] = hd->xn[j];
          wj[j] = wxs + hd->xo[j];
        }
        const uint2* gs = reinterpret_cast<const uint2*>(ring + (size_t)stage * a.stage_bytes) +
                          cl / 4;
        for (int k = 0; k < nph; ++k) {
          float wy[kRows];
          bool rows = false;
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            wy[i] = wyc[i * a.ph + k];
            rows |= wy[i] != 0.0f;
          }
          if (!rows) continue;
          const uint2* gk = gs + k * npw * step;
          float4 u[kCols];
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            u[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            const uint2* gj = gk + xs[j];
            for (int q = 0; q < xn[j]; ++q) u[j] = fma4(wj[j][q], load4(gj + q * step), u[j]);
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            if (wy[i] != 0.0f) {
#pragma unroll
              for (int j = 0; j < kCols; ++j) {
                acc[i * kCols + j] = fma4(wy[i], u[j], acc[i * kCols + j]);
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);
      if (++stage == a.stages) stage = 0, parity ^= 1;
    }
  }

  auto scaled = [&](float4 v) {
    return make_float4(v.x / count, v.y / count, v.z / count, v.w / count);
  };
  if constexpr (kGroups == 1) {
#pragma unroll
    for (int k = 0; k < kWarpCells; ++k) {
      const long long idx = cell_at(k / kCols, k % kCols);
      if (idx >= 0) store_cell<kF32Out>(a.dfeat, (size_t)idx, scaled(acc[k]));
    }
  } else {
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    __syncthreads();  // every stage has been read: the ring takes the partial sums
    float4* parts = reinterpret_cast<float4*>(ring);  // [warp][cell][lane]
    if (warp < kStageWarps) {
#pragma unroll
      for (int k = 0; k < kWarpCells; ++k) parts[(warp * kWarpCells + k) * kLanes + lane] = acc[k];
    }
    cluster.sync();  // every block's partial sums are done
#pragma unroll
    for (int k = 0; k < kWarpCells; ++k) {
      const long long idx = cell_at(k / kCols, k % kCols);
      if (idx >= 0 && k % kGroups == group) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
          const float4 p = cluster.map_shared_rank(parts, gi)[(warp * kWarpCells + k) * kLanes + lane];
          v = gi == 0 ? p : add4(v, p);
        }
        store_cell<kF32Out>(a.dfeat, (size_t)idx, scaled(v));
      }
    }
    cluster.sync();  // no block leaves while another reads its shared memory
  }
}

// The launch of one instance: the tables, then the tiles.
template <typename Rule, int kGroups, bool kF32Out>
int launch_stage_bwd(const StageArgs& a, const float* rois, const float* valid_hw, int b,
                     float scale, size_t smem, dim3 grid, cudaStream_t stream) {
  auto kernel = roi_align_stage_bwd_kernel<Rule, kGroups, kF32Out>;
  if (const int rc = set_smem(kernel, smem)) return rc;
  if (a.r > 0) {
    if (const int rc = launch_roi_tables<Rule>(rois, valid_hw, b, a.h, a.w, a.r, a.ph, a.pw,
                                               a.s, scale, const_cast<char*>(a.table), stream)) {
      return rc;
    }
  }
  const dim3 block(kLanes, kStageWarps + 1);
  if constexpr (kGroups == 1) {
    kernel<<<grid, block, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kGroups;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
  }
}

inline int round_up(long long v, int m) { return (int)((v + m - 1) / m * m); }

// The launch plan of a backward of a bf16 g (B, R, PH, PW, C): the block's
// channel group and tile, its stages and shared memory (`smem`), and the
// cluster size (`groups`: the smallest of 1, 2, 4, 8 that gives
// kBlockTarget blocks, else 8).  Returns a cudaError_t.
inline int stage_plan(int b, int h, int w, int c, int r, int ph, int pw, int s, StageArgs& a,
                      size_t& smem, int& groups) {
  if (h >= 32767 || w >= 32767 || 2 * s * max(ph, pw) >= 32767 || c % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.h = h, a.w = w, a.c = c, a.r = r, a.ph = ph, a.pw = pw, a.s = s;
  a.bulk = c % 8 == 0;
  const int rec_bytes = (int)TableLayout(h, w, ph, pw, s).bytes;
  a.head_bytes = round_up(sizeof(StageHead) + sizeof(float) * (kMaxTileH * ph + 2 * s * pw), 16);
  a.off_hits = round_up(sizeof(uint64_t) * (2 * kMaxStages + kRecSlots), 16);
  a.off_heads = a.off_hits + round_up(sizeof(unsigned) * ((r + 31) / 32), 16);
  // the ring also takes a cluster's partial sums once the stages are read
  const int parts = (int)sizeof(float4) * kStageWarps * kWarpCells * kLanes;
  // the widest channel group (at most 8 slices) whose stages fit
  int n_sl = 1;
  while (n_sl < 8 && n_sl * 128 < c) n_sl *= 2;
  for (;; n_sl /= 2) {
    a.n_sl = n_sl;
    a.cb = n_sl * 128;
    a.cs = min(c, a.cb);
    // a stage holds at least one whole bin row, a quarter of the ring if more
    a.stage_bytes = round_up(max((long long)pw * a.cs * 2, (long long)kRingBudget / 4), 128);
    a.stages = max(2, min(kMaxStages, kRingBudget / a.stage_bytes));
    a.rows_max = a.stage_bytes / (a.cs * 2);
    a.off_recs = a.off_heads + a.stages * a.head_bytes;
    a.off_ring = round_up(a.off_recs + (long long)kRecSlots * rec_bytes, 128);
    smem = (size_t)a.off_ring + max(a.stages * a.stage_bytes, parts);
    if (smem <= (size_t)kSmemLimit) break;
    if (n_sl == 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  a.tile_h = kRows * (kStageWarps / a.n_sl);
  a.n_cg = (c + a.cb - 1) / a.cb;
  if ((long long)b * a.n_cg > 65535 || (h + a.tile_h - 1) / a.tile_h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles =
      (long long)((h + a.tile_h - 1) / a.tile_h) * ((w + kCols - 1) / kCols) * b * a.n_cg;
  groups = 1;
  while (groups < 8 && tiles * groups < kBlockTarget) groups *= 2;
  return 0;
}

// The backward of a bf16 g (B, R, PH, PW, C), C % 4 == 0 -> dfeat (B, H, W,
// C), bf16 (kF32Out false) or float32, every element written; scratch:
// table_scratch_bytes.  Launches on `stream`; returns a cudaError_t.
template <typename Rule, bool kF32Out>
int stage_bwd(const __nv_bfloat16* g, const float* rois, const float* valid_hw, int b, int h,
              int w, int c, int r, int ph, int pw, int s, float scale, void* scratch,
              void* dfeat, cudaStream_t stream) {
  if (b == 0 || h == 0 || w == 0 || c == 0) return 0;
  StageArgs a = {};
  size_t smem = 0;
  int groups = 1;
  if (const int rc = stage_plan(b, h, w, c, r, ph, pw, s, a, smem, groups)) return rc;
  a.g = g;
  a.table = static_cast<const char*>(scratch);
  a.dfeat = dfeat;
  const dim3 grid((w + kCols - 1) / kCols * groups, (h + a.tile_h - 1) / a.tile_h, b * a.n_cg);
  switch (groups) {
    case 1: return launch_stage_bwd<Rule, 1, kF32Out>(a, rois, valid_hw, b, scale, smem, grid, stream);
    case 2: return launch_stage_bwd<Rule, 2, kF32Out>(a, rois, valid_hw, b, scale, smem, grid, stream);
    case 4: return launch_stage_bwd<Rule, 4, kF32Out>(a, rois, valid_hw, b, scale, smem, grid, stream);
    default: return launch_stage_bwd<Rule, 8, kF32Out>(a, rois, valid_hw, b, scale, smem, grid, stream);
  }
}

}  // namespace
