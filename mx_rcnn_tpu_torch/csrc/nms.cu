// Greedy NMS keep mask over a batch of independent, score-sorted problems.
//
// Replaces the Pallas TPU kernel mx_rcnn_tpu/ops/pallas/nms.py::_nms_kernel
// (entry nms_mask_sorted_pallas).  Contract: boxes (P, N, 4) f32 [x1 y1 x2 y2]
// in descending score order per problem, valid (P, N) uint8 -> keep (P, N)
// uint8.  A box survives iff no earlier surviving box overlaps it with
// IoU > thresh; invalid rows neither survive nor suppress.  With max_keep > 0
// the sweep stops at max_keep survivors and later rows are 0: the mask holds
// exactly the first max_keep survivors of the full greedy sweep.
//
// Pass 1, nms_mask_kernel (after the upstream bitmask kernel
// rcnn/cython/nms_kernel.cu): one 64-thread block per 64 x 64 tile of the
// upper triangle (the grid enumerates only those tiles); thread i packs "row
// box i suppresses column box j" for the tile's 64 columns into one 64-bit
// word.  N = 9504 gives 149 words a row, an 11 MB mask that stays in L2.
// It is arithmetic, 45.8 M IoU tests at the FPN union; the IEEE division is
// most of a test, and boxes that do not meet skip it (score-sorted boxes
// cluster, so whole warps of a distant tile do).
//
// Pass 2, nms_reduce_kernel: one 512-thread block per problem walks the
// boxes in 64-box chunks with the removed bits in shared memory.  The sweep
// is serial over chunks, so what bounds it is the time of one chunk step, and
// the design keeps memory latency off the serial path:
//   - warp 0 resolves chunk w in registers.  Lane l holds the chunk's
//     diagonal words (rows w*64 + l and w*64 + 32 + l, word w): the greedy
//     survivors are the fixpoint of S = alive & ~OR_{j in S} row_j, reached
//     by iterating from S = alive (each pass fixes at least the next box in
//     order; a warp OR-reduction per pass, typically a few passes);
//   - the same lanes hold the chunk's next words (word w + 1), so warp 0 ORs
//     the survivors' bits into word w + 1 from registers too.  Both columns
//     of chunk w + 1 are loaded while chunk w resolves;
//   - the other 15 warps OR chunk w - 1's survivors' rows into the words
//     after w + 1 with eight independent loads in flight a thread (shared
//     atomicOr), one step behind warp 0.  One barrier a chunk.
// No survivor waits on memory for the next one to be found: the serial part
// is one step a chunk (149 at the FPN union), as in the TPU kernel's vector
// fixpoint over a 128-box block.  A step with survivors takes about one L2
// round trip, the bulk warps' loads; one without, the barrier and the warp
// reductions.

// Exactness: IoU is computed with the op order of ops/pallas/nms.py
// (areas with +1 widths, union floored at 1e-12, IEEE division, iou > thresh
// in f32) and the library is built with -fmad=false, so the mask is
// bool-identical to the plain PyTorch version in mx_rcnn_tpu_torch/ops/nms.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;
constexpr int kReduceWarps = 16;
constexpr int kReduceThreads = kReduceWarps * 32;
constexpr int kBulkThreads = kReduceThreads - 32;  // every warp but warp 0
constexpr int kLoadsInFlight = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float area(const float4 b) {
  return (b.z - b.x + 1.0f) * (b.w - b.y + 1.0f);
}

// iou(a, b) > thresh.  Where the boxes do not meet, inter is +-0 and so is
// the quotient, whatever the union: the branch skips the division and gives
// the same answer, 0 > thresh.
__device__ __forceinline__ bool suppresses(const float4 a, float area_a, const float4 b,
                                           float area_b, float thresh) {
  const float iw = fminf(a.z, b.z) - fmaxf(a.x, b.x) + 1.0f;
  const float ih = fminf(a.w, b.w) - fmaxf(a.y, b.y) + 1.0f;
  const float inter = fmaxf(iw, 0.0f) * fmaxf(ih, 0.0f);
  if (inter == 0.0f) return 0.0f > thresh;
  const float uni = area_a + area_b - inter;
  return inter / fmaxf(uni, 1e-12f) > thresh;
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes, int n,
                                int col_words, float thresh,
                                u64* __restrict__ mask) {
  // block t is tile (row_tile, col_tile), row_tile <= col_tile, numbered
  // column by column: t = col_tile * (col_tile + 1) / 2 + row_tile
  const int t = blockIdx.x;
  int col_tile = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while (col_tile * (col_tile + 1) / 2 > t) --col_tile;
  while ((col_tile + 1) * (col_tile + 2) / 2 <= t) ++col_tile;
  const int row_tile = t - col_tile * (col_tile + 1) / 2;
  const float4* pb = boxes + (size_t)blockIdx.z * n;
  const int row_size = min(n - row_tile * kTile, kTile);
  const int col_size = min(n - col_tile * kTile, kTile);

  __shared__ float4 cols[kTile];
  __shared__ float col_area[kTile];
  if (threadIdx.x < col_size) {
    const float4 b = pb[col_tile * kTile + threadIdx.x];
    cols[threadIdx.x] = b;
    col_area[threadIdx.x] = area(b);
  }
  __syncthreads();

  if (threadIdx.x < row_size) {
    const int i = row_tile * kTile + threadIdx.x;
    const float4 a = pb[i];
    const float area_a = area(a);
    u64 bits = 0;
    const int start = (row_tile == col_tile) ? threadIdx.x + 1 : 0;
    for (int k = start; k < col_size; ++k) {
      if (suppresses(a, area_a, cols[k], col_area[k], thresh)) bits |= 1ULL << k;
    }
    mask[((size_t)blockIdx.z * n + i) * col_words + col_tile] = bits;
  }
}

// Word j of row i of the mask, 0 past the problem.
__device__ __forceinline__ u64 word(const u64* __restrict__ pm, int n, int col_words, int i,
                                    int j) {
  return (i < n && j < col_words) ? pm[(size_t)i * col_words + j] : 0ULL;
}

__device__ __forceinline__ u64 warp_or(u64 v) {
  return ((u64)__reduce_or_sync(kFull, (unsigned)(v >> 32)) << 32) |
         __reduce_or_sync(kFull, (unsigned)v);
}

// OR of the lanes' words whose chunk bit is set in `set` (lane l holds the
// words of boxes l and l + 32)
__device__ __forceinline__ u64 or_rows(u64 set, int lane, u64 lo, u64 hi) {
  return warp_or(((set >> lane) & 1 ? lo : 0ULL) | ((set >> (lane + 32)) & 1 ? hi : 0ULL));
}

__global__ void __launch_bounds__(kReduceThreads)
nms_reduce_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid,
                  int n, int col_words, int max_keep, uint8_t* __restrict__ keep) {
  extern __shared__ u64 removed[];  // col_words words
  // chunk w's survivors (warp 0 writes) while the bulk reads chunk w - 1's
  __shared__ int surv_list[2][kTile];
  __shared__ int surv_count[2];
  __shared__ int stop_at;  // the chunk whose survivor reached max_keep
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* pv = valid + (size_t)blockIdx.x * n;
  uint8_t* pk = keep + (size_t)blockIdx.x * n;
  const u64* pm = mask + (size_t)blockIdx.x * n * col_words;

  // invalid rows (and the tail past n) start removed
  for (int w = warp; w < col_words; w += kReduceWarps) {
    const int i = w * kTile + lane;
    const unsigned lo = __ballot_sync(kFull, i >= n || !pv[i]);
    const unsigned hi = __ballot_sync(kFull, i + 32 >= n || !pv[i + 32]);
    if (lane == 0) removed[w] = lo | ((u64)hi << 32);
  }
  if (tid == 0) stop_at = col_words;

  // warp 0: chunk w - 1's survivors' bits in word w (carry), the survivors
  // so far (kept), and chunk w's diagonal words (rows w*64 + lane and
  // w*64 + 32 + lane, word w) and next words (word w + 1)
  u64 carry = 0;
  int kept = 0;
  u64 d_lo = 0, d_hi = 0, e_lo = 0, e_hi = 0;
  if (warp == 0) {
    d_lo = word(pm, n, col_words, lane, 0);
    d_hi = word(pm, n, col_words, lane + 32, 0);
    e_lo = word(pm, n, col_words, lane, 1);
    e_hi = word(pm, n, col_words, lane + 32, 1);
  }
  __syncthreads();

  for (int w = 0; w < col_words; ++w) {
    const int buf = w & 1;
    if (warp == 0) {
      // chunk w + 1's words, in flight while chunk w resolves
      const int i1 = (w + 1) * kTile + lane;
      const u64 nd_lo = word(pm, n, col_words, i1, w + 1);
      const u64 nd_hi = word(pm, n, col_words, i1 + 32, w + 1);
      const u64 ne_lo = word(pm, n, col_words, i1, w + 2);
      const u64 ne_hi = word(pm, n, col_words, i1 + 32, w + 2);

      const u64 alive = ~(removed[w] | carry);
      u64 surv = alive;
      for (;;) {
        const u64 s = alive & ~or_rows(surv, lane, d_lo, d_hi);
        if (s == surv) break;
        surv = s;
      }
      int ns = __popcll(surv);
      if (max_keep > 0 && kept + ns >= max_keep) {
        // the sweep stops at the max_keep-th survivor
        u64 rest = surv;
        for (int q = kept + 1; q < max_keep; ++q) rest &= rest - 1;
        const u64 last = rest & (~rest + 1);
        surv &= last + (last - 1);
        ns = max_keep - kept;
        if (lane == 0) stop_at = w;
      }
      kept += ns;

      const int i = w * kTile + lane;
      if (i < n) pk[i] = (surv >> lane) & 1;
      if (i + 32 < n) pk[i + 32] = (surv >> (lane + 32)) & 1;
      if ((surv >> lane) & 1) surv_list[buf][__popcll(surv & ((1ULL << lane) - 1))] = lane;
      if ((surv >> (lane + 32)) & 1) {
        surv_list[buf][__popcll(surv & ((1ULL << (lane + 32)) - 1))] = lane + 32;
      }
      if (lane == 0) surv_count[buf] = ns;
      carry = or_rows(surv, lane, e_lo, e_hi);
      d_lo = nd_lo, d_hi = nd_hi, e_lo = ne_lo, e_hi = ne_hi;
    } else if (w > 0) {
      // chunk w - 1's survivors into words w + 1 ..
      const int* list = surv_list[buf ^ 1];
      const int first = w + 1, rem = col_words - first;
      const int pairs = surv_count[buf ^ 1] * rem;
      const size_t row0 = (size_t)(w - 1) * kTile;
      for (int base = tid - 32; base < pairs; base += kLoadsInFlight * kBulkThreads) {
        u64 v[kLoadsInFlight];
        int j[kLoadsInFlight];
#pragma unroll
        for (int u = 0; u < kLoadsInFlight; ++u) {
          const int p = base + u * kBulkThreads;
          v[u] = 0;
          j[u] = first;
          if (p < pairs) {
            const int s = p / rem;
            j[u] = first + p - s * rem;
            v[u] = pm[(row0 + list[s]) * col_words + j[u]];
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadsInFlight; ++u) {
          if (v[u]) atomicOr(&removed[j[u]], v[u]);
        }
      }
    }
    __syncthreads();
    if (stop_at < col_words) break;
  }
  // the rows after the stop
  for (int i = (stop_at + 1) * kTile + tid; i < n; i += kReduceThreads) pk[i] = 0;
}

}  // namespace

// boxes (P, N, 4) f32, valid (P, N) uint8, scratch (P, N, ceil(N/64)) u64,
// keep (P, N) uint8; launches on `stream`, returns cudaGetLastError().
extern "C" int nms_keep_sorted(const float* boxes, const uint8_t* valid, int p,
                               int n, float thresh, int max_keep,
                               unsigned long long* scratch, uint8_t* keep,
                               void* stream) {
  if (p == 0 || n == 0) return 0;
  const int col_words = (n + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(col_words * (col_words + 1) / 2, 1, p);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(reinterpret_cast<const float4*>(boxes), n,
                                         col_words, thresh, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_reduce_kernel<<<p, kReduceThreads, col_words * sizeof(u64), s>>>(
      scratch, valid, n, col_words, max_keep, keep);
  return static_cast<int>(cudaGetLastError());
}
