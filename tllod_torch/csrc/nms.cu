// Greedy NMS with a fixed output, for many problems in one launch (sm_90a).
//
// Replaces tllod_tpu/ops/nms.py::nms_fixed (:96). That one is not a Pallas
// kernel but an XLA program (a blocked kept-buffer sweep with a
// definite-keeper fixpoint); PyTorch has no NMS of its own, so the port needs
// this kernel on its main path: 12000 -> 2000 (source) and 6000 -> 300
// (target) at IoU 0.7 in the train step's proposal layer, 6000 -> 300 per
// image at eval, and 300 -> 100 at IoU 0.3 per (image, class) in postprocess.
//
// Contract, as nms_fixed: boxes (P, N, 4) xyxy and scores (P, N), either
// sorted by score, descending, already (the proposal layer's top-k) or in
// any order; ties keep input order (a stable sort); a box is suppressed when
// its "+1" IoU with an earlier kept box is strictly above the threshold; a
// score equal to the float32 minimum (or -inf, or NaN) is never selected;
// the output is idx (P, max_output) of input rows in score order, padded
// with 0 past num_keep (P,). Unsorted problems are sorted by nms_sort_kernel
// (a bitonic sort of (score, row) keys, one block a problem); the mask
// kernel then reads the boxes through that order and the scan writes input
// rows, so one call is three launches and no PyTorch sort, gather or
// unsort.
//
// What bounds it. The inputs are N * 20 bytes a problem and the IoUs a few
// GFLOP at most: bytes and operations allow microseconds. The time is set by
// the greedy chain: whether box i is kept depends on every kept box before
// it. The reference's bitmask NMS (lib/model/nms/src/nms_cuda_kernel.cu)
// splits the work in two: a parallel mask of pairwise overlaps, then a
// serial scan of the kept boxes over that mask. A scan that loads a mask row
// from device memory for every kept box waits one L2 round trip per kept box
// (2000 in series at 12000 -> 2000).
//
// The design keeps device memory off that chain:
//  * nms_mask_kernel: boxes are cut into 64-box tiles. Only the upper
//    triangle of (row tile, column tile) pairs is launched, four tiles to a
//    256-thread block, the (problem, tile) pairs of all problems in one
//    linear grid. Thread t of a tile computes the u64 of the boxes j of the
//    column tile, j > i, that row i overlaps beyond the threshold. The words
//    of row i's own tile and of the next one go to `band` (P, col_blocks *
//    64, 2), 16 contiguous bytes a row; the farther ones to `mask` (P, N,
//    col_blocks) at (i, column tile), whose other words are never written or
//    read. Where the intersection is 0 and the threshold is >= 0 the
//    division is skipped: the IoU is then 0, -0 or NaN, none of which is >
//    thresh, so the bit is the one the division would give.
//  * nms_scan_kernel, one 256-thread block per problem, one 64-box tile per
//    iteration. The valid bits (scores) and the removed words live in shared
//    memory; each tile's band (1 KB) is copied there with cp.async two
//    tiles ahead, double-buffered. In iteration w, warp 0 resolves tile w:
//    the greedy chain (lowest live bit, clear its diagonal word) reads
//    shared memory and registers only, and stops at exactly max_output
//    keepers, in the middle of a tile if need be. The kept rows' next-tile
//    words, ORed across the warp, clear tile w+1's candidates in the next
//    iteration. Meanwhile warps 1-7 OR the far words (tiles w+1 ..) of tile
//    w-1's kept rows into `removed`, one thread a word: coalesced loads, 16
//    rows in flight a thread, no atomics. One __syncthreads a tile; device
//    memory is read once per tile, off the chain, instead of once per kept
//    box. What is left in series is one iteration per tile scanned (at most
//    188 at N = 12000; each waits for the far words' one L2 round trip and
//    the barrier) plus one shared-memory step per kept box.
//    The scan writes idx and num_keep itself, so the proposal layer makes
//    no device-to-host copy.
// The IoU is inter / (area_a + area_b - inter) in exactly the order of the
// JAX and numpy versions, and this file is built with -fmad=false, so no
// multiply-add contraction moves a borderline iou > thresh decision.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kMaskTilesPerBlock = 4;
constexpr int kMaskThreads = kTile * kMaskTilesPerBlock;
constexpr int kScanThreads = 256;
constexpr int kOrUnroll = 16;    // far-word loads each thread keeps in flight
constexpr int kSortThreads = 512;
constexpr int kSortSmemKeys = 16384;   // larger problems sort in device memory

typedef unsigned long long u64;

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return (x2 - x1 + 1.0f) * (y2 - y1 + 1.0f);
}

// Sort key of score s at input row i: ascending keys give descending
// scores, equal scores (-0 == +0) in input order, as a stable descending
// sort does. Invalid scores (float32 min, -inf, NaN) sort last: they are
// never kept and so never suppress, and where they sit changes nothing.
__device__ __forceinline__ u64 sort_key(float s, unsigned i) {
  unsigned desc = 0xffffffffu;
  if (s > -FLT_MAX) {
    const unsigned u = __float_as_uint(s + 0.0f);    // -0 -> +0
    desc = ~((u & 0x80000000u) ? ~u : (u | 0x80000000u));
  }
  return ((u64)desc << 32) | i;
}

// One block per problem: a bitonic sort of its keys (padded to a power of
// two with ~0) in shared memory, or in `gkeys` when they do not fit; then
// the sorted scores and the order (input row of each sorted position).
__global__ void __launch_bounds__(kSortThreads)
nms_sort_kernel(const float* __restrict__ scores, int N, int n_pad,
                u64* __restrict__ gkeys, float* __restrict__ sorted,
                long long* __restrict__ order) {
  extern __shared__ __align__(16) u64 skeys[];
  const int p = blockIdx.x;
  const float* sc = scores + (size_t)p * N;
  u64* keys = n_pad <= kSortSmemKeys ? skeys : gkeys + (size_t)p * n_pad;
  for (int i = threadIdx.x; i < n_pad; i += kSortThreads) {
    keys[i] = i < N ? sort_key(sc[i], i) : ~0ULL;
  }
  __syncthreads();
  for (int k = 2; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n_pad; i += kSortThreads) {
        const int l = i ^ j;
        if (l > i) {
          const u64 a = keys[i], b = keys[l];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < N; i += kSortThreads) {
    const unsigned r = (unsigned)(keys[i] & 0xffffffffu);
    order[(size_t)p * N + i] = r;
    sorted[(size_t)p * N + i] = sc[r];
  }
}

// Row tile of the L-th pair of the upper triangle of nb x nb tiles, row by
// row: row r starts at S(r) = r * (2 nb - r + 1) / 2.
__device__ __forceinline__ int triangle_row(long long L, int nb) {
  const double b = 2.0 * nb + 1.0;
  int r = (int)((b - sqrt(b * b - 8.0 * (double)L)) * 0.5);
  r = max(0, min(r, nb - 1));
  auto start = [nb](long long q) { return q * (2LL * nb - q + 1) / 2; };
  while (r > 0 && start(r) > L) --r;
  while (r + 1 < nb && start(r + 1) <= L) ++r;
  return r;
}

__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float* __restrict__ boxes,
                const long long* __restrict__ order, int N, int col_blocks,
                long long tiles_per_problem, long long total_tiles,
                float thresh, u64* __restrict__ mask, u64* __restrict__ band) {
  __shared__ float4 cbox[kMaskTilesPerBlock][kTile];
  __shared__ float carea[kMaskTilesPerBlock][kTile];
  const int sub = threadIdx.x / kTile;
  const int t = threadIdx.x % kTile;
  const long long g = (long long)blockIdx.x * kMaskTilesPerBlock + sub;
  const bool active = g < total_tiles;
  int p = 0, row_block = 0, col_block = 0;
  if (active) {
    p = (int)(g / tiles_per_problem);
    const long long L = g - (long long)p * tiles_per_problem;
    row_block = triangle_row(L, col_blocks);
    const long long row_start =
        (long long)row_block * (2LL * col_blocks - row_block + 1) / 2;
    col_block = row_block + (int)(L - row_start);
  }
  // the box at sorted position j: row order[j] of the input, or row j
  const float* pb = boxes + (size_t)p * N * 4;
  const long long* po = order ? order + (size_t)p * N : nullptr;
  const int row_size = active ? min(N - row_block * kTile, kTile) : 0;
  const int col_size = active ? min(N - col_block * kTile, kTile) : 0;

  float4 cb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (t < col_size) {
    const int j = col_block * kTile + t;
    const float* bx = pb + (size_t)(po ? po[j] : j) * 4;
    cb = make_float4(bx[0], bx[1], bx[2], bx[3]);
  }
  cbox[sub][t] = cb;
  carea[sub][t] = box_area(cb.x, cb.y, cb.z, cb.w);
  __syncthreads();
  if (t >= row_size) return;

  const int i = row_block * kTile + t;
  const float* bi = pb + (size_t)(po ? po[i] : i) * 4;
  const float x1 = bi[0], y1 = bi[1], x2 = bi[2], y2 = bi[3];
  const float area_i = box_area(x1, y1, x2, y2);
  // a threshold below 0 (or NaN) takes every division
  const bool divide_all = !(thresh >= 0.0f);
  u64 bits = 0;
#pragma unroll 16
  for (int k = 0; k < kTile; ++k) {
    const float4 c = cbox[sub][k];
    const float iw = fminf(x2, c.z) - fmaxf(x1, c.x) + 1.0f;
    const float ih = fminf(y2, c.w) - fmaxf(y1, c.y) + 1.0f;
    const float inter = fmaxf(iw, 0.0f) * fmaxf(ih, 0.0f);
    if (inter > 0.0f || divide_all) {
      const float iou = inter / (area_i + carea[sub][k] - inter);
      if (iou > thresh) bits |= 1ULL << k;
    }
  }
  // keep the columns that exist and, on the diagonal, those after i
  if (col_size < kTile) bits &= (1ULL << col_size) - 1;
  u64* pband = band + ((size_t)p * col_blocks * kTile + i) * 2;
  if (col_block == row_block) {
    pband[0] = bits & ~((2ULL << t) - 1);
  } else if (col_block == row_block + 1) {
    pband[1] = bits;
  } else {
    mask[((size_t)p * N + i) * col_blocks + col_block] = bits;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Warp 0 copies tile t's band (64 rows x 2 words, 1 KB) into buffer t & 1,
// as one cp.async group (empty past the last tile).
__device__ __forceinline__ void fetch_band(u64* bbuf, const u64* pb, int t,
                                           int col_blocks, int lane) {
  if (t < col_blocks) {
    u64* dst = bbuf + (t & 1) * 2 * kTile;
    const u64* src = pb + (size_t)t * 2 * kTile;
    cp_async16(dst + 2 * lane, src + 2 * lane);
    cp_async16(dst + kTile + 2 * lane, src + kTile + 2 * lane);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const u64* __restrict__ mask, const u64* __restrict__ band,
                const float* __restrict__ scores,
                const long long* __restrict__ order, int N, int col_blocks,
                int max_output, long long* __restrict__ idx,
                long long* __restrict__ num_keep) {
  extern __shared__ __align__(16) u64 smem[];
  u64* removed = smem;                         // col_blocks words
  u64* valid = smem + col_blocks;              // col_blocks words
  u64* bbuf = smem + 2 * col_blocks;           // 2 tiles x 64 rows x 2 words
  __shared__ int kept_pos[2][kTile];           // kept rows of tiles w, w-1
  __shared__ int s_kept[2], s_count[2];
  const int p = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* sc = scores + (size_t)p * N;
  const u64* pm = mask + (size_t)p * N * col_blocks;
  const u64* pb = band + (size_t)p * col_blocks * kTile * 2;
  const long long* po = order ? order + (size_t)p * N : nullptr;
  long long* out = idx + (size_t)p * max_output;

  if (warp == 0) {
    fetch_band(bbuf, pb, 0, col_blocks, lane);
    fetch_band(bbuf, pb, 1, col_blocks, lane);
  }
  for (int w = warp; w < col_blocks; w += kScanThreads / 32) {
    const int i0 = w * kTile + lane;
    const int i1 = i0 + 32;
    const bool v0 = i0 < N && sc[i0] > -FLT_MAX;
    const bool v1 = i1 < N && sc[i1] > -FLT_MAX;
    const unsigned lo = __ballot_sync(0xffffffffu, v0);
    const unsigned hi = __ballot_sync(0xffffffffu, v1);
    if (lane == 0) {
      valid[w] = (u64)lo | ((u64)hi << 32);
      removed[w] = 0;
    }
  }

  // Iteration w: warp 0 resolves tile w while warps 1-7 OR the far words
  // (w+1 ..) of tile w-1's kept rows into `removed`. removed[w] then holds
  // the kept rows of tiles <= w-2 (ORed by the end of iteration w-1) and
  // `near` those of tile w-1 (their words w, from the band).
  u64 near = 0;           // warp 0 only
  int count = 0;          // warp 0 only
  for (int w = 0; w < col_blocks; ++w) {
    const int cur = w & 1, prev = cur ^ 1;
    if (warp == 0) {
      cp_async_wait_one();        // tile w's band has landed
      __syncwarp();
    }
    __syncthreads();
    if (w > 0 && s_count[prev] >= max_output) break;
    if (warp == 0) {
      // the greedy chain inside the tile: shared memory and registers only
      const u64* bw = bbuf + cur * 2 * kTile;  // row b: diagonal 2b, next 2b+1
      u64 live = valid[w] & ~removed[w] & ~near;
      u64 kept = 0;
      int c = count;
      while (live != 0ULL && c < max_output) {
        const int b = __ffsll((long long)live) - 1;
        kept |= 1ULL << b;
        live &= ~(bw[2 * b] | (1ULL << b));
        ++c;
      }
      // kept rows in order, to the output and to the next iteration's OR
      u64 next = 0;
      for (int b = lane; b < kTile; b += 32) {
        if ((kept >> b) & 1ULL) {
          const int r = __popcll(kept & ((1ULL << b) - 1));
          const int i = w * kTile + b;
          kept_pos[cur][r] = i;
          out[count + r] = po ? po[i] : i;
          next |= bw[2 * b + 1];
        }
      }
      // word w+1 of this tile's kept rows, ORed across the warp
      near = (u64)__reduce_or_sync(0xffffffffu, (unsigned)next) |
             ((u64)__reduce_or_sync(0xffffffffu, (unsigned)(next >> 32))
              << 32);
      if (lane == 0) {
        s_kept[cur] = c - count;
        s_count[cur] = c;
      }
      count = c;
      __syncwarp();               // every lane is done with tile w's band
      fetch_band(bbuf, pb, w + 2, col_blocks, lane);
    } else if (w > 0) {
      // thread t ORs words w+1+t, w+1+t+224, ... of tile w-1's kept rows:
      // coalesced loads, kOrUnroll rows in flight, one thread a word
      constexpr int kOrThreads = kScanThreads - 32;
      const int nk = s_kept[prev];
      const int* rows = kept_pos[prev];
      for (int c = w + 1 + threadIdx.x - 32; c < col_blocks;
           c += kOrThreads) {
        u64 acc = 0;
        for (int j = 0; j < nk; j += kOrUnroll) {
          u64 v[kOrUnroll];
#pragma unroll
          for (int u = 0; u < kOrUnroll; ++u) {
            v[u] = j + u < nk ? pm[(size_t)rows[j + u] * col_blocks + c]
                              : 0ULL;
          }
#pragma unroll
          for (int u = 0; u < kOrUnroll; ++u) acc |= v[u];
        }
        removed[c] |= acc;
      }
    }
  }
  if (warp == 0) {
    for (int k = count + lane; k < max_output; k += 32) out[k] = 0;
    if (lane == 0) num_keep[p] = count;
  }
}

int sort_pad(int N) {
  int n = 1;
  while (n < N) n <<= 1;
  return n;
}

size_t scan_smem(int col_blocks) {
  return (2 * (size_t)col_blocks + 4 * kTile) * sizeof(u64);
}

}  // namespace

extern "C" {

const char* tllod_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// scores: (P, N) float32 in any order; keys: scratch of P * n_pad u64, n_pad
// the power of two >= N (used when n_pad > 16384); sorted: (P, N) float32
// and order: (P, N) int64 out, the scores sorted descending (stable) and
// the input row of each sorted position.
int tllod_nms_sort(const void* scores, void* keys, void* sorted, void* order,
                   int P, int N, void* stream) {
  if (P == 0) return 0;
  if (N < 1) return (int)cudaErrorInvalidValue;
  const int n_pad = sort_pad(N);
  const size_t smem = n_pad <= kSortSmemKeys ? n_pad * sizeof(u64) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_sort_kernel<<<P, kSortThreads, smem, (cudaStream_t)stream>>>(
      (const float*)scores, N, n_pad, (u64*)keys, (float*)sorted,
      (long long*)order);
  return (int)cudaGetLastError();
}

// boxes: (P, N, 4) float32; order: NULL when the boxes are sorted by
// score, descending, else (P, N) int64, the input row of each sorted
// position; mask: scratch of P * N * ceil(N / 64) u64; band: scratch of
// P * ceil(N / 64) * 64 * 2 u64.
int tllod_nms_mask(const void* boxes, const void* order, void* mask,
                   void* band, int P, int N, float thresh, void* stream) {
  if (P == 0) return 0;
  const int col_blocks = (N + kTile - 1) / kTile;
  const long long per = (long long)col_blocks * (col_blocks + 1) / 2;
  const long long total = per * P;
  const long long blocks =
      (total + kMaskTilesPerBlock - 1) / kMaskTilesPerBlock;
  if (N < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  nms_mask_kernel<<<(unsigned)blocks, kMaskThreads, 0, (cudaStream_t)stream>>>(
      (const float*)boxes, (const long long*)order, N, col_blocks, per, total,
      thresh, (u64*)mask, (u64*)band);
  return (int)cudaGetLastError();
}

// mask, band: as tllod_nms_mask left them; scores: (P, N) float32 sorted
// descending; order: as for tllod_nms_mask (idx then holds input rows, not
// sorted positions); idx: (P, max_output) int64; num_keep: (P,) int64.
int tllod_nms_scan(const void* mask, const void* band, const void* scores,
                   const void* order, void* idx, void* num_keep, int P, int N,
                   int max_output, void* stream) {
  if (P == 0 || max_output == 0) return 0;
  const int col_blocks = (N + kTile - 1) / kTile;
  const size_t smem = scan_smem(col_blocks);
  if (N < 1 || smem > 227 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_scan_kernel<<<P, kScanThreads, smem, (cudaStream_t)stream>>>(
      (const u64*)mask, (const u64*)band, (const float*)scores,
      (const long long*)order, N, col_blocks, max_output, (long long*)idx,
      (long long*)num_keep);
  return (int)cudaGetLastError();
}

// The whole NMS of P problems: with keys, sorted and order given (unsorted
// scores), the sort, then the mask and the scan through the order; with
// them NULL (scores sorted descending, boxes in that order), mask and scan.
int tllod_nms(const void* boxes, const void* scores, void* keys, void* sorted,
              void* order, void* mask, void* band, void* idx, void* num_keep,
              int P, int N, int max_output, float thresh, void* stream) {
  if (P == 0 || max_output == 0) return 0;
  if (order != nullptr) {
    const int status = tllod_nms_sort(scores, keys, sorted, order, P, N,
                                      stream);
    if (status != 0) return status;
    scores = sorted;
  }
  const int status =
      tllod_nms_mask(boxes, order, mask, band, P, N, thresh, stream);
  if (status != 0) return status;
  return tllod_nms_scan(mask, band, scores, order, idx, num_keep, P, N,
                        max_output, stream);
}

}  // extern "C"
