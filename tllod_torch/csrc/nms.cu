// Greedy NMS with a fixed output, for many problems in one launch (sm_90a).
//
// Replaces tllod_tpu/ops/nms.py::nms_fixed (:96). That one is not a Pallas
// kernel but an XLA program (a blocked kept-buffer sweep with a
// definite-keeper fixpoint); PyTorch has no NMS of its own, so the port needs
// this kernel on its main path: 6000 -> 300 at IoU 0.7 per image in the
// proposal layer, and N -> 100 at IoU 0.3 per (image, class) in postprocess.
//
// Contract, as nms_fixed: boxes (P, N, 4) xyxy sorted by score, descending,
// within each problem; a box is suppressed when its "+1" IoU with an earlier
// kept box is strictly above the threshold; a score equal to the float32
// minimum (or -inf, or NaN) is never selected; the output is idx (P,
// max_output) of sorted positions, padded with 0 past num_keep (P,).
//
// Algorithm: the reference's bitmask NMS (lib/model/nms/src/
// nms_cuda_kernel.cu), with the scan moved to the device.
//  * nms_mask_kernel, grid (col tile, row tile, problem), 64 threads: thread t
//    computes the u64 mask of the boxes j of the column tile, j > i, that row
//    i = row_tile * 64 + t overlaps beyond the threshold. Tiles left of the
//    diagonal are never read and exit at once.
//  * nms_scan_kernel, one block per problem: its 8 warps first turn the
//    scores into a bitmask of valid boxes; then warp 0 walks the sorted rows
//    word by word, keeping the lowest live bit, ORing that row's mask into
//    the removed-mask held in shared memory (6000 boxes -> 94 words), and
//    stops at max_output keepers. It writes idx and num_keep itself, so the
//    proposal layer makes no device-to-host copy.
// The IoU is inter / (area_a + area_b - inter) in exactly the order of the
// JAX and numpy versions, and this file is built with -fmad=false, so no
// multiply-add contraction moves a borderline iou > thresh decision.
//
// Bound. Per problem the inputs are N * 20 bytes and the outputs
// max_output * 8 bytes, a few hundred KB in all: the time is set by the
// serial scan (one dependent mask load per kept box), not by bytes or
// arithmetic.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kScanThreads = 256;

typedef unsigned long long u64;

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return (x2 - x1 + 1.0f) * (y2 - y1 + 1.0f);
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float* __restrict__ boxes, int N, int col_blocks,
                float thresh, u64* __restrict__ mask) {
  const int p = blockIdx.z;
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  if (col_block < row_block) return;
  const int row_size = min(N - row_block * kTile, kTile);
  const int col_size = min(N - col_block * kTile, kTile);
  const float* pb = boxes + (size_t)p * N * 4;

  __shared__ float cx1[kTile], cy1[kTile], cx2[kTile], cy2[kTile], carea[kTile];
  const int t = threadIdx.x;
  if (t < col_size) {
    const float* bx = pb + (size_t)(col_block * kTile + t) * 4;
    cx1[t] = bx[0];
    cy1[t] = bx[1];
    cx2[t] = bx[2];
    cy2[t] = bx[3];
    carea[t] = box_area(bx[0], bx[1], bx[2], bx[3]);
  }
  __syncthreads();
  if (t >= row_size) return;

  const int i = row_block * kTile + t;
  const float* bi = pb + (size_t)i * 4;
  const float x1 = bi[0], y1 = bi[1], x2 = bi[2], y2 = bi[3];
  const float area_i = box_area(x1, y1, x2, y2);
  u64 bits = 0;
  const int start = (row_block == col_block) ? t + 1 : 0;
  for (int k = start; k < col_size; ++k) {
    const float iw = fminf(x2, cx2[k]) - fmaxf(x1, cx1[k]) + 1.0f;
    const float ih = fminf(y2, cy2[k]) - fmaxf(y1, cy1[k]) + 1.0f;
    const float inter = fmaxf(iw, 0.0f) * fmaxf(ih, 0.0f);
    const float iou = inter / (area_i + carea[k] - inter);
    if (iou > thresh) bits |= 1ULL << k;
  }
  mask[((size_t)p * N + i) * col_blocks + col_block] = bits;
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const u64* __restrict__ mask, const float* __restrict__ scores,
                int N, int col_blocks, int max_output,
                long long* __restrict__ idx, long long* __restrict__ num_keep) {
  extern __shared__ u64 smem[];
  u64* removed = smem;
  u64* valid = smem + col_blocks;
  const int p = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* sc = scores + (size_t)p * N;

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
  __syncthreads();
  if (warp != 0) return;

  const u64* pm = mask + (size_t)p * N * col_blocks;
  long long* out = idx + (size_t)p * max_output;
  int count = 0;
  for (int w = 0; w < col_blocks && count < max_output; ++w) {
    u64 live = valid[w] & ~removed[w];
    while (live != 0ULL && count < max_output) {
      const int b = __ffsll((long long)live) - 1;
      const int i = w * kTile + b;
      if (lane == 0) out[count] = i;
      ++count;
      const u64* row = pm + (size_t)i * col_blocks;
      live &= ~row[w];
      live &= ~(1ULL << b);
      for (int w2 = w + 1 + lane; w2 < col_blocks; w2 += 32) {
        removed[w2] |= row[w2];
      }
      __syncwarp();
    }
  }
  for (int k = count + lane; k < max_output; k += 32) out[k] = 0;
  if (lane == 0) num_keep[p] = count;
}

}  // namespace

extern "C" {

const char* tllod_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// boxes: (P, N, 4) float32, scores: (P, N) float32, both sorted descending;
// mask: scratch of P * N * ceil(N / 64) u64; idx: (P, max_output) int64;
// num_keep: (P,) int64.
int tllod_nms_sorted(const void* boxes, const void* scores, void* mask,
                     void* idx, void* num_keep, int P, int N, int max_output,
                     float thresh, void* stream) {
  if (P == 0 || max_output == 0) return 0;
  const int col_blocks = (N + kTile - 1) / kTile;
  const size_t smem = 2 * (size_t)col_blocks * sizeof(u64);
  if (N < 1 || col_blocks > 65535 || smem > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  nms_mask_kernel<<<dim3(col_blocks, col_blocks, P), kTile, 0, s>>>(
      (const float*)boxes, N, col_blocks, thresh, (u64*)mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<P, kScanThreads, smem, s>>>(
      (const u64*)mask, (const float*)scores, N, col_blocks, max_output,
      (long long*)idx, (long long*)num_keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
