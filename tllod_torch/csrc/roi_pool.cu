// RoIPool forward and backward for Hopper (sm_90a), float32, one launch each
// for the whole batch. They replace the JAX package's RoIPool
// (tllod_tpu/ops/roi_pool.py::roi_pool and _bin_ranges), an XLA masked
// reduction there; the reference's hand kernel was
// lib/model/roi_pooling/src/roi_pooling_kernel.cu.
//
// Semantics (those of tllod_torch/ops/roi_pool.py::roi_pool_plain): each RoI
// row (b, x1, y1, x2, y2) is quantized by floor(x * scale + 0.5), to a width
// and height of at least 1; bin i of P along an axis spans
// [floor(i * ext / P) + lo, ceil((i + 1) * ext / P) + lo), in exact integers,
// clipped to [0, size]. A bin takes the max of its pixels; an empty bin gives
// 0. A batch index outside [0, B) reads image 0, as the JAX package does.
//
// Layout and mapping. The map is NHWC, so one thread per channel of an
// (RoI, bin) pair reads a bin's pixels with neighbouring threads on
// neighbouring addresses. A block takes one bin and 128 channels. The
// forward writes (R, P, P, C): PA-ATF's CLUB heads read it as the
// channels-last NCHW view with no copy.
//
// The backward recomputes the bin in registers and splits the gradient as
// JAX differentiates its two max reductions (over H, then over W): the bin
// max m and n_w, the number of columns whose in-bin column max equals m, in
// one pass; then for each such column x the count n_h(x) of its in-bin rows
// equal to m, and (g / n_w) / n_h(x) added into each of them with atomicAdd
// (overlapping bins add into the same pixel). The division order is JAX's
// transpose, up to the order of summation.
//
// What bounds them: bytes. PA-ATF's 50 gt RoIs read a few MB of each tap and
// do one compare per pixel read; the backward reads each bin up to three
// times (the second and third from L1/L2) and writes the map gradient. Both
// are built with -fmad=false, so the quantization rounds as the plain version
// does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Bin {
  int b, hs, he, ws, we;
};

// [start, end) of bin i of p along an axis from lo with extent ext, clipped
// to [0, limit]; ext >= 1 and i >= 0, so C's division is the floor.
__device__ __forceinline__ void axis_bin(long long lo, long long ext, int i,
                                         int p, int limit, int& start,
                                         int& end) {
  long long s = (long long)i * ext / p + lo;
  long long e = ((long long)(i + 1) * ext + p - 1) / p + lo;
  start = (int)min(max(s, 0LL), (long long)limit);
  end = (int)min(max(e, 0LL), (long long)limit);
}

__device__ __forceinline__ Bin roi_bin(const float* roi, float scale, int B,
                                       int H, int W, int P, int i, int j) {
  Bin bin;
  const int bi = (int)roi[0];
  bin.b = (bi >= 0 && bi < B) ? bi : 0;
  const float x1 = floorf(roi[1] * scale + 0.5f);
  const float y1 = floorf(roi[2] * scale + 0.5f);
  const float x2 = floorf(roi[3] * scale + 0.5f);
  const float y2 = floorf(roi[4] * scale + 0.5f);
  const float roi_w = fmaxf(x2 - x1 + 1.0f, 1.0f);
  const float roi_h = fmaxf(y2 - y1 + 1.0f, 1.0f);
  axis_bin((long long)y1, (long long)roi_h, i, P, H, bin.hs, bin.he);
  axis_bin((long long)x1, (long long)roi_w, j, P, W, bin.ws, bin.we);
  return bin;
}

// max that keeps a NaN, as torch.amax and jnp.max do
__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

__global__ void __launch_bounds__(kThreads)
roi_pool_forward_kernel(const float* __restrict__ feat,
                        const float* __restrict__ rois,
                        float* __restrict__ out, int B, int H, int W, int C,
                        int P, float scale) {
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= C) return;
  const int pp = P * P;
  const int r = blockIdx.x / pp;
  const int k = blockIdx.x - r * pp;
  const Bin bin = roi_bin(rois + 5 * (size_t)r, scale, B, H, W, P, k / P,
                          k % P);
  float m = 0.0f;
  if (bin.he > bin.hs && bin.we > bin.ws) {
    const float* img = feat + (size_t)bin.b * H * W * C + c;
    m = img[((size_t)bin.hs * W + bin.ws) * C];
    for (int y = bin.hs; y < bin.he; ++y) {
      const float* row = img + (size_t)y * W * C;
      for (int x = bin.ws; x < bin.we; ++x) {
        m = nan_max(m, row[(size_t)x * C]);
      }
    }
  }
  out[(size_t)blockIdx.x * C + c] = m;
}

__global__ void __launch_bounds__(kThreads)
roi_pool_backward_kernel(const float* __restrict__ grad_out,
                         const float* __restrict__ feat,
                         const float* __restrict__ rois,
                         float* __restrict__ grad_feat, int B, int H, int W,
                         int C, int P, float scale) {
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= C) return;
  const float g = grad_out[(size_t)blockIdx.x * C + c];
  if (g == 0.0f) return;
  const int pp = P * P;
  const int r = blockIdx.x / pp;
  const int k = blockIdx.x - r * pp;
  const Bin bin = roi_bin(rois + 5 * (size_t)r, scale, B, H, W, P, k / P,
                          k % P);
  if (bin.he <= bin.hs || bin.we <= bin.ws) return;   // an empty bin: 0
  const size_t off = (size_t)bin.b * H * W * C + c;
  const float* img = feat + off;
  float* gimg = grad_feat + off;

  // the bin max m over the column maxima, and n_w, its tied columns
  float m = 0.0f;
  int n_w = 0;
  for (int x = bin.ws; x < bin.we; ++x) {
    float col = img[((size_t)bin.hs * W + x) * C];
    for (int y = bin.hs + 1; y < bin.he; ++y) {
      col = nan_max(col, img[((size_t)y * W + x) * C]);
    }
    if (n_w == 0 || col > m) {
      m = col;
      n_w = 1;
    } else if (col == m) {
      ++n_w;
    }
  }
  const float share = g / (float)n_w;
  for (int x = bin.ws; x < bin.we; ++x) {
    int n_h = 0;
    float col = img[((size_t)bin.hs * W + x) * C];
    for (int y = bin.hs + 1; y < bin.he; ++y) {
      col = nan_max(col, img[((size_t)y * W + x) * C]);
    }
    if (!(col == m)) continue;
    for (int y = bin.hs; y < bin.he; ++y) {
      n_h += img[((size_t)y * W + x) * C] == m;
    }
    const float add = share / (float)n_h;
    for (int y = bin.hs; y < bin.he; ++y) {
      if (img[((size_t)y * W + x) * C] == m) {
        atomicAdd(gimg + ((size_t)y * W + x) * C, add);
      }
    }
  }
}

bool bad_shape(int B, int H, int W, int C, int R, int P) {
  return B < 1 || H < 1 || W < 1 || C < 0 || R < 0 || P < 1 || P > 64 ||
         (long long)R * P * P > 0x7fffffffLL;
}

}  // namespace

extern "C" {

const char* tllod_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// feat: (B, H, W, C) float32 contiguous; rois: (R, 5) float32; out: (R, P, P,
// C) float32.
int tllod_roi_pool_forward(const void* feat, const void* rois, void* out,
                           int B, int H, int W, int C, int R, int P,
                           float spatial_scale, void* stream) {
  if (bad_shape(B, H, W, C, R, P)) return (int)cudaErrorInvalidValue;
  if (R == 0 || C == 0) return 0;
  const dim3 grid(R * P * P, (C + kThreads - 1) / kThreads);
  roi_pool_forward_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)feat, (const float*)rois, (float*)out, B, H, W, C, P,
      spatial_scale);
  return (int)cudaGetLastError();
}

// grad_out: (R, P, P, C) float32 contiguous; feat: the forward's map; rois:
// (R, 5) float32; grad_feat: (B, H, W, C) float32, zeroed by the caller and
// accumulated into. Launches the kernel and nothing else.
int tllod_roi_pool_backward(const void* grad_out, const void* feat,
                            const void* rois, void* grad_feat, int B, int H,
                            int W, int C, int R, int P, float spatial_scale,
                            void* stream) {
  if (bad_shape(B, H, W, C, R, P)) return (int)cudaErrorInvalidValue;
  if (R == 0 || C == 0) return 0;
  const dim3 grid(R * P * P, (C + kThreads - 1) / kThreads);
  roi_pool_backward_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)grad_out, (const float*)feat, (const float*)rois,
      (float*)grad_feat, B, H, W, C, P, spatial_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
