// RoIAlignAvg forward for Hopper (sm_90a), one launch for the whole batch.
//
// Replaces the TPU kernel tllod_tpu/ops/roi_align_pallas.py::_kernel (:33),
// launched by _pallas_forward (:72) through roi_align_avg_pallas (:156). Same
// legacy semantics as tllod_tpu/ops/roi_align.py: for each RoI row
// (b, x1, y1, x2, y2), scaled by spatial_scale, an S x S grid of sample points
// (S = P + 1) at start + k * bin with bin = max(extent + 1, 0) / (S - 1); one
// bilinear sample per point from the 2x2 neighbourhood anchored at
// min(floor(y), H - 2) / min(floor(x), W - 2), so the last row or column
// extrapolates; a point outside [0, H) x [0, W) is exactly 0. RoIAlignAvg then
// takes the 2x2 stride-1 mean of the S x S samples down to P x P.
//
// Design. The Pallas kernel walks one RoI per grid step with the map held in
// VMEM and loops over images with a select. Here one block covers one RoI and
// 128 channels, and the batch index is read from rois[r, 0], so all images go
// in one launch. Threads run along C: the map is NHWC, so the four corner
// reads of a sample coalesce, and so do the output stores. The 2x2 average is
// fused: each thread keeps the previous row of S samples in registers and
// writes output row i - 1 as soon as sample row i is done, so no S x S
// intermediate goes to device memory and each sample is computed once.
// Arithmetic is float32 for float32 and bfloat16 maps; the output is stored in
// the map's type. Built with -fmad=false so every rounding matches the plain
// PyTorch version (tllod_torch/ops/roi_align.py) operation for operation.
//
// Bound. The work is a gather: per RoI, S*S*4 reads of C channels from a map
// that is read again by every RoI, and P*P*C outputs written once. At eval
// batch 1 (600 x 1200 image, 37 x 75 x 512 f32 map, 300 RoIs, P = 7) the map
// is 5.7 MB, which stays in the 50 MB L2, and the output is 30.1 MB: the
// bound is the bytes, about 35.8 MB over 3.35 TB/s, ~11 us. The arithmetic
// (about 0.14 GFLOP) is far below the float32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSamples = 16;  // S = P + 1 <= 16
constexpr int kThreads = 128;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_avg_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                     T* __restrict__ out, int B, int H, int W, int C, int P,
                     float spatial_scale) {
  const int r = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= C) return;
  const int S = P + 1;
  const float* roi = rois + (size_t)r * 5;
  T* out_r = out + (size_t)r * P * P * C + c;

  const int b = (int)roi[0];
  if (b < 0 || b >= B) {  // no such image: zeros, as the plain version
    for (int k = 0; k < P * P; ++k) store_f(out_r + (size_t)k * C, 0.0f);
    return;
  }
  const float x1 = roi[1] * spatial_scale;
  const float y1 = roi[2] * spatial_scale;
  const float x2 = roi[3] * spatial_scale;
  const float y2 = roi[4] * spatial_scale;
  const float roi_w = fmaxf(x2 - x1 + 1.0f, 0.0f);
  const float roi_h = fmaxf(y2 - y1 + 1.0f, 0.0f);
  const float bin_w = roi_w / (float)(S - 1);
  const float bin_h = roi_h / (float)(S - 1);
  const float fh = (float)H, fw = (float)W;
  const T* fb = feat + (size_t)b * H * W * C + c;

  float prev[kMaxSamples], cur[kMaxSamples];
  for (int i = 0; i < S; ++i) {
    const float yy = y1 + (float)i * bin_h;
    const bool in_y = (yy >= 0.0f) && (yy < fh);
    const float y0 = fminf(floorf(yy), fh - 2.0f);
    const float hr = yy - y0;
    const int y0i = min(max((int)y0, 0), H - 2);
    const T* row0 = fb + (size_t)y0i * W * C;
    const T* row1 = row0 + (size_t)W * C;
#pragma unroll
    for (int j = 0; j < kMaxSamples; ++j) {
      if (j < S) {
        const float xx = x1 + (float)j * bin_w;
        const bool inside = in_y && (xx >= 0.0f) && (xx < fw);
        const float x0 = fminf(floorf(xx), fw - 2.0f);
        const float wr = xx - x0;
        const int x0i = min(max((int)x0, 0), W - 2);
        const float ul = load_f(row0 + (size_t)x0i * C);
        const float ur = load_f(row0 + (size_t)(x0i + 1) * C);
        const float dl = load_f(row1 + (size_t)x0i * C);
        const float dr = load_f(row1 + (size_t)(x0i + 1) * C);
        const float val = ul * (1.0f - hr) * (1.0f - wr)
                          + ur * (1.0f - hr) * wr
                          + dl * hr * (1.0f - wr)
                          + dr * hr * wr;
        cur[j] = inside ? val : 0.0f;
      }
    }
    if (i > 0) {
      T* o = out_r + (size_t)(i - 1) * P * C;
#pragma unroll
      for (int j = 0; j < kMaxSamples - 1; ++j) {
        if (j < P) {
          const float v = (prev[j] + prev[j + 1] + cur[j] + cur[j + 1]) * 0.25f;
          store_f(o + (size_t)j * C, v);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxSamples; ++j) prev[j] = cur[j];
  }
}

}  // namespace

extern "C" {

const char* tllod_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

int tllod_roi_align_max_out_size() { return kMaxSamples - 1; }

// feat: (B, H, W, C) contiguous, dtype 0 = float32, 1 = bfloat16;
// rois: (R, 5) float32; out: (R, P, P, C) in feat's dtype.
int tllod_roi_align_avg_forward(const void* feat, const void* rois, void* out,
                                int dtype, int B, int H, int W, int C, int R,
                                int P, float spatial_scale, void* stream) {
  if (R == 0 || C == 0) return 0;
  if (P < 1 || P + 1 > kMaxSamples || H < 2 || W < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(R, (C + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    roi_align_avg_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)feat, (const float*)rois, (float*)out, B, H, W, C, P,
        spatial_scale);
  } else if (dtype == 1) {
    roi_align_avg_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)feat, (const float*)rois, (__nv_bfloat16*)out, B,
        H, W, C, P, spatial_scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
