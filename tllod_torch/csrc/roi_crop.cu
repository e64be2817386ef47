// RoICrop forward and backward for Hopper (sm_90a), float32 and bfloat16
// maps, one launch each for the whole batch.
//
// They replace the JAX package's crop, tllod_tpu/ops/roi_crop.py::roi_crop
// (:85) with affine_grid_points (:25), an XLA gather there and JAX's
// transpose of it; the reference's hand kernel was the bilinear sampler of
// lib/model/roi_crop/src/roi_crop_cuda_kernel.cu.
//
// Semantics (those of tllod_torch/ops/roi_crop.py::roi_crop_plain): each RoI
// row (b, x1, y1, x2, y2) in input pixels, divided by 16 whatever the
// feature stride, gives an affine map from a G x G grid in [-1, 1] to the
// map; along x (y the same with H):
//   lin_k = s_k - (1 - s_k), s_k = k * fl(1 / (G - 1)), lin_{G-1} = 1
//           (jnp.linspace(-1, 1, G) as XLA computes it under jit);
//   t11 = (x2 - x1) * fl(1 / (W - 1)), t13 = ((x1 + x2) + (1 - W)) *
//           fl(1 / (W - 1))   (XLA's reciprocal of a constant divisor);
//   nx = t11 * lin_l + t13, one multiply-add (XLA contracts it under jit;
//           here, as in the plain version, in double and rounded to float);
//   x = clamp((nx + 1) * ((W - 1) / 2), 0, W - 1).
// The grid is separable: sample (k, l) sits at (y_k, x_l). One bilinear
// sample per point from the 2x2 neighbourhood anchored at min(floor(v),
// size - 2), in the plain version's four-term expression, so a point on the
// last row puts weight 1 on row H - 1. With max_pool
// (CROP_RESIZE_WITH_MAX_POOL) the output P x P = (G / 2)^2 takes the max of
// each 2 x 2 window of samples; without it P = G and the samples are the
// output. Samples are float32 whatever the map's type (a bfloat16 map is
// promoted by the float32 weights, as in JAX), so the output is float32. A
// RoI whose batch index names no image gives zeros and no gradient. Built
// with -fmad=false, so every product and sum rounds where the plain
// version's does and the forward is bit-equal to it.
//
// What bounds them. At eval batch 1 (1 x 37 x 75 x 512 float32 map, 300
// RoIs, G = 14 with the max) the map is 5.7 MB, read from L2 after its
// first touch, and the output 30.1 MB: 35.8 MB at 3.35 TB/s, 10.7 us. The
// work is 4 G^2 corner loads per (RoI, channel) and a few operations each:
// far under the card's rates. So bytes, and in this simple design the
// number of load requests.
//
// Design (a simple first kernel; a redesign such as RoIAlign's footprint
// staging in csrc/roi_align.cu is later work). A block takes one RoI and 32
// channels, 256 threads: one lane a channel, 8 rows of lanes taking the P x
// P outputs in turn. Warps 0 and 1 first compute the RoI's G x positions
// and G y positions (corner index and fraction) into shared memory. The
// forward computes each output's 4 (with the max) or 1 samples from the
// map, a warp reading 32 neighbouring channels of a pixel, into a (channel,
// P, P) tile in shared memory, stored to (R, C, P, P) as one contiguous run:
// the order fc6 flattens in, so the (R, P, P, C) view the wrapper returns
// flattens with no copy.
//
// The backward recomputes the window's 4 samples from the map (bit-equal to
// the forward's, so it finds the same maxima) rather than reading a tie
// mask saved by the forward: the map is 5.7 MB and stays in L2, where a
// mask would be another output of the forward (a byte per output, 7.5 MB at
// 300 RoIs) kept alive for the whole step. Each of the n samples equal to
// the window's max gets g / n, JAX's and torch.amax's equal split of the
// gradient among ties (clipped points and zero-size RoIs make 2- to 4-way
// ties common); each sample's share goes to its four corners with the
// forward's weights, in the plain version's product order, by float32
// atomicAdd into the map gradient, which the wrapper zeroes first. The sum
// over samples and RoIs is taken by atomics in an order that varies by run.
// The output gradient is read in the layout it arrives in, (R, C, P, P)
// (through fc6's flatten) or (R, P, P, C), staged through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGrid = 32;          // G <= 32
constexpr int kTile = 32;             // channels a block takes, one a lane
constexpr int kRows = 8;              // rows of lanes
constexpr int kThreads = kTile * kRows;

// One axis of a RoI's sample grid, in shared memory.
struct Axis {
  int lo[kMaxGrid];     // top (left) corner, in [0, size - 2]
  float frac[kMaxGrid]; // hr (wr)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// jnp.linspace(-1, 1, G)[k] as XLA computes it under jit
__device__ __forceinline__ float lin_point(int k, int G) {
  if (G == 1) return -1.0f;
  if (k == G - 1) return 1.0f;
  const float s = (float)k * (1.0f / (float)(G - 1));
  return s - (1.0f - s);
}

// position k of one axis from the RoI's two raw coordinates
__device__ __forceinline__ void build_axis(float raw1, float raw2, int size,
                                           int G, int k, Axis& ax) {
  const float a1 = raw1 * 0.0625f;
  const float a2 = raw2 * 0.0625f;
  const float rc = 1.0f / (float)(size - 1);
  const float t1 = (a2 - a1) * rc;
  const float t3 = ((a1 + a2) + (float)(1 - size)) * rc;
  const float n =
      (float)((double)t1 * (double)lin_point(k, G) + (double)t3);
  float v = (n + 1.0f) * (0.5f * (float)(size - 1));
  v = fminf(fmaxf(v, 0.0f), (float)(size - 1));
  const float v0 = fminf(floorf(v), (float)(size - 2));
  ax.frac[k] = v - v0;
  ax.lo[k] = min(max((int)v0, 0), size - 2);
}

// warp 0: the x axis, warp 1: the y axis; thread 0 the batch index
__device__ __forceinline__ void build_axes(const float* roi, int H, int W,
                                           int G, Axis& ay, Axis& ax,
                                           int& b) {
  const int t = threadIdx.x;
  if (t < G) build_axis(roi[1], roi[3], W, G, t, ax);
  if (t >= 32 && t < 32 + G) build_axis(roi[2], roi[4], H, G, t - 32, ay);
  if (t == 0) b = (int)roi[0];
}

// sample (k, l) of channel c: fb points at the image's channel c
template <typename T>
__device__ __forceinline__ float sample(const T* __restrict__ fb,
                                        const Axis& ay, const Axis& ax,
                                        int k, int l, int W, int C) {
  const float hr = ay.frac[k], wr = ax.frac[l];
  const T* p = fb + ((size_t)ay.lo[k] * W + ax.lo[l]) * C;
  const size_t down = (size_t)W * C;
  const float ul = to_f(p[0]), ur = to_f(p[C]);
  const float dl = to_f(p[down]), dr = to_f(p[down + C]);
  return ul * (1.0f - hr) * (1.0f - wr) + ur * (1.0f - hr) * wr
         + dl * hr * (1.0f - wr) + dr * hr * wr;
}

// RoICrop forward: (B, H, W, C) map -> (R, C, P, P) float32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_crop_forward_kernel(const T* __restrict__ feat,
                        const float* __restrict__ rois,
                        float* __restrict__ out, int B, int H, int W, int C,
                        int G, int max_pool) {
  extern __shared__ float tile[];   // [channel][P * P]
  __shared__ Axis ay, ax;
  __shared__ int s_b;
  const int P = max_pool ? G / 2 : G, PP = P * P;
  const int r = blockIdx.x, c0 = blockIdx.y * kTile;
  build_axes(rois + (size_t)r * 5, H, W, G, ay, ax, s_b);
  __syncthreads();
  const int b = s_b;
  const bool has_image = b >= 0 && b < B;
  const int lane = threadIdx.x % kTile, row = threadIdx.x / kTile;
  const int nch = min(kTile, C - c0);
  if (lane < nch) {
    const T* fb = feat + (size_t)(has_image ? b : 0) * H * W * C + c0 + lane;
    for (int o = row; o < PP; o += kRows) {
      const int i = o / P, j = o % P;
      float v = 0.0f;
      if (has_image && max_pool) {
        v = sample(fb, ay, ax, 2 * i, 2 * j, W, C);
        v = fmaxf(v, sample(fb, ay, ax, 2 * i, 2 * j + 1, W, C));
        v = fmaxf(v, sample(fb, ay, ax, 2 * i + 1, 2 * j, W, C));
        v = fmaxf(v, sample(fb, ay, ax, 2 * i + 1, 2 * j + 1, W, C));
      } else if (has_image) {
        v = sample(fb, ay, ax, i, j, W, C);
      }
      tile[lane * PP + o] = v;
    }
  }
  __syncthreads();
  // (R, C, P, P): this block's channels are one contiguous run
  float* dst = out + ((size_t)r * C + c0) * PP;
  for (int it = threadIdx.x; it < nch * PP; it += kThreads) {
    dst[it] = tile[it];
  }
}

// one sample's gradient share gs to its four corners, in the plain
// version's product order (autograd through ul * (1 - hr) * (1 - wr) gives
// ul the term gs * (1 - wr) * (1 - hr))
__device__ __forceinline__ void scatter(float* __restrict__ gb,
                                        const Axis& ay, const Axis& ax,
                                        int k, int l, int W, int C,
                                        float gs) {
  const float hr = ay.frac[k], wr = ax.frac[l];
  float* p = gb + ((size_t)ay.lo[k] * W + ax.lo[l]) * C;
  const size_t down = (size_t)W * C;
  atomicAdd(p, gs * (1.0f - wr) * (1.0f - hr));
  atomicAdd(p + C, gs * wr * (1.0f - hr));
  atomicAdd(p + down, gs * (1.0f - wr) * hr);
  atomicAdd(p + down + C, gs * wr * hr);
}

// RoICrop backward: the (R, P, P, C) output gradient, (R, C, P, P)- (layout
// 1) or (R, P, P, C)-contiguous (layout 0), into the float32 map gradient.
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_crop_backward_kernel(const float* __restrict__ grad_out,
                         const T* __restrict__ feat,
                         const float* __restrict__ rois,
                         float* __restrict__ grad_feat, int B, int H, int W,
                         int C, int G, int max_pool, int layout) {
  extern __shared__ float gt[];     // [channel][P * P]
  __shared__ Axis ay, ax;
  __shared__ int s_b;
  const int P = max_pool ? G / 2 : G, PP = P * P;
  const int r = blockIdx.x, c0 = blockIdx.y * kTile;
  build_axes(rois + (size_t)r * 5, H, W, G, ay, ax, s_b);
  const int nch = min(kTile, C - c0);
  if (layout == 1) {   // (R, C, P, P): nch * PP contiguous values
    const float* src = grad_out + ((size_t)r * C + c0) * PP;
    for (int it = threadIdx.x; it < nch * PP; it += kThreads) {
      gt[it] = src[it];
    }
  } else {             // (R, P, P, C): PP runs of nch channels
    const float* src = grad_out + (size_t)r * PP * C + c0;
    for (int it = threadIdx.x; it < PP * kTile; it += kThreads) {
      const int o = it / kTile, c = it % kTile;
      if (c < nch) gt[c * PP + o] = src[(size_t)o * C + c];
    }
  }
  __syncthreads();
  const int b = s_b;
  if (b < 0 || b >= B) return;      // no such image: no gradient
  const int lane = threadIdx.x % kTile, row = threadIdx.x / kTile;
  if (lane >= nch) return;
  const size_t img = (size_t)b * H * W * C + c0 + lane;
  const T* fb = feat + img;
  float* gb = grad_feat + img;
  for (int o = row; o < PP; o += kRows) {
    const float g = gt[lane * PP + o];
    if (g == 0.0f) continue;        // adds nothing
    const int i = o / P, j = o % P;
    if (!max_pool) {
      scatter(gb, ay, ax, i, j, W, C, g);
      continue;
    }
    float s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s[q] = sample(fb, ay, ax, 2 * i + q / 2, 2 * j + q % 2, W, C);
    }
    const float m = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
    int n = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) n += s[q] == m;
    const float gs = g / (float)n;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (s[q] == m) scatter(gb, ay, ax, 2 * i + q / 2, 2 * j + q % 2, W, C,
                             gs);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool bad_shape(int dtype, int B, int H, int W, int C, int G, int max_pool) {
  return B < 1 || H < 2 || W < 2 || C < 1 || G < 1 || G > kMaxGrid ||
         (max_pool && G < 2) || (dtype != 0 && dtype != 1);
}

template <typename T>
cudaError_t launch_forward(const void* feat, const void* rois, void* out,
                           int B, int H, int W, int C, int R, int G,
                           int max_pool, cudaStream_t s) {
  const int P = max_pool ? G / 2 : G;
  const size_t bytes = (size_t)kTile * P * P * sizeof(float);
  cudaError_t err = allow_smem(roi_crop_forward_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(R, (C + kTile - 1) / kTile);
  roi_crop_forward_kernel<T><<<grid, kThreads, bytes, s>>>(
      (const T*)feat, (const float*)rois, (float*)out, B, H, W, C, G,
      max_pool);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const void* grad_out, const void* feat,
                            const void* rois, void* grad_feat, int layout,
                            int B, int H, int W, int C, int R, int G,
                            int max_pool, cudaStream_t s) {
  const int P = max_pool ? G / 2 : G;
  const size_t bytes = (size_t)kTile * P * P * sizeof(float);
  cudaError_t err = allow_smem(roi_crop_backward_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(R, (C + kTile - 1) / kTile);
  roi_crop_backward_kernel<T><<<grid, kThreads, bytes, s>>>(
      (const float*)grad_out, (const T*)feat, (const float*)rois,
      (float*)grad_feat, B, H, W, C, G, max_pool, layout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tllod_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// feat: (B, H, W, C) contiguous, dtype 0 = float32, 1 = bfloat16; rois:
// (R, 5) float32; out: (R, C, P, P) float32, P = G / 2 with max_pool, else
// G.
int tllod_roi_crop_forward(const void* feat, const void* rois, void* out,
                           int dtype, int B, int H, int W, int C, int R,
                           int G, int max_pool, void* stream) {
  if (bad_shape(dtype, B, H, W, C, G, max_pool)) {
    return (int)cudaErrorInvalidValue;
  }
  if (R == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? launch_forward<float>(feat, rois, out, B, H, W, C, R, G,
                                           max_pool, s)
                   : launch_forward<__nv_bfloat16>(feat, rois, out, B, H, W,
                                                   C, R, G, max_pool, s));
}

// grad_out: the float32 output gradient, (R, P, P, C)-contiguous (layout 0)
// or (R, C, P, P)-contiguous (layout 1); feat: the forward's map (read for
// the maxima when max_pool); rois: (R, 5) float32; grad_feat: (B, H, W, C)
// float32, zeroed by the caller and accumulated into. Launches the kernel
// and nothing else.
int tllod_roi_crop_backward(const void* grad_out, const void* feat,
                            const void* rois, void* grad_feat, int dtype,
                            int layout, int B, int H, int W, int C, int R,
                            int G, int max_pool, void* stream) {
  if (bad_shape(dtype, B, H, W, C, G, max_pool) ||
      (layout != 0 && layout != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (R == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? launch_backward<float>(grad_out, feat, rois, grad_feat,
                                            layout, B, H, W, C, R, G,
                                            max_pool, s)
                   : launch_backward<__nv_bfloat16>(
                         grad_out, feat, rois, grad_feat, layout, B, H, W, C,
                         R, G, max_pool, s));
}

}  // extern "C"
