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
// each 2 x 2 window of samples (an odd G drops its last sample row and
// column); without it P = G and the samples are the output. Samples are
// float32 whatever the map's type (a bfloat16 map is promoted by the
// float32 weights, as in JAX), so the output is float32. The batch index b
// follows JAX's roi_crop (jnp.take on the flattened map): b in [-B, 0)
// reads image b + B, forward and backward; b outside [-B, B) gives NaN in
// every output (every point is clipped into the map) and no gradient.
// Built with -fmad=false, so every product and sum rounds where the plain
// version's does and the forward is bit-equal to it.
//
// Bound. At eval batch 1 (1 x 37 x 75 x 512 float32 map, 300 RoIs, G = 14
// with the max) the map is 5.7 MB, read from L2 after its first touch, and
// the output 30.1 MB: 35.8 MB at 3.35 TB/s, 10.7 us. The work is a few
// operations per corner, far under the card's rates: bytes bound it.
//
// What both kernels share. A block takes one RoI and one slice of
// channels. Warp 0 lays out the x axis and warp 1 the y axis (build_axis):
// lane t takes the t-th sample in ascending map order (the samples run the
// other way when x2 < x1), and one prefix sum across the warp gives the
// RoI's footprint on that axis, every distinct corner row (column) once,
// ascending, and each sample's index in it; G <= 32 samples need up to 64.
// The crop clips its points into the map, so every sample has its two
// corners. A sample's four corners are read straight from the map through
// L1, 4 channels a load (16 bytes of float32, 8 of bfloat16), the 16 loads
// of a window independent. Neither kernel stages the footprint in shared
// memory as csrc/roi_align.cu does: at G = 14 with the max a RoI's
// footprint of up to 28 x 28 pixels took several serial copy-and-wait
// rounds, slower than the direct loads.
//
// Forward: 128 bytes of each pixel a block (32 float32 or 64 bfloat16
// channels), 128 threads as 8 lanes times 16 slots. A slot takes one output
// at a time: its window's four samples (or its one sample) in the plain
// version's expression, the 2 x 2 max in registers, written into a
// (channel, P, P) tile in shared memory, which goes to (R, C, P, P) as one
// contiguous run with 16-byte stores: the order fc6 flattens in, so the
// (R, P, P, C) view the wrapper returns flattens with no copy. The tile
// takes fewer channels where P is large (G = 32 without the max: 16).
//
// Backward: 32 channels a block, in two passes. It reads its tile of the
// output gradient in the layout it arrives in, (R, C, P, P) through fc6's
// flatten or (R, P, P, C), into shared memory as [output][channel]. With
// the max, a thread takes 4 channels of one
// window at a time: its four samples recomputed bit-equal to the forward's
// (so it finds the same maxima; a tie mask saved by the forward would be
// another output kept alive for the whole step), and each sample's share
// kept in shared memory: g / n for each of the n samples equal to the max,
// JAX's and torch.amax's split among ties (clipped points and zero-size
// RoIs make 2- to 4-way ties common), 0 for the others; without the max a
// sample's share is its output's gradient. A window whose gradient is 0
// in the thread's 4 channels is not sampled, and a block whose whole
// gradient tile is 0 stops once it has loaded it: a step's crop gradient
// is 0 at most samples of some sites (DAF's target, ATF's 2000 RoIs).
// Then the shares are merged within the block: a thread takes 8 channels
// (4 without the max, where a pixel takes fewer samples) of one footprint
// pixel at a time and gathers, in a fixed order (sample
// row, then column), the term
// share * (wx * wy) of every sample whose corners include the pixel (one
// FMA a term; the plain version rounds share * wx first, a difference of
// rounding that the gate's tolerance holds), and the pixel leaves the block
// as one 16-byte atomicAdd a 4 channels into the float32 map gradient,
// which the wrapper zeroes first (none for 4 channels that are all 0). So
// there is one atomic per distinct (pixel, 4 channels) of a RoI, not one
// per sample, corner and channel. The sum over RoIs is still taken by
// atomics in an order that varies by run. Both passes are bound by
// instructions and latency, not by bytes or atomics (PERF.md, section 6).
//
// Any C is taken: where C is not a multiple of a 16-byte vector (or a
// pointer not 16-byte aligned) the loads, the stores and the atomics go
// one value at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGrid = 32;              // G <= 32
constexpr int kMaxFoot = 2 * kMaxGrid;    // distinct rows (columns) of a RoI
constexpr int kThreads = 128;
constexpr int kLine = 128;                // forward: bytes of a pixel a block
constexpr int kOutBytes = 65536;          // forward: the output tile, most
constexpr int kTileB = 32;                // backward: channels a block takes
constexpr int kRowB = kTileB + 4;         // backward: g's tile row, padded
constexpr int kLanesW = kTileB / 4;       // backward windows: 4 channels

// One axis of a RoI's sample grid, in shared memory.
struct Axis {
  int n;                  // footprint: distinct map rows (columns) touched
  int map[kMaxFoot];      // footprint index -> map row (column), ascending
  int pos[kMaxGrid];      // sample -> footprint index of its top (left)
                          // corner
  float frac[kMaxGrid];   // hr (wr)
  int lo[kMaxFoot];       // backward: the samples whose corners include
  int hi[kMaxFoot];       // footprint index f are lo[f] .. hi[f]
};

// jnp.linspace(-1, 1, G)[k] as XLA computes it under jit
__device__ __forceinline__ float lin_point(int k, int G) {
  if (G == 1) return -1.0f;
  if (k == G - 1) return 1.0f;
  const float s = (float)k * (1.0f / (float)(G - 1));
  return s - (1.0f - s);
}

// One warp lays out one axis of n_used samples (of G grid points) from the
// RoI's two raw coordinates: lane t takes the t-th sample in ascending map
// order. The points are monotone in k (an affine map, clipped and rounded),
// so the corners are too: a sample adds its two corners after a gap, one
// when it steps by one, none when it shares the previous sample's.
__device__ __forceinline__ void build_axis(float raw1, float raw2, int size,
                                           int G, int n_used, Axis& ax) {
  const int t = threadIdx.x & 31;
  const float a1 = raw1 * 0.0625f;
  const float a2 = raw2 * 0.0625f;
  const float rc = 1.0f / (float)(size - 1);
  const float t1 = (a2 - a1) * rc;
  const float t3 = ((a1 + a2) + (float)(1 - size)) * rc;
  const bool dec = t1 < 0.0f;
  const int k = dec ? n_used - 1 - t : t;
  const bool in = t < n_used;
  int a = 0;
  float frac = 0.0f;
  if (in) {
    const float nrm =
        (float)((double)t1 * (double)lin_point(k, G) + (double)t3);
    float v = (nrm + 1.0f) * (0.5f * (float)(size - 1));
    v = fminf(fmaxf(v, 0.0f), (float)(size - 1));
    const float v0 = fminf(floorf(v), (float)(size - 2));
    frac = v - v0;
    a = min(max((int)v0, 0), size - 2);
  }
  const int prev = __shfl_up_sync(~0u, a, 1);
  const int cnt = !in ? 0 : t == 0 ? 2 : a == prev ? 0
                : a == prev + 1 ? 1 : 2;
  int end = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(~0u, end, d);
    if (t >= d) end += u;
  }
  if (in) {
    ax.pos[k] = end - 2;
    ax.frac[k] = frac;
  }
  if (cnt == 2) ax.map[end - 2] = a;
  if (cnt >= 1) ax.map[end - 1] = a + 1;
  if (t == 31) ax.n = end;
}

// The same warp, after build_axis: for each footprint index, the range of
// samples whose two corners include it (contiguous: the corners are
// monotone in the sample).
__device__ __forceinline__ void build_ranges(int n_used, Axis& ax) {
  __syncwarp();
  for (int f = threadIdx.x & 31; f < ax.n; f += 32) {
    int lo = n_used, hi = -1;
    for (int k = 0; k < n_used; ++k) {
      const int p = ax.pos[k];
      if (p == f || p + 1 == f) {
        lo = min(lo, k);
        hi = max(hi, k);
      }
    }
    ax.lo[f] = lo;
    ax.hi[f] = hi;
  }
}

// warps 0 and 1 lay out the x and y axes (with each footprint index's
// sample range for the backward), thread 0 reads the batch index
__device__ __forceinline__ void build_axes(const float* roi, int H, int W,
                                           int G, int n_used, bool ranges,
                                           Axis& ay, Axis& ax, int& b) {
  if (threadIdx.x < 32) {
    build_axis(roi[1], roi[3], W, G, n_used, ax);
    if (ranges) build_ranges(n_used, ax);
    if (threadIdx.x == 0) b = (int)roi[0];
  } else if (threadIdx.x < 64) {
    build_axis(roi[2], roi[4], H, G, n_used, ay);
    if (ranges) build_ranges(n_used, ay);
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// N values of T at p (16-byte aligned for float, 8 for bfloat16 x 4) to
// floats
template <int N>
__device__ __forceinline__ void to_floats(const float* p, float* v) {
#pragma unroll
  for (int q = 0; q < N; q += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + q);
    v[q] = f.x; v[q + 1] = f.y; v[q + 2] = f.z; v[q + 3] = f.w;
  }
}
template <int N>
__device__ __forceinline__ void to_floats(const __nv_bfloat16* p, float* v) {
#pragma unroll
  for (int q = 0; q < N; q += 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p + q);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[q] = a.x; v[q + 1] = a.y; v[q + 2] = b.x; v[q + 3] = b.y;
  }
}

// 4 channels of sample (k, l) read from the map itself: `fb` points at
// the image's channel of the thread's first; vec: 16-byte (8 for
// bfloat16) loads, else the first nv channels one at a time
template <typename T>
__device__ __forceinline__ void sample_map(const T* __restrict__ fb,
                                           const Axis& ay, const Axis& ax,
                                           int k, int l, int W, int C,
                                           bool vec, int nv, float* val) {
  const float hr = ay.frac[k], wr = ax.frac[l];
  const T* top = fb + ((size_t)ay.map[ay.pos[k]] * W + ax.map[ax.pos[l]]) *
                          C;
  const T* bot = top + (size_t)W * C;
  float ul[4], ur[4], dl[4], dr[4];
  if (vec) {
    to_floats<4>(top, ul);
    to_floats<4>(top + C, ur);
    to_floats<4>(bot, dl);
    to_floats<4>(bot + C, dr);
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const bool in = v < nv;
      ul[v] = in ? to_f(top[v]) : 0.0f;
      ur[v] = in ? to_f(top[C + v]) : 0.0f;
      dl[v] = in ? to_f(bot[v]) : 0.0f;
      dr[v] = in ? to_f(bot[C + v]) : 0.0f;
    }
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    val[v] = ul[v] * (1.0f - hr) * (1.0f - wr) + ur[v] * (1.0f - hr) * wr
             + dl[v] * hr * (1.0f - wr) + dr[v] * hr * wr;
  }
}

// RoICrop forward: (B, H, W, C) map -> (R, C, P, P) float32. `tile`:
// channels a block takes (128 bytes of a pixel, fewer where the (channel,
// P, P) tile would pass kOutBytes); vec: C a multiple of 16 bytes and the
// map 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_crop_forward_kernel(const T* __restrict__ feat,
                        const float* __restrict__ rois,
                        float* __restrict__ out, int B, int H, int W, int C,
                        int G, int max_pool, int tile, int vec) {
  constexpr int kVec = 16 / sizeof(T);   // channels a lane computes
  extern __shared__ __align__(16) float otile[];   // [c][PP]
  __shared__ Axis ay, ax;
  __shared__ int s_b;
  const int P = max_pool ? G / 2 : G, PP = P * P;
  const int n_used = max_pool ? 2 * P : G;
  const int r = blockIdx.x, c0 = blockIdx.y * tile;
  const int nch = min(tile, C - c0);
  const int lanes = tile / kVec, slots = kThreads / lanes;
  const int lane = threadIdx.x % lanes, slot = threadIdx.x / lanes;
  const int cb = lane * kVec;
  build_axes(rois + (size_t)r * 5, H, W, G, n_used, false, ay, ax, s_b);
  __syncthreads();
  const int b = s_b < 0 ? s_b + B : s_b;
  if (b < 0 || b >= B) {
    for (int it = threadIdx.x; it < nch * PP; it += kThreads) {
      otile[it] = __int_as_float(0x7fc00000);
    }
  } else {
    // a slot takes one output at a time: its window's four samples (or its
    // one sample) from independent vector loads, the max in registers
    const T* fb = feat + (size_t)b * H * W * C + c0 + cb;
    const int nv = min(kVec, nch - cb);
    for (int t = slot; cb < nch && t < PP; t += slots) {
      const int i = t / P, j = t % P;
      float m[kVec];
#pragma unroll
      for (int h = 0; h < kVec; h += 4) {
        if (max_pool) {
          sample_map(fb + h, ay, ax, 2 * i, 2 * j, W, C, vec, nv - h, m + h);
#pragma unroll
          for (int q = 1; q < 4; ++q) {
            float s[4];
            sample_map(fb + h, ay, ax, 2 * i + q / 2, 2 * j + q % 2, W, C,
                       vec, nv - h, s);
#pragma unroll
            for (int v = 0; v < 4; ++v) m[h + v] = fmaxf(m[h + v], s[v]);
          }
        } else {
          sample_map(fb + h, ay, ax, i, j, W, C, vec, nv - h, m + h);
        }
      }
#pragma unroll
      for (int v = 0; v < kVec; ++v) otile[(size_t)(cb + v) * PP + t] = m[v];
    }
  }
  __syncthreads();
  // (R, C, P, P): this block's channels are one contiguous run
  float* dst = out + ((size_t)r * C + c0) * PP;
  const int n = nch * PP;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && n % 4 == 0) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(otile);
    for (int it = threadIdx.x; it < n / 4; it += kThreads) d4[it] = s4[it];
  } else {
    for (int it = threadIdx.x; it < n; it += kThreads) dst[it] = otile[it];
  }
}

// The backward's merge: a thread takes VEC channels of one footprint
// pixel at a time and gathers, k then l, the terms share * (wx * wy) of the
// samples whose corners include the pixel (sample (k, l)'s share at sh[(k *
// n + l) * row + channel]), then sends the sums to the map gradient as one
// 16-byte atomicAdd a 4 channels (none for 4 that are all 0).
template <int VEC>
__device__ __forceinline__ void gather(const float* sh, int n, int row,
                                       const Axis& ay, const Axis& ax,
                                       float* __restrict__ grad_feat, int b,
                                       int H, int W, int C, int c0, int nch,
                                       int gvec) {
  constexpr int kLanes = kTileB / VEC;
  const int cg = threadIdx.x % kLanes * VEC, slot = threadIdx.x / kLanes;
  if (cg >= nch) return;
  const int nv = min(VEC, nch - cg);
  float* gb = grad_feat + (size_t)b * H * W * C + c0 + cg;
  const int nx = ax.n;
  for (int px = slot; px < ay.n * nx; px += kThreads / kLanes) {
    const int fr = px / nx, fc = px % nx;
    const int llo = ax.lo[fc], lhi = ax.hi[fc];
    float a[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) a[v] = 0.0f;
    for (int k = ay.lo[fr]; k <= ay.hi[fr]; ++k) {
      const float wy = ay.pos[k] == fr ? 1.0f - ay.frac[k] : ay.frac[k];
      for (int l = llo; l <= lhi; ++l) {
        const float w =
            (ax.pos[l] == fc ? 1.0f - ax.frac[l] : ax.frac[l]) * wy;
        const float* g = sh + ((size_t)k * n + l) * row + cg;
#pragma unroll
        for (int h = 0; h < VEC; h += 4) {
          float s[4];
          to_floats<4>(g + h, s);
#pragma unroll
          for (int v = 0; v < 4; ++v) a[h + v] = __fmaf_rn(s[v], w, a[h + v]);
        }
      }
    }
    float* p = gb + ((size_t)ay.map[fr] * W + ax.map[fc]) * C;
#pragma unroll
    for (int h = 0; h < VEC; h += 4) {
      if (a[h] == 0.0f && a[h + 1] == 0.0f && a[h + 2] == 0.0f &&
          a[h + 3] == 0.0f) {
        continue;
      }
      if (gvec && h + 4 <= nv) {
        atomicAdd(reinterpret_cast<float4*>(p + h),
                  make_float4(a[h], a[h + 1], a[h + 2], a[h + 3]));
      } else {
        for (int v = h; v < min(h + 4, nv); ++v) atomicAdd(p + v, a[v]);
      }
    }
  }
}

// RoICrop backward: the (R, P, P, C) output gradient, (R, C, P, P)- (layout
// 1) or (R, P, P, C)-contiguous (layout 0), into the float32 map gradient.
// vec: the map's C a multiple of 16 bytes and the map 16-byte aligned;
// gvec: C a multiple of 4 and the output and map gradients 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_crop_backward_kernel(const float* __restrict__ grad_out,
                         const T* __restrict__ feat,
                         const float* __restrict__ rois,
                         float* __restrict__ grad_feat, int B, int H, int W,
                         int C, int G, int max_pool, int layout, int vec,
                         int gvec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Axis ay, ax;
  __shared__ int s_b;
  const int P = max_pool ? G / 2 : G, PP = P * P;
  const int n_used = max_pool ? 2 * P : G;
  const int r = blockIdx.x, c0 = blockIdx.y * kTileB;
  const int nch = min(kTileB, C - c0);
  float* gt = reinterpret_cast<float*>(smem);   // g's tile, [o][c]
  float* gs = gt + (size_t)PP * kRowB;          // max: [k][l][c] shares
  build_axes(rois + (size_t)r * 5, H, W, G, n_used, true, ay, ax, s_b);
  __syncthreads();
  const int b = s_b < 0 ? s_b + B : s_b;
  if (b < 0 || b >= B) return;      // no such image: no gradient

  // g's tile as [position][channel], rows padded to kRowB floats: a
  // thread's 4 channels are one 16-byte load
  bool any = false;    // a non-zero value among those this thread loaded
  if (layout == 1) {   // (R, C, P, P): nch * PP contiguous values, read a
                       // value a thread (neighbouring threads' stores then
                       // fall on 8 banks, where a 16-byte load's 4 would
                       // put a warp's on 2)
    const float* src = grad_out + ((size_t)r * C + c0) * PP;
    for (int it = threadIdx.x; it < nch * PP; it += kThreads) {
      const float v = src[it];
      gt[(it % PP) * kRowB + it / PP] = v;
      any |= v != 0.0f;
    }
  } else {             // (R, P, P, C): PP runs of nch channels
    const float* src = grad_out + (size_t)r * PP * C + c0;
    for (int it = threadIdx.x; it < PP * kTileB / 4; it += kThreads) {
      const int o = it / (kTileB / 4), q = it % (kTileB / 4) * 4;
      if (q >= nch) continue;
      if (gvec) {
        const float4 v =
            *reinterpret_cast<const float4*>(src + (size_t)o * C + q);
        *reinterpret_cast<float4*>(gt + o * kRowB + q) = v;
        any |= v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
      } else {
        for (int v = q; v < min(q + 4, nch); ++v) {
          gt[o * kRowB + v] = src[(size_t)o * C + v];
          any |= src[(size_t)o * C + v] != 0.0f;
        }
      }
    }
  }
  // a tile of zeros adds nothing: the block's work ends here
  if (!__syncthreads_or(any)) return;

  if (max_pool) {
    // a thread takes 4 channels of one window at a time: its samples,
    // bit-equal to the forward's, read straight from the map (the
    // window's 16 corner loads are independent, and the block has no
    // staging round trips to wait on); each sample's share of the
    // window's gradient to gs
    const int cb = threadIdx.x % kLanesW * 4, slot = threadIdx.x / kLanesW;
    const int nv = min(4, nch - cb);
    const T* fb = feat + (size_t)b * H * W * C + c0 + cb;
    for (int t = slot; cb < nch && t < PP; t += kThreads / kLanesW) {
      const int i = t / P, j = t % P;
      float s[4][4], g[4];
      to_floats<4>(gt + t * kRowB + cb, g);
      if (g[0] == 0.0f && g[1] == 0.0f && g[2] == 0.0f && g[3] == 0.0f) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {   // no gradient: every share is 0
          *reinterpret_cast<float4*>(
              gs + ((size_t)(2 * i + q / 2) * n_used + 2 * j + q % 2) *
                       kTileB + cb) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        continue;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sample_map(fb, ay, ax, 2 * i + q / 2, 2 * j + q % 2, W, C, vec, nv,
                   s[q]);
      }
      float m[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        m[v] = fmaxf(fmaxf(s[0][v], s[1][v]), fmaxf(s[2][v], s[3][v]));
        const int n = (s[0][v] == m[v]) + (s[1][v] == m[v])
                      + (s[2][v] == m[v]) + (s[3][v] == m[v]);
        g[v] = g[v] / (float)n;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        *reinterpret_cast<float4*>(
            gs + ((size_t)(2 * i + q / 2) * n_used + 2 * j + q % 2) * kTileB
            + cb) = make_float4(s[q][0] == m[0] ? g[0] : 0.0f,
                                s[q][1] == m[1] ? g[1] : 0.0f,
                                s[q][2] == m[2] ? g[2] : 0.0f,
                                s[q][3] == m[3] ? g[3] : 0.0f);
      }
    }
    __syncthreads();
  }

  // the merge: 8 channels a thread with the max (the shares' buffer), 4
  // without (g's tile; a pixel takes fewer samples there)
  if (max_pool) {
    gather<8>(gs, n_used, kTileB, ay, ax, grad_feat, b, H, W, C, c0, nch,
              gvec);
  } else {
    gather<4>(gt, P, kRowB, ay, ax, grad_feat, b, H, W, C, c0, nch, gvec);
  }
}

// dynamic shared memory past 48 KB, with the kernels' static Axis pair
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes + 2 * sizeof(Axis) + sizeof(int) <= 48 * 1024) {
    return cudaSuccess;
  }
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool bad_shape(int dtype, int B, int H, int W, int C, int G, int max_pool) {
  return B < 1 || H < 2 || W < 2 || C < 1 || G < 1 || G > kMaxGrid ||
         (max_pool && G < 2) || (dtype != 0 && dtype != 1);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t launch_forward(const void* feat, const void* rois, void* out,
                           int B, int H, int W, int C, int R, int G,
                           int max_pool, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int P = max_pool ? G / 2 : G;
  int tile = kLine / (int)sizeof(T);
  while (tile > 2 * kVec && (size_t)tile * P * P * 4 > kOutBytes) tile /= 2;
  const size_t bytes = (size_t)tile * P * P * sizeof(float);
  cudaError_t err = allow_smem(roi_crop_forward_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const int vec = C % kVec == 0 && aligned16(feat);
  const dim3 grid(R, (C + tile - 1) / tile);
  roi_crop_forward_kernel<T><<<grid, kThreads, bytes, s>>>(
      (const T*)feat, (const float*)rois, (float*)out, B, H, W, C, G,
      max_pool, tile, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const void* grad_out, const void* feat,
                            const void* rois, void* grad_feat, int layout,
                            int B, int H, int W, int C, int R, int G,
                            int max_pool, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int P = max_pool ? G / 2 : G;
  const int n_used = max_pool ? 2 * P : G;
  // g's tile, and with the max the samples' shares
  const size_t bytes =
      ((size_t)P * P * kRowB + (max_pool ? (size_t)n_used * n_used * kTileB
                                         : 0)) * sizeof(float);
  cudaError_t err = allow_smem(roi_crop_backward_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const int vec = C % kVec == 0 && aligned16(feat);
  const int gvec = C % 4 == 0 && aligned16(grad_out) && aligned16(grad_feat);
  const dim3 grid(R, (C + kTileB - 1) / kTileB);
  roi_crop_backward_kernel<T><<<grid, kThreads, bytes, s>>>(
      (const float*)grad_out, (const T*)feat, (const float*)rois,
      (float*)grad_feat, B, H, W, C, G, max_pool, layout, vec, gvec);
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
