// RoIAlignAvg forward and backward for Hopper (sm_90a), one launch each for
// the whole batch.
//
// Semantics are those of tllod_tpu/ops/roi_align.py (legacy reference): for
// each RoI row (b, x1, y1, x2, y2), scaled by spatial_scale, an S x S grid of
// sample points (S = P + 1) at start + k * bin with bin = max(extent + 1, 0)
// / (S - 1); one bilinear sample per point from the 2x2 neighbourhood
// anchored at min(floor(y), H - 2) / min(floor(x), W - 2), so the last row or
// column extrapolates; a point outside [0, H) x [0, W) gives exactly 0.
// RoIAlignAvg then takes the 2x2 stride-1 mean of the S x S samples down to
// P x P. The batch index b follows JAX's model path (jnp.take on the
// flattened map): b in [-B, 0) reads image b + B, forward and backward; b
// outside [-B, B) gives NaN at every in-map sample, so an output bin is NaN
// where any of its four samples lies in the map, and no map gradient.
//
// What both kernels share. A block takes one RoI and one slice of channels.
// Warp 0 first lays out the RoI's two axes in shared memory (build_axes):
// for each sample row and column its fractional weight (hr, wr) and the
// index, in a short ascending list of map rows and columns, of its top (left)
// corner. The coordinates are nondecreasing along a sample row and column, so
// the distinct rows and columns the in-map samples touch come out of one
// prefix sum across the lanes: the RoI's footprint, at most 2S x 2S pixels,
// every distinct corner once. The coordinates are computed in the same
// operations as the plain version and the kernels before, built with
// -fmad=false.
//
// Measurements made before the redesign (variants of the first kernels timed
// on the main path's tensors, NVIDIA H100 80GB HBM3, 700 W) found what
// bounded those kernels, which loaded or added 4 bytes per corner, per
// sample, per channel: the number of memory requests. 16-byte loads alone halved the
// forward (0.048 -> 0.025 ms at 300 RoIs); moving the RoIs apart so that none
// shares a map line made it slower, not faster, and so did giving each RoI
// its own gradient map in the backward: contention between RoIs costs little.
// The RoIs reuse each distinct corner about 5 times (4 S^2 R over the
// distinct corners of each RoI, summed: 4.8-5.3).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSamples = 16;      // S = P + 1 <= 16
constexpr int kMaxFoot = 2 * kMaxSamples;  // distinct rows (columns) of a RoI
constexpr int kThreads = 128;
constexpr int kLine = 128;           // forward: bytes of a pixel a block takes
constexpr int kFootBytes = 8192;     // forward: map pixels staged at once
constexpr int kTileB = 32;           // backward: channels a block takes
constexpr int kLanesB = kTileB / 4;  // backward: float4 lanes of a pixel

// One axis of a RoI's sample grid, in shared memory.
struct Axis {
  int n;                     // footprint: distinct map rows (columns) touched
  int map[kMaxFoot];         // footprint index -> map row (column), ascending
  int pos[kMaxSamples];      // sample -> footprint index of its top (left)
                             // corner; -1 for a sample outside the map
  float frac[kMaxSamples];   // hr (wr)
  int lo[kMaxFoot];          // backward: the samples whose corners include
  int hi[kMaxFoot];          // footprint index f are lo[f] .. hi[f]
};

// Warp 0: lanes 0-15 lay out the columns, lanes 16-31 the rows.
__device__ __forceinline__ void build_axes(const float* roi, float scale,
                                           int S, int H, int W, Axis& ay,
                                           Axis& ax) {
  const int lane = threadIdx.x & 31;
  const int k = lane & 15;
  const bool is_x = lane < 16;
  const float x1 = roi[1] * scale;
  const float y1 = roi[2] * scale;
  const float x2 = roi[3] * scale;
  const float y2 = roi[4] * scale;
  const float roi_w = fmaxf(x2 - x1 + 1.0f, 0.0f);
  const float roi_h = fmaxf(y2 - y1 + 1.0f, 0.0f);
  const float bin = (is_x ? roi_w : roi_h) / (float)(S - 1);
  const int size = is_x ? W : H;
  const float fsize = (float)size;
  const float v = (is_x ? x1 : y1) + (float)k * bin;
  const bool in = k < S && v >= 0.0f && v < fsize;
  const float v0 = fminf(floorf(v), fsize - 2.0f);
  const float frac = v - v0;
  const int a = min(max((int)v0, 0), size - 2);
  // the in-map samples are consecutive and their corners nondecreasing: a
  // sample adds its two corners after a gap, one when it steps by one, none
  // when it shares the previous sample's corners
  const int prev_a = __shfl_up_sync(~0u, a, 1, 16);
  const bool prev_in = __shfl_up_sync(~0u, (int)in, 1, 16) && k > 0;
  const int cnt = !in ? 0 : !prev_in ? 2 : a == prev_a ? 0
                : a == prev_a + 1 ? 1 : 2;
  int end = cnt;
#pragma unroll
  for (int d = 1; d < 16; d <<= 1) {
    const int t = __shfl_up_sync(~0u, end, d, 16);
    if (k >= d) end += t;
  }
  const int n = __shfl_sync(~0u, end, 15, 16);
  Axis& axr = is_x ? ax : ay;
  if (k < S) {
    axr.pos[k] = in ? end - 2 : -1;
    axr.frac[k] = frac;
  }
  if (cnt == 2) axr.map[end - 2] = a;
  if (cnt >= 1) axr.map[end - 1] = a + 1;
  if (k == 0) axr.n = n;
}

// Warp 0, after build_axes: for each footprint index, the range of samples
// whose two corners include it (contiguous, as the corners are sorted).
__device__ __forceinline__ void build_ranges(int S, Axis& axr) {
  const int f = threadIdx.x & 31;
  if (f >= axr.n) return;
  int lo = S, hi = -1;
  for (int k = 0; k < S; ++k) {
    const int p = axr.pos[k];
    if (p >= 0 && (p == f || p + 1 == f)) {
      lo = min(lo, k);
      hi = k;
    }
  }
  axr.lo[f] = lo;
  axr.hi[f] = hi;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// 16 bytes of T to floats
__device__ __forceinline__ void to_floats(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void to_floats(const __nv_bfloat16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// RoIAlignAvg forward: (B, H, W, C) map -> (R, C, P, P) output.
//
// Replaces the TPU kernel tllod_tpu/ops/roi_align_pallas.py::_kernel (:33),
// launched by _pallas_forward (:72) through roi_align_avg_pallas (:156).
//
// Bound. At eval batch 1 (37 x 75 x 512 float32 map, 300 RoIs, P = 7) the
// map is 5.7 MB and stays in the 50 MB L2; the output is 30.1 MB: 35.8 MB at
// 3.35 TB/s, 10.7 us. The first kernel took 0.048 ms: its 4 S^2 loads of 4
// bytes per (RoI, channel), 157 MB in 39 M requests through L2, were the
// cost, not the bytes.
//
// Design. A block takes one RoI and 128 bytes of each pixel (32 float32 or
// 64 bfloat16 channels), 128 threads: 8 lanes of 16 bytes times 16 slots.
// It copies the RoI's footprint (every distinct corner once) to shared
// memory with cp.async, 16 bytes a thread and all in flight at once, in
// groups of sample rows whose map rows fit in kFootBytes (one group unless a
// RoI is both wide and tall). From shared memory it computes the S x S
// samples, a slot keeping one sample column, in the same four-term
// expression as the plain version, so the float32 output is bit-equal to it;
// then one thread a channel takes the 2x2 means into a (channel, P, P) tile
// (a warp reads 32 neighbouring floats and writes 32 distinct banks), stored
// to (R, C, P, P) with 16-byte stores: that is the order fc6 reads, so the
// flatten before it is a view and not a copy. S is a compile-time constant
// for the main path's P = 7.
//
// What bounds it now (variants with one phase taken out, timed on the main
// path's tensors on an H100): about 2.5 times the byte bound at 300 RoIs,
// spread over phases that each block runs in turn, none of them dominant:
// the staging from L2 (the 33 MB of distinct corners, near the L2 rate),
// the samples, the output stores, the means and the per-block set-up.
// Taking more than one channel tile or more than one item per block, or
// keeping the corners in registers down a sample column, measured no
// faster.
template <typename T, int kS>
__global__ void __launch_bounds__(kThreads)
roi_align_avg_forward_kernel(const T* __restrict__ feat,
                             const float* __restrict__ rois,
                             T* __restrict__ out, int B, int H, int W, int C,
                             int P, float spatial_scale, int foot_bytes) {
  constexpr int kVec = 16 / sizeof(T);      // channels in 16 bytes
  constexpr int kTile = kLine / sizeof(T);  // channels a block takes
  constexpr int kLanes = kLine / 16;        // 16-byte lanes of a pixel
  constexpr int kSlots = kThreads / kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Axis ay, ax;
  __shared__ int s_b;
  // kS > 0: S known when compiled (the main path's P = 7)
  const int S = kS > 0 ? kS : P + 1;
  const int Pn = S - 1, PP = Pn * Pn;
  const int r = blockIdx.x;
  const int c0 = blockIdx.y * kTile;
  const int nlanes = min(kTile, C - c0) / kVec;
  const int lane = threadIdx.x % kLanes, slot = threadIdx.x / kLanes;
  const bool active = lane < nlanes;
  unsigned char* foot = smem;                       // staged map pixels
  float* samp = reinterpret_cast<float*>(smem + foot_bytes);  // [k][l][c]
  T* tile = reinterpret_cast<T*>(smem);             // [c][i * P + j]
  const float* roi = rois + (size_t)r * 5;
  if (threadIdx.x < 32) {
    build_axes(roi, spatial_scale, S, H, W, ay, ax);
    if (threadIdx.x == 0) s_b = (int)roi[0];
  }
  __syncthreads();
  const int b = s_b < 0 ? s_b + B : s_b;
  const bool has_image = b >= 0 && b < B;
  if (has_image) {
    // a slot computes sample column l of every rstep-th row from row r0
    const int l = slot % S, r0 = slot / S, rstep = kSlots / S;
    const bool computes = active && r0 < rstep;
    const int fc_l = ax.pos[l];
    const float wr = ax.frac[l];
    float* samp_l = samp + (size_t)l * kTile + lane * kVec;
    int k = 0;
    for (; k < S && ay.pos[k] < 0; ++k) {}  // rows above the map
    for (int i = r0; computes && i < S; i += rstep) {
      if (ay.pos[i] >= 0) continue;          // rows outside the map: zeros
#pragma unroll
      for (int v = 0; v < kVec; v += 4) {
        *reinterpret_cast<float4*>(samp_l + (size_t)i * S * kTile + v) =
            make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    const int nc = ax.n;
    const int row_bytes = nc * kLine;  // foot_bytes holds two rows at least
    const T* fb = feat + (size_t)b * H * W * C + c0 + lane * kVec;
    while (k < S && ay.pos[k] >= 0) {
      const int p0 = ay.pos[k];
      int k1 = k + 1;
      while (k1 < S && ay.pos[k1] >= 0 &&
             (ay.pos[k1] + 2 - p0) * row_bytes <= foot_bytes) {
        ++k1;
      }
      const int nrows = ay.pos[k1 - 1] + 2 - p0;
      for (int fc = slot; active && fc < nc; fc += kSlots) {
        const T* src = fb + (size_t)ax.map[fc] * C;
        unsigned char* dst = foot + (size_t)fc * kLine + lane * 16;
        for (int fr = 0; fr < nrows; ++fr) {
          cp_async16(dst + (size_t)fr * nc * kLine,
                     src + (size_t)ay.map[p0 + fr] * W * C);
        }
      }
      cp_async_wait_all();
      __syncthreads();
      for (int i = k + r0; computes && i < k1; i += rstep) {
        float val[kVec];
        if (fc_l >= 0) {
          const float hr = ay.frac[i];
          const T* top = reinterpret_cast<const T*>(
              foot + ((size_t)(ay.pos[i] - p0) * nc + fc_l) * kLine) +
              lane * kVec;
          const T* bot = top + (size_t)nc * kTile;
          float ul[kVec], ur[kVec], dl[kVec], dr[kVec];
          to_floats(top, ul);
          to_floats(top + kTile, ur);
          to_floats(bot, dl);
          to_floats(bot + kTile, dr);
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            val[v] = ul[v] * (1.0f - hr) * (1.0f - wr)
                     + ur[v] * (1.0f - hr) * wr
                     + dl[v] * hr * (1.0f - wr)
                     + dr[v] * hr * wr;
          }
        } else {
#pragma unroll
          for (int v = 0; v < kVec; ++v) val[v] = 0.0f;
        }
#pragma unroll
        for (int v = 0; v < kVec; v += 4) {
          *reinterpret_cast<float4*>(samp_l + (size_t)i * S * kTile + v) =
              make_float4(val[v], val[v + 1], val[v + 2], val[v + 3]);
        }
      }
      __syncthreads();  // the next group overwrites the staged pixels
      k = k1;
    }
    __syncthreads();
  }
  // the 2x2 means, in the plain version's order, into the (c, P, P) tile:
  // one thread a channel and an output row, so that a warp reads 32
  // neighbouring floats of a sample and writes 32 banks apart
  {
    const int c = threadIdx.x % kTile;
    for (int i = threadIdx.x / kTile; c < nlanes * kVec && i < Pn;
         i += kThreads / kTile) {
      T* o = tile + (size_t)c * PP + i * Pn;
      if (!has_image) {  // NaN where a sample of the bin is in the map
        const bool row_in = ay.pos[i] >= 0 || ay.pos[i + 1] >= 0;
        for (int j = 0; j < Pn; ++j) {
          const bool in = row_in && (ax.pos[j] >= 0 || ax.pos[j + 1] >= 0);
          store_f(o + j, in ? __int_as_float(0x7fc00000) : 0.0f);
        }
        continue;
      }
      const float* top = samp + (size_t)i * S * kTile + c;
      const float* bot = top + (size_t)S * kTile;
      float t0 = top[0], b0 = bot[0];
      for (int j = 0; j < Pn; ++j) {
        const float t1 = top[(j + 1) * kTile], b1 = bot[(j + 1) * kTile];
        store_f(o + j, (t0 + t1 + b0 + b1) * 0.25f);
        t0 = t1;
        b0 = b1;
      }
    }
  }
  __syncthreads();
  // (R, C, P, P): this block's channels are one contiguous run
  const int n16 = nlanes * kVec * PP * (int)sizeof(T) / 16;
  uint4* dst = reinterpret_cast<uint4*>(out + ((size_t)r * C + c0) * PP);
  const uint4* src = reinterpret_cast<const uint4*>(tile);
  for (int it = threadIdx.x; it < n16; it += kThreads) dst[it] = src[it];
}

// RoIAlignAvg backward: the map gradient of the forward above.
//
// Replaces the backward of the custom VJP tllod_tpu/ops/roi_align_pallas.py::
// roi_align_pallas (_bwd, :144-150), which differentiates the XLA gather
// formulation: g times the bilinear weight, scatter-added into the four
// corners of every in-map sample; the RoIs get no gradient. The gradient of
// sample (k, l) is 0.25 times the sum of g[i, j] over i in {k-1, k} and j in
// {l-1, l}, each within [0, P); it goes to the sample's four corners with the
// forward's weights (negative on the extrapolated last row or column).
//
// Bound. Train step, one 600 x 1200 image per domain: g is 256 (source) or
// 300 (target) x 512 x 7 x 7 float32, 25.7 or 30.1 MB read once, and the map
// gradient 1 x 37 x 75 x 512 float32, 5.7 MB written: 9.4 / 10.7 us at 3.35
// TB/s. The first kernel took 0.049-0.057 ms: one 4-byte atomicAdd per
// corner, per sample, per channel (33.6 M at 256 RoIs), issued as they came.
//
// Design. A block takes one RoI and 32 channels, 128 threads: 8 lanes of 4
// channels times 16 slots. It reads its (channel, P, P) or (P, P, channel)
// tile of g in the layout g arrives in (layout 1 or 0: through fc6's
// flatten it is (R, C, P, P), so no copy is made), as 16-byte loads into
// shared memory, and one thread a channel computes each sample's gradient
// once. Then a slot takes one footprint column and walks the sample rows in
// order: it sums each row's terms of the samples whose corners include the
// column, carries them into the column's two current footprint rows, and
// adds a pixel to the map gradient, with one 16-byte atomicAdd per 4
// channels, once no later sample row can reach it. A RoI's contributions
// are merged before they leave the block: one atomic per distinct (pixel, 4
// channels) of a RoI, about 20 times fewer requests than the first kernel.
// The sum over RoIs is still taken by atomics in an order that changes from
// run to run, so the map gradient is not bit-reproducible; within a RoI the
// order is fixed. An earlier draft that let each footprint pixel gather its
// terms read every sample's gradient from shared memory four times, and
// measured slower.
template <typename T, int kS>
__global__ void __launch_bounds__(kThreads)
roi_align_avg_backward_kernel(const T* __restrict__ grad_out,
                              const float* __restrict__ rois,
                              float* __restrict__ grad_feat, int B, int H,
                              int W, int C, int P, float spatial_scale,
                              int layout) {
  constexpr int kVec = 16 / sizeof(T);   // values of g in 16 bytes
  constexpr int kSlots = kThreads / kLanesB;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Axis ay, ax;
  __shared__ int s_b;
  // kS > 0: S known when compiled (the main path's P = 7)
  const int S = kS > 0 ? kS : P + 1;
  const int Pn = S - 1, PP = Pn * Pn;
  const int r = blockIdx.x;
  const int c0 = blockIdx.y * kTileB;
  const int nch = min(kTileB, C - c0);
  const int lane = threadIdx.x % kLanesB, slot = threadIdx.x / kLanesB;
  float* gt = reinterpret_cast<float*>(smem);    // g's tile, see below
  float* gs = gt + (size_t)PP * kTileB;          // [k * S + l][c]
  const float* roi = rois + (size_t)r * 5;
  if (threadIdx.x < 32) {
    build_axes(roi, spatial_scale, S, H, W, ay, ax);
    __syncwarp();
    build_ranges(S, ax);
    if (threadIdx.x == 0) s_b = (int)roi[0];
  }
  __syncthreads();
  const int b = s_b < 0 ? s_b + B : s_b;
  if (b < 0 || b >= B || ax.n == 0 || ay.n == 0) return;  // no gradient

  // g's tile to shared memory as float32, in the layout it arrives in:
  // (channel, position) for layout 1, (position, channel) for layout 0
  if (layout == 1) {  // (R, C, P, P): nch * PP contiguous values
    const T* src = grad_out + ((size_t)r * C + c0) * PP;
    for (int it = threadIdx.x; it < nch * PP / kVec; it += kThreads) {
      float v[kVec];
      to_floats(src + (size_t)it * kVec, v);
#pragma unroll
      for (int q = 0; q < kVec; q += 4) {
        *reinterpret_cast<float4*>(gt + (size_t)it * kVec + q) =
            make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
      }
    }
  } else {            // (R, P, P, C): PP runs of nch channels
    constexpr int kPerPos = kTileB / kVec;
    const T* src = grad_out + (size_t)r * PP * C + c0;
    for (int it = threadIdx.x; it < PP * kPerPos; it += kThreads) {
      const int o = it / kPerPos, q = it % kPerPos;
      if (q * kVec >= nch) continue;
      float v[kVec];
      to_floats(src + (size_t)o * C + q * kVec, v);
#pragma unroll
      for (int u = 0; u < kVec; u += 4) {
        *reinterpret_cast<float4*>(gt + o * kTileB + q * kVec + u) =
            make_float4(v[u], v[u + 1], v[u + 2], v[u + 3]);
      }
    }
  }
  __syncthreads();

  // each sample's gradient, in the order of the kernels before: one thread
  // a channel and a sample row, reading g[k-1][.] and g[k][.] along the row
  {
    const int c = threadIdx.x % kTileB;
    const int sc = layout == 1 ? PP : 1, so = layout == 1 ? 1 : kTileB;
    for (int k = threadIdx.x / kTileB; k < S; k += kThreads / kTileB) {
      const bool has_p = k >= 1 && k - 1 < Pn, has_c = k < Pn;
      const float* gp = gt + (size_t)c * sc + (has_p ? (k - 1) * Pn * so : 0);
      const float* gc = gt + (size_t)c * sc + (has_c ? k * Pn * so : 0);
      float pl = 0.0f, cl = 0.0f;  // g[k-1][l-1], g[k][l-1]
      for (int l = 0; l < S; ++l) {
        const float pr = has_p && l < Pn ? gp[l * so] : 0.0f;
        const float cr = has_c && l < Pn ? gc[l * so] : 0.0f;
        gs[(size_t)(k * S + l) * kTileB + c] =
            (((pl + pr) + cl) + cr) * 0.25f;
        pl = pr;
        cl = cr;
      }
    }
  }
  __syncthreads();

  // each footprint column: a slot walks the sample rows in order, sums each
  // row's terms of the samples whose corners include the column, carries
  // them into the column's current two footprint rows, and adds a pixel to
  // the map gradient once no later row can reach it
  if (lane * 4 >= nch) return;
  float* gb = grad_feat + (size_t)b * H * W * C + c0 + lane * 4;
  for (int fc = slot; fc < ax.n; fc += kSlots) {
    const int llo = ax.lo[fc], lhi = ax.hi[fc];
    float* gcol = gb + (size_t)ax.map[fc] * C;
    auto flush = [&](int fr, float4 v) {
      atomicAdd(reinterpret_cast<float4*>(gcol + (size_t)ay.map[fr] * W * C),
                v);
    };
    float4 top = make_float4(0.0f, 0.0f, 0.0f, 0.0f), bot = top;
    int row = -1;  // footprint row of `top`; `bot` is the next
    // sample row k's terms h for this column go to its two footprint rows
    auto carry = [&](int k, float4 h) {
      const int py = ay.pos[k];
      if (py < 0) return;
      if (row >= 0 && py != row) {
        flush(row, top);
        if (py == row + 1) {
          top = bot;
        } else {
          flush(row + 1, bot);
          top = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        bot = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      row = py;
      const float hr = ay.frac[k], hr1 = 1.0f - hr;
      top.x += h.x * hr1;
      top.y += h.y * hr1;
      top.z += h.z * hr1;
      top.w += h.w * hr1;
      bot.x += h.x * hr;
      bot.y += h.y * hr;
      bot.z += h.z * hr;
      bot.w += h.w * hr;
    };
    auto add = [&](float4& h, int k, int l, float wx) {
      const float4 g = *reinterpret_cast<const float4*>(
          gs + (size_t)(k * S + l) * kTileB + lane * 4);
      h.x += g.x * wx;
      h.y += g.y * wx;
      h.z += g.z * wx;
      h.w += g.w * wx;
    };
    if constexpr (kS > 0) {
      // all rows' sums at once: kS independent chains per sample column
      float4 h[kS];
#pragma unroll
      for (int k = 0; k < kS; ++k) h[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int l = llo; l <= lhi; ++l) {
        const float wx = ax.pos[l] == fc ? 1.0f - ax.frac[l] : ax.frac[l];
#pragma unroll
        for (int k = 0; k < kS; ++k) add(h[k], k, l, wx);
      }
#pragma unroll
      for (int k = 0; k < kS; ++k) carry(k, h[k]);
    } else {
      for (int k = 0; k < S; ++k) {
        float4 h = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int l = llo; l <= lhi; ++l) {
          add(h, k, l, ax.pos[l] == fc ? 1.0f - ax.frac[l] : ax.frac[l]);
        }
        carry(k, h);
      }
    }
    if (row >= 0) {
      flush(row, top);
      flush(row + 1, bot);
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

template <typename T>
cudaError_t launch_forward(const void* feat, const void* rois, void* out,
                           int B, int H, int W, int C, int R, int P,
                           float spatial_scale, cudaStream_t s) {
  const int S = P + 1;
  const int tile = kLine / (int)sizeof(T);
  // the staging area also holds the output tile, and two map rows at least
  const int foot = max(kFootBytes, max(kLine * P * P, 2 * 2 * S * kLine));
  const size_t bytes = (size_t)foot + (size_t)S * S * tile * sizeof(float);
  auto kernel = P == 7 ? roi_align_avg_forward_kernel<T, 8>
                        : roi_align_avg_forward_kernel<T, 0>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(R, (C + tile - 1) / tile);
  kernel<<<grid, kThreads, bytes, s>>>((const T*)feat, (const float*)rois,
                                       (T*)out, B, H, W, C, P, spatial_scale,
                                       foot);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const void* grad_out, const void* rois,
                            void* grad_feat, int layout, int B, int H, int W,
                            int C, int R, int P, float spatial_scale,
                            cudaStream_t s) {
  const int S = P + 1;
  const size_t bytes = (size_t)(P * P + S * S) * kTileB * sizeof(float);
  auto kernel = P == 7 ? roi_align_avg_backward_kernel<T, 8>
                        : roi_align_avg_backward_kernel<T, 0>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(R, (C + kTileB - 1) / kTileB);
  kernel<<<grid, kThreads, bytes, s>>>((const T*)grad_out,
                                       (const float*)rois, (float*)grad_feat,
                                       B, H, W, C, P, spatial_scale, layout);
  return cudaGetLastError();
}

bool bad_shape(int dtype, int H, int W, int C, int P) {
  // 16-byte vectors: C a multiple of 8 channels serves both types
  return P < 1 || P + 1 > kMaxSamples || H < 2 || W < 2 || C % 8 != 0 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

extern "C" {

const char* tllod_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

int tllod_roi_align_max_out_size() { return kMaxSamples - 1; }

// feat: (B, H, W, C) contiguous, 16-byte aligned, dtype 0 = float32,
// 1 = bfloat16, C a multiple of 8; rois: (R, 5) float32; out: (R, C, P, P)
// in feat's dtype.
int tllod_roi_align_avg_forward(const void* feat, const void* rois, void* out,
                                int dtype, int B, int H, int W, int C, int R,
                                int P, float spatial_scale, void* stream) {
  if (bad_shape(dtype, H, W, C, P)) return (int)cudaErrorInvalidValue;
  if (R == 0 || C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? launch_forward<float>(feat, rois, out, B, H, W, C, R, P,
                                           spatial_scale, s)
                   : launch_forward<__nv_bfloat16>(feat, rois, out, B, H, W,
                                                   C, R, P, spatial_scale, s));
}

// grad_out: the output gradient, dtype 0 = float32, 1 = bfloat16, 16-byte
// aligned, (R, P, P, C)-contiguous (layout 0) or (R, C, P, P)-contiguous
// (layout 1); rois: (R, 5) float32; grad_feat: (B, H, W, C) float32, zeroed
// by the caller and accumulated into. Launches the kernel and nothing else.
int tllod_roi_align_avg_backward(const void* grad_out, const void* rois,
                                 void* grad_feat, int dtype, int layout,
                                 int B, int H, int W, int C, int R, int P,
                                 float spatial_scale, void* stream) {
  if (bad_shape(dtype, H, W, C, P) || (layout != 0 && layout != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (R == 0 || C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? launch_backward<float>(grad_out, rois, grad_feat, layout,
                                            B, H, W, C, R, P, spatial_scale,
                                            s)
                   : launch_backward<__nv_bfloat16>(grad_out, rois, grad_feat,
                                                    layout, B, H, W, C, R, P,
                                                    spatial_scale, s));
}

}  // extern "C"
