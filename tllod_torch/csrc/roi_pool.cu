// RoIPool forward and backward for Hopper (sm_90a), float32 and bfloat16.
// They replace
// the JAX package's RoIPool (tllod_tpu/ops/roi_pool.py::roi_pool and
// _bin_ranges), an XLA masked reduction there, and JAX's transpose of its two
// max reductions; the reference's hand kernel was
// lib/model/roi_pooling/src/roi_pooling_kernel.cu.
//
// Semantics (those of tllod_torch/ops/roi_pool.py::roi_pool_plain): each RoI
// row (b, x1, y1, x2, y2) is quantized by floor(x * scale + 0.5), to a width
// and height of at least 1; bin i of P along an axis spans
// [floor(i * ext / P) + lo, ceil((i + 1) * ext / P) + lo), in exact integers,
// clipped to [0, size]. A bin takes the max of its pixels; an empty bin gives
// 0. A batch index outside [0, B) reads image 0, as the JAX package does.
// The map is NHWC; the forward writes (R, P, P, C), which PA-ATF's CLUB heads
// read as the channels-last NCHW view with no copy. Built with -fmad=false,
// so the quantization rounds as the plain version does.
//
// bfloat16 (PA-ATF under --bf16). Bin membership is the JAX package's at
// bfloat16: it compares the edges with the cell coordinates
// jnp.arange(size, dtype=bfloat16) (roi_pool.py:64-69), which round to
// nearest even above 256, so each bin's cells are [first x with rb(x) >=
// start, first x with rb(x) >= end) (member_edge), and a bin that is not
// empty by its edges but holds no cell gives JAX's fill, -1e30 rounded to
// bfloat16, and no gradient. Rows of PA-ATF's maps (H <= 150) are not
// affected; 22 of the 300 columns of its c3 map are. Every max, compare and
// sum runs in float32 registers; the map gradient is summed in float32 and
// rounded to bfloat16 once (JAX sums it in bfloat16; the port pins one
// rounding).
//
// What bounds them. PA-ATF's 50 gt RoIs (15 real, then 35 zero-padded 1x1
// rows at (0, 0)) read 8-20 MB of bin pixels for a few MB of distinct map,
// and the backward writes the whole map gradient (46 MB at c3 in float32,
// 23 MB in bfloat16): bytes, but at these sizes first the latency of each
// block's chain of loads and the number of blocks a wave holds. The kernels
// before gave a thread one channel of one bin, a serial chain of 4-byte
// loads over up to ~100 pixels; most blocks were the padding rows' and did
// one load.
//
// Design (roi_pool_rows_kernel, both directions). A block takes one RoI's
// bin row and a chunk of L lanes of V channels each (the wrapper's chunk
// rule: float32 16-byte loads of 4, L = 32 for deep maps, 16 or 8 for
// C = 256; bfloat16 8-byte loads of 4 with L = 32 for deep maps, else 16
// (forward and backward), and 16-byte loads of 8 for the forward of a
// deep map; 1 channel when C or the alignment allows no vector load), so
// the 256 threads are L lanes times 256 / L column groups. Threads 0..P
// compute the RoI's bin edges once into shared memory. The groups split
// the bin row's columns, each taking the max over the row's rows of its
// columns (JAX's H-then-W order) into shared memory; each thread then
// folds the column maxima of at most two bins. The grid is 1-D with bin
// rows in RoI order and a bin row's chunks together, so the real gt boxes,
// which come first, start first. Measured at float32 against a 2-D (bin row,
// chunk) grid, an 8-lane-only build, a map held in shared memory for many
// RoIs, a pull backward that writes each pixel once from per-bin
// statistics, a backward that keeps the tied rows in bitmasks and one that
// zeroes the map gradient in the same kernel as it adds into it (fill
// blocks ordered before the rest by a ticket): each was slower on PA-ATF's
// float32 taps or the eval map.
//
// At bfloat16 the column and bin maxima are staged as packed bfloat16
// (exact: a max of bfloat16 values is one of them), so a block stages
// 2944 / L columns at V = 4 (1472 / L at V = 8; float32 1792 / L) and
// PA-ATF's c3 boxes (at most 75 columns) are never cut into column tiles.
// The earlier build ran bfloat16 as float32's template with 16-byte loads
// of 8 channels: half float32's blocks, 108-119 registers (2 blocks an SM) and
// a quarter of its staged columns. On PA-ATF's taps (H100, roi_pool_ab.py
// and the taps of a bf16 step), 8-byte loads of 4 channels beat 16-byte
// loads of 8 in the backward at c3 and c4 (within noise at c5, so the
// backward has no 16-byte bfloat16 build) and in the forward at c3.
// Registers (ptxas, sm_90a), bfloat16: backward 64 (V = 4, L = 8; 4 blocks
// an SM), 77 (L = 16, 32; 3 an SM), 56 (V = 1); forward 48-56 (V = 4), 64
// (V = 8), 56 (V = 1), held to 4 blocks an SM (faster at c4 than 1); no
// spills. float32: backward 64 and 80 (24 / 4 bytes spilled), forward
// 56.
//
// Backward, float32: two device passes. roi_pool_zero_kernel zeroes the map
// gradient with 16-byte stores. Then the rows kernel in its backward mode:
// a bin row whose output gradient is 0 in the chunk (the zero-padded gt
// rows) ends at once; else it computes the column maxima and the bin
// maxima m as the forward does, n_w (the bin's columns whose max equals m)
// and q = g / n_w (JAX's first division), and per column x adds g_x / n_h,
// g_x the sum of q_j over its bins j whose max equals the column max and
// n_h the column's rows equal to it, into each of those rows with one
// 16-byte atomicAdd per row and 4 channels (JAX's transpose; overlapping
// bins add, in an order that varies by run).
//
// Backward, bfloat16: three device passes, none over a full float32 map
// (the earlier build zeroed a float32 scratch map and rounded all of it
// into the gradient: 115 MB moved at c3 around the kernel). The map is cut
// into tiles of kTile x kTile pixels and every channel; a tile is touched
// when a RoI's rectangle (roi_rect: its first bin's start to its last
// bin's end, by JAX's membership) meets it, 26-45% of PA-ATF's tiles.
// roi_pool_plan_kernel (a block of 128 threads a tile, each thread testing
// a RoI) marks each tile in the first element of the bfloat16 gradient and
// zeroes the float32 sums of the touched ones only, in the caller's
// full-size float32 buffer; the rows kernel adds into them as at float32;
// roi_pool_finish_kernel (the same tiles) writes every element of the
// bfloat16 gradient once, the marks too: 0 in an unmarked tile, a touched
// tile's sums rounded. The rows and finish passes are programmatic dependent
// launches: the rows kernel's blocks compute their edges, column maxima and
// shares while the plan zeroes, and wait for it (griddepcontrol.wait) only
// before they add; the finish writes its unmarked tiles' zeros while the
// rows kernel adds, and waits only before it reads sums. The order this
// needs is kept in launch_rows and the rows kernel's early return, and
// stated at both. No counter or flag lives across calls, and the call
// needs no host synchronisation (it runs inside --fuse_steps' CUDA
// graphs). Measured against this design on the taps, each slower: the
// three passes launched in plain stream order (1.09-1.13x, PERF.md, PR
// 17), plan and finish blocks of 8 tiles (fewer blocks in flight) and the
// plan writing the unmarked tiles' zeros; within noise: counting n_h while
// staging, staging two columns a pass, and reading the RoI while the
// any-check reads the gradient. A pull backward and a ticket were not
// tried again at bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 64;
// the bfloat16 backward's map tiles: kTile x kTile pixels, every channel
constexpr int kTile = 4;

template <int V>
struct alignas(4 * V) Vec {
  float v[V];
};

template <int V>
struct alignas(4 * V) IVec {
  int v[V];
};

using bf16 = __nv_bfloat16;

// V bfloat16 values packed, as the bfloat16 kernels stage maxima
template <int V>
struct alignas(2 * V) BVec {
  bf16 v[V];
};

// a column or bin maximum in shared memory: float32 as it is, bfloat16
// packed (exact: the max of bfloat16 values is one of them)
template <typename T, int V>
using Staged = std::conditional_t<std::is_same_v<T, float>, Vec<V>, BVec<V>>;

template <typename T, int V>
__device__ __forceinline__ Staged<T, V> to_staged(const Vec<V>& x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    BVec<V> r;
    if constexpr (V == 1) {
      r.v[0] = __float2bfloat16_rn(x.v[0]);
    } else {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(r.v);
#pragma unroll
      for (int k = 0; k < V / 2; ++k) {
        h[k] = __floats2bfloat162_rn(x.v[2 * k], x.v[2 * k + 1]);
      }
    }
    return r;
  }
}

template <typename T, int V>
__device__ __forceinline__ Vec<V> from_staged(const Staged<T, V>& x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    Vec<V> r;
    if constexpr (V == 1) {
      r.v[0] = __bfloat162float(x.v[0]);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(x.v);
#pragma unroll
      for (int k = 0; k < V / 2; ++k) {
        const float2 f = __bfloat1622float2(h[k]);
        r.v[2 * k] = f.x;
        r.v[2 * k + 1] = f.y;
      }
    }
    return r;
  }
}

// V elements of type T from p into float registers: one 16-byte load for
// V = 4 (float) or 8 (bfloat16), one 8-byte load for V = 4 (bfloat16),
// else one element
template <typename T, int V>
__device__ __forceinline__ Vec<V> load(const T* p) {
  Vec<V> r;
  if constexpr (V == 1) {
    if constexpr (std::is_same_v<T, float>) {
      r.v[0] = __ldg(p);
    } else {
      r.v[0] = __bfloat162float(*p);
    }
  } else if constexpr (std::is_same_v<T, float>) {
    static_assert(V == 4, "float loads are 4 wide");
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else if constexpr (V == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      r.v[2 * k] = f.x;
      r.v[2 * k + 1] = f.y;
    }
  } else {
    static_assert(V == 8, "bfloat16 loads are 4 or 8 wide");
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      r.v[2 * k] = f.x;
      r.v[2 * k + 1] = f.y;
    }
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Vec<V>& x) {
  if constexpr (V == 1) {
    if constexpr (std::is_same_v<T, float>) {
      *p = x.v[0];
    } else {
      *p = __float2bfloat16_rn(x.v[0]);
    }
  } else if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(p) = make_float4(x.v[0], x.v[1], x.v[2],
                                                x.v[3]);
  } else if constexpr (V == 4) {
    uint2 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      h[k] = __floats2bfloat162_rn(x.v[2 * k], x.v[2 * k + 1]);
    }
    *reinterpret_cast<uint2*>(p) = t;
  } else {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = __floats2bfloat162_rn(x.v[2 * k], x.v[2 * k + 1]);
    }
    *reinterpret_cast<uint4*>(p) = t;
  }
}

// JAX's fill of a max over no cell (roi_pool.py:21, _NEG), in bfloat16
__device__ __forceinline__ float bf16_fill() {
  return __bfloat162float(__float2bfloat16_rn(-1e30f));
}

// the cell coordinate x as jnp.arange(size, dtype=bfloat16) holds it
__device__ __forceinline__ int bf16_coord(int x) {
  return (int)__bfloat162float(__float2bfloat16_rn((float)x));
}

// The first cell x in [0, limit] whose bfloat16 coordinate is >= edge
// (limit when none), for an edge in [0, limit]: bf16_coord is monotone and
// within x / 256 of x, so both walks are short.
__device__ __forceinline__ int member_edge(int edge, int limit) {
  int x = edge;
  while (x > 0 && bf16_coord(x - 1) >= edge) --x;
  while (x < limit && bf16_coord(x) < edge) ++x;
  return x;
}

// Programmatic dependent launch (sm_90): a kernel launched with
// launch_after_previous may start while the kernel before it on the stream
// still runs; pdl_wait holds it until that kernel has finished and its
// writes are visible (at once for a kernel launched plainly), and
// pdl_trigger lets the kernel after it start early.
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" :::);
}

// max that keeps a NaN, as torch.amax and jnp.max do
__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// a / b for a >= 0, b >= 1: 32-bit division when both fit (always, for
// coordinates a map can have), else 64-bit
__device__ __forceinline__ long long div_pos(long long a, long long b) {
  if (((a | b) >> 31) == 0) return (long long)((unsigned)a / (unsigned)b);
  return a / b;
}

// A RoI quantized: its image and, per axis, the first map cell and extent.
struct Roi {
  int b;
  long long x0, w, y0, h;
};

__device__ __forceinline__ Roi quantize(const float* roi, float scale,
                                        int B) {
  Roi q;
  const int bi = (int)roi[0];
  q.b = (bi >= 0 && bi < B) ? bi : 0;
  const float x1 = floorf(roi[1] * scale + 0.5f);
  const float y1 = floorf(roi[2] * scale + 0.5f);
  const float x2 = floorf(roi[3] * scale + 0.5f);
  const float y2 = floorf(roi[4] * scale + 0.5f);
  q.x0 = (long long)x1;
  q.y0 = (long long)y1;
  q.w = (long long)fmaxf(x2 - x1 + 1.0f, 1.0f);
  q.h = (long long)fmaxf(y2 - y1 + 1.0f, 1.0f);
  return q;
}

// [start, end) of bin i of p along an axis from lo with extent ext, clipped
// to [0, limit]; ext >= 1 and i >= 0.
__device__ __forceinline__ void axis_bin(long long lo, long long ext, int i,
                                         int p, int limit, int& start,
                                         int& end) {
  const long long s = div_pos((long long)i * ext, p) + lo;
  const long long e = div_pos((long long)(i + 1) * ext + p - 1, p) + lo;
  start = (int)min(max(s, 0LL), (long long)limit);
  end = (int)min(max(e, 0LL), (long long)limit);
}

// The bins [first, last] along an axis that hold the cell d = v - lo cells
// from the RoI's start, 0 <= d < ext: floor(i ext / P) <= d < ceil((i + 1)
// ext / P) gives floor(d P / ext) <= i <= ceil((d + 1) P / ext) - 1.
__device__ __forceinline__ void covering_bins(long long d, long long ext,
                                              int p, int& first, int& last) {
  first = (int)div_pos(d * p, ext);
  last = (int)min(div_pos((d + 1) * p + ext - 1, ext) - 1,
                  (long long)(p - 1));
}

// The cells of image b, rows [y0, y1) and columns [x0, x1), that hold every
// cell of a RoI's bins by JAX's bfloat16 membership: bin edges grow with
// the bin's index and member_edge is monotone, so the first bin's start
// (lo) and the last bin's end (lo + ext), clipped, bound every bin.
struct Rect {
  int b, y0, y1, x0, x1;
};

__device__ __forceinline__ Rect roi_rect(const float* roi, float scale, int B,
                                         int H, int W) {
  const Roi q = quantize(roi, scale, B);
  auto clip = [](long long v, int limit) {
    return (int)min(max(v, 0LL), (long long)limit);
  };
  return {q.b, member_edge(clip(q.y0, H), H),
          member_edge(clip(q.y0 + q.h, H), H),
          member_edge(clip(q.x0, W), W), member_edge(clip(q.x0 + q.w, W), W)};
}

// The bfloat16 backward's plan and finish passes: a block of kTileThreads
// a map tile, tile t of the flattened (b, ty, tx) order.
constexpr int kTileThreads = 128;

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int t, int H, int W) {
  const int tx_n = (W + kTile - 1) / kTile, ty_n = (H + kTile - 1) / kTile;
  const int b = t / (ty_n * tx_n);
  const int rest = t - b * ty_n * tx_n;
  const int ty = rest / tx_n;
  return {b, ty * kTile, (rest - ty * tx_n) * kTile};
}

// Whether any of the R RoIs' rectangles meets tile t, one RoI a thread;
// every thread of the block gets the answer.
__device__ bool tile_touched(const float* __restrict__ rois, int R,
                             float scale, int B, int H, int W,
                             const Tile& t) {
  for (int r0 = 0; r0 < R; r0 += kTileThreads) {
    const int r = r0 + threadIdx.x;
    bool hit = false;
    if (r < R) {
      const Rect q = roi_rect(rois + 5 * (size_t)r, scale, B, H, W);
      hit = q.b == t.b && q.y0 < q.y1 && q.x0 < q.x1 &&
            q.y0 < t.y0 + kTile && t.y0 < q.y1 && q.x0 < t.x0 + kTile &&
            t.x0 < q.x1;
    }
    if (__syncthreads_or(hit)) return true;
  }
  return false;
}

// A tile's elements, V at a time: its rows are runs of up to kTile pixels
// times C contiguous elements of the (B, H, W, C) map. Calls f(offset).
template <int V, typename F>
__device__ __forceinline__ void for_tile(const Tile& t, int H, int W, int C,
                                         F f) {
  const int rows = min(kTile, H - t.y0);
  const int per_row = min(kTile, W - t.x0) * C / V;
  for (int k = threadIdx.x; k < rows * per_row; k += kTileThreads) {
    const int y = k / per_row;
    f((((size_t)t.b * H + t.y0 + y) * W + t.x0) * C +
      (size_t)(k - y * per_row) * V);
  }
}

// The plan's mark of a touched tile, in the bits of the bfloat16 map
// gradient's first element of the tile (a NaN the finish pass overwrites)
constexpr unsigned short kTouched = 0xffff;

__device__ __forceinline__ unsigned short* tile_flag(bf16* grad, const Tile& t,
                                                     int H, int W, int C) {
  return reinterpret_cast<unsigned short*>(grad) +
         (((size_t)t.b * H + t.y0) * W + t.x0) * C;
}

// The bfloat16 backward's first pass, a block a tile: its mark written
// and, when a RoI touches it, its float32 sums zeroed (V = 4: 16-byte
// stores); the rest of the sums left as they are.
template <int V>
__global__ void __launch_bounds__(kTileThreads)
roi_pool_plan_kernel(const float* __restrict__ rois, float* __restrict__ acc,
                     bf16* __restrict__ grad, int R, int B, int H, int W,
                     int C, float scale) {
  pdl_trigger();               // the rows kernel's blocks may start staging
  const Tile t = tile_at(blockIdx.x, H, W);
  const bool hit = tile_touched(rois, R, scale, B, H, W, t);
  if (threadIdx.x == 0) *tile_flag(grad, t, H, W, C) = hit ? kTouched : 0;
  if (!hit) return;
  const Vec<V> zero = {};
  for_tile<V>(t, H, W, C,
              [&](size_t off) { store<float, V>(acc + off, zero); });
}

// The bfloat16 backward's last pass, the same tiles: every element of the
// map gradient written once, a marked tile's float32 sums rounded (V = 4:
// one 16-byte load, one 8-byte store), 0 elsewhere.
template <int V>
__global__ void __launch_bounds__(kTileThreads)
roi_pool_finish_kernel(const float* __restrict__ acc, bf16* __restrict__ grad,
                       int H, int W, int C) {
  const Tile t = tile_at(blockIdx.x, H, W);
  // the plan pass has finished (see launch_rows); a marked tile waits for
  // the rows kernel's sums, the others write their zeros at once
  const bool hit = __syncthreads_or(
      threadIdx.x == 0 && *tile_flag(grad, t, H, W, C) == kTouched);
  if (hit) pdl_wait();
  for_tile<V>(t, H, W, C, [&](size_t off) {
    Vec<V> x = {};
    if (hit) {
      if constexpr (V == 1) {
        x.v[0] = acc[off];
      } else {
#pragma unroll
        for (int j = 0; j < V; j += 4) {
          const float4 a = *reinterpret_cast<const float4*>(acc + off + j);
          x.v[j] = a.x;
          x.v[j + 1] = a.y;
          x.v[j + 2] = a.z;
          x.v[j + 3] = a.w;
        }
      }
    }
    store<bf16, V>(grad + off, x);
  });
}

// Columns of a bin row a block stages in shared memory at once: float32 28
// KB (1792 / L columns of 16 bytes a lane), bfloat16 23 KB of
// packed maxima (1472 / L columns at V = 8, 2944 / L at V = 4), so that
// with the backward's bin maxima and shares (P L (16 + 16) bytes at
// float32, P L (8 + 16) at bfloat16, P L <= 512 by bad_lanes) and the
// static arrays a block stays under the 48 KB a launch gets without
// raising its limit.
template <typename T, int V, int L>
__host__ __device__ constexpr int staged_cols() {
  return std::is_same_v<T, float> ? 1792 / L
                                  : 23552 / (L * (int)sizeof(Staged<T, V>));
}

// Dynamic shared memory of a block: the column maxima and, backward, the
// bin row's maxima m and q = g / n_w.
template <typename T, int V, int L, bool kGrad>
size_t smem_bytes(int P) {
  const size_t cols =
      (size_t)staged_cols<T, V, L>() * L * sizeof(Staged<T, V>);
  return kGrad ? cols + (size_t)P * L * (sizeof(Staged<T, V>) + sizeof(Vec<V>))
               : cols;
}

// The backward's first pass at float32: the map gradient zeroed, 16 bytes
// a store.
template <int V>
__global__ void __launch_bounds__(kThreads)
roi_pool_zero_kernel(float* __restrict__ p, size_t n) {
  const Vec<V> zero = {};
  for (size_t t = (size_t)blockIdx.x * kThreads + threadIdx.x; t < n;
       t += (size_t)gridDim.x * kThreads) {
    store<float, V>(p + t * V, zero);
  }
}

// Blocks an SM the launch bounds ask room for. float32: the forward 1; the
// backward 4 at 8 lanes and 3 at 16 or 32 (64 and 85 registers), which
// measured fastest on PA-ATF's taps. bfloat16: see the file's head.
template <typename T, int V, int L, bool kGrad>
__host__ __device__ constexpr int min_blocks() {
  if constexpr (std::is_same_v<T, float>) {
    return !kGrad ? 1 : L == 8 ? 4 : 3;
  } else {
    return !kGrad ? 4 : L == 8 ? 4 : 3;
  }
}

// Grid R * P * chunks, bin rows in RoI order and a bin row's chunks
// together; a block takes bin row i of RoI r and one chunk of L * V
// channels, L lanes times G = 256 / L column groups. Forward (kGrad false):
// out (R, P, P, C) = the bin maxima. Backward (kGrad true): the bin row's
// gradient added into the float32 grad_feat (float32: the map gradient,
// zeroed by roi_pool_zero_kernel; bfloat16: the sums, zeroed where a RoI
// touches by roi_pool_plan_kernel).
template <typename T, int V, int L, bool kGrad>
__global__ void __launch_bounds__(kThreads, min_blocks<T, V, L, kGrad>())
roi_pool_rows_kernel(const T* __restrict__ feat,
                 const float* __restrict__ rois, T* __restrict__ out,
                 const T* __restrict__ grad_out,
                 float* __restrict__ grad_feat, int B, int H, int W, int C,
                 int P, int chunks, float scale) {
  constexpr bool kBf16 = std::is_same_v<T, bf16>;
  constexpr int G = kThreads / L;
  constexpr int kCols = staged_cols<T, V, L>();
  constexpr int S = 2;                             // bins a thread folds:
                                                   // P <= 2 G (bad_lanes)
  using St = Staged<T, V>;
  extern __shared__ __align__(32) unsigned char smem[];
  auto s_col = reinterpret_cast<St(*)[L]>(smem);   // column maxima
  auto s_m = s_col + kCols;                        // bin maxima
  auto s_q = reinterpret_cast<Vec<V>(*)[L]>(s_m + P);  // g / n_w
  __shared__ int s_ws[kMaxP], s_we[kMaxP];       // the bins' cells
  __shared__ bool s_wempty[kMaxP];                 // empty by its edges
  __shared__ int s_row[4];                  // image, hs, he, empty by edges
  __shared__ long long s_x[2];                     // RoI's x0, w

  const int tid = threadIdx.x;
  const int item = blockIdx.x / chunks;            // r * P + i
  const int chunk = blockIdx.x - item * chunks;
  const int r = item / P;
  const int i = item - r * P;
  const int lane = tid % L;
  const int grp = tid / L;
  const int c = (chunk * L + lane) * V;
  const bool c_ok = c < C;
  const T* gout = kGrad ? grad_out + (size_t)item * P * C + c : nullptr;

  // backward: a bin row with no gradient in this chunk (PA-ATF's
  // zero-padded gt rows) adds nothing and ends here
  if constexpr (kGrad) {
    bool any = false;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = grp + s * G;
      if (j >= P || !c_ok) continue;
      const Vec<V> g = load<T, V>(gout + (size_t)j * C);
#pragma unroll
      for (int k = 0; k < V; ++k) any |= g.v[k] != 0.0f;
    }
    if (!__syncthreads_or(any)) {
      // bfloat16: block 0 waits for the plan pass even with no gradient,
      // so that the rows kernel never ends, and the finish pass never
      // starts, before the plan has finished (the finish reads the plan's
      // marks before it waits; see launch_rows). No block may end before
      // this point without the same wait.
      if (kBf16 && blockIdx.x == 0) pdl_wait();
      return;
    }
  }

  if (tid < P || tid == kThreads - 1) {
    const Roi q = quantize(rois + 5 * (size_t)r, scale, B);
    int lo, hi;
    if (tid < P) {
      axis_bin(q.x0, q.w, tid, P, W, lo, hi);
      s_wempty[tid] = hi <= lo;
      if constexpr (kBf16) {
        lo = member_edge(lo, W);
        hi = member_edge(hi, W);
      }
      s_ws[tid] = lo;
      s_we[tid] = hi;
    } else {
      s_row[0] = q.b;
      axis_bin(q.y0, q.h, i, P, H, lo, hi);
      s_row[3] = hi <= lo;
      if constexpr (kBf16) {
        lo = member_edge(lo, H);
        hi = member_edge(hi, H);
      }
      s_row[1] = lo;
      s_row[2] = hi;
      s_x[0] = q.x0;
      s_x[1] = q.w;
    }
  }
  __syncthreads();
  const int hs = s_row[1], he = s_row[2];
  const bool row_empty = s_row[3];
  const int x0 = s_ws[0];
  const int x1 = he > hs ? s_we[P - 1] : x0;       // an empty row: no columns
  const size_t img_off = (size_t)s_row[0] * H * W * C + c;
  const T* img = feat + img_off;
  const size_t row_stride = (size_t)W * C;

  // the column maxima of columns [t0, t1)
  auto stage = [&](int t0, int t1) {
    if (!c_ok) return;
    for (int x = t0 + grp; x < t1; x += G) {
      const T* p = img + ((size_t)hs * W + x) * C;
      Vec<V> cur = load<T, V>(p);
#pragma unroll 4
      for (int y = hs + 1; y < he; ++y) {
        p += row_stride;
        const Vec<V> v = load<T, V>(p);
#pragma unroll
        for (int k = 0; k < V; ++k) cur.v[k] = nan_max(cur.v[k], v.v[k]);
      }
      s_col[x - t0][lane] = to_staged<T, V>(cur);
    }
  };

  // the bin maxima: thread (lane, grp) folds bins grp and grp + G
  Vec<V> acc[S] = {};
  bool have[S] = {};
  for (int t0 = x0; t0 < x1; t0 += kCols) {
    const int t1 = min(x1, t0 + kCols);
    stage(t0, t1);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = grp + s * G;
      if (j >= P || !c_ok) continue;
      const int lo = max(s_ws[j], t0), hi = min(s_we[j], t1);
      for (int x = lo; x < hi; ++x) {
        const Vec<V> v = from_staged<T, V>(s_col[x - t0][lane]);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          acc[s].v[k] = have[s] ? nan_max(acc[s].v[k], v.v[k]) : v.v[k];
        }
        have[s] = true;
      }
    }
    __syncthreads();
  }

  if constexpr (!kGrad) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = grp + s * G;
      if (j >= P || !c_ok) continue;
      // a bin with no cell: 0 when it is empty by its edges, else (only at
      // bfloat16) JAX's fill
      const float none = row_empty || s_wempty[j] ? 0.0f : bf16_fill();
      Vec<V> o;
#pragma unroll
      for (int k = 0; k < V; ++k) o.v[k] = have[s] ? acc[s].v[k] : none;
      store<T, V>(out + ((size_t)item * P + j) * C + c, o);
    }
  } else {
    // n_w: the bin's columns whose max equals m (JAX's first division)
    IVec<V> nw[S] = {};
    const bool tiled = x1 - x0 > kCols;
    for (int t0 = x0; t0 < x1; t0 += kCols) {
      const int t1 = min(x1, t0 + kCols);
      if (tiled) {
        stage(t0, t1);
        __syncthreads();
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int j = grp + s * G;
        if (j >= P || !c_ok) continue;
        const int lo = max(s_ws[j], t0), hi = min(s_we[j], t1);
        for (int x = lo; x < hi; ++x) {
          const Vec<V> v = from_staged<T, V>(s_col[x - t0][lane]);
#pragma unroll
          for (int k = 0; k < V; ++k) nw[s].v[k] += v.v[k] == acc[s].v[k];
        }
      }
      if (tiled) __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = grp + s * G;
      if (j >= P || !c_ok) continue;
      const Vec<V> g = load<T, V>(gout + (size_t)j * C);
      Vec<V> q;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        q.v[k] = have[s] ? g.v[k] / (float)nw[s].v[k] : 0.0f;
      }
      s_m[j][lane] = to_staged<T, V>(acc[s]);
      s_q[j][lane] = q;
    }
    __syncthreads();

    // per column x: g_x = the sum of q_j over its bins j whose max equals
    // the column max, added as g_x / n_h into each of the n_h rows equal
    // to it
    // bfloat16: the plan pass zeroes the sums while this block stages;
    // wait for it before adding, then let the finish pass start
    if constexpr (kBf16) {
      pdl_wait();
      pdl_trigger();
    }
    float* gimg = grad_feat + img_off;
    const long long rx0 = s_x[0], rw = s_x[1];
    for (int t0 = x0; t0 < x1; t0 += kCols) {
      const int t1 = min(x1, t0 + kCols);
      if (tiled) {
        __syncthreads();
        stage(t0, t1);
        __syncthreads();
      }
      if (!c_ok) continue;
      for (int x = t0 + grp; x < t1; x += G) {
        const Vec<V> col = from_staged<T, V>(s_col[x - t0][lane]);
        // the bins holding x: those whose edges hold its coordinate, x
        // itself or, at bfloat16, rb(x), which can reach W (no bin there)
        const int v = kBf16 ? bf16_coord(x) : x;
        if (v >= W || v - rx0 >= rw) continue;
        int j0, j1;
        covering_bins(v - rx0, rw, P, j0, j1);
        Vec<V> gx = {};
        bool take = false;
        for (int j = j0; j <= j1; ++j) {
          const Vec<V> m = from_staged<T, V>(s_m[j][lane]);
          const Vec<V> q = s_q[j][lane];
#pragma unroll
          for (int k = 0; k < V; ++k) {
            if (m.v[k] == col.v[k]) gx.v[k] += q.v[k];
          }
        }
#pragma unroll
        for (int k = 0; k < V; ++k) take |= gx.v[k] != 0.0f;
        if (!take) continue;
        const T* p0 = img + ((size_t)hs * W + x) * C;
        int n_h[V] = {};
        const T* p = p0;
#pragma unroll 4
        for (int y = hs; y < he; ++y, p += row_stride) {
          const Vec<V> e = load<T, V>(p);
#pragma unroll
          for (int k = 0; k < V; ++k) n_h[k] += e.v[k] == col.v[k];
        }
#pragma unroll
        for (int k = 0; k < V; ++k) gx.v[k] = gx.v[k] / (float)n_h[k];
        p = p0;
        float* gp = gimg + ((size_t)hs * W + x) * C;
        for (int y = hs; y < he; ++y, p += row_stride, gp += row_stride) {
          const Vec<V> e = load<T, V>(p);
          Vec<V> add;
          bool hit = false;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            add.v[k] = e.v[k] == col.v[k] ? gx.v[k] : 0.0f;
            hit |= add.v[k] != 0.0f;
          }
          if (!hit) continue;
          // one 16-byte atomic for 4 channels (adding 0 where a channel
          // does not tie): the taps' dead channels tie whole bins at 0
          if constexpr (V == 1) {
            atomicAdd(gp, add.v[0]);
          } else {
#pragma unroll
            for (int k = 0; k < V; k += 4) {
              atomicAdd(reinterpret_cast<float4*>(gp + k),
                        make_float4(add.v[k], add.v[k + 1], add.v[k + 2],
                                    add.v[k + 3]));
            }
          }
        }
      }
    }
  }
}

bool bad_shape(int B, int H, int W, int C, int R, int P) {
  return B < 1 || H < 1 || W < 1 || C < 0 || R < 0 || P < 1 || P > kMaxP ||
         (long long)R * P * P > 0x7fffffffLL ||
         (long long)R * P * ((C + 7) / 8) > 0x7fffffffLL ||
         (long long)B * ((H + kTile - 1) / kTile) *
                 ((W + kTile - 1) / kTile) > 0x7fffffffLL ||
         (long long)kTile * kTile * C > 0x7fffffffLL;
}

// vec: the elements of a load, 4 float32 (16 bytes), 4 bfloat16 (8
// bytes), 8 bfloat16 (16 bytes, the forward only), or 1
bool bad_vec(int dtype, int vec, int C, bool backward) {
  return !((dtype == 0 && (vec == 1 || vec == 4)) ||
           (dtype == 1 && (vec == 1 || vec == 4 || (vec == 8 && !backward)))) ||
         C % vec != 0;
}

// lanes 8 (8 V channels a block), or 16 or 32 with vector loads; a thread
// folds at most 2 of G = 256 / lanes bins, so P <= 2 G
bool bad_lanes(int lanes, int vec, int P) {
  return !(lanes == 8 || ((lanes == 16 || lanes == 32) && vec > 1 &&
                          P <= 2 * kThreads / lanes));
}

int grid_of(size_t n) {
  return (int)min((n + kThreads - 1) / kThreads, (size_t)4096);
}

// kernel<<<grid, threads, smem, s>>>(args...), with early as a programmatic
// dependent launch: it may start before the kernel before it on s has
// finished, and must pdl_wait before it reads or writes what that kernel
// writes.
template <typename... KArgs, typename... Args>
cudaError_t launch_after_previous(bool early, void (*kernel)(KArgs...),
                                  int grid, int threads, size_t smem,
                                  cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = early;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

// Forward: the rows kernel. Backward at float32: the map gradient zeroed
// and the rows kernel adding into it; at bfloat16: the touched tiles' sums
// zeroed (gf) and every tile marked in grad_feat, the rows kernel adding
// into the sums, and every element of grad_feat written from them.
template <typename T, int V, int L, bool kGrad>
int launch_rows(const T* f, const float* r, T* o, const T* g, float* gf,
                T* grad_feat, int B, int H, int W, int C, int R, int P,
                float scale, cudaStream_t s) {
  constexpr bool kBf16 = std::is_same_v<T, bf16>;
  // at most 45056 bytes at float32 (28672 + 2 P L 16 with P L <= 512 by
  // bad_lanes), 35840 at bfloat16 (23552 + P L 24): with the static arrays
  // under the 48 KB a launch gets without raising its limit
  const size_t bytes = smem_bytes<T, V, L, kGrad>(P);
  const size_t n = (size_t)B * H * W * C;
  const int tiles = B * ((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
  if constexpr (kGrad && !kBf16) {
    if (V == 1) {
      roi_pool_zero_kernel<1><<<grid_of(n), kThreads, 0, s>>>(gf, n);
    } else {
      roi_pool_zero_kernel<4><<<grid_of(n / 4), kThreads, 0, s>>>(gf, n / 4);
    }
  }
  if constexpr (kGrad && kBf16) {
    roi_pool_plan_kernel<V><<<tiles, kTileThreads, 0, s>>>(
        r, gf, grad_feat, R, B, H, W, C, scale);
  }
  if (kGrad) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (R > 0) {
    const int chunks = (C + L * V - 1) / (L * V);
    if constexpr (kGrad && kBf16) {
      const cudaError_t err = launch_after_previous(
          true, roi_pool_rows_kernel<T, V, L, kGrad>, R * P * chunks, kThreads,
          bytes, s, f, r, o, g, gf, B, H, W, C, P, chunks, scale);
      if (err != cudaSuccess) return (int)err;
    } else {
      roi_pool_rows_kernel<T, V, L, kGrad>
          <<<R * P * chunks, kThreads, bytes, s>>>(f, r, o, g, gf, B, H, W,
                                                   C, P, chunks, scale);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if constexpr (kGrad && kBf16) {
    // early only after the rows kernel, whose block 0 waits for the plan:
    // the finish pass reads the plan's marks before it waits
    const cudaError_t err =
        launch_after_previous(R > 0, roi_pool_finish_kernel<V>, tiles,
                              kTileThreads, 0, s, gf, grad_feat, H, W, C);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T, int V, bool kGrad>
int launch_lanes(int lanes, const void* f, const float* r, void* o,
                 const void* g, float* gf, void* grad_feat, int B, int H,
                 int W, int C, int R, int P, float scale, cudaStream_t s) {
  const T* ft = (const T*)f;
  const T* gt = (const T*)g;
  T* ot = (T*)o;
  T* dt = (T*)grad_feat;
  if constexpr (V > 1) {
    if (lanes == 32) {
      return launch_rows<T, V, 32, kGrad>(ft, r, ot, gt, gf, dt, B, H, W, C,
                                          R, P, scale, s);
    }
    if (lanes == 16) {
      return launch_rows<T, V, 16, kGrad>(ft, r, ot, gt, gf, dt, B, H, W, C,
                                          R, P, scale, s);
    }
  }
  return launch_rows<T, V, 8, kGrad>(ft, r, ot, gt, gf, dt, B, H, W, C, R, P,
                                     scale, s);
}

template <typename T, bool kGrad>
int launch(int vec, int lanes, const void* f, const float* r, void* o,
           const void* g, float* gf, void* grad_feat, int B, int H, int W,
           int C, int R, int P, float scale, cudaStream_t s) {
  if constexpr (std::is_same_v<T, bf16> && !kGrad) {
    if (vec == 8) {
      return launch_lanes<T, 8, kGrad>(lanes, f, r, o, g, gf, grad_feat, B,
                                       H, W, C, R, P, scale, s);
    }
  }
  if (vec == 4) {
    return launch_lanes<T, 4, kGrad>(lanes, f, r, o, g, gf, grad_feat, B, H,
                                     W, C, R, P, scale, s);
  }
  return launch_lanes<T, 1, kGrad>(lanes, f, r, o, g, gf, grad_feat, B, H, W,
                                   C, R, P, scale, s);
}

}  // namespace

extern "C" {

const char* tllod_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// feat: (B, H, W, C) contiguous, dtype 0 = float32, 1 = bfloat16; rois:
// (R, 5) float32; out: (R, P, P, C) of feat's dtype. vec: 4 (float32) or
// 8 (bfloat16) for 16-byte loads, at bfloat16 4 for 8-byte loads (C a
// multiple of it, feat and out aligned to the load), else 1; lanes: 8, or
// 16 or 32 with vector loads.
int tllod_roi_pool_forward(const void* feat, const void* rois, void* out,
                           int dtype, int B, int H, int W, int C, int R,
                           int P, float spatial_scale, int vec, int lanes,
                           void* stream) {
  if (bad_shape(B, H, W, C, R, P) || bad_vec(dtype, vec, C, false) ||
      bad_lanes(lanes, vec, P))
    return (int)cudaErrorInvalidValue;
  if (R == 0 || C == 0) return 0;
  const float* r = (const float*)rois;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0
             ? launch<float, false>(vec, lanes, feat, r, out, nullptr,
                                    nullptr, nullptr, B, H, W, C, R, P,
                                    spatial_scale, s)
             : launch<bf16, false>(vec, lanes, feat, r, out, nullptr,
                                   nullptr, nullptr, B, H, W, C, R, P,
                                   spatial_scale, s);
}

// grad_out: (R, P, P, C) of feat's dtype, contiguous; feat: the forward's
// map; rois: (R, 5) float32; grad_feat: (B, H, W, C) of feat's dtype, every
// element written; scratch: at bfloat16 a float32 (B, H, W, C) buffer of
// which only the tiles that RoIs touch are written and read (its other
// elements may hold anything), else unused (float32 sums go straight into
// grad_feat). vec and lanes as the forward's (grad_out, grad_feat and
// scratch aligned to the load). Device passes on the stream:
// float32, roi_pool_zero_kernel and the rows kernel adding the gradient
// in; bfloat16, roi_pool_plan_kernel, the rows kernel and
// roi_pool_finish_kernel.
int tllod_roi_pool_backward(const void* grad_out, const void* feat,
                            const void* rois, void* grad_feat, void* scratch,
                            int dtype, int B, int H, int W, int C, int R,
                            int P, float spatial_scale, int vec, int lanes,
                            void* stream) {
  if (bad_shape(B, H, W, C, R, P) || bad_vec(dtype, vec, C, true) ||
      bad_lanes(lanes, vec, P) || (dtype == 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const float* r = (const float*)rois;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0
             ? launch<float, true>(vec, lanes, feat, r, nullptr, grad_out,
                                   (float*)grad_feat, nullptr, B, H, W, C, R,
                                   P, spatial_scale, s)
             : launch<bf16, true>(vec, lanes, feat, r, nullptr, grad_out,
                                  (float*)scratch, grad_feat, B, H, W, C, R,
                                  P, spatial_scale, s);
}

}  // extern "C"
