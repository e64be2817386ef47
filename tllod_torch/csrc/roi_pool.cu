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
// bfloat16 (PA-ATF under --bf16). The kernels are templated on the element
// type T: a 16-byte load is 8 bfloat16 channels (C % 8 != 0 or an unaligned
// pointer: 1-element loads), and every max, compare and sum runs in float32
// registers; the max of bfloat16 values is one of them, so the forward is
// exact. Bin membership is the JAX package's at bfloat16: it compares the
// edges with the cell coordinates jnp.arange(size, dtype=bfloat16)
// (roi_pool.py:64-69), which round to nearest even above 256, so each bin's
// cells are [first x with rb(x) >= start, first x with rb(x) >= end)
// (member_edge), and a bin that is not empty by its edges but holds no cell
// gives JAX's fill, -1e30 rounded to bfloat16, and no gradient. Rows of
// PA-ATF's maps (H <= 150) are not affected; 22 of the 300 columns of its
// c3 map are. The backward adds into a float32 scratch map (zeroed first),
// then roi_pool_cast_kernel rounds it once into the bfloat16 map gradient:
// a third device pass over the map.
//
// What bounds them. PA-ATF's 50 gt RoIs (15 real, then 35 zero-padded 1x1
// rows at (0, 0)) read 8-20 MB of bin pixels for a few MB of distinct map,
// and the backward writes the whole map gradient (46 MB at c3): bytes, but
// at these sizes first the latency of each block's chain of loads and the
// number of blocks a wave holds. The kernels before gave a thread one
// channel of one bin, a serial chain of 4-byte loads over up to ~100
// pixels; most blocks were the padding rows' and did one load.
//
// Design (roi_pool_rows_kernel, both directions). A block takes one RoI's
// bin row and a chunk of L lanes of 16-byte loads (4 float32 or 8 bfloat16
// channels each; 1 when C is not a multiple of that or the data is not
// 16-byte aligned): L = 32 (128 float32 channels) for deep maps, 16 or 8
// for C = 256, so the 256 threads are L lanes times 256
// / L column groups (the wrapper's lanes rule). Threads 0..P compute the
// RoI's bin edges once into shared memory. The groups split the bin row's
// columns, each taking the max over the row's rows of its columns (JAX's
// H-then-W order) into shared memory; each thread then folds the column
// maxima of at most two bins. The grid is 1-D with bin rows in RoI order
// and a bin row's chunks together, so the real gt boxes, which come first,
// start first. Measured against a 2-D (bin row, chunk) grid, an 8-lane-only
// build, a map held in shared memory for many RoIs, a pull backward that
// writes each pixel once from per-bin statistics, a backward that keeps the
// tied rows in bitmasks and one that zeroes the map gradient in the same
// kernel as it adds into it (fill blocks ordered before the rest by a
// ticket): each was slower on PA-ATF's taps or the eval map.
//
// Backward: two device passes. roi_pool_zero_kernel zeroes the map
// gradient with 16-byte stores. Then the rows kernel in its backward mode:
// a bin row whose output gradient is 0 in the chunk (the zero-padded gt
// rows) ends at once; else it computes the column maxima and the bin
// maxima m as the forward does, n_w (the bin's columns whose max equals m)
// and q = g / n_w (JAX's first division), and per column x adds g_x / n_h,
// g_x the sum of q_j over its bins j whose max equals the column max and
// n_h the column's rows equal to it, into each of those rows with one
// 16-byte atomicAdd per row and 4 channels (JAX's transpose; overlapping
// bins add, in an order that varies by run).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 64;

template <int V>
struct alignas(4 * V) Vec {
  float v[V];
};

template <int V>
struct alignas(4 * V) IVec {
  int v[V];
};

using bf16 = __nv_bfloat16;

// V elements of type T from p into float registers: one 16-byte load for
// V = 4 (float) or 8 (bfloat16), else one element
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
  } else {
    static_assert(V == 8, "bfloat16 loads are 8 wide");
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

// Columns of a bin row a block stages in shared memory at once: 28 KB of
// column maxima at V = 4, 14 KB at V = 8 (bfloat16), so that with the
// backward's 2 P L V floats the block stays under the 48 KB a launch gets
// without raising its limit.
template <int L, int V>
__host__ __device__ constexpr int staged_cols() {
  return V == 8 ? 448 / L : 1792 / L;
}

// Dynamic shared memory of a block: the column maxima and, backward, the
// bin row's maxima m and q = g / n_w.
template <int V, int L, bool kGrad>
size_t smem_bytes(int P) {
  const size_t cols = (size_t)staged_cols<L, V>() * L * sizeof(Vec<V>);
  return kGrad ? cols + 2 * (size_t)P * L * sizeof(Vec<V>) : cols;
}

// The backward's first pass: the float32 map gradient (bfloat16: its
// scratch) zeroed, 16 bytes a store.
template <int V>
__global__ void __launch_bounds__(kThreads)
roi_pool_zero_kernel(float* __restrict__ p, size_t n) {
  const Vec<V> zero = {};
  for (size_t t = (size_t)blockIdx.x * kThreads + threadIdx.x; t < n;
       t += (size_t)gridDim.x * kThreads) {
    store<float, V>(p + t * V, zero);
  }
}

// The bfloat16 backward's last pass: the float32 scratch rounded once into
// the map gradient.
__global__ void __launch_bounds__(kThreads)
roi_pool_cast_kernel(const float* __restrict__ src, bf16* __restrict__ dst,
                     size_t n) {
  for (size_t t = (size_t)blockIdx.x * kThreads + threadIdx.x; t < n;
       t += (size_t)gridDim.x * kThreads) {
    dst[t] = __float2bfloat16_rn(src[t]);
  }
}

// Grid R * P * chunks, bin rows in RoI order and a bin row's chunks
// together; a block takes bin row i of RoI r and one chunk of L * V
// channels, L lanes times G = 256 / L column groups. Forward (kGrad false):
// out (R, P, P, C) = the bin maxima. Backward (kGrad true): the bin row's
// gradient added into the float32 grad_feat, zeroed by roi_pool_zero_kernel
// before. The backward is held to 4 blocks an SM at 8 lanes and 3 at 16 or
// 32 (64 and 85 registers at float32), which measured fastest on PA-ATF's
// taps.
template <typename T, int V, int L, bool kGrad>
__global__ void __launch_bounds__(kThreads, !kGrad ? 1 : L == 8 ? 4 : 3)
roi_pool_rows_kernel(const T* __restrict__ feat,
                 const float* __restrict__ rois, T* __restrict__ out,
                 const T* __restrict__ grad_out,
                 float* __restrict__ grad_feat, int B, int H, int W, int C,
                 int P, int chunks, float scale) {
  constexpr bool kBf16 = std::is_same_v<T, bf16>;
  constexpr int G = kThreads / L;
  constexpr int kCols = staged_cols<L, V>();
  constexpr int S = 2;                             // bins a thread folds:
                                                   // P <= 2 G (bad_lanes)
  extern __shared__ __align__(32) unsigned char smem[];
  auto s_col = reinterpret_cast<Vec<V>(*)[L]>(smem);  // column maxima
  auto s_m = s_col + kCols;                           // bin maxima
  auto s_q = s_m + P;                                 // g / n_w
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
    if (!__syncthreads_or(any)) return;
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
      s_col[x - t0][lane] = cur;
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
        const Vec<V> v = s_col[x - t0][lane];
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
          const Vec<V> v = s_col[x - t0][lane];
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
      s_m[j][lane] = acc[s];
      s_q[j][lane] = q;
    }
    __syncthreads();

    // per column x: g_x = the sum of q_j over its bins j whose max equals
    // the column max, added as g_x / n_h into each of the n_h rows equal
    // to it
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
        const Vec<V> col = s_col[x - t0][lane];
        // the bins holding x: those whose edges hold its coordinate, x
        // itself or, at bfloat16, rb(x), which can reach W (no bin there)
        const int v = kBf16 ? bf16_coord(x) : x;
        if (v >= W || v - rx0 >= rw) continue;
        int j0, j1;
        covering_bins(v - rx0, rw, P, j0, j1);
        Vec<V> gx = {};
        bool take = false;
        for (int j = j0; j <= j1; ++j) {
          const Vec<V> m = s_m[j][lane];
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
         (long long)R * P * ((C + 7) / 8) > 0x7fffffffLL;
}

// vec: the elements of a 16-byte load, 4 (float32) or 8 (bfloat16), or 1;
// lanes 8 (8 V channels a block), 16 or 32 (16-byte loads only); a thread
// folds at most 2 of G = 256 / lanes bins, so P <= 2 G
bool bad_vec(int dtype, int vec, int C) {
  const int wide = dtype == 0 ? 4 : 8;
  return !(dtype == 0 || dtype == 1) || (vec != 1 && vec != wide) ||
         C % vec != 0;
}

bool bad_lanes(int lanes, int vec, int P) {
  return !(lanes == 8 ||
           ((lanes == 16 || lanes == 32) && vec > 1 &&
            P <= 2 * kThreads / lanes));
}

int grid_of(size_t n) {
  return (int)min((n + kThreads - 1) / kThreads, (size_t)4096);
}

// Forward: the rows kernel. Backward: the float32 map gradient (bfloat16:
// the scratch) zeroed, the rows kernel adding into it, and at bfloat16 the
// scratch rounded into grad_feat.
template <typename T, int V, int L, bool kGrad>
int launch_rows(const T* f, const float* r, T* o, const T* g, float* gf,
                T* grad_feat, int B, int H, int W, int C, int R, int P,
                float scale, cudaStream_t s) {
  // at most 45056 bytes (28672 + 2 P L 16 with P L <= 512 by bad_lanes;
  // 14336 + 2 P L 32 at bfloat16): under the 48 KB a launch gets without
  // raising its limit
  const size_t bytes = smem_bytes<V, L, kGrad>(P);
  const size_t n = (size_t)B * H * W * C;
  if (kGrad) {
    if (V == 1) {
      roi_pool_zero_kernel<1><<<grid_of(n), kThreads, 0, s>>>(gf, n);
    } else {
      roi_pool_zero_kernel<4><<<grid_of(n / 4), kThreads, 0, s>>>(gf, n / 4);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (R > 0) {
    const int chunks = (C + L * V - 1) / (L * V);
    roi_pool_rows_kernel<T, V, L, kGrad>
        <<<R * P * chunks, kThreads, bytes, s>>>(f, r, o, g, gf, B, H, W, C,
                                                 P, chunks, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if constexpr (kGrad && std::is_same_v<T, bf16>) {
    roi_pool_cast_kernel<<<grid_of(n), kThreads, 0, s>>>(gf, grad_feat, n);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool kGrad>
int launch(int vec, int lanes, const void* f, const float* r, void* o,
           const void* g, float* gf, void* grad_feat, int B, int H, int W,
           int C, int R, int P, float scale, cudaStream_t s) {
  constexpr int kWide = std::is_same_v<T, float> ? 4 : 8;
  const T* ft = (const T*)f;
  const T* gt = (const T*)g;
  T* ot = (T*)o;
  T* dt = (T*)grad_feat;
  if (lanes == 32) {
    return launch_rows<T, kWide, 32, kGrad>(ft, r, ot, gt, gf, dt, B, H, W,
                                            C, R, P, scale, s);
  }
  if (lanes == 16) {
    return launch_rows<T, kWide, 16, kGrad>(ft, r, ot, gt, gf, dt, B, H, W,
                                            C, R, P, scale, s);
  }
  if (vec > 1) {
    return launch_rows<T, kWide, 8, kGrad>(ft, r, ot, gt, gf, dt, B, H, W, C,
                                           R, P, scale, s);
  }
  return launch_rows<T, 1, 8, kGrad>(ft, r, ot, gt, gf, dt, B, H, W, C, R, P,
                                     scale, s);
}

}  // namespace

extern "C" {

const char* tllod_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// feat: (B, H, W, C) contiguous, dtype 0 = float32, 1 = bfloat16; rois:
// (R, 5) float32; out: (R, P, P, C) of feat's dtype. vec: 4 (float32) or
// 8 (bfloat16) for 16-byte loads (C a multiple of it, feat and out 16-byte
// aligned), else 1; lanes: 8, or 16 or 32 with 16-byte loads.
int tllod_roi_pool_forward(const void* feat, const void* rois, void* out,
                           int dtype, int B, int H, int W, int C, int R,
                           int P, float spatial_scale, int vec, int lanes,
                           void* stream) {
  if (bad_shape(B, H, W, C, R, P) || bad_vec(dtype, vec, C) ||
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
// element written; scratch: at bfloat16 a float32 (B, H, W, C) buffer,
// else unused (float32 sums go straight into grad_feat). vec and lanes as
// the forward's (grad_out, grad_feat and scratch 16-byte aligned for 16-byte
// loads). Device passes on the stream: roi_pool_zero_kernel, the rows
// kernel adding the gradient in, and at bfloat16 roi_pool_cast_kernel.
int tllod_roi_pool_backward(const void* grad_out, const void* feat,
                            const void* rois, void* grad_feat, void* scratch,
                            int dtype, int B, int H, int W, int C, int R,
                            int P, float spatial_scale, int vec, int lanes,
                            void* stream) {
  if (bad_shape(B, H, W, C, R, P) || bad_vec(dtype, vec, C) ||
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
