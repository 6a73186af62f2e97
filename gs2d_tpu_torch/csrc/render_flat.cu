// Flat-layout rasterizer kernels for Hopper (sm_90a), bound with ctypes
// through a plain C interface (gs2d_tpu_torch/ops/_build.py).
//
// The flat binning (gs2d_tpu_torch/ops/tiles_flat.py) stores each tile's
// index-ordered (tile, splat) pairs as a run of pregathered 16-float rows
// that starts on a kc-row block: tile t owns rows
// [start[t], start[t] + count[t]) of one (M, 16) array.
//
// Kernel 10, gs2d_fwd_flat: the forward composite (C, T).
//   Replaces gs2d_tpu/ops/render_pallas_flat.py::_fwd_flat_kernel
//   (pallas_call at :366).
// Kernel 11, gs2d_bwd_flat: the backward replay from a carry-in prefix
//   (C_in, T_in) for any upstream cotangent gC, writing one 9-moment row per
//   flat pair row; a second kernel adds each splat's rows in tile order into
//   the (9, n) moments. Replaces render_pallas_flat.py::_bwd_flat_kernel
//   (pallas_call at :460) and, for the segment sum, the XLA scatter of
//   _segment_grads_flat. No atomics, so runs repeat bit for bit.
//
// Design. The TPU grid is (tile, chunk) with the chunk axis sequential
// because its carry lives in the output block. Here one block owns one tile
// and walks its ceil(count / kc) chunks in order, staging each chunk's rows
// (contiguous, so the reads coalesce) into shared memory; the (C, T) and
// (ga, T) carries stay in registers across chunks. Each thread keeps kRows
// pixels of one tile column. A tile taller than one pass of kMaxThreads x
// kRows pixels (64-row tiles at tile_w 128) is walked in passes of sub_h
// rows, each a full walk of the list; kernel 11 adds the passes' moment sums
// in pass order. Early exits, both exact (they skip only steps whose every
// pixel fails the T >= 1/256 early-out, so they contribute exactly zero):
// a chunk is skipped once no pixel of the pass is unsaturated, and with
// sat_walk set (N >= SAT_WALK_THRESHOLD in the wrapper) the same block-wide
// check runs every kGroup (= SAT_CHECK_EVERY) splats inside a chunk.
//
// What bounds them on the card: about 45 f32 operations per (pixel, pair)
// forward and 60 more backward, against 64 bytes of row per pair, so both
// are compute and latency bound. Known shortfall: one block per tile gives
// 70 blocks on 132 SMs at 535x426 with 32x128 tiles; splitting tiles is a
// later performance item (ROADMAP.md queue 1b).

#include <cuda_runtime.h>

#include "splat_terms.cuh"

namespace gs2d {
namespace flat {

constexpr int kRows = 8;          // pixel rows per thread (one column each)
constexpr int kMaxThreads = 512;  // threads per block (one pass)
constexpr int kGroup = 32;        // splats per saturation check and per
                                  // moment-reduction round

struct FlatArgs {
  RenderArgs p;
  int kc;          // chunk rows
  int max_chunks;  // chunk cap per tile (the TPU grid's chunk axis)
  int sat_walk;    // check saturation inside a chunk too
  int sub_h;       // pixel rows per pass
};

// This block's tile and this thread's column, and the first pixel row it
// owns in pass 0.
struct TileWalk {
  int s0, n, nb;
  int xx, y0;
  float fx;
};

__device__ __forceinline__ TileWalk tile_walk(const int* start,
                                              const int* count,
                                              const FlatArgs& a) {
  const RenderArgs& p = a.p;
  const int tile = blockIdx.x;
  TileWalk w;
  w.s0 = start[tile];
  w.n = count[tile];
  w.nb = min((w.n + a.kc - 1) / a.kc, a.max_chunks);
  w.xx = (tile % p.n_tiles_x) * p.tile_w + threadIdx.x % p.tile_w;
  w.y0 = (tile / p.n_tiles_x) * p.tile_h + (threadIdx.x / p.tile_w) * kRows;
  w.fx = (float)w.xx + 0.5f;
  return w;
}

// Block-wide (a barrier): does any pixel of the pass still pass the
// per-pixel early-out T >= min_throughput?
__device__ __forceinline__ bool any_unsaturated(const float (&T)[kRows],
                                                float mt) {
  int any = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) any |= (T[r] >= mt) ? 1 : 0;
  return __syncthreads_or(any) != 0;
}

// Stage chunk c's n_here rows into shared memory (rows are 64-byte
// aligned: a run starts on a kc-row block).
__device__ __forceinline__ void stage_chunk(const float* __restrict__ rows,
                                            const TileWalk& w, int c,
                                            int n_here, const FlatArgs& a,
                                            float* smem) {
  const float4* src = reinterpret_cast<const float4*>(
      rows + ((size_t)w.s0 + (size_t)c * a.kc) * kFields);
  float4* dst = reinterpret_cast<float4*>(smem);
  for (int i = threadIdx.x; i < n_here * (kFields / 4); i += blockDim.x) {
    dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kMaxThreads)
fwd_flat_kernel(const float* __restrict__ rows, const int* __restrict__ start,
                const int* __restrict__ count, float* __restrict__ color,
                float* __restrict__ trans, FlatArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // kc x kFields
  const RenderArgs& p = a.p;
  const TileWalk w = tile_walk(start, count, a);
  const size_t wp = (size_t)p.n_tiles_x * p.tile_w;
  const size_t plane = (size_t)p.n_tiles_y * p.tile_h * wp;
  const bool col_in = w.xx < p.width;

  for (int pass = 0; pass < p.tile_h; pass += a.sub_h) {
    const int y0 = w.y0 + pass;
    float cr[kRows], cg[kRows], cb[kRows], T[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      cr[r] = cg[r] = cb[r] = 0.0f;
      T[r] = (y0 + r < p.height && col_in) ? 1.0f : 0.0f;
    }
    for (int c = 0; c < w.nb; ++c) {
      // Chunk-level skip; also the barrier before smem is overwritten.
      if (!any_unsaturated(T, p.min_throughput)) break;
      const int n_here = min(a.kc, w.n - c * a.kc);
      stage_chunk(rows, w, c, n_here, a, smem);
      __syncthreads();
      for (int k0 = 0; k0 < n_here; k0 += kGroup) {
        if (a.sat_walk && k0 > 0 && !any_unsaturated(T, p.min_throughput)) {
          break;
        }
        const int k1 = min(k0 + kGroup, n_here);
        for (int k = k0; k < k1; ++k) {
          const Splat s = load_splat(smem + k * kFields);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int yy = y0 + r;
            fwd_one(s, w.xx, yy, w.fx, (float)yy + 0.5f,
                    yy < p.height && col_in, p, cr[r], cg[r], cb[r], T[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const size_t i = (size_t)(y0 + r) * wp + w.xx;
      color[i] = cr[r];
      color[plane + i] = cg[r];
      color[2 * plane + i] = cb[r];
      trans[i] = T[r];
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
bwd_flat_kernel(const float* __restrict__ rows, const int* __restrict__ start,
                const int* __restrict__ count, const float* __restrict__ fin,
                const float* __restrict__ gc, const float* __restrict__ cin,
                const float* __restrict__ tin, float* __restrict__ moments,
                FlatArgs a) {
  extern __shared__ float4 smem4[];
  float* srows = reinterpret_cast<float*>(smem4);     // kc x kFields
  float* red = srows + (size_t)a.kc * kFields;        // warps x kGroup x 9
  const RenderArgs& p = a.p;
  const TileWalk w = tile_walk(start, count, a);
  const size_t wp = (size_t)p.n_tiles_x * p.tile_w;
  const size_t plane = (size_t)p.n_tiles_y * p.tile_h * wp;
  const bool col_in = w.xx < p.width;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int pass = 0; pass < p.tile_h; pass += a.sub_h) {
    const int y0 = w.y0 + pass;
    // Replay carry entering the tile: ga = sum_ch gC * C_in, T = T_in;
    // gf = sum_ch gC * C_final.
    float gc_r[kRows], gc_g[kRows], gc_b[kRows], gf[kRows], ga[kRows],
        T[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const size_t i = (size_t)(y0 + r) * wp + w.xx;
      gc_r[r] = gc[i];
      gc_g[r] = gc[plane + i];
      gc_b[r] = gc[2 * plane + i];
      gf[r] = gc_r[r] * fin[i] + gc_g[r] * fin[plane + i] +
              gc_b[r] * fin[2 * plane + i];
      ga[r] = gc_r[r] * cin[i] + gc_g[r] * cin[plane + i] +
              gc_b[r] * cin[2 * plane + i];
      T[r] = tin[i];
    }
    for (int c = 0; c < w.nb; ++c) {
      if (!any_unsaturated(T, p.min_throughput)) break;
      const int n_here = min(a.kc, w.n - c * a.kc);
      stage_chunk(rows, w, c, n_here, a, srows);
      __syncthreads();
      float* out = moments + ((size_t)w.s0 + (size_t)c * a.kc) * kMoments;
      for (int k0 = 0; k0 < n_here; k0 += kGroup) {
        if (a.sat_walk && k0 > 0 && !any_unsaturated(T, p.min_throughput)) {
          break;
        }
        const int kn = min(kGroup, n_here - k0);
        for (int kk = 0; kk < kn; ++kk) {
          const Splat s = load_splat(srows + (k0 + kk) * kFields);
          Moments m;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int yy = y0 + r;
            bwd_one(s, w.xx, yy, w.fx, (float)yy + 0.5f,
                    yy < p.height && col_in, p, gc_r[r], gc_g[r], gc_b[r],
                    gf[r], ga[r], T[r], m);
          }
          float v[kMoments];
          m.finish(w.fx - s.px, v);
          // Fixed-order warp tree, then the warps in index order below.
#pragma unroll
          for (int f = 0; f < kMoments; ++f) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              v[f] += __shfl_down_sync(0xffffffffu, v[f], off);
            }
          }
          if (lane == 0) {
#pragma unroll
            for (int f = 0; f < kMoments; ++f) {
              red[(warp * kGroup + kk) * kMoments + f] = v[f];
            }
          }
        }
        __syncthreads();
        // out is zeroed by the caller; pass 0 adds to 0, later passes add
        // their rows' sums in pass order.
        for (int i = threadIdx.x; i < kn * kMoments; i += blockDim.x) {
          float acc = 0.0f;
          for (int wi = 0; wi < n_warps; ++wi) {
            acc += red[wi * kGroup * kMoments + i];
          }
          out[(size_t)k0 * kMoments + i] += acc;
        }
        __syncthreads();
      }
    }
  }
}

// grads9[f][i] = sum over tiles, in tile order, of splat i's moment row in
// that tile's run.
__global__ void segment_sum_flat_kernel(const int* __restrict__ ids,
                                        const int* __restrict__ start,
                                        const int* __restrict__ count,
                                        const float* __restrict__ moments,
                                        float* __restrict__ grads9,
                                        int n_tiles, int n_splats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_splats) return;
  float acc[kMoments];
#pragma unroll
  for (int f = 0; f < kMoments; ++f) acc[f] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = start[t];
    add_run_moments(ids + s, count[t], moments + (size_t)s * kMoments, i,
                    acc);
  }
#pragma unroll
  for (int f = 0; f < kMoments; ++f) grads9[(size_t)f * n_splats + i] = acc[f];
}

// Fills the launch constants; returns the threads per block, or 0 for a
// tile shape the kernels do not take.
int flat_args(int height, int width, int tile_h, int tile_w, int n_tiles_x,
              int n_tiles_y, int kc, int max_chunks, int sat_walk,
              float cutoff_sq, float min_throughput, int use_exp_approx,
              FlatArgs* a) {
  if (tile_w <= 0 || tile_w % 32 || kc <= 0) return 0;
  const int sub_h = min(tile_h, kMaxThreads * kRows / tile_w);
  if (sub_h <= 0 || sub_h % kRows || tile_h % sub_h) return 0;
  a->p.height = height;
  a->p.width = width;
  a->p.tile_h = tile_h;
  a->p.tile_w = tile_w;
  a->p.n_tiles_x = n_tiles_x;
  a->p.n_tiles_y = n_tiles_y;
  a->p.k_cap = kc;
  a->p.cutoff_sq = cutoff_sq;
  a->p.min_throughput = min_throughput;
  a->p.use_exp_approx = use_exp_approx;
  a->kc = kc;
  a->max_chunks = max_chunks;
  a->sat_walk = sat_walk;
  a->sub_h = sub_h;
  return tile_w * sub_h / kRows;
}

}  // namespace flat
}  // namespace gs2d

using gs2d::flat::FlatArgs;

extern "C" {

// Kernel 10. rows is (M, 16), start/count (n_tiles,); color is
// (3, Hp, Wp), trans (Hp, Wp). Returns cudaGetLastError().
int gs2d_fwd_flat(const float* rows, const int* start, const int* count,
                  float* color, float* trans, int height, int width,
                  int tile_h, int tile_w, int n_tiles_x, int n_tiles_y,
                  int kc, int max_chunks, int sat_walk, float cutoff_sq,
                  float min_throughput, int use_exp_approx, void* stream) {
  FlatArgs a;
  const int threads = gs2d::flat::flat_args(
      height, width, tile_h, tile_w, n_tiles_x, n_tiles_y, kc, max_chunks,
      sat_walk, cutoff_sq, min_throughput, use_exp_approx, &a);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)kc * gs2d::kFields;
  cudaError_t err = cudaFuncSetAttribute(
      gs2d::flat::fwd_flat_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gs2d::flat::fwd_flat_kernel<<<n_tiles_x * n_tiles_y, threads, smem,
                                (cudaStream_t)stream>>>(rows, start, count,
                                                        color, trans, a);
  return (int)cudaGetLastError();
}

// Kernel 11 and the segment sum. fin, gc and cin are (3, Hp, Wp), tin
// (Hp, Wp); moments is (M, 9), zeroed by the caller (rows no chunk reaches
// stay zero); grads9 is (9, n_splats). Returns cudaGetLastError().
int gs2d_bwd_flat(const float* rows, const int* ids, const int* start,
                  const int* count, const float* fin, const float* gc,
                  const float* cin, const float* tin, float* moments,
                  float* grads9, int n_splats, int height, int width,
                  int tile_h, int tile_w, int n_tiles_x, int n_tiles_y,
                  int kc, int max_chunks, int sat_walk, float cutoff_sq,
                  float min_throughput, int use_exp_approx, void* stream) {
  FlatArgs a;
  const int threads = gs2d::flat::flat_args(
      height, width, tile_h, tile_w, n_tiles_x, n_tiles_y, kc, max_chunks,
      sat_walk, cutoff_sq, min_throughput, use_exp_approx, &a);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = n_tiles_x * n_tiles_y;
  const size_t smem =
      sizeof(float) * ((size_t)kc * gs2d::kFields +
                       (size_t)(threads / 32) * gs2d::flat::kGroup *
                           gs2d::kMoments);
  cudaError_t err = cudaFuncSetAttribute(
      gs2d::flat::bwd_flat_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  gs2d::flat::bwd_flat_kernel<<<n_tiles, threads, smem, s>>>(
      rows, start, count, fin, gc, cin, tin, moments, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gs2d::flat::segment_sum_flat_kernel<<<(n_splats + 127) / 128, 128, 0, s>>>(
      ids, start, count, moments, grads9, n_tiles, n_splats);
  return (int)cudaGetLastError();
}

}  // extern "C"
