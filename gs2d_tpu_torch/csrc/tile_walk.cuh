// Chunk walk of one tile's contiguous run of pregathered pair rows: the
// one-block-per-tile walk of the references gs2d_fwd_chunk and
// gs2d_bwd_chunk (render_dense.cu: the forward and the backward that
// kernels 6/7 and 8/9 had before their warp patches, kept unchanged as the
// in-call reference of every warp-patch kernel) and gs2d_l2_mxu_chunk
// (render_mxu.cu: kernel 13's, kept unchanged as its reference).
//
// The dense layout stores a tile's index-ordered (tile, splat) pairs as a
// run of 16-float rows starting at t * K (its (n_tiles, K, 16) tile_params).
// One block owns one tile and walks its ceil(count / kc) chunks in order,
// staging each chunk's rows (contiguous, so the reads coalesce) into shared
// memory; the (C, T) and (ga, T) carries stay in registers across chunks.
// Each thread keeps kRows pixels of one tile column. A tile taller than one
// pass of kMaxThreads x kRows pixels (64-row tiles at tile_w 128) is walked
// in passes of sub_h rows, each a full walk of the list; the backward adds
// the passes' moment sums in pass order. Early exits, both exact (they skip
// only steps whose every pixel fails the T >= 1/256 early-out, so they
// contribute exactly zero): a chunk is skipped once no pixel of the pass is
// unsaturated, and with sat_walk set (N >= SAT_WALK_THRESHOLD in the
// wrappers) the same block-wide check runs every kGroup (= SAT_CHECK_EVERY)
// splats inside a chunk. They are the TPU chunked kernels' exits; the
// unchunked TPU kernels have none, which gives the same outputs. The
// warp-patch kernels (patch_walk.cuh) take the pass geometry (walk_args,
// kRows) and the replays' cotangent load (load_cotangent) from here.
#pragma once

#include <cuda_runtime.h>

#include "splat_terms.cuh"

namespace gs2d {
namespace walk {

constexpr int kRows = 8;          // pixel rows per thread (one column each)
constexpr int kMaxThreads = 512;  // threads per block (one pass)
constexpr int kGroup = 32;        // splats per saturation check and per
                                  // moment-reduction round

struct WalkArgs {
  RenderArgs p;
  int kc;          // chunk rows
  int max_chunks;  // chunk cap per tile (the TPU grid's chunk axis)
  int sat_walk;    // check saturation inside a chunk too
  int sub_h;       // pixel rows per pass
  int stride;      // run start of tile t is t * stride
};

// This block's tile run and this thread's column, and the first pixel row
// it owns in pass 0.
struct TileWalk {
  int s0, n, nb;
  int xx, y0;
  float fx;
  bool col_in;
};

__device__ __forceinline__ TileWalk tile_walk(const int* count,
                                              const WalkArgs& a) {
  const RenderArgs& p = a.p;
  const int tile = blockIdx.x;
  TileWalk w;
  w.s0 = tile * a.stride;
  w.n = count[tile];
  w.nb = min((w.n + a.kc - 1) / a.kc, a.max_chunks);
  w.xx = (tile % p.n_tiles_x) * p.tile_w + threadIdx.x % p.tile_w;
  w.y0 = (tile / p.n_tiles_x) * p.tile_h + (threadIdx.x / p.tile_w) * kRows;
  w.fx = (float)w.xx + 0.5f;
  w.col_in = w.xx < p.width;
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
// aligned: a run starts on a row boundary of a 16-float row array).
__device__ __forceinline__ void stage_chunk(const float* __restrict__ rows,
                                            const TileWalk& w, int c,
                                            int n_here, const WalkArgs& a,
                                            float* smem) {
  const float4* src = reinterpret_cast<const float4*>(
      rows + ((size_t)w.s0 + (size_t)c * a.kc) * kFields);
  float4* dst = reinterpret_cast<float4*>(smem);
  for (int i = threadIdx.x; i < n_here * (kFields / 4); i += blockDim.x) {
    dst[i] = src[i];
  }
}

// Forward composite of one pass's pixels (rows y0 .. y0 + kRows - 1 of this
// thread's column) over the tile's run, carrying (cr, cg, cb, T).
__device__ __forceinline__ void fwd_pass(const float* __restrict__ rows,
                                         const TileWalk& w, int y0,
                                         const WalkArgs& a, float* smem,
                                         float (&cr)[kRows],
                                         float (&cg)[kRows],
                                         float (&cb)[kRows],
                                         float (&T)[kRows]) {
  const RenderArgs& p = a.p;
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
                  yy < p.height && w.col_in, p, cr[r], cg[r], cb[r], T[r]);
        }
      }
    }
  }
}

// Backward replay of one pass's pixels over the tile's run from the carry
// (ga, T) under the cotangent (gc, gf), adding each pair's 9-moment sum
// over the pass to its row of moments (zeroed by the caller; pass 0 adds to
// 0, later passes add in pass order). srows holds kc rows, red
// warps x kGroup x 9 floats.
__device__ __forceinline__ void bwd_pass(
    const float* __restrict__ rows, const TileWalk& w, int y0,
    const WalkArgs& a, float* srows, float* red, const float (&gc_r)[kRows],
    const float (&gc_g)[kRows], const float (&gc_b)[kRows],
    const float (&gf)[kRows], float (&ga)[kRows], float (&T)[kRows],
    float* __restrict__ moments) {
  const RenderArgs& p = a.p;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
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
                  yy < p.height && w.col_in, p, gc_r[r], gc_g[r], gc_b[r],
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

// Reads the cotangent planes of one pass into registers: gc, gf = sum_ch
// gC * C_final, and the replay carry entering the tile, ga = sum_ch gC *
// C_in and T = T_in. Planes are (3, Hp, Wp) / (Hp, Wp).
__device__ __forceinline__ void load_cotangent(
    const float* __restrict__ fin, const float* __restrict__ gc,
    const float* __restrict__ cin, const float* __restrict__ tin,
    const RenderArgs& p, int xx, int y0, float (&gc_r)[kRows],
    float (&gc_g)[kRows], float (&gc_b)[kRows], float (&gf)[kRows],
    float (&ga)[kRows], float (&T)[kRows]) {
  const size_t wp = (size_t)p.n_tiles_x * p.tile_w;
  const size_t plane = (size_t)p.n_tiles_y * p.tile_h * wp;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const size_t i = (size_t)(y0 + r) * wp + xx;
    gc_r[r] = gc[i];
    gc_g[r] = gc[plane + i];
    gc_b[r] = gc[2 * plane + i];
    gf[r] = gc_r[r] * fin[i] + gc_g[r] * fin[plane + i] +
            gc_b[r] * fin[2 * plane + i];
    ga[r] = gc_r[r] * cin[i] + gc_g[r] * cin[plane + i] +
            gc_b[r] * cin[2 * plane + i];
    T[r] = tin[i];
  }
}

// Fills the launch constants; returns the threads per block, or 0 for a
// tile shape the kernels do not take.
inline int walk_args(int height, int width, int tile_h, int tile_w,
                     int n_tiles_x, int n_tiles_y, int kc, int max_chunks,
                     int sat_walk, int stride, float cutoff_sq,
                     float min_throughput, int use_exp_approx, WalkArgs* a) {
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
  a->p.row_off = 0;
  a->kc = kc;
  a->max_chunks = max_chunks;
  a->sat_walk = sat_walk;
  a->sub_h = sub_h;
  a->stride = stride;
  return tile_w * sub_h / kRows;
}

// Dynamic shared memory of a backward walk: kc staged rows plus the warps'
// reduction rounds.
inline size_t bwd_smem_bytes(int kc, int threads) {
  return sizeof(float) *
         ((size_t)kc * kFields + (size_t)(threads / 32) * kGroup * kMoments);
}

}  // namespace walk
}  // namespace gs2d
