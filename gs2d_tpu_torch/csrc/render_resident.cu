// Resident-table rasterizer kernels for Hopper (sm_90a), bound with ctypes
// through a plain C interface (gs2d_tpu_torch/ops/_build.py).
//
// Kernel 1, gs2d_l2_resident: the fused L2 train step.
//   Replaces gs2d_tpu/ops/render_pallas_resident.py::_l2_resident_kernel
//   (pallas_call at :231). One block per tile: gather the tile's listed
//   rows of the packed table into shared memory, composite front to back,
//   form the cotangent gC = C - ref in registers, replay backward with the
//   (ga, T) carry re-deriving coverage (the alpha_cache=False form: a
//   K x 32 x 128 G-cache is 8 MB and does not fit a block), and write one
//   deterministic 9-moment partial per (tile, slot). A second kernel adds
//   each splat's partials in tile order into the (16, n_pad) moment rows,
//   in place of the TPU kernel's one-hot MXU expansion. No atomics, so runs
//   repeat bit for bit.
// Kernel 2, gs2d_fwd_resident: the forward composite (C, T).
//   Replaces render_pallas_resident.py::_fwd_resident_kernel (pallas_call
//   at :366).
// Kernel 3, gs2d_bwd_resident: the backward replay alone, from a carry-in
//   prefix (C_in, T_in) under any upstream cotangent gC read from a plane
//   (the VJP of the differentiable render, e.g. under the SSIM objective).
//   Replaces render_pallas_resident.py::_bwd_resident_kernel (pallas_call
//   at :451). It runs kernel 1's replay (replay_moments) from other inputs
//   and shares its segment sum.
//
// What bounds them on the card: about 58 f32 operations per (pixel, slot)
// in the forward and 81 in the backward replay (counted in chip_smoke.py),
// against under 100 KB of table and ids, so all three are compute and
// latency bound. Each thread keeps kRows pixels of one tile column in
// registers and reads the splat scalars from shared memory as broadcasts.
// Known shortfall: one block per tile gives 21 blocks on 132 SMs at the
// default 268x213 workload with 32x128 tiles; splitting tiles or choosing a
// Hopper tile shape is the first performance item in ROADMAP.md.

#include <cuda_runtime.h>

#include "splat_terms.cuh"
#include "tile_walk.cuh"

namespace gs2d {

constexpr int kRows = walk::kRows;  // pixel rows per thread (one column each)
constexpr int kChunk = 32;      // slots per shared-memory reduction round
constexpr int kMaxThreads = 512;

struct PixelCoords {
  int xx, y0;
  float fx;
};

__device__ __forceinline__ PixelCoords pixel_coords(const RenderArgs& p) {
  const int tile = blockIdx.x;
  const int tx = tile % p.n_tiles_x;
  const int ty = tile / p.n_tiles_x;
  const int col = threadIdx.x % p.tile_w;
  const int grp = threadIdx.x / p.tile_w;
  PixelCoords c;
  c.xx = tx * p.tile_w + col;
  c.y0 = ty * p.tile_h + grp * kRows;
  c.fx = (float)c.xx + 0.5f;
  return c;
}

// Stage the first n listed rows of the table into shared memory.
__device__ __forceinline__ void gather_rows(const float* __restrict__ table,
                                            const int* __restrict__ ids,
                                            int n, const RenderArgs& p,
                                            float* rows) {
  const int* tile_ids = ids + (size_t)blockIdx.x * p.k_cap;
  for (int i = threadIdx.x; i < n * kFields; i += blockDim.x) {
    rows[i] = table[(size_t)tile_ids[i / kFields] * kFields + i % kFields];
  }
}

// The backward replay of a tile's n listed rows (in shared memory) from the
// carry (ga, T) under the cotangent (gc, gf): pass 2 of kernel 1 and all of
// kernel 3. Writes one 9-moment partial per slot to out (K x 9); red holds
// warps x kChunk x 9 floats.
__device__ __forceinline__ void replay_moments(
    const float* rows, int n, const PixelCoords& c, const RenderArgs& p,
    const float (&gc_r)[kRows], const float (&gc_g)[kRows],
    const float (&gc_b)[kRows], const float (&gf)[kRows], float (&ga)[kRows],
    float (&T)[kRows], float* red, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int k0 = 0; k0 < n; k0 += kChunk) {
    const int kn = min(kChunk, n - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const Splat s = load_splat(rows + (k0 + kk) * kFields);
      Moments m;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int yy = c.y0 + r;
        const bool inside = yy < p.height && c.xx < p.width;
        bwd_one(s, c.xx, yy, c.fx, (float)yy + 0.5f, inside, p, gc_r[r],
                gc_g[r], gc_b[r], gf[r], ga[r], T[r], m);
      }
      float v[kMoments];
      m.finish(c.fx - s.px, v);
      // Fixed-order warp tree, then the warps in index order below: the
      // sum order never changes between runs.
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
          red[(warp * kChunk + kk) * kMoments + f] = v[f];
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kn * kMoments; i += blockDim.x) {
      float acc = 0.0f;
      for (int w = 0; w < n_warps; ++w) acc += red[w * kChunk * kMoments + i];
      out[(size_t)k0 * kMoments + i] = acc;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMaxThreads)
fwd_resident_kernel(const float* __restrict__ table,
                    const int* __restrict__ ids,
                    const int* __restrict__ count, float* __restrict__ color,
                    float* __restrict__ trans, RenderArgs p) {
  extern __shared__ float smem[];
  const int n = count[blockIdx.x];
  gather_rows(table, ids, n, p, smem);
  __syncthreads();

  const PixelCoords c = pixel_coords(p);
  float cr[kRows], cg[kRows], cb[kRows], T[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool inside = (c.y0 + r) < p.height && c.xx < p.width;
    cr[r] = cg[r] = cb[r] = 0.0f;
    T[r] = inside ? 1.0f : 0.0f;
  }
  for (int k = 0; k < n; ++k) {
    const Splat s = load_splat(smem + k * kFields);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int yy = c.y0 + r;
      const bool inside = yy < p.height && c.xx < p.width;
      fwd_one(s, c.xx, yy, c.fx, (float)yy + 0.5f, inside, p, cr[r], cg[r],
              cb[r], T[r]);
    }
  }
  const size_t wp = (size_t)p.n_tiles_x * p.tile_w;
  const size_t plane = (size_t)p.n_tiles_y * p.tile_h * wp;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const size_t i = (size_t)(c.y0 + r) * wp + c.xx;
    color[i] = cr[r];
    color[plane + i] = cg[r];
    color[2 * plane + i] = cb[r];
    trans[i] = T[r];
  }
}

__global__ void __launch_bounds__(kMaxThreads)
l2_resident_kernel(const float* __restrict__ table,
                   const int* __restrict__ ids, const int* __restrict__ count,
                   const float* __restrict__ ref, float* __restrict__ color,
                   float* __restrict__ partial, RenderArgs p) {
  extern __shared__ float smem[];
  float* rows = smem;                               // K x kFields
  float* red = smem + (size_t)p.k_cap * kFields;    // warps x kChunk x 9
  const int n = count[blockIdx.x];
  gather_rows(table, ids, n, p, rows);
  __syncthreads();

  // ---- pass 1: forward composite ----------------------------------------
  const PixelCoords c = pixel_coords(p);
  float gc_r[kRows], gc_g[kRows], gc_b[kRows], gf[kRows], ga[kRows],
      T[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool inside = (c.y0 + r) < p.height && c.xx < p.width;
    gc_r[r] = gc_g[r] = gc_b[r] = 0.0f;
    T[r] = inside ? 1.0f : 0.0f;
  }
  for (int k = 0; k < n; ++k) {
    const Splat s = load_splat(rows + k * kFields);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int yy = c.y0 + r;
      const bool inside = yy < p.height && c.xx < p.width;
      // gc_* hold the composite colour until the cotangent is formed.
      fwd_one(s, c.xx, yy, c.fx, (float)yy + 0.5f, inside, p, gc_r[r],
              gc_g[r], gc_b[r], T[r]);
    }
  }

  // ---- cotangent gC = C - ref, gf = sum_ch gC * C ------------------------
  const size_t wp = (size_t)p.n_tiles_x * p.tile_w;
  const size_t plane = (size_t)p.n_tiles_y * p.tile_h * wp;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int yy = c.y0 + r;
    const size_t i = (size_t)yy * wp + c.xx;
    const float fr = gc_r[r], fg = gc_g[r], fb = gc_b[r];
    color[i] = fr;
    color[plane + i] = fg;
    color[2 * plane + i] = fb;
    gc_r[r] = fr - ref[i];
    gc_g[r] = fg - ref[plane + i];
    gc_b[r] = fb - ref[2 * plane + i];
    gf[r] = gc_r[r] * fr + gc_g[r] * fg + gc_b[r] * fb;
    ga[r] = 0.0f;
    T[r] = (yy < p.height && c.xx < p.width) ? 1.0f : 0.0f;
  }

  // ---- pass 2: backward replay, per-slot moments ---------------------------
  replay_moments(rows, n, c, p, gc_r, gc_g, gc_b, gf, ga, T, red,
                 partial + (size_t)blockIdx.x * p.k_cap * kMoments);
}

__global__ void __launch_bounds__(kMaxThreads)
bwd_resident_kernel(const float* __restrict__ table,
                    const int* __restrict__ ids,
                    const int* __restrict__ count,
                    const float* __restrict__ fin,
                    const float* __restrict__ gc,
                    const float* __restrict__ cin,
                    const float* __restrict__ tin,
                    float* __restrict__ partial, RenderArgs p) {
  extern __shared__ float smem[];
  float* rows = smem;                               // K x kFields
  float* red = smem + (size_t)p.k_cap * kFields;    // warps x kChunk x 9
  const int n = count[blockIdx.x];
  gather_rows(table, ids, n, p, rows);
  __syncthreads();

  const PixelCoords c = pixel_coords(p);
  float gc_r[kRows], gc_g[kRows], gc_b[kRows], gf[kRows], ga[kRows],
      T[kRows];
  walk::load_cotangent(fin, gc, cin, tin, p, c.xx, c.y0, gc_r, gc_g, gc_b,
                       gf, ga, T);
  replay_moments(rows, n, c, p, gc_r, gc_g, gc_b, gf, ga, T, red,
                 partial + (size_t)blockIdx.x * p.k_cap * kMoments);
}

// Splat-axis expansion: grads16[f][i] = sum over tiles, in tile order, of
// the partial at the slot where splat i appears. Tile lists are ascending
// in splat id (index order), so each lookup is a binary search.
__global__ void segment_sum_kernel(const int* __restrict__ ids,
                                   const int* __restrict__ count,
                                   const float* __restrict__ partial,
                                   float* __restrict__ grads16, int n_tiles,
                                   int k_cap, int n_splats, int n_pad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_splats) return;
  float acc[kMoments];
#pragma unroll
  for (int f = 0; f < kMoments; ++f) acc[f] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    add_run_moments(ids + (size_t)t * k_cap, count[t],
                    partial + (size_t)t * k_cap * kMoments, i, acc);
  }
#pragma unroll
  for (int f = 0; f < kMoments; ++f) grads16[(size_t)f * n_pad + i] = acc[f];
}

int launch_segment_sum(const int* ids, const int* count,
                       const float* partial, float* grads, int n_tiles,
                       int k_cap, int n_splats, int n_pad,
                       cudaStream_t stream) {
  segment_sum_kernel<<<(n_splats + 127) / 128, 128, 0, stream>>>(
      ids, count, partial, grads, n_tiles, k_cap, n_splats, n_pad);
  return (int)cudaGetLastError();
}

RenderArgs make_args(int height, int width, int tile_h, int tile_w,
                     int n_tiles_x, int n_tiles_y, int k_cap,
                     float cutoff_sq, float min_throughput,
                     int use_exp_approx) {
  RenderArgs p;
  p.height = height;
  p.width = width;
  p.tile_h = tile_h;
  p.tile_w = tile_w;
  p.n_tiles_x = n_tiles_x;
  p.n_tiles_y = n_tiles_y;
  p.k_cap = k_cap;
  p.cutoff_sq = cutoff_sq;
  p.min_throughput = min_throughput;
  p.use_exp_approx = use_exp_approx;
  return p;
}

}  // namespace gs2d

using namespace gs2d;

extern "C" {

// Threads per block and pixel rows per thread; the wrapper checks shapes
// against these before launching.
int gs2d_rows_per_thread() { return kRows; }
int gs2d_max_threads() { return kMaxThreads; }

const char* gs2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Kernel 1. ref and color are (3, Hp, Wp); partial is (n_tiles, K, 9)
// scratch; grads16 is (16, n_pad), zeroed by the caller (rows 9..15 and
// columns >= n_splats are left as they are). Returns cudaGetLastError().
int gs2d_l2_resident(const float* table, const int* ids, const int* count,
                     const float* ref, float* color, float* partial,
                     float* grads16, int n_splats, int n_pad, int height,
                     int width, int tile_h, int tile_w, int n_tiles_x,
                     int n_tiles_y, int k_cap, float cutoff_sq,
                     float min_throughput, int use_exp_approx,
                     void* stream) {
  const RenderArgs p =
      make_args(height, width, tile_h, tile_w, n_tiles_x, n_tiles_y, k_cap,
                cutoff_sq, min_throughput, use_exp_approx);
  const int threads = tile_w * tile_h / kRows;
  const int n_tiles = n_tiles_x * n_tiles_y;
  const size_t smem = sizeof(float) * ((size_t)k_cap * kFields +
                                       (size_t)(threads / 32) * kChunk *
                                           kMoments);
  cudaError_t err = cudaFuncSetAttribute(
      l2_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  l2_resident_kernel<<<n_tiles, threads, smem, s>>>(table, ids, count, ref,
                                                    color, partial, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_segment_sum(ids, count, partial, grads16, n_tiles, k_cap,
                            n_splats, n_pad, s);
}

// Kernel 3 and the segment sum. fin, gc and cin are (3, Hp, Wp), tin
// (Hp, Wp); partial is (n_tiles, K, 9) scratch; grads16 is (16, n_pad),
// zeroed by the caller. Returns cudaGetLastError().
int gs2d_bwd_resident(const float* table, const int* ids, const int* count,
                      const float* fin, const float* gc, const float* cin,
                      const float* tin, float* partial, float* grads16,
                      int n_splats, int n_pad, int height, int width,
                      int tile_h, int tile_w, int n_tiles_x, int n_tiles_y,
                      int k_cap, float cutoff_sq, float min_throughput,
                      int use_exp_approx, void* stream) {
  const RenderArgs p =
      make_args(height, width, tile_h, tile_w, n_tiles_x, n_tiles_y, k_cap,
                cutoff_sq, min_throughput, use_exp_approx);
  const int threads = tile_w * tile_h / kRows;
  const int n_tiles = n_tiles_x * n_tiles_y;
  const size_t smem = sizeof(float) * ((size_t)k_cap * kFields +
                                       (size_t)(threads / 32) * kChunk *
                                           kMoments);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  bwd_resident_kernel<<<n_tiles, threads, smem, s>>>(table, ids, count, fin,
                                                     gc, cin, tin, partial, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_segment_sum(ids, count, partial, grads16, n_tiles, k_cap,
                            n_splats, n_pad, s);
}

// Kernel 2. color is (3, Hp, Wp), trans (Hp, Wp). Returns
// cudaGetLastError().
int gs2d_fwd_resident(const float* table, const int* ids, const int* count,
                      float* color, float* trans, int height, int width,
                      int tile_h, int tile_w, int n_tiles_x, int n_tiles_y,
                      int k_cap, float cutoff_sq, float min_throughput,
                      int use_exp_approx, void* stream) {
  const RenderArgs p =
      make_args(height, width, tile_h, tile_w, n_tiles_x, n_tiles_y, k_cap,
                cutoff_sq, min_throughput, use_exp_approx);
  const int threads = tile_w * tile_h / kRows;
  const size_t smem = sizeof(float) * (size_t)k_cap * kFields;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fwd_resident_kernel<<<n_tiles_x * n_tiles_y, threads, smem,
                        (cudaStream_t)stream>>>(table, ids, count, color,
                                                trans, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
