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
// Kernel 12, gs2d_l2_window: kernel 1 with the window layout's splat-axis
//   sum. Replaces gs2d_tpu/ops/render_pallas_window.py::_l2_window_kernel
//   (pallas_call at :228), which expands the per-slot gradient columns onto
//   a per-tile window [base_t, base_t + W) of the splat axis and drops ids
//   past it (the escaped pairs, counted by the wrapper). The tile's work is
//   kernel 1's (l2_tile, so the colour and partials are kernel 1's bit for
//   bit); the window sum adds splat i's partials only from the tiles whose
//   window holds i, in tile order. With no escapes it visits a subset of the
//   tiles kernel 1's segment sum visits, in the same order, and adds the same
//   partials, so the two steps agree bit for bit.
//
// A tile taller than one pass of kMaxThreads x kRows pixels (64-row tiles at
// tile_w 128) is walked in passes of sub_h rows: the forward of each pass is
// a full walk of the list, and the replay adds each pass's per-slot moments,
// in pass order, to the (tile, slot) partial, which the caller zeroes.
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
constexpr int kChunk = walk::kGroup;  // slots per shared-memory reduction round
constexpr int kMaxThreads = walk::kMaxThreads;

struct PixelCoords {
  int xx, y0;
  float fx;
};

// This thread's column and its first pixel row in pass 0.
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

// The backward replay of a tile's n listed rows (in shared memory) over the
// pass whose first rows c names, from the carry (ga, T) under the cotangent
// (gc, gf): pass 2 of kernels 1 and 12 and all of kernel 3. Adds the pass's
// 9-moment sum of each slot to out (K x 9, zeroed by the caller); red holds
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
      out[(size_t)k0 * kMoments + i] += acc;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMaxThreads)
fwd_resident_kernel(const float* __restrict__ table,
                    const int* __restrict__ ids,
                    const int* __restrict__ count, float* __restrict__ color,
                    float* __restrict__ trans, RenderArgs p, int sub_h) {
  extern __shared__ float smem[];
  const int n = count[blockIdx.x];
  gather_rows(table, ids, n, p, smem);
  __syncthreads();

  const size_t wp = (size_t)p.n_tiles_x * p.tile_w;
  const size_t plane = (size_t)p.n_tiles_y * p.tile_h * wp;
  for (int pass = 0; pass < p.tile_h; pass += sub_h) {
    PixelCoords c = pixel_coords(p);
    c.y0 += pass;
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
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const size_t i = (size_t)(c.y0 + r) * wp + c.xx;
      color[i] = cr[r];
      color[plane + i] = cg[r];
      color[2 * plane + i] = cb[r];
      trans[i] = T[r];
    }
  }
}

// The fused L2 step of one tile (kernels 1 and 12): gather the listed rows,
// then per pass composite, form gC = C - ref and gf in registers, and replay
// backward into the tile's (K, 9) partial.
__device__ __forceinline__ void l2_tile(const float* __restrict__ table,
                                        const int* __restrict__ ids,
                                        const int* __restrict__ count,
                                        const float* __restrict__ ref,
                                        float* __restrict__ color,
                                        float* __restrict__ partial,
                                        const RenderArgs& p, int sub_h) {
  extern __shared__ float smem[];
  float* rows = smem;                               // K x kFields
  float* red = smem + (size_t)p.k_cap * kFields;    // warps x kChunk x 9
  const int n = count[blockIdx.x];
  gather_rows(table, ids, n, p, rows);
  __syncthreads();

  const size_t wp = (size_t)p.n_tiles_x * p.tile_w;
  const size_t plane = (size_t)p.n_tiles_y * p.tile_h * wp;
  for (int pass = 0; pass < p.tile_h; pass += sub_h) {
    // ---- forward composite ----------------------------------------------
    PixelCoords c = pixel_coords(p);
    c.y0 += pass;
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

    // ---- cotangent gC = C - ref, gf = sum_ch gC * C ----------------------
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

    // ---- backward replay, per-slot moments -------------------------------
    replay_moments(rows, n, c, p, gc_r, gc_g, gc_b, gf, ga, T, red,
                   partial + (size_t)blockIdx.x * p.k_cap * kMoments);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
l2_resident_kernel(const float* __restrict__ table,
                   const int* __restrict__ ids, const int* __restrict__ count,
                   const float* __restrict__ ref, float* __restrict__ color,
                   float* __restrict__ partial, RenderArgs p, int sub_h) {
  l2_tile(table, ids, count, ref, color, partial, p, sub_h);
}

__global__ void __launch_bounds__(kMaxThreads)
l2_window_kernel(const float* __restrict__ table,
                 const int* __restrict__ ids, const int* __restrict__ count,
                 const float* __restrict__ ref, float* __restrict__ color,
                 float* __restrict__ partial, RenderArgs p, int sub_h) {
  l2_tile(table, ids, count, ref, color, partial, p, sub_h);
}

__global__ void __launch_bounds__(kMaxThreads)
bwd_resident_kernel(const float* __restrict__ table,
                    const int* __restrict__ ids,
                    const int* __restrict__ count,
                    const float* __restrict__ fin,
                    const float* __restrict__ gc,
                    const float* __restrict__ cin,
                    const float* __restrict__ tin,
                    float* __restrict__ partial, RenderArgs p, int sub_h) {
  extern __shared__ float smem[];
  float* rows = smem;                               // K x kFields
  float* red = smem + (size_t)p.k_cap * kFields;    // warps x kChunk x 9
  const int n = count[blockIdx.x];
  gather_rows(table, ids, n, p, rows);
  __syncthreads();

  for (int pass = 0; pass < p.tile_h; pass += sub_h) {
    PixelCoords c = pixel_coords(p);
    c.y0 += pass;
    float gc_r[kRows], gc_g[kRows], gc_b[kRows], gf[kRows], ga[kRows],
        T[kRows];
    walk::load_cotangent(fin, gc, cin, tin, p, c.xx, c.y0, gc_r, gc_g, gc_b,
                         gf, ga, T);
    replay_moments(rows, n, c, p, gc_r, gc_g, gc_b, gf, ga, T, red,
                   partial + (size_t)blockIdx.x * p.k_cap * kMoments);
  }
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

// Kernel 12's splat-axis sum: as segment_sum_kernel, but splat i takes its
// partials only from the tiles t with bases[t] <= i < bases[t] + win, in
// tile order; an id listed past its tile's window (an escaped pair) adds
// nothing.
__global__ void window_sum_kernel(const int* __restrict__ ids,
                                  const int* __restrict__ count,
                                  const int* __restrict__ bases,
                                  const float* __restrict__ partial,
                                  float* __restrict__ grads16, int n_tiles,
                                  int k_cap, int win, int n_splats,
                                  int n_pad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_splats) return;
  float acc[kMoments];
#pragma unroll
  for (int f = 0; f < kMoments; ++f) acc[f] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const int base = bases[t];
    if (i < base || i >= base + win) continue;
    add_run_moments(ids + (size_t)t * k_cap, count[t],
                    partial + (size_t)t * k_cap * kMoments, i, acc);
  }
#pragma unroll
  for (int f = 0; f < kMoments; ++f) grads16[(size_t)f * n_pad + i] = acc[f];
}

// Launch constants of the resident kernels: the walk's passes for the tile
// shape (tile_walk.cuh) with the whole K-row list as one chunk, so a.p.k_cap
// is K. Returns the threads per block, or 0 for a shape the kernels do not
// take.
int resident_args(int height, int width, int tile_h, int tile_w,
                  int n_tiles_x, int n_tiles_y, int k_cap, float cutoff_sq,
                  float min_throughput, int use_exp_approx,
                  walk::WalkArgs* a) {
  return walk::walk_args(height, width, tile_h, tile_w, n_tiles_x, n_tiles_y,
                         k_cap, 1, 0, k_cap, cutoff_sq, min_throughput,
                         use_exp_approx, a);
}

// Launches kernel 1 or 12 (the tile work) on a partial zeroed by the caller;
// the K staged rows and the reduction rounds are the backward walk's shared
// memory with kc = K.
int launch_l2_tiles(bool window, const float* table, const int* ids,
                    const int* count, const float* ref, float* color,
                    float* partial, const walk::WalkArgs& a, int threads,
                    cudaStream_t stream) {
  const size_t smem = walk::bwd_smem_bytes(a.kc, threads);
  auto kernel = window ? l2_window_kernel : l2_resident_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.p.n_tiles_x * a.p.n_tiles_y, threads, smem, stream>>>(
      table, ids, count, ref, color, partial, a.p, a.sub_h);
  return (int)cudaGetLastError();
}

}  // namespace gs2d

using namespace gs2d;

extern "C" {

// Pixel rows per thread and threads per block (one pass); the wrapper
// checks shapes against these before launching.
int gs2d_rows_per_thread() { return kRows; }
int gs2d_max_threads() { return kMaxThreads; }

// Dynamic shared memory a block may use on the current device (the
// opt-in limit), or -1 if it cannot be read.
int gs2d_max_smem_per_block() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

const char* gs2d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Kernel 1. ref and color are (3, Hp, Wp); partial is (n_tiles, K, 9),
// zeroed by the caller; grads16 is (16, n_pad), zeroed by the caller (rows
// 9..15 and columns >= n_splats are left as they are). Returns
// cudaGetLastError().
int gs2d_l2_resident(const float* table, const int* ids, const int* count,
                     const float* ref, float* color, float* partial,
                     float* grads16, int n_splats, int n_pad, int height,
                     int width, int tile_h, int tile_w, int n_tiles_x,
                     int n_tiles_y, int k_cap, float cutoff_sq,
                     float min_throughput, int use_exp_approx,
                     void* stream) {
  walk::WalkArgs a;
  const int threads =
      resident_args(height, width, tile_h, tile_w, n_tiles_x, n_tiles_y,
                    k_cap, cutoff_sq, min_throughput, use_exp_approx, &a);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_l2_tiles(false, table, ids, count, ref, color,
                                  partial, a, threads, s);
  if (err != 0) return err;
  return launch_segment_sum(ids, count, partial, grads16,
                            n_tiles_x * n_tiles_y, k_cap, n_splats, n_pad, s);
}

// Kernel 12: kernel 1's arguments plus bases (n_tiles,), each tile's window
// start, and win, the window width. Returns cudaGetLastError().
int gs2d_l2_window(const float* table, const int* ids, const int* count,
                   const int* bases, const float* ref, float* color,
                   float* partial, float* grads16, int n_splats, int n_pad,
                   int win, int height, int width, int tile_h, int tile_w,
                   int n_tiles_x, int n_tiles_y, int k_cap, float cutoff_sq,
                   float min_throughput, int use_exp_approx, void* stream) {
  walk::WalkArgs a;
  const int threads =
      resident_args(height, width, tile_h, tile_w, n_tiles_x, n_tiles_y,
                    k_cap, cutoff_sq, min_throughput, use_exp_approx, &a);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_l2_tiles(true, table, ids, count, ref, color,
                                  partial, a, threads, s);
  if (err != 0) return err;
  window_sum_kernel<<<(n_splats + 127) / 128, 128, 0, s>>>(
      ids, count, bases, partial, grads16, n_tiles_x * n_tiles_y, k_cap, win,
      n_splats, n_pad);
  return (int)cudaGetLastError();
}

// Kernel 3 and the segment sum. fin, gc and cin are (3, Hp, Wp), tin
// (Hp, Wp); partial is (n_tiles, K, 9) and grads16 (16, n_pad), both zeroed
// by the caller. Returns cudaGetLastError().
int gs2d_bwd_resident(const float* table, const int* ids, const int* count,
                      const float* fin, const float* gc, const float* cin,
                      const float* tin, float* partial, float* grads16,
                      int n_splats, int n_pad, int height, int width,
                      int tile_h, int tile_w, int n_tiles_x, int n_tiles_y,
                      int k_cap, float cutoff_sq, float min_throughput,
                      int use_exp_approx, void* stream) {
  walk::WalkArgs a;
  const int threads =
      resident_args(height, width, tile_h, tile_w, n_tiles_x, n_tiles_y,
                    k_cap, cutoff_sq, min_throughput, use_exp_approx, &a);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = n_tiles_x * n_tiles_y;
  const size_t smem = walk::bwd_smem_bytes(k_cap, threads);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  bwd_resident_kernel<<<n_tiles, threads, smem, s>>>(
      table, ids, count, fin, gc, cin, tin, partial, a.p, a.sub_h);
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
  walk::WalkArgs a;
  const int threads =
      resident_args(height, width, tile_h, tile_w, n_tiles_x, n_tiles_y,
                    k_cap, cutoff_sq, min_throughput, use_exp_approx, &a);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)k_cap * kFields;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fwd_resident_kernel<<<n_tiles_x * n_tiles_y, threads, smem,
                        (cudaStream_t)stream>>>(table, ids, count, color,
                                                trans, a.p, a.sub_h);
  return (int)cudaGetLastError();
}

}  // extern "C"
