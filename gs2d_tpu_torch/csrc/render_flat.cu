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
// Design: the chunk walk of tile_walk.cuh. The TPU grid is (tile, chunk)
// with the chunk axis sequential because its carry lives in the output
// block; here one block owns one tile and walks its chunks in order.
//
// What bounds them on the card: about 58 f32 operations per (pixel, pair)
// forward and 81 backward (counted in chip_smoke.py), against 64 bytes of
// row per pair, so both are compute and latency bound. Known shortfall: one
// block per tile gives 70 blocks on 132 SMs at 535x426 with 32x128 tiles;
// splitting tiles is a later performance item (ROADMAP.md queue 1b).

#include <cuda_runtime.h>

#include "tile_walk.cuh"

namespace gs2d {
namespace flat {

using walk::kRows;
using walk::WalkArgs;

__global__ void __launch_bounds__(walk::kMaxThreads)
fwd_flat_kernel(const float* __restrict__ rows, const int* __restrict__ start,
                const int* __restrict__ count, float* __restrict__ color,
                float* __restrict__ trans, WalkArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // kc x kFields
  const RenderArgs& p = a.p;
  const walk::TileWalk w = walk::tile_walk(start, count, a);
  const size_t wp = (size_t)p.n_tiles_x * p.tile_w;
  const size_t plane = (size_t)p.n_tiles_y * p.tile_h * wp;

  for (int pass = 0; pass < p.tile_h; pass += a.sub_h) {
    const int y0 = w.y0 + pass;
    float cr[kRows], cg[kRows], cb[kRows], T[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      cr[r] = cg[r] = cb[r] = 0.0f;
      T[r] = (y0 + r < p.height && w.col_in) ? 1.0f : 0.0f;
    }
    walk::fwd_pass(rows, w, y0, a, smem, cr, cg, cb, T);
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

__global__ void __launch_bounds__(walk::kMaxThreads)
bwd_flat_kernel(const float* __restrict__ rows, const int* __restrict__ start,
                const int* __restrict__ count, const float* __restrict__ fin,
                const float* __restrict__ gc, const float* __restrict__ cin,
                const float* __restrict__ tin, float* __restrict__ moments,
                WalkArgs a) {
  extern __shared__ float4 smem4[];
  float* srows = reinterpret_cast<float*>(smem4);     // kc x kFields
  float* red = srows + (size_t)a.kc * kFields;        // warps x kGroup x 9
  const walk::TileWalk w = walk::tile_walk(start, count, a);
  for (int pass = 0; pass < a.p.tile_h; pass += a.sub_h) {
    const int y0 = w.y0 + pass;
    float gc_r[kRows], gc_g[kRows], gc_b[kRows], gf[kRows], ga[kRows],
        T[kRows];
    walk::load_cotangent(fin, gc, cin, tin, a.p, w.xx, y0, gc_r, gc_g, gc_b,
                         gf, ga, T);
    walk::bwd_pass(rows, w, y0, a, srows, red, gc_r, gc_g, gc_b, gf, ga, T,
                   moments);
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

}  // namespace flat
}  // namespace gs2d

using gs2d::walk::WalkArgs;

extern "C" {

// Kernel 10. rows is (M, 16), start/count (n_tiles,); color is
// (3, Hp, Wp), trans (Hp, Wp). Returns cudaGetLastError().
int gs2d_fwd_flat(const float* rows, const int* start, const int* count,
                  float* color, float* trans, int height, int width,
                  int tile_h, int tile_w, int n_tiles_x, int n_tiles_y,
                  int kc, int max_chunks, int sat_walk, float cutoff_sq,
                  float min_throughput, int use_exp_approx, void* stream) {
  WalkArgs a;
  const int threads = gs2d::walk::walk_args(
      height, width, tile_h, tile_w, n_tiles_x, n_tiles_y, kc, max_chunks,
      sat_walk, 0, cutoff_sq, min_throughput, use_exp_approx, &a);
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
  WalkArgs a;
  const int threads = gs2d::walk::walk_args(
      height, width, tile_h, tile_w, n_tiles_x, n_tiles_y, kc, max_chunks,
      sat_walk, 0, cutoff_sq, min_throughput, use_exp_approx, &a);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = n_tiles_x * n_tiles_y;
  const size_t smem = gs2d::walk::bwd_smem_bytes(kc, threads);
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
