// Dense-layout rasterizer kernels for Hopper (sm_90a), bound with ctypes
// through a plain C interface (gs2d_tpu_torch/ops/_build.py).
//
// The dense binning (gs2d_tpu_torch/ops/tiles.py::bin_splats) pregathers
// each tile's index-ordered list into (n_tiles, K, 16) tile_params: tile t
// owns rows [t * K, t * K + count[t]), padded slots hold benign rows. Each
// TPU kernel pair below differs only in how the TPU fits a long list into
// SMEM (the chunked member takes K > 256 in 256-row chunks over a grid
// axis, with saturation exits); here one kernel serves both members, so it
// takes any K.
//
// Kernels 4/5, gs2d_l2_dense: the fused L2 train step. Replaces
//   gs2d_tpu/ops/render_pallas.py::_l2_fused_kernel (pallas_call at :958)
//   and ::_l2_chunked_kernel (:1140). The warp patches of kernels 1 and 12
//   (patch_walk.cuh: one warp per 8 x 32 patch, 4 a block, an exact
//   per-warp cull and saturation exit) over the tile_params (DenseRun):
//   composite, form the cotangent gC = C - ref in registers, replay, one
//   9-moment partial per (tile, slot, pass, warp), an exact zero where the
//   walk skips, then kernel 1's patch sum.
// Kernels 6/7, gs2d_fwd_dense: the forward composite (C, T). Replaces
//   render_pallas.py::_forward_kernel (:597) and ::_fwd_chunked_kernel
//   (:576). Kernel 2's warp patches over the tile_params (patch_walk.cuh's
//   fwd_patch over DenseRun: the exact per-warp cull, the per-warp
//   saturation exit, T 0 on padding as the chunk walk starts it).
// Kernels 8/9, gs2d_bwd_dense: the backward replay from a carry-in prefix
//   (C_in, T_in) under any upstream cotangent. Replaces
//   render_pallas.py::_backward_kernel (:728) and ::_bwd_chunked_kernel
//   (:681). Kernel 3's warp patches over the tile_params (patch_walk.cuh's
//   replay_patch over DenseRun: an exact per-warp cull, its own saturation
//   exit on the replayed T), one 9-moment partial per (tile, slot, pass,
//   warp), then the patch sum.
//
// gs2d_fwd_chunk and gs2d_bwd_chunk, references only: the chunk walk of
// tile_walk.cuh (one block per tile, chunks of kc <= 256 rows in shared
// memory, register carries, the exits bitwise-neutral), the designs that
// kernels 6/7 and 8/9 had before they moved onto warp patches, kept
// unchanged. They port no TPU kernel and no fit path reaches them: the
// forward, then gC, then the backward reference are the in-call reference
// (chip_smoke.py::chain) of the warp-patch kernels 1-12, which equal them
// bit for bit (on finite inputs; where a splat or a carry is not finite the
// patch walk gives the NaNs of the chunk walk without its exits).
//
// No G-cache: the TPU's (K, 32, 128) cache of the masked Gaussian term does
// not fit a block, so the backward re-derives coverage (the alpha_cache=False
// form). The per-(pixel, pair) arithmetic and the moment sums' order are the
// resident kernels' (splat_terms.cuh, the same warp tree and warp order), so
// a dense fit repeats the resident fit's numbers. What bounds them on the
// card: about 58 f32 operations per (pixel, pair) forward and 81 backward
// (counted in chip_smoke.py) against 64 bytes of row per pair, so they are
// compute and latency bound. An eager fit step spends most of its time on
// the host between launches; a scanned step, one CUDA graph replayed
// (train/graphs.py), keeps the card busy for all but about a tenth of it
// (PERF.md section 5).

#include <cuda_runtime.h>

#include "patch_walk.cuh"
#include "tile_walk.cuh"

namespace gs2d {
namespace dense {

using walk::kRows;
using walk::WalkArgs;

// The forward reference (gs2d_fwd_chunk): the chunk walk kernels 6/7 had
// before their warp patches, unchanged.
__global__ void __launch_bounds__(walk::kMaxThreads)
fwd_chunk_kernel(const float* __restrict__ rows, const int* __restrict__ count,
                 float* __restrict__ color, float* __restrict__ trans,
                 WalkArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // kc x kFields
  const RenderArgs& p = a.p;
  const walk::TileWalk w = walk::tile_walk(count, a);
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
bwd_chunk_kernel(const float* __restrict__ rows, const int* __restrict__ count,
                 const float* __restrict__ fin, const float* __restrict__ gc,
                 const float* __restrict__ cin, const float* __restrict__ tin,
                 float* __restrict__ partial, WalkArgs a) {
  extern __shared__ float4 smem4[];
  float* srows = reinterpret_cast<float*>(smem4);     // kc x kFields
  float* red = srows + (size_t)a.kc * kFields;        // warps x kGroup x 9
  const walk::TileWalk w = walk::tile_walk(count, a);
  for (int pass = 0; pass < a.p.tile_h; pass += a.sub_h) {
    const int y0 = w.y0 + pass;
    float gc_r[kRows], gc_g[kRows], gc_b[kRows], gf[kRows], ga[kRows],
        T[kRows];
    walk::load_cotangent(fin, gc, cin, tin, a.p, w.xx, y0, gc_r, gc_g, gc_b,
                         gf, ga, T);
    walk::bwd_pass(rows, w, y0, a, srows, red, gc_r, gc_g, gc_b, gf, ga, T,
                   partial);
  }
}

// Kernels 4/5 on warp patches: partial is (n_tiles, K, n_pass, warps per
// pass, 9), every entry of a slot below count[t] written once; walked, when
// set, gets (survivors, survivors walked) per patch.
__global__ void __launch_bounds__(patch::kPatchWarps * 32)
l2_dense_kernel(const float* __restrict__ rows, const int* __restrict__ count,
                const float* __restrict__ ref, float* __restrict__ color,
                float* __restrict__ partial, int* __restrict__ walked,
                RenderArgs p, patch::PatchGrid g) {
  const patch::Patch c = patch::patch_of(p, g);
  if (!c.active) return;
  patch::l2_patch(patch::DenseRun{rows, p.k_cap}, count[c.tile], c, p, g,
                  ref, color, partial, walked);
}

// Kernels 6/7 on warp patches (kernel 2's forward over DenseRun): color is
// (3, Hp, Wp), trans (Hp, Wp); walked as in l2_dense_kernel.
__global__ void __launch_bounds__(patch::kPatchWarps * 32)
fwd_dense_kernel(const float* __restrict__ rows, const int* __restrict__ count,
                 float* __restrict__ color, float* __restrict__ trans,
                 int* __restrict__ walked, RenderArgs p, patch::PatchGrid g) {
  const patch::Patch c = patch::patch_of(p, g);
  if (!c.active) return;
  patch::fwd_patch_out(patch::DenseRun{rows, p.k_cap}, count[c.tile], c, p,
                       g, color, trans, walked);
}

// Kernels 8/9 on warp patches: partial and walked as in l2_dense_kernel.
__global__ void __launch_bounds__(patch::kPatchWarps * 32)
bwd_dense_kernel(const float* __restrict__ rows, const int* __restrict__ count,
                 const float* __restrict__ fin, const float* __restrict__ gc,
                 const float* __restrict__ cin, const float* __restrict__ tin,
                 float* __restrict__ partial, int* __restrict__ walked,
                 RenderArgs p, patch::PatchGrid g) {
  const patch::Patch c = patch::patch_of(p, g);
  if (!c.active) return;
  patch::replay_patch(patch::DenseRun{rows, p.k_cap}, count[c.tile], c, p, g,
                      fin, gc, cin, tin, partial, walked);
}

// Launch constants of a dense walk over (n_tiles, k_cap, 16) rows in
// chunks of kc; returns the threads per block, or 0 for a shape the kernels
// do not take.
int dense_args(int height, int width, int tile_h, int tile_w, int n_tiles_x,
               int n_tiles_y, int k_cap, int kc, int sat_walk,
               float cutoff_sq, float min_throughput, int use_exp_approx,
               WalkArgs* a) {
  if (k_cap <= 0 || kc <= 0) return 0;
  return walk::walk_args(height, width, tile_h, tile_w, n_tiles_x, n_tiles_y,
                         kc, (k_cap + kc - 1) / kc, sat_walk, k_cap,
                         cutoff_sq, min_throughput, use_exp_approx, a);
}

}  // namespace dense
}  // namespace gs2d

using gs2d::walk::WalkArgs;

extern "C" {

// Kernels 6/7. rows is (n_tiles, K, 16), count (n_tiles,); color is
// (3, Hp, Wp), trans (Hp, Wp); walked is null or (patches, 2). A band of
// tile rows is n_tiles_y rows from image row row_off, its planes
// (3, n_tiles_y * tile_h, Wp); 0 for the whole image. Returns
// cudaGetLastError().
int gs2d_fwd_dense(const float* rows, const int* count, float* color,
                   float* trans, int* walked, int height, int width,
                   int tile_h, int tile_w, int n_tiles_x, int n_tiles_y,
                   int row_off, int k_cap, float cutoff_sq,
                   float min_throughput, int use_exp_approx, void* stream) {
  WalkArgs a;
  if (gs2d::patch::patch_args(height, width, tile_h, tile_w, n_tiles_x,
                              n_tiles_y, k_cap, cutoff_sq, min_throughput,
                              use_exp_approx, &a, row_off) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const gs2d::patch::PatchGrid g = gs2d::patch::patch_grid(a);
  gs2d::dense::fwd_dense_kernel<<<gs2d::patch::patch_blocks(a, g),
                                  gs2d::patch::kPatchWarps * 32, 0,
                                  (cudaStream_t)stream>>>(rows, count, color,
                                                          trans, walked, a.p,
                                                          g);
  return (int)cudaGetLastError();
}

// The forward reference (fwd_chunk_kernel), with the arguments kernels
// 6/7 took before their warp patches: color (3, Hp, Wp), trans (Hp, Wp),
// chunks of kc rows. Returns cudaGetLastError().
int gs2d_fwd_chunk(const float* rows, const int* count, float* color,
                   float* trans, int height, int width, int tile_h,
                   int tile_w, int n_tiles_x, int n_tiles_y, int k_cap,
                   int kc, int sat_walk, float cutoff_sq,
                   float min_throughput, int use_exp_approx, void* stream) {
  WalkArgs a;
  const int threads = gs2d::dense::dense_args(
      height, width, tile_h, tile_w, n_tiles_x, n_tiles_y, k_cap, kc,
      sat_walk, cutoff_sq, min_throughput, use_exp_approx, &a);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)kc * gs2d::kFields;
  cudaError_t err = cudaFuncSetAttribute(
      gs2d::dense::fwd_chunk_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gs2d::dense::fwd_chunk_kernel<<<n_tiles_x * n_tiles_y, threads, smem,
                                  (cudaStream_t)stream>>>(rows, count, color,
                                                          trans, a);
  return (int)cudaGetLastError();
}

// The chunk reference (bwd_chunk_kernel) and the segment sum. ids is
// (n_tiles, K); fin, gc and cin are (3, Hp, Wp), tin (Hp, Wp); partial is
// (n_tiles, K, 9), zeroed by the caller; grads9 is (9, n_splats). Returns
// cudaGetLastError().
int gs2d_bwd_chunk(const float* rows, const int* ids, const int* count,
                   const float* fin, const float* gc, const float* cin,
                   const float* tin, float* partial, float* grads9,
                   int n_splats, int height, int width, int tile_h,
                   int tile_w, int n_tiles_x, int n_tiles_y, int k_cap,
                   int kc, int sat_walk, float cutoff_sq,
                   float min_throughput, int use_exp_approx, void* stream) {
  WalkArgs a;
  const int threads = gs2d::dense::dense_args(
      height, width, tile_h, tile_w, n_tiles_x, n_tiles_y, k_cap, kc,
      sat_walk, cutoff_sq, min_throughput, use_exp_approx, &a);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = n_tiles_x * n_tiles_y;
  const size_t smem = gs2d::walk::bwd_smem_bytes(kc, threads);
  cudaError_t err = cudaFuncSetAttribute(
      gs2d::dense::bwd_chunk_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  gs2d::dense::bwd_chunk_kernel<<<n_tiles, threads, smem, s>>>(
      rows, count, fin, gc, cin, tin, partial, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return gs2d::launch_segment_sum(ids, count, partial, grads9, n_tiles, k_cap,
                                  n_splats, n_splats, s);
}

// Kernels 8/9 and the patch sum. ids is (n_tiles, K); fin, gc and cin are
// (3, Hp, Wp), tin (Hp, Wp); partial is (n_tiles, K, patches per tile, 9)
// scratch, read only where the patch kernel wrote it; grads9 (9, n_splats)
// is written whole; walked is null or (patches, 2); the band as in
// gs2d_fwd_dense. Returns cudaGetLastError().
int gs2d_bwd_dense(const float* rows, const int* ids, const int* count,
                   const float* fin, const float* gc, const float* cin,
                   const float* tin, float* partial, float* grads9,
                   int* walked, int n_splats, int height, int width,
                   int tile_h, int tile_w, int n_tiles_x, int n_tiles_y,
                   int row_off, int k_cap, float cutoff_sq,
                   float min_throughput, int use_exp_approx, void* stream) {
  WalkArgs a;
  if (gs2d::patch::patch_args(height, width, tile_h, tile_w, n_tiles_x,
                              n_tiles_y, k_cap, cutoff_sq, min_throughput,
                              use_exp_approx, &a, row_off) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const gs2d::patch::PatchGrid g = gs2d::patch::patch_grid(a);
  cudaStream_t s = (cudaStream_t)stream;
  gs2d::dense::bwd_dense_kernel<<<gs2d::patch::patch_blocks(a, g),
                                  gs2d::patch::kPatchWarps * 32, 0, s>>>(
      rows, count, fin, gc, cin, tin, partial, walked, a.p, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return gs2d::patch::launch_patch_sum(ids, count, nullptr, 0, partial,
                                       grads9, n_tiles_x * n_tiles_y, k_cap,
                                       g, n_splats, n_splats, s);
}

// Kernels 4/5 and the patch sum. ref and color are (3, Hp, Wp); partial is
// (n_tiles, K, patches per tile, 9) scratch (patches as in gs2d_l2_resident),
// read only where the patch kernel wrote it; grads9 (9, n_splats) is
// written whole; walked is null or (patches, 2); the band as in
// gs2d_fwd_dense. Returns cudaGetLastError().
int gs2d_l2_dense(const float* rows, const int* ids, const int* count,
                  const float* ref, float* color, float* partial,
                  float* grads9, int* walked, int n_splats, int height,
                  int width, int tile_h, int tile_w, int n_tiles_x,
                  int n_tiles_y, int row_off, int k_cap, float cutoff_sq,
                  float min_throughput, int use_exp_approx, void* stream) {
  WalkArgs a;
  if (gs2d::patch::patch_args(height, width, tile_h, tile_w, n_tiles_x,
                              n_tiles_y, k_cap, cutoff_sq, min_throughput,
                              use_exp_approx, &a, row_off) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const gs2d::patch::PatchGrid g = gs2d::patch::patch_grid(a);
  cudaStream_t s = (cudaStream_t)stream;
  gs2d::dense::l2_dense_kernel<<<gs2d::patch::patch_blocks(a, g),
                                 gs2d::patch::kPatchWarps * 32, 0, s>>>(
      rows, count, ref, color, partial, walked, a.p, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return gs2d::patch::launch_patch_sum(ids, count, nullptr, 0, partial,
                                       grads9, n_tiles_x * n_tiles_y, k_cap,
                                       g, n_splats, n_splats, s);
}

}  // extern "C"
