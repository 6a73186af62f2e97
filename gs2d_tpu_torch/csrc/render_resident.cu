// Resident-table rasterizer kernels for Hopper (sm_90a), bound with ctypes
// through a plain C interface (gs2d_tpu_torch/ops/_build.py).
//
// Kernel 1, gs2d_l2_resident: the fused L2 train step.
//   Replaces gs2d_tpu/ops/render_pallas_resident.py::_l2_resident_kernel
//   (pallas_call at :231): composite front to back, form the cotangent
//   gC = C - ref in registers, replay backward with the (ga, T) carry
//   re-deriving coverage (the alpha_cache=False form: a K x 32 x 128 G-cache
//   does not fit on chip), and reduce nine z-moments per listed splat. In
//   place of the TPU kernel's one-hot MXU expansion it writes deterministic
//   per-slot partials that a second kernel adds onto the splat axis. No
//   atomics, so runs repeat bit for bit.
// Kernel 2, gs2d_fwd_resident: the forward composite (C, T).
//   Replaces render_pallas_resident.py::_fwd_resident_kernel (pallas_call
//   at :366).
// Kernel 3, gs2d_bwd_resident: the backward replay alone, from a carry-in
//   prefix (C_in, T_in) under any upstream cotangent gC read from a plane
//   (the VJP of the differentiable render, e.g. under the SSIM objective).
//   Replaces render_pallas_resident.py::_bwd_resident_kernel (pallas_call
//   at :451).
//
// Kernel 12, gs2d_l2_window: the L2 step with the window layout's
//   splat-axis sum. Replaces gs2d_tpu/ops/render_pallas_window.py::
//   _l2_window_kernel (pallas_call at :228), which expands the per-slot
//   gradient columns onto a per-tile window [base_t, base_t + W) of the
//   splat axis and drops ids past it (the escaped pairs, counted by the
//   wrapper). Kernel 1's patch kernel, then patch_sum_kernel with the
//   window: splat i adds its partials only from the tiles whose window
//   holds i, in tile order. At W = n_pad it is kernel 1 bit for bit.
//
// What bounds them on the card: about 58 f32 operations per live (pixel,
// slot) in the forward and 81 in the backward replay (scripts/roofline.py),
// against under 100 KB of table and ids, so all are compute and latency
// bound.
//
// Kernels 1, 2, 3 and 12 on warp patches (patch_walk.cuh, shared with the
// dense kernels 4/5 and 8/9 and the flat kernels 10 and 11). The
// one-block-per-tile design ran 21 blocks of 16 warps on 132 SMs at the
// default 268x213 workload and had every warp evaluate every listed splat
// at all 256 of its pixels, about 12x the live evaluations; kernel 3 also
// staged the K listed table rows in shared memory, which bounded K. Now
// each warp owns one 8 x 32 patch and walks only the slots of the tile's
// list (read through TableRun) whose splat covers one of its pixels, with a
// saturation exit, 4 patches a block: the default workload runs 84 blocks.
// One warp a block (336 blocks) ran kernel 2 slower and kernel 1 no faster
// (PERF.md). Kernel 1's replay culls again and walks the forward's
// survivors, its T following the forward's bit for bit; kernel 3 finds its
// own exit on its replayed T (kernel 11's replay). Kernels 1, 3 and 12 write
// one 9-moment partial per (tile, slot, pass, warp), the warp's lane tree
// as before, and an exact zero for every slot they did not walk;
// patch_sum_kernel adds them in the order of the one-block-per-tile sums
// (warps in index order, then passes in order, then tiles in order). So
// colour, T and the moments equal the one-block-per-tile chunk walk's (the
// dense kernels 6/7, then gC, then the chunk reference gs2d_bwd_chunk)
// bit for bit; where a splat or a carry is not finite, kernel 3 gives the
// NaNs of its old walk, which had no exits.

#include <cuda_runtime.h>

#include "patch_walk.cuh"
#include "splat_terms.cuh"
#include "tile_walk.cuh"

namespace gs2d {

constexpr int kRows = walk::kRows;  // pixel rows of a patch
constexpr int kMaxThreads = walk::kMaxThreads;

// ---- Kernels 1, 2, 3 and 12: warp patches (patch_walk.cuh) ----------------

using patch::kPatchWarps;
using patch::Patch;
using patch::PatchGrid;
using patch::TableRun;

// Kernel 1 (and kernel 12) on warp patches. partial is (n_tiles, K,
// n_pass, warps per pass, 9); every entry of a slot below count[t] is
// written once. walked, when set, gets (survivors, survivors walked) per
// patch.
__global__ void __launch_bounds__(kPatchWarps * 32)
l2_resident_kernel(const float* __restrict__ table,
                   const int* __restrict__ ids, const int* __restrict__ count,
                   const float* __restrict__ ref, float* __restrict__ color,
                   float* __restrict__ partial, int* __restrict__ walked,
                   RenderArgs p, PatchGrid g) {
  const Patch c = patch::patch_of(p, g);
  if (!c.active) return;
  patch::l2_patch(TableRun{table, ids, p.k_cap}, count[c.tile], c, p, g, ref,
                  color, partial, walked);
}

// Kernel 3 on warp patches: the replay from the carry-in planes under the
// cotangent plane (patch_walk.cuh's replay_patch over TableRun), partial
// and walked as in kernel 1.
__global__ void __launch_bounds__(kPatchWarps * 32)
bwd_resident_kernel(const float* __restrict__ table,
                    const int* __restrict__ ids,
                    const int* __restrict__ count,
                    const float* __restrict__ fin,
                    const float* __restrict__ gc,
                    const float* __restrict__ cin,
                    const float* __restrict__ tin,
                    float* __restrict__ partial, int* __restrict__ walked,
                    RenderArgs p, PatchGrid g) {
  const Patch c = patch::patch_of(p, g);
  if (!c.active) return;
  patch::replay_patch(TableRun{table, ids, p.k_cap}, count[c.tile], c, p, g,
                      fin, gc, cin, tin, partial, walked);
}

// Kernel 2 on warp patches: kernel 1's forward, written out as (C, T).
__global__ void __launch_bounds__(kPatchWarps * 32)
fwd_resident_kernel(const float* __restrict__ table,
                    const int* __restrict__ ids,
                    const int* __restrict__ count, float* __restrict__ color,
                    float* __restrict__ trans, int* __restrict__ walked,
                    RenderArgs p, PatchGrid g) {
  const Patch c = patch::patch_of(p, g);
  if (!c.active) return;
  patch::fwd_patch_out(TableRun{table, ids, p.k_cap}, count[c.tile], c, p, g,
                       color, trans, walked);
}

// Splat-axis expansion of (n_tiles, K, 9) per-(tile, slot) partials (the
// chunk reference of render_dense.cu and kernel 13): grads16[f][i] = sum
// over tiles, in tile order, of the partial at the slot where splat i
// appears. Tile lists are ascending in splat id (index order), so each
// lookup is a binary search.
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

// The splat-axis sum of the per-(tile, slot, pass, warp) partials of
// kernels 1, 3, 4/5, 8/9 and 12, one thread per (splat, moment): for each
// tile in order that lists splat i, the slot's sum is formed as the
// one-block-per-tile kernels formed it (per pass, acc = 0 and the warps
// added in index order; out = 0 and the passes added in order) and added to
// the splat's sum. With bases set (kernel 12), only the tiles t with
// bases[t] <= i < bases[t] + win add: an id listed past its tile's window
// (an escaped pair) adds nothing.
__global__ void patch_sum_kernel(const int* __restrict__ ids,
                                 const int* __restrict__ count,
                                 const int* __restrict__ bases, int win,
                                 const float* __restrict__ partial,
                                 float* __restrict__ grads16, int n_tiles,
                                 int k_cap, int n_pass, int wpp, int n_splats,
                                 int n_pad) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_splats * kMoments) return;
  const int i = g / kMoments, f = g % kMoments;
  const size_t slot_stride = (size_t)n_pass * wpp * kMoments;
  float acc = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    if (bases != nullptr && (i < bases[t] || i >= bases[t] + win)) continue;
    const int slot = find_in_run(ids + (size_t)t * k_cap, count[t], i);
    if (slot < 0) continue;
    const float* src = partial + ((size_t)t * k_cap + slot) * slot_stride + f;
    float out = 0.0f;
    for (int ps = 0; ps < n_pass; ++ps) {
      float a = 0.0f;
      for (int w = 0; w < wpp; ++w) a += src[(size_t)(ps * wpp + w) * kMoments];
      out += a;
    }
    acc += out;
  }
  grads16[(size_t)f * n_pad + i] = acc;
}

int patch::launch_patch_sum(const int* ids, const int* count,
                            const int* bases, int win, const float* partial,
                            float* grads, int n_tiles, int k_cap,
                            const PatchGrid& g, int n_splats, int n_pad,
                            cudaStream_t stream) {
  const int threads = n_splats * kMoments;
  patch_sum_kernel<<<(threads + 127) / 128, 128, 0, stream>>>(
      ids, count, bases, win, partial, grads, n_tiles, k_cap, g.n_pass,
      g.ngrp * g.ncg, n_splats, n_pad);
  return (int)cudaGetLastError();
}

// Kernel 1's patch kernel, then the patch sum (over the window when bases
// is set: kernel 12). Returns a cudaError_t.
int l2_patches(const float* table, const int* ids, const int* count,
               const int* bases, int win, const float* ref, float* color,
               float* partial, float* grads16, int* walked, int n_splats,
               int n_pad, int height, int width, int tile_h, int tile_w,
               int n_tiles_x, int n_tiles_y, int row_off, int k_cap,
               float cutoff_sq, float min_throughput, int use_exp_approx,
               cudaStream_t stream) {
  walk::WalkArgs a;
  if (patch::patch_args(height, width, tile_h, tile_w, n_tiles_x,
                        n_tiles_y, k_cap, cutoff_sq, min_throughput,
                        use_exp_approx, &a, row_off) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const PatchGrid g = patch::patch_grid(a);
  l2_resident_kernel<<<patch::patch_blocks(a, g), kPatchWarps * 32, 0,
                       stream>>>(table, ids, count, ref, color, partial,
                                 walked, a.p, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return patch::launch_patch_sum(ids, count, bases, win, partial, grads16,
                                 n_tiles_x * n_tiles_y, k_cap, g, n_splats,
                                 n_pad, stream);
}

}  // namespace gs2d

using namespace gs2d;

extern "C" {

// Pixel rows of a patch and threads of a one-block-per-tile pass (which
// set the pass height); the wrapper checks shapes against these before
// launching.
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

// Kernel 1. ref and color are (3, Hp, Wp); partial is (n_tiles, K, patches
// per tile, 9), patch (pass, warp) at pass * warps per pass + warp, which is
// the patch's 8-row group * (tile_w / 32) + its column group: every entry
// the sum reads is written by the kernel; grads16 is (16, n_pad), zeroed by
// the caller (rows 9..15 and columns >= n_splats are left as they are);
// walked is null or (patches, 2). A band of tile rows is n_tiles_y rows
// from image row row_off, its planes (3, n_tiles_y * tile_h, Wp); 0 for the
// whole image. Returns cudaGetLastError().
int gs2d_l2_resident(const float* table, const int* ids, const int* count,
                     const float* ref, float* color, float* partial,
                     float* grads16, int* walked, int n_splats, int n_pad,
                     int height, int width, int tile_h, int tile_w,
                     int n_tiles_x, int n_tiles_y, int row_off, int k_cap,
                     float cutoff_sq, float min_throughput,
                     int use_exp_approx, void* stream) {
  return l2_patches(table, ids, count, nullptr, 0, ref, color, partial,
                    grads16, walked, n_splats, n_pad, height, width, tile_h,
                    tile_w, n_tiles_x, n_tiles_y, row_off, k_cap, cutoff_sq,
                    min_throughput, use_exp_approx, (cudaStream_t)stream);
}

// Kernel 12: kernel 1's arguments plus bases (n_tiles,), each tile's
// window start, and win, the window width. Returns cudaGetLastError().
int gs2d_l2_window(const float* table, const int* ids, const int* count,
                   const int* bases, const float* ref, float* color,
                   float* partial, float* grads16, int* walked, int n_splats,
                   int n_pad, int win, int height, int width, int tile_h,
                   int tile_w, int n_tiles_x, int n_tiles_y, int k_cap,
                   float cutoff_sq, float min_throughput, int use_exp_approx,
                   void* stream) {
  return l2_patches(table, ids, count, bases, win, ref, color, partial,
                    grads16, walked, n_splats, n_pad, height, width, tile_h,
                    tile_w, n_tiles_x, n_tiles_y, 0, k_cap, cutoff_sq,
                    min_throughput, use_exp_approx, (cudaStream_t)stream);
}

// Kernel 3 and the patch sum. fin, gc and cin are (3, Hp, Wp), tin
// (Hp, Wp); partial, grads16, walked and the band (n_tiles_y, row_off) as
// in gs2d_l2_resident. Returns cudaGetLastError().
int gs2d_bwd_resident(const float* table, const int* ids, const int* count,
                      const float* fin, const float* gc, const float* cin,
                      const float* tin, float* partial, float* grads16,
                      int* walked, int n_splats, int n_pad, int height,
                      int width, int tile_h, int tile_w, int n_tiles_x,
                      int n_tiles_y, int row_off, int k_cap,
                      float cutoff_sq, float min_throughput,
                      int use_exp_approx, void* stream) {
  walk::WalkArgs a;
  if (patch::patch_args(height, width, tile_h, tile_w, n_tiles_x,
                        n_tiles_y, k_cap, cutoff_sq, min_throughput,
                        use_exp_approx, &a, row_off) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const PatchGrid g = patch::patch_grid(a);
  cudaStream_t s = (cudaStream_t)stream;
  bwd_resident_kernel<<<patch::patch_blocks(a, g), kPatchWarps * 32, 0, s>>>(
      table, ids, count, fin, gc, cin, tin, partial, walked, a.p, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return patch::launch_patch_sum(ids, count, nullptr, 0, partial, grads16,
                                 n_tiles_x * n_tiles_y, k_cap, g, n_splats,
                                 n_pad, s);
}

// Kernel 2. color is (3, Hp, Wp), trans (Hp, Wp); walked is null or
// (patches, 2), patches in kernel 1's order; the band as in
// gs2d_l2_resident. Returns cudaGetLastError().
int gs2d_fwd_resident(const float* table, const int* ids, const int* count,
                      float* color, float* trans, int* walked, int height,
                      int width, int tile_h, int tile_w, int n_tiles_x,
                      int n_tiles_y, int row_off, int k_cap,
                      float cutoff_sq, float min_throughput,
                      int use_exp_approx, void* stream) {
  walk::WalkArgs a;
  if (patch::patch_args(height, width, tile_h, tile_w, n_tiles_x,
                        n_tiles_y, k_cap, cutoff_sq, min_throughput,
                        use_exp_approx, &a, row_off) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const PatchGrid g = patch::patch_grid(a);
  fwd_resident_kernel<<<patch::patch_blocks(a, g), kPatchWarps * 32, 0,
                        (cudaStream_t)stream>>>(table, ids, count, color,
                                                trans, walked, a.p, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
