// Flat-layout rasterizer kernels for Hopper (sm_90a), bound with ctypes
// through a plain C interface (gs2d_tpu_torch/ops/_build.py).
//
// The flat binning (gs2d_tpu_torch/ops/tiles_flat.py) stores each tile's
// index-ordered (tile, splat) pairs as a run of pregathered 16-float rows
// that starts on a kc-row block: tile t owns rows
// [start[t], start[t] + count[t]) of one (M, 16) array, of which the
// kernels take the first min(count[t], max_chunks * kc).
//
// Kernel 10, gs2d_fwd_flat: the forward composite (C, T), after a pass
//   that writes the launch's non-finite mask (nonfinite_mask_kernel).
//   Replaces gs2d_tpu/ops/render_pallas_flat.py::_fwd_flat_kernel
//   (pallas_call at :366).
// Kernel 11, gs2d_bwd_flat: the backward replay from a carry-in prefix
//   (C_in, T_in) for any upstream cotangent gC, writing one 9-moment row per
//   flat pair row, and the sum of each splat's rows in tile order into the
//   (9, n) moments. Replaces render_pallas_flat.py::_bwd_flat_kernel
//   (pallas_call at :460) and, for the splat sum, the XLA scatter of
//   _segment_grads_flat. No atomics, so runs repeat bit for bit.
//
// Design: the warp patches of kernels 1 and 2 (patch_walk.cuh) over a
// tile's run (FlatRun). One warp owns an 8-row x 32-column patch, the pixels
// warp w of a one-block-per-tile pass owned, 4 patches a block, so the 10k
// workload (14x5 tiles of 32x128) runs 280 blocks and the 1080p one 2040;
// 64-row tiles are walked in 32-row passes. Each warp culls the run 32 rows
// at a time, walks the survivors in run order and stops at its own
// saturation exit (then walks only non-finite survivors); no shared memory
// and no block-wide barrier, so kc bounds nothing here. After the exit the
// forward culls no more: the mask pass, one warp per 32 flat rows, sets a
// bit for each row with a non-finite field (cull_slot's bad), and the
// warp reads one mask word per 32 slots of the rest of its run (1,024
// slots a load), culling and walking only a chunk with a listed bit set
// (patch_walk.cuh's fwd_tail). The replay has no
// forward beside it: it loads the cotangent and carry-in planes of its
// patch and finds its exit on its own replayed T; once a pixel's
// cotangent, ga or T is not finite it walks every later row (0 * NaN).
//   bwd_flat_kernel writes one 9-moment partial per (pass, warp, flat row),
//   (n_pass * warps per pass, M, 9), an exact zero for every row it skips;
//   flat_patch_sum_kernel adds them per row in the order of the
//   one-block-per-tile sums (per pass a = 0 and the warps in index order;
//   out = 0 and the passes in order) and writes every row of the (M, 9)
//   moments, zeros on rows outside the runs (so the wrapper allocates them
//   unzeroed); segment_sum_flat_kernel adds splat i's rows over the tiles
//   of its tile box in ascending tile order.
// The box is the one the binning expanded (tiles._bbox_and_quad), computed
// in the kernel from the splat's packed fields (tiles.packed_fields: pos,
// sx, sy, cos and sin of rot, h) with the float32 operations of
// geometry.cov_of / inv_cov_of / bbox_half_width in their order, so it is the
// binning's box bit for bit; the binning's exact cull only removes pairs
// from it, so a splat's rows all lie in box tiles and the sum is the
// all-tile sum. Offscreen splats have an empty box and get 0.
//
// On finite inputs colour, T and the moments equal the one-block-per-tile
// chunk walk's (tile_walk.cuh, which the dense kernels 6/7 and 8/9 run)
// bit for bit: a step over a culled row or past a warp's exit adds exact
// zeros. Where a splat or a carry is not finite the patch walk gives the
// NaNs of the walk without exits, while the chunk walk stops at block-wide
// points set by the other warps of its pass; the two agree there as long as
// that pass does not saturate after the non-finite value.
//
// What bounds them on the card: about 58 f32 operations per live (pixel,
// pair) forward and 81 backward (scripts/roofline.py), against 64 bytes of
// row per pair; the patch partials add M x passes x 16 x 36 bytes written
// and read once (332 MB at 1080p/100k). Opaque populations saturate a
// patch within the first 3-6% of its run (hd-1m), so the forward is
// bounded by its cull up to the exit, each warp reading and culling those
// rows, and by the mask pass's reads: all M rows once, 64 bytes a row (229
// MB, 0.07 ms at 3.35 TB/s, at hd-1m's M of 3,581,184), and M / 8 bytes of
// mask written.

#include <cuda_runtime.h>

#include "patch_walk.cuh"
#include "splat_terms.cuh"
#include "tile_walk.cuh"

namespace gs2d {
namespace flat {

using patch::FlatRun;
using patch::kPatchWarps;
using patch::kRows;
using patch::Patch;
using patch::PatchGrid;

// Bit j of mask word w: whether flat row 32 w + j has a non-finite field
// among kPx..kOp, on cull_slot's loads and isfinite tests (its bad); rows
// past m_rows are clear. One warp a word, a lane a row; no atomics.
__global__ void nonfinite_mask_kernel(const float* __restrict__ rows,
                                      unsigned* __restrict__ mask,
                                      int m_rows) {
  const size_t r = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool bad = false;
  if (r < (size_t)m_rows) {
    const float* row = rows + r * kFields;
#pragma unroll
    for (int f = kPx; f <= kOp; ++f) bad |= !isfinite(row[f]);
  }
  const unsigned word = __ballot_sync(0xffffffffu, bad);
  if ((threadIdx.x & 31) == 0 && r < (size_t)m_rows) mask[r >> 5] = word;
}

// Kernel 10's patch. With mask set (nonfinite_mask_kernel's words) its walk
// stops culling at the saturation exit (fwd_tail); without, it culls the
// whole run, as walked's survivor count needs. exits, when set, gets each
// patch's exit slot (fwd_walk's exit_slot), patches in (tile, pass, warp)
// order.
__global__ void __launch_bounds__(kPatchWarps * 32)
fwd_flat_kernel(const float* __restrict__ rows, const int* __restrict__ start,
                const int* __restrict__ count, float* __restrict__ color,
                float* __restrict__ trans, int* __restrict__ walked,
                const unsigned* __restrict__ mask, int* __restrict__ exits,
                RenderArgs p, PatchGrid g, int cap) {
  const Patch c = patch::patch_of(p, g);
  if (!c.active) return;
  const int s0 = start[c.tile];
  FlatRun run{rows + (size_t)s0 * kFields};
  if (mask != nullptr) {
    run.mask = mask + (s0 >> 5);
    run.bit0 = s0 & 31;
  }
  float cr[kRows], cg[kRows], cb[kRows], T[kRows];
  int survivors, n_walked, exit_slot;
  patch::fwd_patch(run, min(count[c.tile], cap), c, p, cr, cg, cb, T,
                   survivors, n_walked, &exit_slot);
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
  patch::record_walk(walked, c, g, survivors, n_walked);
  if (exits != nullptr && c.lane == 0) {
    exits[patch::patch_index(c, g)] = exit_slot;
  }
}

__global__ void __launch_bounds__(kPatchWarps * 32)
bwd_flat_kernel(const float* __restrict__ rows, const int* __restrict__ start,
                const int* __restrict__ count, const float* __restrict__ fin,
                const float* __restrict__ gc, const float* __restrict__ cin,
                const float* __restrict__ tin, float* __restrict__ partial,
                int* __restrict__ walked, RenderArgs p, PatchGrid g, int cap,
                int m_rows) {
  const Patch c = patch::patch_of(p, g);
  if (!c.active) return;
  const int s0 = start[c.tile];
  float gc_r[kRows], gc_g[kRows], gc_b[kRows], gf[kRows], ga[kRows],
      T[kRows];
  walk::load_cotangent(fin, gc, cin, tin, p, c.xx, c.y0, gc_r, gc_g, gc_b,
                       gf, ga, T);
  const int pw = c.pass * g.ngrp * g.ncg + c.warp;
  int survivors, n_walked;
  patch::bwd_patch<true>(FlatRun{rows + (size_t)s0 * kFields},
                         min(count[c.tile], cap), 0, c, p, gc_r, gc_g, gc_b,
                         gf, ga, T,
                         partial + ((size_t)pw * m_rows + s0) * kMoments,
                         kMoments, survivors, n_walked);
  patch::record_walk(walked, c, g, survivors, n_walked);
}

// moments[r][f] for every flat row r: for the row k < min(count[t], cap) of
// tile t's run, its partials summed per pass (a = 0, the warps in index
// order) and over the passes in order (out = 0); 0 on every other row. One
// thread per (row, moment), so the partials' reads coalesce.
__global__ void flat_patch_sum_kernel(const int* __restrict__ start,
                                      const int* __restrict__ count,
                                      const float* __restrict__ partial,
                                      float* __restrict__ moments,
                                      int n_tiles, int cap, int m_rows,
                                      int n_pass, int wpp) {
  const size_t gi = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= (size_t)m_rows * kMoments) return;
  const int r = (int)(gi / kMoments);
  // The tile whose run may hold row r: the last one starting at or before
  // it (starts ascend; empty tiles share the next tile's start).
  int lo = 0, hi = n_tiles;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (start[mid] <= r) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  float out = 0.0f;
  if (lo > 0 && r - start[lo - 1] < min(count[lo - 1], cap)) {
    const size_t plane = (size_t)m_rows * kMoments;
    for (int ps = 0; ps < n_pass; ++ps) {
      float a = 0.0f;
      for (int w = 0; w < wpp; ++w) {
        a += partial[(size_t)(ps * wpp + w) * plane + gi];
      }
      out += a;
    }
  }
  moments[gi] = out;
}

// Floor division (torch.div's rounding_mode="floor" on int32).
__device__ __forceinline__ int floor_div(int v, int d) {
  const int q = v / d;
  return (v % d != 0 && v < 0) ? q - 1 : q;
}

// Splat i's clamped tile box [tx0, tx1] x [ty0, ty1], empty when it is
// offscreen: tiles._bbox_and_quad on the packed fields (16, n), operation
// for operation (the half-height is the packed h, which packed_fields forms
// as the box does). In a band of n_tiles_y tile rows from image row row_off
// its rows are band rows, clipped to the band, and it is empty for a splat
// outside the band, as tiles.bin_splats bins a band.
struct TileBox {
  int tx0, tx1, ty0, ty1;
};

__device__ __forceinline__ TileBox tile_box(const float* __restrict__ fields,
                                            int n, int i, const RenderArgs& p,
                                            float bounds) {
  const float px = fields[(size_t)kPx * n + i];
  const float py = fields[(size_t)kPy * n + i];
  const float hy = fields[(size_t)kH * n + i];
  const float sx = fields[(size_t)kSx * n + i];
  const float sy = fields[(size_t)kSy * n + i];
  const float c = fields[(size_t)kCos * n + i];
  const float s = fields[(size_t)kSin * n + i];
  const float l0 = sx * sx;
  const float l1 = sy * sy;
  const float s11 = l0 * c * c + l1 * s * s;
  const float s12 = (l0 - l1) * s * c;
  const float s22 = l0 + l1 - s11;
  const float det = s11 * s22 - s12 * s12;
  const float hx = sqrtf((s11 / det) * det) * bounds;
  const int x0 = trunc_i32(px - hx), x1 = trunc_i32(px + hx);
  const int y0 = trunc_i32(py - hy), y1 = trunc_i32(py + hy);
  const int r0 = p.row_off / p.tile_h;  // the band's first tile row
  const int ty0 = floor_div(y0, p.tile_h), ty1 = floor_div(y1, p.tile_h);
  TileBox b;
  b.tx0 = min(max(floor_div(x0, p.tile_w), 0), p.n_tiles_x - 1);
  b.tx1 = min(max(floor_div(x1, p.tile_w), 0), p.n_tiles_x - 1);
  b.ty0 = min(max(ty0 - r0, 0), p.n_tiles_y - 1);
  b.ty1 = min(max(ty1 - r0, 0), p.n_tiles_y - 1);
  if (x1 < 0 || x0 >= p.width || y1 < 0 || y0 >= p.height || ty1 < r0 ||
      ty0 > r0 + p.n_tiles_y - 1) {
    b.ty0 = 1;  // offscreen: no tile
    b.ty1 = 0;
  }
  return b;
}

// grads9[f][i] = sum over the tiles of splat i's box, in tile order, of its
// moment row in that tile's run (row-major over (ty, tx) is ascending tile
// index). boxes, when set, gets the box as (tx0, tx1, ty0, ty1).
__global__ void segment_sum_flat_kernel(const int* __restrict__ ids,
                                        const int* __restrict__ start,
                                        const int* __restrict__ count,
                                        const float* __restrict__ moments,
                                        const float* __restrict__ fields,
                                        float* __restrict__ grads9,
                                        int* __restrict__ boxes, int n_splats,
                                        RenderArgs p, float bounds) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_splats) return;
  const TileBox b = tile_box(fields, n_splats, i, p, bounds);
  float acc[kMoments];
#pragma unroll
  for (int f = 0; f < kMoments; ++f) acc[f] = 0.0f;
  for (int ty = b.ty0; ty <= b.ty1; ++ty) {
    for (int tx = b.tx0; tx <= b.tx1; ++tx) {
      const int t = ty * p.n_tiles_x + tx;
      const int s = start[t];
      add_run_moments(ids + s, count[t], moments + (size_t)s * kMoments, i,
                      acc);
    }
  }
#pragma unroll
  for (int f = 0; f < kMoments; ++f) grads9[(size_t)f * n_splats + i] = acc[f];
  if (boxes != nullptr) {
    boxes[4 * i] = b.tx0;
    boxes[4 * i + 1] = b.tx1;
    boxes[4 * i + 2] = b.ty0;
    boxes[4 * i + 3] = b.ty1;
  }
}

// Launch constants: the pass geometry of walk_args and the patch grid.
// Returns false for a tile shape the kernels do not take.
bool flat_args(int height, int width, int tile_h, int tile_w, int n_tiles_x,
               int n_tiles_y, int row_off, int kc, int max_chunks,
               float cutoff_sq, float min_throughput, int use_exp_approx,
               walk::WalkArgs* a, PatchGrid* g) {
  if (walk::walk_args(height, width, tile_h, tile_w, n_tiles_x, n_tiles_y,
                      kc, max_chunks, 0, 0, cutoff_sq, min_throughput,
                      use_exp_approx, a) == 0) {
    return false;
  }
  a->p.row_off = row_off;
  *g = patch::patch_grid(*a);
  return true;
}

}  // namespace flat
}  // namespace gs2d

using gs2d::flat::PatchGrid;
using gs2d::walk::WalkArgs;

namespace {

int launch_nonfinite_mask(const float* rows, unsigned* mask, int m_rows,
                          cudaStream_t stream) {
  if (m_rows <= 0) return (int)cudaSuccess;
  const size_t threads = (size_t)(m_rows + 31) / 32 * 32;
  gs2d::flat::nonfinite_mask_kernel<<<(unsigned)((threads + 255) / 256), 256,
                                      0, stream>>>(rows, mask, m_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The non-finite mask of the (m_rows, 16) rows: mask gets (m_rows + 31) /
// 32 words. Returns cudaGetLastError().
int gs2d_flat_nonfinite_mask(const float* rows, unsigned* mask, int m_rows,
                             void* stream) {
  return launch_nonfinite_mask(rows, mask, m_rows, (cudaStream_t)stream);
}

// Kernel 10. rows is (m_rows, 16), start/count (n_tiles,); color is
// (3, Hp, Wp), trans (Hp, Wp); walked is null or (patches, 2), exits null or
// (patches,), patches in (tile, pass, warp) order. mask is null (the whole
// run culled) or scratch of (m_rows + 31) / 32 words, which the mask pass
// writes first on the same stream. A band of tile rows is n_tiles_y rows
// from image row row_off, its planes (3, n_tiles_y * tile_h, Wp); 0 for the
// whole image. Returns cudaGetLastError().
int gs2d_fwd_flat(const float* rows, const int* start, const int* count,
                  float* color, float* trans, int* walked, unsigned* mask,
                  int* exits, int m_rows, int height, int width, int tile_h,
                  int tile_w, int n_tiles_x, int n_tiles_y, int row_off,
                  int kc, int max_chunks, float cutoff_sq,
                  float min_throughput, int use_exp_approx, void* stream) {
  WalkArgs a;
  PatchGrid g;
  if (!gs2d::flat::flat_args(height, width, tile_h, tile_w, n_tiles_x,
                             n_tiles_y, row_off, kc, max_chunks, cutoff_sq,
                             min_throughput, use_exp_approx, &a, &g)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (mask != nullptr) {
    const int err = launch_nonfinite_mask(rows, mask, m_rows, s);
    if (err != cudaSuccess) return err;
  }
  gs2d::flat::fwd_flat_kernel<<<gs2d::patch::patch_blocks(a, g),
                                gs2d::patch::kPatchWarps * 32, 0, s>>>(
      rows, start, count, color, trans, walked, mask, exits, a.p, g,
      max_chunks * kc);
  return (int)cudaGetLastError();
}

// Kernel 11: the replay, the per-row patch sum and the splat sum. fin, gc
// and cin are (3, Hp, Wp), tin (Hp, Wp); fields is the (16, n_splats)
// packed fields (the splats' tile boxes); partial is scratch of
// (patches per tile, m_rows, 9) floats, read only where the replay wrote it;
// moments (m_rows, 9) and grads9 (9, n_splats) are written whole; walked is
// null or (patches, 2) as in gs2d_fwd_flat, boxes null or (n_splats, 4);
// the band as in gs2d_fwd_flat. Returns cudaGetLastError().
int gs2d_bwd_flat(const float* rows, const int* ids, const int* start,
                  const int* count, const float* fin, const float* gc,
                  const float* cin, const float* tin, const float* fields,
                  float* partial, float* moments, float* grads9, int* walked,
                  int* boxes, int n_splats, int m_rows, int height, int width,
                  int tile_h, int tile_w, int n_tiles_x, int n_tiles_y,
                  int row_off, int kc, int max_chunks, float cutoff_sq,
                  float min_throughput, float bounds, int use_exp_approx,
                  void* stream) {
  WalkArgs a;
  PatchGrid g;
  if (!gs2d::flat::flat_args(height, width, tile_h, tile_w, n_tiles_x,
                             n_tiles_y, row_off, kc, max_chunks, cutoff_sq,
                             min_throughput, use_exp_approx, &a, &g)) {
    return (int)cudaErrorInvalidValue;
  }
  const int cap = max_chunks * kc;
  cudaStream_t s = (cudaStream_t)stream;
  gs2d::flat::bwd_flat_kernel<<<gs2d::patch::patch_blocks(a, g),
                                gs2d::patch::kPatchWarps * 32, 0, s>>>(
      rows, start, count, fin, gc, cin, tin, partial, walked, a.p, g, cap,
      m_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t threads = (size_t)m_rows * gs2d::kMoments;
  gs2d::flat::flat_patch_sum_kernel<<<(unsigned)((threads + 255) / 256), 256,
                                      0, s>>>(
      start, count, partial, moments, n_tiles_x * n_tiles_y, cap, m_rows,
      g.n_pass, g.ngrp * g.ncg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gs2d::flat::segment_sum_flat_kernel<<<(n_splats + 127) / 128, 128, 0, s>>>(
      ids, start, count, moments, fields, grads9, boxes, n_splats, a.p,
      bounds);
  return (int)cudaGetLastError();
}

}  // extern "C"
