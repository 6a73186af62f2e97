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
//   at :451). One block per tile: it runs replay_moments over the tile's
//   whole list and shares the per-(tile, slot) segment sum.
//
// Kernel 12, gs2d_l2_window: the L2 step with the window layout's
//   splat-axis sum. Replaces gs2d_tpu/ops/render_pallas_window.py::
//   _l2_window_kernel (pallas_call at :228), which expands the per-slot
//   gradient columns onto a per-tile window [base_t, base_t + W) of the
//   splat axis and drops ids past it (the escaped pairs, counted by the
//   wrapper). One block per tile (l2_tile: the one-block-per-tile design
//   kernel 1 had before its warp patches); the window sum adds splat i's
//   partials only from the tiles whose window holds i, in tile order. At
//   W = n_pad it computes kernel 1's function with kernel 1's sums, so the
//   two agree bit for bit.
//
// What bounds them on the card: about 58 f32 operations per live (pixel,
// slot) in the forward and 81 in the backward replay (scripts/roofline.py),
// against under 100 KB of table and ids, so all are compute and latency
// bound. Each thread keeps kRows pixels of one tile column in registers and
// reads the splat scalars from shared memory as broadcasts. A tile taller
// than one pass of kMaxThreads x kRows pixels (64-row tiles at tile_w 128)
// is walked in passes of sub_h rows.
//
// Kernels 1 and 2 on warp patches. The one-block-per-tile design ran 21
// blocks of 16 warps on 132 SMs at the default 268x213 workload and had
// every warp evaluate every listed splat at all 256 of its pixels, about
// 12x the live evaluations. Now each warp owns one patch, the 8 rows x 32
// columns that warp w of a pass owned before (lane = column), and a block
// holds kPatchWarps = 4 patches of one pass of one tile (a 32-column strip
// of a 32-row pass), so the default workload runs 84 blocks. One warp a
// block (336 blocks) ran kernel 2 slower and kernel 1 no faster (PERF.md).
// A warp culls its tile's list 32 slots at a time, a lane a slot: the lane
// reads the splat's row and decides, for the patch's 8 rows at once, which
// lanes it covers (row walk, row_interval, image bounds: the bits of
// splat_terms' cover). The survivors of a cull, the slots covering a pixel
// of the patch or with a non-finite field, are walked in list order, each
// broadcast from its lane by shuffles with its covered lanes, so a step
// tests a lane's own range in place of recomputing the interval. Nothing is
// staged in shared memory, so K is not bounded by it. A culled slot's step
// adds exact zeros and leaves (C, T, ga) unchanged, as long as its Gaussian
// term is finite (a finite, positive-definite conic) and the warp's
// cotangent and carries are: 0 * NaN is how a step that covers nothing
// still reaches the outputs. Hence the second rule, and once a pixel of the
// warp holds a non-finite cotangent or carry, the replay walks every later
// slot. The forward stops its walk after the survivor at which no pixel of
// the patch keeps T >= min_throughput (the early-out then fails everywhere
// for every later step; tile_walk.cuh's exit), walking only the non-finite
// survivors after it; the replay culls again and walks the same survivors,
// its T following the forward's bit for bit. Kernel 1 writes one 9-moment
// partial per (tile, slot, pass, warp), the warp's lane tree as before, and
// an exact zero for every slot it did not walk; patch_sum_kernel adds them
// in the order of the one-block-per-tile sums (warps in index order, then
// passes in order, then tiles in order). So colour, T and the moments equal
// the one-block-per-tile kernels' (kernel 12 at W = n_pad) bit for bit.

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
// (gc, gf): pass 2 of kernel 12 and all of kernel 3. Adds the pass's
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

// The fused L2 step of one tile (kernel 12): gather the listed rows,
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

// ---- Kernels 1 and 2: warp patches ---------------------------------------

// Warps (patches) per block of kernels 1 and 2.
constexpr int kPatchWarps = 4;

// The patches of a launch: passes per tile, row groups per pass (sub_h /
// kRows), 32-column groups per pass, and blocks per pass.
struct PatchGrid {
  int n_pass, ngrp, ncg, bpp;
};

struct Patch {
  int tile, pass, warp;  // warp: its index within the pass (the sum order)
  int lane, x0, xx, y0;  // x0, y0: the patch's first column and row
  float fx;
  bool active;           // false for the spare warps of a pass's last block
};

// This thread's patch. A block holds kPatchWarps consecutive warps of one
// pass in strip order (column group outer, row group inner): at 4 row groups
// a block is one 32-column strip. The patch itself is what warp
// grp * ncg + cg of a one-block-per-tile pass owned (pixel_coords).
__device__ __forceinline__ Patch patch_of(const RenderArgs& p,
                                          const PatchGrid& g) {
  const int per_tile = g.n_pass * g.bpp;
  const int rem = blockIdx.x % per_tile;
  const int s = (rem % g.bpp) * kPatchWarps + (threadIdx.x >> 5);
  const int cg = s / g.ngrp, grp = s % g.ngrp;
  Patch c;
  c.tile = blockIdx.x / per_tile;
  c.pass = rem / g.bpp;
  c.warp = grp * g.ncg + cg;
  c.active = s < g.ngrp * g.ncg;
  c.lane = threadIdx.x & 31;
  c.x0 = (c.tile % p.n_tiles_x) * p.tile_w + cg * 32;
  c.xx = c.x0 + c.lane;
  c.y0 = (c.tile / p.n_tiles_x) * p.tile_h + (c.pass * g.ngrp + grp) * kRows;
  c.fx = (float)c.xx + 0.5f;
  return c;
}

// One listed slot as the lane that culls it holds it: the splat's scalars
// and, per patch row r, the lanes [lo_r, hi_r] it covers there (empty as
// lo = 1, hi = 0), one byte each: lo in span[r / 4], hi in span[2 + r / 4].
struct Slot {
  Splat s;
  unsigned span[4];
  bool keep;  // covers a pixel of the patch, or a field is not finite
  bool bad;   // a field is not finite
};

// The cull of slot k of the patch's tile (keep false past count): the
// cover of splat_terms (row walk, row_interval, image bounds) decided for
// the 8 rows at once, on the same bits.
__device__ __forceinline__ Slot cull_slot(const float* __restrict__ table,
                                          const int* __restrict__ ids, int k,
                                          int n, const Patch& c,
                                          const RenderArgs& p) {
  Slot sl = {};
  if (k >= n) return sl;
  const float* row = table + (size_t)ids[(size_t)c.tile * p.k_cap + k] *
                                 kFields;
  sl.s = load_splat(row);
#pragma unroll
  for (int f = kPx; f <= kOp; ++f) sl.bad |= !isfinite(row[f]);
  const int x_hi = min(c.x0 + 31, p.width - 1);
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int yy = c.y0 + r;
    int beg_x, end_x;
    const bool q_ok = row_interval(sl.s, (float)yy + 0.5f - sl.s.py, p,
                                   beg_x, end_x);
    const int lo = max(beg_x, c.x0), hi = min(end_x, x_hi);
    const bool on = q_ok && yy >= sl.s.beg_y && yy <= sl.s.end_y &&
                    yy < p.height && lo <= hi;
    any |= on;
    const unsigned shift = 8u * (r % 4);
    sl.span[r / 4] |= (on ? (unsigned)(lo - c.x0) : 1u) << shift;
    sl.span[2 + r / 4] |= (on ? (unsigned)(hi - c.x0) : 0u) << shift;
  }
  sl.keep = any || sl.bad;
  return sl;
}

// Slot `src`'s splat and spans, from the lane that culled it to the warp.
__device__ __forceinline__ Slot broadcast(const Slot& sl, int src) {
  constexpr unsigned kAll = 0xffffffffu;
  Slot b;
  b.s.px = __shfl_sync(kAll, sl.s.px, src);
  b.s.py = __shfl_sync(kAll, sl.s.py, src);
  b.s.a = __shfl_sync(kAll, sl.s.a, src);
  b.s.b = __shfl_sync(kAll, sl.s.b, src);
  b.s.d = __shfl_sync(kAll, sl.s.d, src);
  b.s.cr = __shfl_sync(kAll, sl.s.cr, src);
  b.s.cg = __shfl_sync(kAll, sl.s.cg, src);
  b.s.cb = __shfl_sync(kAll, sl.s.cb, src);
  b.s.op = __shfl_sync(kAll, sl.s.op, src);
#pragma unroll
  for (int i = 0; i < 4; ++i) b.span[i] = __shfl_sync(kAll, sl.span[i], src);
  return b;
}

// Whether this lane's pixel in patch row r is covered by the broadcast slot.
__device__ __forceinline__ bool covered(const Slot& b, int r, int lane) {
  const unsigned shift = 8u * (r % 4);
  const int lo = (int)((b.span[r / 4] >> shift) & 0xffu);
  const int hi = (int)((b.span[2 + r / 4] >> shift) & 0xffu);
  return lane >= lo && lane <= hi;
}

// One forward step of the patch's 8 pixels over a broadcast slot (fwd_one
// with the cover of its spans).
__device__ __forceinline__ void fwd_patch_step(
    const Slot& b, const Patch& c, const RenderArgs& p, float (&cr)[kRows],
    float (&cg)[kRows], float (&cb)[kRows], float (&T)[kRows]) {
  const float vx = c.fx - b.s.px;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float vy = ((float)(c.y0 + r) + 0.5f) - b.s.py;
    const float alpha = gauss_alpha(b.s, vx, vy, p);
    const bool live = covered(b, r, c.lane) && T[r] >= p.min_throughput;
    fwd_step(b.s, live, alpha, cr[r], cg[r], cb[r], T[r]);
  }
}

// The forward composite of the patch over the n listed slots of its tile,
// (cr, cg, cb, T) carried in registers (T starting at 1 inside the image,
// 0 on padding), walking the survivors of each 32-slot cull in list order.
// The full walk stops after the survivor at which no pixel of the patch
// keeps T >= min_throughput; after it only the non-finite survivors are
// walked. Returns that prefix's length (the replay's); survivors and walked
// get the survivors' count and how many were walked.
__device__ __forceinline__ int fwd_patch(
    const float* __restrict__ table, const int* __restrict__ ids, int n,
    const Patch& c, const RenderArgs& p, float (&cr)[kRows],
    float (&cg)[kRows], float (&cb)[kRows], float (&T)[kRows],
    int& survivors, int& walked) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    cr[r] = cg[r] = cb[r] = 0.0f;
    T[r] = (c.y0 + r < p.height && c.xx < p.width) ? 1.0f : 0.0f;
  }
  int n_full = -1;  // set at the saturation exit
  survivors = walked = 0;
  for (int k0 = 0; k0 < n; k0 += 32) {
    const Slot sl = cull_slot(table, ids, k0 + c.lane, n, c, p);
    unsigned todo = __ballot_sync(0xffffffffu, sl.keep);
    const unsigned bad = __ballot_sync(0xffffffffu, sl.bad);
    survivors += __popc(todo);
    if (n_full >= 0) todo &= bad;
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      fwd_patch_step(broadcast(sl, src), c, p, cr, cg, cb, T);
      ++walked;
      if (n_full >= 0) continue;
      int open = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) open |= T[r] >= p.min_throughput;
      if (!__any_sync(0xffffffffu, open)) {
        n_full = walked;
        todo &= bad;
      }
    }
  }
  return n_full >= 0 ? n_full : walked;
}

// Whether a pixel of the warp holds a non-finite value of x: once a replay
// input or carry is, a step that covers nothing still adds 0 * NaN to its
// moments and to ga, so no slot may be skipped any more.
__device__ __forceinline__ bool any_nonfinite(const float (&x)[kRows]) {
  bool bad = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) bad |= !isfinite(x[r]);
  return __any_sync(0xffffffffu, bad);
}

// One replay step of the patch's 8 pixels over a broadcast slot (bwd_one
// with the cover of its spans): writes the slot's 9-moment warp sum (the
// fixed-order lane tree of replay_moments) to dst.
__device__ __forceinline__ void bwd_patch_step(
    const Slot& b, const Patch& c, const RenderArgs& p,
    const float (&gc_r)[kRows], const float (&gc_g)[kRows],
    const float (&gc_b)[kRows], const float (&gf)[kRows], float (&ga)[kRows],
    float (&T)[kRows], float* __restrict__ dst) {
  const float vx = c.fx - b.s.px;
  Moments m;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float vy = ((float)(c.y0 + r) + 0.5f) - b.s.py;
    const float alpha = gauss_alpha(b.s, vx, vy, p);
    const bool live = covered(b, r, c.lane) && T[r] >= p.min_throughput;
    bwd_step(b.s, live, alpha, vy, gc_r[r], gc_g[r], gc_b[r], gf[r], ga[r],
             T[r], m);
  }
  float v[kMoments];
  m.finish(vx, v);
#pragma unroll
  for (int f = 0; f < kMoments; ++f) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[f] += __shfl_down_sync(0xffffffffu, v[f], off);
    }
  }
  if (c.lane == 0) {
#pragma unroll
    for (int f = 0; f < kMoments; ++f) dst[f] = v[f];
  }
}

// The replay of the patch from the carry (ga, T) under the cotangent (gc,
// gf), writing every listed slot's partial (slot k's at part + k *
// slot_stride): the forward's walk, i.e. the first n_full survivors and
// the non-finite ones after them, and an exact zero for every other slot.
// Once the warp is poisoned, every later slot is walked, as the unculled
// walk does.
__device__ __forceinline__ void bwd_patch(
    const float* __restrict__ table, const int* __restrict__ ids, int n,
    int n_full, const Patch& c, const RenderArgs& p,
    const float (&gc_r)[kRows], const float (&gc_g)[kRows],
    const float (&gc_b)[kRows], const float (&gf)[kRows], float (&ga)[kRows],
    float (&T)[kRows], float* __restrict__ part, size_t slot_stride) {
  bool bad = any_nonfinite(gc_r) || any_nonfinite(gc_g) ||
             any_nonfinite(gc_b) || any_nonfinite(gf) || any_nonfinite(ga) ||
             any_nonfinite(T);
  int j = 0;  // survivors met so far
  for (int k0 = 0; k0 < n; k0 += 32) {
    const Slot sl = cull_slot(table, ids, k0 + c.lane, n, c, p);
    const unsigned listed = __ballot_sync(0xffffffffu, k0 + c.lane < n);
    const unsigned nonfin = __ballot_sync(0xffffffffu, sl.bad);
    unsigned todo = __ballot_sync(0xffffffffu, sl.keep);
    unsigned full = bad ? listed : 0u;  // the slots walked unculled
    if (!bad) {
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        float* dst = part + (size_t)(k0 + src) * slot_stride;
        if (j++ >= n_full && !((nonfin >> src) & 1u)) {
          if (c.lane < kMoments) dst[c.lane] = 0.0f;
          continue;
        }
        bwd_patch_step(broadcast(sl, src), c, p, gc_r, gc_g, gc_b, gf, ga, T,
                       dst);
        if (any_nonfinite(ga) || any_nonfinite(T)) {
          bad = true;
          full = listed & ~((2u << src) - 1u);  // the slots after src
          break;
        }
      }
    }
    // A culled slot before the unculled walk is an exact zero.
    const bool zero = (listed >> c.lane) & 1u && !sl.keep &&
                      !((full >> c.lane) & 1u);
    if (zero) {
#pragma unroll
      for (int f = 0; f < kMoments; ++f) {
        part[(size_t)(k0 + c.lane) * slot_stride + f] = 0.0f;
      }
    }
    while (full) {
      const int src = __ffs(full) - 1;
      full &= full - 1;
      bwd_patch_step(broadcast(sl, src), c, p, gc_r, gc_g, gc_b, gf, ga, T,
                     part + (size_t)(k0 + src) * slot_stride);
    }
  }
}

// Kernel 1 on warp patches. partial is (n_tiles, K, n_pass, warps per pass,
// 9); every entry of a slot below count[t] is written once. walked, when
// set, gets (survivors, survivors walked) per patch.
__global__ void __launch_bounds__(kPatchWarps * 32)
l2_resident_kernel(const float* __restrict__ table,
                   const int* __restrict__ ids, const int* __restrict__ count,
                   const float* __restrict__ ref, float* __restrict__ color,
                   float* __restrict__ partial, int* __restrict__ walked,
                   RenderArgs p, PatchGrid g) {
  const Patch c = patch_of(p, g);
  if (!c.active) return;
  const int n = count[c.tile];
  const int wpp = g.ngrp * g.ncg;
  float gc_r[kRows], gc_g[kRows], gc_b[kRows], gf[kRows], ga[kRows],
      T[kRows];
  int n_survivors, n_walked;
  // gc_* hold the composite colour until the cotangent is formed.
  const int n_full = fwd_patch(table, ids, n, c, p, gc_r, gc_g, gc_b, T,
                               n_survivors, n_walked);
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
  const size_t slot_stride = (size_t)g.n_pass * wpp * kMoments;
  float* part = partial + ((size_t)c.tile * p.k_cap * g.n_pass + c.pass) *
                              wpp * kMoments +
                c.warp * kMoments;
  bwd_patch(table, ids, n, n_full, c, p, gc_r, gc_g, gc_b, gf, ga, T, part,
            slot_stride);
  if (walked != nullptr && c.lane == 0) {
    const size_t w = ((size_t)c.tile * g.n_pass + c.pass) * wpp + c.warp;
    walked[2 * w] = n_survivors;
    walked[2 * w + 1] = n_walked;
  }
}

// Kernel 2 on warp patches: kernel 1's forward, written out as (C, T).
__global__ void __launch_bounds__(kPatchWarps * 32)
fwd_resident_kernel(const float* __restrict__ table,
                    const int* __restrict__ ids,
                    const int* __restrict__ count, float* __restrict__ color,
                    float* __restrict__ trans, int* __restrict__ walked,
                    RenderArgs p, PatchGrid g) {
  const Patch c = patch_of(p, g);
  if (!c.active) return;
  float cr[kRows], cg[kRows], cb[kRows], T[kRows];
  int n_survivors, n_walked;
  fwd_patch(table, ids, count[c.tile], c, p, cr, cg, cb, T, n_survivors,
            n_walked);
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
  if (walked != nullptr && c.lane == 0) {
    const int wpp = g.ngrp * g.ncg;
    const size_t w = ((size_t)c.tile * g.n_pass + c.pass) * wpp + c.warp;
    walked[2 * w] = n_survivors;
    walked[2 * w + 1] = n_walked;
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

// Kernel 1's splat-axis sum over its per-(tile, slot, pass, warp) partials,
// one thread per (splat, moment): for each tile in order that lists splat
// i, the slot's sum is formed as the one-block-per-tile kernels formed it
// (per pass, acc = 0 and the warps added in index order; out = 0 and the
// passes added in order) and added to the splat's sum.
__global__ void patch_sum_kernel(const int* __restrict__ ids,
                                 const int* __restrict__ count,
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

// Launch constants of the resident kernels: the walk's passes for the tile
// shape (tile_walk.cuh) with the whole K-row list as one chunk, so a.p.k_cap
// is K. Returns the threads per block of a one-block-per-tile kernel, or 0
// for a shape the kernels do not take.
int resident_args(int height, int width, int tile_h, int tile_w,
                  int n_tiles_x, int n_tiles_y, int k_cap, float cutoff_sq,
                  float min_throughput, int use_exp_approx,
                  walk::WalkArgs* a) {
  return walk::walk_args(height, width, tile_h, tile_w, n_tiles_x, n_tiles_y,
                         k_cap, 1, 0, k_cap, cutoff_sq, min_throughput,
                         use_exp_approx, a);
}

// The patch grid of kernels 1 and 2.
PatchGrid patch_grid(const walk::WalkArgs& a) {
  PatchGrid g;
  g.n_pass = a.p.tile_h / a.sub_h;
  g.ngrp = a.sub_h / kRows;
  g.ncg = a.p.tile_w / 32;
  g.bpp = (g.ngrp * g.ncg + kPatchWarps - 1) / kPatchWarps;
  return g;
}

int patch_blocks(const walk::WalkArgs& a, const PatchGrid& g) {
  return a.p.n_tiles_x * a.p.n_tiles_y * g.n_pass * g.bpp;
}

}  // namespace gs2d

using namespace gs2d;

extern "C" {

// Pixel rows per thread and threads per one-block-per-tile pass; the
// wrapper checks shapes against these before launching.
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
// the sum reads is written by the kernel; grads16 is (16, n_pad), zeroed by the
// caller (rows 9..15 and columns >= n_splats are left as they are); walked
// is null or (patches, 2). Returns cudaGetLastError().
int gs2d_l2_resident(const float* table, const int* ids, const int* count,
                     const float* ref, float* color, float* partial,
                     float* grads16, int* walked, int n_splats, int n_pad,
                     int height, int width, int tile_h, int tile_w,
                     int n_tiles_x, int n_tiles_y, int k_cap,
                     float cutoff_sq, float min_throughput,
                     int use_exp_approx, void* stream) {
  walk::WalkArgs a;
  if (resident_args(height, width, tile_h, tile_w, n_tiles_x, n_tiles_y,
                    k_cap, cutoff_sq, min_throughput, use_exp_approx,
                    &a) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const PatchGrid g = patch_grid(a);
  l2_resident_kernel<<<patch_blocks(a, g), kPatchWarps * 32, 0, s>>>(
      table, ids, count, ref, color, partial, walked, a.p, g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = n_splats * kMoments;
  patch_sum_kernel<<<(threads + 127) / 128, 128, 0, s>>>(
      ids, count, partial, grads16, n_tiles_x * n_tiles_y, k_cap, g.n_pass,
      g.ngrp * g.ncg, n_splats, n_pad);
  return (int)cudaGetLastError();
}

// Kernel 12: kernel 1's arguments but walked, plus bases
// (n_tiles,), each tile's window start, and win, the window width; partial
// is (n_tiles, K, 9), zeroed by the caller. Returns cudaGetLastError().
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
  const size_t smem = walk::bwd_smem_bytes(a.kc, threads);
  cudaError_t err = cudaFuncSetAttribute(
      l2_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  l2_window_kernel<<<n_tiles_x * n_tiles_y, threads, smem, s>>>(
      table, ids, count, ref, color, partial, a.p, a.sub_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
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

// Kernel 2. color is (3, Hp, Wp), trans (Hp, Wp); walked is null or
// (patches, 2), patches in kernel 1's order. Returns cudaGetLastError().
int gs2d_fwd_resident(const float* table, const int* ids, const int* count,
                      float* color, float* trans, int* walked, int height,
                      int width, int tile_h, int tile_w, int n_tiles_x,
                      int n_tiles_y, int k_cap, float cutoff_sq,
                      float min_throughput, int use_exp_approx,
                      void* stream) {
  walk::WalkArgs a;
  if (resident_args(height, width, tile_h, tile_w, n_tiles_x, n_tiles_y,
                    k_cap, cutoff_sq, min_throughput, use_exp_approx,
                    &a) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const PatchGrid g = patch_grid(a);
  fwd_resident_kernel<<<patch_blocks(a, g), kPatchWarps * 32, 0,
                        (cudaStream_t)stream>>>(table, ids, count, color,
                                                trans, walked, a.p, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
