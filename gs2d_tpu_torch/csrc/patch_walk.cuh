// Warp-patch walk of one tile's list, shared by the resident kernels 1, 2, 3
// and 12 (render_resident.cu), the dense kernels 4/5, 6/7 and 8/9
// (render_dense.cu), the flat kernels 10 and 11 (render_flat.cu) and the
// MXU-form kernel 13 (render_mxu.cu, its own steps on this walk).
//
// Each warp owns one patch, the 8 rows x 32 columns that warp w of a
// one-block-per-tile pass owned (lane = column; tile_walk.cuh's pass), and a
// block holds kPatchWarps = 4 patches of one pass of one tile (a 32-column
// strip of a 32-row pass). A warp culls its tile's list 32 slots at a time,
// a lane a slot: the lane reads the splat's row and decides, for the patch's
// 8 rows at once, which lanes it covers (row walk, row_interval, image
// bounds: the bits of splat_terms' cover). The survivors of a cull, the
// slots covering a pixel of the patch or with a non-finite field, are walked
// in list order, each broadcast from its lane by shuffles with its covered
// lanes, so a step tests a lane's own range in place of recomputing the
// interval. Nothing is staged in shared memory, so the list length is not
// bounded by it.
//
// The layouts differ only in where slot k's row lies, which the walk takes
// as a row source (a template parameter, no branch in the step): TableRun
// reads the resident table through the tile's ids, DenseRun the dense
// layout's (n_tiles, K, 16) tile_params, FlatRun the tile's run of
// pregathered rows. A FlatRun may also carry the launch's non-finite mask
// (kMasked, kernel 10): the forward walk then stops culling at its
// saturation exit and reads the mask for the non-finite rows after it
// (fwd_tail). TableRun and DenseRun carry none, so their walk is compiled
// without the tail.
//
// Exactness. A culled slot's step adds exact zeros and leaves (C, T, ga)
// unchanged, as long as its Gaussian term is finite (a finite,
// positive-definite conic) and the warp's cotangent and carries are: 0 * NaN
// is how a step that covers nothing still reaches the outputs. Hence
// non-finite splats are never culled, and once a pixel of the warp holds a
// non-finite cotangent or carry, the replay walks every later slot. The
// forward stops its walk after the survivor at which no pixel of the patch
// keeps T >= min_throughput (the early-out then fails everywhere for every
// later step), walking only the non-finite survivors after it; the replay
// either takes that prefix from the forward (kernel 1, whose replay T
// follows the forward's bit for bit) or finds its own on its replayed T
// (kernels 3, 8/9 and 11, from a carry-in). The walks take their steps as
// functors (fwd_walk, replay_walk), so kernel 13 walks its coefficient-form
// steps the same way. So on finite inputs the patch walk computes what the
// one-block-per-tile walk (tile_walk.cuh) computes, bit for bit;
// where a splat or a carry is not finite it gives the NaNs of that walk
// without its saturation exits.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>

#include "splat_terms.cuh"
#include "tile_walk.cuh"

namespace gs2d {
namespace patch {

constexpr int kRows = walk::kRows;  // pixel rows of a patch
constexpr int kPatchWarps = 4;      // patches (warps) per block

// The patches of a launch: passes per tile, row groups per pass (sub_h /
// kRows), 32-column groups per pass, and blocks per pass.
struct PatchGrid {
  int n_pass, ngrp, ncg, bpp;
};

struct Patch {
  int tile, pass, warp;  // warp: its index within the pass (the sum order)
  int lane, x0, xx, y0;  // x0, y0: the patch's first column and row in the
                         // launch's planes
  int yg;                // its first row in the image: y0 + p.row_off
  float fx;
  bool active;           // false for the spare warps of a pass's last block
};

// This thread's patch. A block holds kPatchWarps consecutive warps of one
// pass in strip order (column group outer, row group inner): at 4 row groups
// a block is one 32-column strip. The patch itself is what warp
// grp * ncg + cg of a one-block-per-tile pass owned.
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
  c.yg = c.y0 + p.row_off;
  c.fx = (float)c.xx + 0.5f;
  return c;
}

// The launch constants of a warp-patch kernel over lists of k_cap slots:
// the walk's passes for the tile shape (tile_walk.cuh's walk_args, which fix
// the patches' pass order) with the whole list as one chunk, so a->p.k_cap
// is K. A band of tile rows (tile-axis sharding) is a launch over its
// n_tiles_y rows whose planes hold only the band, row_off its first image
// row: the splat geometry and the in-image test take image rows (yg), the
// planes band rows (y0). Returns 0 for a shape the kernels do not take.
inline int patch_args(int height, int width, int tile_h, int tile_w,
                      int n_tiles_x, int n_tiles_y, int k_cap,
                      float cutoff_sq, float min_throughput,
                      int use_exp_approx, walk::WalkArgs* a,
                      int row_off = 0) {
  const int threads = walk::walk_args(
      height, width, tile_h, tile_w, n_tiles_x, n_tiles_y, k_cap, 1, 0,
      k_cap, cutoff_sq, min_throughput, use_exp_approx, a);
  a->p.row_off = row_off;
  return threads;
}

// The patch grid of a launch whose pass geometry walk_args fixed.
inline PatchGrid patch_grid(const walk::WalkArgs& a) {
  PatchGrid g;
  g.n_pass = a.p.tile_h / a.sub_h;
  g.ngrp = a.sub_h / kRows;
  g.ncg = a.p.tile_w / 32;
  g.bpp = (g.ngrp * g.ncg + kPatchWarps - 1) / kPatchWarps;
  return g;
}

inline int patch_blocks(const walk::WalkArgs& a, const PatchGrid& g) {
  return a.p.n_tiles_x * a.p.n_tiles_y * g.n_pass * g.bpp;
}

// The patch's index among the launch's patches, in (tile, pass, warp) order.
__device__ __forceinline__ size_t patch_index(const Patch& c,
                                              const PatchGrid& g) {
  return ((size_t)c.tile * g.n_pass + c.pass) * (g.ngrp * g.ncg) + c.warp;
}

// Writes a patch's (survivors, survivors walked) into walked (patches, 2),
// patches in (tile, pass, warp) order, when the caller asked for them.
__device__ __forceinline__ void record_walk(int* walked, const Patch& c,
                                            const PatchGrid& g, int survivors,
                                            int n_walked) {
  if (walked == nullptr || c.lane != 0) return;
  const size_t w = patch_index(c, g);
  walked[2 * w] = survivors;
  walked[2 * w + 1] = n_walked;
}

// Row sources: slot k's 16-float row in tile `tile`'s list.
struct TableRun {  // the resident table through the (n_tiles, K) ids
  static constexpr bool kMasked = false;
  const float* table;
  const int* ids;
  int k_cap;
  __device__ __forceinline__ const float* row(int tile, int k) const {
    return table + (size_t)ids[(size_t)tile * k_cap + k] * kFields;
  }
};

struct DenseRun {  // the (n_tiles, K, 16) tile_params: tile t owns rows t * K..
  static constexpr bool kMasked = false;
  const float* rows;
  int k_cap;
  __device__ __forceinline__ const float* row(int tile, int k) const {
    return rows + ((size_t)tile * k_cap + k) * kFields;
  }
};

struct FlatRun {  // one tile's run of pregathered rows
  static constexpr bool kMasked = true;
  const float* run;
  // Null, or the launch's non-finite mask (render_flat.cu's
  // nonfinite_mask_kernel: bit j of word w for flat row 32 w + j) from the
  // word that holds the run's first row, as its bit bit0.
  const unsigned* mask = nullptr;
  int bit0 = 0;
  __device__ __forceinline__ const float* row(int, int k) const {
    return run + (size_t)k * kFields;
  }
  // Bit j: whether slot k + j is listed (below n) and its row has a
  // non-finite field; k < n, a multiple of 32. A run that starts inside a
  // word (kc not a multiple of 32) takes its bits from two.
  __device__ __forceinline__ unsigned nonfinite(int k, int n) const {
    const int w = (bit0 + k) >> 5;
    const unsigned hi = bit0 != 0 && n - k > 32 - bit0 ? mask[w + 1] : 0u;
    const unsigned bits = __funnelshift_r(mask[w], hi, bit0);
    return n - k < 32 ? bits & ((1u << (n - k)) - 1u) : bits;
  }
};

// One listed slot as the lane that culls it holds it: the splat's scalars
// and, per patch row r, the lanes [lo_r, hi_r] it covers there (empty as
// lo = 1, hi = 0), one byte each: lo in span[r / 4], hi in span[2 + r / 4].
struct Slot {
  Splat s;
  unsigned span[4];
  bool keep;  // covers a pixel of the patch, or a field is not finite
  bool bad;   // a field is not finite
};

// The cull of slot k of the patch's tile (keep false past n): the cover of
// splat_terms (row walk, row_interval, image bounds) decided for the 8 rows
// at once, on the same bits.
template <class Run>
__device__ __forceinline__ Slot cull_slot(const Run& run, int k, int n,
                                          const Patch& c,
                                          const RenderArgs& p) {
  Slot sl = {};
  if (k >= n) return sl;
  const float* row = run.row(c.tile, k);
  sl.s = load_splat(row);
#pragma unroll
  for (int f = kPx; f <= kOp; ++f) sl.bad |= !isfinite(row[f]);
  const int x_hi = min(c.x0 + 31, p.width - 1);
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int yy = c.yg + r;
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

// Whether no pixel of the warp keeps T >= min_throughput.
__device__ __forceinline__ bool saturated(const float (&T)[kRows],
                                          const RenderArgs& p) {
  int open = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) open |= T[r] >= p.min_throughput;
  return !__any_sync(0xffffffffu, open);
}

// One forward step of the patch's 8 pixels over a broadcast slot (fwd_one
// with the cover of its spans).
__device__ __forceinline__ void fwd_patch_step(
    const Slot& b, const Patch& c, const RenderArgs& p, float (&cr)[kRows],
    float (&cg)[kRows], float (&cb)[kRows], float (&T)[kRows]) {
  const float vx = c.fx - b.s.px;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float vy = ((float)(c.yg + r) + 0.5f) - b.s.py;
    const float alpha = gauss_alpha(b.s, vx, vy, p);
    const bool live = covered(b, r, c.lane) && T[r] >= p.min_throughput;
    fwd_step(b.s, live, alpha, cr[r], cg[r], cb[r], T[r]);
  }
}

// The tail of a masked forward walk, from chunk k0 (a multiple of 32) to the
// run's end, past the saturation exit: fwd_walk's cull walks only the
// non-finite survivors there, which are the rows the mask flags (a bad row
// is always kept). A lane reads the word of one chunk, so a load covers
// 1,024 slots; only a chunk with a flagged listed slot is culled, and its
// non-finite survivors are walked in slot order: the steps fwd_walk's full
// cull walks, in the same order.
template <class Run, class Step>
__device__ __forceinline__ void fwd_tail(const Run& run, int k0, int n,
                                         const Patch& c, const RenderArgs& p,
                                         Step&& step, int& walked) {
  for (; k0 < n; k0 += 32 * 32) {
    const int k = k0 + 32 * c.lane;
    const unsigned word = k < n ? run.nonfinite(k, n) : 0u;
    unsigned hit = __ballot_sync(0xffffffffu, word != 0u);
    while (hit) {
      const int j = __ffs(hit) - 1;
      hit &= hit - 1;
      const Slot sl = cull_slot(run, k0 + 32 * j + c.lane, n, c, p);
      unsigned todo = __ballot_sync(0xffffffffu, sl.bad);
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        step(broadcast(sl, src));
        ++walked;
      }
    }
  }
}

// The forward walk of the patch over the n listed slots of its tile: the
// survivors of each 32-slot cull in list order, each broadcast from its
// lane to the warp and handed to step, which updates the patch's carries
// (T among them). The full walk stops after the survivor at which no pixel
// of the patch keeps T >= min_throughput; after it only the non-finite
// survivors are walked. Returns that prefix's length (the replay's);
// survivors and walked get the survivors' count and how many were walked.
// A run with its mask set (kMasked) culls only up to the exit, or not at
// all when the patch starts with no pixel at T >= min_throughput, and
// walks the rest in fwd_tail: the same steps, but survivors then counts
// only the culls before the exit. exit_slot, when set (kMasked only), gets
// the number of slots up to the exit's survivor (0 for a patch saturated
// from the start, n where it never saturates).
template <class Run, class Step>
__device__ __forceinline__ int fwd_walk(const Run& run, int n, const Patch& c,
                                        const RenderArgs& p,
                                        const float (&T)[kRows], Step&& step,
                                        int& survivors, int& walked,
                                        int* exit_slot = nullptr) {
  int n_full = -1;  // set at the saturation exit
  survivors = walked = 0;
  [[maybe_unused]] int exit_at = n;
  if constexpr (Run::kMasked) {
    if (saturated(T, p)) {
      exit_at = 0;
      if (run.mask != nullptr) n_full = 0;
    }
  }
  int k0 = 0;
  for (; k0 < n; k0 += 32) {
    if constexpr (Run::kMasked) {
      if (run.mask != nullptr && n_full >= 0) break;  // fwd_tail's
    }
    const Slot sl = cull_slot(run, k0 + c.lane, n, c, p);
    unsigned todo = __ballot_sync(0xffffffffu, sl.keep);
    const unsigned bad = __ballot_sync(0xffffffffu, sl.bad);
    survivors += __popc(todo);
    if (n_full >= 0) todo &= bad;
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      step(broadcast(sl, src));
      ++walked;
      if (n_full >= 0) continue;
      if (saturated(T, p)) {
        n_full = walked;
        todo &= bad;
        if constexpr (Run::kMasked) exit_at = min(exit_at, k0 + src + 1);
      }
    }
  }
  if constexpr (Run::kMasked) {
    if (run.mask != nullptr) fwd_tail(run, k0, n, c, p, step, walked);
    if (exit_slot != nullptr) *exit_slot = exit_at;
  }
  return n_full >= 0 ? n_full : walked;
}

// The forward composite of the patch over the n listed slots of its tile
// (fwd_walk of fwd_patch_step), (cr, cg, cb, T) carried in registers (T
// starting at 1 inside the image, 0 on padding). Returns fwd_walk's prefix;
// exit_slot as in fwd_walk.
template <class Run>
__device__ __forceinline__ int fwd_patch(
    const Run& run, int n, const Patch& c, const RenderArgs& p,
    float (&cr)[kRows], float (&cg)[kRows], float (&cb)[kRows],
    float (&T)[kRows], int& survivors, int& walked,
    int* exit_slot = nullptr) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    cr[r] = cg[r] = cb[r] = 0.0f;
    T[r] = (c.yg + r < p.height && c.xx < p.width) ? 1.0f : 0.0f;
  }
  return fwd_walk(
      run, n, c, p, T,
      [&](const Slot& b) { fwd_patch_step(b, c, p, cr, cg, cb, T); },
      survivors, walked, exit_slot);
}

// The forward of kernels 2 and 6/7: fwd_patch, its (C, T) written to color
// (3, Hp, Wp) and trans (Hp, Wp), and the patch's (survivors, walked) to
// walked when set.
template <class Run>
__device__ __forceinline__ void fwd_patch_out(const Run& run, int n,
                                              const Patch& c,
                                              const RenderArgs& p,
                                              const PatchGrid& g,
                                              float* __restrict__ color,
                                              float* __restrict__ trans,
                                              int* __restrict__ walked) {
  float cr[kRows], cg[kRows], cb[kRows], T[kRows];
  int n_survivors, n_walked;
  fwd_patch(run, n, c, p, cr, cg, cb, T, n_survivors, n_walked);
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
  record_walk(walked, c, g, n_survivors, n_walked);
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
// fixed-order lane tree of tile_walk.cuh's bwd_pass) to dst.
__device__ __forceinline__ void bwd_patch_step(
    const Slot& b, const Patch& c, const RenderArgs& p,
    const float (&gc_r)[kRows], const float (&gc_g)[kRows],
    const float (&gc_b)[kRows], const float (&gf)[kRows], float (&ga)[kRows],
    float (&T)[kRows], float* __restrict__ dst) {
  const float vx = c.fx - b.s.px;
  Moments m;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float vy = ((float)(c.yg + r) + 0.5f) - b.s.py;
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

// The replay walk of the patch over the n listed slots of its tile, writing
// every listed slot's kWidth-float partial (slot k's at part + k *
// slot_stride): step(b, dst) replays the broadcast slot b and writes its
// warp sum to dst. The first n_full survivors and the non-finite ones after
// them are walked, and an exact zero is written for every other slot.
// kOwnExit: n_full is not known in advance (no forward ran) and is set after
// the survivor at which saturated_now() first holds. Once the warp is
// poisoned (bad: a replay input or carry of a pixel is not finite at the
// start; poisoned(): a carry became so in a step), every later slot is
// walked, as the unculled walk does. survivors and walked get the survivors' count and
// the steps walked.
template <bool kOwnExit, int kWidth, class Run, class Step, class Poisoned,
          class Saturated>
__device__ __forceinline__ void replay_walk(
    const Run& run, int n, int n_full, const Patch& c, const RenderArgs& p,
    bool bad, Step&& step, Poisoned&& poisoned, Saturated&& saturated_now,
    float* __restrict__ part, size_t slot_stride, int& survivors,
    int& walked) {
  if (kOwnExit) n_full = INT_MAX;
  survivors = walked = 0;
  int j = 0;  // survivors met so far
  for (int k0 = 0; k0 < n; k0 += 32) {
    const Slot sl = cull_slot(run, k0 + c.lane, n, c, p);
    const unsigned listed = __ballot_sync(0xffffffffu, k0 + c.lane < n);
    const unsigned nonfin = __ballot_sync(0xffffffffu, sl.bad);
    unsigned todo = __ballot_sync(0xffffffffu, sl.keep);
    survivors += __popc(todo);
    unsigned full = bad ? listed : 0u;  // the slots walked unculled
    if (!bad) {
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        float* dst = part + (size_t)(k0 + src) * slot_stride;
        if (j++ >= n_full && !((nonfin >> src) & 1u)) {
          if (c.lane < kWidth) dst[c.lane] = 0.0f;
          continue;
        }
        step(broadcast(sl, src), dst);
        ++walked;
        if (poisoned()) {
          bad = true;
          full = listed & ~((2u << src) - 1u);  // the slots after src
          break;
        }
        if (kOwnExit && j < n_full && saturated_now()) n_full = j;
      }
    }
    // A culled slot before the unculled walk is an exact zero.
    const bool zero = (listed >> c.lane) & 1u && !sl.keep &&
                      !((full >> c.lane) & 1u);
    if (zero) {
#pragma unroll
      for (int f = 0; f < kWidth; ++f) {
        part[(size_t)(k0 + c.lane) * slot_stride + f] = 0.0f;
      }
    }
    while (full) {
      const int src = __ffs(full) - 1;
      full &= full - 1;
      step(broadcast(sl, src), part + (size_t)(k0 + src) * slot_stride);
      ++walked;
    }
  }
}

// The replay of the patch from the carry (ga, T) under the cotangent (gc,
// gf) (replay_walk of bwd_patch_step), poisoned once a pixel's cotangent or
// carry is not finite; kOwnExit finds the exit on the replay's own T.
template <bool kOwnExit, class Run>
__device__ __forceinline__ void bwd_patch(
    const Run& run, int n, int n_full, const Patch& c, const RenderArgs& p,
    const float (&gc_r)[kRows], const float (&gc_g)[kRows],
    const float (&gc_b)[kRows], const float (&gf)[kRows], float (&ga)[kRows],
    float (&T)[kRows], float* __restrict__ part, size_t slot_stride,
    int& survivors, int& walked) {
  const bool bad = any_nonfinite(gc_r) || any_nonfinite(gc_g) ||
                   any_nonfinite(gc_b) || any_nonfinite(gf) ||
                   any_nonfinite(ga) || any_nonfinite(T);
  replay_walk<kOwnExit, kMoments>(
      run, n, n_full, c, p, bad,
      [&](const Slot& b, float* dst) {
        bwd_patch_step(b, c, p, gc_r, gc_g, gc_b, gf, ga, T, dst);
      },
      [&] { return any_nonfinite(ga) || any_nonfinite(T); },
      [&] { return saturated(T, p); }, part, slot_stride, survivors, walked);
}

// The per-patch partials of kernels 1, 3, 4/5, 8/9, 12 (width 9) and 13
// (width 10): (n_tiles, p.k_cap, n_pass, warps per pass, width). Slot k's
// partial of patch c lies at patch_partial(...) + k * slot_stride(g).
__device__ __forceinline__ size_t slot_stride(const PatchGrid& g,
                                              int width = kMoments) {
  return (size_t)g.n_pass * g.ngrp * g.ncg * width;
}

__device__ __forceinline__ float* patch_partial(float* partial,
                                                const Patch& c,
                                                const PatchGrid& g,
                                                const RenderArgs& p,
                                                int width = kMoments) {
  return partial + ((size_t)c.tile * p.k_cap * g.n_pass + c.pass) *
                       (g.ngrp * g.ncg) * width +
         c.warp * width;
}

// The fused L2 step of one patch (kernels 1, 4/5 and 12) over the n listed
// slots of its tile: the forward composite, its colour written to color
// (3, Hp, Wp), the cotangent gC = C - ref and gf = sum_ch gC * C formed in
// registers, then the replay from the identity carry, which writes slot
// k's partial for this patch into partial (n_tiles, p.k_cap, n_pass,
// warps per pass, 9), an exact zero where it skips the slot. walked, when
// set, gets the patch's (survivors, survivors walked).
template <class Run>
__device__ __forceinline__ void l2_patch(const Run& run, int n,
                                         const Patch& c, const RenderArgs& p,
                                         const PatchGrid& g,
                                         const float* __restrict__ ref,
                                         float* __restrict__ color,
                                         float* __restrict__ partial,
                                         int* __restrict__ walked) {
  float gc_r[kRows], gc_g[kRows], gc_b[kRows], gf[kRows], ga[kRows],
      T[kRows];
  int n_survivors, n_walked;
  // gc_* hold the composite colour until the cotangent is formed.
  const int n_full = fwd_patch(run, n, c, p, gc_r, gc_g, gc_b, T,
                               n_survivors, n_walked);
  const size_t wp = (size_t)p.n_tiles_x * p.tile_w;
  const size_t plane = (size_t)p.n_tiles_y * p.tile_h * wp;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const size_t i = (size_t)(c.y0 + r) * wp + c.xx;
    const float fr = gc_r[r], fg = gc_g[r], fb = gc_b[r];
    color[i] = fr;
    color[plane + i] = fg;
    color[2 * plane + i] = fb;
    gc_r[r] = fr - ref[i];
    gc_g[r] = fg - ref[plane + i];
    gc_b[r] = fb - ref[2 * plane + i];
    gf[r] = gc_r[r] * fr + gc_g[r] * fg + gc_b[r] * fb;
    ga[r] = 0.0f;
    T[r] = (c.yg + r < p.height && c.xx < p.width) ? 1.0f : 0.0f;
  }
  int replay_survivors, replay_walked;
  bwd_patch<false>(run, n, n_full, c, p, gc_r, gc_g, gc_b, gf, ga, T,
                   patch_partial(partial, c, g, p), slot_stride(g),
                   replay_survivors, replay_walked);
  record_walk(walked, c, g, n_survivors, n_walked);
}

// The replay of one patch from a carry-in under an upstream cotangent
// (kernels 3 and 8/9) over the n listed slots of its tile: the planes of
// its 8 rows read into registers (walk::load_cotangent: gc, gf = sum_ch gC
// * C_final, ga = sum_ch gC * C_in, T = T_in; fin, gc and cin are (3, Hp,
// Wp), tin (Hp, Wp)), then bwd_patch with its own saturation exit, slot k's
// partial written as l2_patch writes it, an exact zero where it skips the
// slot. walked, when set, gets the patch's (survivors, survivors walked).
template <class Run>
__device__ __forceinline__ void replay_patch(
    const Run& run, int n, const Patch& c, const RenderArgs& p,
    const PatchGrid& g, const float* __restrict__ fin,
    const float* __restrict__ gc, const float* __restrict__ cin,
    const float* __restrict__ tin, float* __restrict__ partial,
    int* __restrict__ walked) {
  float gc_r[kRows], gc_g[kRows], gc_b[kRows], gf[kRows], ga[kRows],
      T[kRows];
  walk::load_cotangent(fin, gc, cin, tin, p, c.xx, c.y0, gc_r, gc_g, gc_b,
                       gf, ga, T);
  int survivors, n_walked;
  bwd_patch<true>(run, n, 0, c, p, gc_r, gc_g, gc_b, gf, ga, T,
                  patch_partial(partial, c, g, p), slot_stride(g), survivors,
                  n_walked);
  record_walk(walked, c, g, survivors, n_walked);
}

// Launches the splat-axis sum of l2_patch's and replay_patch's partials
// (patch_sum_kernel, render_resident.cu) into rows 0..8 of grads (row
// stride n_pad): ids (n_tiles, k_cap), the first count[t] of each row
// ascending; with bases set, splat i takes its partials only from the
// tiles t with bases[t] <= i < bases[t] + win (kernel 12's window). Returns
// cudaGetLastError().
int launch_patch_sum(const int* ids, const int* count, const int* bases,
                     int win, const float* partial, float* grads, int n_tiles,
                     int k_cap, const PatchGrid& g, int n_splats, int n_pad,
                     cudaStream_t stream);

}  // namespace patch
}  // namespace gs2d
