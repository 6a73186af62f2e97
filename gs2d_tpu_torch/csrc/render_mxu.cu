// The fused L2 train step in the "MXU form", for Hopper (sm_90a), bound with
// ctypes through a plain C interface (gs2d_tpu_torch/ops/_build.py).
//
// Kernel 13, gs2d_l2_mxu: replaces gs2d_tpu/ops/render_pallas_mxu.py::
//   _l2_mxu_kernel (pallas_call at :369). It computes that kernel's
//   function, not its block structure:
//   - each splat's squared distance is a degree-2 polynomial in
//     tile-centred pixel coordinates (x', y'): D2 = c_xx x'^2 + c_xy x'y' +
//     c_yy y'^2 + c_x x' + c_y y' + c_0 (the TPU forms D2 as Coef (K, 8) @
//     Basis (8, P) on its matrix unit). The terms are added as
//     ((c_xx x'^2 + c_x x') + c_0) + ((c_yy y'^2 + c_y y') + c_xy x'y'):
//     the terms cancel to D2 <= 18 from magnitudes in the hundreds, and this
//     grouping keeps the default fit's colour within 2.4e-6 of the direct
//     form where the plain left-to-right sum strays by 5.2e-5;
//   - coverage is the exact trunc row/column interval of the direct form,
//     so the masks are kernel 4's;
//   - phase 0 composites with the per-pixel early-out T >= 1/256. T starts
//     at 1 on every pixel of the tile, padding included, as on the TPU, so
//     a patch that reaches the image edge never saturates;
//   - phase 1 replays from (0, 1) and, for each slot, forms q = dL/dalpha *
//     alpha (the (fin - c) / (1 - alpha) form with the select guard) and
//     w = alpha T, and reduces over the tile's pixels the six moments of q
//     against [x'^2, x'y', y'^2, x', y', 1], the three sums of w gC and
//     sum q / max(op, 1e-30) (the TPU's moment matmuls);
//   - the moments are combined per (tile, slot) into the nine gradient
//     fields (g_px, g_py, g_sx, g_sy, g_rot, the colours, the opacity) and
//     the shared tile-order segment sum adds the rows onto the splat axis,
//     where the TPU scatter-adds them.
//   The TPU's (kc, th, tw) alpha, q and w scratch (4 MiB each at kc = 256
//   with 32x128 tiles) is not kept: the replay computes q and w and reduces
//   them at once.
//
// The design: kernel 1's warp patches over the tile_params (patch_walk.cuh:
// one warp per 8 x 32 patch, 4 a block, DenseRun). A warp culls its tile's
// list 32 slots at a time on the bits of the cover above (the cull's spans
// are that interval), walks the survivors with a per-warp saturation exit
// in phase 0, and replays those survivors from the forward's exit in phase
// 1, its T following phase 0's bit for bit. A step forms the splat's six
// coefficients from the broadcast row and evaluates D2, alpha and the
// replay with the arithmetic of the chunk walk below. Each lane takes its
// column sums over its 8 rows in row order, then the x' monomials and the
// fixed warp tree give one 10-sum partial per (tile, slot, pass, warp), an
// exact +0.0 where the walk skips the slot. mxu_combine_kernel adds each
// slot's partials as the chunk walk adds its warps' sums (per pass the
// warps in index order from +0.0, then the passes in order), combines them
// into the nine fields and hands them to the segment sum. A skipped step
// adds exact zeros and leaves the carries unchanged while the patch's
// values are finite, and a sum that starts at +0.0 is never -0.0, so the
// colour, the rows and the gradients equal the chunk walk's bit for bit;
// once a pixel of a patch holds a non-finite value the replay walks every
// later slot, giving that walk's NaNs without its exits.
//
// gs2d_l2_mxu_chunk, a reference only: the design kernel 13 had before it
// moved onto warp patches, kept unchanged. One block per tile; each thread
// owns kRows pixels of one column; chunks of kc rows and their coefficients
// are staged in shared memory and every pixel of the tile is evaluated at
// every listed slot; a tile taller than one pass is walked in passes of
// sub_h rows, each adding its moments, in pass order, to a per-(tile, slot)
// moment scratch that the caller zeroes. It ports no TPU kernel and no path
// reaches it.
//
// What bounds it on the card: CUDA-core float32 arithmetic, as kernel 4
// (the coefficient form saves the direct form's per-pixel vx, vy terms
// and adds a division per live pixel for the opacity sum). A tensor-core
// form (mma/wgmma) is a later change (ROADMAP.md); TF32 alone is too coarse
// here, where the TPU needed its highest matmul precision.

#include <cuda_runtime.h>

#include "patch_walk.cuh"
#include "splat_terms.cuh"
#include "tile_walk.cuh"

namespace gs2d {
namespace mxu {

using walk::kRows;
using walk::WalkArgs;
constexpr int kGroup = walk::kGroup;  // slots per reduction round
constexpr int kCoefs = 6;     // c_xx, c_xy, c_yy, c_x, c_y, c_0
constexpr int kSums = 10;     // m_xx, m_xy, m_yy, m_x, m_y, m_1, w.gC x3, q/op

// Stage chunk c's n_here rows of the tile's run into srows (the dense
// kernels' walk: the run of tile t starts at t * K), then form their
// coefficients in tile-centred coordinates (cx, cy: the tile centre) into
// scoef. Ends with a barrier.
__device__ __forceinline__ void stage_coefs(const float* __restrict__ rows,
                                            const walk::TileWalk& w, int c,
                                            int n_here, const WalkArgs& a,
                                            float cx, float cy, float* srows,
                                            float* scoef) {
  walk::stage_chunk(rows, w, c, n_here, a, srows);
  __syncthreads();
  for (int k = threadIdx.x; k < n_here; k += blockDim.x) {
    const float* r = srows + k * kFields;
    const float sa = r[kA], sb = r[kB], sd = r[kD];
    const float ex = r[kPx] - cx;
    const float ey = r[kPy] - cy;
    float* co = scoef + k * kCoefs;
    co[0] = sa;
    co[1] = 2.0f * sb;
    co[2] = sd;
    co[3] = -2.0f * (sa * ex + sb * ey);
    co[4] = -2.0f * (sd * ey + sb * ex);
    co[5] = sa * ex * ex + 2.0f * sb * ex * ey + sd * ey * ey;
  }
  __syncthreads();
}

// Coverage-masked alpha of one staged splat at pixel (xx, yy), whose
// tile-centred coordinates are (xp, yp) and basis terms bxx = x'^2,
// bxy = x'y', byy = y'^2.
__device__ __forceinline__ float mxu_alpha(const float* r, const float* co,
                                           int xx, int yy, float xp,
                                           float yp, float bxx, float bxy,
                                           float byy, const RenderArgs& p) {
  const float px = r[kPx], py = r[kPy], sa = r[kA], sb = r[kB], sd = r[kD];
  const float h = r[kH];
  const bool row_ok = yy >= trunc_i32(py - h) && yy <= trunc_i32(py + h);
  const float vy = ((float)yy + 0.5f) - py;
  const float qb = 2.0f * sb * vy;
  const float qc = sd * vy * vy - p.cutoff_sq;
  const float disc = qb * qb - 4.0f * sa * qc;
  const bool q_ok = disc >= 0.0f;
  const float sq = sqrtf(nan_max(disc, 0.0f));
  const float sgn = qb < 0.0f ? -1.0f : 1.0f;
  const float kq = (-qb - sgn * sq) * 0.5f;
  const float r0 = kq / sa;
  const float r1 = qc / kq;
  const int beg_x = trunc_i32(px + nan_min(r0, r1));
  const int end_x = trunc_i32(px + nan_max(r0, r1));
  const bool cover = row_ok && q_ok && xx >= beg_x && xx <= end_x &&
                     yy < p.height && xx < p.width;
  const float d2 = ((co[0] * bxx + co[3] * xp) + co[5]) +
                   ((co[2] * byy + co[4] * yp) + co[1] * bxy);
  const float g = exp_term(-0.5f * d2, p.use_exp_approx);
  return cover ? g * r[kOp] : 0.0f;
}

// This thread's pixels in one pass: column xx (tile-centred x'), rows
// y0 .. y0 + kRows - 1 (tile-local row0 ..).
struct PassPixels {
  int xx, y0, row0;
  float xp, bxx;
};

// The reference (gs2d_l2_mxu_chunk): kernel 13's one-block-per-tile chunk
// walk, unchanged.
__global__ void __launch_bounds__(walk::kMaxThreads)
l2_mxu_chunk_kernel(const float* __restrict__ rows,
                    const int* __restrict__ count,
                    const float* __restrict__ ref, float* __restrict__ color,
                    float* __restrict__ mom, float* __restrict__ out,
                    WalkArgs a) {
  extern __shared__ float4 smem4[];
  float* srows = reinterpret_cast<float*>(smem4);       // kc x kFields
  float* scoef = srows + (size_t)a.kc * kFields;        // kc x kCoefs
  float* red = scoef + (size_t)a.kc * kCoefs;           // warps x kGroup x 10
  const RenderArgs& p = a.p;
  const walk::TileWalk run = walk::tile_walk(count, a);
  const int tile = blockIdx.x;
  const int tile_x0 = (tile % p.n_tiles_x) * p.tile_w;
  const int tile_y0 = (tile / p.n_tiles_x) * p.tile_h;
  const float cx = (float)tile_x0 + 0.5f * (float)p.tile_w;
  const float cy = (float)tile_y0 + 0.5f * (float)p.tile_h;
  const float mt = p.min_throughput;
  const size_t wp = (size_t)p.n_tiles_x * p.tile_w;
  const size_t plane = (size_t)p.n_tiles_y * p.tile_h * wp;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float* tile_mom = mom + (size_t)run.s0 * kSums;

  for (int pass = 0; pass < p.tile_h; pass += a.sub_h) {
    PassPixels px;
    px.xx = run.xx;
    px.y0 = run.y0 + pass;
    px.row0 = px.y0 - tile_y0;
    px.xp = ((float)(run.xx - tile_x0) + 0.5f) - 0.5f * (float)p.tile_w;
    px.bxx = px.xp * px.xp;
    float yp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      yp[r] = ((float)(px.row0 + r) + 0.5f) - 0.5f * (float)p.tile_h;
    }

    // ---- phase 0: forward composite --------------------------------------
    float fr[kRows], fg[kRows], fb[kRows], T[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      fr[r] = fg[r] = fb[r] = 0.0f;
      T[r] = 1.0f;
    }
    for (int c = 0; c < run.nb; ++c) {
      // Chunk skip (the TPU's max T >= mt test); also the barrier before
      // shared memory is overwritten.
      if (!walk::any_unsaturated(T, mt)) break;
      const int n_here = min(a.kc, run.n - c * a.kc);
      stage_coefs(rows, run, c, n_here, a, cx, cy, srows, scoef);
      for (int k = 0; k < n_here; ++k) {
        const float* r = srows + k * kFields;
        const float* co = scoef + k * kCoefs;
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const float al = mxu_alpha(r, co, px.xx, px.y0 + j, px.xp, yp[j],
                                     px.bxx, px.xp * yp[j], yp[j] * yp[j], p);
          const bool live = T[j] >= mt;
          const float w = live ? T[j] * al : 0.0f;
          fr[j] = fr[j] + w * r[kCr];
          fg[j] = fg[j] + w * r[kCg];
          fb[j] = fb[j] + w * r[kCb];
          T[j] = live ? T[j] * (1.0f - al) : T[j];
        }
      }
    }

    // ---- cotangent gC = C - ref -------------------------------------------
    float gr[kRows], gg[kRows], gb[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const size_t i = (size_t)(px.y0 + r) * wp + px.xx;
      color[i] = fr[r];
      color[plane + i] = fg[r];
      color[2 * plane + i] = fb[r];
      gr[r] = fr[r] - ref[i];
      gg[r] = fg[r] - ref[plane + i];
      gb[r] = fb[r] - ref[2 * plane + i];
    }

    // ---- phase 1: replay from (0, 1), per-slot moment sums ---------------
    float cr[kRows], cg[kRows], cb[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      cr[r] = cg[r] = cb[r] = 0.0f;
      T[r] = 1.0f;
    }
    for (int c = 0; c < run.nb; ++c) {
      if (!walk::any_unsaturated(T, mt)) break;
      const int n_here = min(a.kc, run.n - c * a.kc);
      stage_coefs(rows, run, c, n_here, a, cx, cy, srows, scoef);
      for (int k0 = 0; k0 < n_here; k0 += kGroup) {
        const int kn = min(kGroup, n_here - k0);
        for (int kk = 0; kk < kn; ++kk) {
          const float* r = srows + (k0 + kk) * kFields;
          const float* co = scoef + (k0 + kk) * kCoefs;
          const float c_r = r[kCr], c_g = r[kCg], c_b = r[kCb];
          const float opd = nan_max(r[kOp], 1e-30f);
          // Column sums: q, q y', q y'^2, w gC per channel, q / op.
          float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, wr = 0.0f, wg = 0.0f,
                wb = 0.0f, so = 0.0f;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const float byy = yp[j] * yp[j];
            const float al = mxu_alpha(r, co, px.xx, px.y0 + j, px.xp, yp[j],
                                       px.bxx, px.xp * yp[j], byy, p);
            const bool live = T[j] >= mt;
            const float mw = live ? 1.0f : 0.0f;
            const float w = live ? T[j] * al : 0.0f;
            const float w_c = (al * T[j]) * mw;
            cr[j] = cr[j] + w * c_r;
            cg[j] = cg[j] + w * c_g;
            cb[j] = cb[j] + w * c_b;
            const float inv1ma =
                1.0f / (al >= 1.0f ? 1e-15f : 1.0f - al);
            const float dl_da = (gr[j] * (c_r * T[j] - (fr[j] - cr[j]) * inv1ma) +
                                 gg[j] * (c_g * T[j] - (fg[j] - cg[j]) * inv1ma) +
                                 gb[j] * (c_b * T[j] - (fb[j] - cb[j]) * inv1ma)) *
                                mw;
            const float q = dl_da * al;
            T[j] = live ? T[j] * (1.0f - al) : T[j];
            s0 = s0 + q;
            s1 = s1 + q * yp[j];
            s2 = s2 + q * byy;
            wr = wr + w_c * gr[j];
            wg = wg + w_c * gg[j];
            wb = wb + w_c * gb[j];
            so = so + q / opd;
          }
          // The column's moments against [x'^2, x'y', y'^2, x', y', 1].
          float v[kSums] = {s0 * px.bxx, s1 * px.xp, s2, s0 * px.xp, s1, s0,
                            wr, wg, wb, so};
          // Fixed-order warp tree, then the warps in index order below.
#pragma unroll
          for (int f = 0; f < kSums; ++f) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              v[f] += __shfl_down_sync(0xffffffffu, v[f], off);
            }
          }
          if (lane == 0) {
#pragma unroll
            for (int f = 0; f < kSums; ++f) {
              red[(warp * kGroup + kk) * kSums + f] = v[f];
            }
          }
        }
        __syncthreads();
        float* dst = tile_mom + ((size_t)c * a.kc + k0) * kSums;
        for (int i = threadIdx.x; i < kn * kSums; i += blockDim.x) {
          float acc = 0.0f;
          for (int wi = 0; wi < n_warps; ++wi) {
            acc += red[wi * kGroup * kSums + i];
          }
          dst[i] += acc;
        }
        __syncthreads();
      }
    }
  }

  // ---- combine the moments into the nine gradient fields -----------------
  __syncthreads();
  const float* tile_rows = rows + (size_t)run.s0 * kFields;
  float* tile_out = out + (size_t)run.s0 * kMoments;
  for (int k = threadIdx.x; k < a.stride; k += blockDim.x) {
    float* o = tile_out + (size_t)k * kMoments;
    if (k >= run.n) {
#pragma unroll
      for (int f = 0; f < kMoments; ++f) o[f] = 0.0f;
      continue;
    }
    const float* r = tile_rows + (size_t)k * kFields;
    const float* m = tile_mom + (size_t)k * kSums;
    const float m_xx = m[0], m_xy = m[1], m_yy = m[2], m_x = m[3],
                m_y = m[4], m_1 = m[5];
    const float sa = r[kA], sb = r[kB], sd = r[kD];
    const float sx = r[kSx], sy = r[kSy], cs = r[kCos], sn = r[kSin];
    const float ex = r[kPx] - cx;
    const float ey = r[kPy] - cy;
    const float s_x = m_x - ex * m_1;
    const float s_y = m_y - ey * m_1;
    const float s_xx = m_xx - 2.0f * ex * m_x + ex * ex * m_1;
    const float s_yy = m_yy - 2.0f * ey * m_y + ey * ey * m_1;
    const float s_xy = m_xy - ex * m_y - ey * m_x + ex * ey * m_1;
    const float inv_sx3 = 1.0f / (sx * sx * sx);
    const float inv_sy3 = 1.0f / (sy * sy * sy);
    const float rot_k = (sx * sx - sy * sy) / (sx * sx * sy * sy);
    o[0] = sa * s_x + sb * s_y;
    o[1] = sd * s_y + sb * s_x;
    o[2] = inv_sx3 *
           (cs * cs * s_xx + 2.0f * sn * cs * s_xy + sn * sn * s_yy);
    o[3] = inv_sy3 *
           (sn * sn * s_xx - 2.0f * sn * cs * s_xy + cs * cs * s_yy);
    o[4] = rot_k * ((cs * cs - sn * sn) * s_xy - sn * cs * (s_xx - s_yy));
    o[5] = m[6];
    o[6] = m[7];
    o[7] = m[8];
    o[8] = m[9];
  }
}


// ---- kernel 13 on warp patches -------------------------------------------

using patch::Patch;
using patch::PatchGrid;
using patch::Slot;

// A patch's tile-centred coordinates: the tile centre (cx, cy), the lane's
// x' and x'^2, and y' of the patch's rows (the chunk walk's PassPixels).
struct PatchFrame {
  float cx, cy, xp, bxx;
  float yp[kRows];
};

__device__ __forceinline__ PatchFrame patch_frame(const Patch& c,
                                                  const RenderArgs& p) {
  const int tile_x0 = (c.tile % p.n_tiles_x) * p.tile_w;
  const int tile_y0 = (c.tile / p.n_tiles_x) * p.tile_h;
  PatchFrame f;
  f.cx = (float)tile_x0 + 0.5f * (float)p.tile_w;
  f.cy = (float)tile_y0 + 0.5f * (float)p.tile_h;
  f.xp = ((float)(c.xx - tile_x0) + 0.5f) - 0.5f * (float)p.tile_w;
  f.bxx = f.xp * f.xp;
  const int row0 = c.y0 - tile_y0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    f.yp[r] = ((float)(row0 + r) + 0.5f) - 0.5f * (float)p.tile_h;
  }
  return f;
}

// The six coefficients of a broadcast splat in the tile's centred
// coordinates (stage_coefs' expressions).
__device__ __forceinline__ void coefs_of(const Splat& s, const PatchFrame& f,
                                         float (&co)[kCoefs]) {
  const float ex = s.px - f.cx;
  const float ey = s.py - f.cy;
  co[0] = s.a;
  co[1] = 2.0f * s.b;
  co[2] = s.d;
  co[3] = -2.0f * (s.a * ex + s.b * ey);
  co[4] = -2.0f * (s.d * ey + s.b * ex);
  co[5] = s.a * ex * ex + 2.0f * s.b * ex * ey + s.d * ey * ey;
}

// Coverage-masked alpha of a broadcast slot at this lane's pixel in patch
// row r (mxu_alpha, its cover read from the slot's spans).
__device__ __forceinline__ float patch_alpha(const Slot& b,
                                             const float (&co)[kCoefs],
                                             const PatchFrame& f, int r,
                                             int lane, const RenderArgs& p) {
  const float yp = f.yp[r];
  const float bxy = f.xp * yp;
  const float byy = yp * yp;
  const float d2 = ((co[0] * f.bxx + co[3] * f.xp) + co[5]) +
                   ((co[2] * byy + co[4] * yp) + co[1] * bxy);
  const float g = exp_term(-0.5f * d2, p.use_exp_approx);
  return patch::covered(b, r, lane) ? g * b.s.op : 0.0f;
}

// One phase-0 step of the patch's 8 pixels: the early-out on T alone, the
// alpha masked by the cover.
__device__ __forceinline__ void mxu_fwd_step(
    const Slot& b, const PatchFrame& f, int lane, const RenderArgs& p,
    float (&fr)[kRows], float (&fg)[kRows], float (&fb)[kRows],
    float (&T)[kRows]) {
  float co[kCoefs];
  coefs_of(b.s, f, co);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float al = patch_alpha(b, co, f, r, lane, p);
    fwd_step(b.s, T[r] >= p.min_throughput, al, fr[r], fg[r], fb[r], T[r]);
  }
}

// One phase-1 step of the patch's 8 pixels over a broadcast slot: the
// chunk walk's replay, column sums in row order, the x' monomials and the
// fixed-order warp tree; lane 0 writes the slot's 10 sums to dst.
__device__ __forceinline__ void mxu_replay_step(
    const Slot& b, const PatchFrame& f, int lane, const RenderArgs& p,
    const float (&fr)[kRows], const float (&fg)[kRows],
    const float (&fb)[kRows], const float (&gr)[kRows],
    const float (&gg)[kRows], const float (&gb)[kRows], float (&cr)[kRows],
    float (&cg)[kRows], float (&cb)[kRows], float (&T)[kRows],
    float* __restrict__ dst) {
  float co[kCoefs];
  coefs_of(b.s, f, co);
  const float mt = p.min_throughput;
  const float c_r = b.s.cr, c_g = b.s.cg, c_b = b.s.cb;
  const float opd = nan_max(b.s.op, 1e-30f);
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, wr = 0.0f, wg = 0.0f, wb = 0.0f,
        so = 0.0f;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const float byy = f.yp[j] * f.yp[j];
    const float al = patch_alpha(b, co, f, j, lane, p);
    const bool live = T[j] >= mt;
    const float mw = live ? 1.0f : 0.0f;
    const float w = live ? T[j] * al : 0.0f;
    const float w_c = (al * T[j]) * mw;
    cr[j] = cr[j] + w * c_r;
    cg[j] = cg[j] + w * c_g;
    cb[j] = cb[j] + w * c_b;
    const float inv1ma = 1.0f / (al >= 1.0f ? 1e-15f : 1.0f - al);
    const float dl_da = (gr[j] * (c_r * T[j] - (fr[j] - cr[j]) * inv1ma) +
                         gg[j] * (c_g * T[j] - (fg[j] - cg[j]) * inv1ma) +
                         gb[j] * (c_b * T[j] - (fb[j] - cb[j]) * inv1ma)) *
                        mw;
    const float q = dl_da * al;
    T[j] = live ? T[j] * (1.0f - al) : T[j];
    s0 = s0 + q;
    s1 = s1 + q * f.yp[j];
    s2 = s2 + q * byy;
    wr = wr + w_c * gr[j];
    wg = wg + w_c * gg[j];
    wb = wb + w_c * gb[j];
    so = so + q / opd;
  }
  float v[kSums] = {s0 * f.bxx, s1 * f.xp, s2, s0 * f.xp, s1, s0,
                    wr, wg, wb, so};
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kSums; ++i) dst[i] = v[i];
  }
}

// Kernel 13's patch: phase 0 (T from 1 on every pixel) with its exit, the
// colour written to color (3, Hp, Wp), gC = C - ref, then phase 1 from (0,
// 1) over the forward's survivors, slot k's 10 sums written to partial
// (n_tiles, K, n_pass, warps per pass, 10), +0.0 where the walk skips;
// walked, when set, gets the forward's (survivors, survivors walked).
__global__ void __launch_bounds__(patch::kPatchWarps * 32)
l2_mxu_kernel(const float* __restrict__ rows, const int* __restrict__ count,
              const float* __restrict__ ref, float* __restrict__ color,
              float* __restrict__ partial, int* __restrict__ walked,
              RenderArgs p, PatchGrid g) {
  const Patch c = patch::patch_of(p, g);
  if (!c.active) return;
  const patch::DenseRun run{rows, p.k_cap};
  const int n = count[c.tile];
  const PatchFrame f = patch_frame(c, p);
  float fr[kRows], fg[kRows], fb[kRows], T[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    fr[r] = fg[r] = fb[r] = 0.0f;
    T[r] = 1.0f;
  }
  int n_survivors, n_walked;
  const int n_full = patch::fwd_walk(
      run, n, c, p, T,
      [&](const Slot& b) { mxu_fwd_step(b, f, c.lane, p, fr, fg, fb, T); },
      n_survivors, n_walked);

  const size_t wp = (size_t)p.n_tiles_x * p.tile_w;
  const size_t plane = (size_t)p.n_tiles_y * p.tile_h * wp;
  float gr[kRows], gg[kRows], gb[kRows], cr[kRows], cg[kRows], cb[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const size_t i = (size_t)(c.y0 + r) * wp + c.xx;
    color[i] = fr[r];
    color[plane + i] = fg[r];
    color[2 * plane + i] = fb[r];
    gr[r] = fr[r] - ref[i];
    gg[r] = fg[r] - ref[plane + i];
    gb[r] = fb[r] - ref[2 * plane + i];
    cr[r] = cg[r] = cb[r] = 0.0f;
    T[r] = 1.0f;
  }
  const bool bad = patch::any_nonfinite(fr) || patch::any_nonfinite(fg) ||
                   patch::any_nonfinite(fb) || patch::any_nonfinite(gr) ||
                   patch::any_nonfinite(gg) || patch::any_nonfinite(gb);
  int replay_survivors, replay_walked;
  patch::replay_walk<false, kSums>(
      run, n, n_full, c, p, bad,
      [&](const Slot& b, float* dst) {
        mxu_replay_step(b, f, c.lane, p, fr, fg, fb, gr, gg, gb, cr, cg, cb,
                        T, dst);
      },
      [&] {
        return patch::any_nonfinite(cr) || patch::any_nonfinite(cg) ||
               patch::any_nonfinite(cb) || patch::any_nonfinite(T);
      },
      [] { return false; }, patch::patch_partial(partial, c, g, p, kSums),
      patch::slot_stride(g, kSums), replay_survivors, replay_walked);
  patch::record_walk(walked, c, g, n_survivors, n_walked);
}

// Kernel 13's patch sum and combine, one thread per (tile, slot): the
// slot's 10 sums added from l2_mxu_kernel's partials as the chunk walk adds
// them (per pass the warps in index order from +0.0, then the passes in
// order onto +0.0), combined into the nine fields of out (n_tiles, K, 9)
// with the chunk walk's expressions; zero rows past each tile's count.
__global__ void mxu_combine_kernel(const float* __restrict__ rows,
                                   const int* __restrict__ count,
                                   const float* __restrict__ partial,
                                   float* __restrict__ out, RenderArgs p,
                                   PatchGrid g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_tiles_x * p.n_tiles_y * p.k_cap) return;
  const int tile = i / p.k_cap;
  float* o = out + (size_t)i * kMoments;
  if (i % p.k_cap >= count[tile]) {
#pragma unroll
    for (int k = 0; k < kMoments; ++k) o[k] = 0.0f;
    return;
  }
  const int wpp = g.ngrp * g.ncg;
  const float* src = partial + (size_t)i * g.n_pass * wpp * kSums;
  float m[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float total = 0.0f;
    for (int ps = 0; ps < g.n_pass; ++ps) {
      float acc = 0.0f;
      for (int wi = 0; wi < wpp; ++wi) acc += src[(ps * wpp + wi) * kSums + k];
      total += acc;
    }
    m[k] = total;
  }
  const float cx = (float)((tile % p.n_tiles_x) * p.tile_w) +
                   0.5f * (float)p.tile_w;
  const float cy = (float)((tile / p.n_tiles_x) * p.tile_h) +
                   0.5f * (float)p.tile_h;
  const float* r = rows + (size_t)i * kFields;
  const float m_xx = m[0], m_xy = m[1], m_yy = m[2], m_x = m[3], m_y = m[4],
              m_1 = m[5];
  const float sa = r[kA], sb = r[kB], sd = r[kD];
  const float sx = r[kSx], sy = r[kSy], cs = r[kCos], sn = r[kSin];
  const float ex = r[kPx] - cx;
  const float ey = r[kPy] - cy;
  const float s_x = m_x - ex * m_1;
  const float s_y = m_y - ey * m_1;
  const float s_xx = m_xx - 2.0f * ex * m_x + ex * ex * m_1;
  const float s_yy = m_yy - 2.0f * ey * m_y + ey * ey * m_1;
  const float s_xy = m_xy - ex * m_y - ey * m_x + ex * ey * m_1;
  const float inv_sx3 = 1.0f / (sx * sx * sx);
  const float inv_sy3 = 1.0f / (sy * sy * sy);
  const float rot_k = (sx * sx - sy * sy) / (sx * sx * sy * sy);
  o[0] = sa * s_x + sb * s_y;
  o[1] = sd * s_y + sb * s_x;
  o[2] = inv_sx3 * (cs * cs * s_xx + 2.0f * sn * cs * s_xy + sn * sn * s_yy);
  o[3] = inv_sy3 * (sn * sn * s_xx - 2.0f * sn * cs * s_xy + cs * cs * s_yy);
  o[4] = rot_k * ((cs * cs - sn * sn) * s_xy - sn * cs * (s_xx - s_yy));
  o[5] = m[6];
  o[6] = m[7];
  o[7] = m[8];
  o[8] = m[9];
}

}  // namespace mxu
}  // namespace gs2d

extern "C" {

// Kernel 13, its patch sum and combine, and the segment sum. rows is the
// dense binning's (n_tiles, K, 16) tile_params, ids (n_tiles, K), count
// (n_tiles,); ref and color are (3, Hp, Wp); partial is (n_tiles, K,
// patches per tile, 10) scratch, read only where the patch kernel wrote it;
// out is (n_tiles, K, 9); grads9 is (9, n_splats); walked is null or
// (patches, 2). Returns cudaGetLastError().
int gs2d_l2_mxu(const float* rows, const int* ids, const int* count,
                const float* ref, float* color, float* partial, float* out,
                float* grads9, int* walked, int n_splats, int height,
                int width, int tile_h, int tile_w, int n_tiles_x,
                int n_tiles_y, int k_cap, float cutoff_sq,
                float min_throughput, int use_exp_approx, void* stream) {
  using namespace gs2d;
  walk::WalkArgs a;
  if (patch::patch_args(height, width, tile_h, tile_w, n_tiles_x, n_tiles_y,
                        k_cap, cutoff_sq, min_throughput, use_exp_approx,
                        &a) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const patch::PatchGrid g = patch::patch_grid(a);
  cudaStream_t s = (cudaStream_t)stream;
  mxu::l2_mxu_kernel<<<patch::patch_blocks(a, g), patch::kPatchWarps * 32, 0,
                       s>>>(rows, count, ref, color, partial, walked, a.p, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = n_tiles_x * n_tiles_y;
  const int slots = n_tiles * k_cap;
  mxu::mxu_combine_kernel<<<(slots + 127) / 128, 128, 0, s>>>(
      rows, count, partial, out, a.p, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_segment_sum(ids, count, out, grads9, n_tiles, k_cap,
                            n_splats, n_splats, s);
}

// The reference (l2_mxu_chunk_kernel) and the segment sum, with kernel 13's
// arguments before its warp patches. rows is the dense binning's (n_tiles, K,
// 16) tile_params, ids (n_tiles, K), count (n_tiles,); ref and color are
// (3, Hp, Wp); mom is (n_tiles, K, 10) scratch zeroed by the caller; out is
// (n_tiles, K, 9); grads9 is (9, n_splats). kc divides K. Returns
// cudaGetLastError().
int gs2d_l2_mxu_chunk(const float* rows, const int* ids, const int* count,
                      const float* ref, float* color, float* mom, float* out,
                      float* grads9, int n_splats, int height, int width,
                      int tile_h, int tile_w, int n_tiles_x, int n_tiles_y,
                      int k_cap, int kc, float cutoff_sq,
                      float min_throughput, int use_exp_approx,
                      void* stream) {
  using namespace gs2d;
  if (kc <= 0 || k_cap % kc) return (int)cudaErrorInvalidValue;
  walk::WalkArgs a;
  const int threads = walk::walk_args(
      height, width, tile_h, tile_w, n_tiles_x, n_tiles_y, kc, k_cap / kc, 0,
      k_cap, cutoff_sq, min_throughput, use_exp_approx, &a);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = n_tiles_x * n_tiles_y;
  const size_t smem =
      sizeof(float) * ((size_t)kc * (kFields + mxu::kCoefs) +
                       (size_t)(threads / 32) * mxu::kGroup * mxu::kSums);
  cudaError_t err = cudaFuncSetAttribute(
      mxu::l2_mxu_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  mxu::l2_mxu_chunk_kernel<<<n_tiles, threads, smem, s>>>(
      rows, count, ref, color, mom, out, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_segment_sum(ids, count, out, grads9, n_tiles, k_cap,
                            n_splats, n_splats, s);
}

}  // extern "C"
