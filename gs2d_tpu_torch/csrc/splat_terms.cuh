// Shared device code of the rasterizer kernels (render_resident.cu,
// render_flat.cu, render_dense.cu).
//
// CUDA counterparts of gs2d_tpu/ops/render_pallas.py's shared kernel math:
//   splat_terms   <- _splat_terms    (coverage, G, alpha, early-out mask)
//   fwd_one       <- _fwd_one        (one front-to-back composite step)
//   bwd_one       <- _bwd_splat_step (cotangent-weighted replay, z-moments)
//   Moments       <- _moment_reduce  (separable reduction of 9 tile sums)
//   add_run_moments: one tile's share of the splat-axis segment sum (the
//   JAX package scatters with XLA here; this is its deterministic form)
// Their plain PyTorch twin is gs2d_tpu_torch/ops/render.py.
//
// Numerics: the float32 operation order follows the Pallas code line by
// line, and the library is built with -fmad=false and without fast math, so
// no product is contracted into an FMA and no division or sqrt is
// approximated. The 1 - alpha guard stays in select form (never
// `1 - alpha + 1e-15`, which reassociates to 0 at alpha == 1). jnp.minimum
// and jnp.maximum propagate NaN where fminf/fmaxf drop it, so the root
// bounds use nan_min/nan_max; trunc_i32 gives XLA's NaN -> 0.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gs2d {

// Packed table row layout (gs2d_tpu_torch/ops/tiles.py FIELD_*).
constexpr int kFields = 16;
constexpr int kMoments = 9;  // moment rows G_PX..G_OP (ops/render.py)
constexpr int kPx = 0, kPy = 1, kA = 2, kB = 3, kD = 4, kH = 5;
constexpr int kCr = 6, kCg = 7, kCb = 8, kOp = 9;
constexpr int kSx = 10, kSy = 11, kCos = 12, kSin = 13;  // cos, sin of rot

// Fast-exp flush threshold (gs2d_tpu_torch/config.py EXP_APPROX_FLUSH).
constexpr float kExpFlush = 0.00001814586175896693021059036255f;

// Per-launch constants.
struct RenderArgs {
  int height, width;        // image
  int tile_h, tile_w;       // tile shape
  int n_tiles_x, n_tiles_y;
  int k_cap;                // per-tile list capacity K (ids row stride)
  float cutoff_sq;          // splat_bounds^2
  float min_throughput;     // per-pixel early-out threshold on T
  int use_exp_approx;
  int row_off;              // image row of the launch's first pixel row: a
                            // band's first row, 0 for the whole image
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// C-style truncation toward zero; saturating, NaN -> 0 (XLA's convert).
__device__ __forceinline__ int trunc_i32(float x) {
  return isnan(x) ? 0 : __float2int_rz(x);
}

// Reference fast exp (1 + x/8)^8 with the flush-to-zero guard
// (main.cpp:49-83); exact expf in validation mode.
__device__ __forceinline__ float exp_term(float x, int use_approx) {
  if (!use_approx) return expf(x);
  x = 1.0f + x * 0.125f;
  const bool flush = x < kExpFlush;
  x = x * x;
  x = x * x;
  x = x * x;
  return flush ? 0.0f : x;
}

// One splat's scalars, read from a packed row in shared memory.
struct Splat {
  float px, py, a, b, d, cr, cg, cb, op;
  int beg_y, end_y;  // row walk [trunc(py - h), trunc(py + h)]
};

__device__ __forceinline__ Splat load_splat(const float* row) {
  Splat s;
  s.px = row[kPx];
  s.py = row[kPy];
  s.a = row[kA];
  s.b = row[kB];
  s.d = row[kD];
  s.cr = row[kCr];
  s.cg = row[kCg];
  s.cb = row[kCb];
  s.op = row[kOp];
  const float h = row[kH];
  s.beg_y = trunc_i32(s.py - h);
  s.end_y = trunc_i32(s.py + h);
  return s;
}

// Exact per-row x interval of a splat from the ellipse quadratic
// (main.cpp:497-509) at vy = (row centre) - py: returns whether the row
// meets the ellipse at all (disc >= 0) and writes the columns [beg_x, end_x]
// it covers there. splat_terms and the resident kernels' per-warp cull
// (render_resident.cu) both call it, so they decide coverage on the same
// bits.
__device__ __forceinline__ bool row_interval(const Splat& s, float vy,
                                             const RenderArgs& p, int& beg_x,
                                             int& end_x) {
  const float qb = 2.0f * s.b * vy;
  const float qc = s.d * vy * vy - p.cutoff_sq;
  const float disc = qb * qb - 4.0f * s.a * qc;
  const float sq = sqrtf(nan_max(disc, 0.0f));
  const float sgn = qb < 0.0f ? -1.0f : 1.0f;
  const float kq = (-qb - sgn * sq) * 0.5f;
  const float r0 = kq / s.a;
  const float r1 = qc / kq;
  beg_x = trunc_i32(s.px + nan_min(r0, r1));
  end_x = trunc_i32(s.px + nan_max(r0, r1));
  return disc >= 0.0f;
}

// The Gaussian term of splat s at offset (vx, vy) from its centre, times
// its opacity (_splat_terms' alpha).
__device__ __forceinline__ float gauss_alpha(const Splat& s, float vx,
                                             float vy, const RenderArgs& p) {
  const float d2 = s.a * vx * vx + 2.0f * s.b * vx * vy + s.d * vy * vy;
  return exp_term(-0.5f * d2, p.use_exp_approx) * s.op;
}

// Coverage + alpha of one splat at one pixel (_splat_terms). Returns live;
// alpha, vx, vy are written through.
__device__ __forceinline__ bool splat_terms(const Splat& s, int xx, int yy,
                                            float fx, float fy, bool inside,
                                            float T, const RenderArgs& p,
                                            float& alpha, float& vx,
                                            float& vy) {
  vy = fy - s.py;
  vx = fx - s.px;
  const bool row_ok = (yy >= s.beg_y) && (yy <= s.end_y);
  int beg_x, end_x;
  const bool q_ok = row_interval(s, vy, p, beg_x, end_x);
  const bool col_ok = (xx >= beg_x) && (xx <= end_x);
  const bool cover = row_ok && q_ok && col_ok && inside;
  alpha = gauss_alpha(s, vx, vy, p);
  return cover && (T >= p.min_throughput);
}

// The composite step of a pixel whose live flag and alpha are known.
__device__ __forceinline__ void fwd_step(const Splat& s, bool live,
                                         float alpha, float& cr, float& cg,
                                         float& cb, float& T) {
  const float w = live ? T * alpha : 0.0f;
  cr = cr + w * s.cr;
  cg = cg + w * s.cg;
  cb = cb + w * s.cb;
  T = live ? T * (1.0f - alpha) : T;
}

// One front-to-back composite step at one pixel (_fwd_one).
__device__ __forceinline__ void fwd_one(const Splat& s, int xx, int yy,
                                        float fx, float fy, bool inside,
                                        const RenderArgs& p, float& cr,
                                        float& cg, float& cb, float& T) {
  float alpha, vx, vy;
  const bool live = splat_terms(s, xx, yy, fx, fy, inside, T, p, alpha, vx,
                                vy);
  fwd_step(s, live, alpha, cr, cg, cb, T);
}

// A thread's running column sums for one splat (_moment_reduce, first
// stage): the thread owns pixels of one column, so vx is constant over them
// and the x monomials apply once, in Moments::finish.
struct Moments {
  float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;  // sum z, z*vy, z*vy^2
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;  // sum gc_ch * w_c

  // Rows in G_PX..G_OP order: [M1, M2, M3, M4, M5, CR, CG, CB, M0].
  __device__ __forceinline__ void finish(float vx, float out[9]) const {
    const float r0x = r0 * vx;
    out[0] = r0x;
    out[1] = r1;
    out[2] = r0x * vx;
    out[3] = r1 * vx;
    out[4] = r2;
    out[5] = cr;
    out[6] = cg;
    out[7] = cb;
    out[8] = r0;
  }
};

// The replay step of a pixel whose live flag, alpha and vy are known.
__device__ __forceinline__ void bwd_step(const Splat& s, bool live,
                                         float alpha, float vy, float gc_r,
                                         float gc_g, float gc_b, float gf,
                                         float& ga, float& T, Moments& m) {
  const float mw = live ? 1.0f : 0.0f;
  const float w_c = alpha * T * mw;
  const float gcdot = gc_r * s.cr + gc_g * s.cg + gc_b * s.cb;
  ga = ga + w_c * gcdot;
  const float inv1ma = 1.0f / (alpha >= 1.0f ? 1e-15f : 1.0f - alpha);
  const float dl_da = (T * gcdot - (gf - ga) * inv1ma) * mw;
  const float z = dl_da * alpha;
  const float zvy = z * vy;
  m.r0 = m.r0 + z;
  m.r1 = m.r1 + zvy;
  m.r2 = m.r2 + zvy * vy;
  m.cr = m.cr + gc_r * w_c;
  m.cg = m.cg + gc_g * w_c;
  m.cb = m.cb + gc_b * w_c;
  T = live ? T * (1.0f - alpha) : T;
}

// One splat's backward step at one pixel (_bwd_splat_step): replay the
// composite with the cotangent-weighted prefix ga and add the pixel's terms
// to the thread's moment sums.
__device__ __forceinline__ void bwd_one(const Splat& s, int xx, int yy,
                                        float fx, float fy, bool inside,
                                        const RenderArgs& p, float gc_r,
                                        float gc_g, float gc_b, float gf,
                                        float& ga, float& T, Moments& m) {
  float alpha, vx, vy;
  const bool live = splat_terms(s, xx, yy, fx, fy, inside, T, p, alpha, vx,
                                vy);
  bwd_step(s, live, alpha, vy, gc_r, gc_g, gc_b, gf, ga, T, m);
}

// The slot of splat i in one tile's run, or -1: run_ids holds the run's n
// splat ids in ascending order (index order; padding never lies inside a
// run), so a binary search finds the one match, if any.
// add_run_moments adds to acc the moment row of splat i in the run, run_mom
// holding the run's n x kMoments moment rows. Called for tiles in ascending
// order, it sums each splat's rows in a fixed order without atomics.
__device__ __forceinline__ int find_in_run(const int* run_ids, int n, int i) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (run_ids[mid] < i) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return (lo < n && run_ids[lo] == i) ? lo : -1;
}

__device__ __forceinline__ void add_run_moments(const int* run_ids, int n,
                                                const float* run_mom, int i,
                                                float acc[kMoments]) {
  const int slot = find_in_run(run_ids, n, i);
  if (slot >= 0) {
    const float* src = run_mom + (size_t)slot * kMoments;
#pragma unroll
    for (int f = 0; f < kMoments; ++f) acc[f] += src[f];
  }
}

// Launches the tile-order segment sum of (n_tiles, k_cap, 9) per-(tile,
// slot) moment partials (ids (n_tiles, k_cap), the first count[t] of each
// row ascending) into rows 0..8 of grads (row stride n_pad); defined in
// render_resident.cu, shared by the resident and dense backward kernels.
// Returns cudaGetLastError().
int launch_segment_sum(const int* ids, const int* count,
                       const float* partial, float* grads, int n_tiles,
                       int k_cap, int n_splats, int n_pad,
                       cudaStream_t stream);

}  // namespace gs2d
