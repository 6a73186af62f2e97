// The flat binning's pair expansion for Hopper (sm_90a), bound with ctypes
// through a plain C interface (gs2d_tpu_torch/ops/_build.py).
//
// The stage gs2d.bin_flat.expand of ops/tiles_flat.py::bin_splats_flat, for
// CUDA tensors (its plain twin, tiles_flat._expand_plain, runs on the CPU):
// splat i owns cnt[i] consecutive rows of the (m_cap,) pair arrays from
// starts[i] = cnt[0] + ... + cnt[i-1], one row per tile of its clamped tile
// box in row-major order (cnt 0 where the splat is off screen or off the
// band). Row e of splat i holds tile_e[e] = ty * n_tiles_x + tx and
// splat_e[e] = i where the (splat, tile) pair passes the exact ellipse-rect
// cull; every other row of the m_cap (culled, past the total, or empty)
// holds the dead tile n_tiles and -1. Rows past m_cap are not written; their
// number is dropped_exp.
//
// Three launches in place of the plain twin's chain of eager operations:
//   expand_count_kernel: one thread a splat computes its tile box and cnt.
//   torch.cumsum of cnt (the wrapper's): incl[i] = starts[i + 1].
//   expand_emit_kernel: a block of kEmitThreads threads owns as many
//   consecutive splats. Each thread computes one splat's box and its start
//   incl[i - 1] into shared memory; then the block walks the rows of the
//   block's runs kEmitThreads at a time (coalesced writes), each thread
//   taking its row's owner from the shared starts (the last splat whose run
//   starts at or before the row, as searchsorted(starts[1:], e, right=True)
//   gives it where empty splats' starts coincide) by an 8-probe search.
//   Every thread of the grid then fills the dead rows [total, m_cap).
// Both kernels compute a splat's box with one device function (splat_box),
// so the counts and the emitted rows agree; nothing is staged between them
// but cnt and its scan.
//
// Numerics: bit for bit what the plain twin's PyTorch operations give on
// CUDA tensors. Each float32 operation of tiles._bbox_and_quad and
// tiles.tile_may_touch in its order, built with -fmad=false and without fast
// math (no contraction, IEEE division and sqrt); cosf and sinf are the CUDA
// math library's, which PyTorch's cos and sin call; torch.minimum and
// torch.maximum propagate NaN (nan_min / nan_max), the float to int32
// conversion is XLA's (trunc_i32: NaN -> 0, saturating), integer division
// floors. PyTorch's CUDA division of a tensor by a host scalar multiplies
// by the scalar's float32 reciprocal, so the opacity cull's shrink
// sqrt(max(k2, 0)) / bounds is a product with inv_bounds here. The cull's
// per-splat cutoff k2, where given, is the wrapper's (tiles.cull_cutoff),
// computed by the plain PyTorch operations.
//
// What bounds it on the card: bytes. It reads the splats' positions,
// scales and rotations twice (20 bytes a splat a pass, and k2) and cnt and
// its scan, and writes 8 bytes a row of the m_cap.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "splat_terms.cuh"

namespace gs2d {
namespace expand {

constexpr int kCountThreads = 256;
constexpr int kEmitThreads = 256;  // a power of two: the owner search
constexpr int kPadRowsPerThread = 8;

// Per-launch constants.
struct ExpandArgs {
  int n;                     // splats
  int m_cap;                 // rows of tile_e and splat_e
  int width, height;         // image
  int tile_w, tile_h;
  int n_tiles_x, n_tiles_y;  // the whole image's tile grid
  int band_row0, band_rows;  // the band's first tile row and its rows
  int exact_cull;
  float bounds;              // cfg.splat_bounds
  float inv_bounds;          // float32(1) / float32(bounds)
  float margin;              // footprint slack in pixels (0: none)
  float rel_margin;          // tiles.CULL_REL_MARGIN as float32
  float abs_margin;          // tiles.CULL_ABS_MARGIN as float32
  float limit;               // float32(cutoff_sq) + abs_margin, where no k2
};

// Floor division (torch.div's rounding_mode="floor" on int32).
__device__ __forceinline__ int floor_div(int v, int d) {
  const int q = v / d;
  return (v % d != 0 && v < 0) ? q - 1 : q;
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// One splat's band-local tile box and the inverse-covariance quadratic of
// its cull: tiles._bbox_and_quad, then tiles._band_clip and the count.
struct SplatBox {
  int tx0, ty0, w_t, cnt;
  float px, py, a, b, d, k2;
};

__device__ __forceinline__ SplatBox splat_box(const float* __restrict__ pos,
                                              const float* __restrict__ sx,
                                              const float* __restrict__ sy,
                                              const float* __restrict__ rot,
                                              const float* __restrict__ k2,
                                              int i, const ExpandArgs& x) {
  SplatBox s;
  s.px = pos[2 * i];
  s.py = pos[2 * i + 1];
  // geometry.cov_of, inv_cov_of, bbox_half_height / _width.
  const float r = rot[i];
  const float c = cosf(r);
  const float sn = sinf(r);
  const float l0 = sx[i] * sx[i];
  const float l1 = sy[i] * sy[i];
  const float s11 = l0 * c * c + l1 * sn * sn;
  const float s12 = (l0 - l1) * sn * c;
  const float s22 = l0 + l1 - s11;
  const float det = s11 * s22 - s12 * s12;
  s.a = s22 / det;
  s.b = -s12 / det;
  s.d = s11 / det;
  float hy = sqrtf(s.a * det) * x.bounds;
  float hx = sqrtf(s.d * det) * x.bounds;
  s.k2 = 0.0f;
  if (k2 != nullptr) {
    s.k2 = k2[i];
    const float shrink = sqrtf(nan_max(s.k2, 0.0f)) * x.inv_bounds;
    hy = hy * shrink;
    hx = hx * shrink;
  }
  if (x.margin != 0.0f) {
    hy = hy + x.margin;
    hx = hx + x.margin;
  }
  const int x0 = trunc_i32(s.px - hx), x1 = trunc_i32(s.px + hx);
  const int y0 = trunc_i32(s.py - hy), y1 = trunc_i32(s.py + hy);
  const int tx0 = clamp_int(floor_div(x0, x.tile_w), 0, x.n_tiles_x - 1);
  const int tx1 = clamp_int(floor_div(x1, x.tile_w), 0, x.n_tiles_x - 1);
  int ty0 = clamp_int(floor_div(y0, x.tile_h), 0, x.n_tiles_y - 1);
  int ty1 = clamp_int(floor_div(y1, x.tile_h), 0, x.n_tiles_y - 1);
  bool off = (x1 < 0) || (x0 >= x.width) || (y1 < 0) || (y0 >= x.height);
  if (k2 != nullptr) off = off || (s.k2 <= 0.0f);
  // The band (the whole grid from row 0 leaves the box as it is).
  off = off || (ty1 < x.band_row0) || (ty0 > x.band_row0 + (x.band_rows - 1));
  ty0 = clamp_int(ty0 - x.band_row0, 0, x.band_rows - 1);
  ty1 = clamp_int(ty1 - x.band_row0, 0, x.band_rows - 1);
  s.tx0 = tx0;
  s.ty0 = ty0;
  s.w_t = tx1 - tx0 + 1;
  s.cnt = off ? 0 : s.w_t * (ty1 - ty0 + 1);
  return s;
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return nan_min(nan_max(v, lo), hi);
}

// The quadratic at vx = cx, minimised over vy in [ry0, ry1].
__device__ __forceinline__ float edge_vx(float a, float b, float d, float cx,
                                         float ry0, float ry1, float rel) {
  const float vy = clip(-b * cx / d, ry0, ry1);
  const float t1 = a * cx * cx;
  const float t2 = 2.0f * b * cx * vy;
  const float t3 = d * vy * vy;
  return (t1 + t2 + t3) - rel * (fabsf(t1) + fabsf(t2) + fabsf(t3));
}

// The quadratic at vy = ry, minimised over vx in [rx0, rx1].
__device__ __forceinline__ float edge_vy(float a, float b, float d, float ry,
                                         float rx0, float rx1, float rel) {
  const float vx = clip(-b * ry / a, rx0, rx1);
  const float t1 = a * vx * vx;
  const float t2 = 2.0f * b * vx * ry;
  const float t3 = d * ry * ry;
  return (t1 + t2 + t3) - rel * (fabsf(t1) + fabsf(t2) + fabsf(t3));
}

// tiles.tile_may_touch of one (splat, tile) pair, tile row tyg of the
// image; limit is the cutoff plus the absolute slack.
__device__ __forceinline__ bool tile_may_touch(float px, float py, float a,
                                               float b, float d, int tx,
                                               int tyg, float limit,
                                               const ExpandArgs& x) {
  const bool healthy = isfinite(px) && isfinite(py) && isfinite(b) &&
                       (a > 0.0f) && (d > 0.0f) && isfinite(a) && isfinite(d);
  if (!healthy) return true;
  const float x_edge = (float)(tx * x.tile_w);
  const float y_edge = (float)(tyg * x.tile_h);
  float rx0 = x_edge - 1.0f - px;
  float rx1 = x_edge + (float)x.tile_w - px;
  float ry0 = y_edge + 0.5f - py;
  float ry1 = y_edge + (float)x.tile_h - 0.5f - py;
  if (x.margin != 0.0f) {
    rx0 = rx0 - x.margin;
    rx1 = rx1 + x.margin;
    ry0 = ry0 - x.margin;
    ry1 = ry1 + x.margin;
  }
  if ((rx0 <= 0.0f) && (0.0f <= rx1) && (ry0 <= 0.0f) && (0.0f <= ry1)) {
    return true;  // the centre lies in the rect
  }
  const float rel = x.rel_margin;
  const float qmin =
      nan_min(nan_min(edge_vx(a, b, d, rx0, ry0, ry1, rel),
                      edge_vx(a, b, d, rx1, ry0, ry1, rel)),
              nan_min(edge_vy(a, b, d, ry0, rx0, rx1, rel),
                      edge_vy(a, b, d, ry1, rx0, rx1, rel)));
  return qmin <= limit;
}

__global__ void __launch_bounds__(kCountThreads)
expand_count_kernel(const float* __restrict__ pos,
                    const float* __restrict__ sx,
                    const float* __restrict__ sy,
                    const float* __restrict__ rot,
                    const float* __restrict__ k2, int* __restrict__ cnt,
                    ExpandArgs x) {
  const int i = blockIdx.x * kCountThreads + threadIdx.x;
  if (i >= x.n) return;
  cnt[i] = splat_box(pos, sx, sy, rot, k2, i, x).cnt;
}

__global__ void __launch_bounds__(kEmitThreads)
expand_emit_kernel(const float* __restrict__ pos,
                   const float* __restrict__ sx, const float* __restrict__ sy,
                   const float* __restrict__ rot,
                   const float* __restrict__ k2,
                   const int* __restrict__ incl, int* __restrict__ tile_e,
                   int* __restrict__ splat_e, int* __restrict__ dropped,
                   ExpandArgs x) {
  __shared__ int s_start[kEmitThreads];
  __shared__ int s_tx0[kEmitThreads], s_ty0[kEmitThreads], s_w[kEmitThreads];
  __shared__ float s_px[kEmitThreads], s_py[kEmitThreads];
  __shared__ float s_a[kEmitThreads], s_b[kEmitThreads], s_d[kEmitThreads];
  __shared__ float s_lim[kEmitThreads];
  const int t = threadIdx.x;
  const int base = blockIdx.x * kEmitThreads;
  const int total = incl[x.n - 1];
  const int dead = x.band_rows * x.n_tiles_x;
  if (base < x.n) {  // the block's splats (the grid's later blocks only pad)
    const int i = base + t;
    if (i < x.n) {
      const SplatBox s = splat_box(pos, sx, sy, rot, k2, i, x);
      s_start[t] = i == 0 ? 0 : incl[i - 1];
      s_tx0[t] = s.tx0;
      s_ty0[t] = s.ty0;
      s_w[t] = max(s.w_t, 1);
      s_px[t] = s.px;
      s_py[t] = s.py;
      s_a[t] = s.a;
      s_b[t] = s.b;
      s_d[t] = s.d;
      s_lim[t] = k2 != nullptr ? s.k2 + x.abs_margin : x.limit;
    } else {
      s_start[t] = INT_MAX;  // never a row's owner
    }
    __syncthreads();
    const int end = min(incl[min(base + kEmitThreads, x.n) - 1], x.m_cap);
    for (int e = max(s_start[0], 0) + t; e < end; e += kEmitThreads) {
      // The owner l: the last of the block's splats whose run starts at or
      // before e (the starts ascend, and s_start[0] <= e).
      int l = 0;
#pragma unroll
      for (int step = kEmitThreads / 2; step > 0; step >>= 1) {
        if (s_start[l + step] <= e) l += step;
      }
      const int rank = e - s_start[l];
      const int wb = s_w[l];
      const int ly = floor_div(rank, wb);
      const int ty = s_ty0[l] + ly;
      const int tx = s_tx0[l] + (rank - ly * wb);
      const bool live =
          !x.exact_cull ||
          tile_may_touch(s_px[l], s_py[l], s_a[l], s_b[l], s_d[l], tx,
                         ty + x.band_row0, s_lim[l], x);
      tile_e[e] = live ? ty * x.n_tiles_x + tx : dead;
      splat_e[e] = live ? base + l : -1;
    }
  }
  const int stride = gridDim.x * kEmitThreads;
  for (int e = max(total, 0) + base + t; e < x.m_cap; e += stride) {
    tile_e[e] = dead;
    splat_e[e] = -1;
  }
  if (blockIdx.x == 0 && t == 0) *dropped = max(total - x.m_cap, 0);
}

// Verification only, as the repo keeps its references: no path launches it.
// cosf and sinf of every x as splat_box takes them, for the card test that
// holds them to torch.cos and torch.sin over every float32 (the integer
// cases feed only some angles through splat_box).
__global__ void expand_trig_kernel(const float* __restrict__ v,
                                   float* __restrict__ c,
                                   float* __restrict__ s, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  c[i] = cosf(v[i]);
  s[i] = sinf(v[i]);
}

bool expand_args(int n, int m_cap, int width, int height, int tile_w,
                 int tile_h, int n_tiles_x, int n_tiles_y, int band_row0,
                 int band_rows, int exact_cull, float bounds,
                 float inv_bounds, float margin, float rel_margin,
                 float abs_margin, float limit, ExpandArgs* x) {
  if (n < 1 || m_cap < 0 || tile_w < 1 || tile_h < 1 || n_tiles_x < 1 ||
      n_tiles_y < 1 || band_rows < 1) {
    return false;
  }
  *x = ExpandArgs{n,         m_cap,     width,      height,      tile_w,
                  tile_h,    n_tiles_x, n_tiles_y,  band_row0,   band_rows,
                  exact_cull, bounds,   inv_bounds, margin,      rel_margin,
                  abs_margin, limit};
  return true;
}

}  // namespace expand
}  // namespace gs2d

using gs2d::expand::ExpandArgs;

extern "C" {

// The per-splat pass. pos is (n, 2), sx, sy and rot (n,), k2 null or (n,)
// (the opacity cull's cutoff), all float32; cnt (n,) int32 is written whole.
// Returns cudaGetLastError().
int gs2d_expand_count(const float* pos, const float* sx, const float* sy,
                      const float* rot, const float* k2, int* cnt, int n,
                      int width, int height, int tile_w, int tile_h,
                      int n_tiles_x, int n_tiles_y, int band_row0,
                      int band_rows, float bounds, float inv_bounds,
                      float margin, void* stream) {
  ExpandArgs x;
  if (!gs2d::expand::expand_args(n, 0, width, height, tile_w, tile_h,
                                 n_tiles_x, n_tiles_y, band_row0, band_rows,
                                 0, bounds, inv_bounds, margin, 0.0f, 0.0f,
                                 0.0f, &x)) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = gs2d::expand::kCountThreads;
  gs2d::expand::expand_count_kernel<<<(n + threads - 1) / threads, threads, 0,
                                      (cudaStream_t)stream>>>(
      pos, sx, sy, rot, k2, cnt, x);
  return (int)cudaGetLastError();
}

// The emission. incl (n,) int32 is the inclusive scan of gs2d_expand_count's
// cnt under the same arguments; tile_e and splat_e (m_cap,) int32 are
// written whole, dropped (a 0-d int32) gets max(total - m_cap, 0).
// Returns cudaGetLastError().
int gs2d_expand_emit(const float* pos, const float* sx, const float* sy,
                     const float* rot, const float* k2, const int* incl,
                     int* tile_e, int* splat_e, int* dropped, int n,
                     int m_cap, int width, int height, int tile_w,
                     int tile_h, int n_tiles_x, int n_tiles_y, int band_row0,
                     int band_rows, int exact_cull, float bounds,
                     float inv_bounds, float margin, float rel_margin,
                     float abs_margin, float limit, void* stream) {
  ExpandArgs x;
  if (!gs2d::expand::expand_args(n, m_cap, width, height, tile_w, tile_h,
                                 n_tiles_x, n_tiles_y, band_row0, band_rows,
                                 exact_cull, bounds, inv_bounds, margin,
                                 rel_margin, abs_margin, limit, &x)) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = gs2d::expand::kEmitThreads;
  const long long pad_blocks =
      ((long long)m_cap + threads * gs2d::expand::kPadRowsPerThread - 1) /
      (threads * gs2d::expand::kPadRowsPerThread);
  const long long splat_blocks = (n + threads - 1) / threads;
  const long long blocks =
      splat_blocks > pad_blocks ? splat_blocks : pad_blocks;
  gs2d::expand::expand_emit_kernel<<<(unsigned)blocks, threads, 0,
                                     (cudaStream_t)stream>>>(
      pos, sx, sy, rot, k2, incl, tile_e, splat_e, dropped, x);
  return (int)cudaGetLastError();
}

// cosf and sinf of v (n,) into c and s, as the expansion computes them
// (verification only: the card test's entry; no path calls it). Returns
// cudaGetLastError().
int gs2d_expand_trig(const float* v, float* c, float* s, long long n,
                     void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  gs2d::expand::expand_trig_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                                     (cudaStream_t)stream>>>(v, c, s, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
