// Measurement probes for Hopper (sm_90a), bound with ctypes through a plain
// C interface (gs2d_tpu_torch/ops/_build.py, wrappers in ops/probes.py).
//
// Kernel 14, gs2d_fma_peak: a float32 FMA-issue ceiling.
//   Replaces scripts/roofline.py::measure_vpu_fma's inner `kernel`
//   (pallas_call at :106): `chains` independent accumulators, each running
//   a = a * c + b `inner` times, summed into the output. Here a thread keeps
//   its chains in registers and writes their sum. The library is built with
//   -fmad=false, so the step is the intrinsic __fmaf_rn (one FFMA): a
//   written-out a * c + b would issue FMUL + FADD and read half the peak.
//   Bound by operations; the only bytes are the 4 B a thread writes.
// Kernels 15a-c: the backward's moment reduction in isolation, K steps over
//   one 32 x 128 tile of a fake z plane derived from a carry. They replace
//   scripts/probe_mxu_moments.py::kernel_vpu / kernel_mxu / kernel_mxu2
//   (pallas_call at :138, :138, :149). Every block computes the same
//   function and writes its own 128 outputs, so a grid of one block per SM
//   loads the whole card. No input, 512 B of output a block: bound by
//   operations, 15b's and 15c's products at the tensor cores' TF32 rate
//   (ops/probes.py::moments_bound).
//   15a gs2d_moments_cuda_cores: the production reduction of
//     csrc/patch_walk.cuh::bwd_patch_step: 512 threads, a thread owns 8
//     rows of a column, per-thread row chains (Moments), the column
//     monomials (Moments::finish), the nine values reduced over the warp's
//     lanes and the warps summed in index order every 32 steps. Bound by
//     instruction issue: the library is built with -fmad=false, so the 16
//     operations a pixel are 16 instructions, and beside them production's
//     lane tree issues 45 shuffles and 45 adds a step (30 shuffles here:
//     this probe's z plane is the same in every column, so three of the
//     nine values are the same on every lane and ptxas folds their
//     shuffles; production's z differs by pixel). The lanes are
//     reduced instead by a reduce-scatter butterfly over kStepBatch steps'
//     values (butterfly_to_round): at each level a lane keeps half of its
//     values and adds its partner's, so nine values take 12 shuffles, not
//     45, and four steps' 36 values 37 (G = 4, the fastest of 1, 2 and 4 on
//     the H100: scripts/probe_parts.py times the others). Every add has the
//     operands of the tree's lane 0, in either order, so the totals, and
//     the output, are the tree's bit for bit. The design before it, the
//     tree, is kept unchanged as the reference-only
//     gs2d_moments_cuda_cores_tree.
//   15b gs2d_moments_tensor_cores: per step the product of z with [1, vx,
//     vx^2] and [1, vy, vy^2] on the tensor cores, z computed where they
//     read it. The tile is taken transposed, E = z^T (128, 32) @ Vy (32, 8),
//     Vy = [1, vy, vy^2, 0...], as wgmma with A from registers: warpgroup q
//     multiplies columns 64 (q % 2) .. +63 by rows 16 (q / 2) .. +15 (two
//     k8 steps), so lane (g, t) of warp j of it owns columns c and c + 8,
//     c = 64 (q % 2) + 16 j + g, at rows r and r + 4, r = 16 (q / 2) + 8 s
//     + t, s = 0, 1: its 8 pixels are exactly its A fragments a0-a3 of the
//     two k-steps, and their carries stay in registers. Vy, split hi and lo
//     once, sits in shared memory as B (hi rows 0-7, lo rows 8-15, the
//     layout of 15c's stages); a k-step is two wgmmas, a_hi @ [Vy hi | Vy
//     lo] (m64n16k8) and a_lo @ Vy hi (m64n8k8). Stage 2 (the column
//     monomials 1 + vx + vx^2) and the two plain sums run on the CUDA cores;
//     the five values of a step are reduced over the lanes by 8 shuffles
//     (each reduces one value for half of the lanes), and the warps are
//     summed in index order every 32 steps as in 15a: no shared z plane and
//     no barrier inside the step loop. wgmma, not mma.sync: A from
//     registers takes the fragments as they are. 512 threads, 12 KB of
//     shared memory (scripts/probe_parts.py times it without its products).
//   15c gs2d_moments_scratch_contraction: the loop only yields z; the
//     contraction Z (K, 4096) @ V (4096, 9) runs on the tensor cores. The
//     TPU kernel's (K, 32, 128) scratch is 8 MiB and fits no block's 227 KB
//     of shared memory (in global memory it would be 1.1 GB for one block
//     per SM, an HBM measurement), so the planes are contracted as the carry
//     recursion yields them: in batches of 64 planes (wgmma's m64), each
//     batch in 32 chunks of one tile row (128 pixels). Warp-specialised, 384
//     threads: producer warpgroup p (a thread per tile column) runs the
//     recursion of its pixel of rows r = p mod 2 through the batch's 64
//     planes, its carries kept in shared memory across batches, and writes
//     each plane, split hi and lo once at the store, and the chunk's V^T
//     (hi rows 0-8, lo rows 16-24), into its own 80 KB stage, 128-byte
//     swizzled K-major rows ([plane][pixel], [column][pixel]); the stage is
//     handed over by mbarriers. The consumer warpgroup issues two wgmmas a
//     k8 step, A hi @ [V^T hi | V^T lo] (m64n32k8) and A lo @ V^T hi
//     (m64n16k8), into four independent accumulator chains, closes the chunk
//     with commit_group / wait_group, adds it into the batch's (64, 9)
//     moments in float32 (the tensor cores' own accumulation truncates) and
//     frees the stage. A batch's moments go to the (K, 9) result in shared
//     memory, then the fold. 195 KB of shared memory at K = 512 (199 712 B;
//     K up to 1416): one block of 12 warps per SM. Each chunk moves 168 KB
//     through shared memory: 80 KB stored, 88 KB read by the tensor cores.
//   The designs before these (15b: z in the production layout staged
//     through a shared plane, one __syncthreads a step; 15c: batches of 8
//     planes, one __syncthreads after each phase) are kept unchanged as the
//     reference-only gs2d_moments_tensor_cores_staged and
//     gs2d_moments_scratch_contraction_sync, for chip_smoke.py and the card
//     tests.
// TF32 keeps 11 significant bits, the TPU kernels ask for
// Precision.HIGHEST, so each float32 operand is split into a TF32 high and
// low part and three products are added (3xTF32: lo*hi, hi*lo, hi*hi, the
// small terms first).

#include <cuda_runtime.h>
#include <stdint.h>

#include "splat_terms.cuh"

namespace gs2d {
namespace probe {

constexpr int kTileH = 32, kTileW = 128;
constexpr int kRows = 8;                              // pixel rows per thread
constexpr int kThreads = kTileH * kTileW / kRows;     // 512
constexpr int kWarps = kThreads / 32;                 // 16
constexpr int kRound = 32;        // steps between cross-warp sums
constexpr int kFmaUnroll = 8;     // inner must divide by it
constexpr int kFmaThreads = 256;

constexpr float kZScale = 1e-6f, kZBias = 1e-3f;      // _fake_z
constexpr float kCarryKeep = 0.999f, kCarryGain = 1e-4f;

// ---- kernel 14 -------------------------------------------------------------

template <int CHAINS>
__global__ void __launch_bounds__(kFmaThreads)
fma_peak_kernel(float* __restrict__ out, int inner, float c, float b) {
  float acc[CHAINS];
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) acc[i] = 1.0f + (float)i;
  for (int it = 0; it < inner; it += kFmaUnroll) {
#pragma unroll
    for (int u = 0; u < kFmaUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < CHAINS; ++i) acc[i] = __fmaf_rn(acc[i], c, b);
    }
  }
  float s = acc[0];
#pragma unroll
  for (int i = 1; i < CHAINS; ++i) s = s + acc[i];
  out[(size_t)blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// ---- shared pieces of kernels 15a-c ----------------------------------------

// A thread's 8 pixels of the tile: rows grp*8 .. grp*8+7 of column col.
struct Pixels {
  int col, row0;
  float carry[kRows];

  __device__ __forceinline__ Pixels() {
    col = threadIdx.x % kTileW;
    row0 = (threadIdx.x / kTileW) * kRows;
#pragma unroll
    for (int r = 0; r < kRows; ++r) carry[r] = 0.5f;
  }
  __device__ __forceinline__ float vx() const { return (float)col - 64.0f; }
  __device__ __forceinline__ float vy(int r) const {
    return (float)(row0 + r) - 16.0f;
  }
  // z of step k at pixel r (_fake_z).
  __device__ __forceinline__ float z(int k, int r) const {
    return carry[r] * (kZScale * (float)(k + 1)) + kZBias;
  }
  __device__ __forceinline__ void advance(int r, float zr) {
    carry[r] = carry[r] * kCarryKeep + zr * kCarryGain;
  }
};

// One step's NV per-thread values -> the step's row of the round buffer:
// the fixed-order warp tree of csrc/patch_walk.cuh::bwd_patch_step, lane 0
// writes its warp's sum.
template <int NV>
__device__ __forceinline__ void warp_to_round(float (&v)[NV], int kk,
                                              float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < NV; ++f) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[f] += __shfl_down_sync(0xffffffffu, v[f], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int f = 0; f < NV; ++f) red[(warp * kRound + kk) * NV + f] = v[f];
  }
}

// End of a round of kn steps: the warps' sums added in index order; every
// (step, value) total goes into the calling thread's running sum.
template <int NV>
__device__ __forceinline__ void close_round(const float* red, int kn,
                                            float& acc) {
  __syncthreads();
  for (int i = threadIdx.x; i < kn * NV; i += blockDim.x) {
    float a = 0.0f;
    for (int w = 0; w < kWarps; ++w) a += red[w * kRound * NV + i];
    acc += a;
  }
  __syncthreads();
}

// close_round, and the step totals of block 0 written to steps (k0 + its
// first step; nullptr: not written). NW: the warps summed, kWarps
// (scripts/probe_parts.py sums one, to time the round close without them).
template <int NV, int NW>
__device__ __forceinline__ void close_round_steps(const float* red, int k0,
                                                  int kn, float& acc,
                                                  float* __restrict__ steps) {
  __syncthreads();
  for (int i = threadIdx.x; i < kn * NV; i += blockDim.x) {
    float a = 0.0f;
    for (int w = 0; w < NW; ++w) a += red[w * kRound * NV + i];
    acc += a;
    if (steps != nullptr && blockIdx.x == 0) steps[(size_t)k0 * NV + i] = a;
  }
  __syncthreads();
}

// The block's sum of the threads' running sums, written to all 128 outputs
// (the TPU kernels add a scalar onto a (1, 128) row).
__device__ __forceinline__ void write_total(float acc, float* total,
                                            float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) total[warp] = acc;
  __syncthreads();
  if (threadIdx.x < kTileW) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += total[w];
    out[(size_t)blockIdx.x * kTileW + threadIdx.x] = t;
  }
}

// x = hi + lo, both with TF32's 10-bit mantissa (round to nearest).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// c (16, 8) += a (16, 8) @ b (8, 8), TF32 operands, float32 accumulate.
// Lane = 4 g + t holds a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
// b0 (k = t, n = g), b1 (k = t+4, n = g); c0 (g, 2t), c1 (g, 2t+1),
// c2 (g+8, 2t), c3 (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The float32 product from split operands: the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// ---- kernel 15a: a reduce-scatter butterfly over a batch of steps -------

constexpr int kStepBatch = 4;  // steps reduced together; divides kRound
static_assert(kRound % kStepBatch == 0, "a round holds whole batches");

// Of n values, the lane with a level's bit clear keeps the first
// butterfly_keep(n), its partner the rest (ops/probes.py::butterfly_keep).
__host__ __device__ constexpr int butterfly_keep(int n) { return (n + 1) / 2; }

// The values a lane holds after `levels` levels, n before them.
__host__ __device__ constexpr int butterfly_held(int n, int levels) {
  return levels == 0 ? n : butterfly_held(butterfly_keep(n), levels - 1);
}

// Levels OFF, OFF / 2, ..., 1 of the butterfly over the lane's N values v.
// The lane with bit OFF clear keeps v[0 .. keep) and adds its partner's of
// them, the lane with it set keeps v[keep .. N) and adds its partner's: a
// shuffle and two selects a kept value (no select for the last of an odd N,
// which only the clear lane keeps; the set lane's copy of it is a spare).
// [first, end) follows the values the lane holds: slot j holds value first
// + j if that is below end, else a spare.
template <int N, int OFF, int NOUT>
__device__ __forceinline__ void butterfly_levels(const float* v,
                                                 float (&out)[NOUT],
                                                 int lane, int& first,
                                                 int& end) {
  constexpr int keep = butterfly_keep(N), rest = N - keep;
  const bool up = lane & OFF;
  float w[keep];
#pragma unroll
  for (int i = 0; i < keep; ++i) {
    if (i < rest) {
      const float mine = up ? v[keep + i] : v[i];
      const float theirs = up ? v[i] : v[keep + i];
      w[i] = mine + __shfl_xor_sync(0xffffffffu, theirs, OFF);
    } else {
      w[i] = v[i] + __shfl_xor_sync(0xffffffffu, v[i], OFF);
    }
  }
  if (up) {
    first += keep;
  } else {
    end = min(end, first + keep);
  }
  if constexpr (OFF > 1) {
    butterfly_levels<keep, OFF / 2>(w, out, lane, first, end);
  } else {
    static_assert(keep == NOUT, "out holds the last level's values");
#pragma unroll
    for (int i = 0; i < keep; ++i) out[i] = w[i];
  }
}

// The warp's sums of the lanes' N values, v[s * 9 + f] of step kk + s
// value f, written to the round buffer at row = red + (warp * kRound + kk)
// * 9: row[s * 9 + f] is the slot warp_to_round's lane 0 writes, and each
// total is the tree's bit for bit (its adds take the same two operands).
template <int N>
__device__ __forceinline__ void butterfly_to_round(const float (&v)[N],
                                                   float* row) {
  constexpr int kHeld = butterfly_held(N, 5);
  float w[kHeld];
  int first = 0, end = N;
  butterfly_levels<N, 16>(v, w, threadIdx.x & 31, first, end);
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    if (first + j < end) row[first + j] = w[j];
  }
}

// Adds v's values into x: scripts/probe_parts.py puts it in place of the
// reduction to time 15a's arithmetic with its values still used (an
// empty asm does not keep them: ptxas drops the work whose results no
// instruction reads).
template <int N>
__device__ __forceinline__ void fold_into(const float (&v)[N], float& x) {
#pragma unroll
  for (int i = 0; i < N; ++i) x += v[i];
}

// Step k of the thread's 8 pixels, the arithmetic of the reference's step
// in its order: the row chains, then Moments::finish into v[0 .. 9).
__device__ __forceinline__ void moments_step(Pixels& px, float vx, int k,
                                             float* v) {
  Moments m;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float vy = px.vy(r);
    const float z = px.z(k, r);
    const float zvy = z * vy;
    m.r0 = m.r0 + z;
    m.r1 = m.r1 + zvy;
    m.r2 = m.r2 + zvy * vy;
    m.cr = m.cr + z * px.carry[r];
    m.cg = m.cg + zvy * px.carry[r];
    m.cb = m.cb + z * z;
    px.advance(r, z);
  }
  m.finish(vx, v);
}

__global__ void __launch_bounds__(kThreads)
moments_cuda_cores_kernel(float* __restrict__ out, float* __restrict__ steps,
                          int n_k) {
  __shared__ float red[kWarps * kRound * kMoments];
  __shared__ float total[kWarps];
  Pixels px;
  const float vx = px.vx();
  float* const red_w = red + (threadIdx.x >> 5) * kRound * kMoments;
  float acc = 0.0f;
  for (int k0 = 0; k0 < n_k; k0 += kRound) {
    const int kn = min(kRound, n_k - k0);
    int kk = 0;
    for (; kk + kStepBatch <= kn; kk += kStepBatch) {
      float v[kStepBatch * kMoments];
#pragma unroll
      for (int s = 0; s < kStepBatch; ++s) {
        moments_step(px, vx, k0 + kk + s, v + s * kMoments);
      }
      butterfly_to_round(v, red_w + kk * kMoments);
    }
    // The last round's steps past its whole batches, one at a time.
    for (; kk < kn; ++kk) {
      float t[kMoments];
      moments_step(px, vx, k0 + kk, t);
      butterfly_to_round(t, red_w + kk * kMoments);
    }
    close_round_steps<kMoments, kWarps>(red, k0, kn, acc, steps);
  }
  write_total(acc, total, out);
}

// ---- kernel 15a's reference: the lane tree ---------------------------------

// The design before the butterfly, unchanged: production's fixed-order warp
// tree (warp_to_round). No path launches it.
__global__ void __launch_bounds__(kThreads)
moments_cuda_cores_tree_kernel(float* __restrict__ out, int n_k) {
  __shared__ float red[kWarps * kRound * kMoments];
  __shared__ float total[kWarps];
  Pixels px;
  const float vx = px.vx();
  float acc = 0.0f;
  for (int k0 = 0; k0 < n_k; k0 += kRound) {
    const int kn = min(kRound, n_k - k0);
    for (int kk = 0; kk < kn; ++kk) {
      Moments m;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float vy = px.vy(r);
        const float z = px.z(k0 + kk, r);
        const float zvy = z * vy;
        m.r0 = m.r0 + z;
        m.r1 = m.r1 + zvy;
        m.r2 = m.r2 + zvy * vy;
        m.cr = m.cr + z * px.carry[r];
        m.cg = m.cg + zvy * px.carry[r];
        m.cb = m.cb + z * z;
        px.advance(r, z);
      }
      float v[kMoments];
      m.finish(vx, v);
      warp_to_round<kMoments>(v, kk, red);
    }
    close_round<kMoments>(red, kn, acc);
  }
  write_total(acc, total, out);
}

// ---- kernel 15b's reference: z staged through a shared plane --------------

constexpr int kZStride = kTileW + 4;  // fragment loads hit 32 distinct banks
constexpr int kMxuSums = 5;           // s0, s1, s2, sum z*carry, sum z*z

__global__ void __launch_bounds__(kThreads)
moments_tensor_cores_staged_kernel(float* __restrict__ out, int n_k) {
  __shared__ float zs[2][kTileH * kZStride];
  __shared__ float red[kWarps * kRound * kMxuSums];
  __shared__ float total[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  Pixels px;

  // B fragment of this warp's k-step: Vx[c][n] = {1, vx, vx^2, 0...}[n] at
  // columns c = 8 warp + t and + 4, n = g.
  uint32_t b_hi[2], b_lo[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float vx = (float)(8 * warp + t + 4 * i) - 64.0f;
    const float b = g == 0 ? 1.0f : g == 1 ? vx : g == 2 ? vx * vx : 0.0f;
    split_tf32(b, b_hi[i], b_lo[i]);
  }

  float acc = 0.0f;
  for (int k0 = 0; k0 < n_k; k0 += kRound) {
    const int kn = min(kRound, n_k - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float* buf = zs[(k0 + kk) & 1];
      float v[kMxuSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float z = px.z(k0 + kk, r);
        buf[(px.row0 + r) * kZStride + px.col] = z;
        v[3] = v[3] + z * px.carry[r];
        v[4] = v[4] + z * z;
        px.advance(r, z);
      }
      // The next step writes the other buffer, and no warp reaches the step
      // after it before all have passed the next barrier: one barrier a
      // step.
      __syncthreads();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ra = 16 * half + g, rb = ra + 8;
        const int ca = 8 * warp + t, cb = ca + 4;
        const float a[4] = {buf[ra * kZStride + ca], buf[rb * kZStride + ca],
                            buf[ra * kZStride + cb], buf[rb * kZStride + cb]};
        uint32_t a_hi[4], a_lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(a[i], a_hi[i], a_lo[i]);
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_3xtf32(c, a_hi, a_lo, b_hi, b_lo);
        // Stage 2: this lane's elements of A, rows ra and rb, two columns.
        const float vya = (float)ra - 16.0f, vyb = (float)rb - 16.0f;
        const float ea = c[0] + c[1], eb = c[2] + c[3];
        v[0] = v[0] + (ea + eb);
        v[1] = v[1] + (ea * vya + eb * vyb);
        v[2] = v[2] + (ea * (vya * vya) + eb * (vyb * vyb));
      }
      warp_to_round<kMxuSums>(v, kk, red);
    }
    close_round<kMxuSums>(red, kn, acc);
  }
  write_total(acc, total, out);
}

// ---- kernel 15c's reference: batches of 8 planes ----------------------------

constexpr int kBatch = 8;                       // planes per contraction
constexpr int kPlane = kTileH * kTileW;         // 4096 pixels
constexpr int kPlaneStride = kPlane + 4;        // bank spread, as kZStride
constexpr int kVCols = 9;
constexpr int kPixelsPerWarp = kPlane / kWarps; // 256: 32 k-steps

// V[p][m] for pixel offsets (vx, vy): the TPU kernel's nine columns
// [1, vx, vy, vx^2, vx vy, vy^2, vx, vy, vx], zero past them.
__device__ __forceinline__ float v_column(int m, float vx, float vy) {
  switch (m) {
    case 0: return 1.0f;
    case 1: case 6: case 8: return vx;
    case 2: case 7: return vy;
    case 3: return vx * vx;
    case 4: return vx * vy;
    case 5: return vy * vy;
    default: return 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
moments_scratch_contraction_sync_kernel(float* __restrict__ out, int n_k) {
  extern __shared__ float smem[];
  float* zs = smem;                              // kBatch x kPlaneStride
  float* red = zs + kBatch * kPlaneStride;       // kWarps x 16 x 8
  float* ms = red + kWarps * 16 * kBatch;        // n_k x 9
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  Pixels px;

  for (int k0 = 0; k0 < n_k; k0 += kBatch) {
    for (int kk = 0; kk < kBatch; ++kk) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float z = px.z(k0 + kk, r);
        zs[kk * kPlaneStride + (px.row0 + r) * kTileW + px.col] = z;
        px.advance(r, z);
      }
    }
    __syncthreads();
    // M^T (16, 8) over this warp's pixels: A = V^T rows g and g + 8, B =
    // the batch's planes, plane g.
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int ks = 0; ks < kPixelsPerWarp / 8; ++ks) {
      const int p0 = warp * kPixelsPerWarp + 8 * ks + t;
      uint32_t a_hi[4], a_lo[4], b_hi[2], b_lo[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = p0 + 4 * i;
        const float vx = (float)(p % kTileW) - 64.0f;
        const float vy = (float)(p / kTileW) - 16.0f;
        split_tf32(v_column(g, vx, vy), a_hi[2 * i], a_lo[2 * i]);
        split_tf32(v_column(g + 8, vx, vy), a_hi[2 * i + 1], a_lo[2 * i + 1]);
        split_tf32(zs[g * kPlaneStride + p], b_hi[i], b_lo[i]);
      }
      mma_3xtf32(c, a_hi, a_lo, b_hi, b_lo);
    }
    float* mine = red + warp * 16 * kBatch;
    mine[g * kBatch + 2 * t] = c[0];
    mine[g * kBatch + 2 * t + 1] = c[1];
    mine[(g + 8) * kBatch + 2 * t] = c[2];
    mine[(g + 8) * kBatch + 2 * t + 1] = c[3];
    __syncthreads();
    if (threadIdx.x < kVCols * kBatch) {
      const int m = threadIdx.x / kBatch, n = threadIdx.x % kBatch;
      float a = 0.0f;
      for (int w = 0; w < kWarps; ++w) a += red[(w * 16 + m) * kBatch + n];
      ms[(k0 + n) * kVCols + m] = a;
    }
    __syncthreads();
  }
  // The fold of the TPU kernel: M (n_k, 9) flat, reshaped to (4, n_k 9 / 4),
  // summed over the 4 rows, the first 128 columns kept.
  if (threadIdx.x < kTileW) {
    const int q = n_k * kVCols / 4;
    float s = ms[threadIdx.x];
    for (int i = 1; i < 4; ++i) s = s + ms[i * q + threadIdx.x];
    out[(size_t)blockIdx.x * kTileW + threadIdx.x] = s;
  }
}

size_t contraction_sync_smem_bytes(int n_k) {
  return sizeof(float) * ((size_t)kBatch * kPlaneStride +
                          (size_t)kWarps * 16 * kBatch +
                          (size_t)n_k * kVCols);
}

// ---- Hopper pieces of kernels 15b and 15c ----------------------------------

// The TF32 split of 15b and 15c in integer form, the arithmetic of the plain
// twin ops/probes.py::tf32_split: round to nearest with ties away from zero
// (cvt.rna.tf32.f32's rounding) to a 10-bit mantissa, the low 13 bits zero.
// x - hi is exact, so |x - hi - lo| <= 2^-22 |x| for a normal x.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32_rna(float x, uint32_t& hi,
                                               uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma's shared-memory matrix descriptor (PTX ISA, "Matrix Descriptor
// Format"): the start address, the leading- and the stride-dimension byte
// offsets, each >> 4, and the swizzle mode in bits 62-63 (0: none, 1: 128 B).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo,
                                               uint32_t swizzle) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) |
         ((uint64_t)((lbo & 0x3ffffu) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3ffffu) >> 4) << 32) |
         ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins a register that an asynchronous wgmma reads or writes: the compiler
// moves no access of it across this point (after wgmma_wait: no read of d
// before the product lands, no reuse of an A register before it is read).
__device__ __forceinline__ void fence_reg(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

__device__ __forceinline__ void fence_reg(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// Orders this thread's ordinary shared-memory accesses with the tensor
// cores' (the async proxy's) reads of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64, 8) = a (64, 8) @ B (8, 8) [+ d], TF32, A from registers: lane
// (g, t) of warp j of the warpgroup holds a0 (16 j + g, t), a1 (16 j + g +
// 8, t), a2 (16 j + g, t + 4), a3 (16 j + g + 8, t + 4), and receives d0
// (16 j + g, 2t), d1 (16 j + g, 2t + 1), d2 (16 j + g + 8, 2t), d3 (16 j +
// g + 8, 2t + 1). B by descriptor. accumulate 0: d is the product alone.
__device__ __forceinline__ void wgmma_m64n8k8_rs(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (64, 16) = A (64, 8) @ B (8, 16) [+ d], TF32, both by descriptor;
// d[4 h + i] is wgmma_m64n8k8_rs's d[i] of columns 8 h .. 8 h + 7.
__device__ __forceinline__ void wgmma_m64n16k8_ss(float (&d)[8], uint64_t a,
                                                  uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64, 16) = a (64, 8) @ B (8, 16) [+ d], A from registers as in
// wgmma_m64n8k8_rs; d[4 h + i] is its d[i] of columns 8 h .. 8 h + 7.
__device__ __forceinline__ void wgmma_m64n16k8_rs(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (64, 32) = A (64, 8) @ B (8, 32) [+ d], both by descriptor; d[4 h + i]
// as above for columns 8 h .. 8 h + 7.
__device__ __forceinline__ void wgmma_m64n32k8_ss(float (&d)[16], uint64_t a,
                                                  uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
// A pipeline that never hands the stage over traps (the launch fails)
// after kMbarPolls polls, seconds, instead of holding the card.
constexpr uint32_t kMbarPolls = 1u << 26;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == kMbarPolls) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---- kernel 15b: z in wgmma's A fragments ----------------------------------

constexpr int kWarpgroup = 128;

// Word of element (row, x) of a block of 128-byte rows (x < 32) under the
// 128-byte swizzle: 16-byte chunk x / 4 of a row moves to chunk (x / 4) ^
// (row % 8) (PTX ISA, the 128B swizzling mode; blocks 1024-byte aligned).
__device__ __forceinline__ int swz_word(int row, int x) {
  return row * 32 + ((((x >> 2) ^ (row & 7)) << 2) | (x & 3));
}

// A value the compiler must keep in its register instead of recomputing it
// in the loop (it rematerialised the descriptors every step).
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("mov.b64 %0, %0;\n" : "+l"(x));
  return x;
}

__global__ void __launch_bounds__(kThreads)
moments_tensor_cores_kernel(float* __restrict__ out,
                            float* __restrict__ steps, int n_k) {
  // B = Vy (32, 8), Vy[r] = [1, vy, vy^2, 0...], split: K-major rows n of
  // 128 B (the tile's 32 rows), hi in rows 0-7, lo in rows 8-15, swizzled
  // as kernel 15c's stages; k-step S reads its 8 rows at byte 32 S.
  __shared__ __align__(1024) uint32_t vy_b[16 * kTileH];
  __shared__ float red[kWarps * kRound * kMxuSums];
  __shared__ float total[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int q = warp >> 2, j = warp & 3;  // warpgroup, its warp
  for (int i = threadIdx.x; i < 8 * kTileH; i += blockDim.x) {
    const int n = i / kTileH, r = i % kTileH;
    const float vy = (float)r - 16.0f;
    const float b = n == 0 ? 1.0f : n == 1 ? vy : n == 2 ? vy * vy : 0.0f;
    uint32_t hi, lo;
    split_tf32_rna(b, hi, lo);
    vy_b[swz_word(n, r)] = hi;
    vy_b[swz_word(8 + n, r)] = lo;
  }
  fence_proxy_async();
  __syncthreads();

  // The lane's pixels are its A fragments of k-steps s = 0, 1 (register i
  // at row 16 (q / 2) + 8 s + t + 4 (i / 2), column c + 8 (i % 2), t = lane
  // % 4); every carry starts at 0.5, so the lane needs only its columns.
  const int c = 64 * (q & 1) + 16 * j + g;
  uint64_t b_desc[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int ks = 2 * (q >> 1) + s;
    b_desc[s] = opaque(wgmma_desc(smem_u32(vy_b) + 32 * ks, 16, 8 * 128, 1));
  }
  // Stage 2's column monomials 1 + vx + vx^2 of columns c and c + 8 (exact).
  const float vxa = (float)c - 64.0f, vxb = vxa + 8.0f;
  const float wa = (1.0f + vxa) + vxa * vxa, wb = (1.0f + vxb) + vxb * vxb;
  // After the lane sums: lane 0 holds s0 and sum z carry, lane 16 s1 and
  // sum z z, lane 1 s2 (below); their places in a step's row of red.
  const bool up = lane & 16;
  const bool put_xy = lane == 0 || lane == 16 || lane == 1;
  const bool put_cc = lane == 0 || lane == 16;
  const int f_xy = lane == 0 ? 0 : lane == 16 ? 1 : 2, f_cc = up ? 4 : 3;
  float* const red_w = red + warp * kRound * kMxuSums;
  float carry[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) carry[s][i] = 0.5f;
  }
  // Per k-step s: d1[s] = a_hi @ [B hi | B lo] (n16), d2[s] = a_lo @ B hi
  // (n8): four independent products a step, none waits for another.
  float d1[2][8], d2[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int i = 0; i < 8; ++i) d1[s][i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) d2[s][i] = 0.0f;
  }

  float acc = 0.0f;
  for (int k0 = 0; k0 < n_k; k0 += kRound) {
    const int kn = min(kRound, n_k - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float scale = kZScale * (float)(k0 + kk + 1);
      uint32_t a_hi[2][4], a_lo[2][4];
      float c3 = 0.0f, c4 = 0.0f;  // sum z * carry, sum z * z
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float cr = carry[s][i];
          const float z = cr * scale + kZBias;
          c3 = c3 + z * cr;
          c4 = c4 + z * z;
          carry[s][i] = cr * kCarryKeep + z * kCarryGain;
          split_tf32_rna(z, a_hi[s][i], a_lo[s][i]);
        }
      }
      // E (64, 8) of this warpgroup's 16 rows, 3xTF32.
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        wgmma_m64n16k8_rs(d1[s], a_hi[s], b_desc[s], 0);
        wgmma_m64n8k8_rs(d2[s], a_lo[s], b_desc[s], 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fence_reg(d1[s][i]);
          fence_reg(d1[s][4 + i]);
          fence_reg(d2[s][i]);
          fence_reg(a_hi[s][i]);
          fence_reg(a_lo[s][i]);
        }
      }
      // The lane's E at columns c, c + 8 and n = 2t, 2t + 1, the small terms
      // (lo hi, hi lo) first; n = 0, 1, 2 are the vy monomials 1, vy, vy^2,
      // n >= 3 zero.
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        e[i] = ((d2[0][i] + d1[0][4 + i]) + (d2[1][i] + d1[1][4 + i])) +
               (d1[0][i] + d1[1][i]);
      }
      // Stage 2, the column monomials.
      const float x = e[0] * wa + e[2] * wb;  // t = 0: s0; t = 1: s2
      const float y = e[1] * wa + e[3] * wb;  // t = 0: s1
      // Over the 8 lanes g of each t: half of the lanes carry x, the other
      // half y; then the two plain sums over all 32 lanes the same way.
      float xy = (up ? y : x) + __shfl_xor_sync(0xffffffffu, up ? x : y, 16);
      xy += __shfl_xor_sync(0xffffffffu, xy, 8);
      xy += __shfl_xor_sync(0xffffffffu, xy, 4);
      float cc = (up ? c4 : c3) +
                 __shfl_xor_sync(0xffffffffu, up ? c3 : c4, 16);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        cc += __shfl_xor_sync(0xffffffffu, cc, off);
      }
      float* row = red_w + kk * kMxuSums;
      if (put_xy) row[f_xy] = xy;
      if (put_cc) row[f_cc] = cc;
    }
    close_round_steps<kMxuSums, kWarps>(red, k0, kn, acc, steps);
  }
  write_total(acc, total, out);
}

// ---- kernel 15c: warp-specialised contraction on wgmma ---------------------

constexpr int kPlanes = 64;                    // planes a batch: wgmma's m64
constexpr int kStages = 2;                     // one per producer warpgroup
constexpr int kContractionThreads = (1 + kStages) * kWarpgroup;
constexpr int kSwz = 128;                      // a swizzled row: 32 TF32
constexpr int kBlockPx = kSwz / 4;             // pixels of a column block
constexpr int kColBlocks = kTileW / kBlockPx;  // 4 a chunk (one tile row)
constexpr int kVRows = 16;                     // V^T: 9 columns, n16
constexpr int kABlock = kPlanes * kSwz;        // 8 KB: 64 planes x 32 px
constexpr int kBBlock = 2 * kVRows * kSwz;     // 4 KB: V^T hi, then lo
constexpr int kAHalf = kColBlocks * kABlock;   // 32 KB: the hi (or lo) planes
constexpr int kStageBytes = 2 * kAHalf + kColBlocks * kBBlock;  // 80 KB
constexpr int kChunkSteps = kTileW / 8;        // k8 steps of a chunk
constexpr int kSwzAtom = 8 * kSwz;             // 8 rows: the swizzle's period
constexpr int kBarBytes = 2 * kStages * 8;

size_t contraction_smem_bytes(int n_k) {
  return kSwzAtom + (size_t)kStages * kStageBytes + kBarBytes +
         sizeof(float) * ((size_t)kPlane + (size_t)n_k * kVCols);
}

constexpr int kChains = 4;  // accumulator sets a chunk: k-step s feeds s % 4

// A chunk's accumulators, one set for each chain: big = A hi @ [V^T hi | V^T
// lo] (n32: the hi hi product in columns 0-15, hi lo in 16-31), small = A lo
// @ V^T hi (n16).
struct ChunkAcc {
  float big[kChains][16];
  float small[kChains][8];
};

// Issues the 3xTF32 product of the chunk in the stage at shared address sp
// into acc, chain j taking the k-steps s = j mod 4 (each set the product
// of its k-steps alone), and commits it as one group. Two wgmmas a k-step,
// A hi read once for both of its products; four independent chains, so a
// wgmma does not wait for the one before it to land (with one accumulator
// the products of a chunk ran one after the other on the H100).
__device__ __forceinline__ void contract_chunk(ChunkAcc& acc, uint32_t sp) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kChunkSteps; ++s) {
    // k-step s: column block s / 4, 32 bytes further per step within the
    // swizzled rows; 8-row groups kSwzAtom apart (the leading offset is
    // not read under the swizzle).
    const uint32_t ao = sp + (s / 4) * kABlock + (s % 4) * 32;
    const uint32_t bo = sp + 2 * kAHalf + (s / 4) * kBBlock + (s % 4) * 32;
    const uint64_t a_hi = wgmma_desc(ao, 16, kSwzAtom, 1);
    const uint64_t a_lo = wgmma_desc(ao + kAHalf, 16, kSwzAtom, 1);
    const uint64_t b = wgmma_desc(bo, 16, kSwzAtom, 1);
    wgmma_m64n32k8_ss(acc.big[s % kChains], a_hi, b, s >= kChains);
    wgmma_m64n16k8_ss(acc.small[s % kChains], a_lo, b, s >= kChains);
  }
  wgmma_commit();
}

// m += a finished chunk's product in float32 rounded to nearest, the small
// terms (lo hi, hi lo) first: the tensor cores' own accumulation truncates,
// so short chains keep it below the old kernel's error (a whole batch's
// 1536 products in one accumulator drifted past PROBE_TC_RTOL of the
// terms' size on the H100).
__device__ __forceinline__ void add_chunk(float (&m)[8], ChunkAcc& acc) {
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      fence_reg(acc.big[j][i]);
      fence_reg(acc.big[j][8 + i]);
      fence_reg(acc.small[j][i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float lo = 0.0f, hi = 0.0f;
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      lo = lo + (acc.small[j][i] + acc.big[j][8 + i]);
      hi = hi + acc.big[j][i];
    }
    m[i] = m[i] + (lo + hi);
  }
}

// The carry recursion of one pixel through a batch's planes k0 .. k0 + 63,
// each plane split at the store (row m of the pixel's column block, word
// sw[m % 8] of it); kMasked: planes m >= kv (past n_k) are zeros and keep
// the carry. Returns the carry. Unrolled, so every store's offset is an
// immediate; the scale (k + 1) 1e-6 is counted up in float32, exact.
template <bool kMasked>
__device__ __forceinline__ float produce_planes(float cr, int k0, int kv,
                                                uint32_t* __restrict__ a_hi,
                                                uint32_t* __restrict__ a_lo,
                                                const int (&sw)[8]) {
  float kf = (float)(k0 + 1);
#pragma unroll
  for (int m = 0; m < kPlanes; ++m) {
    float z = 0.0f;
    if (!kMasked || m < kv) {
      z = cr * (kZScale * kf) + kZBias;
      cr = cr * kCarryKeep + z * kCarryGain;
    }
    kf = kf + 1.0f;
    uint32_t hi, lo;
    split_tf32_rna(z, hi, lo);
    a_hi[m * kBlockPx + sw[m & 7]] = hi;
    a_lo[m * kBlockPx + sw[m & 7]] = lo;
  }
  return cr;
}

__global__ void __launch_bounds__(kContractionThreads)
moments_scratch_contraction_kernel(float* __restrict__ out,
                                   float* __restrict__ steps, int n_k) {
  // Stages from a 1024-byte boundary (the swizzle XORs address bits 4-6
  // with bits 7-9): stage s at s * kStageBytes holds A hi, A lo (column
  // block b of 64 rows x 128 B at b * kABlock), B hi, B lo (b at b *
  // kBBlock); then the barriers, the carries (4096), the (n_k, 9) result.
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((kSwzAtom - (smem_u32(smem_raw) & (kSwzAtom - 1))) &
                  (kSwzAtom - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  float* carry =
      reinterpret_cast<float*>(base + kStages * kStageBytes + kBarBytes);
  float* ms = carry + kPlane;
  // full[s]: the producer warpgroup has filled stage s; empty[s]: the
  // consumer warpgroup's products of it have landed.
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kWarpgroup);
      mbar_init(empty + s, kWarpgroup);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_batches = (n_k + kPlanes - 1) / kPlanes;

  if (threadIdx.x >= kWarpgroup) {
    // Producer warpgroup p fills stage p with the chunks (tile rows) r = p
    // mod 2 of every batch; thread `col` runs tile column col, so a warp
    // writes one 128-byte row of a block per store, 32 distinct banks.
    const int p = threadIdx.x / kWarpgroup - 1, col = threadIdx.x % kWarpgroup;
    const int blk = col / kBlockPx, x = col % kBlockPx;
    const float vx = (float)col - 64.0f;
    int sw[8];  // swz_word(row, x) within its row, by row % 8
#pragma unroll
    for (int i = 0; i < 8; ++i) sw[i] = swz_word(i, x) - i * kBlockPx;
    for (int r = p; r < kTileH; r += kStages) carry[r * kTileW + col] = 0.5f;
    unsigned char* sp = base + p * kStageBytes;
    uint32_t* a_hi = reinterpret_cast<uint32_t*>(sp + blk * kABlock);
    uint32_t* a_lo = reinterpret_cast<uint32_t*>(sp + kAHalf + blk * kABlock);
    uint32_t* b_hi =
        reinterpret_cast<uint32_t*>(sp + 2 * kAHalf + blk * kBBlock);
    uint32_t* b_lo = b_hi + kVRows * kBlockPx;
    int u = 0;  // the stage's uses so far
    for (int b = 0; b < n_batches; ++b) {
      const int k0 = b * kPlanes, kv = min(kPlanes, n_k - k0);
      for (int r = p; r < kTileH; r += kStages, ++u) {
        mbar_wait(empty + p, (u & 1) ^ 1);
        fence_proxy_async();
        float& cr = carry[r * kTileW + col];
        cr = kv == kPlanes ? produce_planes<false>(cr, k0, kv, a_hi, a_lo, sw)
                           : produce_planes<true>(cr, k0, kv, a_hi, a_lo, sw);
        const float vy = (float)r - 16.0f;
#pragma unroll
        for (int n = 0; n < kVRows; ++n) {
          uint32_t hi, lo;
          split_tf32_rna(v_column(n, vx, vy), hi, lo);
          b_hi[n * kBlockPx + sw[n & 7]] = hi;
          b_lo[n * kBlockPx + sw[n & 7]] = lo;
        }
        fence_proxy_async();
        mbar_arrive(full + p);
      }
    }
  } else {
    // The consumer warpgroup: chunk `it` (tile row it % 32 of batch it /
    // 32) is in stage it % 2. It issues the chunk's products, waits for
    // them, adds them into the batch's moments and frees the stage at once,
    // so each producer warpgroup refills its stage while the tensor cores
    // read the other.
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t st0 = smem_u32(base);
    ChunkAcc acc;
    float mo[8];
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
#pragma unroll
      for (int i = 0; i < 16; ++i) acc.big[j][i] = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc.small[j][i] = 0.0f;
    }
    int it = 0;
    for (int b = 0; b < n_batches; ++b) {
      const int k0 = b * kPlanes;
#pragma unroll
      for (int i = 0; i < 8; ++i) mo[i] = 0.0f;
      for (int r = 0; r < kTileH; ++r, ++it) {
        const int st = it % kStages;
        mbar_wait(full + st, (it / kStages) & 1);
        contract_chunk(acc, st0 + st * kStageBytes);
        wgmma_wait<0>();
        add_chunk(mo, acc);
        mbar_arrive(empty + st);
      }
      // The batch's moments: mo[i] is M (k0 + m, n).
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = 16 * warp + g + 8 * ((i >> 1) & 1);
        const int n = 8 * (i >> 2) + 2 * t + (i & 1);
        const int k = k0 + m;
        if (n < kVCols && k < n_k) {
          ms[k * kVCols + n] = mo[i];
          if (steps != nullptr && blockIdx.x == 0) {
            steps[(size_t)k * kVCols + n] = mo[i];
          }
        }
      }
    }
    // The consumer warpgroup alone (named barrier 1): the fold of the TPU
    // kernel, M (n_k, 9) flat, reshaped to (4, n_k 9 / 4), summed over the
    // 4 rows, the first 128 columns kept.
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWarpgroup) : "memory");
    const int qf = n_k * kVCols / 4;
    float s = ms[threadIdx.x];
    for (int i = 1; i < 4; ++i) s = s + ms[i * qf + threadIdx.x];
    out[(size_t)blockIdx.x * kTileW + threadIdx.x] = s;
  }
}

template <int CHAINS>
int launch_fma(float* out, int inner, int grid, float c, float b,
               cudaStream_t stream) {
  fma_peak_kernel<CHAINS><<<grid, kFmaThreads, 0, stream>>>(out, inner, c, b);
  return (int)cudaGetLastError();
}

}  // namespace probe
}  // namespace gs2d

using namespace gs2d::probe;

extern "C" {

int gs2d_fma_threads() { return kFmaThreads; }
int gs2d_fma_unroll() { return kFmaUnroll; }
int gs2d_probe_batch() { return kBatch; }

// out: (grid, gs2d_fma_threads()) float32. chains in {1, 2, 4, 8, 16, 32};
// inner a multiple of gs2d_fma_unroll().
int gs2d_fma_peak(float* out, int chains, int inner, int grid, float c,
                  float b, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (inner <= 0 || inner % kFmaUnroll || grid <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  switch (chains) {
    case 1: return launch_fma<1>(out, inner, grid, c, b, s);
    case 2: return launch_fma<2>(out, inner, grid, c, b, s);
    case 4: return launch_fma<4>(out, inner, grid, c, b, s);
    case 8: return launch_fma<8>(out, inner, grid, c, b, s);
    case 16: return launch_fma<16>(out, inner, grid, c, b, s);
    case 32: return launch_fma<32>(out, inner, grid, c, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out: (n_blocks, 128) float32; every block computes the same n_k steps.
// steps: nullptr, or (n_k, 9) float32 that block 0 fills with each step's
// nine totals (Moments::finish's rows summed over the tile).
int gs2d_moments_cuda_cores(float* out, float* steps, int n_k, int n_blocks,
                            void* stream) {
  if (n_k <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  moments_cuda_cores_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      out, steps, n_k);
  return (int)cudaGetLastError();
}

// Kernel 15a's reference (the lane tree); no path launches it.
int gs2d_moments_cuda_cores_tree(float* out, int n_k, int n_blocks,
                                 void* stream) {
  if (n_k <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  moments_cuda_cores_tree_kernel<<<n_blocks, kThreads, 0,
                                   (cudaStream_t)stream>>>(out, n_k);
  return (int)cudaGetLastError();
}

// steps: nullptr, or (n_k, 5) float32 that block 0 fills with each step's
// five values (s0, s1, s2, sum z carry, sum z z).
int gs2d_moments_tensor_cores(float* out, float* steps, int n_k,
                              int n_blocks, void* stream) {
  if (n_k <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  moments_tensor_cores_kernel<<<n_blocks, kThreads, 0,
                                (cudaStream_t)stream>>>(out, steps, n_k);
  return (int)cudaGetLastError();
}

// Kernel 15b's reference (the design before wgmma); no path launches it.
int gs2d_moments_tensor_cores_staged(float* out, int n_k, int n_blocks,
                                     void* stream) {
  if (n_k <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  moments_tensor_cores_staged_kernel<<<n_blocks, kThreads, 0,
                                       (cudaStream_t)stream>>>(out, n_k);
  return (int)cudaGetLastError();
}

static bool contraction_takes(int n_k, int n_blocks) {
  return n_k > 0 && n_k % kBatch == 0 && n_k * kVCols / 4 >= kTileW &&
         n_blocks > 0;
}

// n_k a multiple of gs2d_probe_batch() with n_k * 9 / 4 >= 128 (the fold);
// the last batch of 64 planes is masked. steps: nullptr, or (n_k, 9)
// float32 that block 0 fills with M = Z @ V.
int gs2d_moments_scratch_contraction(float* out, float* steps, int n_k,
                                     int n_blocks, void* stream) {
  if (!contraction_takes(n_k, n_blocks)) return (int)cudaErrorInvalidValue;
  const size_t smem = contraction_smem_bytes(n_k);
  cudaError_t err = cudaFuncSetAttribute(
      moments_scratch_contraction_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  moments_scratch_contraction_kernel<<<n_blocks, kContractionThreads, smem,
                                       (cudaStream_t)stream>>>(out, steps,
                                                               n_k);
  return (int)cudaGetLastError();
}

// Kernel 15c's reference (batches of 8 planes); no path launches it.
int gs2d_moments_scratch_contraction_sync(float* out, int n_k, int n_blocks,
                                          void* stream) {
  if (!contraction_takes(n_k, n_blocks)) return (int)cudaErrorInvalidValue;
  const size_t smem = contraction_sync_smem_bytes(n_k);
  cudaError_t err = cudaFuncSetAttribute(
      moments_scratch_contraction_sync_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  moments_scratch_contraction_sync_kernel<<<n_blocks, kThreads, smem,
                                            (cudaStream_t)stream>>>(out, n_k);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory kernel 15c (and its reference) asks for
// at n_k steps.
int gs2d_contraction_smem_bytes(int n_k) {
  return (int)contraction_smem_bytes(n_k);
}

int gs2d_contraction_sync_smem_bytes(int n_k) {
  return (int)contraction_sync_smem_bytes(n_k);
}

}  // extern "C"
