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
//   loads the whole card. All three are bound by operations (no input, 512 B
//   of output a block).
//   15a gs2d_moments_cuda_cores: the production reduction of
//     csrc/render_resident.cu::replay_moments: 512 threads, a thread owns 8
//     rows of a column, per-thread row chains (Moments), the column
//     monomials (Moments::finish), a fixed-order warp tree and the warps
//     summed in index order every 32 steps.
//   15b gs2d_moments_tensor_cores: per step the (32, 128) @ (128, 8) product
//     z @ [1, vx, vx^2, 0...] on the tensor cores (mma.sync m16n8k8 TF32),
//     the vy monomials and the two plain sums on the CUDA cores. z is
//     computed in the production layout (a thread owns 8 rows of a column)
//     and reaches the A fragments through shared memory: one padded
//     (32, 132) plane, double buffered, one __syncthreads a step. That
//     staging is the cost the probe is about. Warp w multiplies columns
//     8w..8w+7 (one k-step) for both 16-row halves.
//   15c gs2d_moments_scratch_contraction: the loop only stores z; the
//     contraction Z (K, 4096) @ V (4096, 9) runs on the tensor cores
//     afterwards. The TPU kernel's (K, 32, 128) scratch is 8 MiB and fits no
//     block's 227 KB of shared memory; a global scratch would be 8 MiB a
//     block, 1.1 GB for one block per SM, far past the 50 MB L2, and the
//     probe would then measure HBM. The carry recursion yields the planes
//     in order, so the contraction is taken in shared-memory batches of 8
//     planes (131 KB, the n8 of the instruction): M^T (16, 8) = V^T (16,
//     4096) @ Z^T (4096, 8), V's 9 columns padded to the m16. Warp w
//     contracts pixels 256w..256w+255 and the warps' (16, 8) partials are
//     added in index order. The (K, 9) result stays in shared memory for
//     the fold into the (1, 128) output.
// TF32 keeps 11 significant bits, the TPU kernels ask for
// Precision.HIGHEST, so each float32 operand is split into a TF32 high and
// low part and three products are added (3xTF32: lo*hi, hi*lo, hi*hi).

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
// the fixed-order warp tree of replay_moments, lane 0 writes its warp's sum.
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

// ---- kernel 15a ------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
moments_cuda_cores_kernel(float* __restrict__ out, int n_k) {
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

// ---- kernel 15b ------------------------------------------------------------

constexpr int kZStride = kTileW + 4;  // fragment loads hit 32 distinct banks
constexpr int kMxuSums = 5;           // s0, s1, s2, sum z*carry, sum z*z

__global__ void __launch_bounds__(kThreads)
moments_tensor_cores_kernel(float* __restrict__ out, int n_k) {
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

// ---- kernel 15c ------------------------------------------------------------

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
moments_scratch_contraction_kernel(float* __restrict__ out, int n_k) {
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

size_t contraction_smem_bytes(int n_k) {
  return sizeof(float) * ((size_t)kBatch * kPlaneStride +
                          (size_t)kWarps * 16 * kBatch +
                          (size_t)n_k * kVCols);
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
int gs2d_moments_cuda_cores(float* out, int n_k, int n_blocks, void* stream) {
  if (n_k <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  moments_cuda_cores_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      out, n_k);
  return (int)cudaGetLastError();
}

int gs2d_moments_tensor_cores(float* out, int n_k, int n_blocks,
                              void* stream) {
  if (n_k <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  moments_tensor_cores_kernel<<<n_blocks, kThreads, 0,
                                (cudaStream_t)stream>>>(out, n_k);
  return (int)cudaGetLastError();
}

// n_k a multiple of gs2d_probe_batch() with n_k * 9 / 4 >= 128 (the fold).
int gs2d_moments_scratch_contraction(float* out, int n_k, int n_blocks,
                                     void* stream) {
  if (n_k <= 0 || n_k % kBatch || n_k * kVCols / 4 < kTileW ||
      n_blocks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = contraction_smem_bytes(n_k);
  cudaError_t err = cudaFuncSetAttribute(
      moments_scratch_contraction_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  moments_scratch_contraction_kernel<<<n_blocks, kThreads, smem,
                                       (cudaStream_t)stream>>>(out, n_k);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory kernel 15c asks for at n_k steps.
int gs2d_contraction_smem_bytes(int n_k) {
  return (int)contraction_smem_bytes(n_k);
}

}  // extern "C"
