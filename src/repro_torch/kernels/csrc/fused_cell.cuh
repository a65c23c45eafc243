// Fused minGRU / minLSTM layer for Hopper (sm_90a): gate projections,
// gates and the linear scan in one launch.  Shared by
// kernels/fused_mingru/csrc/fused_mingru.cu (G = 2 gates: z, h~) and
// kernels/fused_minlstm/csrc/fused_minlstm.cu (G = 3: f, i, h~).
//
// Replaces the Pallas TPU kernels fused_mingru_kernel and
// fused_minlstm_kernel (src/repro/kernels/fused_mingru/kernel.py,
// fused_minlstm/kernel.py, _fused_kernel).  For x (B, T, Dx) and weights
// W_g (Dx, Dh), biases b_g (Dh,), h0 (B, Dh) fp32:
//
//   k_g = x @ W_g + b_g                       fp32 inputs, fp32 sums
//   minGRU:  z = sigmoid(k_0), h~ = g(k_1) (log mode) or k_1
//            a = 1 - z, b = z * h~
//   minLSTM: f', i' = normalized_gates(k_0, k_1) or sigmoid, sigmoid
//            h~ = g(k_2) or k_2;  a = f', b = i' * h~
//   h_t = a_t * h_{t-1} + b_t                 fp32 carry, out rounded to T
//
// Bound.  At the training shapes (B 8, T 256, Dx 768, Dh 1536) a minGRU
// layer is 9.66 GFLOP of projections (minLSTM 14.5) against 14-17 MB of
// bytes: about 10 us of bf16 tensor-core time against 4-5 us of memory
// time, so the bound is operations.  This first kernel does those
// operations as fp32 FMAs on the CUDA cores (67 TFLOP/s peak, not 989),
// so it cannot come within 15x of the bound; tensor cores are later work.
//
// Design.  The TPU kernel's grid is (batch row, Dh tile, time chunk) with
// time last and sequential, carrying h in VMEM.  Here one block owns one
// (batch row, 64-column Dh tile) and loops over the time chunks itself,
// so the carry is a register of the thread that owns the column and
// nothing crosses blocks.  Per 64-step chunk:
//   1. GEMM: the (64 x Dx) x tile times G (Dx x 64) weight tiles, tiled
//      through shared memory 32 deep; each of 256 threads accumulates a
//      4 x 4 block of every gate in fp32 registers.
//   2. Gates in fp32, written as (a, b) to shared memory (reusing the
//      GEMM tiles' space).
//   3. Scan: 64 threads, one per column, walk the chunk's rows in order
//      and carry h, unrounded fp32, into the next chunk; only the store
//      rounds to T.
// The ragged T, Dh and Dx edges are masked in the kernel (zero operands,
// no stores), not padded.  Sums run in a fixed order, so the kernel is
// deterministic: a remat replay reproduces the forward bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fused_cell {

constexpr int kThreads = 256;
constexpr int kBT = 64;     // time rows per chunk
constexpr int kBN = 64;     // Dh columns per block
constexpr int kBK = 32;     // contraction depth per shared-memory stage
constexpr int kXs = kBK + 1;  // padded x row: conflict-free 4-row reads

struct Params {
  const void* x;      // (B, T, Dx) T
  const void* w[3];   // (Dx, Dh)   T
  const void* b[3];   // (Dh,)      T
  const float* h0;    // (B, Dh)    fp32
  void* out;          // (B, T, Dh) T
  int B, T, Dx, Dh;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}
// the paper's positivity transform g(v) = v + 0.5 (v >= 0), sigmoid(v)
__device__ __forceinline__ float g_pos(float v) {
  return v >= 0.0f ? v + 0.5f : sigmoid(v);
}

struct GemmSmem {
  float xs[kBT][kXs];
  float ws[3][kBK][kBN];
};
struct ScanSmem {
  float a[kBT][kBN];
  float b[kBT][kBN];
};
union __align__(16) Smem {
  GemmSmem gemm;
  ScanSmem scan;
};

template <typename T, int G, bool kLog, bool kNorm>
__global__ void __launch_bounds__(kThreads) fused_cell_kernel(Params p) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // 4 x 4 micro-tile coordinates
  const int n0 = blockIdx.x * kBN;
  const int row = blockIdx.y;
  const int T_ = p.T, Dx = p.Dx, Dh = p.Dh;
  const T* x = static_cast<const T*>(p.x) + (long long)row * T_ * Dx;
  T* out = static_cast<T*>(p.out) + (long long)row * T_ * Dh;

  float bias[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      bias[g][j] =
          n < Dh ? to_f(static_cast<const T*>(p.b[g])[n]) : 0.0f;
    }
  // the carry: thread c < kBN owns column n0 + c
  float carry = 0.0f;
  if (tid < kBN && n0 + tid < Dh) carry = p.h0[(long long)row * Dh + n0 + tid];

  for (int t0 = 0; t0 < T_; t0 += kBT) {
    float acc[G][4][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[g][i][j] = 0.0f;

    for (int k0 = 0; k0 < Dx; k0 += kBK) {
      // x tile: a warp reads kBK consecutive k of one row
#pragma unroll
      for (int m = 0; m < kBT * kBK / kThreads; ++m) {
        const int i = tid + m * kThreads;
        const int r = i / kBK, k = i % kBK;
        float v = 0.0f;
        if (t0 + r < T_ && k0 + k < Dx)
          v = to_f(x[(long long)(t0 + r) * Dx + k0 + k]);
        sm.gemm.xs[r][k] = v;
      }
      // weight tiles: a warp reads 32 consecutive n of one k row
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const T* w = static_cast<const T*>(p.w[g]);
#pragma unroll
        for (int m = 0; m < kBK * kBN / kThreads; ++m) {
          const int i = tid + m * kThreads;
          const int k = i / kBN, n = i % kBN;
          float v = 0.0f;
          if (k0 + k < Dx && n0 + n < Dh)
            v = to_f(w[(long long)(k0 + k) * Dh + n0 + n]);
          sm.gemm.ws[g][k][n] = v;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        float xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = sm.gemm.xs[ty * 4 + i][k];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 wv =
              *reinterpret_cast<const float4*>(&sm.gemm.ws[g][k][tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[g][i][0] = fmaf(xv[i], wv.x, acc[g][i][0]);
            acc[g][i][1] = fmaf(xv[i], wv.y, acc[g][i][1]);
            acc[g][i][2] = fmaf(xv[i], wv.z, acc[g][i][2]);
            acc[g][i][3] = fmaf(xv[i], wv.w, acc[g][i][3]);
          }
        }
      }
      __syncthreads();
    }

    // gates, fp32, into the scan buffers (the GEMM tiles are dead now)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a, b;
        if (G == 2) {
          const float z = sigmoid(acc[0][i][j] + bias[0][j]);
          const float v = acc[1][i][j] + bias[1][j];
          a = 1.0f - z;
          b = z * (kLog ? g_pos(v) : v);
        } else {
          const float kf = acc[0][i][j] + bias[0][j];
          const float ki = acc[1 % G][i][j] + bias[1 % G][j];
          const float v = acc[G - 1][i][j] + bias[G - 1][j];
          float f, in;
          if (kNorm) {   // f/(f+i), i/(f+i) in the stable form
            const float diff = softplus(-kf) - softplus(-ki);
            f = sigmoid(-diff);
            in = sigmoid(diff);
          } else {
            f = sigmoid(kf);
            in = sigmoid(ki);
          }
          a = f;
          b = in * (kLog ? g_pos(v) : v);
        }
        sm.scan.a[ty * 4 + i][tx * 4 + j] = a;
        sm.scan.b[ty * 4 + i][tx * 4 + j] = b;
      }
    __syncthreads();

    if (tid < kBN) {
      const int n = n0 + tid;
      const int rows = min(kBT, T_ - t0);
      if (n < Dh) {
        for (int r = 0; r < rows; ++r) {
          carry = fmaf(sm.scan.a[r][tid], carry, sm.scan.b[r][tid]);
          out[(long long)(t0 + r) * Dh + n] = from_f<T>(carry);
        }
      }
    }
    __syncthreads();
  }
}

template <int G>
int launch(int bf16, int log_mode, int normalize, const Params& p,
           cudaStream_t s) {
  if (p.B < 1 || p.T < 1 || p.Dx < 1 || p.Dh < 1 || p.B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((p.Dh + kBN - 1) / kBN), (unsigned)p.B);
  const int key = (bf16 ? 4 : 0) | (log_mode ? 2 : 0) |
                  ((G == 3 && normalize) ? 1 : 0);
  using bf16_t = __nv_bfloat16;
  switch (key) {
    case 0: fused_cell_kernel<float, G, false, false>
                <<<grid, kThreads, 0, s>>>(p); break;
    case 1: fused_cell_kernel<float, G, false, true>
                <<<grid, kThreads, 0, s>>>(p); break;
    case 2: fused_cell_kernel<float, G, true, false>
                <<<grid, kThreads, 0, s>>>(p); break;
    case 3: fused_cell_kernel<float, G, true, true>
                <<<grid, kThreads, 0, s>>>(p); break;
    case 4: fused_cell_kernel<bf16_t, G, false, false>
                <<<grid, kThreads, 0, s>>>(p); break;
    case 5: fused_cell_kernel<bf16_t, G, false, true>
                <<<grid, kThreads, 0, s>>>(p); break;
    case 6: fused_cell_kernel<bf16_t, G, true, false>
                <<<grid, kThreads, 0, s>>>(p); break;
    default: fused_cell_kernel<bf16_t, G, true, true>
                <<<grid, kThreads, 0, s>>>(p); break;
  }
  return (int)cudaGetLastError();
}

inline Params make_params(int B, int T, int Dx, int Dh, void* const* ptrs,
                          int G) {
  // ptrs: x, w_0 .. w_{G-1}, b_0 .. b_{G-1}, h0, out
  Params p;
  p.x = ptrs[0];
  for (int g = 0; g < 3; ++g) {
    p.w[g] = g < G ? ptrs[1 + g] : nullptr;
    p.b[g] = g < G ? ptrs[1 + G + g] : nullptr;
  }
  p.h0 = static_cast<const float*>(ptrs[1 + 2 * G]);
  p.out = ptrs[2 + 2 * G];
  p.B = B; p.T = T; p.Dx = Dx; p.Dh = Dh;
  return p;
}

}  // namespace fused_cell
