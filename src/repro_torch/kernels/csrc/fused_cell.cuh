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
//   k_g = x @ W_g + b_g                       fp32 sums
//   minGRU:  z = sigmoid(k_0), h~ = g(k_1) (log mode) or k_1
//            a = 1 - z, b = z * h~
//   minLSTM: f', i' = normalized_gates(k_0, k_1) or sigmoid, sigmoid
//            h~ = g(k_2) or k_2;  a = f', b = i' * h~
//   h_t = a_t * h_{t-1} + b_t                 fp32 carry, out rounded to T
//
// Only h leaves the kernel: the k / a / b activations never reach device
// memory.  Sums run in a fixed order in both bodies, so a launch is
// deterministic and a remat replay reproduces the forward bit for bit.
//
// Bound.  At the training shapes (B 8, T 256, Dx 768, Dh 1536) a minGRU
// layer is 9.66 GFLOP of projections (minLSTM 14.5) against 14-17 MB of
// bytes: about 10 us of bf16 tensor-core time against 4-5 us of memory
// time, so the bound is operations, and only the tensor cores come near
// it.  Three more costs sit on each block's critical path: the operand
// traffic from L2 (x is read by every column tile, W by every batch row
// and time chunk), the gate math (exp / log / divide per element), and
// the scan's T sequential steps per column.
//
// Two bodies, routed by dtype and alignment in choose() before the
// launch (never by catching a failure):
//
// * fused_cell_tc_kernel, the tensor-core body: bf16 with Dx and Dh
//   multiples of 8 and x and the weights 16-byte aligned (16-byte
//   cp.async rows).  One block of 12 warps owns one (batch row, 96-column
//   Dh tile): B 8 x Dh 1536 is 128 blocks, one per SM (about 180 KB of
//   shared memory and 140-170 registers a thread), so the grid is one
//   wave on the 132 SMs.  The block walks T in 128-row chunks (W is read
//   twice per block at T 256, not four times); per chunk
//     1. GEMM on the tensor cores, mma.sync.m16n8k16 (bf16 in, fp32
//        accumulate) fed by ldmatrix: warp (wm, wn) owns rows 32 wm ..
//        32 wm + 31 and columns 32 wn .. 32 wn + 31 of every gate, so
//        one x fragment serves all G gates.  The operands come through a
//        ring of shared-memory stages (x 128 x 64 and G weight 64 x 96
//        tiles, rows padded by 16 bytes so ldmatrix is free of bank
//        conflicts; 4 stages for minGRU, 3 for minLSTM), filled by
//        cp.async stages - 1 ahead.  The ring runs across chunk
//        boundaries: the next chunk's first stages load while this
//        chunk's gates and scan run.  W is read (Dx, Dh) as the caller
//        holds it; ldmatrix.trans transposes it.
//     2. Gates in fp32 on the accumulator registers, with the same
//        precise exp / log / divide as the CUDA-core body (gate_ab), so
//        the forward and the backward's fp32 gate recompute agree.
//     3. Scan across the block: each warp composes its rows with a
//        Kogge-Stone ladder over shuffles (h -> a h + b pairs), the four
//        row warps exchange their totals through shared memory, and each
//        applies the unrounded fp32 carry of the rows before it.  All
//        384 threads scan; the carry into the next chunk stays in shared
//        memory of the block that owns the columns.
//   Why mma.sync and not wgmma: PERF.md, Findings.
// * fused_cell_kernel, the CUDA-core body: fp32 (the exact path, held to
//   1e-4, which TF32 would break), and bf16 that the tensor-core body
//   cannot take.  One block per (batch row, 64-column Dh tile); per
//   64-step chunk an fp32 shared-memory GEMM 32 deep (each of 256 threads
//   accumulates a 4 x 4 block of every gate), the gates into shared
//   memory, and 64 threads walking the chunk's rows one column
//   each.
//
// Both bodies mask the ragged T, Dh and Dx edges (zero operands, no
// stores); nothing is padded.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace fused_cell {

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

// The scan inputs (a, b) of one element from its G pre-activations
// (biases added), in fp32; both bodies share it.
template <int G, bool kLog, bool kNorm>
__device__ __forceinline__ void gate_ab(const float (&k)[G], float& a,
                                        float& b) {
  if (G == 2) {
    const float z = sigmoid(k[0]);
    const float v = k[1];
    a = 1.0f - z;
    b = z * (kLog ? g_pos(v) : v);
  } else {
    const float kf = k[0];
    const float ki = k[1 % G];
    const float v = k[G - 1];
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
}

// A block's (batch row, Dh tile) from its place in a one-dimensional grid of
// B x ceil(Dh / bn) blocks, tiles fastest (the order of the 2D grid it
// replaced, whose grid.y held B: at most 65535 rows)
__device__ __forceinline__ int tile_of(int Dh, int bn) {
  return (int)(blockIdx.x % (unsigned)((Dh + bn - 1) / bn));
}
__device__ __forceinline__ int row_of(int Dh, int bn) {
  return (int)(blockIdx.x / (unsigned)((Dh + bn - 1) / bn));
}

// ---------------------------------------------------------------------------
// The CUDA-core body (fp32, and bf16 the tensor-core body cannot take)
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBT = 64;     // time rows per chunk
constexpr int kBN = 64;     // Dh columns per block
constexpr int kBK = 32;     // contraction depth per shared-memory stage
constexpr int kXs = kBK + 1;  // padded x row: conflict-free 4-row reads

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
  const int T_ = p.T, Dx = p.Dx, Dh = p.Dh;
  const int n0 = tile_of(Dh, kBN) * kBN;
  const int row = row_of(Dh, kBN);
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
        float k[G];
#pragma unroll
        for (int g = 0; g < G; ++g) k[g] = acc[g][i][j] + bias[g][j];
        float a, b;
        gate_ab<G, kLog, kNorm>(k, a, b);
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

// ---------------------------------------------------------------------------
// The tensor-core body (bf16, aligned)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kRowWarps = 4;         // warps along time
constexpr int kColWarps = 3;         // warps along Dh
constexpr int kThreads = 32 * kRowWarps * kColWarps;
constexpr int kMT = 2;               // m16 row tiles per warp
constexpr int kBT = kRowWarps * kMT * 16;  // time rows per chunk (128)
constexpr int kBN = 96;              // Dh columns per block
constexpr int kBK = 64;              // contraction depth per stage
constexpr int kXs = kBK + 8;         // x row stride, elements (144 B)
constexpr int kWs = kBN + 8;         // weight row stride, elements (208 B)
constexpr int kWarpN = kBN / kColWarps;  // columns per warp (32)
constexpr int kNT = kWarpN / 8;      // n8 tiles per warp and gate
constexpr int kSmemMax = 232448;     // a block's shared memory on sm_90

template <int G>
struct Layout {
  static constexpr int x_elems = kBT * kXs;
  static constexpr int w_elems = kBK * kWs;
  static constexpr int stage_elems = x_elems + G * w_elems;
  // fp32 after the ring: bias[G][kBN], carry[2][kBN],
  // tot_a[2][kRowWarps][kBN], tot_b[2][kRowWarps][kBN]
  static constexpr int tail_floats =
      G * kBN + 2 * kBN + 2 * 2 * kRowWarps * kBN;
  static constexpr int fit = (kSmemMax - tail_floats * 4) / (stage_elems * 2);
  static constexpr int stages = fit < 4 ? fit : 4;   // the ring
  static constexpr int ring_bytes = stages * stage_elems * 2;
  static constexpr int smem_bytes = ring_bytes + tail_floats * 4;
};

// the warp-level helpers, shared with the cell decode kernels
using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::ldmatrix_x4;
using sm90::ldmatrix_x4_trans;
using sm90::mma_bf16;

// Stage iteration `it` of the flat (chunk, k step) sequence into ring
// slot `st`: the x rows of the chunk and the G weight tiles at k step.
template <int G>
__device__ __forceinline__ void load_stage(__nv_bfloat16* st,
                                           const Params& p,
                                           const __nv_bfloat16* x, int t0,
                                           int k0, int n0, int tid) {
  constexpr int kxc = kBK / 8;        // 16-byte chunks per x row
  for (int i = tid; i < kBT * kxc; i += kThreads) {
    const int r = i / kxc, c = (i % kxc) * 8;
    const bool ok = t0 + r < p.T && k0 + c < p.Dx;
    const __nv_bfloat16* src =
        ok ? x + (long long)(t0 + r) * p.Dx + k0 + c : x;
    cp_async16(st + r * kXs + c, src, ok);
  }
  constexpr int kwc = kBN / 8;        // 16-byte chunks per weight row
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w[g]);
    __nv_bfloat16* ws = st + Layout<G>::x_elems + g * Layout<G>::w_elems;
    for (int i = tid; i < kBK * kwc; i += kThreads) {
      const int r = i / kwc, c = (i % kwc) * 8;
      const bool ok = k0 + r < p.Dx && n0 + c < p.Dh;
      const __nv_bfloat16* src =
          ok ? w + (long long)(k0 + r) * p.Dh + n0 + c : w;
      cp_async16(ws + r * kWs + c, src, ok);
    }
  }
}

template <int G, bool kLog, bool kNorm>
__global__ void __launch_bounds__(kThreads, 1)
    fused_cell_tc_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  using L = Layout<G>;
  constexpr int S = L::stages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* bias_s = reinterpret_cast<float*>(smem_raw + L::ring_bytes);
  float* carry_s = bias_s + G * kBN;                 // [2][kBN]
  float* tot_a = carry_s + 2 * kBN;                  // [2][kRowWarps][kBN]
  float* tot_b = tot_a + 2 * kRowWarps * kBN;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % kRowWarps, wn = warp / kRowWarps;
  const int grp = lane / 4, tq = lane % 4;   // mma fragment coordinates
  const int T_ = p.T, Dh = p.Dh;
  const int n0 = tile_of(Dh, kBN) * kBN;
  const int row = row_of(Dh, kBN);
  const bf16* x = static_cast<const bf16*>(p.x) + (long long)row * T_ * p.Dx;
  bf16* out = static_cast<bf16*>(p.out) + (long long)row * T_ * Dh;

  for (int i = tid; i < kBN; i += kThreads) {
    const int n = n0 + i;
#pragma unroll
    for (int g = 0; g < G; ++g)
      bias_s[g * kBN + i] =
          n < Dh ? __bfloat162float(static_cast<const bf16*>(p.b[g])[n])
                 : 0.0f;
    carry_s[i] = n < Dh ? p.h0[(long long)row * Dh + n] : 0.0f;
  }

  const int nk = (p.Dx + kBK - 1) / kBK;
  const int n_chunks = (T_ + kBT - 1) / kBT;
  const int n_iters = n_chunks * nk;
  // prologue: the first S - 1 stages in flight
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_iters)
      load_stage<G>(ring + s * L::stage_elems, p, x, (s / nk) * kBT,
                    (s % nk) * kBK, n0, tid);
    cp_async_commit();
  }

  // acc[g][m][j][e]: row 16 (kMT wm + m) + grp + 8 (e / 2) of the chunk,
  // column kWarpN wn + 8 j + 2 tq + (e % 2) of the tile
  float acc[G][kMT][kNT][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][m][j][e] = 0.0f;

  for (int it = 0; it < n_iters; ++it) {
    cp_async_wait<S - 2>();         // stage `it` has landed (this thread)
    __syncthreads();                // ... for every thread; slot it-1 free
    {
      const int nx = it + S - 1;
      if (nx < n_iters)
        load_stage<G>(ring + (nx % S) * L::stage_elems, p, x,
                      (nx / nk) * kBT, (nx % nk) * kBK, n0, tid);
      cp_async_commit();            // an empty group keeps the count
    }
    const bf16* xs = ring + (it % S) * L::stage_elems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[kMT][4], b[G][kNT / 2][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        ldmatrix_x4(a[m], xs + ((wm * kMT + m) * 16 + lane % 16) * kXs + kk +
                              (lane / 16) * 8);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np)
          ldmatrix_x4_trans(b[g][np], xs + L::x_elems + g * L::w_elems +
                                          (kk + lane % 16) * kWs +
                                          wn * kWarpN + np * 16 +
                                          (lane / 16) * 8);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np)
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
            mma_bf16(acc[g][m][2 * np], a[m], b[g][np][0], b[g][np][1]);
            mma_bf16(acc[g][m][2 * np + 1], a[m], b[g][np][2], b[g][np][3]);
          }
    }
    if (it % nk != nk - 1) continue;

    // ---- chunk epilogue: gates, scan, store -------------------------
    const int chunk = it / nk, t0 = chunk * kBT, q = chunk & 1;
    // gates into (a, b) = (acc[0], acc[1])
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = wn * kWarpN + j * 8 + 2 * tq + (e % 2);
          float k[G];
#pragma unroll
          for (int g = 0; g < G; ++g)
            k[g] = acc[g][m][j][e] + bias_s[g * kBN + c];
          gate_ab<G, kLog, kNorm>(k, acc[0][m][j][e], acc[1][m][j][e]);
        }
    // Kogge-Stone over the 8 row groups of each 8-row half: after it,
    // (A, B) maps h before the half's first row to h after this row
#pragma unroll
    for (int d = 1; d < 8; d *= 2)
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pa =
                __shfl_up_sync(0xffffffffu, acc[0][m][j][e], 4 * d);
            const float pb =
                __shfl_up_sync(0xffffffffu, acc[1][m][j][e], 4 * d);
            if (grp >= d) {
              acc[1][m][j][e] = fmaf(acc[0][m][j][e], pb, acc[1][m][j][e]);
              acc[0][m][j][e] *= pa;
            }
          }
    // then each half after the rows before it in the warp, in order:
    // (m, half 1) after (m, half 0), (m + 1, half 0) after (m, half 1);
    // the totals are row group 7's
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int half = (m == 0 ? 1 : 0); half < 2; ++half)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pm = half ? m : m - 1, pe = half ? e : e + 2;
            const float ta = __shfl_sync(0xffffffffu, acc[0][pm][j][pe],
                                         28 + tq);
            const float tb = __shfl_sync(0xffffffffu, acc[1][pm][j][pe],
                                         28 + tq);
            float& A = acc[0][m][j][2 * half + e];
            float& B = acc[1][m][j][2 * half + e];
            B = fmaf(A, tb, B);
            A *= ta;
          }
    // each warp's total (row group 7 of its last half) to the others
    if (grp == 7) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wn * kWarpN + j * 8 + 2 * tq + e;
          tot_a[(q * kRowWarps + wm) * kBN + c] = acc[0][kMT - 1][j][e + 2];
          tot_b[(q * kRowWarps + wm) * kBN + c] = acc[1][kMT - 1][j][e + 2];
        }
    }
    __syncthreads();
    // h = A h_start + B, h_start the carry after the rows of the warps
    // before; h (fp32) into acc[0]
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = wn * kWarpN + j * 8 + 2 * tq + e;
        float h = carry_s[q * kBN + c];          // h before the chunk
        for (int w = 0; w < wm; ++w)             // ... and before warp wm
          h = fmaf(tot_a[(q * kRowWarps + w) * kBN + c], h,
                   tot_b[(q * kRowWarps + w) * kBN + c]);
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float& A = acc[0][m][j][2 * half + e];
            A = fmaf(A, h, acc[1][m][j][2 * half + e]);
          }
        if (wm == kRowWarps - 1 && grp == 7)
          carry_s[(q ^ 1) * kBN + c] = acc[0][kMT - 1][j][e + 2];
      }
    // h rounded to bf16 pairs; Dh % 8 == 0 keeps a pair inside or
    // outside the edge together
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = n0 + wn * kWarpN + j * 8 + 2 * tq;
      if (n >= Dh) continue;
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = t0 + (wm * kMT + m) * 16 + grp + 8 * half;
          if (t < T_)
            *reinterpret_cast<__nv_bfloat162*>(out + (long long)t * Dh +
                                               n) =
                __floats2bfloat162_rn(acc[0][m][j][2 * half],
                                      acc[0][m][j][2 * half + 1]);
        }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][m][j][e] = 0.0f;
  }
  cp_async_wait<0>();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Routing and launch
// ---------------------------------------------------------------------------

using KernelFn = void (*)(Params);

// the body a launch takes: 1 tensor cores, 0 CUDA cores (the launcher
// reports it, and the wrappers count each body's launches from that)
inline int tc_ok(int bf16, const Params& p, int G) {
  if (!bf16 || p.Dx % 8 != 0 || p.Dh % 8 != 0) return 0;
  if (reinterpret_cast<uintptr_t>(p.x) % 16 != 0) return 0;
  for (int g = 0; g < G; ++g)
    if (reinterpret_cast<uintptr_t>(p.w[g]) % 16 != 0) return 0;
  return 1;
}

struct Choice {
  KernelFn fn;
  int body;         // 1 tensor cores, 0 CUDA cores
  int threads;
  int smem;         // dynamic shared memory, bytes
  dim3 grid;
};

// B x ceil(Dh / bn) blocks, on grid.x (tile_of, row_of)
inline unsigned grid_blocks(const Params& p, int bn) {
  return (unsigned)((long long)p.B * ((p.Dh + bn - 1) / bn));
}

template <int G>
Choice choose(int bf16, int log_mode, int normalize, const Params& p) {
  const int key = (bf16 ? 4 : 0) | (log_mode ? 2 : 0) |
                  ((G == 3 && normalize) ? 1 : 0);
  using bf16_t = __nv_bfloat16;
  Choice c;
  c.body = tc_ok(bf16, p, G);
  if (c.body) {
    c.threads = tc::kThreads;
    c.smem = tc::Layout<G>::smem_bytes;
    c.grid = dim3(grid_blocks(p, tc::kBN));
    switch (key & 3) {
      case 0: c.fn = tc::fused_cell_tc_kernel<G, false, false>; break;
      case 1: c.fn = tc::fused_cell_tc_kernel<G, false, true>; break;
      case 2: c.fn = tc::fused_cell_tc_kernel<G, true, false>; break;
      default: c.fn = tc::fused_cell_tc_kernel<G, true, true>; break;
    }
    return c;
  }
  c.threads = kThreads;
  c.smem = 0;
  c.grid = dim3(grid_blocks(p, kBN));
  switch (key) {
    case 0: c.fn = fused_cell_kernel<float, G, false, false>; break;
    case 1: c.fn = fused_cell_kernel<float, G, false, true>; break;
    case 2: c.fn = fused_cell_kernel<float, G, true, false>; break;
    case 3: c.fn = fused_cell_kernel<float, G, true, true>; break;
    case 4: c.fn = fused_cell_kernel<bf16_t, G, false, false>; break;
    case 5: c.fn = fused_cell_kernel<bf16_t, G, false, true>; break;
    case 6: c.fn = fused_cell_kernel<bf16_t, G, true, false>; break;
    default: c.fn = fused_cell_kernel<bf16_t, G, true, true>; break;
  }
  return c;
}

// (grid.x holds up to 2^31 - 1 blocks: more rows than a card's memory
// holds at any Dh and T)
inline bool valid_shape(const Params& p) {
  return p.B >= 1 && p.T >= 1 && p.Dx >= 1 && p.Dh >= 1 &&
         (long long)p.B * ((p.Dh + 63) / 64) <= 0x7fffffffLL;
}

// Launch on stream s; *body gets the body it took (1 tensor cores, 0
// CUDA cores).
template <int G>
int launch(int bf16, int log_mode, int normalize, const Params& p,
           cudaStream_t s, int* body) {
  if (!valid_shape(p)) return (int)cudaErrorInvalidValue;
  const Choice c = choose<G>(bf16, log_mode, normalize, p);
  *body = c.body;
  if (c.smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        c.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem);
    if (e != cudaSuccess) return (int)e;
  }
  void* args[] = {const_cast<Params*>(&p)};
  const cudaError_t e = cudaLaunchKernel(
      reinterpret_cast<const void*>(c.fn), c.grid, dim3(c.threads), args,
      (size_t)c.smem, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// What a launch of these operands would run: out[0] the body (1 tensor
// cores, 0 CUDA cores), out[1] resident blocks per SM (the occupancy
// query), out[2] grid blocks, out[3] the device's SMs.  Launches nothing.
template <int G>
int occupancy(int bf16, int log_mode, int normalize, const Params& p,
              int* out) {
  if (!valid_shape(p)) return (int)cudaErrorInvalidValue;
  const Choice c = choose<G>(bf16, log_mode, normalize, p);
  cudaError_t e = cudaSuccess;
  if (c.smem > 0)
    e = cudaFuncSetAttribute(
        c.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, c.fn,
                                                      c.threads, c.smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = c.body;
  out[1] = per_sm;
  out[2] = (int)(c.grid.x * c.grid.y);
  out[3] = sms;
  return (int)e;
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
