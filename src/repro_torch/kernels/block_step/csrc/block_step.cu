// Whole-block minRNN decode kernel for Hopper (sm_90a), step and chunk form.
//
// Replaces the Pallas TPU kernels block_step_kernel and block_chunk_kernel
// (src/repro/kernels/block_step/kernel.py, _block_step_body and
// _block_chunk_body).  One launch runs a whole residual block for every
// row of the batch and every position of the chunk:
//
//     y  = RMSNorm(x) ; y = ConvStep(y)                  [optional conv]
//     h  = cell(y, h_prev)     minGRU / minLSTM (stable f/(f+i)), fp32
//     xr = x + Down(h)
//     y  = xr + MLPout(gelu(MLPin(RMSNorm(xr))))         [optional MLP]
//
// Bound.  At serving batch sizes the block is a batched GEMV: every weight
// byte is read once per launch and used for at most B*C multiply-adds.  At
// mingru-lm's full width (Dx 768, Dh 1536, Dm 3072) one layer's weights
// are about 16.5 MB in bf16, about 4.9 us at the H100's 3.35 TB/s; the
// activations are a few KB.  So the kernel is bound by weight bytes.
//
// Design.  The TPU kernel walks a sequential grid over Dh tiles and
// accumulates the down product in VMEM scratch; a Hopper grid runs in no
// order, so that carry cannot exist here.  Instead ONE cooperative launch
// spreads four phases over all SMs, with a grid-wide barrier between
// them (cooperative_groups::this_grid().sync()):
//   A  split over Dh: every block recomputes RMSNorm(x) and the conv step
//      for the batch rows (cheap: a few KB), then its Dh slice of the gate
//      GEMVs and the cell update, and writes h.  Block 0 writes the window.
//   B  split over Dx: xr = x + Down(h).
//   C  split over Dm: m = gelu(RMSNorm(xr) W_in + b_in).
//   D  split over Dx: y = xr + m W_out + b_out.
// Phase results pass through small device scratch (xr, m) that the wrapper
// allocates.  The chunk form loops t over C inside the launch, so each
// layer's weights stream from memory once per position but the launch and
// the barriers are paid once per chunk per phase.  Rows freeze (h, window)
// at t >= valid[b]; their down / MLP read the frozen h.
//
// Determinism.  Every output element is reduced by a fixed thread in a
// fixed order that depends only on (Dx, Dh, Dm): a work unit is 16 output
// columns over the whole contraction, split into 64 k-lanes that each sum
// k = lane, lane+64, ... in ascending order; the 8 k-lanes of a warp are
// then combined by a fixed xor butterfly and the 8 warps in order 0..7.
// The batch tile, the chunk length and the grid size only change WHICH
// block does a unit, never how.  So a C-token chunk equals C step launches
// bit for bit, and a row's result does not depend on B.
//
// Cast points follow kernel.py:136-157: RMSNorm in fp32 and back to the
// element type T; the conv in T (fp32 sum, rounded to T, bias added in T);
// gates and cell in fp32 from T-valued inputs; h rounded to T; the down
// and MLP products rounded to T before each bias / residual add.
//
// Latency, not bandwidth, limits a GEMV this narrow, so each thread keeps
// 8 weight rows of 4 columns in flight (8- or 16-byte loads) and every
// staging pass reads 8 elements per load with all 256 threads.  Plain
// coalesced loads and fp32 FMAs; no wgmma or TMA yet.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBT = 8;                  // batch rows per tile: one warp per row
constexpr int kTN = 16;                 // output columns per work unit
constexpr int kVec = 4;                 // columns per weight load
constexpr int kGroups = kTN / kVec;     // column groups per unit
constexpr int kLanes = kThreads / kGroups;   // 64 k-lanes, 8 per warp
constexpr int kUnroll = 8;              // weight rows in flight per thread
constexpr int kRed = kWarps * kBT * kTN;     // warp partials per unit
constexpr int kRsOff = kRed;                 // 1/rms of the tile's rows
constexpr int kAOff = kRed + 2 * kBT;        // staged GEMV inputs
constexpr float kEps = 1e-6f;

struct Params {
  const void* x;        // (B, C, Dx)          T
  const void* gamma;    // (Dx,)               T   RMSNorm scale
  const void* conv_k;   // (K, Dx)             T
  const void* conv_b;   // (Dx,)               T
  const void* win0;     // (B, K-1, Dx)        T   carried window
  const void* w[3];     // (Dx, Dh) x n_gates  T
  const void* b[3];     // (Dh,) x n_gates     T
  const void* h0;       // (B, Dh)             T   carried h
  const void* down;     // (Dh, Dx)            T
  const void* gamma2;   // (Dx,)               T
  const void* wi;       // (Dx, Dm)            T
  const void* bi;       // (Dm,)               T
  const void* wo;       // (Dm, Dx)            T
  const void* bo;       // (Dx,)               T
  const int* valid;     // (B,) int32 or null (= all positions valid)
  void* ys;             // (B, C, Dx)          T   out
  void* hs;             // (B, C, Dh)          T   out
  void* wins;           // (B, C, K-1, Dx)     T   out (use_conv)
  void* xr;             // (B, Dx)             T   scratch (use_mlp)
  void* m;              // (B, Dm)             T   scratch (use_mlp)
  long long* trace;     // (1 + 7 C,) int64 or null: block 0's
                        // %globaltimer (ns) at launch, then per position
                        // after each phase and each barrier
  int B, C, Dx, Dh, Dm, K, use_conv, use_mlp;
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
  return __float2bfloat16_rn(v);
}

// round to the element type and back: the cast points of the reference
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ void unpack2(uint32_t u, float* f) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  f[0] = v.x;
  f[1] = v.y;
}

// 4 consecutive elements (weights: 8- or 16-byte aligned by construction)
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  unpack2(v.x, f);
  unpack2(v.y, f + 2);
}

// 8 consecutive elements.  Plain (not read-only-path) loads: some of these
// buffers are written earlier in the same launch.
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  unpack2(v.x, f); unpack2(v.y, f + 2); unpack2(v.z, f + 4);
  unpack2(v.w, f + 6);
}
__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
      pack2(f[6], f[7]));
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}
__device__ __forceinline__ float softplusf_(float x) {  // logaddexp(x, 0)
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float g_(float v) {
  return v >= 0.0f ? v + 0.5f : sigmoidf_(v);
}
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same bits (fp add commutes)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kUnroll weight rows k0, k0 + kLanes, ... of this thread's 4 columns.
template <typename T>
__device__ __forceinline__ void load_rows(const T* wp, int N, int K, int k0,
                                          float (&w)[kUnroll][kVec]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int k = k0 + u * kLanes;
    if (k < K) {
      load4(wp + (size_t)k * N, w[u]);
    } else {
#pragma unroll
      for (int c = 0; c < kVec; ++c) w[u][c] = 0.0f;
    }
  }
}

// One work unit of a batched GEMV: out[r, col0 + c] for the BT staged rows
// a[r * K + k] (fp32 in shared memory) against W (K, N) row-major.  Thread
// tid < BT*TN returns the sum for row tid / TN, column tid % TN.
template <typename T>
__device__ float gemv_unit(const T* __restrict__ W, int N, int K, int col0,
                           const float* __restrict__ a, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cgp = tid % kGroups;
  const int kl = tid / kGroups;
  float acc[kBT][kVec];
#pragma unroll
  for (int r = 0; r < kBT; ++r)
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[r][c] = 0.0f;
  const T* wp = W + col0 + kVec * cgp;
  // software-pipelined: the next kUnroll weight rows are in flight while
  // this iteration's FMAs run (left to itself the compiler sinks each
  // load to its first use, serialising kUnroll memory latencies).  Rows
  // past K load as zeros; adding +0 changes no sum.
  float wn[kUnroll][kVec];
  load_rows(wp, N, K, kl, wn);
  for (int k0 = kl; k0 < K; k0 += kUnroll * kLanes) {
    float w[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int c = 0; c < kVec; ++c) w[u][c] = wn[u][c];
    load_rows(wp, N, K, k0 + kUnroll * kLanes, wn);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kLanes;
#pragma unroll
      for (int r = 0; r < kBT; ++r) {
        const float av = k < K ? a[r * K + k] : 0.0f;
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[r][c] = fmaf(av, w[u][c], acc[r][c]);
      }
    }
  }
  // the 8 k-lanes of a warp differ in lane bits 2..4
#pragma unroll
  for (int r = 0; r < kBT; ++r)
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      float v = acc[r][c];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[r][c] = v;
    }
  if (lane < kGroups) {
#pragma unroll
    for (int r = 0; r < kBT; ++r)
#pragma unroll
      for (int c = 0; c < kVec; ++c)
        red[(warp * kBT + r) * kTN + kVec * cgp + c] = acc[r][c];
  }
  __syncthreads();
  float s = 0.0f;
  if (tid < kBT * kTN) {
    const int r = tid / kTN, c = tid % kTN;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * kBT + r) * kTN + c];
  }
  __syncthreads();
  return s;
}

// 1/rms of row b0 + warp into rs[warp] (0 for rows past B).
template <typename T>
__device__ void stage_rsqrt(const T* __restrict__ base, size_t row_stride,
                            int B, int b0, int D, float* rs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = b0 + warp;
  float ss = 0.0f;
  if (b < B) {
    const T* row = base + (size_t)b * row_stride;
    for (int v = lane; v < D / 8; v += 32) {
      float f[8];
      load8(row + 8 * v, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) ss = fmaf(f[i], f[i], ss);
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) rs[warp] = b < B ? rsqrtf(ss / (float)D + kEps) : 0.0f;
}

// Phase A staging: a[r, :] = T(conv(T(RMSNorm(x[b, t])))) for the tile's
// rows; block 0 also writes the carried window after position t.
template <typename T>
__device__ void stage_mixer_input(const Params& p, int t, int b0, float* a,
                                  float* rs, bool write_window) {
  const int Dx = p.Dx, W = p.K - 1, per_row = Dx / 8;
  const T* x = static_cast<const T*>(p.x);
  const T* gamma = static_cast<const T*>(p.gamma);
  const T* ck = static_cast<const T*>(p.conv_k);
  const T* cb = static_cast<const T*>(p.conv_b);
  stage_rsqrt<T>(x + (size_t)t * Dx, (size_t)p.C * Dx, p.B, b0, Dx, rs);
  __syncthreads();
  for (int v = threadIdx.x; v < kBT * per_row; v += kThreads) {
    const int r = v / per_row, d0 = (v % per_row) * 8, b = b0 + r;
    float y[8];
    if (b >= p.B) {
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = 0.0f;
      store8(a + r * Dx + d0, y);
      continue;
    }
    float xv[8], gv[8];
    load8(x + ((size_t)b * p.C + t) * Dx + d0, xv);
    load8(gamma + d0, gv);
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = rnd<T>(xv[i] * rs[r] * gv[i]);
    if (p.use_conv) {
      const T* wprev = t == 0
          ? static_cast<const T*>(p.win0) + (size_t)b * W * Dx
          : static_cast<const T*>(p.wins) + ((size_t)b * p.C + t - 1) * W * Dx;
      float acc[8], wv[8], cv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
      for (int k = 0; k < W; ++k) {
        load8(wprev + (size_t)k * Dx + d0, wv);
        load8(ck + (size_t)k * Dx + d0, cv);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(wv[i], cv[i], acc[i]);
      }
      load8(ck + (size_t)W * Dx + d0, cv);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(y[i], cv[i], acc[i]);
      if (write_window) {
        const bool keep = p.valid == nullptr || t < p.valid[b];
        T* wout = static_cast<T*>(p.wins) + ((size_t)b * p.C + t) * W * Dx;
        for (int k = 0; k < W; ++k) {
          if (keep && k + 1 == W) {
            store8(wout + (size_t)k * Dx + d0, y);
          } else {
            load8(wprev + (size_t)(keep ? k + 1 : k) * Dx + d0, wv);
            store8(wout + (size_t)k * Dx + d0, wv);
          }
        }
      }
      load8(cb + d0, cv);
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = rnd<T>(rnd<T>(acc[i]) + cv[i]);
    }
    store8(a + r * Dx + d0, y);
  }
}

// Stage T-valued rows src[b * row_stride + d] of the tile into a (fp32).
template <typename T>
__device__ void stage_rows(const T* __restrict__ src, size_t row_stride,
                           int B, int b0, int D, float* a) {
  const int per_row = D / 8;
  for (int v = threadIdx.x; v < kBT * per_row; v += kThreads) {
    const int r = v / per_row, d0 = (v % per_row) * 8, b = b0 + r;
    float f[8];
    if (b < B) {
      load8(src + (size_t)b * row_stride + d0, f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = 0.0f;
    }
    store8(a + r * D + d0, f);
  }
}

template <typename T, bool kLSTM, bool kLog>
__device__ void phase_a(const Params& p, int t, float* a, float* red,
                        float* rs) {
  const int n_units = p.Dh / kTN;
  if ((int)blockIdx.x >= n_units) return;
  const int tid = threadIdx.x;
  for (int b0 = 0; b0 < p.B; b0 += kBT) {
    stage_mixer_input<T>(p, t, b0, a, rs, blockIdx.x == 0);
    __syncthreads();
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int j0 = u * kTN;
      float pre[3];
      constexpr int n_gates = kLSTM ? 3 : 2;
#pragma unroll
      for (int g = 0; g < n_gates; ++g)
        pre[g] = gemv_unit<T>(static_cast<const T*>(p.w[g]), p.Dh, p.Dx, j0,
                              a, red);
      if (tid < kBT * kTN) {
        const int b = b0 + tid / kTN, j = j0 + tid % kTN;
        if (b < p.B) {
          const T* hprev_p =
              t == 0 ? static_cast<const T*>(p.h0) + (size_t)b * p.Dh
                     : static_cast<const T*>(p.hs) +
                           ((size_t)b * p.C + t - 1) * p.Dh;
          const T hprev = hprev_p[j];
          const float h32 = to_f(hprev);
          float h;
          if (!kLSTM) {
            const float kz = pre[0] + to_f(static_cast<const T*>(p.b[0])[j]);
            const float v = pre[1] + to_f(static_cast<const T*>(p.b[1])[j]);
            const float z = sigmoidf_(kz);
            const float ht = kLog ? g_(v) : v;
            h = (1.0f - z) * h32 + z * ht;
          } else {
            const float kf = pre[0] + to_f(static_cast<const T*>(p.b[0])[j]);
            const float ki = pre[1] + to_f(static_cast<const T*>(p.b[1])[j]);
            const float v = pre[2] + to_f(static_cast<const T*>(p.b[2])[j]);
            const float diff = softplusf_(-kf) - softplusf_(-ki);
            const float f = sigmoidf_(-diff), i = sigmoidf_(diff);
            const float ht = kLog ? g_(v) : v;
            h = f * h32 + i * ht;
          }
          const bool keep = p.valid == nullptr || t < p.valid[b];
          static_cast<T*>(p.hs)[((size_t)b * p.C + t) * p.Dh + j] =
              keep ? from_f<T>(h) : hprev;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
__device__ void phase_b(const Params& p, int t, float* a, float* red) {
  const int n_units = p.Dx / kTN;
  if ((int)blockIdx.x >= n_units) return;
  const int tid = threadIdx.x;
  const T* hs = static_cast<const T*>(p.hs) + (size_t)t * p.Dh;
  for (int b0 = 0; b0 < p.B; b0 += kBT) {
    stage_rows<T>(hs, (size_t)p.C * p.Dh, p.B, b0, p.Dh, a);
    __syncthreads();
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int i0 = u * kTN;
      const float s = gemv_unit<T>(static_cast<const T*>(p.down), p.Dx, p.Dh,
                                   i0, a, red);
      if (tid < kBT * kTN) {
        const int b = b0 + tid / kTN, i = i0 + tid % kTN;
        if (b < p.B) {
          const size_t xi = ((size_t)b * p.C + t) * p.Dx + i;
          const T xr = from_f<T>(to_f(static_cast<const T*>(p.x)[xi]) + rnd<T>(s));
          if (p.use_mlp) static_cast<T*>(p.xr)[(size_t)b * p.Dx + i] = xr;
          else static_cast<T*>(p.ys)[xi] = xr;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
__device__ void phase_c(const Params& p, float* a, float* red, float* rs) {
  const int n_units = p.Dm / kTN;
  if ((int)blockIdx.x >= n_units) return;
  const int tid = threadIdx.x, Dx = p.Dx, per_row = Dx / 8;
  const T* xr = static_cast<const T*>(p.xr);
  const T* gamma2 = static_cast<const T*>(p.gamma2);
  for (int b0 = 0; b0 < p.B; b0 += kBT) {
    stage_rsqrt<T>(xr, (size_t)Dx, p.B, b0, Dx, rs);
    __syncthreads();
    for (int v = tid; v < kBT * per_row; v += kThreads) {
      const int r = v / per_row, d0 = (v % per_row) * 8, b = b0 + r;
      float y[8];
      if (b < p.B) {
        float xv[8], gv[8];
        load8(xr + (size_t)b * Dx + d0, xv);
        load8(gamma2 + d0, gv);
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i] = rnd<T>(xv[i] * rs[r] * gv[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i] = 0.0f;
      }
      store8(a + r * Dx + d0, y);
    }
    __syncthreads();
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int j0 = u * kTN;
      const float s = gemv_unit<T>(static_cast<const T*>(p.wi), p.Dm, Dx, j0,
                                   a, red);
      if (tid < kBT * kTN) {
        const int b = b0 + tid / kTN, j = j0 + tid % kTN;
        if (b < p.B) {
          const float mm =
              rnd<T>(rnd<T>(s) + to_f(static_cast<const T*>(p.bi)[j]));
          static_cast<T*>(p.m)[(size_t)b * p.Dm + j] = from_f<T>(gelu_tanh(mm));
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
__device__ void phase_d(const Params& p, int t, float* a, float* red) {
  const int n_units = p.Dx / kTN;
  if ((int)blockIdx.x >= n_units) return;
  const int tid = threadIdx.x;
  for (int b0 = 0; b0 < p.B; b0 += kBT) {
    stage_rows<T>(static_cast<const T*>(p.m), (size_t)p.Dm, p.B, b0, p.Dm, a);
    __syncthreads();
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int i0 = u * kTN;
      const float s = gemv_unit<T>(static_cast<const T*>(p.wo), p.Dx, p.Dm, i0,
                                   a, red);
      if (tid < kBT * kTN) {
        const int b = b0 + tid / kTN, i = i0 + tid % kTN;
        if (b < p.B) {
          const float o =
              rnd<T>(rnd<T>(s) + to_f(static_cast<const T*>(p.bo)[i]));
          const float xr = to_f(static_cast<const T*>(p.xr)[(size_t)b * p.Dx + i]);
          static_cast<T*>(p.ys)[((size_t)b * p.C + t) * p.Dx + i] =
              from_f<T>(xr + o);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, bool kLSTM, bool kLog>
__global__ void __launch_bounds__(kThreads, 1)
block_kernel(Params p) {
  extern __shared__ float smem[];
  float* red = smem;
  float* rs = smem + kRsOff;
  float* a = smem + kAOff;                    // kBT * max(Dx, Dh, Dm)
  cg::grid_group grid = cg::this_grid();
  const bool tracing = p.trace != nullptr && blockIdx.x == 0 &&
                       threadIdx.x == 0;
  if (tracing) p.trace[0] = now_ns();
  for (int t = 0; t < p.C; ++t) {
    long long* tr = tracing ? p.trace + 1 + 7 * t : nullptr;
    phase_a<T, kLSTM, kLog>(p, t, a, red, rs);
    if (tracing) tr[0] = now_ns();
    grid.sync();                              // h (and the window) ready
    if (tracing) tr[1] = now_ns();
    phase_b<T>(p, t, a, red);
    if (tracing) tr[2] = now_ns();
    if (p.use_mlp) {
      grid.sync();                            // xr ready
      if (tracing) tr[3] = now_ns();
      phase_c<T>(p, a, red, rs);
      if (tracing) tr[4] = now_ns();
      grid.sync();                            // m ready
      if (tracing) tr[5] = now_ns();
      phase_d<T>(p, t, a, red);
      if (tracing) tr[6] = now_ns();
    }
    // no barrier before the next position: phase A reads only x, h and
    // the window, which phases B-D do not write, and the barrier after
    // it orders every phase-D read of xr / m before the next write
  }
}

int smem_bytes(const Params& p) {
  int kmax = p.Dx > p.Dh ? p.Dx : p.Dh;
  if (p.use_mlp && p.Dm > kmax) kmax = p.Dm;
  return (kAOff + kBT * kmax) * (int)sizeof(float);
}

struct LaunchCache {
  int device = -1, smem = -1, grid_cap = 0, blocks_per_sm = 0, sms = 0;
};

template <typename T, bool kLSTM, bool kLog>
int launch(const Params& p, cudaStream_t stream, int* grid_out) {
  static LaunchCache cache;
  auto kernel = block_kernel<T, kLSTM, kLog>;
  const int smem = smem_bytes(p);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (cache.device != device || cache.smem != smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cache.device = device;
    cache.smem = smem;
    cache.blocks_per_sm = per_sm;
    cache.sms = sms;
    cache.grid_cap = per_sm * sms;
  }
  // more blocks than the widest phase has units would only idle
  int units = p.Dh / kTN;
  if (p.Dx / kTN > units) units = p.Dx / kTN;
  if (p.use_mlp && p.Dm / kTN > units) units = p.Dm / kTN;
  const int grid = units < cache.grid_cap ? units : cache.grid_cap;
  if (grid_out) *grid_out = grid;
  Params args = p;
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), kargs, (size_t)smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one whole-block step (C == 1, valid == null) or varlen chunk.
// ptrs: x, gamma, conv_k, conv_b, win0, w0, w1, w2, b0, b1, b2, h0, down,
//       gamma2, wi, bi, wo, bo, valid, ys, hs, wins, xr, m, trace
//       (25 pointers; valid and trace may be null).
// Returns 0 or the cudaError_t of the launch.
int repro_block_launch(int lstm, int log_mode, int bf16, int use_conv,
                       int use_mlp, int B, int C, int Dx, int Dh, int Dm,
                       int K, void* const* ptrs, void* stream, int* grid_out) {
  if (Dx % kTN || Dh % kTN || (use_mlp && Dm % kTN) || B < 1 || C < 1 ||
      (use_conv && K < 2))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = ptrs[0]; p.gamma = ptrs[1]; p.conv_k = ptrs[2]; p.conv_b = ptrs[3];
  p.win0 = ptrs[4];
  for (int g = 0; g < 3; ++g) { p.w[g] = ptrs[5 + g]; p.b[g] = ptrs[8 + g]; }
  p.h0 = ptrs[11]; p.down = ptrs[12]; p.gamma2 = ptrs[13]; p.wi = ptrs[14];
  p.bi = ptrs[15]; p.wo = ptrs[16]; p.bo = ptrs[17];
  p.valid = static_cast<const int*>(ptrs[18]);
  p.ys = ptrs[19]; p.hs = ptrs[20]; p.wins = ptrs[21]; p.xr = ptrs[22];
  p.m = ptrs[23];
  p.trace = static_cast<long long*>(ptrs[24]);
  p.B = B; p.C = C; p.Dx = Dx; p.Dh = Dh; p.Dm = Dm; p.K = K;
  p.use_conv = use_conv; p.use_mlp = use_mlp;
  if (smem_bytes(p) > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = (lstm ? 4 : 0) | (log_mode ? 2 : 0) | (bf16 ? 1 : 0);
  switch (key) {
    case 0: return launch<float, false, false>(p, s, grid_out);
    case 1: return launch<__nv_bfloat16, false, false>(p, s, grid_out);
    case 2: return launch<float, false, true>(p, s, grid_out);
    case 3: return launch<__nv_bfloat16, false, true>(p, s, grid_out);
    case 4: return launch<float, true, false>(p, s, grid_out);
    case 5: return launch<__nv_bfloat16, true, false>(p, s, grid_out);
    case 6: return launch<float, true, true>(p, s, grid_out);
    default: return launch<__nv_bfloat16, true, true>(p, s, grid_out);
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
