// Cell-only minGRU / minLSTM decode kernels for Hopper (sm_90a), step and
// chunk form.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/decode_step/kernel.py:
// mingru_step_kernel, mingru_chunk_kernel, minlstm_step_kernel and
// minlstm_chunk_kernel.  One launch runs the cell for every row of the
// batch and every position of the chunk:
//
//     pre_g = x W_g + b_g           G = 2 (W_z, W_h) or 3 (W_f, W_i, W_h)
//     minGRU:  z = sigmoid(k); h~ = g(v) (log mode) | v
//              h = (1 - z) h_prev + z h~
//     minLSTM: f', i' = sigmoid(-d), sigmoid(d), d = softplus(-kf) -
//              softplus(-ki) (the stable f/(f+i); plain sigmoids without
//              normalize); h = f' h_prev + i' h~
//
// all in fp32 from T-valued inputs (T = float or bfloat16); h is rounded to
// T after every token (kernel.py:140 / :277), so a bf16 chunk equals
// sequential steps that re-read h from a T-valued cache.  The norm, conv,
// down projection and MLP around the cell stay PyTorch ops.
//
// Bound.  At serving batch sizes a launch is a batched GEMV: every weight
// byte is read once per launch and used for B (or B*C) multiply-adds.  At
// mingru-lm's width (Dx 768, Dh 1536, bf16) the two projections are 4.72 MB,
// about 1.41 us at the H100's 3.35 TB/s; minlstm-lm's three 7.08 MB, about
// 2.11 us; gemma-2b-mingru's (2048 x 2048) two 16.8 MB, about 5.0 us.  x, h
// and the output are a few KB.  So the kernel is bound by weight bytes.
//
// Design.  Block (u, bt) owns a unit of 16 Dh columns for batch tile bt (8
// rows).  When the unit's G weight tiles (G * Dx * 16 elements) fit in
// shared memory with the x tile -- every bf16 width the LMs use, and fp32 up
// to minlstm-lm's -- the block stages them once and then loops t over C:
// the TPU kernel's "weights resident, x per token", carried to Hopper.
// Otherwise (fp32 at gemma width) each token reads the tile from device
// memory (an L2 hit after the first token); the values and the order are
// the same.  h stays in an fp32 register of the thread that owns (row,
// column) across t.  Rows with t >= valid[b] keep their h and write it
// again; valid is read here, on the device.  Ragged Dx, Dh and B are
// masked (zero operands, no stores), not padded.
//
// Determinism.  Every pre-activation is summed by a fixed thread in a fixed
// order that depends only on Dx: 64 k-lanes each sum k = lane, lane + 64,
// ... in ascending order, the 8 k-lanes of a warp are combined by a fixed
// xor butterfly, then the 8 warps in order 0..7 (the order of
// block_step.cu).  The batch tile, the chunk length, the grid and whether
// the weights were staged change only WHICH block does a unit and where it
// reads the weights from, never the arithmetic.  So a C-token chunk equals
// C step launches bit for bit, and a row's result does not depend on B.
//
// Plain coalesced 16-byte loads for staging and fp32 FMAs from shared
// memory; no wgmma or TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBT = 8;                  // batch rows per tile
constexpr int kTN = 16;                 // Dh columns per unit
constexpr int kVec = 4;                 // columns per thread
constexpr int kGroups = kTN / kVec;     // column groups per unit
constexpr int kLanes = kThreads / kGroups;   // 64 k-lanes, 8 per warp
constexpr int kRedBytes = kWarps * kBT * kTN * (int)sizeof(float);
constexpr int kSmemCap = 232448;        // 227 KB a block may use

struct Params {
  const void* x;        // (B, C, Dx)   T
  const void* w[3];     // (Dx, Dh) x G T
  const void* b[3];     // (Dh,) x G    T
  const void* h0;       // (B, Dh)      T, or float32 when h0_f32
  const int* valid;     // (B,) int32 or null (= every position valid)
  void* out;            // (B, C, Dh)   T
  int B, C, Dx, Dh, log_mode, normalize, h0_f32;
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

// round to the element type and back: the per-token cast of the reference
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// 4 consecutive elements of a staged tile (8- or 16-byte aligned)
__device__ __forceinline__ void ld4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
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

__host__ __device__ __forceinline__ int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// Stage columns j0 .. j0+15 of a (rows, ld) row-major matrix into dst
// (rows, 16); columns past ncols are zero.  vec: 16-byte loads (ld and the
// base allow them), else one element per load.
template <typename T>
__device__ void stage_cols(const T* __restrict__ src, int ld, int j0,
                           int ncols, int rows, T* dst, bool vec) {
  constexpr int per16 = 16 / (int)sizeof(T);
  constexpr int chunks = kTN / per16;
  if (vec) {
#pragma unroll 4
    for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
      const int k = e / chunks, c0 = (e % chunks) * per16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c0 < ncols)
        v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)k * ld + j0 + c0));
      *reinterpret_cast<uint4*>(dst + k * kTN + c0) = v;
    }
  } else {
    for (int e = threadIdx.x; e < rows * kTN; e += kThreads) {
      const int k = e / kTN, c = e % kTN;
      dst[k * kTN + c] = c < ncols ? src[(size_t)k * ld + j0 + c]
                                   : from_f<T>(0.0f);
    }
  }
}

// Stage x[b0 + r, t, :] (r < 8) into a (8, Dx); rows past B are zero.
template <typename T>
__device__ void stage_x(const T* __restrict__ x, int B, int C, int Dx,
                        int b0, int t, T* a, bool vec) {
  constexpr int per16 = 16 / (int)sizeof(T);
  if (vec) {
    const int per_row = Dx / per16;
#pragma unroll 4
    for (int e = threadIdx.x; e < kBT * per_row; e += kThreads) {
      const int r = e / per_row, d0 = (e % per_row) * per16, b = b0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (b < B)
        v = *reinterpret_cast<const uint4*>(x + ((size_t)b * C + t) * Dx + d0);
      *reinterpret_cast<uint4*>(a + r * Dx + d0) = v;
    }
  } else {
    for (int e = threadIdx.x; e < kBT * Dx; e += kThreads) {
      const int r = e / Dx, d = e % Dx, b = b0 + r;
      a[r * Dx + d] = b < B ? x[((size_t)b * C + t) * Dx + d]
                            : from_f<T>(0.0f);
    }
  }
}

// One projection of the unit: sum_k a[r, k] W[k, c] for the 8 staged rows
// and the unit's 16 columns.  W is the staged tile (row stride 16) or, when
// not staged, the device matrix offset to the unit (row stride ldw, columns
// past ncols read as zero).  Thread tid < 8*16 returns the sum of row
// tid / 16, column tid % 16.
template <typename T, bool kStaged>
__device__ float gemv_unit(const T* __restrict__ W, int ldw, int ncols,
                           int Dx, const T* __restrict__ a, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid % kGroups;
  const int kl = tid / kGroups;
  float acc[kBT][kVec];
#pragma unroll
  for (int r = 0; r < kBT; ++r)
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
  for (int k = kl; k < Dx; k += kLanes) {
    float w[kVec];
    if (kStaged) {
      ld4(W + k * kTN + kVec * cg, w);
    } else {
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const int col = kVec * cg + c;
        w[c] = col < ncols ? to_f(W[(size_t)k * ldw + col]) : 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < kBT; ++r) {
      const float av = to_f(a[r * Dx + k]);
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[r][c] = fmaf(av, w[c], acc[r][c]);
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
        red[(warp * kBT + r) * kTN + kVec * cg + c] = acc[r][c];
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

template <typename T, int G, bool kStaged>
__global__ void __launch_bounds__(kThreads)
cell_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  T* a = reinterpret_cast<T*>(smem + kRedBytes);
  T* wt = reinterpret_cast<T*>(smem + kRedBytes +
                               align16(kBT * p.Dx * (int)sizeof(T)));
  constexpr int per16 = 16 / (int)sizeof(T);
  const int Dx = p.Dx, Dh = p.Dh;
  const int j0 = blockIdx.x * kTN;
  const int ncols = min(kTN, Dh - j0);
  const int b0 = blockIdx.y * kBT;
  const T* x = static_cast<const T*>(p.x);
  const bool x_vec = Dx % per16 == 0 && ((uintptr_t)x & 15) == 0;

  const T* ws[G];
  int ldw = kTN;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* w = static_cast<const T*>(p.w[g]);
    if (kStaged) {
      const bool w_vec = Dh % per16 == 0 && ((uintptr_t)w & 15) == 0;
      stage_cols<T>(w, Dh, j0, ncols, Dx, wt + (size_t)g * Dx * kTN, w_vec);
      ws[g] = wt + (size_t)g * Dx * kTN;
    } else {
      ws[g] = w + j0;
      ldw = Dh;
    }
  }

  const int tid = threadIdx.x;
  const int r = tid / kTN, c = tid % kTN, b = b0 + r, j = j0 + c;
  const bool mine = tid < kBT * kTN && b < p.B && c < ncols;
  float h = 0.0f, bias[G];
#pragma unroll
  for (int g = 0; g < G; ++g) bias[g] = 0.0f;
  int vlen = p.C;
  if (mine) {
    h = p.h0_f32 ? static_cast<const float*>(p.h0)[(size_t)b * Dh + j]
                 : to_f(static_cast<const T*>(p.h0)[(size_t)b * Dh + j]);
#pragma unroll
    for (int g = 0; g < G; ++g) bias[g] = to_f(static_cast<const T*>(p.b[g])[j]);
    if (p.valid != nullptr) vlen = p.valid[b];
  }
  T* out = static_cast<T*>(p.out);

  for (int t = 0; t < p.C; ++t) {
    stage_x<T>(x, p.B, p.C, Dx, b0, t, a, x_vec);
    __syncthreads();                // x tile (and, at t = 0, the weights)
    float pre[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      pre[g] = gemv_unit<T, kStaged>(ws[g], ldw, ncols, Dx, a, red);
    if (mine) {
      float hn;
      const float v = pre[G - 1] + bias[G - 1];
      const float ht = p.log_mode ? g_(v) : v;
      if (G == 2) {
        const float z = sigmoidf_(pre[0] + bias[0]);
        hn = (1.0f - z) * h + z * ht;
      } else {
        const float kf = pre[0] + bias[0], ki = pre[1] + bias[1];
        float f, i;
        if (p.normalize) {
          const float d = softplusf_(-kf) - softplusf_(-ki);
          f = sigmoidf_(-d);
          i = sigmoidf_(d);
        } else {
          f = sigmoidf_(kf);
          i = sigmoidf_(ki);
        }
        hn = f * h + i * ht;
      }
      if (t < vlen) h = rnd<T>(hn);
      out[((size_t)b * p.C + t) * Dh + j] = from_f<T>(h);
    }
    // gemv_unit ended on a barrier: the next token may restage a
  }
}

int smem_bytes(int Dx, int G, int elem, bool staged) {
  return kRedBytes + align16(kBT * Dx * elem) + (staged ? G * Dx * kTN * elem : 0);
}

template <typename T, int G, bool kStaged>
int launch_one(const Params& p, int smem, cudaStream_t stream) {
  auto kernel = cell_kernel<T, G, kStaged>;
  // opt in to the whole 227 KB once per device; the launch asks for smem
  static bool opted[64] = {false};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemCap);
    if (err != cudaSuccess) return (int)err;
    opted[device] = true;
  }
  const dim3 grid((p.Dh + kTN - 1) / kTN, (p.B + kBT - 1) / kBT);
  cell_kernel<T, G, kStaged><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int G>
int launch_typed(const Params& p, cudaStream_t stream) {
  const int elem = (int)sizeof(T);
  const int staged = smem_bytes(p.Dx, G, elem, true);
  if (staged <= kSmemCap) return launch_one<T, G, true>(p, staged, stream);
  const int plain = smem_bytes(p.Dx, G, elem, false);
  if (plain > kSmemCap) return (int)cudaErrorInvalidValue;
  return launch_one<T, G, false>(p, plain, stream);
}

int launch(int lstm, int log_mode, int normalize, int bf16, int h0_f32,
           int B, int C, int Dx, int Dh, void* const* ptrs, void* stream,
           bool chunk) {
  if (B < 1 || C < 1 || Dx < 1 || Dh < 1 || (!chunk && C != 1) ||
      (B + kBT - 1) / kBT > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = ptrs[0];
  for (int g = 0; g < 3; ++g) { p.w[g] = ptrs[1 + g]; p.b[g] = ptrs[4 + g]; }
  p.h0 = ptrs[7];
  p.valid = chunk ? static_cast<const int*>(ptrs[8]) : nullptr;
  p.out = ptrs[9];
  p.B = B; p.C = C; p.Dx = Dx; p.Dh = Dh;
  p.log_mode = log_mode; p.normalize = normalize; p.h0_f32 = h0_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return lstm ? launch_typed<__nv_bfloat16, 3>(p, s)
                : launch_typed<__nv_bfloat16, 2>(p, s);
  return lstm ? launch_typed<float, 3>(p, s) : launch_typed<float, 2>(p, s);
}

}  // namespace

extern "C" {

// ptrs: x, w0, w1, w2, b0, b1, b2, h0, valid, out (10 pointers; w2 / b2
// unused by minGRU, valid unused by the step form).  bf16 != 0: x, weights,
// biases, out (and h0 unless h0_f32) are bfloat16, else float32.
// Returns 0 or the cudaError_t of the launch.

// One token for every row: C must be 1 (mingru_step_kernel /
// minlstm_step_kernel).
int repro_cell_step_launch(int lstm, int log_mode, int normalize, int bf16,
                           int h0_f32, int B, int C, int Dx, int Dh,
                           void* const* ptrs, void* stream) {
  return launch(lstm, log_mode, normalize, bf16, h0_f32, B, C, Dx, Dh, ptrs,
                stream, false);
}

// A varlen C-token chunk; rows freeze at t >= valid[b] (mingru_chunk_kernel
// / minlstm_chunk_kernel).
int repro_cell_chunk_launch(int lstm, int log_mode, int normalize, int bf16,
                            int h0_f32, int B, int C, int Dx, int Dh,
                            void* const* ptrs, void* stream) {
  return launch(lstm, log_mode, normalize, bf16, h0_f32, B, C, Dx, Dh, ptrs,
                stream, true);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
