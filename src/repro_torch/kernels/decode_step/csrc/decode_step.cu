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
// sequential steps that re-read h from a T-valued cache.  Rows with
// t >= valid[b] keep their h and write it again; valid is read here, on
// the device.  The norm, conv, down projection and MLP around the cell
// stay PyTorch ops.
//
// Bound.  At serving batch sizes a launch is a batched GEMV: every weight
// byte is read once per launch and used for B (or B*C) multiply-adds.  At
// mingru-lm's width (Dx 768, Dh 1536, bf16) the two projections are 4.72 MB,
// about 1.41 us at the H100's 3.35 TB/s; minlstm-lm's three 7.08 MB, about
// 2.11 us; gemma-2b-mingru's (2048 x 2048) two 16.8 MB, about 5.0 us.  x, h
// and the output are a few KB to 100 KB.  So the kernel is bound by weight
// bytes.  A chunk of C 8 at B 8 is 64 rows: 302 MFLOP at mingru-lm's
// width, 0.3 us on the tensor cores but 4.5 us at the CUDA cores' fp32
// peak, so only the tensor cores keep the chunk near its byte bound.
//
// Two bodies.  The wrapper picks one when it binds the weights
// (decode_step/ops.py, cell_body: a function of the cell, the dtype, Dx,
// Dh and the weights' alignment, never of x or C) and passes it to the
// launcher, which runs that body or refuses the launch; it never picks
// another.  So a layer's steps and its chunks run the same body.
//
// * The tensor-core body: bf16 minGRU and minLSTM with Dx and Dh
//   multiples of 8, Dx <= 4096 and 16-byte aligned weights.  A unit is 16
//   Dh columns of one batch tile (8 rows), every position of the chunk.
//   tc::cell_tc_kernel runs it on G gate blocks in one cluster (G = 2
//   for minGRU: W_z, W_h; G = 3 for minLSTM: W_f, W_i, W_h), each owning
//   its gate's 16 columns: one whole 32-byte sector per weight row
//   (8-column units with all gates read part sectors, so every sector
//   crossed L2 more than once, and streamed W markedly slower).  The last
//   block of the cluster, the h~ block, runs the recurrence.  minGRU: 192
//   blocks at mingru-lm's width, 256 at gemma-2b-mingru's, two resident
//   per SM.  minLSTM: 288 blocks at minlstm-lm's width; its gate blocks
//   take one position per pass, which keeps them in the registers and
//   shared memory of three blocks per SM.  One wave on the 132 SMs.
//   1. x (B x C x Dx, read by every block; 16-byte aligned, which the
//      wrapper ensures and the launcher checks) comes by bulk copies
//      multicast to every block of the cluster: one L2 read per unit, not
//      per block.  It is issued first, by warp 0, once the cluster has
//      arrived at its first barrier.
//   2. The block's whole W tile (Dx x 16 bf16, 24 KB / 64 KB) stays in
//      shared memory for the launch, in the caller's (Dx, Dh) layout: one
//      16-byte cp.async per half row, no repacking in device memory (the
//      two halves of a row trade places every 4 rows, against ldmatrix
//      bank conflicts).  Each of the 8 warps owns a fixed slice of the
//      k16 steps and streams it in cp.async groups (8 at gemma's Dx, 4 at
//      mingru-lm's and for minLSTM), two ahead of its multiplies, so the
//      multiplies overlap the stream (a warp that issued its whole slice
//      at once sat blocked in the issue for most of the stream; two
//      producer warps feeding eight consumers could not issue fast
//      enough).
//   3. mma.sync.m16n8k16, bf16 in, fp32 accumulate, with W^T as the m16
//      operand (the unit's 16 columns, ldmatrix.trans of the resident
//      tile) and x^T as the n8 operand (one position's 8 batch rows): one
//      mma per k16 step and position, no padding rows.  Positions go in
//      passes (minGRU: up to 8, as many as shared memory holds beside W
//      for two blocks per SM, 4 at mingru-lm's Dx, 1 at gemma's; minLSTM:
//      1); between passes a cluster barrier, then the next pass's x comes
//      in while the gates and the recurrence run.  A chunk that would
//      take more than one pass and fits one with every gate in a block
//      (mingru-lm's and minlstm-lm's C 8) runs instead on one block per
//      unit, one per SM (96 blocks), x for every position multicast to
//      clusters of four units, no hand-off (tc::cell_tc_joint_kernel):
//      each SM then takes in W and x once.  Where that grid is more than
//      one wave, the chunk stays on gate blocks.
//   4. The warps' partial sums meet in shared memory; all threads add them
//      and the bias and compute what of the gate depends neither on h nor
//      on another gate (minGRU z = sigmoid; minLSTM softplus(-k) under
//      normalize, else sigmoid(k)), write it into the h~ block's shared
//      memory and arrive on its mbarrier for the pass's parity (release,
//      cluster scope); the h~ block keeps h~ = g(v) (or v).
//   5. The h~ block's thread that owns (batch row, column) walks the
//      pass's positions in order: minGRU h = (1 - z) h + z h~; minLSTM
//      f', i' from the two terms (the stable f / (f + i) under normalize),
//      h = f' h + i' h~; in fp32, rounded to bf16 per token, frozen at
//      t >= valid[b].
// * cell_kernel, the CUDA-core body: fp32 (the exact path, held to 1e-4,
//   which TF32 would break) and bf16 that the tensor-core body cannot
//   take.  Block (u, bt) owns a unit of 16 Dh columns for batch
//   tile bt.  When the unit's G weight tiles (G * Dx * 16 elements) fit in
//   shared memory with the x tile -- every bf16 width the LMs use, and
//   fp32 up to minlstm-lm's -- the block stages them once (plain 16-byte
//   loads) and then loops t over C, restaging x and running the GEMV per
//   token on fp32 FMAs from shared memory.  Otherwise (fp32 at gemma
//   width) each token reads the tile from device memory (an L2 hit after
//   the first token); the values and the order are the same.  Ragged Dx,
//   Dh and B are masked (zero operands, no stores), not padded.
//   Where the 8 rows of x do not fit shared memory beside the partial sums
//   (Dx past 7136 in fp32, past 14272 in bf16: deepseek-v3-671b's 7168 in
//   fp32), cell_sliced_kernel stages x in K slices of Ks columns, Ks a
//   multiple of the 64 k-lanes chosen from Dx and the element type alone
//   (slice_cols): as few slices as fit two blocks an SM, of equal width.
//   The weights come from device memory, 4 columns a load where Dh and the
//   address allow.  Each thread keeps every gate's accumulators across
//   the slices of a token, so x is staged once a slice (restaging it for
//   each gate, in the unsliced body's registers, measured 1.34x the time
//   for fp32 minGRU at B 8 x 7168 x 7168 in 2 slices and 1.06-1.17x in
//   bf16 at Dx 16384 on an H100), and the butterfly and the cross-warp sum
//   run once,
//   after the last slice.  A
//   thread's k = kl, kl + 64, ... then runs in ascending order over the
//   slices: the order of the unsliced body.  Wherever the whole row fits,
//   the unsliced body runs, as before.
//
// Determinism.  In either body every pre-activation is summed by a fixed
// thread in an order that depends only on Dx:
// * tensor cores: each warp's k16 steps in ascending order (the fp32
//   accumulator carried from one mma to the next; warp w owns steps
//   [w nk / 8, (w + 1) nk / 8), nk = ceil(Dx / 16)), then the 8 warps'
//   partials added in order 0..7, then the bias;
// * CUDA cores: 64 k-lanes each sum k = lane, lane + 64, ... in ascending
//   order, the 8 k-lanes of a warp are combined by a fixed xor butterfly,
//   then the 8 warps in order 0..7 (the order of block_step.cu).
// The batch tile, the chunk length, the pass, the cp.async grouping, the
// launch shape (gate blocks or one block per unit), a row's place in its mma
// tile, the grid and the launches a batch past 65535 tiles is split into
// (kMaxTiles a launch) change only WHERE a row is computed, never the
// arithmetic.  So a C-token chunk equals C step launches bit
// for bit, and a row's result does not depend on B.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/mma_sm90.cuh"

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
constexpr int kMaxTiles = 65535;        // batch tiles a launch (grid.y)

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

// The unit's sums from every thread's accumulators acc[row][column of its
// group]: the 8 k-lanes of a warp combined by a fixed xor butterfly, then
// the 8 warps' partials in order 0..7.  Thread tid < 8*16 returns the sum
// of row tid / 16, column tid % 16.  Begins and ends on a barrier's far
// side: red is free again on return.
__device__ __forceinline__ float reduce_unit(float (&acc)[kBT][kVec],
                                             float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid % kGroups;
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

// One projection of the unit: sum_k a[r, k] W[k, c] for the 8 staged rows
// and the unit's 16 columns.  W is the staged tile (row stride 16) or, when
// not staged, the device matrix offset to the unit (row stride ldw, columns
// past ncols read as zero).  Thread tid < 8*16 returns the sum of row
// tid / 16, column tid % 16.
template <typename T, bool kStaged>
__device__ float gemv_unit(const T* __restrict__ W, int ldw, int ncols,
                           int Dx, const T* __restrict__ a, float* red) {
  const int tid = threadIdx.x;
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
  return reduce_unit(acc, red);
}

// h after one token (fp32, before the caller's rounding to T) from the G
// gates' pre-activations and biases: minGRU (1 - z) h + z h~; minLSTM
// f' h + i' h~ (the stable f / (f + i) under normalize)
template <int G>
__device__ __forceinline__ float cell_update(const float (&pre)[G],
                                             const float (&bias)[G], float h,
                                             const Params& p) {
  const float v = pre[G - 1] + bias[G - 1];
  const float ht = p.log_mode ? g_(v) : v;
  if (G == 2) {
    const float z = sigmoidf_(pre[0] + bias[0]);
    return (1.0f - z) * h + z * ht;
  }
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
  return f * h + i * ht;
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
      if (t < vlen) h = rnd<T>(cell_update<G>(pre, bias, h, p));
      out[((size_t)b * p.C + t) * Dh + j] = from_f<T>(h);
    }
    // gemv_unit ended on a barrier: the next token may restage a
  }
}

int smem_bytes(int Dx, int G, int elem, bool staged) {
  return kRedBytes + align16(kBT * Dx * elem) + (staged ? G * Dx * kTN * elem : 0);
}

// ---- the CUDA-core body past the widest x tile: x in K slices ----------

// the widest Dx whose 8 rows of x fit shared memory beside the partial
// sums (7136 in fp32, 14272 in bf16): the unsliced body's
__host__ __device__ constexpr int whole_row_max(int elem) {
  return (kSmemCap - kRedBytes) / (kBT * elem);
}

// columns per K slice for a Dx past whole_row_max: as few slices as fit
// in half of it, so that two blocks share an SM, of equal width rounded up
// to the 64 k-lanes (fp32 Dx 7168: 3 x 2432; 2 x 3584, one block an SM,
// measured 1.77x the time on an H100)
__host__ __device__ __forceinline__ int slice_cols(int Dx, int elem) {
  const int cap = whole_row_max(elem) / 2 / kLanes * kLanes;
  const int n = (Dx + cap - 1) / cap;
  return ((Dx + n - 1) / n + kLanes - 1) / kLanes * kLanes;
}

// 4 consecutive elements of a device matrix (16- / 8-byte aligned)
__device__ __forceinline__ void ldg4(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void ldg4(const __nv_bfloat16* p, float* f) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// Stage columns k0 .. k0 + klen - 1 of x[b0 + r, t, :] (r < 8) into a
// (8, Ks); rows past B are zero.  vec: 16-byte loads (Dx a multiple of
// 16 bytes and x aligned; k0 and Ks are multiples of 64).
template <typename T>
__device__ void stage_x_slice(const T* __restrict__ x, int B, int C, int Dx,
                              int b0, int t, int k0, int klen, int Ks, T* a,
                              bool vec) {
  constexpr int per16 = 16 / (int)sizeof(T);
  if (vec) {
    const int per_row = klen / per16;
#pragma unroll 4
    for (int e = threadIdx.x; e < kBT * per_row; e += kThreads) {
      const int r = e / per_row, d0 = (e % per_row) * per16, b = b0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (b < B)
        v = *reinterpret_cast<const uint4*>(
            x + ((size_t)b * C + t) * Dx + k0 + d0);
      *reinterpret_cast<uint4*>(a + r * Ks + d0) = v;
    }
  } else {
    for (int e = threadIdx.x; e < kBT * klen; e += kThreads) {
      const int r = e / klen, d = e % klen, b = b0 + r;
      a[r * Ks + d] = b < B ? x[((size_t)b * C + t) * Dx + k0 + d]
                            : from_f<T>(0.0f);
    }
  }
}

// acc[r][c] += one slice's terms: thread (k-lane kl, column group cg)
// takes k = kl, kl + 64, ... < klen in ascending order, a[r, k] times W[k,
// 4 cg + c], W the device matrix at the slice's first row and the unit's
// first column (row stride ldw; columns past ncols read as zero).  vec: 4
// columns a load where all four are in range (Dh a multiple of 4, W
// aligned).
template <typename T>
__device__ __forceinline__ void slice_acc(float (&acc)[kBT][kVec],
                                          const T* __restrict__ W, int ldw,
                                          int ncols, int klen,
                                          const T* __restrict__ a, int Ks,
                                          bool vec) {
  const int cg = threadIdx.x % kGroups, kl = threadIdx.x / kGroups;
  const bool whole = vec && kVec * cg + kVec <= ncols;
  const T* wp = W + kVec * cg;
#pragma unroll 4
  for (int k = kl; k < klen; k += kLanes) {
    float w[kVec];
    if (whole) {
      ldg4(wp + (size_t)k * ldw, w);
    } else {
#pragma unroll
      for (int c = 0; c < kVec; ++c)
        w[c] = kVec * cg + c < ncols ? to_f(wp[(size_t)k * ldw + c]) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kBT; ++r) {
      const float av = to_f(a[r * Ks + k]);
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[r][c] = fmaf(av, w[c], acc[r][c]);
    }
  }
}

// cell_kernel's unit past whole_row_max: x in K slices of slice_cols(Dx)
// columns, the weights read from device memory, each thread's
// accumulators kept across a token's slices, one reduction after the last.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
cell_sliced_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  T* a = reinterpret_cast<T*>(smem + kRedBytes);
  constexpr int per16 = 16 / (int)sizeof(T);
  const int Dx = p.Dx, Dh = p.Dh, Ks = slice_cols(Dx, (int)sizeof(T));
  const int j0 = blockIdx.x * kTN;
  const int ncols = min(kTN, Dh - j0);
  const int b0 = blockIdx.y * kBT;
  const T* x = static_cast<const T*>(p.x);
  const bool x_vec = Dx % per16 == 0 && ((uintptr_t)x & 15) == 0;
  const T* ws[G];
  bool w_vec = Dh % kVec == 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    ws[g] = static_cast<const T*>(p.w[g]) + j0;
    w_vec = w_vec && ((uintptr_t)p.w[g] & 15) == 0;
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
    float pre[G], acc[G][kBT][kVec];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < kBT; ++i)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][i][e] = 0.0f;
    for (int k0 = 0; k0 < Dx; k0 += Ks) {
      const int klen = min(Ks, Dx - k0);
      stage_x_slice<T>(x, p.B, p.C, Dx, b0, t, k0, klen, Ks, a, x_vec);
      __syncthreads();                // the slice is staged
#pragma unroll
      for (int g = 0; g < G; ++g)
        slice_acc<T>(acc[g], ws[g] + (size_t)k0 * Dh, Dh, ncols, klen, a,
                     Ks, w_vec);
      __syncthreads();                // every thread is done with it
    }
#pragma unroll
    for (int g = 0; g < G; ++g) pre[g] = reduce_unit(acc[g], red);
    if (mine) {
      if (t < vlen) h = rnd<T>(cell_update<G>(pre, bias, h, p));
      out[((size_t)b * p.C + t) * Dh + j] = from_f<T>(h);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16 minGRU and minLSTM)
// ---------------------------------------------------------------------------

namespace tc {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using sm90::bulk_copy_multicast;
using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::fence_mbar_init;
using sm90::ldmatrix_x2;
using sm90::ldmatrix_x4;
using sm90::ldmatrix_x4_trans;
using sm90::mbar_arrive_expect_tx;
using sm90::mbar_arrive_remote;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::mbar_wait_cluster;
using sm90::mma_bf16;

constexpr int kThreads = 256;           // 8 warps, each a slice of K
constexpr int kWarps = kThreads / 32;
constexpr int kBT = 8;                  // batch rows per tile: one n8 tile
constexpr int kTN = 16;                 // Dh columns per unit: one m16 tile
constexpr int kMaxPos = 8;              // positions per pass
constexpr int kJointCluster = 4;        // units per cluster, one block each
// W streams through each warp's slice in kGroups cp.async groups, two
// groups ahead of the multiplies on gate blocks: 8 groups when a warp's
// slice has 16 k16 steps or more (gemma's Dx), else 4 (mingru-lm's: 6
// steps); always 4 for minLSTM's gate blocks (kLstmGroups) and on one
// block per unit, where they are issued all at once
constexpr int kManyGroupsSteps = 16;
constexpr int kJointGroups = 4;
constexpr int kLstmGroups = 4;
constexpr int kMaxDx = 4096;            // W's tile must fit shared memory
// a block's shared memory when two are to be resident on an SM (228 KB
// per SM, 1 KB of it reserved per block)
constexpr int kPairBytes = 112 * 1024;

// Shared memory of one gate block: W [16 nk][kTN] bf16 (its gate's tile;
// the two 16-byte halves of row k swapped when bit 2 of k is set, so that
// ldmatrix is free of bank conflicts), x [pos kBT][xs] bf16, the warps'
// partial sums [kWarps][pos kBT][kTN] fp32, the gate buffers [2 (pass
// parity)][G][pos kBT][kTN] fp32 (the h~ block's are read), the bias
// [kTN] fp32, the mbarriers of x and of the hand-off [2 (pass parity)].
struct Layout {
  int nk;       // k16 steps
  int xs;       // x row stride, elements
  int pos;      // positions per pass
  int x_off, red_off, gate_off, bias_off, bar_off, bytes;
};

// G gates (2 minGRU, 3 minLSTM), at most max_pos positions per pass
__host__ __device__ __forceinline__ Layout layout(int Dx, int C, int G,
                                                  int max_pos) {
  Layout L;
  L.nk = (Dx + 15) / 16;
  L.xs = 16 * L.nk + 8;                 // +16 bytes: no bank conflicts
  const int w_bytes = 16 * L.nk * kTN * 2;
  const int per_pos = kBT * L.xs * 2 + (kWarps + 2 * G) * kBT * kTN * 4;
  const int tail = kTN * 4 + 24;       // bias, three mbarriers
  int pos = (kPairBytes - w_bytes - tail) / per_pos;
  pos = pos < 1 ? 1 : (pos > max_pos ? max_pos : pos);
  if (pos > C) pos = C;
  L.pos = pos;
  L.x_off = w_bytes;
  L.red_off = L.x_off + pos * kBT * L.xs * 2;
  L.gate_off = L.red_off + kWarps * pos * kBT * kTN * 4;
  L.bias_off = L.gate_off + 2 * G * pos * kBT * kTN * 4;
  L.bar_off = L.bias_off + kTN * 4;
  L.bytes = L.bar_off + 24;
  return L;
}

// the positions a pass of a G-gate block takes at most: minLSTM's gate
// blocks run one position per pass, in few enough registers (and shared
// memory) for three blocks per SM, so that a step's 3 Dh / 16 blocks are
// one wave; minGRU's up to kMaxPos, two blocks per SM
__host__ __device__ constexpr int max_pos_of(int G) {
  return G == 3 ? 1 : kMaxPos;
}

// element offset of the 16-byte half `c` of W tile row k
__device__ __forceinline__ int w_at(int k, int c) {
  return k * kTN + ((c ^ (k >> 2)) & 1) * 8;
}

// h after one token, its rounding spelled out so that every tensor-core
// kernel computes it alike.  minGRU: (1 - z) h + z h~.
__device__ __forceinline__ float gru_update(float z, float h, float ht) {
  return __fmaf_rn(1.0f - z, h, __fmul_rn(z, ht));
}
// minLSTM: f' h + (i' h~), where i' h~ is `iht`
__device__ __forceinline__ float lstm_update(float f, float h, float iht) {
  return __fmaf_rn(f, h, iht);
}
// minLSTM's forget / input gate pre-activation k, as a term of one gate:
// softplus(-k) under normalize (f' = sigmoid(-d), i' = sigmoid(d), d =
// softplus(-kf) - softplus(-ki), the stable f / (f + i)), else sigmoid(k)
__device__ __forceinline__ float lstm_term(float k, int normalize) {
  return normalize ? softplusf_(-k) : sigmoidf_(k);
}
// f' and i' from the two gates' terms
__device__ __forceinline__ void lstm_gates(float tf, float ti, int normalize,
                                           float* f, float* i) {
  if (normalize) {
    const float d = tf - ti;
    *f = sigmoidf_(-d);
    *i = sigmoidf_(d);
  } else {
    *f = tf;
    *i = ti;
  }
}

// one of G pointers by a run-time index, without indexing the kernel's
// parameters dynamically
template <int G>
__device__ __forceinline__ const void* pick(const void* const* v, int g) {
  return G == 3 && g == 2 ? v[2] : (g == 1 ? v[1] : v[0]);
}

// cp_async_wait<n> for a run-time n in [0, 1]
__device__ __forceinline__ void cp_async_wait_upto1(int n) {
  if (n) cp_async_wait<1>(); else cp_async_wait<0>();
}

// cp_async_wait<n> for a run-time n in [0, kJointGroups - 1]
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  static_assert(kJointGroups == 4, "one case per group");
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// A unit's G gate blocks, one cluster: rank g owns gate g's W (minGRU z,
// h~; minLSTM f, i, h~), rank G - 1 the recurrence.  At most kMaxP
// positions per pass; at least kMinBlocks blocks resident per SM.
template <int G, int kGroups, int kMaxP, int kMinBlocks>
__global__ void __cluster_dims__(G, 1, 1)
__launch_bounds__(kThreads, kMinBlocks) cell_tc_kernel(Params p) {
  constexpr int kH = G - 1;                     // the h~ block's rank
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dx = p.Dx, Dh = p.Dh, C = p.C, B = p.B;
  const Layout L = layout(Dx, C, G, kMaxP);
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.x_off);
  float* red = reinterpret_cast<float*>(smem + L.red_off);
  float* gate = reinterpret_cast<float*>(smem + L.gate_off);
  float* bias = reinterpret_cast<float*>(smem + L.bias_off);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  // in the h~ block, the other gates of the passes of each parity have
  // arrived: one mbarrier per parity, so that a gate block, which may run
  // a pass ahead, never completes a phase the h~ block has yet to test
  uint64_t* hbar = xbar + 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int g = (int)cluster.block_rank();      // the gate this block owns
  // the h~ block of this unit, where the other gate blocks put theirs
  float* gate_h = cluster.map_shared_rank(gate, kH);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tq = lane & 3;     // mma fragment coordinates
  const int j0 = (blockIdx.x / G) * kTN, b0 = blockIdx.y * kBT;
  const int nb = min(kBT, B - b0);              // batch rows in the tile
  const int rows = L.pos * kBT;                 // x rows of a full pass
  const int gsize = rows * kTN;                 // one gate buffer
  // 16-byte aligned (the launcher refuses any other x), so that its rows
  // (Dx * 2 bytes, a multiple of 16) come by bulk copies
  const bf16* x = static_cast<const bf16*>(p.x);
  // this warp's k16 steps, group q: [step_of(q), step_of(q + 1))
  const int s0 = warp * L.nk / kWarps, s1 = (warp + 1) * L.nk / kWarps;
  auto step_of = [&](int q) { return s0 + q * (s1 - s0) / kGroups; };

  if (tid == 0) {
    mbar_init(xbar, 1);
    mbar_init(hbar, (G - 1) * kThreads);   // every thread of the others
    mbar_init(hbar + 1, (G - 1) * kThreads);
    fence_mbar_init();
  }
  // no block writes into another's shared memory (x, gates) before every
  // block of the cluster has arrived here
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // W group q of this warp's slice: two 16-byte halves (one 32-byte
  // sector) per row; rows past Dx and columns past Dh are zeros
  const bf16* w = static_cast<const bf16*>(pick<G>(p.w, g));
  auto issue_w = [&](int q) {
    const int k0 = 16 * step_of(q), n = 32 * (step_of(q + 1) - step_of(q));
    for (int i = lane; i < n; i += 32) {
      const int k = k0 + i / 2, c = i % 2;
      const bool ok = k < Dx && j0 + 8 * c < Dh;
      cp_async16(ws + w_at(k, c), ok ? w + (size_t)k * Dh + j0 + 8 * c : w,
                 ok);
    }
    cp_async_commit();
  };
  // x rows of positions t0 .. t0 + npos - 1 (row r: position t0 + r / kBT,
  // batch row b0 + r % kBT), each block of the cluster issuing every G-th
  // row to all; by warp 0
  auto issue_x = [&](int t0, int npos) {
    if (lane == 0)
      mbar_arrive_expect_tx(xbar, (uint32_t)(npos * nb * Dx * 2));
    __syncwarp();
    for (int r = lane; r < npos * kBT; r += 32) {
      if (r % kBT >= nb || r % G != g) continue;
      const int b = b0 + r % kBT, t = t0 + r / kBT;
      bulk_copy_multicast(xs + (size_t)r * L.xs, x + ((size_t)b * C + t) * Dx,
                          (uint32_t)(Dx * 2), xbar,
                          (uint16_t)((1 << G) - 1));
    }
  };

  // x first (warp 0, once the cluster has arrived), and W streaming
  // through each warp's slice two groups ahead of its multiplies
  if (warp == 0) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    issue_x(0, L.pos);
  }
  issue_w(0);
  // x rows that no copy writes read as zeros: the K tail past Dx, and
  // rows past B
  for (int r = tid; r < rows; r += kThreads) {
    bf16* xr = xs + (size_t)r * L.xs;
    if (r % kBT >= nb) {
      for (int c = 0; c < 2 * L.nk; ++c)
        reinterpret_cast<uint4*>(xr)[c] = make_uint4(0u, 0u, 0u, 0u);
    } else if (Dx % 16 != 0) {
      reinterpret_cast<uint4*>(xr + Dx)[0] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // the small operands, needed only after the multiplies: the bias and,
  // in the h~ block, the state and length of each (batch row ob, column
  // oj) whose thread carries h across t
  const float bias_v = tid < kTN && j0 + tid < Dh
      ? __bfloat162float(static_cast<const bf16*>(
            pick<G>(p.b, g))[j0 + tid])
      : 0.0f;
  const int rb = tid / kTN, rc = tid % kTN;
  const int ob = b0 + rb, oj = j0 + rc;
  const bool owner = g == kH && tid < kBT * kTN && ob < B && oj < Dh;
  float h = 0.0f;
  int vlen = C;
  if (owner) {
    h = p.h0_f32 ? static_cast<const float*>(p.h0)[(size_t)ob * Dh + oj]
                 : __bfloat162float(
                       static_cast<const bf16*>(p.h0)[(size_t)ob * Dh + oj]);
    if (p.valid != nullptr) vlen = p.valid[ob];
  }
  __syncthreads();                    // the zeros, before any ldmatrix
  issue_w(1);

  bf16* out = static_cast<bf16*>(p.out);
  for (int t0 = 0, pass = 0; t0 < C; t0 += L.pos, ++pass) {
    const int npos = min(L.pos, C - t0);
    mbar_wait(xbar, (uint32_t)(pass & 1));

    // acc[i]: columns j0 + grp (e 0, 1) and j0 + grp + 8 (e 2, 3) of
    // batch rows b0 + 2 tq (e 0, 2) and b0 + 2 tq + 1 (e 1, 3), position
    // t0 + i: the m16 tile is the unit's columns (A = W^T), the n8 tile a
    // position's batch rows (B = x^T)
    float acc[kMaxP][4];
#pragma unroll
    for (int i = 0; i < kMaxP; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

    for (int q = 0; q < kGroups; ++q) {
      if (pass == 0) {                 // W is resident after the first pass
        cp_async_wait_upto1(q + 1 < kGroups);   // group q has landed ...
        __syncwarp();                           // ... for every lane
        if (q + 2 < kGroups) issue_w(q + 2);
      }
      const int end = step_of(q + 1);
      for (int s = step_of(q); s < end; ++s) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, ws + w_at(16 * s + (lane & 7) + ((lane >> 4) << 3),
                                       (lane >> 3) & 1));
        const bf16* xk = xs + 16 * s + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int i = 0; i < kMaxP; i += 2) {
          if (i >= npos) break;
          if (i + 1 < kMaxP && i + 1 < npos) {
            uint32_t b[4];
            ldmatrix_x4(b, xk + (size_t)((i + (lane >> 4)) * kBT + (lane & 7)) * L.xs);
            mma_bf16(acc[i], a, b[0], b[1]);
            mma_bf16(acc[i + 1], a, b[2], b[3]);
          } else {
            uint32_t b0_, b1_;
            ldmatrix_x2(b0_, b1_, xk + (size_t)(i * kBT + (lane & 7)) * L.xs);
            mma_bf16(acc[i], a, b0_, b1_);
          }
        }
      }
    }
    if (pass == 0 && tid < kTN) bias[tid] = bias_v;
    // this warp's partial sums: red[warp][position * kBT + batch row][col]
#pragma unroll
    for (int i = 0; i < kMaxP; ++i) {
      if (i >= npos) break;
      float* d = red + ((size_t)warp * rows + i * kBT + 2 * tq) * kTN + grp;
      d[0] = acc[i][0];
      d[kTN] = acc[i][1];
      d[8] = acc[i][2];
      d[kTN + 8] = acc[i][3];
    }
    __syncthreads();
    if (pass == 0 && warp != 0)
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    // every block is done with this pass's x: the next pass's may come
    // in while the gates and the recurrence run; after the last pass,
    // only arrive (the wait is at the end: no block exits while a
    // multicast copy may still land in it)
    const bool last = t0 + L.pos >= C;
    if (!last) {
      cluster.sync();
      if (warp == 0) issue_x(t0 + L.pos, min(L.pos, C - t0 - L.pos));
    } else {
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    }
    // pre-activations: the warps' partials in order 0..7, then the bias;
    // then what of the gate does not depend on h or on another gate: a
    // gate block puts it (minGRU z = sigmoid; minLSTM lstm_term) into the
    // h~ block's shared memory and arrives on its mbarrier, the h~ block
    // keeps h~ = g(v) (or v) (buffers alternate by pass, so a pass never
    // overwrites what may still be read of the one before)
    float* gput = (g == kH ? gate : gate_h) +
                  (size_t)(G * (pass & 1) + g) * gsize;
    const int n_el = npos * kBT * kTN;
    for (int e = tid; e < n_el; e += kThreads) {
      float s = red[e];
#pragma unroll
      for (int w_ = 1; w_ < kWarps; ++w_)
        s += red[(size_t)w_ * rows * kTN + e];
      const float v = s + bias[e % kTN];
      if (g == kH)
        gput[e] = p.log_mode ? g_(v) : v;
      else
        gput[e] = G == 2 ? sigmoidf_(v) : lstm_term(v, p.normalize);
    }
    // red is read; in the h~ block, h~ is in, and then the other gates:
    // the passes of one parity complete hbar[parity]'s phases in turn, and
    // the cluster barrier between passes keeps every gate block within a
    // pass of the h~ block, so none arrives twice on a barrier the h~
    // block has yet to pass
    __syncthreads();
    if (g != kH)
      mbar_arrive_remote(hbar + (pass & 1), kH);
    else
      mbar_wait_cluster(hbar + (pass & 1), (uint32_t)((pass >> 1) & 1));
    if (owner) {
      const float* lg = gate + (size_t)(G * (pass & 1)) * gsize;
      for (int i = 0; i < npos; ++i) {
        const int t = t0 + i, e = (i * kBT + rb) * kTN + rc;
        const float ht = lg[(size_t)kH * gsize + e];
        float hn;
        if (G == 2) {
          hn = gru_update(lg[e], h, ht);
        } else {
          float f, i_;
          lstm_gates(lg[e], lg[gsize + e], p.normalize, &f, &i_);
          hn = lstm_update(f, h, __fmul_rn(i_, ht));
        }
        if (t < vlen) h = rnd<bf16>(hn);
        out[((size_t)ob * C + t) * Dh + oj] = __float2bfloat16_rn(h);
      }
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---- long chunks: one block per unit, every gate ----------------------
//
// A chunk whose positions the gate blocks above would run in more than
// one pass (x for C 8 at mingru-lm's Dx, 97 KB, does not fit beside W
// with two blocks per SM; minLSTM's gate blocks take one position a
// pass) runs here in one: one block per unit with all G gates' W tiles,
// one block per SM (96 blocks at mingru-lm's and minlstm-lm's width), x
// for every position multicast to a cluster of units.  The arithmetic is
// the gate blocks', step for step: the same K split over the same 8
// warps, the same mma per k16 step, the warps' partials added in order
// 0..7, the same gate and update code; so a chunk here equals its C step
// launches there, bit for bit.

// Shared memory: W [G][16 nk][kTN] bf16, x [C kBT][xs] bf16 (the warps'
// partial sums [kWarps][C kBT][red_stride(G)] fp32 overwrite it once the
// multiplies are done, and extend past it when they are the larger), the
// values the recurrence reads [2][C kBT][kTN] fp32 (minGRU z, h~;
// minLSTM f', i' h~), the biases [G][kTN] fp32, x's mbarrier.
struct JointLayout {
  int nk, xs, x_off, red_off, gate_off, bias_off, bar_off, bytes;
};

// the row stride of the partial sums (G kTN columns), padded so that the
// mma fragments' stores (rows 2 tq apart) fall into distinct banks
__host__ __device__ constexpr int red_stride(int G) { return G * kTN + 4; }

__host__ __device__ __forceinline__ JointLayout joint_layout(int Dx, int C,
                                                             int G) {
  JointLayout L;
  L.nk = (Dx + 15) / 16;
  L.xs = 16 * L.nk + 8;
  const int rows = C * kBT;
  const int x_bytes = rows * L.xs * 2;
  const int red_bytes = kWarps * rows * red_stride(G) * 4;
  L.x_off = G * 16 * L.nk * kTN * 2;
  L.red_off = L.x_off;
  L.gate_off = L.x_off + (red_bytes > x_bytes ? red_bytes : x_bytes);
  L.bias_off = L.gate_off + 2 * rows * kTN * 4;
  L.bar_off = L.bias_off + G * kTN * 4;
  L.bytes = L.bar_off + 16;
  return L;
}

template <int G>
__global__ void __cluster_dims__(kJointCluster, 1, 1)
__launch_bounds__(kThreads, 1) cell_tc_joint_kernel(Params p) {
  constexpr int kGroups = kJointGroups;
  constexpr int kRedJoint = red_stride(G);
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dx = p.Dx, Dh = p.Dh, C = p.C, B = p.B;
  const JointLayout L = joint_layout(Dx, C, G);
  bf16* ws = reinterpret_cast<bf16*>(smem);          // [G][16 nk][kTN]
  bf16* xs = reinterpret_cast<bf16*>(smem + L.x_off);
  float* red = reinterpret_cast<float*>(smem + L.red_off);
  float* gate = reinterpret_cast<float*>(smem + L.gate_off);
  float* bias = reinterpret_cast<float*>(smem + L.bias_off);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  const int rank = (int)cg::this_cluster().block_rank();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tq = lane & 3;
  const int j0 = blockIdx.x * kTN, b0 = blockIdx.y * kBT;
  const int nb = min(kBT, B - b0);
  const int rows = C * kBT;
  const int wsize = 16 * L.nk * kTN;                 // one gate's W tile
  const bf16* x = static_cast<const bf16*>(p.x);     // 16-byte aligned
  const int s0 = warp * L.nk / kWarps, s1 = (warp + 1) * L.nk / kWarps;
  auto step_of = [&](int q) { return s0 + q * (s1 - s0) / kGroups; };

  if (tid == 0) {
    mbar_init(xbar, 1);
    fence_mbar_init();
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // W group q of this warp's slice, every gate: per row G 32-byte
  // sectors, one of each matrix
  auto issue_w = [&](int q) {
    const int k0 = 16 * step_of(q), n = 32 * (step_of(q + 1) - step_of(q));
    for (int i = lane; i < G * n; i += 32) {
      const int g = i / n, k = k0 + (i % n) / 2, c = i % 2;
      const bf16* w = static_cast<const bf16*>(pick<G>(p.w, g));
      const bool ok = k < Dx && j0 + 8 * c < Dh;
      cp_async16(ws + g * wsize + w_at(k, c),
                 ok ? w + (size_t)k * Dh + j0 + 8 * c : w, ok);
    }
    cp_async_commit();
  };

  // x, every position, multicast to the cluster's units; by warp 0
  if (warp == 0) {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (lane == 0)
      mbar_arrive_expect_tx(xbar, (uint32_t)(C * nb * Dx * 2));
    __syncwarp();
    for (int r = lane; r < rows; r += 32) {
      if (r % kBT >= nb || r % kJointCluster != rank) continue;
      const int b = b0 + r % kBT, t = r / kBT;
      bulk_copy_multicast(xs + (size_t)r * L.xs,
                          x + ((size_t)b * C + t) * Dx, (uint32_t)(Dx * 2),
                          xbar, (uint16_t)((1 << kJointCluster) - 1));
    }
  }
  issue_w(0);
  for (int r = tid; r < rows; r += kThreads) {
    bf16* xr = xs + (size_t)r * L.xs;
    if (r % kBT >= nb) {
      for (int c = 0; c < 2 * L.nk; ++c)
        reinterpret_cast<uint4*>(xr)[c] = make_uint4(0u, 0u, 0u, 0u);
    } else if (Dx % 16 != 0) {
      reinterpret_cast<uint4*>(xr + Dx)[0] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  float bias_v = 0.0f;
  if (tid < G * kTN && j0 + tid % kTN < Dh)
    bias_v = __bfloat162float(static_cast<const bf16*>(
        pick<G>(p.b, tid / kTN))[j0 + tid % kTN]);
  const int rb = tid / kTN, rc = tid % kTN;
  const int ob = b0 + rb, oj = j0 + rc;
  const bool owner = tid < kBT * kTN && ob < B && oj < Dh;
  float h = 0.0f;
  int vlen = C;
  if (owner) {
    h = p.h0_f32 ? static_cast<const float*>(p.h0)[(size_t)ob * Dh + oj]
                 : __bfloat162float(
                       static_cast<const bf16*>(p.h0)[(size_t)ob * Dh + oj]);
    if (p.valid != nullptr) vlen = p.valid[ob];
  }
  __syncthreads();                    // the zeros, before any ldmatrix
  // one block per SM: the whole tile in flight at once (two groups ahead
  // of the multiplies, as the pairs run, leaves too few bytes in flight)
  for (int q = 1; q < kGroups; ++q) issue_w(q);
  mbar_wait(xbar, 0u);

  // acc[g][i]: gate g, laid out as the gate blocks' acc[i]
  float acc[G][kMaxPos][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < kMaxPos; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][i][e] = 0.0f;
  for (int q = 0; q < kGroups; ++q) {
    cp_async_wait_pending(kGroups - 1 - q);
    __syncwarp();
    const int end = step_of(q + 1);
    for (int s = step_of(q); s < end; ++s) {
      uint32_t a[G][4];
      const int k = 16 * s + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int g = 0; g < G; ++g)
        ldmatrix_x4_trans(a[g], ws + g * wsize + w_at(k, (lane >> 3) & 1));
      const bf16* xk = xs + 16 * s + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int i = 0; i < kMaxPos; i += 2) {
        if (i >= C) break;
        if (i + 1 < C) {
          uint32_t b[4];
          ldmatrix_x4(b, xk + (size_t)((i + (lane >> 4)) * kBT + (lane & 7)) * L.xs);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            mma_bf16(acc[g][i], a[g], b[0], b[1]);
            mma_bf16(acc[g][i + 1], a[g], b[2], b[3]);
          }
        } else {
          uint32_t b0_, b1_;
          ldmatrix_x2(b0_, b1_, xk + (size_t)(i * kBT + (lane & 7)) * L.xs);
#pragma unroll
          for (int g = 0; g < G; ++g) mma_bf16(acc[g][i], a[g], b0_, b1_);
        }
      }
    }
  }
  if (tid < G * kTN) bias[tid] = bias_v;
  if (warp != 0)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // no block exits while a multicast copy may still land in it: x has
  // landed here; the wait is at the end
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  __syncthreads();                    // every warp is done with x
  // red[warp][position * kBT + batch row][g * kTN + col]
#pragma unroll
  for (int i = 0; i < kMaxPos; ++i) {
    if (i >= C) break;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* d = red + ((size_t)warp * rows + i * kBT + 2 * tq) * kRedJoint +
                 g * kTN + grp;
      d[0] = acc[g][i][0];
      d[kRedJoint] = acc[g][i][1];
      d[8] = acc[g][i][2];
      d[kRedJoint + 8] = acc[g][i][3];
    }
  }
  __syncthreads();
  // pre-activations: the warps' partials in order 0..7, then the bias;
  // then the gates, as the gate blocks compute them
#pragma unroll 4
  for (int e = tid; e < rows * kTN; e += kThreads) {
    const int r = e / kTN, c = e % kTN;
    float v[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int at = r * kRedJoint + g * kTN + c;
      float s = red[at];
#pragma unroll
      for (int w_ = 1; w_ < kWarps; ++w_)
        s += red[w_ * rows * kRedJoint + at];
      v[g] = s + bias[g * kTN + c];
      if (G == 2)
        gate[(size_t)g * rows * kTN + e] =
            g == 0 ? sigmoidf_(v[g]) : (p.log_mode ? g_(v[g]) : v[g]);
    }
    if (G == 3) {
      float f, i_;
      lstm_gates(lstm_term(v[0], p.normalize), lstm_term(v[1], p.normalize),
                 p.normalize, &f, &i_);
      gate[e] = f;
      gate[(size_t)rows * kTN + e] =
          __fmul_rn(i_, p.log_mode ? g_(v[2]) : v[2]);
    }
  }
  __syncthreads();
  if (owner) {
    bf16* out = static_cast<bf16*>(p.out);
    for (int t = 0; t < C; ++t) {
      const int e = (t * kBT + rb) * kTN + rc;
      const float a0 = gate[e], a1 = gate[(size_t)rows * kTN + e];
      const float hn = G == 2 ? gru_update(a0, h, a1) : lstm_update(a0, h, a1);
      if (t < vlen) h = rnd<bf16>(hn);
      out[((size_t)ob * C + t) * Dh + oj] = __float2bfloat16_rn(h);
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Routing and launch
// ---------------------------------------------------------------------------

// the bodies, by the number the wrapper passes
constexpr int kBodyCudaCore = 0;
constexpr int kBodyTC = 1;

// Whether the tensor-core body can run these operands (the wrapper's
// choice is checked against it, never replaced by it).
bool tc_can_run(int lstm, int bf16, const Params& p) {
  if (!bf16 || p.Dx % 8 != 0 || p.Dh % 8 != 0 || p.Dx > tc::kMaxDx)
    return false;
  for (int g = 0; g < (lstm ? 3 : 2); ++g)
    if (reinterpret_cast<uintptr_t>(p.w[g]) % 16 != 0) return false;
  return true;
}

struct Choice {
  const void* fn;
  int threads;
  int smem;          // dynamic shared memory, bytes
  int cluster;       // blocks per cluster
  bool carveout;     // ask for the largest shared-memory carveout
  dim3 grid;
};

template <typename T, int G>
int choose_cuda_core(const Params& p, Choice* c) {
  const int elem = (int)sizeof(T);
  const int staged = smem_bytes(p.Dx, G, elem, true);
  if (p.Dx > whole_row_max(elem)) {   // x in K slices
    c->fn = reinterpret_cast<const void*>(cell_sliced_kernel<T, G>);
    c->smem = kRedBytes + align16(kBT * slice_cols(p.Dx, elem) * elem);
  } else if (staged <= kSmemCap) {
    c->fn = reinterpret_cast<const void*>(cell_kernel<T, G, true>);
    c->smem = staged;
  } else {
    c->fn = reinterpret_cast<const void*>(cell_kernel<T, G, false>);
    c->smem = smem_bytes(p.Dx, G, elem, false);
  }
  c->threads = kThreads;
  c->cluster = 1;
  c->carveout = false;
  c->grid = dim3((p.Dh + kTN - 1) / kTN, (p.B + kBT - 1) / kBT);
  return 0;
}

// Opt a kernel in to the whole 227 KB of dynamic shared memory (and, for
// the tensor-core body, the largest carveout, so two blocks fit an SM),
// once per kernel and device; the launch asks for what it uses.
int opt_in(const Choice& c) {
  constexpr int kSeen = 64;
  static const void* seen_fn[kSeen];
  static int seen_dev[kSeen];
  static int n_seen = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < n_seen; ++i)
    if (seen_fn[i] == c.fn && seen_dev[i] == device) return 0;
  err = cudaFuncSetAttribute(c.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemCap);
  if (err == cudaSuccess && c.carveout)
    err = cudaFuncSetAttribute(c.fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  if (n_seen < kSeen) {
    seen_fn[n_seen] = c.fn;
    seen_dev[n_seen] = device;
    ++n_seen;
  }
  return 0;
}

// Clusters of `fn` (a kernel of `cluster`-block clusters) resident at
// once for a launch of `smem` bytes (the occupancy query, asked once per
// device, kernel and size).
int resident_clusters(const void* fn, int cluster, int smem, int* out) {
  constexpr int kSeen = 64;
  static const void* seen_fn[kSeen];
  static int seen[kSeen][3];             // device, smem, clusters
  static int n_seen = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < n_seen; ++i)
    if (seen_fn[i] == fn && seen[i][0] == device && seen[i][1] == smem) {
      *out = seen[i][2];
      return 0;
    }
  Choice q = {};
  q.fn = fn;
  q.carveout = true;
  const int err = opt_in(q);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(tc::kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  e = cudaOccupancyMaxActiveClusters(out, fn, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (n_seen < kSeen) {
    seen_fn[n_seen] = fn;
    seen[n_seen][0] = device;
    seen[n_seen][1] = smem;
    seen[n_seen][2] = *out;
    ++n_seen;
  }
  return 0;
}

// The tensor-core body's launch: G gate blocks per unit (one gate each,
// one cluster: a pair for minGRU, three for minLSTM); or, for a chunk the
// gate blocks would run in more than one pass, a block per unit (every
// gate) in clusters of four units, where its one pass fits shared memory
// and its grid one wave.  The arithmetic is the same in both shapes.
int choose_tc(int lstm, const Params& p, Choice* c) {
  const int G = lstm ? 3 : 2;
  const int units = (p.Dh + tc::kTN - 1) / tc::kTN;
  const int tiles = (p.B + tc::kBT - 1) / tc::kBT;
  const tc::Layout L = tc::layout(p.Dx, p.C, G, tc::max_pos_of(G));
  c->threads = tc::kThreads;
  c->carveout = true;
  const int joint_smem = tc::joint_layout(p.Dx, p.C, G).bytes;
  if (L.pos < p.C && p.C <= tc::kMaxPos && joint_smem <= kSmemCap) {
    const void* joint =
        lstm ? reinterpret_cast<const void*>(tc::cell_tc_joint_kernel<3>)
             : reinterpret_cast<const void*>(tc::cell_tc_joint_kernel<2>);
    int resident = 0;
    const int err = resident_clusters(joint, tc::kJointCluster, joint_smem,
                                      &resident);
    if (err != 0) return err;
    const int clusters = (units + tc::kJointCluster - 1) / tc::kJointCluster;
    if (clusters * tiles <= resident) {
      c->fn = joint;
      c->smem = joint_smem;
      c->cluster = tc::kJointCluster;
      // a unit past Dh (rounding up to whole clusters) only loads and
      // synchronises
      c->grid = dim3(clusters * tc::kJointCluster, tiles);
      return 0;
    }
  }
  c->smem = L.bytes;
  if (c->smem > kSmemCap) return (int)cudaErrorInvalidValue;
  using tc::cell_tc_kernel;
  using tc::max_pos_of;
  if (lstm)       // one position a pass, three blocks per SM
    c->fn = reinterpret_cast<const void*>(
        cell_tc_kernel<3, tc::kLstmGroups, max_pos_of(3), 3>);
  else if (L.nk / tc::kWarps >= tc::kManyGroupsSteps)
    c->fn = reinterpret_cast<const void*>(
        cell_tc_kernel<2, 8, max_pos_of(2), 2>);
  else
    c->fn = reinterpret_cast<const void*>(
        cell_tc_kernel<2, 4, max_pos_of(2), 2>);
  c->cluster = G;
  c->grid = dim3(G * units, tiles);
  return 0;
}

// the launch of these operands; its grid.y is ceil(B / 8), which launch()
// keeps within kMaxTiles
int choose(int lstm, int bf16, int body, const Params& p, Choice* c) {
  if (p.B < 1 || p.C < 1 || p.Dx < 1 || p.Dh < 1)
    return (int)cudaErrorInvalidValue;
  if (body == kBodyTC) {
    if (!tc_can_run(lstm, bf16, p)) return (int)cudaErrorInvalidValue;
    return choose_tc(lstm, p, c);
  }
  if (body != kBodyCudaCore) return (int)cudaErrorInvalidValue;
  if (bf16)
    return lstm ? choose_cuda_core<__nv_bfloat16, 3>(p, c)
                : choose_cuda_core<__nv_bfloat16, 2>(p, c);
  return lstm ? choose_cuda_core<float, 3>(p, c)
              : choose_cuda_core<float, 2>(p, c);
}

Params make_params(int log_mode, int normalize, int h0_f32, int B, int C,
                   int Dx, int Dh, void* const* ptrs, bool chunk) {
  Params p;
  p.x = ptrs[0];
  for (int g = 0; g < 3; ++g) { p.w[g] = ptrs[1 + g]; p.b[g] = ptrs[4 + g]; }
  p.h0 = ptrs[7];
  p.valid = chunk ? static_cast<const int*>(ptrs[8]) : nullptr;
  p.out = ptrs[9];
  p.B = B; p.C = C; p.Dx = Dx; p.Dh = Dh;
  p.log_mode = log_mode; p.normalize = normalize; p.h0_f32 = h0_f32;
  return p;
}

// the launches a batch of B rows is split into, kMaxTiles batch tiles
// each (one where B fits, or where choose() refuses B)
int launches_for(int B) {
  const long long tiles = ((long long)B + kBT - 1) / kBT;
  return tiles <= kMaxTiles ? 1 : (int)((tiles + kMaxTiles - 1) / kMaxTiles);
}

int launch(int lstm, int log_mode, int normalize, int bf16, int h0_f32,
           int B, int C, int Dx, int Dh, void* const* ptrs, void* stream,
           int body, bool chunk) {
  if (!chunk && C != 1) return (int)cudaErrorInvalidValue;
  const Params p = make_params(log_mode, normalize, h0_f32, B, C, Dx, Dh,
                               ptrs, chunk);
  // the tensor-core body takes x by bulk copies: the wrapper hands it an
  // aligned x, and any other is refused, never read another way
  if (body == kBodyTC && reinterpret_cast<uintptr_t>(p.x) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  // kMaxTiles batch tiles a launch (grid.y), the rest in further launches
  // on the rows after them (offsets keep x 16-byte aligned: a multiple of
  // 8 rows)
  const size_t elem = bf16 ? 2 : 4, h_elem = h0_f32 ? 4 : elem;
  for (int i = 0, n = launches_for(B); i < n; ++i) {
    const int b0 = i * kMaxTiles * kBT;
    Params q = p;
    q.B = B - b0 < kMaxTiles * kBT ? B - b0 : kMaxTiles * kBT;
    q.x = static_cast<const char*>(p.x) + (size_t)b0 * C * Dx * elem;
    q.h0 = static_cast<const char*>(p.h0) + (size_t)b0 * Dh * h_elem;
    if (p.valid != nullptr) q.valid = p.valid + b0;
    q.out = static_cast<char*>(p.out) + (size_t)b0 * C * Dh * elem;
    Choice c;
    int err = choose(lstm, bf16, body, q, &c);
    if (err == 0) err = opt_in(c);
    if (err != 0) return err;
    void* args[] = {&q};
    cudaError_t e = cudaLaunchKernel(
        c.fn, c.grid, dim3(c.threads), args, (size_t)c.smem,
        static_cast<cudaStream_t>(stream));
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" {

// ptrs: x, w0, w1, w2, b0, b1, b2, h0, valid, out (10 pointers; w2 / b2
// unused by minGRU, valid unused by the step form).  bf16 != 0: x, weights,
// biases, out (and h0 unless h0_f32) are bfloat16, else float32.  body:
// the body the wrapper chose when it bound the weights (0 CUDA cores, 1
// tensor cores); a body that cannot run these operands is refused.
// Returns 0 or the cudaError_t of the launch.

// One token for every row: C must be 1 (mingru_step_kernel /
// minlstm_step_kernel).
int repro_cell_step_launch(int lstm, int log_mode, int normalize, int bf16,
                           int h0_f32, int B, int C, int Dx, int Dh,
                           void* const* ptrs, void* stream, int body) {
  return launch(lstm, log_mode, normalize, bf16, h0_f32, B, C, Dx, Dh, ptrs,
                stream, body, false);
}

// A varlen C-token chunk; rows freeze at t >= valid[b] (mingru_chunk_kernel
// / minlstm_chunk_kernel).
int repro_cell_chunk_launch(int lstm, int log_mode, int normalize, int bf16,
                            int h0_f32, int B, int C, int Dx, int Dh,
                            void* const* ptrs, void* stream, int body) {
  return launch(lstm, log_mode, normalize, bf16, h0_f32, B, C, Dx, Dh, ptrs,
                stream, body, true);
}

// What a launch of this body on these operands would run, without
// launching: out[0] resident blocks per SM (the occupancy query at the
// launch's shared memory), out[1] grid blocks, out[2] the device's SMs,
// out[3] blocks per cluster, out[4] clusters resident at once on the
// device (cudaOccupancyMaxActiveClusters; 0 without clusters).
int repro_cell_occupancy(int lstm, int bf16, int body, int B, int C, int Dx,
                         int Dh, void* const* ptrs, int* out) {
  const Params p = make_params(1, 1, 0, B, C, Dx, Dh, ptrs, C > 1);
  Choice c;
  int err = choose(lstm, bf16, body, p, &c);
  if (err == 0) err = opt_in(c);
  if (err != 0) return err;
  int per_sm = 0, dev = 0, sms = 0, clusters = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, c.fn, c.threads, c.smem);
  if (e == cudaSuccess && c.cluster > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c.grid.x, c.grid.y < (unsigned)kMaxTiles
                                          ? c.grid.y : (unsigned)kMaxTiles);
    cfg.blockDim = dim3(c.threads);
    cfg.dynamicSmemBytes = (size_t)c.smem;
    e = cudaOccupancyMaxActiveClusters(&clusters, c.fn, &cfg);
  }
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = per_sm;
  out[1] = (int)(c.grid.x * c.grid.y);
  out[2] = sms;
  out[3] = c.cluster;
  out[4] = clusters;
  return (int)e;
}

// The kernel launches repro_cell_step_launch / repro_cell_chunk_launch
// make for B rows: one up to 65535 tiles of 8 rows, one per 65535 tiles
// past that.
int repro_cell_launches(int B) { return launches_for(B); }

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
