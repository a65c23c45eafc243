// First-order linear scans for Hopper (sm_90a): linear and log-space.
//
// Replaces the Pallas TPU kernels linear_scan_kernel and log_scan_kernel
// (src/repro/kernels/scan/kernel.py:94 and :153, bodies _scan_kernel and
// _log_scan_kernel):
//
//   linear:  h_t = a_t * h_{t-1} + b_t          fp32 carry, out in T
//   log:     log_h_t = logaddexp(log_a_t + log_h_{t-1}, log_b_t)
//            out = exp(log_h_t) in fp32; the carry stays in log space
//
// over (B, T, D) inputs, with h0 / log_h0 (B, D) in fp32 (log_h0 = -inf
// means h0 = 0).  The linear scan also runs reversed (t = T-1 .. 0,
// h_t = a_t * h_{t+1} + b_t, h_T = h0): that is the backward of every
// fused layer and of the log-space scan (g_t = dh_t + a_{t+1} g_{t+1}).
//
// Bound.  Elementwise: each input element is read once and each output
// written once.  At the training shapes (B 8, T 256, D 1536, fp32) that
// is 37.7 MB, about 11.3 us at 3.35 TB/s: bound by bytes.  The log scan
// also spends about 50 instructions an element (a logaddexp with precise
// expf and log1pf, two precise expf in the fix-up): some 5 us of issue
// on 132 SMs (derived).
//
// Design: a segmented two-level scan, one block per (batch row, tile of
// kCols = 32 columns), kWarps = 8 warps.  The TPU kernel walks 256-step
// chunks on a sequential grid axis; here the time loop is inside the
// block, and a block's kWarps segments expose the parallel work:
//   * Warp w owns the kSeg = 32 steps [w S, (w+1) S) of a kTile = 256-step
//     T-tile for the block's 32 columns; lane j owns column j, so every
//     warp load or store is one 128-byte line (fp32) or 64 bytes (bf16).
//   * Phase 1: each thread issues all 2 S loads of its segment before it
//     uses one (64 loads in flight a thread, the whole input in flight at
//     once across the grid), then scans the segment in order, keeping
//     each step's prefix (A_t, B_t) in the registers the loads came into
//     (step 0's prefix is the step itself; the identity, (1, 0) linear
//     and (0, -inf) log, stands in for steps past T), and leaves the
//     segment's aggregate in shared memory.
//   * Phase 2, after one barrier: each thread folds, in order, the
//     aggregates of the segments before its own onto the tile's carry-in
//     (h0 / log_h0 for the first tile, the previous tile's last state
//     after it): at most kWarps - 1 combines.
//   * Phase 3: h_t = A_t carry + B_t, stored; log: out_t = exp(B_t) +
//     exp(A_t + carry), which is exp(logaddexp(B_t, A_t + carry)) without
//     its log1pf and never forms inf - inf.  The last warp leaves the
//     tile's last state (log: in log space) for the next tile.
// The grid is B x ceil(D / 32) blocks of 256 threads (384 at the training
// shapes), 3 blocks a SM (__launch_bounds__; 80 registers a thread, a few
// bytes spilled in three of the four instances): one wave of 24 warps a
// SM where the parent ran 2.9.  Any T runs (the block loops over T-tiles
// with the carry in shared memory); a ragged last tile, segment or column
// tile is masked.  reverse maps step t onto row T-1-t by index
// arithmetic.  Measured on the card while the design was chosen: loads
// masked step by step everywhere (no unmasked path for full segments)
// spilled up to 152 bytes a thread and ran the linear scan 1.4x slower; 16-step segments with
// the next T-tile's loads issued ahead, and the log scan's segment
// scanned as two interleaved halves, both ran slower: once its loads
// land, the log scan is bound by instruction issue (about 50 an element),
// not by the latency of its chain.
//
// Fixed order.  Every combine's order is set by (T, kSeg, kWarps) alone,
// never by B, D or the grid, and the linear combines are a rounded
// multiply then a rounded add (__fmul_rn / __fadd_rn, never contracted
// to an FMA): two launches agree bit for bit, a row's result does not
// depend on B, and ref.linear_scan_segmented / log_scan_segmented render
// the same arithmetic in PyTorch ops (bit for bit on the card, where
// torch's exp and log1p are CUDA's expf and log1pf).
//
// logaddexp(-inf, -inf) is -inf here, as jnp.logaddexp gives: the max is
// tested first, so -inf - (-inf) = NaN is never formed.  expf / log1pf
// are the precise forms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 32;                 // S: steps a warp owns in a tile
constexpr int kWarps = 8;                // W: segments a tile
constexpr int kCols = 32;                // columns a block, one per lane
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kSeg * kWarps;     // steps a T-tile
constexpr int kBlocksPerSm = 3;

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

__device__ __forceinline__ float logaddexp(float x, float y) {
  const float m = fmaxf(x, y);
  if (m == -INFINITY) return -INFINITY;
  return m + log1pf(expf(-fabsf(x - y)));
}

// The map h -> a h + b.  (A, B) after (a, b): h -> a (A h + B) + b.
struct Linear {
  __device__ __forceinline__ static float id_a() { return 1.0f; }
  __device__ __forceinline__ static float id_b() { return 0.0f; }
  __device__ __forceinline__ static void then(float& A, float& B, float a,
                                              float b) {
    A = __fmul_rn(A, a);
    B = __fadd_rn(__fmul_rn(a, B), b);
  }
  __device__ __forceinline__ static float apply(float A, float B, float h) {
    return __fadd_rn(__fmul_rn(A, h), B);
  }
  __device__ __forceinline__ static float out(float A, float B, float h) {
    return apply(A, B, h);
  }
};

// The map lh -> logaddexp(la + lh, lb), in log space.
struct Log {
  __device__ __forceinline__ static float id_a() { return 0.0f; }
  __device__ __forceinline__ static float id_b() { return -INFINITY; }
  __device__ __forceinline__ static void then(float& A, float& B, float a,
                                              float b) {
    A = A + a;
    B = logaddexp(a + B, b);
  }
  __device__ __forceinline__ static float apply(float A, float B, float lh) {
    return logaddexp(A + lh, B);
  }
  __device__ __forceinline__ static float out(float A, float B, float lh) {
    return expf(B) + expf(A + lh);
  }
};

// Loads one warp's segment (steps s0 .. s0 + kSeg - 1) into registers,
// every load issued before any is used; steps past T and columns past D
// are the identity.
template <class Op, typename In>
__device__ __forceinline__ void load_segment(float (&p)[kSeg],
                                             float (&q)[kSeg],
                                             const In* __restrict__ x,
                                             const In* __restrict__ y,
                                             long long first,
                                             long long stride, int s0, int T,
                                             bool live) {
  if (live && s0 + kSeg <= T) {
#pragma unroll
    for (int s = 0; s < kSeg; ++s) {
      const long long i = first + (long long)(s0 + s) * stride;
      p[s] = to_f(x[i]);
      q[s] = to_f(y[i]);
    }
  } else {
#pragma unroll
    for (int s = 0; s < kSeg; ++s) {
      if (live && s0 + s < T) {
        const long long i = first + (long long)(s0 + s) * stride;
        p[s] = to_f(x[i]);
        q[s] = to_f(y[i]);
      } else {
        p[s] = Op::id_a();
        q[s] = Op::id_b();
      }
    }
  }
}

template <class Op, typename In, typename Out>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
scan_kernel(const In* __restrict__ x, const In* __restrict__ y,
            const float* __restrict__ c0, Out* __restrict__ out, int T,
            int D, int reverse) {
  __shared__ float agg_a[kWarps][kCols];
  __shared__ float agg_b[kWarps][kCols];
  __shared__ float carry_in[kCols];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  // one-dimensional grid, column tiles fastest (grid_for)
  const unsigned tiles = (unsigned)((D + kCols - 1) / kCols);
  const int row = (int)(blockIdx.x / tiles);
  const int d = (int)(blockIdx.x % tiles) * kCols + lane;
  const bool live = d < D;
  const long long stride = reverse ? -(long long)D : (long long)D;
  const long long first =
      (long long)row * T * D + d + (reverse ? (long long)(T - 1) * D : 0);
  if (w == 0) carry_in[lane] = live ? c0[(long long)row * D + d] : 0.0f;

  // the loads of the next T-tile are issued at the end of this one: the
  // same schedule with the loads at the loop's top spilled more and ran
  // the log scan 7% slower on the card
  float p[kSeg], q[kSeg];
  load_segment<Op>(p, q, x, y, first, stride, w * kSeg, T, live);
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int s0 = t0 + w * kSeg;
    // phase 1: the segment's prefixes, in place (step 0's is itself)
    float A = p[0], B = q[0];
#pragma unroll
    for (int s = 1; s < kSeg; ++s) {
      Op::then(A, B, p[s], q[s]);
      p[s] = A;
      q[s] = B;
    }
    agg_a[w][lane] = A;
    agg_b[w][lane] = B;
    __syncthreads();
    // phase 2: the segments before this one, in order
    float carry = carry_in[lane];
    for (int k = 0; k < w; ++k)
      carry = Op::apply(agg_a[k][lane], agg_b[k][lane], carry);
    // phase 3
#pragma unroll
    for (int s = 0; s < kSeg; ++s) {
      if (live && s0 + s < T)
        out[first + (long long)(s0 + s) * stride] =
            from_f<Out>(Op::out(p[s], q[s], carry));
    }
    if (t0 + kTile < T) {
      __syncthreads();              // every warp has read carry_in, agg
      if (w == kWarps - 1) carry_in[lane] = Op::apply(A, B, carry);
      load_segment<Op>(p, q, x, y, first, stride, s0 + kTile, T, live);
    }
  }
}

// B x ceil(D / 32) blocks on grid.x, column tiles fastest: the order of
// the 2D grid it replaced, whose grid.y held B (at most 65535 rows)
dim3 grid_for(int B, int D) {
  return dim3((unsigned)((long long)B * ((D + kCols - 1) / kCols)));
}

// (grid.x holds 2^31 - 1 blocks: more than a card's memory holds rows
// of, at any D and T)
bool bad_dims(int B, int T, int D) {
  return B < 1 || T < 1 || D < 1 ||
         (long long)B * ((D + kCols - 1) / kCols) > 0x7fffffffLL;
}

template <class Op, typename In, typename Out>
int launch(int B, int T, int D, const void* x, const void* y,
           const void* c0, void* out, int reverse, cudaStream_t s) {
  scan_kernel<Op, In, Out><<<grid_for(B, D), kThreads, 0, s>>>(
      static_cast<const In*>(x), static_cast<const In*>(y),
      static_cast<const float*>(c0), static_cast<Out*>(out), T, D,
      reverse);
  return (int)cudaGetLastError();
}

template <class Op, typename In, typename Out>
int blocks_per_sm(int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, scan_kernel<Op, In, Out>, kThreads, 0);
}

}  // namespace

extern "C" {

// h = linear scan of (a, b) from h0 (fp32), forward or reversed; a, b and
// out share the element type (bf16 != 0: bfloat16, else float32).
// Returns 0 or the cudaError_t of the launch.
int repro_linear_scan(int bf16, int reverse, int B, int T, int D,
                      const void* a, const void* b, const void* h0,
                      void* out, void* stream) {
  if (bad_dims(B, T, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<Linear, __nv_bfloat16, __nv_bfloat16>(
                    B, T, D, a, b, h0, out, reverse, s)
              : launch<Linear, float, float>(B, T, D, a, b, h0, out,
                                             reverse, s);
}

// h = exp(log-space scan of (log_a, log_b) from log_h0), out in float32.
int repro_log_scan(int bf16, int B, int T, int D, const void* la,
                   const void* lb, const void* lh0, void* out,
                   void* stream) {
  if (bad_dims(B, T, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<Log, __nv_bfloat16, float>(B, T, D, la, lb, lh0,
                                                  out, 0, s)
              : launch<Log, float, float>(B, T, D, la, lb, lh0, out, 0, s);
}

// The launch a (B, T, D) scan runs, without launching: out[0] kSeg,
// out[1] kWarps, out[2] kCols, out[3] T-tiles, out[4] grid blocks,
// out[5] resident blocks per SM (the occupancy query), out[6] the
// device's SMs.  log_mode / bf16 pick the kernel instance.
int repro_scan_plan(int log_mode, int bf16, int B, int T, int D, int* out) {
  if (bad_dims(B, T, D)) return (int)cudaErrorInvalidValue;
  int per_sm = 0, dev = 0, sms = 0;
  int e = log_mode ? (bf16 ? blocks_per_sm<Log, __nv_bfloat16, float>(&per_sm)
                           : blocks_per_sm<Log, float, float>(&per_sm))
                   : (bf16 ? blocks_per_sm<Linear, __nv_bfloat16,
                                           __nv_bfloat16>(&per_sm)
                           : blocks_per_sm<Linear, float, float>(&per_sm));
  if (e == 0) e = (int)cudaGetDevice(&dev);
  if (e == 0)
    e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  const dim3 g = grid_for(B, D);
  out[0] = kSeg;
  out[1] = kWarps;
  out[2] = kCols;
  out[3] = (T + kTile - 1) / kTile;
  out[4] = (int)(g.x * g.y);
  out[5] = per_sm;
  out[6] = sms;
  return e;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
