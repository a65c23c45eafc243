// First-order linear scans for Hopper (sm_90a): linear and log-space.
//
// Replaces the Pallas TPU kernels linear_scan_kernel and log_scan_kernel
// (src/repro/kernels/scan/kernel.py, _scan_kernel and _log_scan_kernel):
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
// written once, a couple of flops per element.  At the training shapes
// (B 8, T 256, D 1536, fp32) that is 37.7 MB, about 11 us at 3.35 TB/s:
// bound by bytes.
//
// Design.  The TPU kernel walks time chunks on a sequential grid axis
// with a VMEM carry and a Kogge-Stone ladder inside each chunk.  Here the
// time loop is inside the thread: one thread owns one (b, d) column and
// walks T in order, so the carry is a register and nothing crosses
// blocks.  Neighbouring threads own neighbouring d, so every load and
// store of a warp is one contiguous segment.  The recurrence is a chain
// of dependent FMAs; the loads of the next kUnroll steps are issued
// before the chain consumes them, so the chain waits on memory once per
// kUnroll steps, not once per step.  Blocks of 64 threads give B * D / 64
// blocks (192 at the training shapes), which still under-fills 132 SMs
// four warps deep: a first design, simple and right.
//
// logaddexp(-inf, -inf) is -inf here, as jnp.logaddexp gives: the max is
// tested first, so -inf - (-inf) = NaN is never formed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 8;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const float* __restrict__ h0, T* __restrict__ out, int B,
                   int T_, int D, int reverse) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (d >= D) return;
  const long long step = reverse ? -(long long)D : (long long)D;
  const long long first =
      (long long)row * T_ * D + d + (reverse ? (long long)(T_ - 1) * D : 0);
  float h = h0[(long long)row * D + d];
  for (int t0 = 0; t0 < T_; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < T_) {
        const long long i = first + (t0 + u) * step;
        av[u] = to_f(a[i]);
        bv[u] = to_f(b[i]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < T_) {
        h = fmaf(av[u], h, bv[u]);
        out[first + (t0 + u) * step] = from_f<T>(h);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
log_scan_kernel(const T* __restrict__ la, const T* __restrict__ lb,
                const float* __restrict__ lh0, float* __restrict__ out,
                int B, int T_, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (d >= D) return;
  const long long first = (long long)row * T_ * D + d;
  float lh = lh0[(long long)row * D + d];
  for (int t0 = 0; t0 < T_; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < T_) {
        const long long i = first + (long long)(t0 + u) * D;
        av[u] = to_f(la[i]);
        bv[u] = to_f(lb[i]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < T_) {
        lh = logaddexp(av[u] + lh, bv[u]);
        out[first + (long long)(t0 + u) * D] = expf(lh);
      }
    }
  }
}

dim3 grid_for(int B, int D) {
  return dim3((unsigned)((D + kThreads - 1) / kThreads), (unsigned)B);
}

bool bad_dims(int B, int T, int D) {
  return B < 1 || T < 1 || D < 1 || B > 65535;
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
  const float* h0f = static_cast<const float*>(h0);
  if (bf16) {
    linear_scan_kernel<__nv_bfloat16><<<grid_for(B, D), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), h0f,
        static_cast<__nv_bfloat16*>(out), B, T, D, reverse);
  } else {
    linear_scan_kernel<float><<<grid_for(B, D), kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), h0f,
        static_cast<float*>(out), B, T, D, reverse);
  }
  return (int)cudaGetLastError();
}

// h = exp(log-space scan of (log_a, log_b) from log_h0), out in float32.
int repro_log_scan(int bf16, int B, int T, int D, const void* la,
                   const void* lb, const void* lh0, void* out,
                   void* stream) {
  if (bad_dims(B, T, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lh0f = static_cast<const float*>(lh0);
  float* o = static_cast<float*>(out);
  if (bf16) {
    log_scan_kernel<__nv_bfloat16><<<grid_for(B, D), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(la),
        static_cast<const __nv_bfloat16*>(lb), lh0f, o, B, T, D);
  } else {
    log_scan_kernel<float><<<grid_for(B, D), kThreads, 0, s>>>(
        static_cast<const float*>(la), static_cast<const float*>(lb), lh0f,
        o, B, T, D);
  }
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
