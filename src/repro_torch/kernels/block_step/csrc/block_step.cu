// Whole-block minRNN decode kernel for Hopper (sm_90a), step and chunk form.
//
// Replaces the Pallas TPU kernels block_step_kernel and block_chunk_kernel
// (src/repro/kernels/block_step/kernel.py, _block_step_body and
// _block_chunk_body, pallas_call at :333 and :383).  One launch runs a
// whole residual block for every row of the batch and every position of
// the chunk:
//
//     y  = RMSNorm(x) ; y = ConvStep(y)                  [optional conv]
//     h  = cell(y, h_prev)     minGRU / minLSTM (stable f/(f+i)), fp32
//     xr = x + Down(h)
//     y  = xr + MLPout(gelu(MLPin(RMSNorm(xr))))         [optional MLP]
//
// Bound.  At serving batch sizes the block is a batched GEMV: every weight
// byte is used for at most B*C multiply-adds.  At mingru-lm's full width
// (Dx 768, Dh 1536, Dm 3072) one layer's weights are about 16.5 MB in
// bf16, about 4.9 us at the H100's 3.35 TB/s; the activations are a few
// KB.  So the kernel is bound by weight bytes, and the time it loses over
// that bound is latency: of the weight stream, of each phase's chain of
// dependent round trips (staging, arrival, epilogue) and of the grid
// barriers.
//
// The TPU kernel walks a sequential grid over Dh tiles and accumulates
// the down product in VMEM scratch; a Hopper grid runs in no order, so
// that carry cannot exist here.  Both bodies below are ONE cooperative
// launch of a grid resident at once that runs four phases per position,
// with a grid barrier (cooperative_groups grid sync) after each of the
// first three:
//   A  gates + cell: the gate GEMVs of RMSNorm(x) (conv'd) against W_g,
//      the cell update, h.   K = Dx, N = Dh, 2 (minLSTM 3) matrices
//   B  down:  xr = x + Down(h).                       K = Dh, N = Dx
//   C  MLP in: m = gelu(RMSNorm(xr) W_in + b_in).      K = Dx, N = Dm
//   D  MLP out: y = xr + m W_out + b_out.              K = Dm, N = Dx
//
// Two bodies.  The launcher picks one from the dims, the element type and
// the card's SM count, never from B, C or the data (make_plan); every
// shape runs one of them:
//   split     where every feature dim is a multiple of 16 and one
//             block's weight slices for a position fit in its shared
//             memory (bf16 at mingru-lm / minlstm-lm width: 126 /
//             144 KB a block), so they are loaded once per launch;
//   streamed  every other shape (fp32 at those widths: 33 MB a layer, 258
//             KB a block).  A split plan that has to stream its slices
//             again for every position measured 1.3x (step) to 1.6x
//             (chunk) this body's time on an H100 at fp32 mingru-lm width.
//
// split.  A work unit is 16 output columns times one K slice of Ks rows.
// Each phase's split S = ceil(K / Ks) is chosen from the dims alone
// (slice_rows): at least kTargetUnits units a phase (about three per SM of
// a 132-SM card), slices of 64..kMaxKs rows.  At mingru-lm's width that is
// A x 4, B x 8, C x 2, D x 8: 384 units in every phase, three a block on
// 128 blocks, so the most weight bytes any block holds in a phase is 1.03x
// the phase's bytes over 132 SMs.  Unit u is column tile u % ncols of
// slice u / ncols; block b takes units b J .. b J + J-1 (J = ceil(units /
// grid)), neighbouring column tiles of one slice, so they share their
// staged rows and run in one GEMV loop.  A block writes each unit's fp32
// partial sums (8 rows x 16 columns a gate a batch tile) to device
// scratch, fences, and arrives on the column tile's counter; the block
// that arrives S-th sums the S partials in order s = 0..S-1, runs the
// tile's epilogue (the cell update, the residual, the bias and GELU) and
// resets the counter for the next position.  No extra barrier: a phase's
// arrivals are one atomic round trip per block.  The scratch and the
// counters are the wrapper's, bound with the weights (ops.BlockOperands).
//   Resident weights: at the start of the launch every block issues the
// weight slices of all its units of A, B, C and D into shared memory, one
// cp.async group a unit in the order of use, so phase A computes while
// the later phases' slices arrive, across the barriers, which they do not
// depend on.  The slices stay for every position of a chunk.
//   Staging: the rows a phase's GEMVs read are staged in shared memory as
// T (every one is already rounded to T), [k][row] so one k of the 8 rows
// is one load; each thread's loads go out in one round, beside the 1/rms
// reduction of the batch tile's rows (a warp per row, in a fixed order)
// where the phase normalises.
//   The GEMVs run on CUDA-core fp32 FMAs from shared memory: warp r takes
// staged row r; its 32 lanes are 8 k-lanes times 4 groups of 4 columns.
//   Order: within a slice, k-lane kl sums k = kl, kl + 8, ... in ascending
// order; the 8 k-lanes are combined by a fixed xor butterfly; the S
// slices' partials are added in order 0..S-1.
//
// streamed.  A work unit is 16 output columns over the whole contraction,
// strided over the grid.  A batch tile's rows are staged in fp32 in
// shared memory: whole rows, once for all of a block's units, in every
// phase whose K fits (8 x K floats beside the partials: K up to 7,134);
// a longer K in slices of at most 7,104 rows, as few as fit, of equal
// length rounded up to the 64 k-lanes (slice_len: a function of K alone),
// staged again for each unit and matrix (one gate's accumulators at a
// time), each thread's accumulators kept across the slices and reduced
// once after the last.  Such shapes, and ragged ones, run kernels of their
// own (Any: one per element type and load width, the cell and the mode
// read at run time), so the whole-row kernels (Fixed) keep their code.
// Each thread streams its weights from global memory with 8 rows of 4
// columns in flight, never past its slice.  Order: 64 k-lanes (8 a warp),
// k-lane kl sums k = kl, kl + 64, ... in ascending order, over the slices
// in turn; a warp's 8 k-lanes by a fixed xor butterfly, then the 8 warps
// in order 0..7.  The RMSNorms' 1/rms is reduced over the whole row (its
// true length) before any slice is staged, and the carried window is
// written on one pass over the slices (block 0's first unit), each
// element once.
//   Feature dims that 16 does not divide run this body only, loading
// element by element: the last column tile ragged (its columns past N
// neither computed nor stored, so no ragged Dh column reaches hs, the
// state or the down product), each row's 1/rms over its true length in
// the vector path's order.  Dims that 16 divides run 16-byte vector loads
// in both bodies, on operands the wrapper keeps 16-byte aligned (it copies
// any other; the launcher refuses one).
//
// Determinism.  In either body every output element is reduced in an
// order that depends only on the dims (and the body they pick).  The batch
// tile, B, C and the grid only change WHICH block does a unit and which
// block arrives last, never how.  So a C-token chunk equals C step
// launches bit for bit, a row's result does not depend on B, and two
// launches give the same bits.
//
// Cast points follow kernel.py:136-157: RMSNorm in fp32 and back to the
// element type T; the conv in T (fp32 sum, rounded to T, bias added in T);
// gates and cell in fp32 from T-valued inputs, with the precise expf /
// log1pf / tanhf forms; h rounded to T; the down and MLP products rounded
// to T before each bias / residual add.  Rows freeze (h, window) at
// t >= valid[b]; their down / MLP read the frozen h.  No tensor cores or
// TMA yet.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "../../csrc/mma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBT = 8;                  // batch rows per tile: a warp each
constexpr int kTN = 16;                 // output columns per work unit
constexpr int kVec = 4;                 // columns per thread
constexpr int kGroups = kTN / kVec;     // column groups per unit
constexpr int kPhases = 4;
constexpr int kSmemCap = 232448;        // shared memory a block may use
constexpr float kEps = 1e-6f;

enum Body { kStreamed = 0, kSplit = 1 };

struct Phase {
  int K, N, ng;         // contraction, columns, matrices
  int ncols, S, Ks, units;
  int job_bytes;        // one unit's weight slice: ng * Ks * kTN elements
  int jobs_max;         // units of the block with the most (block 0)
  int part_off;         // floats into a batch tile's partials
  int cnt_off;          // its column tiles' counters
};

// What a launch runs: a function of the dims, the element size and the
// card, cached per shape by the launcher
struct Layout {
  Phase ph[kPhases];
  int n_ph, body, part_per_tile, counters, ring;
  int vec;              // every dim a multiple of 16: 16-byte vector loads
  int whole;            // streamed: every phase's input staged in whole rows
  int flag_off, rs_off, stage_off, ring_off;    // split: shared memory
  int grid, blocks_per_sm, sms, smem;
};

struct Params : Layout {
  const void* x;        // (B, C, Dx)          T
  const void* gamma;    // (Dx,)               T   RMSNorm scale
  const void* conv_k;   // (K, Dx)             T
  const void* conv_b;   // (Dx,)               T
  const void* win0;     // (B, K-1, Dx)        T   carried window
  const void* wt[kPhases][3];   // each phase's weights (K, N), row-major T
  const void* b[3];     // (Dh,) x n_gates     T
  const void* h0;       // (B, Dh)             T   carried h
  const void* gamma2;   // (Dx,)               T
  const void* bi;       // (Dm,)               T
  const void* bo;       // (Dx,)               T
  const int* valid;     // (B,) int32 or null (= all positions valid)
  void* ys;             // (B, C, Dx)          T   out
  void* hs;             // (B, C, Dh)          T   out
  void* wins;           // (B, C, K-1, Dx)     T   out (use_conv)
  void* xr;             // (B, Dx)             T   scratch (use_mlp)
  void* m;              // (B, Dm)             T   scratch (use_mlp)
  float* part;          // (n_tiles, part_per_tile) fp32 split-K partials
  int* cnt;             // (counters,) int32, zero between launches
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
__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
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

// ===========================================================================
// The split body: balanced K-split phases, weights resident in shared memory
// ===========================================================================
namespace split {

constexpr int kKLanes = 32 / kGroups;   // k-lanes per row: 8
constexpr int kMinKs = 64;              // rows per K slice, at least
constexpr int kUnitOut = kBT * kTN;     // partial sums per gate per tile
constexpr int kTargetUnits = 384;       // units per phase, at least
constexpr int kMaxKs = 384;             // rows per K slice, at most
constexpr int kGroup = 3;               // units computed together, at most

// 8 consecutive elements of an input of the launch (read-only path)
__device__ __forceinline__ void ldg8(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void ldg8(const __nv_bfloat16* p, float* f) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), f);
}
// 8 consecutive elements that another block may have written earlier in
// the same launch: through L2 (.cg), never a stale L1 line
__device__ __forceinline__ void ldcg8(const float* p, float* f) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void ldcg8(const __nv_bfloat16* p, float* f) {
  unpack8(__ldcg(reinterpret_cast<const uint4*>(p)), f);
}
__device__ __forceinline__ float ldcg1(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcg(p));
}

// 4 weights from shared memory
__device__ __forceinline__ void lds4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  unpack2(v.x, f);
  unpack2(v.y, f + 2);
}

// cp.async.wait_group takes an immediate: wait until at most n groups are
// in flight (more than 15 waits for 15, which is only earlier)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: sm90::cp_async_wait<0>(); break;
    case 1: sm90::cp_async_wait<1>(); break;
    case 2: sm90::cp_async_wait<2>(); break;
    case 3: sm90::cp_async_wait<3>(); break;
    case 4: sm90::cp_async_wait<4>(); break;
    case 5: sm90::cp_async_wait<5>(); break;
    case 6: sm90::cp_async_wait<6>(); break;
    case 7: sm90::cp_async_wait<7>(); break;
    case 8: sm90::cp_async_wait<8>(); break;
    case 9: sm90::cp_async_wait<9>(); break;
    case 10: sm90::cp_async_wait<10>(); break;
    case 11: sm90::cp_async_wait<11>(); break;
    case 12: sm90::cp_async_wait<12>(); break;
    case 13: sm90::cp_async_wait<13>(); break;
    case 14: sm90::cp_async_wait<14>(); break;
    default: sm90::cp_async_wait<15>(); break;
  }
}

// Block b takes units b * J .. b * J + J - 1 of a phase (J = jobs_max):
// neighbouring column tiles of one K slice, so its units share their
// staged rows.
__device__ __forceinline__ int first_unit(const Phase& ph) {
  return blockIdx.x * ph.jobs_max;
}
__device__ __forceinline__ int n_jobs(const Phase& ph) {
  const int left = ph.units - first_unit(ph);
  return left <= 0 ? 0 : (left < ph.jobs_max ? left : ph.jobs_max);
}

// The block's job table in shared memory, per phase x: tab[x] its jobs,
// tab[kPhases + x] the index of its first job in the block's list,
// tab[2 kPhases + x] the byte offset of its first slice in the ring.
constexpr int kTabInts = 3 * kPhases;

// the cp.async copies of job i's weight slice of phase X into `slot`,
// laid out [gate][Ks rows][kTN columns]; rows past K fill with zeros
template <typename T, int X>
__device__ void issue_job(const Params& p, int i, unsigned char* slot) {
  const Phase& ph = p.ph[X];
  const int u = first_unit(ph) + i;
  const int col0 = (u % ph.ncols) * kTN, k0 = (u / ph.ncols) * ph.Ks;
  constexpr int kPerRow = kTN * (int)sizeof(T) / 16;   // 16-byte chunks
  constexpr int kElems = 16 / (int)sizeof(T);
  const int per_gate = ph.Ks * kPerRow;
  for (int g = 0; g < ph.ng; ++g) {
    const T* w = static_cast<const T*>(p.wt[X][g]);
    unsigned char* dst = slot + (size_t)g * per_gate * 16;
    for (int q = threadIdx.x; q < per_gate; q += kThreads) {
      const int k = q / kPerRow, h = q % kPerRow;   // powers of two
      const bool ok = k0 + k < ph.K;
      sm90::cp_async16(dst + (size_t)q * 16,
                       ok ? w + (size_t)(k0 + k) * ph.N + col0 + h * kElems
                          : w,
                       ok);
    }
  }
}

// every slice of phase X's jobs, one commit group each, in order
template <typename T, int X>
__device__ void issue_phase(const Params& p, const int* tab,
                            unsigned char* ring) {
  for (int i = 0; i < tab[X]; ++i) {
    issue_job<T, X>(p, i, ring + tab[2 * kPhases + X] +
                              (size_t)i * p.ph[X].job_bytes);
    sm90::cp_async_commit();
  }
}

// ---------------------------------------------------------------------------
// Staging: one batch tile's rows of the K slices the block's jobs read
// (its units are neighbouring column tiles, so mostly one slice) into
// stage[slice][k][r] (T), every load of a thread's items in flight at
// once, and beside them the 1/rms reduction of the tile's rows where the
// phase normalises.  Rows past B are zeros; k past a ragged slice's end is
// not staged (the GEMV stops there).  Neighbouring threads take
// neighbouring rows of one k group, so the transposed stores spread over
// the banks.
// ---------------------------------------------------------------------------

template <typename T>
struct Units {
  const T* slot[kGroup];
  float* part[kGroup];
};

// the K slices a phase's jobs read: first and count
struct Slices {
  int first, n;
};

__device__ __forceinline__ Slices slices_of(const Phase& ph, int nj) {
  const int u0 = first_unit(ph);
  const int first = u0 / ph.ncols;
  return Slices{first, (u0 + nj - 1) / ph.ncols - first + 1};
}

// item v of a staging pass: slice d, row r, slice columns kk..kk+7
struct Item {
  int d, r, kk, k0;
  bool live;
};

__device__ __forceinline__ Item item_at(const Phase& ph, const Slices& sl,
                                        int v) {
  Item it;
  it.d = v / ph.Ks;
  const int rem = v % ph.Ks;
  it.r = rem % kBT;
  it.kk = (rem / kBT) * 8;
  it.k0 = (sl.first + it.d) * ph.Ks;
  it.live = v < sl.n * ph.Ks && it.k0 + it.kk < ph.K;
  return it;
}

template <typename T>
__device__ __forceinline__ void put_rows(T* stage, const Phase& ph,
                                         const Item& it, const float* y) {
  T* s = stage + (size_t)it.d * ph.Ks * kBT;
#pragma unroll
  for (int i = 0; i < 8; ++i) s[(it.kk + i) * kBT + it.r] = from_f<T>(y[i]);
}

// 1/rms of the first `rows` rows of src (D elements, row_stride apart)
// into rs[0..rows): warp r takes row r
template <typename T, bool kInLaunch>
__device__ void stage_rsqrt(const T* src, size_t row_stride, int rows, int D,
                            float* rs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kRound = 2;   // loads in flight per lane
  if (warp >= rows) return;
  const T* row = src + (size_t)warp * row_stride;
  float ss = 0.0f;
  for (int v0 = lane; v0 < D / 8; v0 += 32 * kRound) {
    float f[kRound][8];
#pragma unroll
    for (int j = 0; j < kRound; ++j) {
      const int v = v0 + 32 * j;
      if (v >= D / 8) break;
      if (kInLaunch) ldcg8(row + 8 * v, f[j]);
      else ldg8(row + 8 * v, f[j]);
    }
#pragma unroll
    for (int j = 0; j < kRound; ++j) {
      if (v0 + 32 * j >= D / 8) break;
#pragma unroll
      for (int i = 0; i < 8; ++i) ss = fmaf(f[j][i], f[j][i], ss);
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) rs[warp] = rsqrtf(ss / (float)D + kEps);
}

constexpr int kTaps = 3;    // window taps loaded per round

// Phase A: T(conv(T(RMSNorm(x[b, t])))); the unit of column tile 0 of a
// slice also writes the carried window after position t on its columns.
// x, gamma, the bias, the current tap and up to kTaps window taps load in
// one round, beside the 1/rms reduction.
template <typename T>
__device__ void stage_a(const Params& p, const Phase& ph, const Slices& sl,
                        int nj, int t, int b0, float* rs, T* stage) {
  const int Dx = p.Dx, W = p.K - 1, n = sl.n * ph.Ks;
  const int u0 = first_unit(ph);
  const T* x = static_cast<const T*>(p.x);
  const T* gamma = static_cast<const T*>(p.gamma);
  const T* ck = static_cast<const T*>(p.conv_k);
  const T* cb = static_cast<const T*>(p.conv_b);
  const int rows = min(kBT, p.B - b0);
  for (int base = 0; base < n; base += kThreads) {
    const Item it = item_at(ph, sl, base + threadIdx.x);
    const int b = b0 + it.r, d0 = it.k0 + it.kk;
    const bool ok = it.live && b < p.B;
    float xv[8], gv[8], cy[8], bv[8], wv[kTaps][8], cv[kTaps][8];
    const T* wprev = nullptr;
    if (ok) {
      ldg8(x + ((size_t)b * p.C + t) * Dx + d0, xv);
      ldg8(gamma + d0, gv);
      if (p.use_conv) {
        wprev = (t == 0 ? static_cast<const T*>(p.win0) + (size_t)b * W * Dx
                        : static_cast<const T*>(p.wins) +
                              ((size_t)b * p.C + t - 1) * W * Dx) + d0;
        ldg8(ck + (size_t)W * Dx + d0, cy);
        ldg8(cb + d0, bv);
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          if (k >= W) break;
          if (t == 0) ldg8(wprev + (size_t)k * Dx, wv[k]);
          else ldcg8(wprev + (size_t)k * Dx, wv[k]);
          ldg8(ck + (size_t)k * Dx + d0, cv[k]);
        }
      }
    }
    if (base == 0)
      stage_rsqrt<T, false>(x + ((size_t)b0 * p.C + t) * Dx,
                            (size_t)p.C * Dx, rows, Dx, rs);
    __syncthreads();                        // rs
    if (!it.live) continue;
    float y[8];
    if (!ok) {
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = 0.0f;
      put_rows(stage, ph, it, y);
      continue;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = rnd<T>(xv[i] * rs[it.r] * gv[i]);
    if (p.use_conv) {
      const bool keep = p.valid == nullptr || t < p.valid[b];
      const int wu = (sl.first + it.d) * ph.ncols;   // the slice's tile 0
      T* wout = wu >= u0 && wu < u0 + nj
          ? static_cast<T*>(p.wins) + ((size_t)b * p.C + t) * W * Dx + d0
          : nullptr;
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
      for (int k0 = 0; k0 < W; k0 += kTaps) {
        if (k0 > 0) {                       // taps past the first round
#pragma unroll
          for (int k = 0; k < kTaps; ++k) {
            if (k0 + k >= W) break;
            if (t == 0) ldg8(wprev + (size_t)(k0 + k) * Dx, wv[k]);
            else ldcg8(wprev + (size_t)(k0 + k) * Dx, wv[k]);
            ldg8(ck + (size_t)(k0 + k) * Dx + d0, cv[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          if (k0 + k >= W) break;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = fmaf(wv[k][i], cv[k][i], acc[i]);
          // the window after t: shifted by one where the row is valid
          if (wout != nullptr && (k0 + k > 0 || !keep))
            store8(wout + (size_t)(keep ? k0 + k - 1 : k0 + k) * Dx, wv[k]);
        }
      }
      if (wout != nullptr && keep) store8(wout + (size_t)(W - 1) * Dx, y);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = fmaf(y[i], cy[i], acc[i]);
        y[i] = rnd<T>(rnd<T>(a) + bv[i]);
      }
    }
    put_rows(stage, ph, it, y);
  }
}

// Phases B, D: T-valued rows src[b * row_stride + k] written earlier in
// the launch.  Phase C (gamma != null): T(RMSNorm(xr)), the 1/rms of the
// tile's rows reduced beside the loads.
template <typename T>
__device__ void stage_rows(const Params& p, const Phase& ph, const Slices& sl,
                           const T* src, size_t row_stride, int D, int b0,
                           const T* gamma, float* rs, T* stage) {
  constexpr int U = 2;
  const int n = sl.n * ph.Ks;
  for (int base = 0; base < n; base += kThreads * U) {
    Item it[U];
    float f[U][8], gv[U][8];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      it[j] = item_at(ph, sl, base + j * kThreads + threadIdx.x);
      const int b = b0 + it[j].r, k = it[j].k0 + it[j].kk;
      if (it[j].live && b < p.B) {
        ldcg8(src + (size_t)b * row_stride + k, f[j]);
        if (gamma != nullptr) ldg8(gamma + k, gv[j]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[j][i] = 0.0f;
      }
    }
    if (gamma != nullptr) {
      if (base == 0)
        stage_rsqrt<T, true>(src + (size_t)b0 * row_stride, row_stride,
                             min(kBT, p.B - b0), D, rs);
      __syncthreads();                      // rs
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (!it[j].live) continue;
      if (gamma != nullptr && b0 + it[j].r < p.B) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          f[j][i] = rnd<T>(f[j][i] * rs[it[j].r] * gv[j][i]);
      }
      put_rows(stage, ph, it[j], f[j]);
    }
  }
}

// NJ units' slices of NG batched GEMVs for one batch tile, units that
// share their K slice (so their staged rows): warp r takes staged row r;
// its lane is k-lane kl = lane / 4 (of 8) times column group cg = lane % 4
// (4 columns).  k-lane kl sums k = kl, kl + 8, ... < klen in ascending
// order and the 8 k-lanes are combined by a fixed xor butterfly; lanes
// 0-3 store the row's kTN partial sums of unit j's gate g to
// part[j][g * kUnitOut + r * kTN + c].  The units' independent sums keep
// several loads and FMAs in flight per staged value.
template <typename T, int NG, int NJ>
__device__ void gemv_units(const Units<T>& un, int Ks, int klen,
                           const T* stage) {
  static_assert(kWarps == kBT, "one warp per staged row");
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int cgp = lane % kGroups, kl = lane / kGroups;
  float acc[NJ][NG][kVec];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[j][g][c] = 0.0f;
#pragma unroll 2
  for (int k = kl; k < klen; k += kKLanes) {
    const float a = to_f(stage[k * kBT + r]);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float w[kVec];
        lds4(un.slot[j] + ((size_t)g * Ks + k) * kTN + kVec * cgp, w);
#pragma unroll
        for (int c = 0; c < kVec; ++c)
          acc[j][g][c] = fmaf(a, w[c], acc[j][g][c]);
      }
  }
  // the 8 k-lanes differ in lane bits 2..4
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        float v = acc[j][g][c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[j][g][c] = v;
      }
  if (kl == 0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int g = 0; g < NG; ++g)
        *reinterpret_cast<float4*>(un.part[j] + g * kUnitOut + r * kTN +
                                   kVec * cgp) =
            make_float4(acc[j][g][0], acc[j][g][1], acc[j][g][2],
                        acc[j][g][3]);
  }
}

// pre[g] += the S slices' partials of gate g, in order s = 0..S-1, 8
// slices' loads in flight at a time.  part: (s, g) at part[(s*NG+g)*kUnitOut]
template <int NG>
__device__ __forceinline__ void sum_partials(const float* part, int S,
                                             float* pre) {
  for (int s0 = 0; s0 < S; s0 += 8) {
    float v[8][NG];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int g = 0; g < NG; ++g)
        v[j][g] = s0 + j < S
            ? __ldcg(part + (size_t)((s0 + j) * NG + g) * kUnitOut) : 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (s0 + j < S)
#pragma unroll
        for (int g = 0; g < NG; ++g) pre[g] += v[j][g];
  }
}

// The epilogues of the column tiles this block completed (flags[i] for
// its job i): every (job, tile, row, column) on its own thread, the
// operands loaded before the partials they wait beside.
template <typename T, bool kLSTM, bool kLog, int X>
__device__ void epilogues(const Params& p, const Phase& ph, int t, int nj,
                          const int* flags) {
  constexpr int NG = X == 0 ? (kLSTM ? 3 : 2) : 1;
  const int n_tiles = (p.B + kBT - 1) / kBT, per_job = n_tiles * kUnitOut;
  for (int q = threadIdx.x; q < nj * per_job; q += kThreads) {
    const int i = q / per_job;
    if (!flags[i]) continue;
    const int tile = (q % per_job) / kUnitOut, e = q % kUnitOut;
    const int b = tile * kBT + e / kTN;
    if (b >= p.B) continue;
    const int c = (first_unit(ph) + i) % ph.ncols;
    const int col = c * kTN + e % kTN;
    const float* part = p.part + (size_t)tile * p.part_per_tile +
                        ph.part_off + (size_t)c * ph.S * NG * kUnitOut + e;
    float pre[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) pre[g] = 0.0f;
    if constexpr (X == 0) {
      const int j = col;
      const T hprev = t == 0
          ? static_cast<const T*>(p.h0)[(size_t)b * p.Dh + j]
          : from_f<T>(ldcg1(static_cast<const T*>(p.hs) +
                            ((size_t)b * p.C + t - 1) * p.Dh + j));
      float bias[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g)
        bias[g] = to_f(static_cast<const T*>(p.b[g])[j]);
      const bool keep = p.valid == nullptr || t < p.valid[b];
      sum_partials<NG>(part, ph.S, pre);
      const float h32 = to_f(hprev);
      float h;
      if (!kLSTM) {
        const float z = sigmoidf_(pre[0] + bias[0]);
        const float v = pre[1] + bias[1];
        const float ht = kLog ? g_(v) : v;
        h = (1.0f - z) * h32 + z * ht;
      } else {
        const float kf = pre[0] + bias[0];
        const float ki = pre[1] + bias[1];
        const float v = pre[NG - 1] + bias[NG - 1];
        const float diff = softplusf_(-kf) - softplusf_(-ki);
        const float f = sigmoidf_(-diff), ig = sigmoidf_(diff);
        const float ht = kLog ? g_(v) : v;
        h = f * h32 + ig * ht;
      }
      static_cast<T*>(p.hs)[((size_t)b * p.C + t) * p.Dh + j] =
          keep ? from_f<T>(h) : hprev;
    } else if constexpr (X == 1) {
      const size_t xi = ((size_t)b * p.C + t) * p.Dx + col;
      const float xv = to_f(static_cast<const T*>(p.x)[xi]);
      sum_partials<NG>(part, ph.S, pre);
      const T xr = from_f<T>(xv + rnd<T>(pre[0]));
      if (p.use_mlp) static_cast<T*>(p.xr)[(size_t)b * p.Dx + col] = xr;
      else static_cast<T*>(p.ys)[xi] = xr;
    } else if constexpr (X == 2) {
      const float bias = to_f(static_cast<const T*>(p.bi)[col]);
      sum_partials<NG>(part, ph.S, pre);
      const float mm = rnd<T>(rnd<T>(pre[0]) + bias);
      static_cast<T*>(p.m)[(size_t)b * p.Dm + col] = from_f<T>(gelu_tanh(mm));
    } else {
      const float bias = to_f(static_cast<const T*>(p.bo)[col]);
      const float xr = ldcg1(static_cast<const T*>(p.xr) + (size_t)b * p.Dx +
                             col);
      sum_partials<NG>(part, ph.S, pre);
      const float o = rnd<T>(rnd<T>(pre[0]) + bias);
      static_cast<T*>(p.ys)[((size_t)b * p.C + t) * p.Dx + col] =
          from_f<T>(xr + o);
    }
  }
}

struct Smem {
  int* tab;                 // the job table (kTabInts)
  int* flags;
  float* rs;
  unsigned char* stage;
  unsigned char* ring;
  int jobs;                 // the block's jobs over all phases
};

// One phase X at position t: the block's units (every batch tile staged
// for all of them at once, then their GEMVs), its arrivals, and the
// epilogues of the column tiles it completes.
template <typename T, bool kLSTM, bool kLog, int X>
__device__ void run_phase(const Params& p, int t, const Smem& sm) {
  constexpr int NG = X == 0 ? (kLSTM ? 3 : 2) : 1;
  const Phase& ph = p.ph[X];
  const int nj = n_jobs(ph);
  if (nj == 0) return;
  const int tid = threadIdx.x, u0 = first_unit(ph);
  const int n_tiles = (p.B + kBT - 1) / kBT;
  const Slices sl = slices_of(ph, nj);
  T* stage = reinterpret_cast<T*>(sm.stage);
  const unsigned char* slots = sm.ring + sm.tab[2 * kPhases + X];
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int b0 = tile * kBT;
    if (X == 0) {
      stage_a<T>(p, ph, sl, nj, t, b0, sm.rs, stage);
    } else if (X == 1) {
      stage_rows<T>(p, ph, sl, static_cast<const T*>(p.hs) + (size_t)t * p.Dh,
                    (size_t)p.C * p.Dh, p.Dh, b0, nullptr, sm.rs, stage);
    } else if (X == 2) {
      stage_rows<T>(p, ph, sl, static_cast<const T*>(p.xr), (size_t)p.Dx,
                    p.Dx, b0, static_cast<const T*>(p.gamma2), sm.rs, stage);
    } else {
      stage_rows<T>(p, ph, sl, static_cast<const T*>(p.m), (size_t)p.Dm,
                    p.Dm, b0, nullptr, sm.rs, stage);
    }
    for (int i = 0; i < nj;) {
      // a group: the next units of one K slice, at most kGroup
      const int s = (u0 + i) / ph.ncols;
      int n = 1;
      while (n < kGroup && i + n < nj && (u0 + i + n) / ph.ncols == s) ++n;
      // the first use of these slices: wait for their copies (the list
      // was committed in order, one group a job)
      if (t == 0 && tile == 0)
        cp_async_wait_upto(sm.jobs - 1 - (sm.tab[kPhases + X] + i + n - 1));
      __syncthreads();      // the stage, and the group's slots (all copies)
      Units<T> un;
      for (int j = 0; j < n; ++j) {
        un.slot[j] = reinterpret_cast<const T*>(
            slots + (size_t)(i + j) * ph.job_bytes);
        un.part[j] = p.part + (size_t)tile * p.part_per_tile + ph.part_off +
                     (size_t)(((u0 + i + j) % ph.ncols) * ph.S + s) * NG *
                         kUnitOut;
      }
      const int klen = min(ph.Ks, ph.K - s * ph.Ks);
      const T* st = stage + (size_t)(s - sl.first) * ph.Ks * kBT;
      if (n == 3) gemv_units<T, NG, 3>(un, ph.Ks, klen, st);
      else if (n == 2) gemv_units<T, NG, 2>(un, ph.Ks, klen, st);
      else gemv_units<T, NG, 1>(un, ph.Ks, klen, st);
      i += n;
    }
    __syncthreads();        // the stage is free for the next tile
  }

  // arrive: the block's partial stores before its arrivals; the S-th
  // arrival on a column tile completes it
  __threadfence();
  __syncthreads();
  for (int i = tid; i < nj; i += kThreads) {
    const int c = (u0 + i) % ph.ncols;
    int last = 1;
    if (ph.S > 1) {
      int* cnt = p.cnt + ph.cnt_off + c;
      last = atomicAdd(cnt, 1) == ph.S - 1;
      if (last) {
        atomicExch(cnt, 0);         // ready for the next position
        __threadfence();
      }
    }
    sm.flags[i] = last;
  }
  __syncthreads();
  epilogues<T, kLSTM, kLog, X>(p, ph, t, nj, sm.flags);
}

template <typename T, bool kLSTM, bool kLog>
__global__ void __launch_bounds__(kThreads, 1)
block_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem sm{reinterpret_cast<int*>(smem),
          reinterpret_cast<int*>(smem + p.flag_off),
          reinterpret_cast<float*>(smem + p.rs_off), smem + p.stage_off,
          smem + p.ring_off, 0};
  cg::grid_group grid = cg::this_grid();
  const bool tracing = p.trace != nullptr && blockIdx.x == 0 &&
                       threadIdx.x == 0;
  if (tracing) p.trace[0] = now_ns();
  if (threadIdx.x == 0) {
    int jobs = 0, bytes = 0;
    for (int x = 0; x < p.n_ph; ++x) {
      sm.tab[x] = n_jobs(p.ph[x]);
      sm.tab[kPhases + x] = jobs;
      sm.tab[2 * kPhases + x] = bytes;
      jobs += sm.tab[x];
      bytes += sm.tab[x] * p.ph[x].job_bytes;
    }
  }
  __syncthreads();
  for (int x = 0; x < p.n_ph; ++x) sm.jobs += sm.tab[x];
  // every weight slice of the block, in the order of use; they stay
  issue_phase<T, 0>(p, sm.tab, sm.ring);
  issue_phase<T, 1>(p, sm.tab, sm.ring);
  if (p.use_mlp) {
    issue_phase<T, 2>(p, sm.tab, sm.ring);
    issue_phase<T, 3>(p, sm.tab, sm.ring);
  }
  for (int t = 0; t < p.C; ++t) {
    long long* tr = tracing ? p.trace + 1 + 7 * t : nullptr;
    run_phase<T, kLSTM, kLog, 0>(p, t, sm);
    if (tracing) tr[0] = now_ns();
    grid.sync();                              // h (and the window) ready
    if (tracing) tr[1] = now_ns();
    run_phase<T, kLSTM, kLog, 1>(p, t, sm);
    if (tracing) tr[2] = now_ns();
    if (p.use_mlp) {
      grid.sync();                            // xr ready
      if (tracing) tr[3] = now_ns();
      run_phase<T, kLSTM, kLog, 2>(p, t, sm);
      if (tracing) tr[4] = now_ns();
      grid.sync();                            // m ready
      if (tracing) tr[5] = now_ns();
      run_phase<T, kLSTM, kLog, 3>(p, t, sm);
      if (tracing) tr[6] = now_ns();
    }
    // no barrier before the next position: phase A reads only x, h, the
    // window and its own counters and partials, which phases B-D do not
    // write, and the barrier after it orders every phase-D read of xr / m
    // before the next write
  }
}

}  // namespace split

// ===========================================================================
// The streamed body: a unit per 16 columns over the whole contraction,
// weights streamed from global memory through registers
// ===========================================================================
namespace streamed {

// The body's own arguments: pointers and dims only (a kernel argument
// block the size of Params measured slower on the fp32 minLSTM step on an
// H100).
struct Args {
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
  long long* trace;     // as Params::trace
  int B, C, Dx, Dh, Dm, K, use_conv, use_mlp;
  int lstm, log_mode;   // read by the Any kernels only
};

Args args_of(const Params& p, int lstm, int log_mode) {
  return Args{p.x, p.gamma, p.conv_k, p.conv_b, p.win0,
              {p.wt[0][0], p.wt[0][1], p.wt[0][2]}, {p.b[0], p.b[1], p.b[2]},
              p.h0, p.wt[1][0], p.gamma2, p.wt[2][0], p.bi, p.wt[3][0], p.bo,
              p.valid, p.ys, p.hs, p.wins, p.xr, p.m, p.trace,
              p.B, p.C, p.Dx, p.Dh, p.Dm, p.K, p.use_conv, p.use_mlp,
              lstm, log_mode};
}

constexpr int kLanes = kThreads / kGroups;   // 64 k-lanes, 8 per warp
constexpr int kUnroll = 8;              // weight rows in flight per thread
constexpr int kRed = kWarps * kBT * kTN;     // warp partials per unit
constexpr int kRsOff = kRed;                 // 1/rms of the tile's rows
constexpr int kAOff = kRed + 2 * kBT;        // staged GEMV inputs
// the longest contraction whose 8 staged rows (fp32) fit shared memory
// beside the partials and 1/rms: every phase up to it stages whole rows
constexpr int kWholeMax = (kSmemCap / (int)sizeof(float) - kAOff) / kBT;
constexpr int kSliceCap = kWholeMax / kLanes * kLanes;

// Rows per K slice of a contraction of K: all of K up to kWholeMax, else
// as few slices as fit, of equal length rounded up to the 64 k-lanes (so
// a k-lane's k = kl, kl + 64, ... continues across the slices in order).
// A function of K alone.
__host__ __device__ __forceinline__ int slice_len(int K) {
  if (K <= kWholeMax) return K;
  const int n = (K + kSliceCap - 1) / kSliceCap;
  return ((K + n - 1) / n + kLanes - 1) / kLanes * kLanes;
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
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

// N = 8 consecutive elements by vector loads and stores (dims multiples of
// 16, operands 16-byte aligned), or N = 1 (any dims, any address)
template <int N, typename T>
__device__ __forceinline__ void ldn(const T* p, float* f) {
  if constexpr (N == 8) load8(p, f);
  else f[0] = to_f(*p);
}
template <int N, typename T>
__device__ __forceinline__ void stn(T* p, const float* f) {
  if constexpr (N == 8) store8(p, f);
  else *p = from_f<T>(f[0]);
}

// kUnroll weight rows k0, k0 + kLanes, ... of this thread's 4 columns;
// rows past K load as zeros, and (kVector false) columns past `ncol`.
template <typename T, bool kVector>
__device__ __forceinline__ void load_rows(const T* wp, int N, int K, int k0,
                                          int ncol,
                                          float (&w)[kUnroll][kVec]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int k = k0 + u * kLanes;
    if (kVector && k < K) {
      load4(wp + (size_t)k * N, w[u]);
    } else {
#pragma unroll
      for (int c = 0; c < kVec; ++c)
        w[u][c] = !kVector && k < K && c < ncol
            ? to_f(wp[(size_t)k * N + c]) : 0.0f;
    }
  }
}

// acc[r][c] += the terms k0 <= k < k0 + klen of a batched GEMV: staged
// rows a[r * lda + k - k0] (fp32 in shared memory) against W (K, N)
// row-major at columns col0 + 4 cgp + c.  Thread (k-lane kl, column group
// cgp) takes k = k0 + kl, k0 + kl + 64, ... in ascending order.
// kVector: 4 columns a load (N a multiple of 16, W aligned); else one,
// columns past N as zeros.
template <typename T, bool kVector>
__device__ __forceinline__ void gemv_acc(float (&acc)[kBT][kVec],
                                         const T* __restrict__ W, int N,
                                         int col0, int k0, int klen,
                                         const float* __restrict__ a,
                                         int lda) {
  const int tid = threadIdx.x;
  const int cgp = tid % kGroups;
  const int kl = tid / kGroups;
  const T* wp = W + (size_t)k0 * N + col0 + kVec * cgp;
  const int ncol = N - col0 - kVec * cgp;
  // software-pipelined: the next kUnroll weight rows are in flight while
  // this iteration's FMAs run (left to itself the compiler sinks each
  // load to its first use, serialising kUnroll memory latencies).  Rows
  // past the slice load as zeros and read no staged value; adding +0
  // changes no sum.
  float wn[kUnroll][kVec];
  load_rows<T, kVector>(wp, N, klen, kl, ncol, wn);
  for (int kk = kl; kk < klen; kk += kUnroll * kLanes) {
    float w[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int c = 0; c < kVec; ++c) w[u][c] = wn[u][c];
    load_rows<T, kVector>(wp, N, klen, kk + kUnroll * kLanes, ncol, wn);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = kk + u * kLanes;
#pragma unroll
      for (int r = 0; r < kBT; ++r) {
        const float av = k < klen ? a[r * lda + k] : 0.0f;
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[r][c] = fmaf(av, w[u][c], acc[r][c]);
      }
    }
  }
}

// The unit's sums for row tid / TN, column tid % TN (thread tid < BT*TN)
// from every thread's accumulators: a warp's 8 k-lanes by a fixed xor
// butterfly, then the 8 warps in order 0..7.  Ends on a barrier: red is
// free again on return.
__device__ __forceinline__ float reduce_unit(float (&acc)[kBT][kVec],
                                             float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cgp = tid % kGroups;
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

// 1/rms of row b0 + warp into rs[warp] (0 for rows past B), over all D
// elements of the row: lane j takes 8-element groups j, j + 32, ... in
// order (kVector: a vector load each; else one element at a time, the
// same sum), then the warp's butterfly.
template <typename T, bool kVector>
__device__ void stage_rsqrt(const T* __restrict__ base, size_t row_stride,
                            int B, int b0, int D, float* rs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = b0 + warp;
  float ss = 0.0f;
  if (b < B) {
    const T* row = base + (size_t)b * row_stride;
    for (int v = lane; v < (D + 7) / 8; v += 32) {
      float f[8];
      if constexpr (kVector) {
        load8(row + 8 * v, f);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          f[i] = 8 * v + i < D ? to_f(row[8 * v + i]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) ss = fmaf(f[i], f[i], ss);
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) rs[warp] = b < B ? rsqrtf(ss / (float)D + kEps) : 0.0f;
}

// Phase A staging: a[r, d - k0] = T(conv(T(RMSNorm(x[b, t]))))[d] for the
// tile's rows and d in [k0, k0 + klen) (rs: the rows' 1/rms over all of
// Dx), row stride lda.  write_window: also the carried window after
// position t on those columns; the caller passes it on one pass over the
// row's slices only, so each element is written once.
template <typename T, bool kVector>
__device__ void stage_mixer_input(const Args& p, int t, int b0, int k0,
                                  int klen, int lda, float* a,
                                  const float* rs, bool write_window) {
  constexpr int NV = kVector ? 8 : 1;
  const int Dx = p.Dx, W = p.K - 1, per_row = klen / NV;
  const T* x = static_cast<const T*>(p.x);
  const T* gamma = static_cast<const T*>(p.gamma);
  const T* ck = static_cast<const T*>(p.conv_k);
  const T* cb = static_cast<const T*>(p.conv_b);
  for (int v = threadIdx.x; v < kBT * per_row; v += kThreads) {
    const int r = v / per_row, dd = (v % per_row) * NV, d0 = k0 + dd;
    const int b = b0 + r;
    float y[NV];
    if (b >= p.B) {
#pragma unroll
      for (int i = 0; i < NV; ++i) y[i] = 0.0f;
      stn<NV>(a + r * lda + dd, y);
      continue;
    }
    float xv[NV], gv[NV];
    ldn<NV>(x + ((size_t)b * p.C + t) * Dx + d0, xv);
    ldn<NV>(gamma + d0, gv);
#pragma unroll
    for (int i = 0; i < NV; ++i) y[i] = rnd<T>(xv[i] * rs[r] * gv[i]);
    if (p.use_conv) {
      const T* wprev = t == 0
          ? static_cast<const T*>(p.win0) + (size_t)b * W * Dx
          : static_cast<const T*>(p.wins) + ((size_t)b * p.C + t - 1) * W * Dx;
      float acc[NV], wv[NV], cv[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[i] = 0.0f;
      for (int k = 0; k < W; ++k) {
        ldn<NV>(wprev + (size_t)k * Dx + d0, wv);
        ldn<NV>(ck + (size_t)k * Dx + d0, cv);
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[i] = fmaf(wv[i], cv[i], acc[i]);
      }
      ldn<NV>(ck + (size_t)W * Dx + d0, cv);
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[i] = fmaf(y[i], cv[i], acc[i]);
      if (write_window) {
        const bool keep = p.valid == nullptr || t < p.valid[b];
        T* wout = static_cast<T*>(p.wins) + ((size_t)b * p.C + t) * W * Dx;
        for (int k = 0; k < W; ++k) {
          if (keep && k + 1 == W) {
            stn<NV>(wout + (size_t)k * Dx + d0, y);
          } else {
            ldn<NV>(wprev + (size_t)(keep ? k + 1 : k) * Dx + d0, wv);
            stn<NV>(wout + (size_t)k * Dx + d0, wv);
          }
        }
      }
      ldn<NV>(cb + d0, cv);
#pragma unroll
      for (int i = 0; i < NV; ++i) y[i] = rnd<T>(rnd<T>(acc[i]) + cv[i]);
    }
    stn<NV>(a + r * lda + dd, y);
  }
}

// Stage columns [k0, k0 + klen) of the tile's T-valued rows src[b *
// row_stride + d] into a (fp32, row stride lda); with gamma, as
// T(RMSNorm(row)) (rs: the rows' 1/rms over the whole row).
template <typename T, bool kVector>
__device__ void stage_rows(const T* __restrict__ src, size_t row_stride,
                           int B, int b0, int k0, int klen, int lda,
                           float* a, const T* __restrict__ gamma = nullptr,
                           const float* rs = nullptr) {
  constexpr int NV = kVector ? 8 : 1;
  const int per_row = klen / NV;
  for (int v = threadIdx.x; v < kBT * per_row; v += kThreads) {
    const int r = v / per_row, dd = (v % per_row) * NV, b = b0 + r;
    float f[NV];
    if (b < B) {
      ldn<NV>(src + (size_t)b * row_stride + k0 + dd, f);
      if (gamma != nullptr) {
        float gv[NV];
        ldn<NV>(gamma + k0 + dd, gv);
#pragma unroll
        for (int i = 0; i < NV; ++i) f[i] = rnd<T>(f[i] * rs[r] * gv[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NV; ++i) f[i] = 0.0f;
    }
    stn<NV>(a + r * lda + dd, f);
  }
}

// What a streamed kernel fixes when it is compiled.  Fixed: the cell and
// the mode, 16-byte vector loads, every phase's input staged in whole
// rows (the LMs' fp32 widths: one kernel per element type, cell and
// mode).  Any: the cell and the mode read from the arguments, loads by
// kVec16, each phase's input staged again for every unit in K slices of
// slice_len(K), one where K fits (every other shape: one kernel per
// element type and load width, so the wide and ragged shapes add no code
// to the Fixed kernels, which run as fast as before them).  Any<false>
// gives Any<true>'s bits at every shape Any<true> takes, but at B 8 x Dx
// 1024 x Dh 2048 x Dm 8192 it took 2.2-2.7x Any<true>'s time on an H100
// (block_step/ab.py --dims 1024 2048 8192), so aligned dims keep 16-byte
// loads.
template <bool kLSTM, bool kLog>
struct Fixed {
  static constexpr bool kVector = true, kSliced = false;
  __device__ static constexpr bool lstm(const Args&) { return kLSTM; }
  __device__ static constexpr bool log(const Args&) { return kLog; }
};
template <bool kVec16>
struct Any {
  static constexpr bool kVector = kVec16, kSliced = true;
  __device__ static bool lstm(const Args& p) { return p.lstm != 0; }
  __device__ static bool log(const Args& p) { return p.log_mode != 0; }
};

// One unit's sums over whole staged rows a[r * K + k]: the accumulators
// from zeros over all of K, then reduce_unit.
template <typename T, bool kVector>
__device__ float gemv_unit(const T* __restrict__ W, int N, int K, int col0,
                           const float* __restrict__ a, float* red) {
  float acc[kBT][kVec];
#pragma unroll
  for (int r = 0; r < kBT; ++r)
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[r][c] = 0.0f;
  gemv_acc<T, kVector>(acc, W, N, col0, 0, K, a, K);
  return reduce_unit(acc, red);
}

// One unit's sums over K slices of Ks rows: `stage(k0, klen)` stages
// each into a (row stride Ks), the accumulators kept across the slices,
// one reduce_unit after the last.
template <typename T, bool kVector, typename Stage>
__device__ float gemv_slices(const T* __restrict__ W, int N, int K, int Ks,
                             int col0, const float* __restrict__ a,
                             float* red, Stage stage) {
  float acc[kBT][kVec];
#pragma unroll
  for (int r = 0; r < kBT; ++r)
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[r][c] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += Ks) {
    const int klen = K - k0 < Ks ? K - k0 : Ks;
    stage(k0, klen);
    __syncthreads();                          // the slice is staged
    gemv_acc<T, kVector>(acc, W, N, col0, k0, klen, a, Ks);
    __syncthreads();                          // and read by every thread
  }
  return reduce_unit(acc, red);
}

// One phase's units for every batch tile: ng (at most 3) matrices W[g]
// (K, N), unit u the 16 columns from 16 u, strided over the grid.  Per
// tile, `tile(b0)` first (the 1/rms where the phase normalises), then the
// input rows staged by `stage(b0, k0, klen, lda, first)`: Fixed, whole
// rows once for all of the block's units; Any, slice by slice again for
// each unit and matrix (`first` on the block's first pass over the row;
// one matrix's accumulators at a time); then `epi(b0, col0, pre)` on the
// unit's sums.
template <typename T, typename Cfg, typename Tile, typename Stage,
          typename Epi>
__device__ void run_units(int B, int K, int N, int ng, const T* const* W,
                          float* a, float* red, Tile tile, Stage stage,
                          Epi epi) {
  const int n_units = (N + kTN - 1) / kTN;
  if ((int)blockIdx.x >= n_units) return;
  const int Ks = slice_len(K);
  for (int b0 = 0; b0 < B; b0 += kBT) {
    tile(b0);
    if constexpr (!Cfg::kSliced) {
      stage(b0, 0, K, K, true);
      __syncthreads();
    }
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int col0 = u * kTN;
      float pre[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        if (g >= ng) break;
        if constexpr (!Cfg::kSliced) {
          pre[g] = gemv_unit<T, Cfg::kVector>(W[g], N, K, col0, a, red);
        } else {
          const bool first = u == (int)blockIdx.x && g == 0;
          pre[g] = gemv_slices<T, Cfg::kVector>(
              W[g], N, K, Ks, col0, a, red, [&](int k0, int klen) {
                stage(b0, k0, klen, Ks, first);
              });
        }
      }
      epi(b0, col0, pre);
    }
    __syncthreads();
  }
}

template <typename T, typename Cfg>
__device__ void phase_a(const Args& p, int t, float* a, float* red,
                        float* rs) {
  const bool lstm = Cfg::lstm(p), log_mode = Cfg::log(p);
  const T* W[3] = {static_cast<const T*>(p.w[0]),
                   static_cast<const T*>(p.w[1]),
                   static_cast<const T*>(p.w[2])};
  const T* x = static_cast<const T*>(p.x);
  run_units<T, Cfg>(
      p.B, p.Dx, p.Dh, lstm ? 3 : 2, W, a, red,
      [&](int b0) {
        stage_rsqrt<T, Cfg::kVector>(x + (size_t)t * p.Dx,
                                     (size_t)p.C * p.Dx, p.B, b0, p.Dx, rs);
        __syncthreads();
      },
      [&](int b0, int k0, int klen, int lda, bool first) {
        stage_mixer_input<T, Cfg::kVector>(p, t, b0, k0, klen, lda, a, rs,
                                           first && blockIdx.x == 0);
      },
      [&](int b0, int j0, const float (&pre)[3]) {
        const int tid = threadIdx.x;
        if (tid >= kBT * kTN) return;
        const int b = b0 + tid / kTN, j = j0 + tid % kTN;
        if (b >= p.B || j >= p.Dh) return;
        const T* hprev_p =
            t == 0 ? static_cast<const T*>(p.h0) + (size_t)b * p.Dh
                   : static_cast<const T*>(p.hs) +
                         ((size_t)b * p.C + t - 1) * p.Dh;
        const T hprev = hprev_p[j];
        const float h32 = to_f(hprev);
        float h;
        if (!lstm) {
          const float kz = pre[0] + to_f(static_cast<const T*>(p.b[0])[j]);
          const float v = pre[1] + to_f(static_cast<const T*>(p.b[1])[j]);
          const float z = sigmoidf_(kz);
          const float ht = log_mode ? g_(v) : v;
          h = (1.0f - z) * h32 + z * ht;
        } else {
          const float kf = pre[0] + to_f(static_cast<const T*>(p.b[0])[j]);
          const float ki = pre[1] + to_f(static_cast<const T*>(p.b[1])[j]);
          const float v = pre[2] + to_f(static_cast<const T*>(p.b[2])[j]);
          const float diff = softplusf_(-kf) - softplusf_(-ki);
          const float f = sigmoidf_(-diff), i = sigmoidf_(diff);
          const float ht = log_mode ? g_(v) : v;
          h = f * h32 + i * ht;
        }
        const bool keep = p.valid == nullptr || t < p.valid[b];
        static_cast<T*>(p.hs)[((size_t)b * p.C + t) * p.Dh + j] =
            keep ? from_f<T>(h) : hprev;
      });
}

template <typename T, typename Cfg>
__device__ void phase_b(const Args& p, int t, float* a, float* red) {
  const T* W[1] = {static_cast<const T*>(p.down)};
  const T* hs = static_cast<const T*>(p.hs) + (size_t)t * p.Dh;
  run_units<T, Cfg>(
      p.B, p.Dh, p.Dx, 1, W, a, red, [](int) {},
      [&](int b0, int k0, int klen, int lda, bool) {
        stage_rows<T, Cfg::kVector>(hs, (size_t)p.C * p.Dh, p.B, b0, k0,
                                    klen, lda, a);
      },
      [&](int b0, int i0, const float (&s)[3]) {
        const int tid = threadIdx.x;
        if (tid >= kBT * kTN) return;
        const int b = b0 + tid / kTN, i = i0 + tid % kTN;
        if (b >= p.B || i >= p.Dx) return;
        const size_t xi = ((size_t)b * p.C + t) * p.Dx + i;
        const T xr =
            from_f<T>(to_f(static_cast<const T*>(p.x)[xi]) + rnd<T>(s[0]));
        if (p.use_mlp) static_cast<T*>(p.xr)[(size_t)b * p.Dx + i] = xr;
        else static_cast<T*>(p.ys)[xi] = xr;
      });
}

template <typename T, typename Cfg>
__device__ void phase_c(const Args& p, float* a, float* red, float* rs) {
  const T* W[1] = {static_cast<const T*>(p.wi)};
  const T* xr = static_cast<const T*>(p.xr);
  const T* gamma2 = static_cast<const T*>(p.gamma2);
  run_units<T, Cfg>(
      p.B, p.Dx, p.Dm, 1, W, a, red,
      [&](int b0) {
        stage_rsqrt<T, Cfg::kVector>(xr, (size_t)p.Dx, p.B, b0, p.Dx, rs);
        __syncthreads();
      },
      [&](int b0, int k0, int klen, int lda, bool) {
        stage_rows<T, Cfg::kVector>(xr, (size_t)p.Dx, p.B, b0, k0, klen,
                                    lda, a, gamma2, rs);
      },
      [&](int b0, int j0, const float (&s)[3]) {
        const int tid = threadIdx.x;
        if (tid >= kBT * kTN) return;
        const int b = b0 + tid / kTN, j = j0 + tid % kTN;
        if (b >= p.B || j >= p.Dm) return;
        const float mm =
            rnd<T>(rnd<T>(s[0]) + to_f(static_cast<const T*>(p.bi)[j]));
        static_cast<T*>(p.m)[(size_t)b * p.Dm + j] = from_f<T>(gelu_tanh(mm));
      });
}

template <typename T, typename Cfg>
__device__ void phase_d(const Args& p, int t, float* a, float* red) {
  const T* W[1] = {static_cast<const T*>(p.wo)};
  const T* m = static_cast<const T*>(p.m);
  run_units<T, Cfg>(
      p.B, p.Dm, p.Dx, 1, W, a, red, [](int) {},
      [&](int b0, int k0, int klen, int lda, bool) {
        stage_rows<T, Cfg::kVector>(m, (size_t)p.Dm, p.B, b0, k0, klen, lda,
                                    a);
      },
      [&](int b0, int i0, const float (&s)[3]) {
        const int tid = threadIdx.x;
        if (tid >= kBT * kTN) return;
        const int b = b0 + tid / kTN, i = i0 + tid % kTN;
        if (b >= p.B || i >= p.Dx) return;
        const float o =
            rnd<T>(rnd<T>(s[0]) + to_f(static_cast<const T*>(p.bo)[i]));
        const float xr =
            to_f(static_cast<const T*>(p.xr)[(size_t)b * p.Dx + i]);
        static_cast<T*>(p.ys)[((size_t)b * p.C + t) * p.Dx + i] =
            from_f<T>(xr + o);
      });
}

template <typename T, typename Cfg>
__global__ void __launch_bounds__(kThreads, 1)
block_kernel(Args p) {
  extern __shared__ float smem[];
  float* red = smem;
  float* rs = smem + kRsOff;
  float* a = smem + kAOff;            // kBT * the longest slice_len(K)
  cg::grid_group grid = cg::this_grid();
  const bool tracing = p.trace != nullptr && blockIdx.x == 0 &&
                       threadIdx.x == 0;
  if (tracing) p.trace[0] = now_ns();
  for (int t = 0; t < p.C; ++t) {
    long long* tr = tracing ? p.trace + 1 + 7 * t : nullptr;
    phase_a<T, Cfg>(p, t, a, red, rs);
    if (tracing) tr[0] = now_ns();
    grid.sync();                              // h (and the window) ready
    if (tracing) tr[1] = now_ns();
    phase_b<T, Cfg>(p, t, a, red);
    if (tracing) tr[2] = now_ns();
    if (p.use_mlp) {
      grid.sync();                            // xr ready
      if (tracing) tr[3] = now_ns();
      phase_c<T, Cfg>(p, a, red, rs);
      if (tracing) tr[4] = now_ns();
      grid.sync();                            // m ready
      if (tracing) tr[5] = now_ns();
      phase_d<T, Cfg>(p, t, a, red);
      if (tracing) tr[6] = now_ns();
    }
    // no barrier before the next position: phase A reads only x, h and
    // the window, which phases B-D do not write, and the barrier after
    // it orders every phase-D read of xr / m before the next write
  }
}

}  // namespace streamed

// ---------------------------------------------------------------------------
// Host: the plan (a function of the dims, the element size and the card),
// cached per shape, its launch and its report.
// ---------------------------------------------------------------------------

int ceil_div(int a, int b) { return (a + b - 1) / b; }
int round_up(int a, int b) { return ceil_div(a, b) * b; }

// rows per K slice of the split body: at least kTargetUnits units in the
// phase, slices of 64 (or all of K) to kMaxKs rows in steps of 16
int slice_rows(int K, int ncols) {
  const int s0 = ceil_div(split::kTargetUnits, ncols);
  int ks = round_up(ceil_div(K, s0), 16);
  const int kmin = K < split::kMinKs ? K : split::kMinKs;
  if (ks < kmin) ks = kmin;
  if (ks > split::kMaxKs) ks = split::kMaxKs;
  return ks;
}

// the phases' shapes, each split into slices of ks(K, ncols) rows, and
// the grid: one block per SM, or fewer where no phase has that many units
// (a unit: a column tile times a slice where slices_are_units, the split
// body's; else a column tile over all its slices, the streamed body's)
template <typename KsRule>
void plan_phases(Layout& L, const int dims[kPhases][3], int elem, int cap,
                 KsRule ks_rule, bool slices_are_units) {
  int max_units = 0;
  for (int x = 0; x < L.n_ph; ++x) {
    Phase& ph = L.ph[x];
    ph.K = dims[x][0]; ph.N = dims[x][1]; ph.ng = dims[x][2];
    ph.ncols = ceil_div(ph.N, kTN);
    ph.Ks = ks_rule(ph.K, ph.ncols);
    ph.S = ceil_div(ph.K, ph.Ks);
    ph.units = slices_are_units ? ph.ncols * ph.S : ph.ncols;
    ph.job_bytes = ph.ng * ph.Ks * kTN * elem;
    if (ph.units > max_units) max_units = ph.units;
  }
  L.grid = max_units < cap ? max_units : cap;
  for (int x = 0; x < L.n_ph; ++x)
    L.ph[x].jobs_max = ceil_div(L.ph[x].units, L.grid);
}

// The split body's plan where every block's slices fit its shared memory
// beside the job table, the flags, 1/rms and the stage: returns true and
// fills L; else false.  Nothing in it depends on B or C.
bool plan_split(Layout& L, const int dims[kPhases][3], int elem) {
  plan_phases(L, dims, elem, L.sms, slice_rows, true);
  int part = 0, cnt = 0, ring = 0, jobs_cap = 0, max_stage = 0;
  for (int x = 0; x < L.n_ph; ++x) {
    Phase& ph = L.ph[x];
    ph.part_off = part;
    ph.cnt_off = cnt;
    part += ph.units * ph.ng * split::kUnitOut;
    cnt += ph.ncols;
    ring += ph.jobs_max * ph.job_bytes;
    if (ph.jobs_max > jobs_cap) jobs_cap = ph.jobs_max;
    // K slices one block's jobs (neighbouring units) can span
    int spans = (ph.jobs_max - 1) / ph.ncols + 2;
    if (spans > ph.jobs_max) spans = ph.jobs_max;
    if (spans * ph.Ks > max_stage) max_stage = spans * ph.Ks;
  }
  L.part_per_tile = part;
  L.counters = cnt;
  L.ring = ring;
  L.flag_off = split::kTabInts * 4;
  L.rs_off = L.flag_off + round_up(jobs_cap * 4, 16);
  L.stage_off = L.rs_off + round_up(kBT * 4, 16);
  L.ring_off = L.stage_off + round_up(max_stage * kBT * elem, 16);
  L.smem = L.ring_off + L.ring;
  return L.smem <= kSmemCap;
}

// The streamed body's plan on a grid of at most `cap` blocks: a unit per
// 16 columns (the last one ragged) over all of K, 8 rows of each phase's
// input staged in fp32, whole or in K slices (streamed::slice_len, S the
// slices; the staged rows fit shared memory at any K)
void plan_streamed(Layout& L, const int dims[kPhases][3], int elem,
                   int cap) {
  plan_phases(L, dims, elem, cap,
              [](int K, int) { return streamed::slice_len(K); }, false);
  int kmax = 0;
  L.whole = 1;
  for (int x = 0; x < L.n_ph; ++x) {
    if (L.ph[x].Ks > kmax) kmax = L.ph[x].Ks;
    if (L.ph[x].S > 1) L.whole = 0;
  }
  L.part_per_tile = L.counters = L.ring = 0;
  L.flag_off = L.rs_off = L.stage_off = L.ring_off = 0;
  L.smem = (streamed::kAOff + kBT * kmax) * (int)sizeof(float);
}

// the plan's kernel: split, or streamed Fixed (vector loads, whole rows)
// or Any (K slices or element loads)
template <typename T, bool kLSTM, bool kLog>
const void* kernel_of(const Layout& L) {
  using namespace streamed;
  if (L.body == kSplit)
    return (const void*)split::block_kernel<T, kLSTM, kLog>;
  if (L.vec && L.whole)
    return (const void*)block_kernel<T, Fixed<kLSTM, kLog>>;
  return L.vec ? (const void*)block_kernel<T, Any<true>>
               : (const void*)block_kernel<T, Any<false>>;
}

// the plan of a shape on the current device; 0 or a cudaError_t
template <typename T, bool kLSTM, bool kLog>
int make_plan(const Params& p, Layout& L) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&L.sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return (int)err;
  const int elem = (int)sizeof(T);
  const int dims[kPhases][3] = {{p.Dx, p.Dh, kLSTM ? 3 : 2}, {p.Dh, p.Dx, 1},
                                {p.Dx, p.Dm, 1}, {p.Dm, p.Dx, 1}};
  L.n_ph = p.use_mlp ? 4 : 2;
  // feature dims that 16 does not divide (a ragged last column tile,
  // rows that are not 16-byte multiples) take the streamed body, element
  // by element
  L.vec = p.Dx % kTN == 0 && p.Dh % kTN == 0 &&
          (!p.use_mlp || p.Dm % kTN == 0);
  L.body = L.vec && plan_split(L, dims, elem) ? kSplit : kStreamed;
  // the streamed body's smem, then (below) the grid its occupancy allows
  if (L.body == kStreamed) plan_streamed(L, dims, elem, L.sms);
  // the kernel's dynamic shared memory limit, raised to this plan's use
  // and no further (a limit at the cap measured slower on the fp32
  // minLSTM step on an H100)
  const void* kernel = kernel_of<T, kLSTM, kLog>(L);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  if (fa.maxDynamicSharedSizeBytes < L.smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L.smem);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&L.blocks_per_sm, kernel,
                                                      kThreads, L.smem);
  if (err != cudaSuccess) return (int)err;
  if (L.blocks_per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (L.body == kStreamed)
    plan_streamed(L, dims, elem, L.blocks_per_sm * L.sms);
  return 0;
}

// Plans cached by shape (and instantiation, whose kernel the plan set up):
// the engine's layers share one, so a launch makes no occupancy or
// attribute query.  Host-side and unsynchronised: one thread of a process
// issues the launches, as the wrappers' callers do.
struct PlanKey {
  int device, lstm, log_mode, bf16, use_conv, use_mlp, Dx, Dh, Dm, K;
};
struct PlanEntry {
  PlanKey key;
  Layout layout;
  bool used;
};
constexpr int kPlanCache = 8;
PlanEntry plan_cache[kPlanCache];
int plan_next = 0;

// whether a T-valued operand the vector loads read or write is off a
// 16-byte boundary (the wrapper hands the vector path aligned copies)
bool misaligned(const Params& p) {
  const void* ptrs[] = {p.x, p.gamma, p.conv_k, p.conv_b, p.win0,
                        p.wt[0][0], p.wt[0][1], p.wt[0][2], p.wt[1][0],
                        p.wt[2][0], p.wt[3][0], p.b[0], p.b[1], p.b[2],
                        p.h0, p.gamma2, p.bi, p.bo, p.ys, p.hs, p.wins,
                        p.xr, p.m};
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return true;
  return false;
}

template <typename T, bool kLSTM, bool kLog>
int plan_and_launch(Params& p, cudaStream_t stream, bool run) {
  PlanKey key{0, kLSTM, kLog, sizeof(T) == 2, p.use_conv, p.use_mlp,
              p.Dx, p.Dh, p.use_mlp ? p.Dm : 0, p.use_conv ? p.K : 0};
  cudaError_t err = cudaGetDevice(&key.device);
  if (err != cudaSuccess) return (int)err;
  Layout& L = p;
  const PlanEntry* hit = nullptr;
  for (const PlanEntry& e : plan_cache)
    if (e.used && memcmp(&e.key, &key, sizeof key) == 0) hit = &e;
  if (hit != nullptr) {
    L = hit->layout;
  } else {
    const int rc = make_plan<T, kLSTM, kLog>(p, L);
    if (rc) return rc;
    plan_cache[plan_next] = PlanEntry{key, L, true};
    plan_next = (plan_next + 1) % kPlanCache;
  }
  if (!run) return 0;
  if (L.vec && misaligned(p)) return (int)cudaErrorMisalignedAddress;
  streamed::Args a;
  void* kargs[] = {&p};
  if (p.body == kStreamed) {
    a = streamed::args_of(p, kLSTM, kLog);
    kargs[0] = &a;
  }
  err = cudaLaunchCooperativeKernel(kernel_of<T, kLSTM, kLog>(p),
                                    dim3(p.grid), dim3(kThreads), kargs,
                                    (size_t)p.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int dispatch(Params& p, int lstm, int log_mode, int bf16, cudaStream_t s,
             bool run) {
  const int key = (lstm ? 4 : 0) | (log_mode ? 2 : 0) | (bf16 ? 1 : 0);
  switch (key) {
    case 0: return plan_and_launch<float, false, false>(p, s, run);
    case 1: return plan_and_launch<__nv_bfloat16, false, false>(p, s, run);
    case 2: return plan_and_launch<float, false, true>(p, s, run);
    case 3: return plan_and_launch<__nv_bfloat16, false, true>(p, s, run);
    case 4: return plan_and_launch<float, true, false>(p, s, run);
    case 5: return plan_and_launch<__nv_bfloat16, true, false>(p, s, run);
    case 6: return plan_and_launch<float, true, true>(p, s, run);
    default: return plan_and_launch<__nv_bfloat16, true, true>(p, s, run);
  }
}

int fill_dims(Params& p, int use_conv, int use_mlp, int B, int C, int Dx,
              int Dh, int Dm, int K) {
  if (Dx < 1 || Dh < 1 || (use_mlp && Dm < 1) || B < 1 || C < 1 ||
      (use_conv && K < 2))
    return (int)cudaErrorInvalidValue;
  p.B = B; p.C = C; p.Dx = Dx; p.Dh = Dh; p.Dm = Dm; p.K = K;
  p.use_conv = use_conv; p.use_mlp = use_mlp;
  return 0;
}

}  // namespace

extern "C" {

// Launch one whole-block step (C == 1, valid == null) or varlen chunk.
// ptrs: x, gamma, conv_k, conv_b, win0, w0, w1, w2, b0, b1, b2, h0, down,
//       gamma2, wi, bi, wo, bo, valid, ys, hs, wins, xr, m, trace, part,
//       cnt (27 pointers; valid and trace may be null; part and cnt are
//       read only by the split body).  part holds ceil(B / 8) x
//       partials_per_tile floats and cnt `counters` int32 zeros
//       (repro_block_plan); the launch leaves cnt zero again.
// Returns 0 or the cudaError_t of the launch.
int repro_block_launch(int lstm, int log_mode, int bf16, int use_conv,
                       int use_mlp, int B, int C, int Dx, int Dh, int Dm,
                       int K, void* const* ptrs, void* stream,
                       int* grid_out) {
  Params p;
  int rc = fill_dims(p, use_conv, use_mlp, B, C, Dx, Dh, Dm, K);
  if (rc) return rc;
  p.x = ptrs[0]; p.gamma = ptrs[1]; p.conv_k = ptrs[2]; p.conv_b = ptrs[3];
  p.win0 = ptrs[4];
  for (int g = 0; g < 3; ++g) {
    p.wt[0][g] = ptrs[5 + g];
    p.b[g] = ptrs[8 + g];
  }
  for (int x = 1; x < kPhases; ++x) p.wt[x][1] = p.wt[x][2] = nullptr;
  p.h0 = ptrs[11]; p.wt[1][0] = ptrs[12]; p.gamma2 = ptrs[13];
  p.wt[2][0] = ptrs[14]; p.bi = ptrs[15]; p.wt[3][0] = ptrs[16];
  p.bo = ptrs[17];
  p.valid = static_cast<const int*>(ptrs[18]);
  p.ys = ptrs[19]; p.hs = ptrs[20]; p.wins = ptrs[21]; p.xr = ptrs[22];
  p.m = ptrs[23];
  p.trace = static_cast<long long*>(ptrs[24]);
  p.part = static_cast<float*>(ptrs[25]);
  p.cnt = static_cast<int*>(ptrs[26]);
  rc = dispatch(p, lstm, log_mode, bf16, static_cast<cudaStream_t>(stream),
                true);
  if (grid_out) *grid_out = rc ? 0 : p.grid;
  return rc;
}

// The plan a launch of this shape runs (on the current device); launches
// nothing.  out (at least 10 + 8 * 4 ints): n_phases, body (1 split, 0
// streamed), grid, blocks_per_sm, sms, smem bytes, ring bytes (the split
// body's resident weight slices), partials_per_tile, counters; then per
// phase (A, B, C, D): K, N, gates, S, slice rows, units, jobs_max (units
// of the block with the most), job_bytes.  Returns 0 or a cudaError_t.
int repro_block_plan(int lstm, int bf16, int use_conv, int use_mlp, int Dx,
                     int Dh, int Dm, int K, int* out) {
  Params p;
  int rc = fill_dims(p, use_conv, use_mlp, 1, 1, Dx, Dh, Dm, K);
  if (rc) return rc;
  rc = dispatch(p, lstm, 1, bf16, nullptr, false);
  if (rc) return rc;
  const int head[9] = {p.n_ph, p.body, p.grid, p.blocks_per_sm, p.sms,
                       p.smem, p.ring, p.part_per_tile, p.counters};
  for (int i = 0; i < 9; ++i) out[i] = head[i];
  for (int x = 0; x < p.n_ph; ++x) {
    const Phase& ph = p.ph[x];
    const int row[8] = {ph.K, ph.N, ph.ng, ph.S, ph.Ks, ph.units,
                        ph.jobs_max, ph.job_bytes};
    for (int i = 0; i < 8; ++i) out[9 + 8 * x + i] = row[i];
  }
  return 0;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
