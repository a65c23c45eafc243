// Fused minLSTM (G = 3: W_f, W_i, W_h) layer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_minlstm_kernel
// (src/repro/kernels/fused_minlstm/kernel.py).  The kernel body, its bound
// and its design are in ../../csrc/fused_cell.cuh, which this file
// instantiates with G = 3 gates.

#include "../../csrc/fused_cell.cuh"

extern "C" {

// ptrs: x, w_0 .. w_2, b_0 .. b_2, h0 (fp32), out (9 pointers).
// bf16 != 0: x, weights, biases and out are bfloat16, else float32.
// *body gets the body the launch took (1 tensor cores, 0 CUDA cores).
// Returns 0 or the cudaError_t of the launch.
int repro_fused_minlstm_launch(int bf16, int log_mode, int normalize, int B,
                              int T, int Dx, int Dh, void* const* ptrs,
                              void* stream, int* body) {
  const fused_cell::Params p =
      fused_cell::make_params(B, T, Dx, Dh, ptrs, 3);
  return fused_cell::launch<3>(bf16, log_mode, normalize, p,
                               static_cast<cudaStream_t>(stream), body);
}

// What repro_fused_minlstm_launch would run on these operands, without
// launching: out[0] the body (1 tensor cores, 0 CUDA cores), out[1]
// resident blocks per SM, out[2] grid blocks, out[3] the device's SMs.
int repro_fused_minlstm_occupancy(int bf16, int log_mode, int normalize,
                                  int B, int T, int Dx, int Dh,
                                  void* const* ptrs, int* out) {
  const fused_cell::Params p =
      fused_cell::make_params(B, T, Dx, Dh, ptrs, 3);
  return fused_cell::occupancy<3>(bf16, log_mode, normalize, p, out);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
