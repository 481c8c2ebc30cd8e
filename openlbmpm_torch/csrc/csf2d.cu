// Compressed CSF colour-gradient step, D2Q9, for NVIDIA Hopper (sm_90a):
// the C entry points of the flow step.  The design note and the device code
// are in csf2d.cuh.

#include "csf2d.cuh"

// storage: 0 = f64 state, 1 = f32 state, 2 = bf16 11-plane state.
// Returns a cudaError_t code (0 on success).
extern "C" int csf2d_step(int storage, const void* s_in, void* s_out, const void* geo,
                          void* phi, void* nrm, const CsfParams* params,
                          void* stream) {
  const CsfParams P = *params;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0: return launch_flow<double>(s_in, s_out, geo, phi, nrm, P, st);
    case 1: return launch_flow<float>(s_in, s_out, geo, phi, nrm, P, st);
    case 2: return launch_flow<__nv_bfloat16>(s_in, s_out, geo, phi, nrm, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* csf2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
