// Shan-Chen step K8 for NVIDIA Hopper (sm_90a): the C entry point of the
// f64 state, for checks against the plain path at f64.  The design note and the device code are in sc2d.cuh.

#include "sc2d.cuh"

// One step of the state f_in (params->k fluids) into f_out; psi is scratch
// of params->k planes in the compute type.  Returns a cudaError_t code (0 on
// success).
extern "C" int sc2d_step(const void* f_in, void* f_out, const void* geo, void* psi,
                         const ScParams* params, void* stream) {
  return sc2d_dispatch<double>(f_in, f_out, geo, psi, *params,
                              static_cast<cudaStream_t>(stream));
}

extern "C" const char* sc2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
