// Single-phase D2Q9 step K7 for NVIDIA Hopper (sm_90a): the C entry point of
// the f32 state.  The design note and the device code are in
// single2d.cuh.

#include "single2d.cuh"

// One step of the state f_in into f_out; fluid is the one-byte mask (1 on
// fluid).  Returns a cudaError_t code (0 on success).
extern "C" int single2d_step(const void* f_in, void* f_out, const void* fluid,
                             const Single2dParams* params, void* stream) {
  return single2d_dispatch<float>(f_in, f_out, fluid, *params,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* single2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
