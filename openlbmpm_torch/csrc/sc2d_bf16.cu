// Shan-Chen step K8 for NVIDIA Hopper (sm_90a): the C entry point of the
// bf16 11-plane state, f32 arithmetic.  The design note and the device
// code are in sc2d.cuh.

#include "sc2d.cuh"

// One step of the state f_in (params->k fluids) into f_out (one launch of
// the pull).  Returns a cudaError_t code (0 on success).
extern "C" int sc2d_step(const void* f_in, void* f_out, const void* geo,
                         const ScParams* params, void* stream) {
  return sc2d_dispatch<__nv_bfloat16>(f_in, f_out, geo, *params,
                                    static_cast<cudaStream_t>(stream));
}

// Launches of collide_stream_kernel (bf16), sc_push_kernel and
// sc_outlet_kernel (f32, f64) by this library since it was loaded, into
// out[0..2].
extern "C" void sc2d_kernel_launches(long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = g_launches[i];
}

extern "C" const char* sc2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
