// D3Q19 single-phase step (K11) and Shan-Chen step (K10) for NVIDIA Hopper
// (sm_90a), f64 storage, for checks against the plain path at f64: the C entry points.  The design note and
// the device code are in flow3d.cuh.

#include "flow3d.cuh"

// K11: one single-phase step of the state f_in (19 planes) into
// f_out; fluid is the one-byte mask (1 on fluid).  Returns a cudaError_t
// code (0 on success).
extern "C" int flow3d_single_step(const void* f_in, void* f_out, const void* fluid,
                                  const Flow3dParams* params, void* stream) {
  return single3d_dispatch<double>(f_in, f_out, fluid, *params,
                                   static_cast<cudaStream_t>(stream));
}

// K10: one Shan-Chen step of the state f_in (params->k fluids) into f_out;
// rho is scratch of params->k planes in the compute type for bf16 storage
// (unused, may be null, in f32 and f64).  Returns a cudaError_t code (0 on
// success).
extern "C" int flow3d_sc_step(const void* f_in, void* f_out, const void* fluid, void* rho,
                              const Flow3dParams* params, void* stream) {
  return sc3d_dispatch<double>(f_in, f_out, fluid, rho, *params,
                               static_cast<cudaStream_t>(stream));
}

// Launches of march_kernel (K11 and K10 in bf16), sc_push_kernel and
// rho_kernel (K10) and single_push_kernel (K11 in f32 and f64) by this
// library since it was loaded, into out[0..3].
extern "C" void flow3d_kernel_launches(long long* out) {
  for (int i = 0; i < 4; ++i) out[i] = g_launches[i];
}

extern "C" const char* flow3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
