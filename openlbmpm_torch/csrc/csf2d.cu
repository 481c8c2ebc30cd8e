// CSF colour-gradient step, D2Q9, for NVIDIA Hopper (sm_90a): the C entry
// points of the flow step.  The design note and the device code are in
// csf2d.cuh.  The f64 instances are the library csf2d_f64 (csf2d_f64.cu,
// which defines CSF2D_F64 and is built with -fmad=false), the others this
// file's.

#include "csf2d.cuh"

// mode: compressed 0 = f64 state, 1 = f32 state, 2 = bf16 11-plane state;
// split 3 = f64 (f_r, f_b), 4 = f32 (f_r, f_b); modes 0 and 3 with
// CSF2D_F64 defined, the others without it.  s2_in and s2_out are f_b in
// the split modes and unused otherwise.  Returns a cudaError_t code (0 on
// success; cudaErrorInvalidValue for a Perturbation parameter block or a
// mode this library does not hold).
extern "C" int csf2d_step(int mode, const void* s_in, const void* s2_in, void* s_out,
                          void* s2_out, const void* geo, const CsfParams* params,
                          void* stream) {
  const CsfParams P = *params;
  if (P.variant != 0) return (int)cudaErrorInvalidValue;  // a Perturbation block
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
#ifdef CSF2D_F64
    case 0:
      return launch_flow<double, kCompressed>(s_in, s2_in, s_out, s2_out, geo, P, st);
    case 3: return launch_flow<double, kSplit>(s_in, s2_in, s_out, s2_out, geo, P, st);
#else
    case 1:
      return launch_flow<float, kCompressed>(s_in, s2_in, s_out, s2_out, geo, P, st);
    case 2:
      return launch_flow<__nv_bfloat16, kCompressed>(s_in, s2_in, s_out, s2_out, geo, P,
                                                     st);
    case 4: return launch_flow<float, kSplit>(s_in, s2_in, s_out, s2_out, geo, P, st);
#endif
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launches of each kernel since the library was loaded (csf2d.cuh's
// g_csf_launches: tracer_strip_kernel, strip_kernel, pert_strip_kernel;
// strip_kernel's alone here).
extern "C" void csf2d_kernel_launches(long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = g_csf_launches[i];
}

extern "C" const char* csf2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
