// D3Q19 CSF colour-gradient step (K9), f64 storage: the C entry points.
// The design note and the device code are in cg3d.cuh.

#include "cg3d.cuh"

// split = 0: the compressed state s (in s_in, out s_out); split = 1: f_r in
// s_in / s_out and f_b in s2_in / s2_out.  phi and nrm are scratch of one
// and seven planes in the compute type; bc the boundary-slab scratch or null.
// Returns a cudaError_t code (0 on success).
extern "C" int cg3d_step(int split, const void* s_in, const void* s2_in, void* s_out,
                         void* s2_out, const void* geo, void* phi, void* nrm, void* bc,
                         const Cg3dParams* params, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split)
    return launch_cg3d<double, kSplit>(s_in, s2_in, s_out, s2_out, geo, phi, nrm, bc, *params, st);
  return launch_cg3d<double, kCompressed>(s_in, s2_in, s_out, s2_out, geo, phi, nrm, bc,
                                         *params, st);
}

extern "C" const char* cg3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
