// D3Q19 CSF colour-gradient step (K9) and its coupled D3Q7 tracer step
// (K9t), bf16 storage: the C entry points.
// The design note and the device code are in cg3d.cuh.

#include "cg3d.cuh"

// split = 0: the compressed state s (in s_in, out s_out); split = 1: f_r in
// s_in / s_out and f_b in s2_in / s2_out.  fld is scratch of four planes in
// the compute type (g and kappa); bc the boundary-slab scratch or null.
// Returns a cudaError_t code (0 on success).
extern "C" int cg3d_step(int split, const void* s_in, const void* s2_in, void* s_out,
                         void* s2_out, const void* geo, void* fld, void* bc,
                         const Cg3dParams* params, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split)
    return (int)cudaErrorInvalidValue;   // no split bf16 layout
  return launch_cg3d<__nv_bfloat16, kCompressed>(s_in, s2_in, s_out, s2_out, geo, fld, bc,
                                                 *params, st);
}

// The fields of one step alone (the boundary slabs, then fields_kernel): g
// and kappa of the state (as cg3d_step takes it) into the four planes fld.
// Returns a cudaError_t code.
extern "C" int cg3d_fields(int split, const void* s_in, const void* s2_in, const void* geo,
                           void* fld, void* bc, const Cg3dParams* params, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split)
    return (int)cudaErrorInvalidValue;
  return launch_cg3d_fields<__nv_bfloat16, kCompressed>(s_in, s2_in, geo, fld, bc, *params, st);
}

// The coupled step (K9t), compressed state: s_in / s_out as above, g_in and
// g_out (NT, 7, nz, ny, nx) tracer PDFs in the compute type, tab the
// (NT, 8) tracer table.  Returns a cudaError_t code.
extern "C" int cg3d_coupled_step(const void* s_in, void* s_out, const void* geo, void* fld,
                                 void* bc, const void* g_in, void* g_out, const void* tab,
                                 const Cg3dParams* params, const Tracer3dParams* tparams,
                                 void* stream) {
  return launch_cg3d_coupled<__nv_bfloat16>(s_in, s_out, geo, fld, bc, g_in, g_out, tab, *params,
                                  *tparams, static_cast<cudaStream_t>(stream));
}

// Launches of bc_kernel, fields_kernel and collide_stream by this library
// since it was loaded, into out[0..2].
extern "C" void cg3d_kernel_launches(long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = g_launches[i];
}

extern "C" const char* cg3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
