// The local form of the D3Q19 CSF step and its coupled D3Q7 tracer step
// (K12d), f32 storage: the C entry points.  The design note and the device
// code are in cg3d_local.cuh (on cg3d.cuh).

#include "cg3d_local.cuh"

// The boundary slabs of the centre of the shard G's padded compressed
// buffer s, in place; geo its padded geometry planes; P the step's
// parameters with the buffer's extents.  Returns a cudaError_t code.
extern "C" int cg3d_local_slabs(void* s, const void* geo, const Cg3dParams* params,
                                const Local3* grid, void* stream) {
  return launch_local_bc<float>(s, geo, *params, *grid, static_cast<cudaStream_t>(stream));
}

// One step of the shard G: the padded compressed buffer s_in (slabs
// applied, frame filled) into the centre of s_out; fld scratch of four
// padded planes (g and kappa).  With tracers (g_in not null): g_in into the
// centre of g_out, (NT, 7) padded planes each, tab the (NT, 8) tracer
// table.  Returns a cudaError_t code.
extern "C" int cg3d_local_step(const void* s_in, void* s_out, const void* geo, void* fld,
                               const void* g_in, void* g_out, const void* tab,
                               const Cg3dParams* params, const Tracer3dParams* tparams,
                               const Local3* grid, void* stream) {
  return launch_cg3d_local<float>(s_in, s_out, geo, fld, g_in, g_out, tab, *params, *tparams,
                                 *grid, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cg3d_local_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
