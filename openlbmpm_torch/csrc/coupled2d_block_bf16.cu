// Temporally blocked coupled flow + tracer step K5c-T for NVIDIA Hopper
// (sm_90a): the C entry points of the 11-plane bf16 state (mode 2, compressed
// only), coupled2d_step's mode codes. The design note and the device code are
// in coupled2d_block.cuh.

#include "coupled2d_block.cuh"

// T coupled steps of the flow state s_in (and s2_in, f_b in the split
// layout) and the tracer PDFs g_in into s_out (s2_out) and g_out, with
// the per-tracer table tab (kernels/transport.py::tracer_table); scratch
// holds coupled2d_block_scratch_bytes bytes (null when that is 0).
// Returns a cudaError_t code (0 on success).
extern "C" int coupled2d_block_step(int mode, int T, const void* s_in, const void* s2_in,
                                    void* s_out, void* s2_out, const void* geo,
                                    const void* g_in, void* g_out, const void* tab,
                                    void* scratch, const CoupledParams* params,
                                    void* stream) {
  const CoupledParams Q = *params;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 2: return launch_coupled_block<__nv_bfloat16, kCompressed>(s_in, s2_in, geo, g_in, tab, s_out, s2_out, g_out, scratch, Q, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The global scratch a launch needs in bytes: 0 when the windows fit shared
// memory, -1 for a mode this library does not take.
extern "C" long long coupled2d_block_scratch_bytes(int mode, int T,
                                                   const CoupledParams* params) {
  switch (mode) {
    case 2: return (long long)coupled_block_scratch<__nv_bfloat16, kCompressed>(*params, T);
    default: return -1;
  }
}

// The launch's tiling into shape[8]: tx, ty, hx, hlo, hhi, gmem, grid and
// the bytes of one window.
extern "C" int coupled2d_block_shape(int mode, int T, const CoupledParams* params,
                                     long long* shape) {
  BlockShape B;
  switch (mode) {
    case 2: B = coupled_block_shape<__nv_bfloat16, kCompressed>(*params, T); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const long long v[8] = {B.tx, B.ty, B.hx, B.hlo, B.hhi, B.gmem, B.grid,
                          (long long)B.win_bytes};
  for (int i = 0; i < 8; ++i) shape[i] = v[i];
  return 0;
}

extern "C" const char* coupled2d_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
