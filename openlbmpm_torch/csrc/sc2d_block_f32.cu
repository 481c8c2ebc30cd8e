// Temporally blocked Shan-Chen step K8-T for NVIDIA Hopper (sm_90a): the C
// entry points of the f32 state.  The design note and the device code
// are in sc2d_block.cuh.

#include "sc2d_block.cuh"

// T steps of the state f_in into f_out; scratch holds
// sc2d_block_scratch_bytes bytes (null when that is 0).  Returns a
// cudaError_t code (0 on success).
extern "C" int sc2d_block_step(int T, const void* f_in, void* f_out, const void* geo,
                               void* scratch, const ScParams* params, void* stream) {
  return sc2d_block_dispatch<float>(f_in, f_out, geo, scratch, *params, T,
                                  static_cast<cudaStream_t>(stream));
}

// The global scratch a launch needs in bytes: 0 when the windows fit shared
// memory.
extern "C" long long sc2d_block_scratch_bytes(int T, const ScParams* params) {
  const BlockShape B = sc_block_shape_of<float>(*params, T);
  return B.gmem ? (long long)B.grid * (long long)B.win_bytes : 0;
}

// The launch's tiling into shape[8]: tx, ty, hx, hlo, hhi, gmem, grid and
// the bytes of one window.
extern "C" int sc2d_block_shape(int T, const ScParams* params, long long* shape) {
  const BlockShape B = sc_block_shape_of<float>(*params, T);
  const long long v[8] = {B.tx, B.ty, B.hx, B.hlo, B.hhi, B.gmem, B.grid,
                          (long long)B.win_bytes};
  for (int i = 0; i < 8; ++i) shape[i] = v[i];
  return 0;
}

// The largest T a launch takes for this configuration (the window's limit).
extern "C" int sc2d_block_max_steps(const ScParams* params) {
  const ScParams P = *params;
  return window_max_steps([&](int T) { return sc_block_shape_of<float>(P, T); });
}

extern "C" const char* sc2d_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
