// Temporally blocked single-phase D2Q9 step K7-T for NVIDIA Hopper
// (sm_90a): the C entry points of the bf16 state.  The design note and
// the device code are in single2d_block.cuh.

#include "single2d_block.cuh"

// T steps of the state f_in into f_out; fluid is the one-byte mask (1 on
// fluid); scratch holds single2d_block_scratch_bytes bytes (null when that
// is 0).  Returns a cudaError_t code (0 on success).
extern "C" int single2d_block_step(int T, const void* f_in, void* f_out, const void* fluid,
                                   void* scratch, const Single2dParams* params,
                                   void* stream) {
  return single2d_block_dispatch<__nv_bfloat16>(f_in, f_out, fluid, scratch, *params, T,
                                      static_cast<cudaStream_t>(stream));
}

// The global scratch a launch needs in bytes: 0 when the windows fit shared
// memory.
extern "C" long long single2d_block_scratch_bytes(int T, const Single2dParams* params) {
  const BlockShape B = single_block_shape<__nv_bfloat16>(*params, T);
  return B.gmem ? (long long)B.grid * (long long)B.win_bytes : 0;
}

// The launch's tiling into shape[8]: tx, ty, hx, hlo, hhi, gmem, grid and
// the bytes of one window.
extern "C" int single2d_block_shape(int T, const Single2dParams* params, long long* shape) {
  const BlockShape B = single_block_shape<__nv_bfloat16>(*params, T);
  const long long v[8] = {B.tx, B.ty, B.hx, B.hlo, B.hhi, B.gmem, B.grid,
                          (long long)B.win_bytes};
  for (int i = 0; i < 8; ++i) shape[i] = v[i];
  return 0;
}

// The largest T a launch takes for this configuration (the window's limit).
extern "C" int single2d_block_max_steps(const Single2dParams* params) {
  const Single2dParams P = *params;
  return window_max_steps([&](int T) { return single_block_shape<__nv_bfloat16>(P, T); });
}

extern "C" const char* single2d_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
