// Temporally blocked D3Q19 single-phase (K11-T) and Shan-Chen (K10-T) steps for
// NVIDIA Hopper (sm_90a), f32 storage: the C entry points. The design note and
// the device code are in flow3d_block.cuh.

#include "flow3d_block.cuh"

// T steps of the state f_in into f_out: kind 0 the single-phase state (19
// planes, params->collision SRT or TRT), kind 1 the Shan-Chen state
// (params->k fluids); fluid is the one-byte mask (1 on fluid), scratch holds
// flow3d_block_scratch_bytes bytes (null when that is 0).  Returns a
// cudaError_t code (0 on success).
extern "C" int flow3d_block_step(int kind, int T, const void* f_in, void* f_out,
                                 const void* fluid, void* scratch,
                                 const Flow3dParams* params, void* stream) {
  return launch_flow3d_block<float>(kind, f_in, f_out, fluid, scratch, *params, T,
                                  static_cast<cudaStream_t>(stream));
}

// The global scratch a launch needs in bytes: 0 when the windows fit shared
// memory, -1 for a kind this library does not take.
extern "C" long long flow3d_block_scratch_bytes(int kind, int T, const Flow3dParams* params) {
  if (kind != 0 && kind != 1) return -1;
  return (long long)flow3d_block_scratch<float>(kind, *params, T);
}

// The launch's tiling into shape[8]: tx, ty, tz, the halo on every side,
// gmem, grid, the bytes of one window and the largest T.
extern "C" int flow3d_block_shape(int kind, int T, const Flow3dParams* params,
                                  long long* shape) {
  if (kind != 0 && kind != 1) return (int)cudaErrorInvalidValue;
  const BlockShape3 B = flow3d_block_shape<float>(kind, *params, T);
  const long long v[8] = {B.tx, B.ty, B.tz, B.h, B.gmem, B.grid, (long long)B.win_bytes,
                          kMaxSteps3};
  for (int i = 0; i < 8; ++i) shape[i] = v[i];
  return 0;
}

extern "C" const char* flow3d_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
