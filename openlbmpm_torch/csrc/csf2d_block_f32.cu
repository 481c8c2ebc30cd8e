// Temporally blocked colour-gradient step K3 for NVIDIA Hopper (sm_90a):
// the C entry points of the f32 state (mode 1 = compressed, 4 = split (f_r, f_b),
// csf2d_step's codes).  The design note and the device code are in
// csf2d_block.cuh (the Perturbation variant's windows) and march2d.cuh
// (the CSF variant's row-march).

#include "csf2d_block.cuh"
#include "march2d.cuh"

// T steps of the state s_in (and s2_in, f_b in the split layout) into
// s_out (s2_out) with the Perturbation physics (params->variant 1; the CSF
// variant runs csf2d_march_step); scratch holds csf2d_block_scratch_bytes bytes (null when that
// is 0).  Returns a cudaError_t code (0 on success).
extern "C" int csf2d_block_step(int mode, int T, const void* s_in, const void* s2_in,
                                void* s_out, void* s2_out, const void* geo, void* scratch,
                                const CsfParams* params, void* stream) {
  const CsfParams P = *params;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 1: return launch_csf_block_variant<float, kCompressed>(s_in, s2_in, s_out, s2_out, geo, scratch, P, T, st);
    case 4: return launch_csf_block_variant<float, kSplit>(s_in, s2_in, s_out, s2_out, geo, scratch, P, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The global scratch a launch needs in bytes: 0 when the windows fit shared
// memory, -1 for a mode this library does not take.
extern "C" long long csf2d_block_scratch_bytes(int mode, int T, const CsfParams* params) {
  switch (mode) {
    case 1: return (long long)csf_block_scratch<float, kCompressed>(*params, T);
    case 4: return (long long)csf_block_scratch<float, kSplit>(*params, T);
    default: return -1;
  }
}

// The launch's tiling into shape[8]: tx, ty, hx, hlo, hhi, gmem, grid and
// the bytes of one window.
extern "C" int csf2d_block_shape(int mode, int T, const CsfParams* params,
                                 long long* shape) {
  BlockShape B;
  switch (mode) {
    case 1: B = csf_shape_of<float, kCompressed>(*params, T); break;
    case 4: B = csf_shape_of<float, kSplit>(*params, T); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const long long v[8] = {B.tx, B.ty, B.hx, B.hlo, B.hhi, B.gmem, B.grid,
                          (long long)B.win_bytes};
  for (int i = 0; i < 8; ++i) shape[i] = v[i];
  return 0;
}

// The largest T a window launch of the Perturbation variant takes for this
// configuration (0 for the CSF variant, whose limit is its march plan's,
// kernels/march2d.py::max_steps).
extern "C" int csf2d_block_max_steps(int mode, const CsfParams* params) {
  const CsfParams P = *params;
  if (P.variant != 1) return 0;
  switch (mode) {
    case 1: return window_max_steps([&](int T) { return csf_shape_of<float, kCompressed>(P, T); });
    case 4: return window_max_steps([&](int T) { return csf_shape_of<float, kSplit>(P, T); });
    default: return 0;
  }
}

// csf2d_march_step(mode, T, s_in, s2_in, s_out, s2_out, geo, scratch, plan,
// params, stream): T CSF steps on the plan `plan`
// (kernels/march2d.py::csf2d_march_plan) with its rings in `scratch`;
// csf2d_march_grid(mode, &grid): the cooperative grid;
// csf2d_march_limits(out): the most stages and rings a plan holds.
CSF2D_MARCH_ENTRY_POINTS(float, 1, 4)

extern "C" const char* csf2d_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
