// Temporally blocked D3Q19 single-phase (K11-T) and Shan-Chen (K10-T) steps for
// NVIDIA Hopper (sm_90a), f32 storage: the C entry points. The design note and
// the device code are in flow3d_block.cuh.
//
// single3d_march_step(T, f_in, f_out, fluid, scratch, plan, params,
// stream): T steps of K11-T's single-phase state (params->collision SRT or
// TRT) on the plan (device int64 table of kernels/march3d.py) with its
// rings in scratch; single3d_march_grid(collision, &grid) gives the
// cooperative grid.
// sc3d_march_step(T, f_in, f_out, fluid, scratch, plan, params, stream): T
// steps of K10-T's Shan-Chen state (params->k <= 3 fluids) on the plan
// (device int64 table of kernels/march3d.py) with its rings in scratch;
// sc3d_march_grid(k, &grid) gives the cooperative grid.  fluid is the
// one-byte mask (1 on fluid).  Each returns a cudaError_t code (0 on
// success).

#include "flow3d_block.cuh"

FLOW3D_BLOCK_ENTRY_POINTS(float)
