// Temporally blocked D3Q19 CSF step (K9-T) for NVIDIA Hopper (sm_90a),
// bf16 storage: the 21-plane state, decoded to f32 once a call and
// encoded once.  The C entry points; the design note and the device
// code are in cg3d_block.cuh.
//
// cg3d_march_step(split, T, s_in, s2_in, s_out, s2_out, geo, scratch,
// plan, params, stream): T steps of the compressed state (split = 0,
// s_in -> s_out) or of the split state (split = 1: f_r in s_in -> s_out,
// f_b in s2_in -> s2_out); geo the (4, nz, ny, nx) geometry planes, plan
// the device int64 table of kernels/march3d.py::cg3d_march_plan, scratch
// its rings.  Returns a cudaError_t code (0 on success).
// cg3d_march_grid(split, &grid) gives the cooperative grid.

#include "cg3d_block.cuh"

CG3D_BLOCK_ENTRY_POINTS(__nv_bfloat16)
