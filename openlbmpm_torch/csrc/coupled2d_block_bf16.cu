// Temporally blocked coupled flow + tracer step K5c-T for NVIDIA Hopper
// (sm_90a): the C entry points of the 11-plane bf16 state (mode 2, compressed only),
// coupled2d_step's mode codes.  The design note and the device code are in
// march2d.cuh (the row-march); the window kernel of coupled2d_block.cuh
// serves the local form (coupled2d_local_*.cu).

#include "coupled2d_block.cuh"
#include "march2d.cuh"

// coupled2d_march_step(mode, T, s_in, s2_in, s_out, s2_out, geo, g_in,
// g_out, tab, scratch, plan, params, stream): T coupled steps of the flow
// state s_in (and s2_in, f_b in the split layout) and the tracer PDFs g_in
// into s_out (s2_out) and g_out, with the per-tracer table tab
// (kernels/transport.py::tracer_table), on the plan `plan`
// (kernels/march2d.py::coupled2d_march_plan) with its rings in `scratch`;
// coupled2d_march_grid(10 mode + nq, &grid): the cooperative grid.  Both
// return a cudaError_t code (0 on success).
COUPLED2D_MARCH_ENTRY_POINTS(__nv_bfloat16, 2, -1)
