// Temporally blocked colour-gradient step K3 for NVIDIA Hopper (sm_90a):
// the C entry points of the f64 state (mode 0 = compressed, 3 = split (f_r, f_b),
// csf2d_step's codes), both variants (CsfParams::variant: 0 CSF, 1
// Perturbation).  The design note and the device code are in march2d.cuh
// (the row-march) on march3d.cuh's executor, the cell bodies in csf2d.cuh
// and pert2d.cuh.

#include "march2d.cuh"

// csf2d_march_step(mode, T, s_in, s2_in, s_out, s2_out, geo, scratch, plan,
// params, stream): T steps of the variant params->variant on the plan
// `plan` (kernels/march2d.py::csf2d_march_plan or pert2d_march_plan) with
// its rings in `scratch`; csf2d_march_grid(10 variant + mode, &grid): the
// cooperative grid; csf2d_march_limits(out): the most stages and rings a
// plan holds.
CSF2D_MARCH_ENTRY_POINTS(double, 0, 3)
