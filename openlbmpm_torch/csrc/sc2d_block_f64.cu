// The Shan-Chen T-step kernel K8-T for NVIDIA Hopper (sm_90a): the C
// entry points of the f64 state (built with -fmad=false, build.EXTRA_FLAGS, for
// checks against the plain path at f64).  The design note and
// the device code are in sc2d_march.cuh (the row-march) on march3d.cuh's
// executor, the cell arithmetic in sc2d.cuh.

#include "sc2d_march.cuh"

// sc2d_march_step(T, f_in, f_out, geo, scratch, plan, params, stream): T
// steps on the plan `plan` (kernels/march2d.py::sc2d_march_plan) with its
// rings in `scratch`; sc2d_march_grid(100 K + order, &grid): the
// cooperative grid; sc2d_march_limits(out): the most stages and rings a
// plan holds.
SC2D_MARCH_ENTRY_POINTS(double)
