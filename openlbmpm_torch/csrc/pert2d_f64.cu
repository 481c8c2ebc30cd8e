// Rothman-Keller Perturbation step K4 for NVIDIA Hopper (sm_90a), f64
// storage, for checks against the plain path at f64: pert2d.cu's entry
// points with its f64 instances (modes 0 and 3), in a library built with
// -fmad=false.  The design note and the kernel are in pert2d.cu.

#define PERT2D_F64
#include "pert2d.cu"
