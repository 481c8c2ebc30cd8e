// CSF colour-gradient step (K1 / K6) for NVIDIA Hopper (sm_90a), f64
// storage, for checks against the plain path at f64: csf2d.cu's entry
// points with its f64 instances (modes 0 and 3), in a library built with
// -fmad=false, so that no a * b + c is contracted into an FMA.  The design
// note and the kernel are in csf2d.cuh.

#define CSF2D_F64
#include "csf2d.cu"
