// Coupled CSF flow + tracer step (K5c / K5s) for NVIDIA Hopper (sm_90a),
// f64 storage, for checks against the plain path at f64: coupled2d.cu's
// entry points with its f64 instances (modes 0 and 3), in a library built
// with -fmad=false.  The design note and the kernels are in coupled2d.cu.

#define COUPLED2D_F64
#include "coupled2d.cu"
