// Shan-Chen step K8 and its T-step form K8-T for any number of fluids,
// looped over at run time, for NVIDIA Hopper (sm_90a): the C entry points of
// the f64, f32 and bf16 storage types (built with -fmad=false).  The design
// note and the device code are in sc2d_rt.cuh.

#include "sc2d_rt.cuh"

// T steps of the state f_in (params->k fluids, storage 0 f64, 1 f32, 2
// bf16) into f_out; geo the geometry planes; scratch holds
// sc2d_rt_scratch_bytes bytes; table the device table of per-fluid values
// (kernels/shanchen.py::fluid_table, float64).  Returns a cudaError_t code
// (0 on success).
extern "C" int sc2d_rt_step(int storage, int T, const void* f_in, void* f_out, const void* geo,
                            void* scratch, const void* table, const ScParams* params,
                            void* stream) {
  const double* tab = static_cast<const double*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0: return launch_sc2d_rt<double>(T, f_in, f_out, geo, scratch, tab, *params, st);
    case 1: return launch_sc2d_rt<float>(T, f_in, f_out, geo, scratch, tab, *params, st);
    case 2: return launch_sc2d_rt<__nv_bfloat16>(T, f_in, f_out, geo, scratch, tab, *params, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The scratch a call needs in bytes (-1 for an unknown storage type).
extern "C" long long sc2d_rt_scratch_bytes(int storage, const ScParams* params) {
  switch (storage) {
    case 0: return (long long)sc2d_rt_scratch<double>(*params);
    case 1: return (long long)sc2d_rt_scratch<float>(*params);
    case 2: return (long long)sc2d_rt_scratch<__nv_bfloat16>(*params);
    default: return -1;
  }
}

extern "C" const char* sc2d_rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
