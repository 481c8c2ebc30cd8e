// D3Q19 Shan-Chen step K10 and its T-step form K10-T for any number of
// fluids, looped over at run time, for NVIDIA Hopper (sm_90a): the C entry
// points of the f64, f32 and bf16 storage types (built with -fmad=false).
// The design note and the device code are in sc3d_rt.cuh.

#include "sc3d_rt.cuh"

// T steps of the state f_in (params->k fluids; storage 0 f64, 1 f32, 2
// bf16) into f_out; fluid the one-byte mask; scratch holds
// sc3d_rt_scratch_bytes bytes; table the device table of per-fluid values
// (kernels/flow3d.py::sc3d_table, float64).  Returns a cudaError_t code
// (0 on success).
extern "C" int sc3d_rt_step(int storage, int T, const void* f_in, void* f_out,
                            const void* fluid, void* scratch, const void* table,
                            const Flow3dParams* params, void* stream) {
  const double* tab = static_cast<const double*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0: return launch_sc3d_rt<double>(T, f_in, f_out, fluid, scratch, tab, *params, st);
    case 1: return launch_sc3d_rt<float>(T, f_in, f_out, fluid, scratch, tab, *params, st);
    case 2:
      return launch_sc3d_rt<__nv_bfloat16>(T, f_in, f_out, fluid, scratch, tab, *params, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The scratch a call needs in bytes (-1 for an unknown storage type).
extern "C" long long sc3d_rt_scratch_bytes(int storage, const Flow3dParams* params) {
  switch (storage) {
    case 0: return (long long)sc3d_rt_scratch<double>(*params);
    case 1: return (long long)sc3d_rt_scratch<float>(*params);
    case 2: return (long long)sc3d_rt_scratch<__nv_bfloat16>(*params);
    default: return -1;
  }
}

extern "C" const char* sc3d_rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
