// The local form of the D3Q19 Shan-Chen step (K12e), f32 storage: the C
// entry points.  The design note and the device code are in flow3d_local.cuh
// (on flow3d.cuh and sc3d_rt.cuh).

#include "flow3d_local.cuh"

// T steps of one shard: its padded state f_in ((params->k, 19, nz, ny, nx),
// params->nz the buffer's slabs, a frame of 2T each side, filled) into the
// centre of f_out; f_tmp a buffer of the same shape; fluid the padded
// one-byte mask; scratch flow3d_local_scratch_bytes bytes; table the
// float64 per-fluid table (kernels/flow3d.py::sc3d_table, read above three
// fluids).  Returns a cudaError_t code (0 on success).
extern "C" int flow3d_local_sc_step(int T, const void* f_in, void* f_out, void* f_tmp,
                                    const void* fluid, void* scratch, const void* table,
                                    const Flow3dParams* params, void* stream) {
  return launch_sc3d_local<float>(T, f_in, f_out, f_tmp, fluid, scratch,
                                 static_cast<const double*>(table), *params,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" long long flow3d_local_scratch_bytes(const Flow3dParams* params) {
  return (long long)sc3d_local_scratch<float>(*params);
}

extern "C" const char* flow3d_local_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
