// The local form of the Shan-Chen T-step kernel (K12c: one shard of a
// y-decomposed domain) for NVIDIA Hopper (sm_90a), f64 state: the C entry
// points.  Built with -fmad=false (kernels/build.py::EXTRA_FLAGS), as
// sc2d_block_f64 and sc2d_rt, so that it rounds as the single-device K8-T
// and the plain path do.  The design note and the device code are in
// sc2d_local.cuh (on sc2d_block.cuh and sc2d_rt.cuh).
//
// sc2d_local_block_step(T, ny, nx, py, px, fy, fx, row0, f_in, f_out, geo,
// scratch, params, stream), K = 1 ... 3: T steps of the shard whose padded
// (K, 9, py, px) buffer f_in holds its ny x nx centre at (fy, fx) and the
// frame the exchange filled, into the centre of f_out; geo the shard's
// padded geometry planes (kernels/shanchen.py::geo_stack), row0 the global
// row of centre row 0; scratch holds sc2d_local_block_scratch_bytes bytes
// (null when that is 0).
//
// sc2d_local_rt_step(T, ny, nx, py, px, fy, fx, row0, f_in, f_out, f_tmp,
// geo, scratch, table, params, stream), any K (the runtime-K passes):
// the same, f_tmp a second buffer of f_in's shape (null at T = 1), scratch
// sc2d_local_rt_scratch_bytes bytes, table the float64 per-fluid table
// (kernels/shanchen.py::fluid_table).
//
// Both return a cudaError_t code (0 on success).

#include "sc2d_local.cuh"

extern "C" int sc2d_local_block_step(LOCAL_INTS, const void* f_in, void* f_out, const void* geo,
                                     void* scratch, const ScParams* params, void* stream) {
  return sc2d_local_dispatch<double>(f_in, f_out, geo, scratch, *params, T,
                                 static_cast<cudaStream_t>(stream), LOCAL_GRID);
}

LOCAL_INFO_ENTRY_POINTS(sc2d_local, ScParams, sc_local_shape_of<double>)

extern "C" int sc2d_local_rt_step(LOCAL_INTS, const void* f_in, void* f_out, void* f_tmp,
                                  const void* geo, void* scratch, const void* table,
                                  const ScParams* params, void* stream) {
  return launch_sc2d_local_rt<double>(T, f_in, f_out, f_tmp, geo, scratch,
                                  static_cast<const double*>(table), *params, LOCAL_GRID,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" long long sc2d_local_rt_scratch_bytes(LOCAL_INTS, const ScParams* params) {
  return (long long)sc2d_local_rt_scratch<double>(*params, LOCAL_GRID);
}
