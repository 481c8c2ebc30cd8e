// The local form of the single-phase T-step kernel K7-T (K12b: one shard of
// a y-decomposed domain) for NVIDIA Hopper (sm_90a), f64 state.  Built with
// -fmad=false (kernels/build.py::EXTRA_FLAGS), as single2d_block_f64, so
// that it rounds as the single-device K7-T and the plain path do. The design
// note is in block2d.cuh and single2d_block.cuh. Replaces the local kernel
// of openlbmpm_tpu/pallas/single.py::build_single_sharded_step (:459:
// build_single_phase_fused_step with local_ny, call :418).  What bounds it:
// the bytes of K7-T on the shard (single2d_block.cuh) plus its frame's; at
// config 1 the host's launches and frame copies set the pace (PERF.md).
//
// single2d_local_block_step(T, ny, nx, py, px, fy, fx, row0, f_in, f_out,
// fluid, scratch, params, stream): T steps of the shard whose padded
// (9, py, px) buffer f_in holds its ny x nx centre at (fy, fx) and the
// frame the exchange filled, into the centre of f_out; fluid the shard's
// padded one-byte mask, row0 the global row of centre row 0; scratch holds
// single2d_local_block_scratch_bytes bytes (null when that is 0).  Returns
// a cudaError_t code (0 on success).

#include "single2d_block.cuh"

extern "C" int single2d_local_block_step(LOCAL_INTS, const void* f_in, void* f_out,
                                         const void* fluid, void* scratch,
                                         const Single2dParams* params, void* stream) {
  return single2d_block_dispatch<double, true>(f_in, f_out, fluid, scratch, *params, T,
                                              static_cast<cudaStream_t>(stream), LOCAL_GRID);
}

LOCAL_INFO_ENTRY_POINTS(single2d_local, Single2dParams, single_local_shape<double>)
