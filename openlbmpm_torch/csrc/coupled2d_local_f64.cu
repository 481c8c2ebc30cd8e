// The local form of the coupled flow + tracer T-step kernel K5c-T (K12a with
// transport: one shard of a y or (y, x) decomposed domain) for NVIDIA Hopper
// (sm_90a), f64 compressed flow state, D2Q5 and D2Q9 tracers.  Built with
// -fmad=false (kernels/build.py::EXTRA_FLAGS), as coupled2d_block_f64, so
// that it rounds as the single-device K5c-T and the plain path do. The
// design note is in block2d.cuh and coupled2d_block.cuh. Replaces the local
// kernel of openlbmpm_tpu/pallas/csf.py::build_csf_sharded_step with
// transport_params (:1954, call :1896).  What bounds it: the bytes of K5c-T
// on the shard (coupled2d_block.cuh) plus its frame's, read once a call; the
// frame is the flow's and the tracer's band reaches added, not the TPU
// kernel's H.
//
// coupled2d_local_block_step(T, ny, nx, py, px, fy, fx, row0, s_in, s_out,
// geo, g_in, g_out, tab, scratch, params, stream): T coupled steps of the
// shard whose padded buffers s_in (10, py, px) and g_in (NT, NQ, py, px)
// hold its ny x nx centre at (fy, fx) and the frame the exchange filled,
// into the centres of s_out and g_out; geo the shard's padded (5, py, px)
// geometry planes, tab the per-tracer table, row0 the global row of centre
// row 0; scratch holds coupled2d_local_block_scratch_bytes bytes (null
// when that is 0).  Returns a cudaError_t code (0 on success).

#include "coupled2d_block.cuh"

extern "C" int coupled2d_local_block_step(LOCAL_INTS, const void* s_in, void* s_out,
                                          const void* geo, const void* g_in, void* g_out,
                                          const void* tab, void* scratch,
                                          const CoupledParams* params, void* stream) {
  return launch_coupled_local<double>(s_in, s_out, geo, g_in, g_out, tab, scratch, *params,
                                     LOCAL_GRID, T, static_cast<cudaStream_t>(stream));
}

LOCAL_INFO_ENTRY_POINTS(coupled2d_local, CoupledParams, coupled_local_shape<double>)
