// The local form of the colour-gradient T-step kernel K3 (K12a: one shard of
// a y or (y, x) decomposed domain) for NVIDIA Hopper (sm_90a), f32
// compressed state, both variants (CsfParams::variant).  The design note is
// in block2d.cuh and csf2d_block.cuh. Replaces the local kernel of
// openlbmpm_tpu/pallas/csf.py::build_csf_sharded_step (:1954:
// build_csf_fused_step with local_ny / local_nx, call :1896, row0 a
// prefetched scalar).  What bounds it: the bytes of K3 on the shard
// (csf2d_block.cuh) plus its frame's, read once a call (phase 66's
// bound_ms); its design reads the padded buffer the exchange filled, so no
// step copies the state whole.
//
// csf2d_local_block_step(T, ny, nx, py, px, fy, fx, row0, s_in, s_out, geo,
// scratch, params, stream): T steps of the shard whose padded (10, py, px)
// buffer s_in holds its ny x nx centre at (fy, fx) and the frame the
// exchange filled, into the centre of s_out (the frame of s_out is left
// as it is); geo the shard's padded (5, py, px) geometry planes, row0 the
// global row of centre row 0; scratch holds
// csf2d_local_block_scratch_bytes bytes (null when that is 0).  Returns a
// cudaError_t code (0 on success; invalid value for a frame that does not
// cover the launch's reach).

#include "csf2d_block.cuh"

extern "C" int csf2d_local_block_step(LOCAL_INTS, const void* s_in, void* s_out,
                                      const void* geo, void* scratch,
                                      const CsfParams* params, void* stream) {
  return launch_csf_local<float>(s_in, s_out, geo, scratch, *params, LOCAL_GRID, T,
                                 static_cast<cudaStream_t>(stream));
}

LOCAL_INFO_ENTRY_POINTS(csf2d_local, CsfParams, csf_local_shape<float>)
