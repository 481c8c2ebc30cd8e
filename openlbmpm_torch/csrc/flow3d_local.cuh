// The local form of the D3Q19 Shan-Chen step (K12e): one shard of a
// z-decomposed domain, T steps a call, for NVIDIA Hopper (sm_90a), included
// by flow3d_local_f64.cu and flow3d_local_f32.cu.
//
// Replaces the per-shard kernel of openlbmpm_tpu/pallas/sc3d.py::
// build_sc3d_sharded_step (the local build_sc3d_fused_step, pallas_call
// :378, under shard_map :443-468): any number of fluids, psi = rho,
// steps_per_call T >= 1, f32 / f64 storage (bf16 refused, as there).
//
// A shard's state lives in a padded buffer (parallel/mesh.py): its centre
// of nz slabs, 2T slabs of frame below and above (z periodic: no global
// offset enters the physics), y and x whole and wrapping.  After one
// exchange a call, T sub-steps of K10 run over a slab range that shrinks by
// two a sub-step (rho's stencil one slab, streaming one): sub-step t writes
// slabs [2t, pz - 2t) of the buffer, reading rho over [2t - 2, pz - 2t + 2),
// which the sub-step before wrote.  The sub-steps ping-pong between the
// output buffer and a scratch buffer, so that the last writes the output's
// centre; the input is only read.  K = 1 ... 3: one launch of flow3d.cuh's
// sc_push_kernel with BOX = true a sub-step (it collides [a - 1, b + 1),
// forms rho over [a - 2, b + 2) in its ring and writes only [a, b));
// K > 3: sc3d_rt.cuh's rho, collide and stream over their ranges, on the
// state buffers themselves (f32 / f64 storage is the compute type).
//
// This replaces K10-T's global-scratch window: the one-step kernel over a
// shrinking range recomputes 2T slabs a side a call, not a halo a brick.
//
// What bounds it: HBM bytes, per sub-step the state in and out over its
// range (K = 2: 304 B a cell in f32), plus the frames' copies once a call.

#pragma once

#include "sc3d_rt.cuh"

namespace {

// The scratch of a call in bytes: none up to kFlowMaxFluids; above, rho
// (K planes of the buffer), the post-collision populations (19 K) and the
// interaction sums (3 K).
template <typename S>
size_t sc3d_local_scratch(const Flow3dParams& P) {
  const size_t planes = P.k <= kFlowMaxFluids ? 0 : (size_t)P.k * (Q + 4);
  return planes * (size_t)P.nz * P.ny * P.nx * sizeof(S);
}

// One K10 sub-step over the buffer's slabs [a, b): sc_push_kernel (K <= 3),
// or rho over [a - 2, b + 2), collide over [a - 1, b + 1) and stream
// (runtime K).
template <typename S, int K>
int local_substep(const S* f, S* out, const unsigned char* fl, S* scratch, const double* table,
                  const Flow3dParams& P, int a, int b, cudaStream_t st) {
  const size_t nxy = (size_t)P.ny * P.nx;
  const size_t n = (size_t)P.nz * nxy;
  auto blocks = [&](int z0, int z1) { return (unsigned)(((z1 - z0) * nxy + 255) / 256); };
  cudaError_t err;
  if constexpr (K > 0) {
    return launch_push<S, K, true>(f, fl, out, P, st, ZRange{a, b});
  } else {
    const int k = P.k;
    S* rho = scratch;
    S* gs = rho + (size_t)k * n;
    S* post = gs + (size_t)3 * k * n;
    const Sc3Table tb{table, k};
    rt3_rho_kernel<S><<<blocks(a - 2, b + 2), 256, 0, st>>>(f, fl, rho, k, n, (a - 2) * nxy,
                                                           (b + 2) * nxy);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rt3_collide_kernel<S><<<blocks(a - 1, b + 1), 256, 0, st>>>(f, fl, rho, gs, post, P, tb,
                                                               (a - 1) * nxy, (b + 1) * nxy);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rt3_stream_kernel<S><<<blocks(a, b), 256, 0, st>>>(post, fl, out, P, k, a * nxy, b * nxy);
    return (int)cudaGetLastError();
  }
}

// T sub-steps of the shard's padded buffer f_in (P.nz its slabs, a frame of
// 2T each side) into the centre of f_out, f_tmp a second buffer of its
// shape (written only when T > 1; may be null at T = 1); table the
// runtime-K table (read above kFlowMaxFluids).
template <typename S>
int launch_sc3d_local(int T, const void* f_in, void* f_out, void* f_tmp, const void* fl_v,
                      void* scratch_v, const double* table, const Flow3dParams& P,
                      cudaStream_t st) {
  if (T < 1 || P.nz < 4 * T + 1 || (T > 1 && f_tmp == nullptr) ||
      (P.k > kFlowMaxFluids && table == nullptr))
    return (int)cudaErrorInvalidValue;
  const unsigned char* fl = static_cast<const unsigned char*>(fl_v);
  S* scratch = static_cast<S*>(scratch_v);
  const S* src = static_cast<const S*>(f_in);
  for (int t = 1; t <= T; ++t) {
    S* dst = static_cast<S*>((T - t) % 2 == 0 ? f_out : f_tmp);
    const int a = 2 * t, b = P.nz - 2 * t;
    int err;
    switch (P.k) {
      case 1: err = local_substep<S, 1>(src, dst, fl, scratch, table, P, a, b, st); break;
      case 2: err = local_substep<S, 2>(src, dst, fl, scratch, table, P, a, b, st); break;
      case 3: err = local_substep<S, 3>(src, dst, fl, scratch, table, P, a, b, st); break;
      default: err = local_substep<S, 0>(src, dst, fl, scratch, table, P, a, b, st);
    }
    if (err) return err;
    src = dst;
  }
  return 0;
}

}  // namespace
