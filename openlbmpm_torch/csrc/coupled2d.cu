// Coupled CSF flow + phase-confined tracer step, for NVIDIA Hopper
// (sm_90a).  The tracer's device code is in coupled2d.cuh, which the
// T-step kernel (coupled2d_block.cuh, K5c-T) shares.
//
// Replaces the TPU kernel openlbmpm_tpu/pallas/csf.py::build_csf_fused_step
// with transport_params at steps_per_call=1 (its _transport_substep plus
// the flow step), in both flow-state layouts of csf2d.cuh:
// state_mode="compressed" (K5c: an f64 or f32 flow state, or the 11-plane
// bf16 one) and state_mode="split" (K5s: (f_r, f_b), f64 or f32).  Tracer
// PDFs g (NT, NQ, ny, nx), NQ 5 (D2Q5) or 9 (D2Q9), are f64 in the f64
// instances and f32 otherwise: they are never stored in bf16.  Formulas
// follow the jnp path (TransportRK._transport_substep and ops/transport.py).
// The split model's conserve_mass and redistribute repairs are global or
// neighbourhood passes over g that the reference also runs outside its
// kernel; they stay PyTorch ops after the launch (models/transport.py),
// fed by the pre-step domain mask and velocity this step writes out.
// With TracerParams.standalone (fixed flow fields) the flow launches are
// skipped and the flow state is left as it is.
//
// One coupled step, five launches, one thread per cell in the first four:
//   1. phase_kernel    the flow state as it stands (no boundary rows, the
//                      outlet phi repair kept) -> phi0
//   2. normal_kernel   phi0 -> wetted gradient g0 and unit normals
//   3. tracer_collide  u = (m + F/2)/rho and rho_r < criteria from the same
//                      pre-BC state, the CSF force from the normals around
//                      the cell; per tracer: SRT (J-scheme or linear) or MRT
//                      (linear or quadratic equilibrium) collision, the beta
//                      partition along -g0/|g0|, the bilinear reaction ->
//                      g_post, the domain mask (one byte a cell) and, when
//                      asked, u (the split model's conserve_mass repair
//                      reads this pre-step velocity)
//   4. tracer_stream   free-flow outlet rows, pull streaming with half-way
//                      bounce-back, hard interface bounce-back and the inlet
//                      rows, all as reads of g_post -> g'
//   5. the flow step of csf2d.cuh, strip_kernel (boundary rows on the fly;
//      its phi and normals stay in shared memory).
// The tracer sees the fields of the state before the flow's boundary rows,
// as the reference's 2-D coupled loop does, so launches 1-2 form phi and
// the normals of that state, which the flow's own march (with the rows)
// cannot hand over.
//
// What bounds it: HBM bytes per cell-step.  With an f32 state, one D2Q5
// tracer and f32 tracer PDFs: 48 B (phase: state 40, fluid plane 4, phi 4),
// 28 B (normal), 101 B (tracer_collide: state 40, fluid plane 4, normals 16,
// g 20, g_post 20, mask 1), 44 B (tracer_stream: g_post 20, fluid plane 4,
// g' 20; the mask 1 more with a bounce-back interface) and the flow
// march's 81 B (the state in and out; its halo re-reads from L2): about
// 300 B against 120 B for one fused pass over state and tracers.  With the
// bf16 state: about 230 B against 84 B.  With the split f32 state (72 B a
// read): 80 + 28 + 133 + 44 and the flow's 145 B, about 430 B against
// 184 B.  Stencil neighbour re-reads hit L1/L2.  Fusing launches 1-4 into
// one pass is the next step for speed.

#include "coupled2d.cuh"

namespace {

template <typename S, int L, int NQ, typename C = typename Traits<S>::C>
__global__ void tracer_collide_kernel(const S* __restrict__ s, const S* __restrict__ s2,
                                      const C* __restrict__ geo,
                                      const C* __restrict__ nrm, const C* __restrict__ g,
                                      const C* __restrict__ tab, C* __restrict__ gp,
                                      unsigned char* __restrict__ dom, C* __restrict__ uo,
                                      CsfParams P, TracerParams T) {
  const size_t n = (size_t)P.ny * P.nx;
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int x = (int)(k % P.nx), y = (int)(k / P.nx);

  // flow fields of the state as it stands (TransportRK._step_impl)
  Cell<C, L> c;
  load_raw<S, L>(s, s2, geo, n, k, c);
  C f[9], rr, rb, rho;
  totals(c, f, rr, rb, rho);
  C fx = C(0), fy = C(0);
  if (geo[k] > C(0.5)) csf_force_at(nrm, P, x, y, rho, fx, fy);
  C ux, uy;
  tracer_velocity(f, rho, fx, fy, ux, uy);
  const bool in_dom = rr < C(T.criteria);
  dom[k] = in_dom;
  if (uo) {
    uo[k] = ux;
    uo[n + k] = uy;
  }
  const size_t tq = (size_t)NQ * n;
  tracer_collide<C, NQ>([&](int t, int i) { return g[t * tq + i * n + k]; },
                        [&](int t, int i, C v) { gp[t * tq + i * n + k] = v; }, ux, uy,
                        in_dom, nrm[k], nrm[n + k], tab, T);
}

template <typename C, int NQ>
__global__ void tracer_stream_kernel(const C* __restrict__ gp, const C* __restrict__ geo,
                                     const unsigned char* __restrict__ dom,
                                     const C* __restrict__ tab, C* __restrict__ out,
                                     CsfParams P, TracerParams T) {
  const int nx = P.nx, ny = P.ny;
  const size_t n = (size_t)ny * nx;
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int x = (int)(k % nx), y = (int)(k / nx);
  const GlobalView<C> v{gp, geo, dom, nx, ny, n};
  tracer_stream<C, NQ>(v, tab, T, ny, x, y,
                       [&](int t, int i, C val) { out[((size_t)t * NQ + i) * n + k] = val; });
}

template <typename S, int L, int NQ>
int launch_coupled(const void* s_in, const void* s2_in, void* s_out, void* s2_out,
                   const void* geo_v, void* phi_v, void* nrm_v, const void* g_in,
                   void* g_post, void* g_out, void* dom_v, void* u_out, const void* tab_v,
                   const CsfParams& P, const TracerParams& T, cudaStream_t st) {
  using C = typename Traits<S>::C;
  const S* s = static_cast<const S*>(s_in);
  const S* s2 = static_cast<const S*>(s2_in);
  const C* geo = static_cast<const C*>(geo_v);
  C* phi = static_cast<C*>(phi_v);
  C* nrm = static_cast<C*>(nrm_v);
  C* gp = static_cast<C*>(g_post);
  unsigned char* dom = static_cast<unsigned char*>(dom_v);
  const C* tab = static_cast<const C*>(tab_v);
  // the tracer sees the state before the flow's boundary rows
  CsfParams P0 = P;
  P0.inlet = 0;
  P0.outlet = 0;
  const size_t n = (size_t)P.ny * P.nx;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  phase_kernel<S, L><<<blocks, threads, 0, st>>>(s, s2, geo, phi, P0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++g_csf_launches[0];
  normal_kernel<C><<<blocks, threads, 0, st>>>(geo, phi, nrm, P0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++g_csf_launches[1];
  tracer_collide_kernel<S, L, NQ><<<blocks, threads, 0, st>>>(
      s, s2, geo, nrm, static_cast<const C*>(g_in), tab, gp, dom, static_cast<C*>(u_out),
      P0, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++g_csf_launches[3];
  tracer_stream_kernel<C, NQ><<<blocks, threads, 0, st>>>(gp, geo, dom, tab,
                                                          static_cast<C*>(g_out), P, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++g_csf_launches[4];
  if (T.standalone) return 0;
  return launch_flow<S, L>(s_in, s2_in, s_out, s2_out, geo_v, P, st);
}

template <typename S, int L>
int launch_nq(const TracerParams& T, const void* s_in, const void* s2_in, void* s_out,
              void* s2_out, const void* geo, void* phi, void* nrm, const void* g_in,
              void* g_post, void* g_out, void* dom, void* u_out, const void* tab,
              const CsfParams& P, cudaStream_t st) {
  switch (T.nq) {
    case 5: return launch_coupled<S, L, 5>(s_in, s2_in, s_out, s2_out, geo, phi, nrm,
                                           g_in, g_post, g_out, dom, u_out, tab, P, T, st);
    case 9: return launch_coupled<S, L, 9>(s_in, s2_in, s_out, s2_out, geo, phi, nrm,
                                           g_in, g_post, g_out, dom, u_out, tab, P, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: compressed 0 = f64 state, 1 = f32 state, 2 = bf16 11-plane state;
// split 3 = f64 (f_r, f_b), 4 = f32 (f_r, f_b).  s2_in and s2_out are f_b
// in the split modes and unused otherwise.  The scratch planes phi (1),
// nrm (4), g_post (as g) and all outputs are allocated by the caller: dom
// (bytes) receives the pre-step domain mask rho_r < criteria and u_out, if
// not null, the pre-step velocity (2, ny, nx) in the compute type.  Returns
// a cudaError_t code.
extern "C" int coupled2d_step(int mode, const void* s_in, const void* s2_in, void* s_out,
                              void* s2_out, const void* geo, void* phi, void* nrm,
                              const void* g_in, void* g_post, void* g_out, void* dom,
                              void* u_out, const void* tab, const CsfParams* params,
                              const TracerParams* tparams, void* stream) {
  const CsfParams P = *params;
  const TracerParams T = *tparams;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define COUPLED_ARGS s_in, s2_in, s_out, s2_out, geo, phi, nrm, g_in, g_post, g_out, dom, \
                     u_out, tab, P, st
  switch (mode) {
    case 0: return launch_nq<double, kCompressed>(T, COUPLED_ARGS);
    case 1: return launch_nq<float, kCompressed>(T, COUPLED_ARGS);
    case 2: return launch_nq<__nv_bfloat16, kCompressed>(T, COUPLED_ARGS);
    case 3: return launch_nq<double, kSplit>(T, COUPLED_ARGS);
    case 4: return launch_nq<float, kSplit>(T, COUPLED_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef COUPLED_ARGS
}

// The launches of each kernel since the library was loaded (csf2d.cuh's
// g_csf_launches: phase_kernel, normal_kernel, strip_kernel,
// tracer_collide_kernel, tracer_stream_kernel; the last 0 here).
extern "C" void coupled2d_kernel_launches(long long* out) {
  for (int i = 0; i < 6; ++i) out[i] = g_csf_launches[i];
}

extern "C" const char* coupled2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
