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
// With TracerParams.standalone (fixed flow fields) the flow launch is
// skipped and the flow state is left as it is.  The f64 instances are the
// library coupled2d_f64 (coupled2d_f64.cu, which defines COUPLED2D_F64 and
// is built with -fmad=false), the others this file's.
//
// One coupled step, two launches:
//   1. tracer_strip_kernel  the tracer sub-step by the strip march of
//      csf2d.cuh's strip_kernel (a block owns TX = 32 columns of a run of
//      RUN_H = 32 rows and steps down it TY = 8 rows at a time, a barrier
//      between its stages), on the fields of the state before the flow's
//      boundary rows, as the reference's 2-D coupled loop has them.  Its
//      shared-memory rings, row r of the domain in slot (r - y0 + 8) mod
//      depth:
//        phi     phi of the state as it stands (no boundary rows, the
//                outlet phi repair kept) and the fluid flag, 4 rows ahead
//                of the output rows with a 4-column halo, and the cell's
//                rho, rho_r and momenta (the fields the collision reads,
//                over its columns: a 1-column halo);
//        normal  the wetted gradient and unit normal, 2 rows ahead, a
//                2-column halo;
//        post    g_post of the launch's tracers, the fluid flag and the
//                transport-domain flag rho_r < criteria, 1 row ahead, a
//                1-column halo: tracer_collide on u = (m + F/2) / rho, the
//                CSF force from the normal ring around the cell.
//      Each output row pulls g from the post ring (tracer_stream: the
//      free-flow outlet rows, half-way bounce-back, the hard interface
//      bounce-back, the inlet rows).  The post ring keeps 2 rows behind the
//      output rows, which the zero and anti-bounce-back inlets read, and
//      the last step of the domain forms 3 rows more: its top row pulls
//      from row 0, which the free-flow outlet copies from rows 1-3.  A
//      launch takes the tracers whose rings fit (all of chip_smoke.py's
//      cases fit one); more tracers take more launches.  It also writes, where
//      asked, the pre-step domain mask and velocity of its own cells.
//   2. the flow step of csf2d.cuh, strip_kernel (boundary rows on the fly;
//      its phi and normals stay in shared memory).
// The two read the same state and write different outputs.
//
// What bounds it: HBM bytes per cell-step.  With an f32 state, one D2Q5
// tracer and f32 tracer PDFs the tracer launch moves about 85 B (the state
// 40, the fluid plane 4, g 20 in and 20 out, the domain mask 1 where the
// split model asks for it) and the flow march 81 B: about 166 B against
// 121 B for one fused pass over state and tracers.  With the bf16 state
// the tracer launch moves about 67 B, with the split f32 one about 117 B.
// The x halo (34 collisions for 32 columns) and each run's prologue
// re-read from L2.  Like the flow's march it runs far from these bytes:
// the warps in flight and each stage's latency bind it (PERF.md).

#include "coupled2d.cuh"

namespace {

// The rings of a tracer strip (shared memory, compute type C), row r of the
// domain in slot (r - y0 + 8) mod depth (the prologue reaches 6 rows above
// a run):
//   phi     phi and the fluid flag, TX + 8 columns; the fields rho, rho_r,
//           m_x, m_y of the collision's TX + 2 columns, in the same slots;
//   normal  the wetted gradient and unit normal (4 planes), TX + 4 columns;
//   post    g_post (ng planes), the fluid flag and the domain flag, TX + 2
//           columns.
// Depths: the last step of the domain forms 3 rows more (TY + 7 phi rows
// live in its normal pass, TY + 5 normal rows in its collision, TY + 5 post
// rows in its stream: 1 behind, TY, 1 ahead and the 3; the inlets' second
// row behind is read only by a step of at most 2 rows).
template <typename C>
struct TracerRings {
  static constexpr int PW = TX + 8, PR = TY + 7;
  static constexpr int SW = TX + 2;
  static constexpr int NW = TX + 4, NR = TY + 5;
  static constexpr int QW = TX + 2, QR = TY + 5;
  static constexpr int PN = PR * PW, SN = PR * SW, NN = NR * NW, QN = QR * QW;
  // bytes of the rings for ng post planes
  __host__ __device__ static constexpr size_t bytes(int ng) {
    return sizeof(C) * ((size_t)PN + 4 * SN + 4 * NN + (size_t)ng * QN) + PN + 2 * QN;
  }
};

// resident blocks an SM asked of ptxas (chip_sweep.py 2dcg: in float 4
// against 3 took K5c f32 from 0.2568 to 0.2417 ms a step at 1024^2, 2 to
// 0.2845; the warps in flight bind it, as they bind strip_kernel)
template <typename C>
__host__ __device__ constexpr int tracer_strip_min_blocks() {
  return sizeof(C) == 8 ? 1 : 4;
}

// The tracer's view of the post ring for tracer_stream (coupled2d.cuh's
// view interface): x is the ring's column, y the unwrapped row.
template <typename C>
struct StripView {
  const C* __restrict__ gp;
  const unsigned char* __restrict__ qf;
  const unsigned char* __restrict__ qd;
  int y0, ny;
  __device__ int at(int x, int y) const {
    return ((y - y0 + 8) % TracerRings<C>::QR) * TracerRings<C>::QW + x;
  }
  __device__ C post(int q, int x, int y) const { return gp[q * TracerRings<C>::QN + at(x, y)]; }
  __device__ C fl(int x, int y) const { return qf[at(x, y)] ? C(1) : C(0); }
  __device__ bool dom(int x, int y) const { return qd[at(x, y)]; }
  __device__ int row(int y) const { return wrap(y, ny); }
  __device__ int xs(int x, int d) const { return x + d; }
  __device__ int ys(int y, int d) const { return y + d; }
  __device__ bool above(int) const { return true; }
};

// The tracer sub-step of tracers t0 ... t0 + T.nt - 1 by the strip march
// (the note at the top): g -> g', and where dom / uo are not null the
// pre-step domain mask and velocity of the block's own cells.  tab points
// at tracer t0's table row.
template <typename S, int L, int NQ, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(STRIP_THREADS, tracer_strip_min_blocks<C>())
tracer_strip_kernel(const S* __restrict__ s, const S* __restrict__ s2,
                    const C* __restrict__ geo, const C* __restrict__ g,
                    const C* __restrict__ tab, C* __restrict__ out,
                    unsigned char* __restrict__ dom, C* __restrict__ uo, CsfParams P,
                    TracerParams T, int t0) {
  using R = TracerRings<C>;
  extern __shared__ __align__(16) unsigned char tracer_smem[];
  const int ng = T.nt * NQ;
  C* const ph = reinterpret_cast<C*>(tracer_smem);
  C* const fd = ph + R::PN;
  C* const nm = fd + 4 * R::SN;
  C* const po = nm + 4 * R::NN;
  unsigned char* const pf = reinterpret_cast<unsigned char*>(po + (size_t)ng * R::QN);
  unsigned char* const qf = pf + R::PN;
  unsigned char* const qd = qf + R::QN;
  const int nx = P.nx, ny = P.ny;
  const size_t n = (size_t)ny * nx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * RUN_H;
  const int y1 = min(y0 + RUN_H, ny);
  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  auto slot = [&](int r, int depth) { return (r - y0 + 8) % depth; };
  // the state as it stands: no boundary rows
  CsfParams P0 = P;
  P0.inlet = 0;
  P0.outlet = 0;

  // phi and the fluid flag of rows [r0, r1), columns x0 - 4 ... x0 + TX + 3
  // (phi_at's arithmetic), and rho, rho_r, m_x, m_y of columns
  // x0 - 1 ... x0 + TX, solid cells too
  auto form_phi = [&](int r0, int r1) {
    for (int t = tid; t < (r1 - r0) * R::PW; t += STRIP_THREADS) {
      const int lx = t % R::PW, r = r0 + t / R::PW;
      const int x = wrap(x0 - 4 + lx, nx), y = wrap(r, ny);
      const int b = slot(r, R::PR) * R::PW + lx;
      const size_t k = (size_t)y * nx + x;
      const bool fluid = geo[k] > C(0.5);
      const bool kept = lx >= 3 && lx < TX + 5;
      C phi = C(0);
      if (fluid || kept) {
        Cell<C, L> c;
        load_raw<S, L>(s, s2, geo, n, k, c);
        C f[9], rr, rb, rho;
        totals(c, f, rr, rb, rho);
        if (kept) {
          C* q = fd + slot(r, R::PR) * R::SW + lx - 3;
          C mx, my;
          tracer_momentum(f, mx, my);
          q[0] = rho;
          q[R::SN] = rr;
          q[2 * R::SN] = mx;
          q[3 * R::SN] = my;
        }
        if (fluid) {
          if (P.phi_repair && y <= 1) {
            // Dirichlet-outlet repair: phi on fluid cells of rows 1, 0 <- row 2
            phi = phi_at<S, L>(s, s2, geo, P0, x, 2);
          } else {
            const C tot = rr + rb;
            phi = tot != C(0) ? (rr - rb) / tot : C(0);
          }
        }
      }
      pf[b] = fluid;
      ph[b] = phi;
    }
  };
  // the wetted gradient and unit normal of rows [r0, r1), columns
  // x0 - 2 ... x0 + TX + 1 (strip_kernel's arithmetic)
  auto form_normal = [&](int r0, int r1) {
    for (int t = tid; t < (r1 - r0) * R::NW; t += STRIP_THREADS) {
      const int lx = t % R::NW, r = r0 + t / R::NW;
      const int x = wrap(x0 - 2 + lx, nx), y = wrap(r, ny);
      const size_t k = (size_t)y * nx + x;
      // phi extended onto solid nodes: the w-weighted mean of the fluid
      // neighbours, num / den as the reference forms it
      auto phi_ext = [&](int dx, int dy) -> C {
        const int b = slot(r + dy, R::PR) * R::PW + lx + 2 + dx;
        if (!P.has_wetting || pf[b]) return ph[b];
        C num = C(0), den = C(0);
#pragma unroll
        for (int i = 1; i < 9; ++i) {
          const int q = slot(r + dy + ey(i), R::PR) * R::PW + lx + 2 + dx + ex(i);
          num = num + C(wq(i)) * ph[q];
          den = den + C(wq(i)) * C(pf[q]);
        }
        return den > C(0) ? num / den : C(0);
      };
      C gx, gy;
      phi_gradient([&](int i) { return phi_ext(ex(i), ey(i)); }, gx, gy);
      if (P.has_wetting && geo[n + k] > C(0.5))
        rotate_wetting(gx, gy, geo[2 * n + k], geo[3 * n + k], P);
      const int b = slot(r, R::NR) * R::NW + lx;
      nm[b] = gx;
      nm[R::NN + b] = gy;
      unit_normal(gx, gy, geo[k], P, nm[2 * R::NN + b], nm[3 * R::NN + b]);
    }
  };
  // the tracers' collision of rows [r0, r1), columns x0 - 1 ... x0 + TX (a
  // strip cut short by the domain's edge collides the columns it reads)
  const int qn = min(R::QW, nx - x0 + 2);
  auto form_post = [&](int r0, int r1) {
    for (int t = tid; t < (r1 - r0) * R::QW; t += STRIP_THREADS) {
      const int lx = t % R::QW, r = r0 + t / R::QW;
      if (lx >= qn) continue;
      const int x = wrap(x0 - 1 + lx, nx), y = wrap(r, ny);
      const size_t k = (size_t)y * nx + x;
      const int b = slot(r, R::QR) * R::QW + lx;
      const bool fluid = pf[slot(r, R::PR) * R::PW + lx + 3];
      const C* q = fd + slot(r, R::PR) * R::SW + lx;
      const C rho = q[0], rr = q[R::SN];
      const int nb = slot(r, R::NR) * R::NW + lx + 1;
      const C gx = nm[nb], gy = nm[R::NN + nb];
      C fx = C(0), fy = C(0);
      if (fluid)
        csf_force(
            [&](int i, C& sx, C& sy) {
              const int c = slot(r + ey(i), R::NR) * R::NW + lx + 1 + ex(i);
              sx = nm[2 * R::NN + c];
              sy = nm[3 * R::NN + c];
            },
            nm[2 * R::NN + nb], nm[3 * R::NN + nb], gx, gy, rho, P, fx, fy);
      C ux, uy;
      tracer_velocity_of(q[2 * R::SN], q[3 * R::SN], rho, fx, fy, ux, uy);
      const bool in_dom = rr < C(T.criteria);
      qf[b] = fluid;
      qd[b] = in_dom;
      if (r >= y0 && r < y1 && lx >= 1 && lx <= TX && x0 + lx - 1 < nx) {
        // the block's own cell: written once
        if (dom) dom[k] = in_dom;
        if (uo) {
          uo[k] = ux;
          uo[n + k] = uy;
        }
      }
      tracer_collide<C, NQ>(
          [&](int tr, int i) { return g[((size_t)(t0 + tr) * NQ + i) * n + k]; },
          [&](int tr, int i, C v) { po[(tr * NQ + i) * R::QN + b] = v; }, ux, uy, in_dom,
          gx, gy, tab, T, t0);
    }
  };
  // the pull of the output rows [r0, r0 + TY) from the post ring
  const StripView<C> view{po, qf, qd, y0, ny};
  auto stream_rows = [&](int r0) {
    const int r = r0 + ty, x = x0 + tx;
    if (tid >= TX * TY || r >= y1 || x >= nx) return;
    const size_t k = (size_t)r * nx + x;
    tracer_stream<C, NQ>(view, tab, T, ny, tx + 1, r, [&](int tr, int i, C v) {
      out[((size_t)(t0 + tr) * NQ + i) * n + k] = v;
    });
  };

  // the zero and anti-bounce-back inlets read 2 rows behind
  const int lo = T.inlet >= 2 ? 1 : 0;
  form_phi(y0 - 4 - lo, y0 + 4);
  __syncthreads();
  form_normal(y0 - 2 - lo, y0 + 2);
  __syncthreads();
  form_post(y0 - 1 - lo, y0 + 1);
  __syncthreads();
  for (int a = y0; a < y1; a += TY) {
    // the stream of the step before reads the post ring alone; a last
    // step may stop short, and the domain's last forms 3 rows more for
    // the free-flow outlet's copies of rows 1-3 into row 0
    const int e = min(a + TY, y1);
    const int more = e == ny && T.outlet == 1 ? 3 : 0;
    form_phi(a + 4, e + 4 + more);
    __syncthreads();
    form_normal(a + 2, e + 2 + more);
    __syncthreads();
    form_post(a + 1, e + 1 + more);
    __syncthreads();
    stream_rows(a);
  }
}

// The tracers a launch takes: as many as fit the card's shared memory a
// block (at least one).
template <typename C, int NQ>
int tracers_a_launch(int nt) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 1;
  int fit = 1;
  while (fit < nt && TracerRings<C>::bytes((fit + 1) * NQ) <= (size_t)optin) ++fit;
  return fit;
}

template <typename S, int L, int NQ>
int launch_coupled(const void* s_in, const void* s2_in, void* s_out, void* s2_out,
                   const void* geo_v, const void* g_in, void* g_out, void* dom_v,
                   void* u_out, const void* tab_v, const CsfParams& P,
                   const TracerParams& T, cudaStream_t st) {
  using C = typename Traits<S>::C;
  auto kernel = tracer_strip_kernel<S, L, NQ>;
  static size_t opted[64];   // the rings' bytes this instance opted in to
  const int group = tracers_a_launch<C, NQ>(T.nt);
  const dim3 grid((P.nx + TX - 1) / TX, (P.ny + RUN_H - 1) / RUN_H);
  const C* tab = static_cast<const C*>(tab_v);
  const int row_len = kU + NQ * NQ;
  for (int t0 = 0; t0 < T.nt; t0 += group) {
    TracerParams Tg = T;
    Tg.nt = min(group, T.nt - t0);
    const size_t smem = TracerRings<C>::bytes(Tg.nt * NQ);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (smem > 48 * 1024 && (dev >= 64 || opted[dev] < smem)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) opted[dev] = smem;
    }
    kernel<<<grid, STRIP_THREADS, smem, st>>>(
        static_cast<const S*>(s_in), static_cast<const S*>(s2_in),
        static_cast<const C*>(geo_v), static_cast<const C*>(g_in), tab + t0 * row_len,
        static_cast<C*>(g_out), static_cast<unsigned char*>(dom_v),
        static_cast<C*>(u_out), P, Tg, t0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++g_csf_launches[0];
  }
  if (T.standalone) return 0;
  return launch_flow<S, L>(s_in, s2_in, s_out, s2_out, geo_v, P, st);
}

template <typename S, int L>
int launch_nq(const TracerParams& T, const void* s_in, const void* s2_in, void* s_out,
              void* s2_out, const void* geo, const void* g_in, void* g_out, void* dom,
              void* u_out, const void* tab, const CsfParams& P, cudaStream_t st) {
  switch (T.nq) {
    case 5: return launch_coupled<S, L, 5>(s_in, s2_in, s_out, s2_out, geo, g_in, g_out,
                                           dom, u_out, tab, P, T, st);
    case 9: return launch_coupled<S, L, 9>(s_in, s2_in, s_out, s2_out, geo, g_in, g_out,
                                           dom, u_out, tab, P, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: compressed 0 = f64 state, 1 = f32 state, 2 = bf16 11-plane state;
// split 3 = f64 (f_r, f_b), 4 = f32 (f_r, f_b); modes 0 and 3 with
// COUPLED2D_F64 defined, the others without it.  s2_in and s2_out are f_b
// in the split modes and unused otherwise.  The outputs are allocated by
// the caller: dom (bytes), if not null, receives the pre-step domain mask
// rho_r < criteria and u_out, if not null, the pre-step velocity (2, ny,
// nx) in the compute type.  Returns a cudaError_t code
// (cudaErrorInvalidValue for a mode this library does not hold).
extern "C" int coupled2d_step(int mode, const void* s_in, const void* s2_in, void* s_out,
                              void* s2_out, const void* geo, const void* g_in, void* g_out,
                              void* dom, void* u_out, const void* tab,
                              const CsfParams* params, const TracerParams* tparams,
                              void* stream) {
  const CsfParams P = *params;
  const TracerParams T = *tparams;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define COUPLED_ARGS s_in, s2_in, s_out, s2_out, geo, g_in, g_out, dom, u_out, tab, P, st
  switch (mode) {
#ifdef COUPLED2D_F64
    case 0: return launch_nq<double, kCompressed>(T, COUPLED_ARGS);
    case 3: return launch_nq<double, kSplit>(T, COUPLED_ARGS);
#else
    case 1: return launch_nq<float, kCompressed>(T, COUPLED_ARGS);
    case 2: return launch_nq<__nv_bfloat16, kCompressed>(T, COUPLED_ARGS);
    case 4: return launch_nq<float, kSplit>(T, COUPLED_ARGS);
#endif
    default: return (int)cudaErrorInvalidValue;
  }
#undef COUPLED_ARGS
}

// The launches of each kernel since the library was loaded (csf2d.cuh's
// g_csf_launches: tracer_strip_kernel, strip_kernel; the last 0 here).
extern "C" void coupled2d_kernel_launches(long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = g_csf_launches[i];
}

extern "C" const char* coupled2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
