// Temporally blocked coupled CSF flow + phase-confined tracer step, D2Q9
// flow with D2Q5 or D2Q9 tracers, for NVIDIA Hopper (sm_90a): the window
// form of K5c-T, T time steps a launch, which the local form (K12a with
// transport, coupled2d_local_{f64,f32}.cu) runs on one shard.  The
// single-device K5c-T is the row-march of march2d.cuh (coupled2d_block_
// {f64,f32,bf16}.cu), on the same tracer and CSF bodies.
//
// Replaces the TPU kernel openlbmpm_tpu/pallas/csf.py::build_csf_fused_step
// with transport_params and steps_per_call = T > 1 (tracer sub-step
// _transport_substep :1385, its rows :1454-1500, the order per sub-step
// :1729-1751), on both flow layouts: compressed (f_total, rho_r), 10 planes
// in f32 or f64 or 11 bf16 planes decoded to f32 once a call and encoded
// once a call, and split (f_r, f_b).  The tracer PDFs g (NT, NQ, ny, nx)
// are in the compute type (f32 under bf16 flow storage), never bf16.
//
// Every sub-step, in the reference's order (TransportRK._step_impl, and
// the one-step kernels of coupled2d.cu):
//   1. the colour fields of the flow state as it stands, before the
//      sub-step's boundary rows (csf_window_fields: phi with the outlet
//      repair, phi_ext, the wetted gradient);
//   2. the tracer collision on those fields (u = (m + F/2) / rho with the
//      CSF force, rho_r < criteria), the partition and the reaction
//      (coupled2d.cuh::tracer_collide) into the window's g_post planes;
//   3. the tracer streaming, interface repair and tracer rows as reads of
//      g_post (coupled2d.cuh::tracer_stream) into the g planes;
//   4. the flow's boundary rows (csf2d_block.cuh::window_bc_rows);
//   5. the flow sub-step of K3 (csf2d_block.cuh::csf_window_physics).
// The window machinery is block2d.cuh's.  Rings a sub-step: 4, the CSF
// step's (stream <- force <- gradient <- phi_ext <- phi); the tracer
// streams on the same ring as the flow, its collision one ring inside
// the force's.  The TPU kernel adds a ring with a bounce-back interface
// (_halo_rows), because it repairs the streamed planes by shifting them
// again; here the repair reads g_post at the cell and its upwind neighbour
// only, so the ring stays 4.  Margins: the boundary bands' reaches add up,
// since one crossing of a band stales the flow's copy and then the
// tracer's: above, the flow's outlet rows (3) and the tracer's free-flow
// rows (3); below, the flow's inlet ghost (1) and the tracer's
// anti-bounce-back or zero-concentration inlet (2).
// Window planes (compute type): the flow's K3 planes (state, PHI, GX, GY),
// NT NQ planes of g, NT NQ of g_post, and one plane's room for the
// transport-domain bytes (then block2d.cuh's fluid bytes).
//
// What bounds it: HBM bytes per cell-step are the flow state and the
// tracers read once and written once a call, over T: (81 + 40) / T B
// (compressed f32, one f32 D2Q5 tracer), (45 + 40) / T (bf16).  What sets
// its pace is the window: T = 4 gives windows of 2-6x the tile, recomputed
// every sub-step, in global scratch for most shapes (the g and g_post
// planes double the tracer's share of the window), and one 512-thread
// block a streaming multiprocessor across 15 barriers a sub-step.

#pragma once

#include "coupled2d.cuh"
#include "csf2d_block.cuh"

// The parameter block of a T-step launch: the flow's and the tracers'.
struct CoupledParams {   // mirrored by kernels/transport.py::CoupledParams
  CsfParams flow;
  TracerParams tracer;
};

namespace {

// The tracer's post-collision planes of the window region for the stream
// functions of coupled2d.cuh: coordinates are window cells (no wrap; the
// callers stay two cells inside the window), rows map to global rows by
// the window's offset oy.
template <typename C>
struct WindowView {
  const C* GP;
  const unsigned char* FL;
  const unsigned char* DOM;
  size_t PL;
  int wx, wy, oy, ny;
  __device__ C post(int q, int x, int y) const { return GP[q * PL + (size_t)y * wx + x]; }
  __device__ C fl(int x, int y) const { return FL[y * wx + x] ? C(1) : C(0); }
  __device__ bool dom(int x, int y) const { return DOM[y * wx + x]; }
  __device__ int row(int y) const { return wrap(oy + y, ny); }
  __device__ int xs(int x, int d) const { return x + d; }
  __device__ int ys(int y, int d) const { return y + d; }
  __device__ bool above(int y) const { return y + 1 < wy; }
};

// Window compute planes of the layout for nt tracers of NQ slots: K3's,
// g, g_post, and the domain bytes' room.
template <int L>
__host__ __device__ inline int coupled_planes(int nt, int nq) {
  return CsfWindow<kCSF, L>::PLANES + 2 * nt * nq + 1;
}

// LOCAL: the local form (K12a with transport), one shard's centre of the
// padded buffers of LG (block2d.cuh); the flow state, the geometry and
// each tracer plane are LG.py x LG.px cells.
template <typename S, int L, int NQ, bool LOCAL = false, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(kBlockThreads, 1)
coupled_block_kernel(const S* __restrict__ s, const S* __restrict__ s2,
                     const C* __restrict__ geo, const C* __restrict__ g,
                     const C* __restrict__ tab, S* __restrict__ out, S* __restrict__ out2,
                     C* __restrict__ g_out, CsfParams P, TracerParams T, BlockShape B,
                     LocalGrid LG, unsigned char* __restrict__ scratch) {
  using Win = CsfWindow<kCSF, L>;
  const int NG = T.nt * NQ;
  const int planes = coupled_planes<L>(T.nt, NQ);
  extern __shared__ __align__(16) unsigned char smem[];
  C* W = window_planes<C>(B, smem, scratch);
  unsigned char* FL = window_fluid(B, smem, scratch, planes, (int)sizeof(C));
  const int nx = P.nx, ny = P.ny;
  // the cells this launch writes (the domain, or the shard's centre) and
  // the cells of a plane
  const int tnx = LOCAL ? LG.nx : nx, tny = LOCAL ? LG.ny : ny;
  const size_t n = LOCAL ? (size_t)LG.py * LG.px : (size_t)ny * nx;
  const int wx = B.wx, wy = B.wy;
  const size_t PL = (size_t)wx * wy;
  const C* GX = W + Win::GX * PL;
  const C* GY = W + Win::GY * PL;
  C* G = W + Win::PLANES * PL;
  C* GP = G + NG * PL;
  unsigned char* DOM = reinterpret_cast<unsigned char*>(GP + NG * PL);

  for (int tile = blockIdx.x; tile < B.ntx * B.nty; tile += gridDim.x) {
    const int x0 = (tile % B.ntx) * B.tx, y0 = (tile / B.ntx) * B.ty;
    const int ox = x0 - B.hx, ly0 = y0 - B.hlo;
    // the global row of window row 0
    const int oy = LOCAL ? LG.row0 + ly0 : ly0;
    auto gidx = [&](int c) {
      if constexpr (LOCAL) return local_index(LG, ly0 + c / wx, ox + c % wx);
      else return (size_t)wrap(oy + c / wx, ny) * nx + wrap(ox + c % wx, nx);
    };
    const WindowView<C> view{GP, FL, DOM, PL, wx, wy, oy, ny};

    // decode the window once
    for (int c = threadIdx.x; c < wx * wy; c += kBlockThreads) {
      const size_t k = gidx(c);
      Cell<C, L> v;
      load_raw<S, L>(s, s2, geo, n, k, v);
      win_put(W, PL, c, v);
      FL[c] = geo[k] > C(0.5);
      for (int q = 0; q < NG; ++q) G[q * PL + c] = g[q * n + k];
    }
    __syncthreads();

    for (int sub = 0; sub < B.T; ++sub) {
      const int e0 = B.ring * sub;
      // the tracer on the fields of the state before the boundary rows
      csf_window_fields<C, L>(W, PL, FL, geo, n, gidx, B, e0, oy, P);
      auto normal_of = [&](int c, C& sx, C& sy) {
        unit_normal(GX[c], GY[c], FL[c] ? C(1) : C(0), P, sx, sy);
      };
      Region r = shrunk(B, e0 + 3);
      for (int t = threadIdx.x; t < r.area(); t += kBlockThreads) {
        const int c = (r.y0 + t / r.w()) * wx + r.x0 + t % r.w();
        Cell<C, L> v;
        win_get(W, PL, c, v);
        C f[9], rr, rb, rho;
        totals(v, f, rr, rb, rho);
        C fx = C(0), fy = C(0);
        if (FL[c]) {
          C nhx, nhy;
          normal_of(c, nhx, nhy);
          csf_force([&](int i, C& sx, C& sy) { normal_of(c + ey(i) * wx + ex(i), sx, sy); },
                    nhx, nhy, GX[c], GY[c], rho, P, fx, fy);
        }
        C ux, uy;
        tracer_velocity(f, rho, fx, fy, ux, uy);
        const bool in_dom = rr < C(T.criteria);
        DOM[c] = in_dom;
        tracer_collide<C, NQ>([&](int tr, int i) { return G[(tr * NQ + i) * PL + c]; },
                              [&](int tr, int i, C val) { GP[(tr * NQ + i) * PL + c] = val; },
                              ux, uy, in_dom, GX[c], GY[c], tab, T);
      }
      __syncthreads();
      r = shrunk(B, e0 + 4);
      for (int t = threadIdx.x; t < r.area(); t += kBlockThreads) {
        const int lx = r.x0 + t % r.w(), ly = r.y0 + t / r.w();
        const int c = ly * wx + lx;
        tracer_stream<C, NQ>(view, tab, T, ny, lx, ly,
                             [&](int tr, int i, C val) { G[(tr * NQ + i) * PL + c] = val; });
      }
      __syncthreads();
      // then the flow: its boundary rows and its sub-step
      window_bc_rows<C, L>(W, PL, FL, shrunk(B, e0), wx, wy, oy, P);
      __syncthreads();
      csf_window_physics<C, L>(W, PL, FL, geo, n, gidx, B, e0, oy, P);
    }

    // encode the tile once
    for (int t = threadIdx.x; t < B.tx * B.ty; t += kBlockThreads) {
      const int x = x0 + t % B.tx, y = y0 + t / B.tx;
      if (x >= tnx || y >= tny) continue;
      const int c = (B.hlo + t / B.tx) * wx + B.hx + t % B.tx;
      const size_t k = LOCAL ? (size_t)(LG.fy + y) * LG.px + LG.fx + x : (size_t)y * nx + x;
      Cell<C, L> v;
      win_get(W, PL, c, v);
      if constexpr (L == kSplit) {
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          out[i * n + k] = v.r[i];
          out2[i * n + k] = v.b[i];
        }
      } else {
        store_state<S>(out, n, k, v.f, v.rr, geo[k]);
      }
      for (int q = 0; q < NG; ++q) g_out[q * n + k] = G[q * PL + c];
    }
    __syncthreads();
  }
}

// The launch's tiling for T sub-steps on layout L with the tracers of T:
// K3's ring (4) and the summed band reaches of flow and tracer rows; the
// domain's, or (LOCAL) the centre's of G, the bands by the global rows.
template <typename S, int L, bool LOCAL = false>
BlockShape coupled_block_shape(const CoupledParams& Q, int T, const LocalGrid& G = LocalGrid{}) {
  using C = typename Traits<S>::C;
  const CsfParams& P = Q.flow;
  const TracerParams& R = Q.tracer;
  const int mlo = (P.inlet != 0 ? 1 : 0) + (R.inlet == 2 || R.inlet == 3 ? 2 : 0);
  const int mhi = (P.outlet != 0 ? 3 : 0) + (R.outlet != 0 ? 3 : 0);
  return block_shape(LOCAL ? G.ny : P.ny, LOCAL ? G.nx : P.nx, T, 4, mlo, mhi,
                     coupled_planes<L>(R.nt, R.nq), (int)sizeof(C), P.ny);
}

template <typename S, int L, int NQ, bool LOCAL = false>
int launch_coupled_block_nq(const void* s_in, const void* s2_in, const void* geo,
                            const void* g_in, const void* tab, void* s_out, void* s2_out,
                            void* g_out, void* scratch, const CoupledParams& Q,
                            const BlockShape& B, cudaStream_t st,
                            const LocalGrid& G = LocalGrid{}) {
  using C = typename Traits<S>::C;
  const size_t smem = B.gmem ? 0 : B.win_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        coupled_block_kernel<S, L, NQ, LOCAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  coupled_block_kernel<S, L, NQ, LOCAL><<<B.grid, kBlockThreads, smem, st>>>(
      static_cast<const S*>(s_in), static_cast<const S*>(s2_in),
      static_cast<const C*>(geo), static_cast<const C*>(g_in), static_cast<const C*>(tab),
      static_cast<S*>(s_out), static_cast<S*>(s2_out), static_cast<C*>(g_out), Q.flow,
      Q.tracer, B, G, static_cast<unsigned char*>(scratch));
  return (int)cudaGetLastError();
}

}  // namespace

namespace {

// -- the local form (K12a with transport) ------------------------------------

template <typename S>
BlockShape coupled_local_shape(const CoupledParams& Q, int T, const LocalGrid& G) {
  return coupled_block_shape<S, kCompressed, true>(Q, T, G);
}

// T coupled steps of one shard: the compressed flow state s_in and the
// tracer PDFs g_in, padded buffers of G, into the centres of s_out and
// g_out; refuses T < 1, a T whose smallest window exceeds kMaxWindow
// cells, the Perturbation flow (no coupled form), the standalone tracer, a
// tracer lattice other than D2Q5 / D2Q9, and a frame of G that does
// not cover the reach.
template <typename S>
int launch_coupled_local(const void* s_in, void* s_out, const void* geo, const void* g_in,
                         void* g_out, const void* tab, void* scratch, const CoupledParams& Q,
                         const LocalGrid& G, int T, cudaStream_t st) {
  if (T < 1 || Q.flow.variant != 0 || Q.tracer.standalone) return (int)cudaErrorInvalidValue;
  const BlockShape B = coupled_local_shape<S>(Q, T, G);
  if (B.wx * B.wy > kMaxWindow) return (int)cudaErrorInvalidValue;  // T too large
  if (B.gmem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (!frame_covers(G, B)) return (int)cudaErrorInvalidValue;
  switch (Q.tracer.nq) {
    case 5:
      return launch_coupled_block_nq<S, kCompressed, 5, true>(
          s_in, nullptr, geo, g_in, tab, s_out, nullptr, g_out, scratch, Q, B, st, G);
    case 9:
      return launch_coupled_block_nq<S, kCompressed, 9, true>(
          s_in, nullptr, geo, g_in, tab, s_out, nullptr, g_out, scratch, Q, B, st, G);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
