// Device code of the phase-confined tracer sub-step of the coupled CSF flow
// + tracer step, D2Q5 or D2Q9, for NVIDIA Hopper (sm_90a), shared by
// coupled2d.cu (K5c/K5s, one step a launch) and coupled2d_block.cuh (K5c-T,
// T steps a launch).  The formulas follow the jnp path
// (TransportRK._transport_substep and ops/transport.py).  Include after
// csf2d.cuh.
//
// The functions read their inputs through accessors, so that the one-step
// kernel (rings of rows in shared memory) and the T-step kernels (the
// row-march's rings, the local forms' windows) run the same arithmetic:
//   tracer_velocity  u = (m + F/2) / rho of a cell;
//   tracer_collide   SRT (J-scheme or linear) or MRT (linear or quadratic
//                    equilibrium) collision of every tracer at a cell, the
//                    beta partition along -g/|g|, the bilinear reaction;
//   tracer_stream    free-flow outlet rows, pull streaming with half-way
//                    bounce-back, hard interface bounce-back and the inlet
//                    rows, all as reads of the post-collision PDFs of a
//                    view (the interface below).

#pragma once

#include "csf2d.cuh"

struct TracerParams {    // mirrored by kernels/transport.py::TracerParams
  int nt, nq;
  int mrt, quadratic;
  int interface;         // 0 none, 1 permeable (beta partition), 2 bounceback
  int inlet;             // 0 none, 1 inamuro, 2 anti_bounce_back, 3 zero
  int outlet;            // 0 none, 1 freeflow
  int reaction;
  int standalone;        // 1: the tracer sub-step only, the flow stays
  int pad;
  double criteria, rate;
};

namespace {

// Per-tracer table row (compute type): tau, beta, stoich, inlet
// concentration, J_0..J_4, then the NQ x NQ MRT update matrix, row-major
// (kernels/transport.py::tracer_table).
constexpr int kTau = 0, kBeta = 1, kStoich = 2, kConc = 3, kJ = 4, kU = 9;

template <int NQ> struct Lat;
// D2Q5, reference ordering: 0 rest, 1 E, 2 W, 3 N, 4 S
template <> struct Lat<5> {
  __device__ static int dx(int i) { return (i == 1) - (i == 2); }
  __device__ static int dy(int i) { return (i == 3) - (i == 4); }
  __device__ static int rev(int i) { return i == 0 ? 0 : (i % 2 ? i + 1 : i - 1); }
  __device__ static double w(int i) { return i == 0 ? 1.0 / 3.0 : 1.0 / 6.0; }
  __device__ static double len(int) { return 1.0; }
};
// D2Q9, the flow's ordering
template <> struct Lat<9> {
  __device__ static int dx(int i) { return ex(i); }
  __device__ static int dy(int i) { return ey(i); }
  __device__ static int rev(int i) { return opp(i); }
  __device__ static double w(int i) { return wq(i); }
  __device__ static double len(int i) { return i >= 5 ? sqrt(2.0) : 1.0; }
};

// The momentum m of a cell's total PDF f.
template <typename C>
__device__ __forceinline__ void tracer_momentum(const C f[9], C& mx, C& my) {
  mx = C(0);
  my = C(0);
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    if (ex(i)) mx = mx + C(ex(i)) * f[i];
    if (ey(i)) my = my + C(ey(i)) * f[i];
  }
}

// u = (m + F/2) / rho of a cell of momentum m (rho guarded).
template <typename C>
__device__ __forceinline__ void tracer_velocity_of(C mx, C my, C rho, C fx, C fy, C& ux,
                                                   C& uy) {
  const C rho_safe = rho > C(0) ? rho : C(1);
  ux = (mx + C(0.5) * fx) / rho_safe;
  uy = (my + C(0.5) * fy) / rho_safe;
}

// u = (m + F/2) / rho of a cell's total PDF f.
template <typename C>
__device__ __forceinline__ void tracer_velocity(const C f[9], C rho, C fx, C fy, C& ux,
                                                C& uy) {
  C mx, my;
  tracer_momentum(f, mx, my);
  tracer_velocity_of(mx, my, rho, fx, fy, ux, uy);
}

// Every tracer's collision, partition and reaction at one cell:
// g_at(t, i) gives the PDFs, put(t, i, v) takes the post-collision ones;
// (gx, gy) is the wetted colour gradient, in_dom the cell's rho_r <
// criteria.  A call may take tracers t0 ... t0 + T.nt - 1 alone (tab at
// tracer t0's row, t counted from t0): the reaction reads tracers 0 and 1
// as g_at(-t0, i) and g_at(1 - t0, i).
template <typename C, int NQ, typename GAt, typename Put>
__device__ __forceinline__ void tracer_collide(GAt g_at, Put put, C ux, C uy, bool in_dom,
                                               C gx, C gy, const C* __restrict__ tab,
                                               const TracerParams& T, int t0 = 0) {
  using LQ = Lat<NQ>;
  // unit inward colour gradient, for the partition
  const C gnorm = sqrt(gx * gx + gy * gy);
  const bool gsafe = gnorm > C(kEps);
  const C igx = gsafe ? -gx / gnorm : C(0);
  const C igy = gsafe ? -gy / gnorm : C(0);

  const int row_len = kU + NQ * NQ;
  auto conc_of = [&](int t) {
    C c = C(0);
#pragma unroll
    for (int i = 0; i < NQ; ++i) c = c + g_at(t, i);
    return c;
  };
  const C react = T.reaction ? C(T.rate) * conc_of(-t0) * conc_of(1 - t0) : C(0);
  const C uu = ux * ux + uy * uy;

  for (int t = 0; t < T.nt; ++t) {
    const C* row = tab + t * row_len;
    C gv[NQ];
    C conc = C(0);
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      gv[i] = g_at(t, i);
      conc = conc + gv[i];
    }
    if (T.mrt) {
      // g += U (g - geq), U = -M^-1 S^-1 M
      C dg[NQ];
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const C eu = C(LQ::dx(i)) * ux + C(LQ::dy(i)) * uy;
        const C fac = T.quadratic
                          ? C(1) + C(3) * eu + C(4.5) * eu * eu - C(1.5) * uu
                          : C(1) + C(3) * eu;
        dg[i] = gv[i] - conc * C(LQ::w(i)) * fac;
      }
      const C* U = row + kU;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        C acc = C(0);
#pragma unroll
        for (int b = 0; b < NQ; ++b) acc = acc + U[i * NQ + b] * dg[b];
        gv[i] = gv[i] + acc;
      }
    } else {
      const C tau = row[kTau];
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const C eu = C(LQ::dx(i)) * ux + C(LQ::dy(i)) * uy;
        const C geq = NQ == 5 ? conc * (row[kJ + i] + C(0.5) * eu)
                              : conc * C(LQ::w(i)) * (C(1) + C(3) * eu);
        gv[i] = gv[i] - (gv[i] - geq) / tau;
      }
    }
    // semi-permeable interface: value = -1 inside the transport domain
    const C beta = row[kBeta];
    if (T.interface == 1 && in_dom && gsafe && beta != C(0)) {
#pragma unroll
      for (int i = 1; i < NQ; ++i) {
        const C cos_i = (C(LQ::dx(i)) * igx + C(LQ::dy(i)) * igy) / C(LQ::len(i));
        gv[i] = gv[i] + (-beta) * (C(LQ::w(i)) * cos_i) * conc;
      }
    }
    if (T.reaction) {
      const C src = row[kStoich] * react;
#pragma unroll
      for (int i = 0; i < NQ; ++i)
        gv[i] = gv[i] + (NQ == 5 ? row[kJ + i] : C(LQ::w(i))) * src;
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) put(t, i, gv[i]);
  }
}

// The stream functions below read the post-collision tracer PDFs through a
// view v: v.post(q, x, y) is slot q = t NQ + i of tracer t at (x, y);
// v.fl(x, y) the fluid plane (0 or 1); v.dom(x, y) the transport-domain
// mask; v.row(y) the global row of y; v.xs(x, d) / v.ys(y, d) the
// neighbour coordinates; v.above(y) whether y has a row above it in the
// view (coupled2d.cu's StripView, march2d.cuh's RingRowView).

// Post-collision value of slot q at (x, y) after the free-flow outlet rows:
// rows 2, 1, 0 each copy the (fresh) row above on fluid cells.
template <typename C, typename V>
__device__ __forceinline__ C post_at(const V& v, const TracerParams& T, int q, int x,
                                     int y) {
  if (T.outlet == 1)
    while (v.row(y) <= 2 && v.fl(x, y) > C(0.5) && v.above(y)) y = v.ys(y, 1);
  return v.post(q, x, y);
}

// Slot i of tracer t at (x, y) after pull streaming with half-way
// bounce-back, masked to the pore space.
template <typename C, int NQ, typename V>
__device__ C streamed_at(const V& v, const TracerParams& T, int t, int i, int x, int y) {
  using L = Lat<NQ>;
  const C fl = v.fl(x, y);
  const int q = t * NQ;
  if (i == 0) return post_at<C>(v, T, q, x, y) * fl;
  const int sx = v.xs(x, -L::dx(i)), sy = v.ys(y, -L::dy(i));
  const C val = v.fl(sx, sy) > C(0.5) ? post_at<C>(v, T, q + i, sx, sy)
                                      : post_at<C>(v, T, q + L::rev(i), x, y);
  return val * fl;
}

// Slot i of tracer t at (x, y) after the hard interface bounce-back: a
// population that streamed out of the transport domain returns into the
// opposite slot of the node it left, and the outside node it reached drops
// it.
template <typename C, int NQ, typename V>
__device__ C repaired_at(const V& v, const TracerParams& T, int t, int i, int x, int y) {
  using L = Lat<NQ>;
  if (T.interface == 2 && i != 0) {
    const int sx = v.xs(x, -L::dx(i)), sy = v.ys(y, -L::dy(i));
    const bool d = v.dom(x, y), ds = v.dom(sx, sy);
    if (d && !ds) return streamed_at<C, NQ>(v, T, t, L::rev(i), sx, sy);
    if (!d && ds) return C(0);
  }
  return streamed_at<C, NQ>(v, T, t, i, x, y);
}

// Every tracer's PDFs at (x, y) after the streaming, the interface
// repair and the inlet rows of global row ny - 1 (Inamuro, anti-bounce-back)
// or ny - 2 (zero concentration), handed to put(t, i, v).
template <typename C, int NQ, typename V, typename Put>
__device__ __forceinline__ void tracer_stream(const V& v, const C* __restrict__ tab,
                                              const TracerParams& T, int ny, int x, int y,
                                              Put put) {
  const bool fluid = v.fl(x, y) > C(0.5);
  const int g = v.row(y);
  // zero-concentration inlet: row ny-2 takes the repaired row ny-3 whole
  const int ys = (T.inlet == 3 && g == ny - 2 && fluid) ? v.ys(y, -1) : y;
  const bool top = g == ny - 1 && fluid;
  for (int t = 0; t < T.nt; ++t) {
    C o[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) o[i] = repaired_at<C, NQ>(v, T, t, i, x, ys);
    const C cin = tab[t * (kU + NQ * NQ) + kConc];
    if (T.inlet == 1 && top) {
      // Inamuro: the unknown -y population absorbs the deficit
      o[4] = cin - (o[0] + o[1] + o[2] + o[3]);
    } else if (T.inlet == 2 && top) {
      // anti-bounce-back from the repaired +y population of row ny-2
      o[4] = -repaired_at<C, NQ>(v, T, t, 3, x, v.ys(y, -1)) + C(2.0 * (1.0 / 6.0)) * cin;
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) put(t, i, o[i]);
  }
}

}  // namespace
