// The row-march of the 2-D colour-gradient T-step kernels for NVIDIA Hopper
// (sm_90a): both variants of K3 (K3c, K3h, K3s; csf2d_block_*.cu) and the
// coupled CSF flow + tracer step K5c-T (coupled2d_block_*.cu).
//
// Replaces the TPU kernel openlbmpm_tpu/pallas/csf.py::build_csf_fused_step
// with steps_per_call = T > 1, variant CSF (_substep :998, _substep_c
// :1033) and variant Perturbation (_substep_pert :1118, _substep_pert_c
// :1246; boundary rows in the window :374, :461), with and without
// transport_params (CSF only: _transport_substep :1385, its rows
// :1454-1500, the order per sub-step :1729-1751), on the compressed
// (f_total, rho_r) state in f32 / f64 or the 11 bf16 planes decoded to f32
// at level 0 and encoded at level T, and on the split (f_r, f_b) state.
//
// The design: march3d.cuh's pipelined march with the rows of the domain in
// the place of the z slabs (the plan of kernels/march2d.py is built on an
// (ny, 1, nx) grid, so a ring row is a row of nx cells and x wraps inside
// it).  One cooperative launch advances T steps; each stage of each level
// is a run of Z rows a wave, a grid barrier between waves.  Only level 0
// is read from device memory and only level T written; the periodic y seam
// is recomputed by unwrapped rows below 0 and above ny - 1, nothing else.
// CSF stages a level (kernels/march2d.py has the plan's side):
//   load     (level 0) the state decoded into the ring st_0;
//   bc       at rows ny-2 and 0 only, one thread a column: the inlet row
//            and its ghost, the Dirichlet outlet row and its ghost or the
//            convective rows 2, 1, 0, in place in st_s (window_bc_rows'
//            order and arithmetic);
//   phi      phi of st_s (fluid cells of rows 0 and 1 take row 2's with the
//            Dirichlet-outlet repair), and on solid cells with wetting the
//            w-weighted mean of phi of the fluid neighbours, num / den ->
//            phi_s;
//   normal   the gradient of phi_s, rotated on wetting fluid cells, and the
//            unit normal -> gn_s (gx, gy, n_x, n_y);
//   collide  the curvature from gn_s around, the CSF force, collide_core
//            and lkr_factors -> po_s (post, frac, A, B);
//   stream   pull streaming with half-way bounce-back of post and the red
//            part frac o_i + w_j e_j . (A, B) of the source cell -> st_{s+1},
//            or at level T the output, encoded.
// K5c-T's levels run first phi and normal again on the state before its
// boundary rows (phiA_s, gnA_s), then
//   tcollide the tracers' collision on those fields (u = (m + F/2) / rho
//            with the CSF force, rho_r < criteria) -> gp_s (the
//            post-collision PDFs and the transport-domain plane);
//   tstream  coupled2d.cuh::tracer_stream on gp_s (free-flow rows,
//            streaming, the interface repair, the inlet rows) -> g_{s+1} or
//            the output;
// and then the flow's stages: the plan puts the boundary stage's in-place
// rewrite after the tracer's reads of the state.  The cell-level bodies
// are csf2d.cuh's and coupled2d.cuh's (the window kernels' arithmetic).
// Perturbation stages a level (pert_march_kernel; load and bc as CSF's):
//   phi      d = rho_r - rho_b of st_s (solid_phi on solid cells) and phi
//            with the Dirichlet-outlet repair -> dp_s (2 planes);
//   collide  the gradient of d from dp_s around (pert2d.cuh::
//            pert_gradient), then pert_collide on st_s at the cell (Grunau
//            tau, the RK-original equilibria, SRT/MRT, the perturbation
//            operator, the RK-original recolouring) -> po_s: post and its
//            red part frac post_i + segb feq_i cos_i (18 planes; the red
//            part is not a few factors a cell, as CSF's is);
//   stream   pull streaming with half-way bounce-back of post and red ->
//            st_{s+1} or the output: the total and rho_r' = sum of the
//            streamed red (compressed), or red and post - red (split).
// The Perturbation K3 ran on block2d.cuh's windows before: a 512-thread
// block an SM recomputing a halo of 2 rings a sub-step (4.5-4.7x K4's step
// a time step at 1024^2, PERF.md); the march recomputes only the seam.
//
// What bounds it: HBM bytes per cell-step are the state (and tracers) read
// once and written once a call over T, plus the geometry; the rings (at
// 1024^2 and 96 rows a wave 32-65 MB at T = 2, 64-130 MB at T = 4) spill
// from the 50 MB L2 to HBM.  The post ring keeps frac, A and B beside
// post (12 planes): post and the red part of each direction (18 planes,
// the stream stage reading 2 values a direction instead of 4) was 4-5%
// slower on an H100 (PERF.md).  The window kernels recomputed their halo every sub-step (2-17x
// the tile at T = 2-4, PERF.md); the march recomputes only the seam's rows
// (a few rows a level) and waits at a grid barrier once a wave.

#pragma once

#include "coupled2d.cuh"
#include "march3d.cuh"
#include "pert2d.cuh"

namespace {

// stage kinds beyond march3d.cuh's (kernels/march2d.py)
constexpr int kStagePhi = 6;
constexpr int kStageTracerCollide = 7;
constexpr int kStageTracerStream = 8;

template <int L>
__host__ __device__ constexpr int march2d_state_planes() {
  return L == kSplit ? 18 : 10;
}

// The ring index of the cell dy rows above and dx columns right of the
// march cell (|dx| <= 1, any dy).
template <typename C>
__device__ __forceinline__ int row_cell(const RingAt<C>& R, int dy, int dx) {
  const int slot = dy >= -1 && dy <= 1 ? R.sb[dy + 1] : mwrap(R.c->u + dy, R.depth) * R.slab;
  return slot + R.c->rr[1] + R.c->cc[dx + 1];
}

// A state ring's cell (dy, dx) in and out of a Cell (ring planes in the
// layout's order: f_r then f_b, or f then rho_r).
template <typename C, int L>
__device__ __forceinline__ void st_get(const RingAt<C>& R, int dy, int dx, Cell<C, L>& v) {
  const C* p = R.base + row_cell(R, dy, dx);
  const size_t st = R.stride;
  if constexpr (L == kSplit) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      v.r[i] = p[i * st];
      v.b[i] = p[(9 + i) * st];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) v.f[i] = p[i * st];
    v.rr = p[9 * st];
  }
}

template <typename C, int L>
__device__ __forceinline__ void st_put(const RingAt<C>& R, int dy, const Cell<C, L>& v) {
  C* p = R.base + row_cell(R, dy, 0);
  const size_t st = R.stride;
  if constexpr (L == kSplit) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      p[i * st] = v.r[i];
      p[(9 + i) * st] = v.b[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) p[i * st] = v.f[i];
    p[9 * st] = v.rr;
  }
}

// The march cell's domain: CsfParams' ny x nx, the geometry planes (fluid,
// wet fluid, ns_x, ns_y, den_inv) and the global index of a neighbour.
template <typename C>
struct Row2 {
  const C* geo;
  int ny, nx;
  size_t n;
  const MarchCell* c;
  // the global index of the cell dy rows above, dx columns right (|dx| <= 1)
  __device__ size_t at(int dy, int dx) const {
    const int gy = dy >= -1 && dy <= 1 ? c->gzz[dy + 1] : mwrap(c->gz + dy, ny);
    return (size_t)gy * nx + c->cc[dx + 1];
  }
  __device__ bool fluid(int dy, int dx) const { return geo[at(dy, dx)] > C(0.5); }
};

// phi of a state cell as win_phase computes it
template <typename C, int L>
__device__ __forceinline__ C cell_phi(const Cell<C, L>& v) {
  C f[9], rr, rb, rho;
  totals(v, f, rr, rb, rho);
  const C tot = rr + rb;
  return tot != C(0) ? (rr - rb) / tot : C(0);
}

// The flow's stages of one march cell; rings as kernels/march2d.py hands
// them: load st_0; bc st_s; phi st_s, phi_s; normal phi_s, gn_s; collide
// st_s, phi_s, gn_s, po_s; stream po_s, st_{s+1} (-1 at the last level:
// the output).
template <typename S, int L, typename C = typename Traits<S>::C>
__device__ __forceinline__ void csf_march_cell(const S* __restrict__ s_in,
                                               const S* __restrict__ s2_in,
                                               const C* __restrict__ geo,
                                               S* __restrict__ s_out, S* __restrict__ s2_out,
                                               const CsfParams& P, const MarchPlan& M,
                                               const MarchCell& c) {
  constexpr int NS = march2d_state_planes<L>();
  const Row2<C> D{geo, P.ny, P.nx, (size_t)P.ny * P.nx, &c};
  const int ny = P.ny;
  const size_t n = D.n;
  const size_t k = D.at(0, 0);
  const bool fluid = geo[k] > C(0.5);
  const int kind = c.kind();
  if (kind == kStageLoad) {
    Cell<C, L> v;
    load_raw<S, L>(s_in, s2_in, geo, n, k, v);
    st_put(M.ring<C>(c.ring(0), c), 0, v);
  } else if (kind == kStageBc) {
    const RingAt<C> R = M.ring<C>(c.ring(0), c);
    // row dst takes row src's state (dst fluid), rows as offsets from the
    // trigger
    auto copy = [&](int dst, int src) {
      const int a = row_cell(R, dst, 0), b = row_cell(R, src, 0);
#pragma unroll
      for (int q = 0; q < NS; ++q) R.base[q * R.stride + a] = R.base[q * R.stride + b];
    };
    if (P.inlet != 0 && c.gz == ny - 2) {
      if (fluid) {
        Cell<C, L> v;
        st_get(R, 0, 0, v);
        apply_inlet(v, P);
        st_put(R, 0, v);
      }
      if (D.fluid(1, 0)) copy(1, 0);
    }
    if (P.outlet == 2 && c.gz == 0) {
      if (D.fluid(1, 0)) {
        Cell<C, L> v;
        st_get(R, 1, 0, v);
        apply_outlet(v, P);
        st_put(R, 1, v);
      }
      if (fluid) copy(0, 1);
    } else if (P.outlet == 1 && c.gz == 0) {
      for (int row = 2; row >= 0; --row)
        if (D.fluid(row, 0)) copy(row, row + 1);
    }
  } else if (kind == kStagePhi) {
    const RingAt<C> R = M.ring<C>(c.ring(0), c);
    // phi of the fluid cell (dy, dx) with the outlet repair
    auto phi_of = [&](int dy, int dx) -> C {
      const int g = mwrap(c.gz + dy, ny);
      if (P.phi_repair && g <= 1) {
        if (!D.fluid(dy + 2 - g, dx)) return C(0);
        dy += 2 - g;
      }
      Cell<C, L> v;
      st_get(R, dy, dx, v);
      return cell_phi(v);
    };
    C phi = C(0);
    if (fluid) {
      phi = phi_of(0, 0);
    } else if (P.has_wetting) {
      // num / den as the reference forms it, den summed from the fluid
      // flags beside num
      C num = C(0), den = C(0);
#pragma unroll
      for (int i = 1; i < 9; ++i) {
        const bool fl = D.fluid(ey(i), ex(i));
        num = num + C(wq(i)) * (fl ? phi_of(ey(i), ex(i)) : C(0));
        den = den + C(wq(i)) * C(fl);
      }
      phi = den > C(0) ? num / den : C(0);
    }
    M.ring<C>(c.ring(1), c).at(0) = phi;
  } else if (kind == kStageNormal) {
    const RingAt<C> PH = M.ring<C>(c.ring(0), c), GN = M.ring<C>(c.ring(1), c);
    C gx = C(0), gy = C(0);
    if (fluid) {
      phi_gradient([&](int i) { return PH.at(0, ey(i), 0, ex(i)); }, gx, gy);
      if (P.has_wetting && geo[n + k] > C(0.5))
        rotate_wetting(gx, gy, geo[2 * n + k], geo[3 * n + k], P);
    }
    C sx, sy;
    unit_normal(gx, gy, fluid ? C(1) : C(0), P, sx, sy);
    GN.at(0) = gx;
    GN.at(1) = gy;
    GN.at(2) = sx;
    GN.at(3) = sy;
  } else if (kind == kStageCollide) {
    const RingAt<C> ST = M.ring<C>(c.ring(0), c), PH = M.ring<C>(c.ring(1), c);
    const RingAt<C> GN = M.ring<C>(c.ring(2), c), PO = M.ring<C>(c.ring(3), c);
    C post[9], frac = C(0), A = C(0), Bv = C(0);
    if (fluid) {
      Cell<C, L> v;
      st_get(ST, 0, 0, v);
      C f[9], rr, rb, rho;
      totals(v, f, rr, rb, rho);
      const C gx = GN.at(0), gy = GN.at(1);
      C fx, fy, segc;
      csf_force(
          [&](int i, C& sx, C& sy) {
            sx = GN.at(2, ey(i), 0, ex(i));
            sy = GN.at(3, ey(i), 0, ex(i));
          },
          GN.at(2), GN.at(3), gx, gy, rho, P, fx, fy);
      collide_core(f, rr, rb, rho, PH.at(0), fx, fy, P, post, frac, segc);
      lkr_factors(segc, gx, gy, A, Bv);
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) post[i] = C(0);
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) PO.at(i) = post[i];
    PO.at(9) = frac;
    PO.at(10) = A;
    PO.at(11) = Bv;
  } else if (kind == kStageStream) {
    const RingAt<C> PO = M.ring<C>(c.ring(0), c);
    const size_t ps = PO.stride;
    // o: the streamed total PDF; red: its red part, frac o + seg at the
    // source cell (the blue part is o - red)
    C o[9], red[9];
    C rr_new = C(0);
    if (fluid) {
      const C* own = PO.base + PO.cell(0, 0, 0);
      o[0] = own[0];
      red[0] = own[9 * ps] * o[0];
      rr_new = red[0];
#pragma unroll
      for (int i = 1; i < 9; ++i) {
        // pull from the upwind cell x - e_i, or bounce back from a solid one
        const bool up = D.fluid(-ey(i), -ex(i));
        const C* p = up ? PO.base + PO.cell(-ey(i), 0, -ex(i)) : own;
        const int j = up ? i : opp(i);
        o[i] = p[j * ps];
        const C seg = C(wq(j)) * (C(ex(j)) * p[10 * ps] + C(ey(j)) * p[11 * ps]);
        red[i] = p[9 * ps] * o[i] + seg;
        rr_new = rr_new + red[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) o[i] = red[i] = C(0);
    }
    if (c.ring(1) < 0) {
      if constexpr (L == kSplit) {
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          s_out[i * n + k] = red[i];
          s2_out[i * n + k] = o[i] - red[i];
        }
      } else {
        store_state<S>(s_out, n, k, o, rr_new, geo[k]);
      }
    } else {
      Cell<C, L> v;
      if constexpr (L == kSplit) {
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          v.r[i] = red[i];
          v.b[i] = o[i] - red[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 9; ++i) v.f[i] = o[i];
        v.rr = rr_new;
      }
      st_put(M.ring<C>(c.ring(1), c), 0, v);
    }
  }
}

// The Perturbation variant's stages of one march cell; rings as
// kernels/march2d.py::pert2d_stages hands them: load st_0 and bc st_s as
// csf_march_cell; phi st_s, dp_s; collide st_s, dp_s, po_s; stream po_s,
// st_{s+1} (-1 at the last level: the output).
template <typename S, int L, typename C = typename Traits<S>::C>
__device__ __forceinline__ void pert_march_cell(const S* __restrict__ s_in,
                                                const S* __restrict__ s2_in,
                                                const C* __restrict__ geo,
                                                S* __restrict__ s_out, S* __restrict__ s2_out,
                                                const CsfParams& P, const MarchPlan& M,
                                                const MarchCell& c) {
  const int kind = c.kind();
  if (kind == kStageLoad || kind == kStageBc) {
    csf_march_cell<S, L>(s_in, s2_in, geo, s_out, s2_out, P, M, c);
    return;
  }
  const Row2<C> D{geo, P.ny, P.nx, (size_t)P.ny * P.nx, &c};
  const size_t n = D.n;
  const size_t k = D.at(0, 0);
  const bool fluid = geo[k] > C(0.5);
  if (kind == kStagePhi) {
    const RingAt<C> R = M.ring<C>(c.ring(0), c), DP = M.ring<C>(c.ring(1), c);
    C d = C(P.solid_phi), phi = C(0);
    if (fluid) {
      Cell<C, L> v;
      st_get(R, 0, 0, v);
      C f[9], rr, rb, rho;
      totals(v, f, rr, rb, rho);
      d = rr - rb;
      // the Dirichlet-outlet repair: fluid cells of rows 0 and 1 take row
      // 2's phi (0 where row 2 is solid)
      if (P.phi_repair && c.gz <= 1) {
        const int up = 2 - c.gz;
        if (D.fluid(up, 0)) {
          st_get(R, up, 0, v);
          phi = cell_phi(v);
        }
      } else {
        phi = cell_phi(v);
      }
    }
    DP.at(0) = d;
    DP.at(1) = phi;
  } else if (kind == kStageCollide) {
    const RingAt<C> ST = M.ring<C>(c.ring(0), c), DP = M.ring<C>(c.ring(1), c);
    const RingAt<C> PO = M.ring<C>(c.ring(2), c);
    C post[9], red[9];
    if (fluid) {
      Cell<C, L> v;
      st_get(ST, 0, 0, v);
      C gx, gy;
      pert_gradient([&](int i) { return DP.at(0, ey(i), 0, ex(i)); }, P, gx, gy);
      pert_collide(v, DP.at(1), gx, gy, P, post, red);
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) post[i] = red[i] = C(0);
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      PO.at(i) = post[i];
      PO.at(9 + i) = red[i];
    }
  } else if (kind == kStageStream) {
    const RingAt<C> PO = M.ring<C>(c.ring(0), c);
    const size_t ps = PO.stride;
    // o: the streamed total PDF, red: its streamed red part
    C o[9], red[9];
    C rr_new = C(0);
    if (fluid) {
      const C* own = PO.base + PO.cell(0, 0, 0);
      o[0] = own[0];
      red[0] = own[9 * ps];
      rr_new = red[0];
#pragma unroll
      for (int i = 1; i < 9; ++i) {
        // pull from the upwind cell x - e_i, or bounce back from a solid one
        const bool up = D.fluid(-ey(i), -ex(i));
        const C* p = up ? PO.base + PO.cell(-ey(i), 0, -ex(i)) : own;
        const int j = up ? i : opp(i);
        o[i] = p[j * ps];
        red[i] = p[(9 + j) * ps];
        rr_new = rr_new + red[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) o[i] = red[i] = C(0);
    }
    if (c.ring(1) < 0) {
      if constexpr (L == kSplit) {
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          s_out[i * n + k] = red[i];
          s2_out[i * n + k] = o[i] - red[i];
        }
      } else {
        store_state<S>(s_out, n, k, o, rr_new, geo[k]);
      }
    } else {
      Cell<C, L> v;
      if constexpr (L == kSplit) {
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          v.r[i] = red[i];
          v.b[i] = o[i] - red[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 9; ++i) v.f[i] = o[i];
        v.rr = rr_new;
      }
      st_put(M.ring<C>(c.ring(1), c), 0, v);
    }
  }
}

// The tracer stream's view of a gp ring (coupled2d.cuh's view
// interface): rows are unwrapped march rows, their ring slot row mod depth;
// the transport-domain plane follows the ng PDF planes.
template <typename C>
struct RingRowView {
  const C* base;
  size_t stride;
  int depth, slab, ng;
  const C* geo;
  int nx, ny;
  __device__ size_t idx(int x, int y) const { return (size_t)mwrap(y, depth) * slab + x; }
  __device__ C post(int q, int x, int y) const { return base[q * stride + idx(x, y)]; }
  __device__ C fl(int x, int y) const {
    return geo[(size_t)mwrap(y, ny) * nx + x] > C(0.5) ? C(1) : C(0);
  }
  __device__ bool dom(int x, int y) const { return base[ng * stride + idx(x, y)] > C(0.5); }
  __device__ int row(int y) const { return mwrap(y, ny); }
  __device__ int xs(int x, int d) const { return wrap(x + d, nx); }
  __device__ int ys(int y, int d) const { return y + d; }
  __device__ bool above(int) const { return true; }
};

// The tracer's stages of one march cell: tcollide st_s, gnA_s, g_s (-1 at
// level 0: the input), gp_s; tstream gp_s, g_{s+1} (-1 at the last level:
// the output).
template <typename S, int L, int NQ, typename C = typename Traits<S>::C>
__device__ __forceinline__ void tracer_march_cell(const C* __restrict__ geo,
                                                  const C* __restrict__ g_in,
                                                  const C* __restrict__ tab,
                                                  C* __restrict__ g_out, const CsfParams& P,
                                                  const TracerParams& T, const MarchPlan& M,
                                                  const MarchCell& c) {
  const Row2<C> D{geo, P.ny, P.nx, (size_t)P.ny * P.nx, &c};
  const size_t n = D.n;
  const size_t k = D.at(0, 0);
  const int NG = T.nt * NQ;
  if (c.kind() == kStageTracerCollide) {
    const RingAt<C> ST = M.ring<C>(c.ring(0), c), GN = M.ring<C>(c.ring(1), c);
    const RingAt<C> G = M.ring<C>(c.ring(2), c), GP = M.ring<C>(c.ring(3), c);
    Cell<C, L> v;
    st_get(ST, 0, 0, v);
    C f[9], rr, rb, rho;
    totals(v, f, rr, rb, rho);
    const C gx = GN.at(0), gy = GN.at(1);
    C fx = C(0), fy = C(0);
    if (geo[k] > C(0.5))
      csf_force(
          [&](int i, C& sx, C& sy) {
            sx = GN.at(2, ey(i), 0, ex(i));
            sy = GN.at(3, ey(i), 0, ex(i));
          },
          GN.at(2), GN.at(3), gx, gy, rho, P, fx, fy);
    C ux, uy;
    tracer_velocity(f, rho, fx, fy, ux, uy);
    const bool in_dom = rr < C(T.criteria);
    const bool first = c.ring(2) < 0;
    tracer_collide<C, NQ>(
        [&](int tr, int i) { return first ? g_in[(tr * NQ + i) * n + k] : G.at(tr * NQ + i); },
        [&](int tr, int i, C val) { GP.at(tr * NQ + i) = val; }, ux, uy, in_dom, gx, gy, tab,
        T);
    GP.at(NG) = in_dom ? C(1) : C(0);
  } else {
    const RingAt<C> GP = M.ring<C>(c.ring(0), c);
    const RingRowView<C> view{GP.base, GP.stride, GP.depth, GP.slab, NG, geo, P.nx, P.ny};
    const bool last = c.ring(1) < 0;
    const RingAt<C> G = M.ring<C>(c.ring(1), c);
    tracer_stream<C, NQ>(view, tab, T, P.ny, c.x, c.u, [&](int tr, int i, C val) {
      if (last)
        g_out[(tr * NQ + i) * n + k] = val;
      else
        G.at(tr * NQ + i) = val;
    });
  }
}

// Resident blocks an SM the march kernels ask ptxas for: 3 in float
// arithmetic (80 registers; 1, 2 and 4 were slower at 1024^2 on an H100,
// PERF.md), 1 for the f64 check instances.
template <typename S>
constexpr int march2d_min_blocks() {
  return sizeof(typename Traits<S>::C) == 8 ? 1 : 3;
}

template <typename S, int L, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(kMarchThreads, march2d_min_blocks<S>())
csf_march_kernel(const S* __restrict__ s_in, const S* __restrict__ s2_in,
                 const C* __restrict__ geo, S* __restrict__ s_out, S* __restrict__ s2_out,
                 CsfParams P, const long long* __restrict__ plan,
                 unsigned char* __restrict__ scratch) {
  MarchPlan M{plan, scratch, nullptr, nullptr, nullptr};
  march_run(M, [&](const MarchCell& c) {
    csf_march_cell<S, L>(s_in, s2_in, geo, s_out, s2_out, P, M, c);
  });
}

template <typename S, int L, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(kMarchThreads, march2d_min_blocks<S>())
pert_march_kernel(const S* __restrict__ s_in, const S* __restrict__ s2_in,
                  const C* __restrict__ geo, S* __restrict__ s_out, S* __restrict__ s2_out,
                  CsfParams P, const long long* __restrict__ plan,
                  unsigned char* __restrict__ scratch) {
  MarchPlan M{plan, scratch, nullptr, nullptr, nullptr};
  march_run(M, [&](const MarchCell& c) {
    pert_march_cell<S, L>(s_in, s2_in, geo, s_out, s2_out, P, M, c);
  });
}

template <typename S, int L, int NQ, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(kMarchThreads, march2d_min_blocks<S>())
coupled_march_kernel(const S* __restrict__ s_in, const S* __restrict__ s2_in,
                     const C* __restrict__ geo, const C* __restrict__ g_in,
                     const C* __restrict__ tab, S* __restrict__ s_out,
                     S* __restrict__ s2_out, C* __restrict__ g_out, CsfParams P,
                     TracerParams T, const long long* __restrict__ plan,
                     unsigned char* __restrict__ scratch) {
  MarchPlan M{plan, scratch, nullptr, nullptr, nullptr};
  march_run(M, [&](const MarchCell& c) {
    const int kind = c.kind();
    if (kind == kStageTracerCollide || kind == kStageTracerStream)
      tracer_march_cell<S, L, NQ>(geo, g_in, tab, g_out, P, T, M, c);
    else
      csf_march_cell<S, L>(s_in, s2_in, geo, s_out, s2_out, P, M, c);
  });
}

// Whether a layout (kCompressed / kSplit) names an instance of storage S.
template <typename S>
bool march2d_takes(int split) {
  if (split && Traits<S>::kShifted) return false;   // no split bf16 layout
  return split == 0 || split == 1;
}

// One launch of K3's march (T steps on the plan `plan` in device memory,
// its rings in `scratch`) of the variant P.variant (0 CSF, 1
// Perturbation): split = 0 the compressed state in s_in / s_out, 1 f_r in
// s_in / s_out and f_b in s2_in / s2_out.
template <typename S>
int launch_csf_march(int split, const void* s_in, const void* s2_in, void* s_out,
                     void* s2_out, const void* geo, void* scratch, const void* plan,
                     const CsfParams& P, cudaStream_t st) {
  using C = typename Traits<S>::C;
  if (!march2d_takes<S>(split) || (P.variant != 0 && P.variant != 1) || scratch == nullptr ||
      plan == nullptr)
    return (int)cudaErrorInvalidValue;
  const S* a = static_cast<const S*>(s_in);
  const S* b = static_cast<const S*>(s2_in);
  const C* g = static_cast<const C*>(geo);
  S* oa = static_cast<S*>(s_out);
  S* ob = static_cast<S*>(s2_out);
  const long long* pl = static_cast<const long long*>(plan);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  CsfParams p = P;
  void* args[] = {&a, &b, &g, &oa, &ob, &p, &pl, &sc};
  const bool pert = P.variant == 1;
  if constexpr (!Traits<S>::kShifted) {
    if (split)
      return pert ? march_launch(pert_march_kernel<S, kSplit>, args, st)
                  : march_launch(csf_march_kernel<S, kSplit>, args, st);
  }
  return pert ? march_launch(pert_march_kernel<S, kCompressed>, args, st)
              : march_launch(csf_march_kernel<S, kCompressed>, args, st);
}

// The cooperative grid of K3's instance for the layout `split` and the
// variant `pert`.
template <typename S>
int csf_march_grid_of(int split, bool pert, int* grid) {
  if (!march2d_takes<S>(split)) return (int)cudaErrorInvalidValue;
  if constexpr (!Traits<S>::kShifted) {
    if (split)
      return pert ? march_grid(pert_march_kernel<S, kSplit>, grid)
                  : march_grid(csf_march_kernel<S, kSplit>, grid);
  }
  return pert ? march_grid(pert_march_kernel<S, kCompressed>, grid)
              : march_grid(csf_march_kernel<S, kCompressed>, grid);
}

template <typename S, int L, int NQ>
int launch_coupled_march_l(const void* s_in, const void* s2_in, const void* geo,
                           const void* g_in, const void* tab, void* s_out, void* s2_out,
                           void* g_out, void* scratch, const void* plan, const CsfParams& P,
                           const TracerParams& T, cudaStream_t st) {
  using C = typename Traits<S>::C;
  const S* a = static_cast<const S*>(s_in);
  const S* b = static_cast<const S*>(s2_in);
  const C* g = static_cast<const C*>(geo);
  const C* gi = static_cast<const C*>(g_in);
  const C* tb = static_cast<const C*>(tab);
  S* oa = static_cast<S*>(s_out);
  S* ob = static_cast<S*>(s2_out);
  C* go = static_cast<C*>(g_out);
  const long long* pl = static_cast<const long long*>(plan);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  CsfParams p = P;
  TracerParams t = T;
  void* args[] = {&a, &b, &g, &gi, &tb, &oa, &ob, &go, &p, &t, &pl, &sc};
  return march_launch(coupled_march_kernel<S, L, NQ>, args, st);
}

// One launch of K5c-T's march; refuses the Perturbation flow, the
// standalone tracer and a tracer lattice other than D2Q5 / D2Q9.
template <typename S>
int launch_coupled_march(int split, const void* s_in, const void* s2_in, const void* geo,
                         const void* g_in, const void* tab, void* s_out, void* s2_out,
                         void* g_out, void* scratch, const void* plan, const CsfParams& P,
                         const TracerParams& T, cudaStream_t st) {
  if (!march2d_takes<S>(split) || P.variant != 0 || T.standalone || scratch == nullptr ||
      plan == nullptr || (T.nq != 5 && T.nq != 9))
    return (int)cudaErrorInvalidValue;
  if constexpr (!Traits<S>::kShifted) {
    if (split)
      return T.nq == 5 ? launch_coupled_march_l<S, kSplit, 5>(s_in, s2_in, geo, g_in, tab,
                                                              s_out, s2_out, g_out, scratch,
                                                              plan, P, T, st)
                       : launch_coupled_march_l<S, kSplit, 9>(s_in, s2_in, geo, g_in, tab,
                                                              s_out, s2_out, g_out, scratch,
                                                              plan, P, T, st);
  }
  return T.nq == 5 ? launch_coupled_march_l<S, kCompressed, 5>(s_in, s2_in, geo, g_in, tab,
                                                               s_out, s2_out, g_out, scratch,
                                                               plan, P, T, st)
                   : launch_coupled_march_l<S, kCompressed, 9>(s_in, s2_in, geo, g_in, tab,
                                                               s_out, s2_out, g_out, scratch,
                                                               plan, P, T, st);
}

// The cooperative grid of K5c-T's instance: which = 10 split + nq.
template <typename S>
int coupled_march_grid_of(int which, int* grid) {
  const int split = which / 10, nq = which % 10;
  if (!march2d_takes<S>(split) || (nq != 5 && nq != 9)) return (int)cudaErrorInvalidValue;
  if constexpr (!Traits<S>::kShifted) {
    if (split)
      return nq == 5 ? march_grid(coupled_march_kernel<S, kSplit, 5>, grid)
                     : march_grid(coupled_march_kernel<S, kSplit, 9>, grid);
  }
  return nq == 5 ? march_grid(coupled_march_kernel<S, kCompressed, 5>, grid)
                 : march_grid(coupled_march_kernel<S, kCompressed, 9>, grid);
}

}  // namespace

// The march's C entry points of K3 (both variants) for one storage type S
// whose state modes (csf2d_step's codes) are MC (compressed) and MS (split,
// -1: none); the grid's `which` is 10 variant + mode.
#define CSF2D_MARCH_ENTRY_POINTS(S, MC, MS)                                                 \
  extern "C" int csf2d_march_step(int mode, int T, const void* s_in, const void* s2_in,    \
                                  void* s_out, void* s2_out, const void* geo,              \
                                  void* scratch, const void* plan,                         \
                                  const CsfParams* params, void* stream) {                 \
    if (T < 1 || (mode != MC && mode != MS)) return (int)cudaErrorInvalidValue;             \
    return launch_csf_march<S>(mode == MS, s_in, s2_in, s_out, s2_out, geo, scratch, plan, \
                               *params, static_cast<cudaStream_t>(stream));                \
  }                                                                                         \
  extern "C" int csf2d_march_grid(int which, int* grid) {                                  \
    const int mode = which % 10;                                                            \
    if ((mode != MC && mode != MS) || which / 10 > 1) return (int)cudaErrorInvalidValue;    \
    return csf_march_grid_of<S>(mode == MS, which / 10 == 1, grid);                         \
  }                                                                                         \
  extern "C" int csf2d_march_limits(long long* out) {                                      \
    out[0] = kMarchMaxStages;                                                               \
    out[1] = kMarchMaxRings;                                                                \
    return 0;                                                                               \
  }                                                                                         \
  extern "C" const char* csf2d_block_error_string(int code) {                              \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                              \
  }

// The march's C entry points of K5c-T for one storage type S whose state
// modes are MC (compressed) and MS (split, -1: none); the grid's `which` is
// 10 mode + nq.
#define COUPLED2D_MARCH_ENTRY_POINTS(S, MC, MS)                                             \
  extern "C" int coupled2d_march_step(int mode, int T, const void* s_in, const void* s2_in, \
                                      void* s_out, void* s2_out, const void* geo,          \
                                      const void* g_in, void* g_out, const void* tab,      \
                                      void* scratch, const void* plan,                     \
                                      const CoupledParams* params, void* stream) {         \
    if (T < 1 || (mode != MC && mode != MS)) return (int)cudaErrorInvalidValue;             \
    return launch_coupled_march<S>(mode == MS, s_in, s2_in, geo, g_in, tab, s_out, s2_out, \
                                   g_out, scratch, plan, params->flow, params->tracer,     \
                                   static_cast<cudaStream_t>(stream));                     \
  }                                                                                         \
  extern "C" int coupled2d_march_grid(int which, int* grid) {                              \
    const int mode = which / 10;                                                            \
    if (mode != MC && mode != MS) return (int)cudaErrorInvalidValue;                        \
    return coupled_march_grid_of<S>((mode == MS) * 10 + which % 10, grid);                  \
  }                                                                                         \
  extern "C" const char* coupled2d_block_error_string(int code) {                          \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                              \
  }
