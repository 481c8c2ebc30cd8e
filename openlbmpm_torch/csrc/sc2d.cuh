// Shan-Chen multicomponent step (K8), D2Q9, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel openlbmpm_tpu/pallas/shanchen.py::
// build_sc_fused_step at steps_per_call=1 on one device: the original
// Shan-Chen scheme (its _substep) and the explicit-forcing scheme EFS
// (_substep_efs, iso-4/8/10 stencils), SRT or MRT, psi = rho or the
// Peng-Robinson EOS, with the Zou-He velocity / pressure inlet and the
// Zou-He pressure / convective outlet rows, for K = 1, 2 or 3 fluids.  The
// state is f (K, 9, ny, nx) in f32 or f64, or (K, 11, ny, nx) bf16: per
// fluid the deviations f_i - w_i rho_k and rho_k as a hi/lo bf16 pair,
// decoded to f32 registers and rounded to nearest-even on the way out.
// Each of sc2d_f64.cu, sc2d_f32.cu and sc2d_bf16.cu instantiates one
// storage type, so the three libraries build side by side.
//
// One step, in the op order of the plain step (ShanChenMCMP._step_sc /
// _step_efs, and pallas/shanchen.py:721-740): inlet rows -> rho_k and psi_k
// (zero on solid) -> SC: the common velocity u', the D2Q9-weight force plus
// G_s adhesion, u_eq = u' + tau F / rho, SRT or MRT toward feq(u_eq); EFS:
// the difference-form iso-stencil force, the shared equilibrium velocity,
// the force PDF f^F and f + (feq - f - f^F/2)/tau + f^F (SRT) or its
// M^-1 S M form (MRT) -> body force (inside F) -> pull streaming with
// half-way bounce-back, masked to the fluid -> outlet rows.  The formulas
// follow the plain path, not the TPU kernel's strip windows or its
// closed-form MRT moments: MRT here is the dense M^-1 S M of ops/collision.py
// (Lallemand-Luo M, whose rows are orthogonal).
//
// f32 and f64 storage: one launch a step, sc_push_kernel, and with an
// outlet a second small one, sc_outlet_kernel.  A block owns a 32x8 tile,
// one thread a cell, x fastest (coalesced).  It fills psi_k (zero on solid
// cells) and the fluid flags of the tile plus an R-cell ring (R = the force
// stencil's reach: 1, 2 for iso-8, 3 for iso-10) into shared memory from
// the state, the inlet rows applied on the fly to each loaded cell
// (load_state).  After one barrier each fluid cell loads its K x 9 values
// again (from L1 or L2), forms rho_k, the momenta, the forces and the
// common velocity as sc_collide does, then collides one fluid at a time
// (sc_collide_fluid) and pushes post_i into slot i of x + e_i, or into slot
// opp(i) of x where x + e_i is solid; a solid cell writes its own zeros.
// So each output slot is written exactly once, by the thread whose pull
// would have read it (flow3d.cuh's sc_push_kernel in 2-D).  A push never
// holds the streamed values of row d, so the outlet rows (the Zou-He row d
// and its ghosts below, or the convective rows d + 1 ... 0, each copying
// the row above) are rewritten in place by sc_outlet_kernel, one thread a
// column, after the push.
//
// bf16 storage cannot push: the encoding of an output cell needs its rho,
// the sum of its 9 streamed values.  It pulls, in one launch too,
// collide_stream_kernel, one thread per cell of a 32x8 tile: psi_k of the
// tile plus an (R + 1)-cell ring formed from the state (load_state, the
// inlet rows on the fly) into shared memory, the collision of the tile plus
// a one-cell ring into shared memory (the ring is recomputed by each
// neighbouring tile), then pull streaming from there.  The tiles of the
// first tile row also apply the outlet rows (rows 0 ... d + 2 <= 5 lie
// inside them): the streamed cells go back to shared memory and each outlet
// cell takes its Zou-He rewrite or its copy source from there.  So the bf16
// state is rounded once per step.  (A separate pass writing psi to a
// scratch the pull read took 8-14% longer at 1024^2 on an H100, PERF.md.)
//
// What bounds it: HBM bytes per cell-step.  One fused pass moves the state
// in and out, 144 B (K = 2, f32), 88 B (bf16) or 288 B (f64), plus the
// geometry planes (3 for SC, 5 for EFS).  Both forms read the state twice
// (the ring fill, then the collision, mostly from L2) and write it once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

constexpr int kScMaxFluids = 3;

struct ScParams {      // mirrored by kernels/shanchen.py::ScParams
  int ny, nx;
  int k;               // fluids, 1 ... kScMaxFluids
  int order;           // 0 original SC (D2Q9 weights), 4 | 8 | 10 EFS
  int inlet;           // 0 periodic, 1 zou_he_velocity, 2 zou_he_pressure
  int outlet;          // 0 periodic, 1 zou_he_pressure, 2 convective
  int depth;           // d: the inlet row is ny-1-d, the outlet row d
  int mrt;
  int psi_pr;          // 0 psi = rho, 1 Peng-Robinson
  int pad;
  double tau[kScMaxFluids], inv_tau[kScMaxFluids];
  double g[kScMaxFluids][kScMaxFluids];
  double gs[kScMaxFluids];
  double inlet_v[kScMaxFluids], inlet_rho[kScMaxFluids], outlet_rho[kScMaxFluids];
  double bfx, bfy;
  // Peng-Robinson: const_r, T, a*alpha, b, 2b, b*b, 2/(c0 g)
  double pr_cr, pr_t, pr_aa, pr_b, pr_2b, pr_bb, pr_k2;
};

namespace {

constexpr int TX = 32;
constexpr int TY = 8;

// D2Q9, reference ordering: 0 rest, 1 E, 2 N, 3 W, 4 S, 5 NE, 6 NW, 7 SW, 8 SE
__host__ __device__ constexpr int ex(int i) {
  return (i == 1 || i == 5 || i == 8) - (i == 3 || i == 6 || i == 7);
}
__host__ __device__ constexpr int ey(int i) {
  return (i == 2 || i == 5 || i == 6) - (i == 4 || i == 7 || i == 8);
}
__host__ __device__ constexpr int opp(int i) {
  return i == 0 ? 0 : (i < 5 ? (i + 1) % 4 + 1 : (i - 3) % 4 + 5);
}
__host__ __device__ constexpr double wq(int i) {
  return i == 0 ? 4.0 / 9.0 : (i < 5 ? 1.0 / 9.0 : 1.0 / 36.0);
}
// Lallemand-Luo moment matrix (lattice.py::_d2q9_mrt_matrix); its rows are
// orthogonal, so M^-1[i][a] = M[a][i] / |M_a|^2.
__host__ __device__ constexpr int mm(int a, int b) {
  constexpr signed char M[9][9] = {
      {1, 1, 1, 1, 1, 1, 1, 1, 1},       {-4, -1, -1, -1, -1, 2, 2, 2, 2},
      {4, -2, -2, -2, -2, 1, 1, 1, 1},   {0, 1, 0, -1, 0, 1, -1, -1, 1},
      {0, -2, 0, 2, 0, 1, -1, -1, 1},    {0, 0, 1, 0, -1, 1, 1, -1, -1},
      {0, 0, -2, 0, 2, 1, 1, -1, -1},    {0, 1, -1, 1, -1, 0, 0, 0, 0},
      {0, 0, 0, 0, 0, 1, -1, 1, -1}};
  return M[a][b];
}
__host__ __device__ constexpr double mnorm(int a) {
  constexpr signed char N[9] = {9, 36, 36, 6, 12, 6, 12, 4, 4};
  return N[a];
}
// Shan-Chen MRT rates (ops/collision.py::mrt_relaxation_d2q9_sc) of the
// non-conserved moments 1, 2, 4, 6; the shear moments 7, 8 relax at 1/tau_k
__host__ __device__ constexpr double s_sc(int a) {
  return a == 1 ? 0.6 : a == 2 ? 1.5 : (a == 4 || a == 6) ? 1.2 : 0.0;
}

// Interaction-stencil weight w(|c|^2) (lattice.py::_iso_stencil); order 0
// is the original SC force's D2Q9 weights on the nearest neighbours.
__host__ __device__ constexpr double iso_w(int order, int c2) {
  return order == 0 ? (c2 == 1 ? 1.0 / 9.0 : c2 == 2 ? 1.0 / 36.0 : 0.0)
       : order == 4 ? (c2 == 1 ? 1.0 / 3.0 : c2 == 2 ? 1.0 / 12.0 : 0.0)
       : order == 8 ? (c2 == 1 ? 4.0 / 21.0 : c2 == 2 ? 4.0 / 45.0
                       : c2 == 4 ? 1.0 / 60.0 : c2 == 5 ? 2.0 / 315.0
                       : c2 == 8 ? 1.0 / 5040.0 : 0.0)
       : (c2 == 1 ? 262.0 / 1785.0 : c2 == 2 ? 93.0 / 1190.0
          : c2 == 4 ? 7.0 / 340.0 : c2 == 5 ? 6.0 / 595.0
          : c2 == 8 ? 9.0 / 9520.0 : c2 == 9 ? 2.0 / 5355.0
          : c2 == 10 ? 1.0 / 7140.0 : 0.0);
}
__host__ __device__ constexpr int reach(int order) {
  return order == 8 ? 2 : order == 10 ? 3 : 1;
}

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// Launches of collide_stream_kernel (bf16), sc_push_kernel and
// sc_outlet_kernel (f32, f64) by this library since it was loaded, one
// where each launch is made; sc2d_kernel_launches reads them.
long long g_launches[3];

// Storage type S -> compute type C; bf16 storage holds f_i - w_i rho_k
// (planes 0-8) and rho_k as hi + lo (planes 9, 10) per fluid.
template <typename S> struct Traits {
  using C = S;
  static constexpr bool kShifted = false;
  static constexpr int kPlanes = 9;
};
template <> struct Traits<__nv_bfloat16> {
  using C = float;
  static constexpr bool kShifted = true;
  static constexpr int kPlanes = 11;
};

__device__ __forceinline__ float to_c(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_c(float v) { return v; }
__device__ __forceinline__ double to_c(double v) { return v; }

template <typename C>
__device__ __forceinline__ C sum9(const C f[9]) {
  C r = f[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) r = r + f[i];
  return r;
}

// All K fluids' populations of cell idx as stored.
template <typename S, int K, typename C = typename Traits<S>::C>
__device__ __forceinline__ void load_raw(const S* __restrict__ f, size_t n, size_t idx,
                                         C F[K][9]) {
  constexpr int NP = Traits<S>::kPlanes;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const S* b = f + (size_t)k * NP * n;
    if constexpr (Traits<S>::kShifted) {
      const C rho = to_c(b[9 * n + idx]) + to_c(b[10 * n + idx]);
#pragma unroll
      for (int i = 0; i < 9; ++i) F[k][i] = to_c(b[i * n + idx]) + C(wq(i)) * rho;
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) F[k][i] = to_c(b[i * n + idx]);
    }
  }
}

// Zou-He inlet row of one fluid (ops/boundaries.py::zou_he_velocity_top at
// velocity v for kind 1, zou_he_pressure_top at density rho_t for kind 2);
// unknowns f4, f7, f8.
template <typename C>
__device__ __forceinline__ void inlet_zou_he(C f[9], int kind, double v, double rho_t) {
  const C d13 = C(0.5) * (f[1] - f[3]);
  const C known = f[0] + f[1] + f[3] + C(2) * (f[2] + f[5] + f[6]);
  if (kind == 1) {
    const C vy = C(v);
    const C rho = known / (C(1) + vy);
    f[4] = f[2] - C(2.0 / 3.0) * rho * vy;
    f[7] = f[5] + d13 - rho * vy / C(6);
    f[8] = f[6] - d13 - rho * vy / C(6);
  } else {
    const C rt = C(rho_t);
    const C rv = rt * (C(-1) + known / rt);
    f[4] = f[2] - C(2.0 / 3.0) * rv;
    f[7] = f[5] + d13 - rv / C(6);
    f[8] = f[6] - d13 - rv / C(6);
  }
}

// The inlet row of every fluid.
template <typename C, int K>
__device__ void apply_inlet(C F[K][9], const ScParams& P) {
#pragma unroll
  for (int k = 0; k < K; ++k) inlet_zou_he(F[k], P.inlet, P.inlet_v[k], P.inlet_rho[k]);
}

// Zou-He pressure outlet row of one fluid (zou_he_pressure_bottom);
// unknowns f2, f5, f6.
template <typename C>
__device__ void outlet_zou_he(C f[9], double rho_t) {
  const C rt = C(rho_t);
  const C rv = rt * (C(1) - (f[0] + f[1] + f[3] + C(2) * (f[4] + f[7] + f[8])) / rt);
  const C d31 = C(0.5) * (f[3] - f[1]);
  f[2] = f[4] + C(2.0 / 3.0) * rv;
  f[5] = f[7] + d31 + rv / C(6);
  f[6] = f[8] - d31 + rv / C(6);
}

// All fluids at (x, y) after the inlet rows: row ny-1-d rewritten, the d
// rows above it ghost copies of it on fluid cells.
template <typename S, int K, typename C = typename Traits<S>::C>
__device__ void load_state(const S* __restrict__ f, const C* __restrict__ geo,
                           const ScParams& P, int x, int y, C F[K][9]) {
  const size_t n = (size_t)P.ny * P.nx;
  const int row = P.ny - 1 - P.depth;
  if (P.inlet != 0 && y > row && geo[(size_t)y * P.nx + x] > C(0.5)) y = row;
  load_raw<S, K>(f, n, (size_t)y * P.nx + x, F);
  if (P.inlet != 0 && y == row && geo[(size_t)row * P.nx + x] > C(0.5))
    apply_inlet<C, K>(F, P);
}

// Fluid k's populations at (x, y) after the inlet rows (load_state for one
// fluid) of an f32 or f64 state.
template <typename S>
__device__ __forceinline__ void load_fluid_state(const S* __restrict__ f, const S* __restrict__ geo,
                                                 const ScParams& P, int x, int y, int k, S F[9]) {
  const size_t n = (size_t)P.ny * P.nx;
  const int row = P.ny - 1 - P.depth;
  if (P.inlet != 0 && y > row && geo[(size_t)y * P.nx + x] > S(0.5)) y = row;
  const S* b = f + (size_t)k * 9 * n + (size_t)y * P.nx + x;
#pragma unroll
  for (int i = 0; i < 9; ++i) F[i] = b[i * n];
  if (P.inlet != 0 && y == row && geo[(size_t)row * P.nx + x] > S(0.5))
    inlet_zou_he(F, P.inlet, P.inlet_v[k], P.inlet_rho[k]);
}

// psi(rho): rho, or the Peng-Robinson pseudopotential
// sqrt(max(2 / (c0 g) (P_PR - rho / 3), 0)) in the plain path's op order.
template <typename C>
__device__ __forceinline__ C psi_of(C rho, const ScParams& P) {
  if (!P.psi_pr) return rho;
  const C p = (rho * C(P.pr_cr) * C(P.pr_t)) / (C(1) - C(P.pr_b) * rho) -
              (C(P.pr_aa) * rho * rho) /
                  (C(1) + C(P.pr_2b) * rho - C(P.pr_bb) * rho * rho);
  const C arg = C(P.pr_k2) * (p - rho / C(3));
  return sqrt(arg > C(0) ? arg : C(0));
}

// out = f - M^-1 S M (f - t), S = diag(0, 0.6, 1.5, 0, 1.2, 0, 1.2, 1/tau,
// 1/tau) (ops/collision.py::mrt with mrt_relaxation_d2q9_sc).
template <typename C>
__device__ __forceinline__ void mrt_relax(const C f[9], const C t[9], C inv_tau,
                                          C out[9]) {
  C d[9], sm[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) d[i] = f[i] - t[i];
#pragma unroll
  for (int a = 0; a < 9; ++a) {
    C m = C(0);
#pragma unroll
    for (int b = 0; b < 9; ++b)
      if (mm(a, b) != 0) m = m + C(mm(a, b)) * d[b];
    sm[a] = (a == 7 || a == 8 ? inv_tau : C(s_sc(a))) * m;
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    C c = C(0);
#pragma unroll
    for (int a = 0; a < 9; ++a)
      if (mm(a, i) != 0 && a != 0 && a != 3 && a != 5)
        c = c + C(mm(a, i) / mnorm(a)) * sm[a];
    out[i] = f[i] - c;
  }
}

template <typename C>
__device__ __forceinline__ void feq9(C rho, C ux, C uy, C feq[9]) {
  const C uu = ux * ux + uy * uy;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const C eu = C(ex(i)) * ux + C(ey(i)) * uy;
    feq[i] = C(wq(i)) * rho * (C(1) + C(3) * eu + C(4.5) * eu * eu - C(1.5) * uu);
  }
}

// The momentum (mx, my) of one fluid's populations.
template <typename C>
__device__ __forceinline__ void momentum9(const C f[9], C& mx, C& my) {
  C a = C(0), b = C(0);
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    if (ex(i)) a = a + C(ex(i)) * f[i];
    if (ey(i)) b = b + C(ey(i)) * f[i];
  }
  mx = a;
  my = b;
}

// One fluid's interaction sums sum_dir w (dx, dy) psi(x + d) over the
// stencil; psi_at(dx, dy) reads the fluid's psi at the cell + (dx, dy).
template <typename C, int ORDER, typename PsiAt>
__device__ __forceinline__ void psi_sums(PsiAt psi_at, C& vx, C& vy) {
  constexpr int R = reach(ORDER);
  vx = vy = C(0);
#pragma unroll
  for (int dy = -R; dy <= R; ++dy) {
#pragma unroll
    for (int dx = -R; dx <= R; ++dx) {
      const double w = iso_w(ORDER, dx * dx + dy * dy);
      if (w == 0.0) continue;
      const C s = psi_at(dx, dy);
      if (dx) vx = vx + C(w * dx) * s;
      if (dy) vy = vy + C(w * dy) * s;
    }
  }
}

// The interaction force on fluid k (psi_k its psi, gs its G_ks) of a cell
// with geometry planes g1 ... g4 (SC: the adhesion vector in g1, g2; EFS:
// fluid_vec, then the solid adsorption), over nf fluids: g(j) = G_kj, v(j,
// d) fluid j's interaction sum along d, psi(j) fluid j's psi at the cell.
//   SC:  F_k = -psi_k (sum_j G_kj v_j + G_ks adh)
//   EFS: F_k = -6 psi_k sum_j G_kj (v_j - psi_j fluid_vec) - G_ks psi_k adh_st
template <typename C, int ORDER, typename G, typename V, typename Psi>
__device__ __forceinline__ void sc_force(int nf, G g, V v, Psi psi, C psi_k, double gs, C g1,
                                         C g2, C g3, C g4, C& fx, C& fy) {
  C gx = C(0), gy = C(0);
  for (int j = 0; j < nf; ++j) {
    if constexpr (ORDER == 0) {
      gx = gx + C(g(j)) * v(j, 0);
      gy = gy + C(g(j)) * v(j, 1);
    } else {
      gx = gx + C(g(j)) * (v(j, 0) - psi(j) * g1);
      gy = gy + C(g(j)) * (v(j, 1) - psi(j) * g2);
    }
  }
  if constexpr (ORDER == 0) {
    fx = -psi_k * (gx + C(gs) * g1);
    fy = -psi_k * (gy + C(gs) * g2);
  } else {
    fx = C(-6) * psi_k * gx - C(gs) * psi_k * g3;
    fy = C(-6) * psi_k * gy - C(gs) * psi_k * g4;
  }
}

// Post-collision populations `out` of one fluid (populations f, density
// rho, force (fx, fy), relaxation time tau and 1/tau) at the common
// velocity (ux0, uy0).
template <typename C, int ORDER>
__device__ __forceinline__ void sc_collide_fluid(const C f[9], C rho, C fx, C fy, C ux0, C uy0,
                                                 double tau_d, double inv_tau, int mrt,
                                                 C out[9]) {
  const C rs = rho > C(0) ? rho : C(1);
  const C tau = C(tau_d);
  C feq[9];
  if constexpr (ORDER == 0) {
    // shift forcing: relax toward feq(u' + tau F / rho)
    feq9(rho, ux0 + tau * fx / rs, uy0 + tau * fy / rs, feq);
    if (mrt) {
      mrt_relax(f, feq, C(inv_tau), out);
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) out[i] = f[i] - (f[i] - feq[i]) / tau;
    }
  } else {
    // EDM update of the transformed PDF with the force PDF
    // f^F_i = (F . (e_i - u)) feq_i 3 / rho
    feq9(rho, ux0, uy0, feq);
    C ff[9];
    const C r3 = C(3) / rs;
#pragma unroll
    for (int i = 0; i < 9; ++i)
      ff[i] = (fx * (C(ex(i)) - ux0) + fy * (C(ey(i)) - uy0)) * feq[i] * r3;
    if (mrt) {
      C t[9], m[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) t[i] = feq[i] - C(0.5) * ff[i];
      mrt_relax(f, t, C(inv_tau), m);
#pragma unroll
      for (int i = 0; i < 9; ++i) out[i] = f[i] + (m[i] - f[i]) + ff[i];
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i)
        out[i] = f[i] + (feq[i] - f[i] - C(0.5) * ff[i]) / tau + ff[i];
    }
  }
}

// Post-collision populations out[k] of every fluid at a fluid cell from
// its populations F (after the inlet rows): psi_at(j, dx, dy) gives fluid
// j's psi at the cell + (dx, dy) (dx = dy = 0: the cell's own); g1 ... g4
// are the cell's geometry planes 1 ... 4 (sc_force).
template <typename C, int K, int ORDER, typename PsiAt>
__device__ __forceinline__ void sc_collide(const C F[K][9], PsiAt psi_at, C g1, C g2, C g3,
                                           C g4, const ScParams& P, C out_k[K][9]) {
  C rho[K], mx[K], my[K], psi[K], v[K][2], fx[K], fy[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    rho[k] = sum9(F[k]);
    momentum9(F[k], mx[k], my[k]);
    psi[k] = psi_at(k, 0, 0);
    psi_sums<C, ORDER>([&](int dx, int dy) { return psi_at(k, dx, dy); }, v[k][0], v[k][1]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    sc_force<C, ORDER>(
        K, [&](int j) { return P.g[k][j]; }, [&](int j, int d) { return v[j][d]; },
        [&](int j) { return psi[j]; }, psi[k], P.gs[k], g1, g2, g3, g4, fx[k], fy[k]);
  if (P.bfx != 0.0 || P.bfy != 0.0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      fx[k] = fx[k] + C(P.bfx) * rho[k];
      fy[k] = fy[k] + C(P.bfy) * rho[k];
    }
  }
  C den = C(0), numx = C(0), numy = C(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const C it = C(P.inv_tau[k]);
    den = den + rho[k] * it;
    if constexpr (ORDER == 0) {
      numx = numx + mx[k] * it;
      numy = numy + my[k] * it;
    } else {
      numx = numx + (mx[k] + C(0.5) * fx[k]) * it;
      numy = numy + (my[k] + C(0.5) * fy[k]) * it;
    }
  }
  den = den != C(0) ? den : C(1);
  const C ux0 = numx / den, uy0 = numy / den;
#pragma unroll
  for (int k = 0; k < K; ++k)
    sc_collide_fluid<C, ORDER>(F[k], rho[k], fx[k], fy[k], ux0, uy0, P.tau[k], P.inv_tau[k],
                               P.mrt, out_k[k]);
}

// Post-collision populations of every fluid at the fluid cell (cx, cy),
// written to post (planes of `plane` values each, this cell at `at`).
// (px, py) is the cell in the shared psi tile.
template <typename S, int K, int ORDER, typename C = typename Traits<S>::C>
__device__ void collide_cell(const S* __restrict__ f, const C* __restrict__ geo,
                             const C* __restrict__ sh_psi, const ScParams& P, int cx,
                             int cy, int px, int py, C* __restrict__ post, int plane,
                             int at) {
  constexpr int R = reach(ORDER);
  constexpr int PX = TX + 2 + 2 * R, PY = TY + 2 + 2 * R;
  const size_t n = (size_t)P.ny * P.nx;
  const size_t idx = (size_t)cy * P.nx + cx;
  C F[K][9];
  load_state<S, K>(f, geo, P, cx, cy, F);
  const bool efs = ORDER != 0;
  C out[K][9];
  sc_collide<C, K, ORDER>(
      F, [&](int j, int dx, int dy) { return sh_psi[(j * PY + py + dy) * PX + px + dx]; },
      geo[n + idx], geo[2 * n + idx], efs ? geo[3 * n + idx] : C(0),
      efs ? geo[4 * n + idx] : C(0), P, out);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 9; ++i) post[(k * 9 + i) * plane + at] = out[k][i];
}

template <typename S, int K, typename C = typename Traits<S>::C>
__device__ __forceinline__ void store_state(S* __restrict__ out, size_t n, size_t idx,
                                            const C o[K][9]) {
  constexpr int NP = Traits<S>::kPlanes;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    S* b = out + (size_t)k * NP * n;
    if constexpr (Traits<S>::kShifted) {
      const C rho = sum9(o[k]);
#pragma unroll
      for (int i = 0; i < 9; ++i) b[i * n + idx] = __float2bfloat16_rn(o[k][i] - C(wq(i)) * rho);
      const __nv_bfloat16 hi = __float2bfloat16_rn(rho);
      b[9 * n + idx] = hi;
      b[10 * n + idx] = __float2bfloat16_rn(rho - __bfloat162float(hi));
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) b[i * n + idx] = o[k][i];
    }
  }
}

template <typename C, int K, int ORDER>
constexpr size_t smem_bytes() {
  constexpr int R = reach(ORDER);
  return sizeof(C) * ((size_t)K * 9 * (TY + 2) * (TX + 2) +
                      (size_t)K * (TY + 2 + 2 * R) * (TX + 2 + 2 * R)) +
         (TY + 2) * (TX + 2);
}

template <typename S, int K, int ORDER, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(TX * TY)
collide_stream_kernel(const S* __restrict__ f, const C* __restrict__ geo, S* __restrict__ out,
                      ScParams P) {
  constexpr int R = reach(ORDER);
  constexpr int RX = TX + 2, RY = TY + 2;          // tile + one-cell ring
  constexpr int PX = RX + 2 * R, PY = RY + 2 * R;  // psi tile
  constexpr int RING = RX * RY;
  extern __shared__ __align__(16) unsigned char smem[];
  C* sh_post = reinterpret_cast<C*>(smem);          // [K * 9][RY][RX]
  C* sh_psi = sh_post + K * 9 * RING;                // [K][PY][PX]
  unsigned char* sh_fl = reinterpret_cast<unsigned char*>(sh_psi + K * PY * PX);
  const int nx = P.nx, ny = P.ny;
  const size_t n = (size_t)ny * nx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;

  for (int t = tid; t < PX * PY; t += TX * TY) {
    const int lx = t % PX, ly = t / PX;
    const int cx = wrap(x0 - 1 - R + lx, nx), cy = wrap(y0 - 1 - R + ly, ny);
    const bool fluid = geo[(size_t)cy * nx + cx] > C(0.5);
    C F[K][9];
    if (fluid) load_state<S, K>(f, geo, P, cx, cy, F);
#pragma unroll
    for (int k = 0; k < K; ++k)
      sh_psi[(k * PY + ly) * PX + lx] = fluid ? psi_of(sum9(F[k]), P) : C(0);
  }
  __syncthreads();
  for (int t = tid; t < RING; t += TX * TY) {
    const int lx = t % RX, ly = t / RX;
    const int cx = wrap(x0 - 1 + lx, nx), cy = wrap(y0 - 1 + ly, ny);
    const bool fluid = geo[(size_t)cy * nx + cx] > C(0.5);
    sh_fl[t] = fluid;
    if (fluid) {
      collide_cell<S, K, ORDER>(f, geo, sh_psi, P, cx, cy, lx + R, ly + R, sh_post, RING,
                                t);
    } else {
#pragma unroll
      for (int q = 0; q < K * 9; ++q) sh_post[q * RING + t] = C(0);
    }
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  const bool inside = x < nx && y < ny;
  const int lx = threadIdx.x + 1, ly = threadIdx.y + 1;
  C o[K][9];
  if (inside && sh_fl[ly * RX + lx]) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      // pull from the upwind cell x - e_i, or bounce back from a solid one
      int sx = lx - ex(i), sy = ly - ey(i), j = i;
      if (!sh_fl[sy * RX + sx]) {
        sx = lx;
        sy = ly;
        j = opp(i);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) o[k][i] = sh_post[(k * 9 + j) * RING + sy * RX + sx];
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < 9; ++i) o[k][i] = C(0);
  }

  if (P.outlet != 0 && blockIdx.y == 0) {
    // outlet rows: y0 = 0, so rows 0 ... d + 2 are this tile's rows.  The
    // streamed tile goes to shared memory (over the ring, no longer read).
    constexpr int TILE = TX * TY;
    const int at = threadIdx.y * TX + threadIdx.x;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < 9; ++i) sh_post[(k * 9 + i) * TILE + at] = o[k][i];
    __syncthreads();
    const int d = P.depth;
    auto fluid_row = [&](int r) { return sh_fl[(r + 1) * RX + lx] != 0; };
    if (inside && y <= d + 1 && fluid_row(y)) {
      int src = y;
      if (P.outlet == 2) {
        // convective: rows d+1 ... 0 each copy the (fresh) row above
        while (src <= d + 1 && fluid_row(src)) ++src;
      } else if (y <= d) {
        src = d;   // the Zou-He row, and its ghost copies below it
      }
      if (P.outlet == 2 || y <= d) {
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int i = 0; i < 9; ++i)
            o[k][i] = sh_post[(k * 9 + i) * TILE + src * TX + threadIdx.x];
        if (P.outlet == 1 && fluid_row(d)) {
#pragma unroll
          for (int k = 0; k < K; ++k) outlet_zou_he(o[k], P.outlet_rho[k]);
        }
      }
    }
  }
  if (inside) store_state<S, K>(out, n, (size_t)y * nx + x, o);
}

// The push's shared memory: psi_k and the fluid flags of the tile plus an
// R-cell ring.
template <typename C, int K, int ORDER>
__host__ __device__ constexpr size_t push_smem_bytes() {
  return (sizeof(C) * K + 1) * (size_t)(TY + 2 * reach(ORDER)) * (TX + 2 * reach(ORDER));
}

// One step of f32 or f64 storage by push (the note at the top): the ring
// fill, one barrier, then each fluid cell's collision one fluid at a time,
// post_i stored as it leaves sc_collide_fluid.  The stores go through a
// pointer that the empty asm keeps the compiler from folding into nine
// addresses held in registers (flow3d.cuh's sc_push_kernel, PERF.md).
template <typename S, int K, int ORDER>
__global__ void __launch_bounds__(TX * TY)
sc_push_kernel(const S* __restrict__ f, const S* __restrict__ geo, S* __restrict__ out,
               ScParams P) {
  using C = S;
  constexpr int R = reach(ORDER);
  constexpr int PX = TX + 2 * R, PY = TY + 2 * R, PN = PX * PY;
  extern __shared__ __align__(16) unsigned char smem[];
  C* sh_psi = reinterpret_cast<C*>(smem);                                   // [K][PY][PX]
  unsigned char* sh_fl = reinterpret_cast<unsigned char*>(sh_psi + K * PN);  // [PY][PX]
  const int nx = P.nx, ny = P.ny;
  const size_t n = (size_t)ny * nx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int t = tid; t < PN; t += TX * TY) {
    const int cx = wrap(x0 - R + t % PX, nx), cy = wrap(y0 - R + t / PX, ny);
    const bool fluid = geo[(size_t)cy * nx + cx] > C(0.5);
    sh_fl[t] = fluid;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      C psi = C(0);
      if (fluid) {
        C F[9];
        load_fluid_state<S>(f, geo, P, cx, cy, k, F);
        psi = psi_of(sum9(F), P);
      }
      sh_psi[k * PN + t] = psi;
    }
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const size_t idx = (size_t)y * nx + x;
  const int self = (threadIdx.y + R) * PX + threadIdx.x + R;
  if (!sh_fl[self]) {
#pragma unroll
    for (int q = 0; q < K * 9; ++q) out[q * n + idx] = C(0);
    return;
  }
  unsigned fluid_nb = 1;   // bit i: x + e_i is fluid
#pragma unroll
  for (int i = 1; i < 9; ++i) fluid_nb |= (sh_fl[self + ey(i) * PX + ex(i)] ? 1u : 0u) << i;
  // sc_collide's arithmetic, in its order, one fluid's populations at a time
  C rho[K], mx[K], my[K], psi[K], v[K][2], fx[K], fy[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    C F[9];
    load_fluid_state<S>(f, geo, P, x, y, k, F);
    rho[k] = sum9(F);
    momentum9(F, mx[k], my[k]);
    psi[k] = sh_psi[k * PN + self];
    psi_sums<C, ORDER>([&](int dx, int dy) { return sh_psi[k * PN + self + dy * PX + dx]; },
                       v[k][0], v[k][1]);
  }
  const bool efs = ORDER != 0;
  const C g1 = geo[n + idx], g2 = geo[2 * n + idx];
  const C g3 = efs ? geo[3 * n + idx] : C(0), g4 = efs ? geo[4 * n + idx] : C(0);
#pragma unroll
  for (int k = 0; k < K; ++k)
    sc_force<C, ORDER>(
        K, [&](int j) { return P.g[k][j]; }, [&](int j, int d) { return v[j][d]; },
        [&](int j) { return psi[j]; }, psi[k], P.gs[k], g1, g2, g3, g4, fx[k], fy[k]);
  if (P.bfx != 0.0 || P.bfy != 0.0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      fx[k] = fx[k] + C(P.bfx) * rho[k];
      fy[k] = fy[k] + C(P.bfy) * rho[k];
    }
  }
  C den = C(0), numx = C(0), numy = C(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const C it = C(P.inv_tau[k]);
    den = den + rho[k] * it;
    if constexpr (ORDER == 0) {
      numx = numx + mx[k] * it;
      numy = numy + my[k] * it;
    } else {
      numx = numx + (mx[k] + C(0.5) * fx[k]) * it;
      numy = numy + (my[k] + C(0.5) * fy[k]) * it;
    }
  }
  den = den != C(0) ? den : C(1);
  const C ux0 = numx / den, uy0 = numy / den;
  // the offsets of x + e_i from x along each axis, wrapped (index e + 1)
  const int ox[3] = {x == 0 ? nx - 1 : -1, 0, x == nx - 1 ? 1 - nx : 1};
  const int oy[3] = {(y == 0 ? ny - 1 : -1) * nx, 0, (y == ny - 1 ? 1 - ny : 1) * nx};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    C F[9], o[9];
    load_fluid_state<S>(f, geo, P, x, y, k, F);
    sc_collide_fluid<C, ORDER>(F, rho[k], fx[k], fy[k], ux0, uy0, P.tau[k], P.inv_tau[k], P.mrt,
                               o);
    S* p = out + (size_t)k * 9 * n + idx;   // slot i of x
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      if ((fluid_nb >> i) & 1u)
        p[oy[ey(i) + 1] + ox[ex(i) + 1]] = o[i];
      else
        p[(opp(i) - i) * (ptrdiff_t)n] = o[i];   // bounced back from the solid x + e_i
      p += n;
      asm volatile("" : "+l"(p));
    }
  }
}

// The outlet rows of a pushed step in place, one thread a column: the
// Zou-He row d of every fluid and its ghost rows d - 1 ... 0, or the
// convective rows d + 1 ... 0, each copying the row above, on fluid cells.
template <typename S, int K>
__global__ void sc_outlet_kernel(const S* __restrict__ geo, S* __restrict__ out, ScParams P) {
  using C = S;
  const int nx = P.nx, x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= nx) return;
  const size_t n = (size_t)P.ny * nx;
  const int d = P.depth;
  auto fluid = [&](int r) { return geo[(size_t)r * nx + x] > C(0.5); };
  C F[K][9];
  if (P.outlet == 1) {
    load_raw<S, K>(out, n, (size_t)d * nx + x, F);
    if (fluid(d)) {
#pragma unroll
      for (int k = 0; k < K; ++k) outlet_zou_he(F[k], P.outlet_rho[k]);
      store_state<S, K>(out, n, (size_t)d * nx + x, F);
    }
    for (int r = d - 1; r >= 0; --r)
      if (fluid(r)) store_state<S, K>(out, n, (size_t)r * nx + x, F);
  } else {
    for (int r = d + 1; r >= 0; --r) {
      if (!fluid(r)) continue;
      load_raw<S, K>(out, n, (size_t)(r + 1) * nx + x, F);
      store_state<S, K>(out, n, (size_t)r * nx + x, F);
    }
  }
}

// One step: f32 and f64 the push (and the outlet rows); bf16 the pull.
template <typename S, int K, int ORDER>
int launch_sc(const void* f_in, void* f_out, const void* geo_v, const ScParams& P,
              cudaStream_t st) {
  using C = typename Traits<S>::C;
  const S* f = static_cast<const S*>(f_in);
  S* out = static_cast<S*>(f_out);
  const C* geo = static_cast<const C*>(geo_v);
  const dim3 grid((P.nx + TX - 1) / TX, (P.ny + TY - 1) / TY);
  cudaError_t err;
  if constexpr (!Traits<S>::kShifted) {
    constexpr size_t smem = push_smem_bytes<C, K, ORDER>();
    static_assert(smem <= 48 * 1024, "the push's ring needs no opt-in shared memory");
    sc_push_kernel<S, K, ORDER><<<grid, dim3(TX, TY), smem, st>>>(f, geo, out, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++g_launches[1];
    if (P.outlet != 0) {
      sc_outlet_kernel<S, K><<<(P.nx + 127) / 128, 128, 0, st>>>(geo, out, P);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      ++g_launches[2];
    }
    return 0;
  } else {
    constexpr size_t smem = smem_bytes<C, K, ORDER>();
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(collide_stream_kernel<S, K, ORDER>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    collide_stream_kernel<S, K, ORDER><<<grid, dim3(TX, TY), smem, st>>>(f, geo, out, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++g_launches[0];
    return 0;
  }
}

template <typename S, int K>
int launch_order(const void* f_in, void* f_out, const void* geo, const ScParams& P,
                 cudaStream_t st) {
  switch (P.order) {
    case 0: return launch_sc<S, K, 0>(f_in, f_out, geo, P, st);
    case 4: return launch_sc<S, K, 4>(f_in, f_out, geo, P, st);
    case 8: return launch_sc<S, K, 8>(f_in, f_out, geo, P, st);
    case 10: return launch_sc<S, K, 10>(f_in, f_out, geo, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One step for P.k fluids; returns a cudaError_t code (0 on success).
template <typename S>
int sc2d_dispatch(const void* f_in, void* f_out, const void* geo, const ScParams& P,
                  cudaStream_t st) {
  switch (P.k) {
    case 1: return launch_order<S, 1>(f_in, f_out, geo, P, st);
    case 2: return launch_order<S, 2>(f_in, f_out, geo, P, st);
    case 3: return launch_order<S, 3>(f_in, f_out, geo, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
