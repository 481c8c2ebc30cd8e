// Device code of the CSF colour-gradient step, D2Q9, for NVIDIA Hopper
// (sm_90a), shared by csf2d.cu (the flow step) and coupled2d.cu (the coupled
// flow + tracer step).  The kernels and device functions live in an unnamed
// namespace, so each library that includes this file has its own copy.
//
// Replaces the TPU kernel openlbmpm_tpu/pallas/csf.py::build_csf_fused_step
// at steps_per_call=1 in both state layouts, a template parameter L here:
//   kCompressed  state_mode="compressed", storage "f32" (K1) and "bf16" (K2):
//                (f_total, rho_r), 10 planes, or 11 bf16 planes;
//   kSplit       state_mode="split" (K6): the colour PDFs f_r and f_b, two
//                (9, ny, nx) arrays, f32 or f64 (no bf16 form).
// Each layout also builds an f64-state instance, so the card can check the
// kernel against the plain PyTorch path to ~1e-12.
//
// The split layout applies the boundary rows per colour (Cell<C, kSplit>):
// the total-momentum inlet and the total-pressure outlet computed on
// f_r + f_b and split by the row's red fraction before the rewrite, the
// per-colour Zou-He pressure and velocity inlets, the ghost and convective
// row copies of both colours.  pert2d.cu (the Perturbation step, K4) reads
// the state through the same load_state.  It writes f_b' = stream(post - f_r_post), as the TPU
// kernel's _substep does (csf.py:1016), so that the f64 instance agrees
// with the plain path to rounding.
//
// One step = boundary rows -> rho, phi (+ outlet phi repair) -> solid-phi
// extrapolation -> isotropic gradient -> contact-angle rotation -> unit
// normal -> curvature and CSF force -> u, tau(phi) -> SRT or MRT collision
// with the Guo source -> LKR recolouring of the red density -> pull
// streaming with half-way bounce-back.  Its formulas follow the jnp path
// (ColorGradientRK._step_csf_c and ops/), not the TPU kernel's strip
// windows, rolls and banding.
//
// One launch a step, strip_kernel: the strip march.  A block of
// STRIP_THREADS (10 warps) owns a strip of TX = 32 columns and a run of
// RUN_H = 32 rows (at 1024^2, 32 x 32 blocks) and steps down the run TY = 8
// rows at a time through four stages, a barrier between them (the split
// layout's push shares a phase, the code between two barriers, with the
// next step's phi rows):
//   phi      phi of TY new rows 4 ahead of the output rows over the
//            strip's columns and a 4-column halo (one round of the block's
//            threads), the fluid flags, and the state each cell decoded
//            (boundary rows applied), kept for the collision;
//   normal   the wetted gradient and unit normal of TY rows 2 ahead from
//            the phi ring (a 2-column halo);
//   collide  TY rows 1 ahead from the kept state and the rings (a 1-column
//            halo): post, frac, A, B into the post ring;
//   stream   the pull of the TY output rows from the post ring.
// The rings carry the rows an earlier step formed; only the x halo (40 /
// 32 phi cells, 34 / 32 collisions a strip) and the rows above each run
// (the prologue) are formed twice.  phi and the normals never reach device
// memory.  The split layout (K6) pushes instead: each cell
// of the strip collided once, its red part frac post_i + seg_i and
// post_i - red written to slot i of x + e_i, or to slot opp(i) of x where
// x + e_i is solid (the slots are source-side, so no sum is needed at the
// target), with no post ring.  coupled2d.cu's tracer_strip_kernel walks
// the same way on the fields of the state before the boundary rows.  The
// boundary rows (inlet rows ny-2, ny-1; outlet rows
// 0-2) are applied on the fly wherever a kernel reads the state, in
// compute precision, so no kernel writes a boundary-corrected state back
// to memory: the bf16 state is rounded once, at the store (the TPU kernel
// rewrites them on its f32 window for the same reason).
//
// What bounds it: the least bytes a cell-step are 81 (compressed f32), 45
// (bf16) and 145 (split f32).  The strip march writes the state once and
// reads it for 1.56x its cells (the 4-column halo, and the 4 rows above
// and below each run of 32), the re-reads mostly from L2.  It runs at an
// eighth to a third of the bytes' bound (PERF.md): each stage of a step
// waits for its slowest warp, so what limits it is the warps in flight an
// SM (registers: 4 blocks an SM in float, 3 for the split push) and the
// latency of a stage, not the bytes.  The three-launch
// form before it wrote and read phi and the four normal planes (about
// 180 / 126 / 276 B a cell-step) and collided a 32 x 8 tile plus a
// one-cell ring (1.33x its cells).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

struct CsfParams {       // mirrored by kernels/csf.py::CsfParams
  int ny, nx;
  int inlet;             // 0 periodic, 1 neumann, 2 dirichlet,
                         // 3 neumann_per_color (split layout only)
  int outlet;            // 0 periodic, 1 convective, 2 dirichlet
  int phi_repair;
  int has_wetting;
  int wetting_type;      // 1 Xu 2017, 2 Akai 2018 (inward normal)
  int tau_type;          // 1 | 2
  int mrt;
  int pad;
  double tau_r, tau_b, sigma, beta, delta, cos_t, sin_t, bfx, bfy;
  double inlet_velocity, inlet_rho, outlet_rho;
  double inlet_rho_r, inlet_rho_b;  // split layout: per-colour Zou-He inlet
  int variant;           // 0 CSF (csf2d.cu, coupled2d.cu), 1 Perturbation
  int pad2;              //   (pert2d.cu)
  double inlet_velocity_r, inlet_velocity_b;  // neumann_per_color
  // Perturbation: solid colour difference, strengths of red and blue, the
  // gradient weights of the axis and diagonal neighbours, and the RK
  // equilibrium constants C_i of each colour (rest, axis, diagonal)
  double solid_phi, a_kr, a_kb, grad_wa, grad_wd;
  double c_r[3], c_b[3];
};

namespace {

constexpr int kCompressed = 0;
constexpr int kSplit = 1;

constexpr double kEps = 1.0e-8;
constexpr int TX = 32;
constexpr int TY = 8;

// D2Q9, reference ordering: 0 rest, 1 E, 2 N, 3 W, 4 S, 5 NE, 6 NW, 7 SW, 8 SE
__device__ __forceinline__ int ex(int i) {
  return (i == 1 || i == 5 || i == 8) - (i == 3 || i == 6 || i == 7);
}
__device__ __forceinline__ int ey(int i) {
  return (i == 2 || i == 5 || i == 6) - (i == 4 || i == 7 || i == 8);
}
__device__ __forceinline__ int opp(int i) {
  return i == 0 ? 0 : (i < 5 ? (i + 1) % 4 + 1 : (i - 3) % 4 + 5);
}
__device__ __forceinline__ double wq(int i) {
  return i == 0 ? 4.0 / 9.0 : (i < 5 ? 1.0 / 9.0 : 1.0 / 36.0);
}
// Lallemand-Luo moment matrix (lattice.py::_d2q9_mrt_matrix); its rows are
// orthogonal, so M^-1[i][a] = M[a][i] / |M_a|^2.
__device__ __forceinline__ double mm(int a, int b) {
  constexpr signed char M[9][9] = {
      {1, 1, 1, 1, 1, 1, 1, 1, 1},       {-4, -1, -1, -1, -1, 2, 2, 2, 2},
      {4, -2, -2, -2, -2, 1, 1, 1, 1},   {0, 1, 0, -1, 0, 1, -1, -1, 1},
      {0, -2, 0, 2, 0, 1, -1, -1, 1},    {0, 0, 1, 0, -1, 1, 1, -1, -1},
      {0, 0, -2, 0, 2, 1, 1, -1, -1},    {0, 1, -1, 1, -1, 0, 0, 0, 0},
      {0, 0, 0, 0, 0, 1, -1, 1, -1}};
  return M[a][b];
}
__device__ __forceinline__ double mnorm(int a) {
  constexpr signed char N[9] = {9, 36, 36, 6, 12, 6, 12, 4, 4};
  return N[a];
}

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// Storage type S -> compute type C.  bf16 storage holds f_i - w_i*fl.
template <typename S> struct Traits {
  using C = S;
  static constexpr bool kShifted = false;
};
template <> struct Traits<__nv_bfloat16> {
  using C = float;
  static constexpr bool kShifted = true;
};

__device__ __forceinline__ float to_c(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_c(float v) { return v; }
__device__ __forceinline__ double to_c(double v) { return v; }

// One cell's state in registers, in compute precision: the total PDF and
// rho_r (compressed), or the two colour PDFs (split).
template <typename C, int L> struct Cell;
template <typename C> struct Cell<C, kCompressed> {
  C f[9];
  C rr;
};
template <typename C> struct Cell<C, kSplit> {
  C r[9];
  C b[9];
};

// The state at cell k as stored; s2 is f_b in the split layout (unused in
// the compressed one).
template <typename S, int L, typename C = typename Traits<S>::C>
__device__ __forceinline__ void load_raw(const S* __restrict__ s,
                                         const S* __restrict__ s2,
                                         const C* __restrict__ geo, size_t n,
                                         size_t k, Cell<C, L>& c) {
  if constexpr (L == kSplit) {
    static_assert(!Traits<S>::kShifted, "the split layout has no bf16 form");
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      c.r[i] = s[i * n + k];
      c.b[i] = s2[i * n + k];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) c.f[i] = to_c(s[i * n + k]);
    if constexpr (Traits<S>::kShifted) {
      const C fl = geo[k];
#pragma unroll
      for (int i = 0; i < 9; ++i) c.f[i] = c.f[i] + C(wq(i)) * fl;
      c.rr = to_c(s[9 * n + k]) + to_c(s[10 * n + k]);
    } else {
      c.rr = to_c(s[9 * n + k]);
    }
  }
}

template <typename C>
__device__ __forceinline__ C sum9(const C f[9]) {
  C r = f[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) r = r + f[i];
  return r;
}

// Replace populations a, b, c by na, nb, nc and move rho_r by the local
// red fraction of the change (ops/boundaries.py::_update_rows_c).
template <typename C>
__device__ __forceinline__ void update_rows(C f[9], C& rr, int a, int b, int c,
                                            C na, C nb, C nc) {
  const C rho_row = sum9(f);
  const C rho_s = rho_row != C(0) ? rho_row : C(1);
  const C ratio = rr / rho_s;
  const C delta = (na - f[a]) + (nb - f[b]) + (nc - f[c]);
  f[a] = na;
  f[b] = nb;
  f[c] = nc;
  rr = rr + ratio * delta;
}

template <typename C>
__device__ void inlet_neumann(C f[9], C& rr, double vy) {
  const C rho = (f[0] + f[1] + f[3] + C(2.0) * (f[2] + f[5] + f[6])) / C(1.0 + vy);
  // feq of a row at u = (0, vy) in a direction with y-component ey
  auto feq = [&](double ey_, double w) {
    const double eu = ey_ * vy;
    return rho * C(w) * C(1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * vy * vy);
  };
  const C n4 = feq(-1.0, 1.0 / 9.0) + (f[2] - feq(1.0, 1.0 / 9.0));
  const C n7 = feq(-1.0, 1.0 / 36.0) + (f[5] - feq(1.0, 1.0 / 36.0));
  const C n8 = feq(-1.0, 1.0 / 36.0) + (f[6] - feq(1.0, 1.0 / 36.0));
  update_rows(f, rr, 4, 7, 8, n4, n7, n8);
}

template <typename C>
__device__ void inlet_dirichlet(C f[9], C& rr, double rho_t) {
  const C vy = C(-1.0) + (f[0] + f[1] + f[3] + C(2.0) * (f[2] + f[5] + f[6])) / C(rho_t);
  const C d13 = C(0.5) * (f[1] - f[3]);
  const C rv = C(rho_t) * vy;
  update_rows(f, rr, 4, 7, 8, f[2] - C(2.0 / 3.0) * rv, f[5] + d13 - rv / C(6.0),
              f[6] - d13 - rv / C(6.0));
}

template <typename C>
__device__ void outlet_dirichlet(C f[9], C& rr, double rho_t) {
  const C vy = C(1.0) - (f[0] + f[1] + f[3] + C(2.0) * (f[4] + f[7] + f[8])) / C(rho_t);
  const C d31 = C(0.5) * (f[3] - f[1]);
  const C rv = C(rho_t) * vy;
  update_rows(f, rr, 2, 5, 6, f[4] + C(2.0 / 3.0) * rv, f[7] + d31 + rv / C(6.0),
              f[8] - d31 + rv / C(6.0));
}

// Split layout: the total-row values na, nb, nc of populations a, b, c go
// to the colours by the row's red fraction, taken before the rewrite
// (ops/boundaries.py::total_velocity_inlet_top).
template <typename C>
__device__ __forceinline__ void split_rows(Cell<C, kSplit>& c, int a, int b, int d,
                                           C na, C nb, C nd) {
  const C rr = sum9(c.r), rb = sum9(c.b);
  const C tot = rr + rb;
  const C ratio_r = rr / (tot != C(0) ? tot : C(1));
  const C ratio_b = C(1) - ratio_r;
  c.r[a] = ratio_r * na;
  c.b[a] = ratio_b * na;
  c.r[b] = ratio_r * nb;
  c.b[b] = ratio_b * nb;
  c.r[d] = ratio_r * nd;
  c.b[d] = ratio_b * nd;
}

// Zou-He pressure inlet of one colour's populations at target rho_t != 0
// (the model refuses a zero target before any launch).
template <typename C>
__device__ void zou_he_top(C f[9], double rho_t) {
  const C vy = C(-1.0) + (f[0] + f[1] + f[3] + C(2.0) * (f[2] + f[5] + f[6])) / C(rho_t);
  const C d13 = C(0.5) * (f[1] - f[3]);
  const C rv = C(rho_t) * vy;
  f[4] = f[2] - C(2.0 / 3.0) * rv;
  f[7] = f[5] + d13 - rv / C(6.0);
  f[8] = f[6] - d13 - rv / C(6.0);
}

// Zou-He velocity inlet of one colour's populations at speed vy
// (ops/boundaries.py::zou_he_velocity_top).
template <typename C>
__device__ void zou_he_velocity(C f[9], double vy) {
  const C rho = (f[0] + f[1] + f[3] + C(2.0) * (f[2] + f[5] + f[6])) / C(1.0 + vy);
  const C d13 = C(0.5) * (f[1] - f[3]);
  f[4] = f[2] - C(2.0 / 3.0) * rho * C(vy);
  f[7] = f[5] + d13 - rho * C(vy) / C(6.0);
  f[8] = f[6] - d13 - rho * C(vy) / C(6.0);
}

// The compressed layout has no per-colour inlet (code 3): the model
// refuses it before any launch.
template <typename C>
__device__ void apply_inlet(Cell<C, kCompressed>& c, const CsfParams& P) {
  if (P.inlet == 1) inlet_neumann(c.f, c.rr, P.inlet_velocity);
  else if (P.inlet == 2) inlet_dirichlet(c.f, c.rr, P.inlet_rho);
}

template <typename C>
__device__ void apply_inlet(Cell<C, kSplit>& c, const CsfParams& P) {
  if (P.inlet == 1) {
    const double vy = P.inlet_velocity;
    C ft[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) ft[i] = c.r[i] + c.b[i];
    const C rho = (ft[0] + ft[1] + ft[3] + C(2.0) * (ft[2] + ft[5] + ft[6])) / C(1.0 + vy);
    auto feq = [&](double ey_, double w) {
      const double eu = ey_ * vy;
      return rho * C(w) * C(1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * vy * vy);
    };
    split_rows(c, 4, 7, 8, feq(-1.0, 1.0 / 9.0) + (ft[2] - feq(1.0, 1.0 / 9.0)),
               feq(-1.0, 1.0 / 36.0) + (ft[5] - feq(1.0, 1.0 / 36.0)),
               feq(-1.0, 1.0 / 36.0) + (ft[6] - feq(1.0, 1.0 / 36.0)));
  } else if (P.inlet == 3) {
    zou_he_velocity(c.r, P.inlet_velocity_r);
    zou_he_velocity(c.b, P.inlet_velocity_b);
  } else {
    zou_he_top(c.r, P.inlet_rho_r);
    zou_he_top(c.b, P.inlet_rho_b);
  }
}

template <typename C>
__device__ void apply_outlet(Cell<C, kCompressed>& c, const CsfParams& P) {
  outlet_dirichlet(c.f, c.rr, P.outlet_rho);
}

template <typename C>
__device__ void apply_outlet(Cell<C, kSplit>& c, const CsfParams& P) {
  const double rho_t = P.outlet_rho;
  C ft[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) ft[i] = c.r[i] + c.b[i];
  const C vy = C(1.0) - (ft[0] + ft[1] + ft[3] + C(2.0) * (ft[4] + ft[7] + ft[8])) / C(rho_t);
  const C d31 = C(0.5) * (ft[3] - ft[1]);
  const C rv = C(rho_t) * vy;
  split_rows(c, 2, 5, 6, ft[4] + C(2.0 / 3.0) * rv, ft[7] + d31 + rv / C(6.0),
             ft[8] - d31 + rv / C(6.0));
}

// The cell's total PDF, colour densities and total density.  The split
// layout sums each colour, as the reference's split step does.
template <typename C>
__device__ __forceinline__ void totals(const Cell<C, kCompressed>& c, C f[9], C& rr,
                                       C& rb, C& rho) {
#pragma unroll
  for (int i = 0; i < 9; ++i) f[i] = c.f[i];
  rr = c.rr;
  rho = sum9(f);
  rb = rho - rr;
}

template <typename C>
__device__ __forceinline__ void totals(const Cell<C, kSplit>& c, C f[9], C& rr, C& rb,
                                       C& rho) {
#pragma unroll
  for (int i = 0; i < 9; ++i) f[i] = c.r[i] + c.b[i];
  rr = sum9(c.r);
  rb = sum9(c.b);
  rho = rr + rb;
}

// The state at (x, y) after the inlet rows (row ny-2 rewritten, row ny-1 a
// ghost copy of it on fluid cells).
template <typename S, int L, typename C = typename Traits<S>::C>
__device__ void load_inlet_stage(const S* __restrict__ s, const S* __restrict__ s2,
                                 const C* __restrict__ geo, const CsfParams& P, int x,
                                 int y, Cell<C, L>& c) {
  const size_t n = (size_t)P.ny * P.nx;
  if (P.inlet != 0) {
    const int yi = P.ny - 2;
    if (y == P.ny - 1 && geo[(size_t)y * P.nx + x] > C(0.5)) y = yi;
    if (y == yi) {
      const size_t k = (size_t)yi * P.nx + x;
      load_raw<S, L>(s, s2, geo, n, k, c);
      if (geo[k] > C(0.5)) apply_inlet(c, P);
      return;
    }
  }
  load_raw<S, L>(s, s2, geo, n, (size_t)y * P.nx + x, c);
}

// The state at (x, y) after all boundary rows (ColorGradientRK._apply_bcs_c
// and _apply_inlet/_apply_outlet: inlet first, then the outlet).
template <typename S, int L, typename C = typename Traits<S>::C>
__device__ void load_state(const S* __restrict__ s, const S* __restrict__ s2,
                           const C* __restrict__ geo, const CsfParams& P, int x, int y,
                           Cell<C, L>& c) {
  if (P.outlet == 1 && y <= 2) {
    // convective: rows 2, 1, 0 each copy the (fresh) row above on fluid cells
    int r = y;
    while (r <= 2 && geo[(size_t)r * P.nx + x] > C(0.5)) ++r;
    load_inlet_stage<S, L>(s, s2, geo, P, x, r, c);
    return;
  }
  if (P.outlet == 2 && y <= 1) {
    if (y == 0 && geo[x] > C(0.5)) y = 1;  // ghost row 0 copies row 1
    if (y == 1) {
      load_inlet_stage<S, L>(s, s2, geo, P, x, 1, c);
      if (geo[(size_t)P.nx + x] > C(0.5)) apply_outlet(c, P);
      return;
    }
  }
  load_inlet_stage<S, L>(s, s2, geo, P, x, y, c);
}

// phi = (rho_r - rho_b) / (rho_r + rho_b) on fluid cells, 0 elsewhere.
template <typename S, int L, typename C = typename Traits<S>::C>
__device__ C phi_at(const S* __restrict__ s, const S* __restrict__ s2,
                    const C* __restrict__ geo, const CsfParams& P, int x, int y) {
  if (!(geo[(size_t)y * P.nx + x] > C(0.5))) return C(0);
  Cell<C, L> c;
  load_state<S, L>(s, s2, geo, P, x, y, c);
  C f[9], rr, rb, rho;
  totals(c, f, rr, rb, rho);
  const C tot = rr + rb;
  return tot != C(0) ? (rr - rb) / tot : C(0);
}

// Contact-angle rotation of the gradient on a wetting fluid cell
// (ops/colorgrad.py::rotate_gradient_on_wetting_{xu,akai}).
template <typename C>
__device__ void rotate_wetting(C& gx, C& gy, C nsx, C nsy, const CsfParams& P) {
  const C cos_t = C(P.cos_t), sin_t = C(P.sin_t);
  const C norm = sqrt(gx * gx + gy * gy);
  const bool ok = norm > C(kEps);
  if (P.wetting_type == 2) {
    const C ux = ok ? -gx / norm : C(0);
    const C uy = ok ? -gy / norm : C(0);
    const C dot = fmin(fmax(ux * nsx + uy * nsy, C(-1)), C(1));
    const C th = acos(dot);
    const C sin_gs = sin(th);
    const bool oks = fabs(sin_gs) > C(1.0e-9);
    const C c1 = oks ? sin_t * cos(th) / sin_gs : C(0);
    const C c2 = oks ? sin_t / sin_gs : C(0);
    const C n1x = (cos_t - c1) * nsx + c2 * ux, n1y = (cos_t - c1) * nsy + c2 * uy;
    const C n2x = (cos_t + c1) * nsx - c2 * ux, n2y = (cos_t + c1) * nsy - c2 * uy;
    const C d1 = sqrt((n1x - ux) * (n1x - ux) + (n1y - uy) * (n1y - uy));
    const C d2 = sqrt((n2x - ux) * (n2x - ux) + (n2y - uy) * (n2y - uy));
    if (d1 == d2) return;  // ties keep their gradient
    const bool pick1 = d1 < d2;
    gx = -norm * (pick1 ? n1x : n2x);
    gy = -norm * (pick1 ? n1y : n2y);
  } else {
    const C n1x = nsx * cos_t - nsy * sin_t, n1y = nsy * cos_t + nsx * sin_t;
    const C n2x = nsx * cos_t + nsy * sin_t, n2y = nsy * cos_t - nsx * sin_t;
    const C ux = ok ? gx / norm : C(0);
    const C uy = ok ? gy / norm : C(0);
    const C d1 = sqrt((ux - n1x) * (ux - n1x) + (uy - n1y) * (uy - n1y));
    const C d2 = sqrt((ux - n2x) * (ux - n2x) + (uy - n2y) * (uy - n2y));
    const C mx = d1 < d2 ? n1x : (d1 > d2 ? n2x : nsx);
    const C my = d1 < d2 ? n1y : (d1 > d2 ? n2y : nsy);
    gx = norm * mx;
    gy = norm * my;
  }
}

// The colour gradient 3 sum_i w_i e_i phi_ext(x + e_i), with phi_at(i)
// giving phi_ext of neighbour i (the strip marches and the T-step kernels).
template <typename C, typename PhiAt>
__device__ __forceinline__ void phi_gradient(PhiAt phi_at_i, C& gx, C& gy) {
  gx = C(0);
  gy = C(0);
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    const C sv = phi_at_i(i);
    if (ex(i)) gx = gx + C(wq(i) * ex(i)) * sv;
    if (ey(i)) gy = gy + C(wq(i) * ey(i)) * sv;
  }
  gx = C(3) * gx;
  gy = C(3) * gy;
}

// The unit normal of the (wetted) gradient on a cell of fluid mask fl:
// inward (-g / |g|, |g| > eps) for Akai wetting, g / |g| otherwise.
template <typename C>
__device__ __forceinline__ void unit_normal(C gx, C gy, C fl, const CsfParams& P, C& nx,
                                            C& ny) {
  const bool inward = P.wetting_type == 2;
  const C norm = sqrt(gx * gx + gy * gy);
  const bool ok = norm > C(inward ? kEps : 0.0);
  const C sgn = inward ? C(-1) : C(1);
  nx = (ok ? sgn * gx / norm : C(0)) * fl;
  ny = (ok ? sgn * gy / norm : C(0)) * fl;
}

template <typename C>
__device__ __forceinline__ C tau_at(C phi, C rr, C rb, const CsfParams& P) {
  if (phi > C(P.delta)) return C(P.tau_r);
  if (phi < C(-P.delta)) return C(P.tau_b);
  if (P.tau_type == 1)
    return C(0.5) + C(1) / ((C(1) + phi) / C(2.0 * (P.tau_r - 0.5)) +
                            (C(1) - phi) / C(2.0 * (P.tau_b - 0.5)));
  C tot = rr + rb;
  tot = tot != C(0) ? tot : C(1);
  const C mu = C(1) / ((rr / tot) * C(3.0 / (P.tau_r - 0.5)) +
                       (rb / tot) * C(3.0 / (P.tau_b - 0.5)));
  return C(3) * mu + C(0.5);
}

// CSF force plus body force on a fluid cell of total density rho and
// gradient (gx, gy): the curvature comes from the isotropic derivatives of
// the unit normals around it, normal_at(i, sx, sy) giving neighbour i's and
// (nhx, nhy) the cell's own (ops/colorgrad.py::csf_force).
template <typename C, typename NormalAt>
__device__ __forceinline__ void csf_force(NormalAt normal_at, C nhx, C nhy, C gx, C gy,
                                          C rho, const CsfParams& P, C& fx, C& fy) {
  C dxnx = C(0), dxny = C(0), dynx = C(0), dyny = C(0);
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    C sx, sy;
    normal_at(i, sx, sy);
    const double w3 = 3.0 * wq(i);
    if (ex(i)) {
      dxny = dxny + C(w3 * ex(i)) * sy;
      dxnx = dxnx + C(w3 * ex(i)) * sx;
    }
    if (ey(i)) {
      dynx = dynx + C(w3 * ey(i)) * sx;
      dyny = dyny + C(w3 * ey(i)) * sy;
    }
  }
  const C kappa = nhx * nhy * (dxny + dynx) - nhy * nhy * dxnx - nhx * nhx * dyny;
  const C ks = C((P.wetting_type == 2 ? -0.5 : 0.5) * P.sigma) * kappa;
  fx = ks * gx;
  fy = ks * gy;
  if (P.bfx != 0.0 || P.bfy != 0.0) {
    fx = fx + C(P.bfx) * rho;
    fy = fy + C(P.bfy) * rho;
  }
}

// Post-collision total PDF of one fluid cell from its total PDF f, colour
// densities, phi, gradient and force, plus its recolouring factors: the
// fraction rr / rho and segc = beta rr rb / rho (lkr_factors turns segc
// into the red segregation terms A, B).
template <typename C>
__device__ __forceinline__ void collide_core(const C f[9], C rr, C rb, C rho, C ph, C fx,
                                             C fy, const CsfParams& P, C post[9], C& frac,
                                             C& segc) {
  const C rho_safe = rho > C(0) ? rho : C(1);
  C mx = C(0), my = C(0);
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    if (ex(i)) mx = mx + C(ex(i)) * f[i];
    if (ey(i)) my = my + C(ey(i)) * f[i];
  }
  const C ux = (mx + C(0.5) * fx) / rho_safe;
  const C uy = (my + C(0.5) * fy) / rho_safe;
  const C tau = tau_at(ph, rr, rb, P);

  const C uu = ux * ux + uy * uy;
  C feq[9], src[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const C exi = C(ex(i)), eyi = C(ey(i));
    const C eu = exi * ux + eyi * uy;
    feq[i] = C(wq(i)) * rho * (C(1) + C(3) * eu + C(4.5) * eu * eu - C(1.5) * uu);
    src[i] = C(wq(i)) * ((C(3) * (exi - ux) + C(9) * exi * eu) * fx +
                         (C(3) * (eyi - uy) + C(9) * eyi * eu) * fy);
  }
  if (P.mrt) {
    // f' = f - M^-1 S (M (f - feq)) + src - 0.5 M^-1 S (M src), with the
    // RK relaxation vector and s_7 = s_8 = 1/tau(phi)
    const C inv_tau = C(1) / tau;
    C sm[9], ss[9];
#pragma unroll
    for (int a = 0; a < 9; ++a) {
      C m = C(0), q = C(0);
#pragma unroll
      for (int b = 0; b < 9; ++b) {
        if (mm(a, b) != 0.0) {
          m = m + C(mm(a, b)) * (f[b] - feq[b]);
          q = q + C(mm(a, b)) * src[b];
        }
      }
      C sa;
      switch (a) {
        case 1: sa = C(1.64); break;
        case 2: sa = C(1.54); break;
        case 4: case 6: sa = C(1.9); break;
        case 7: case 8: sa = inv_tau; break;
        default: sa = C(0);
      }
      sm[a] = sa * m;
      ss[a] = sa * q;
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      C c1 = C(0), c2 = C(0);
#pragma unroll
      for (int a = 0; a < 9; ++a) {
        if (mm(a, i) != 0.0 && a != 0 && a != 3 && a != 5) {
          const C mi = C(mm(a, i) / mnorm(a));
          c1 = c1 + mi * sm[a];
          c2 = c2 + mi * ss[a];
        }
      }
      post[i] = (f[i] - c1) + (src[i] - C(0.5) * c2);
    }
  } else {
    const C pref = C(1) - C(0.5) / tau;
#pragma unroll
    for (int i = 0; i < 9; ++i) post[i] = f[i] - (f[i] - feq[i]) / tau + pref * src[i];
  }

  // LKR recolouring factors
  const C tot = rr + rb;
  const C tot_safe = tot != C(0) ? tot : C(1);
  frac = rr / tot_safe;
  segc = C(P.beta) * rr * rb / tot_safe;
}

// The red post-collision population is frac * post_i + w_i (e_ix A + e_iy B)
// with (A, B) = segc g / |g| (0 where |g| <= eps).
template <typename C>
__device__ __forceinline__ void lkr_factors(C segc, C gx, C gy, C& A, C& B) {
  const C norm = sqrt(gx * gx + gy * gy);
  if (norm > C(kEps)) {
    A = segc * (gx / norm);
    B = segc * (gy / norm);
  } else {
    A = C(0);
    B = C(0);
  }
}

template <typename S, typename C = typename Traits<S>::C>
__device__ __forceinline__ void store_state(S* __restrict__ out, size_t n, size_t k,
                                            const C o[9], C rr, C fl) {
  if constexpr (Traits<S>::kShifted) {
#pragma unroll
    for (int i = 0; i < 9; ++i) out[i * n + k] = __float2bfloat16_rn(o[i] - C(wq(i)) * fl);
    const __nv_bfloat16 hi = __float2bfloat16_rn(rr);
    out[9 * n + k] = hi;
    out[10 * n + k] = __float2bfloat16_rn(rr - __bfloat162float(hi));
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) out[i * n + k] = o[i];
    out[9 * n + k] = rr;
  }
}

// -- the strip march: the flow step in one launch (K1, K2, K6) ---------------

// Launches by this library since it was loaded, one where each launch is
// made (coupled2d.cu's tracer_strip_kernel, strip_kernel, pert2d.cu's
// pert_strip_kernel); <library>_kernel_launches reads them.
long long g_csf_launches[3];

// A cell's state (after the boundary rows, in compute precision) in a
// ring of planes `stride` apart: f and rho_r, or f_r and f_b.
template <int L>
__host__ __device__ constexpr int cell_planes() {
  return L == kSplit ? 18 : 10;
}
template <typename C, int L>
__device__ __forceinline__ void cell_put(C* p, int stride, const Cell<C, L>& c) {
  if constexpr (L == kSplit) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      p[i * stride] = c.r[i];
      p[(9 + i) * stride] = c.b[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) p[i * stride] = c.f[i];
    p[9 * stride] = c.rr;
  }
}
template <typename C, int L>
__device__ __forceinline__ void cell_get(const C* p, int stride, Cell<C, L>& c) {
  if constexpr (L == kSplit) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      c.r[i] = p[i * stride];
      c.b[i] = p[(9 + i) * stride];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) c.f[i] = p[i * stride];
    c.rr = p[9 * stride];
  }
}

// The rings of a strip (shared memory, compute type C): rows of TX + 2h
// cells, row r of the domain in slot (r - y0 + 4) mod depth.
//   phi    phi and the fluid flag, a 4-column halo, 4 rows ahead of the
//          output rows (3 with the push; the normals of the collided rows
//          reach 2 more), and the cells' state as the phi pass decoded it,
//          kept for the collision over its columns (a 1-column halo);
//   nrm    the wetted gradient and the unit normal (4 planes), a 2-column
//          halo, 2 rows ahead (1 with the push);
//   post   post, frac, A, B (12 planes) and the fluid flag, a 1-column
//          halo, 1 row ahead (the pull's reach).
// The split layout pushes: it keeps no post ring, collides its own columns
// and writes each value to its slot, and its push shares a phase with the
// next step's phi rows (so the phi ring holds 2 TY + 4 rows).
constexpr int RUN_H = 32;   // rows of a run: the grid's y blocks
// threads a block: the phi pass's TX + 8 columns of TY rows in one round
// (the normals' TX + 4 and the collision's TX + 2 too); TX * TY of them
// stream a step's rows
constexpr int STRIP_THREADS = (TX + 8) * TY;
template <typename C, int L>
struct StripRings {
  static constexpr bool PUSH = L == kSplit;
  static constexpr int PW = TX + 8, PR = PUSH ? 2 * TY + 4 : TY + 4;
  static constexpr int NW = TX + 4, NR = TY + 2;
  static constexpr int QW = PUSH ? 0 : TX + 2, QR = TY + 2;
  static constexpr int SW = TX + 2;
  static constexpr int PN = PR * PW, NN = NR * NW, QN = QR * QW, SN = PR * SW;
  static constexpr size_t bytes =
      sizeof(C) * ((size_t)PN + 4 * NN + 12 * QN + cell_planes<L>() * SN) + PN + QN;
};

// resident blocks an SM asked of ptxas (chip_sweep.py 2dcg): the float
// instances are bound by their warps in flight, not their registers
template <typename C, int L>
__host__ __device__ constexpr int strip_min_blocks() {
  return sizeof(C) == 8 ? 1 : (L == kSplit ? 3 : 4);
}

// One flow step by the strip march (the note at the top).  A block of
// STRIP_THREADS threads owns TX columns of a run of RUN_H rows and steps
// down it TY rows at a time: phi of TY new rows, then their normals, then
// the collision of TY new rows, then the pull of TY output rows (or, split,
// the collision of the step's own rows pushed to their slots), a barrier
// between.  Rows formed by an earlier step stay in the rings; a run starts
// by forming the rows above its first (the prologue).
template <typename S, int L, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(STRIP_THREADS, strip_min_blocks<C, L>())
strip_kernel(const S* __restrict__ s, const S* __restrict__ s2, const C* __restrict__ geo,
             S* __restrict__ out, S* __restrict__ out2, CsfParams P) {
  using R = StripRings<C, L>;
  extern __shared__ __align__(16) unsigned char strip_smem[];
  C* const ph = reinterpret_cast<C*>(strip_smem);
  C* const nm = ph + R::PN;
  C* const po = nm + 4 * R::NN;
  C* const sc = po + 12 * R::QN;
  unsigned char* const pf = reinterpret_cast<unsigned char*>(sc + cell_planes<L>() * R::SN);
  unsigned char* const qf = pf + R::PN;
  const int nx = P.nx, ny = P.ny;
  const size_t n = (size_t)ny * nx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * RUN_H;
  const int y1 = min(y0 + RUN_H, ny);
  const int tid = threadIdx.x;
  // the output cell of thread tid < TX * TY in a step's rows
  const int ty = tid / TX, tx = tid % TX;
  auto slot = [&](int r, int depth) { return (r - y0 + 4) % depth; };

  // phi and the fluid flag of rows [r0, r1), columns x0 - 4 ... x0 + TX + 3
  // (phi_at's arithmetic), and the state of columns x0 - 1 ...
  // x0 + TX
  auto form_phi = [&](int r0, int r1) {
    for (int t = tid; t < (r1 - r0) * R::PW; t += STRIP_THREADS) {
      const int lx = t % R::PW, r = r0 + t / R::PW;
      const int x = wrap(x0 - 4 + lx, nx), y = wrap(r, ny);
      const int b = slot(r, R::PR) * R::PW + lx;
      const bool fluid = geo[(size_t)y * nx + x] > C(0.5);
      C phi = C(0);
      if (fluid) {
        Cell<C, L> c;
        load_state<S, L>(s, s2, geo, P, x, y, c);
        if (lx >= 3 && lx < TX + 5)
          cell_put<C, L>(sc + slot(r, R::PR) * R::SW + lx - 3, R::SN, c);
        if (P.phi_repair && y <= 1) {
          // Dirichlet-outlet repair: phi on fluid cells of rows 1, 0 <- row 2
          phi = phi_at<S, L>(s, s2, geo, P, x, 2);
        } else {
          C f[9], rr, rb, rho;
          totals(c, f, rr, rb, rho);
          const C tot = rr + rb;
          phi = tot != C(0) ? (rr - rb) / tot : C(0);
        }
      }
      pf[b] = fluid;
      ph[b] = phi;
    }
  };
  // the wetted gradient and unit normal of rows [r0, r1), columns
  // x0 - 2 ... x0 + TX + 1 (from the phi ring)
  auto form_normal = [&](int r0, int r1) {
    for (int t = tid; t < (r1 - r0) * R::NW; t += STRIP_THREADS) {
      const int lx = t % R::NW, r = r0 + t / R::NW;
      const int x = wrap(x0 - 2 + lx, nx), y = wrap(r, ny);
      const size_t k = (size_t)y * nx + x;
      // phi extended onto solid nodes: the w-weighted mean of the fluid
      // neighbours, num / den as the reference forms it (num times den's
      // reciprocal parts from it by an ulp, which Xu wetting's |g| > 0
      // turns into a unit normal)
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
  // The collision of the fluid cell of unwrapped row r at column lx of the
  // normal ring, from the state the phi pass kept: post, frac, A, B.
  auto collide = [&](int r, int lx, C post[9], C& frac, C& A, C& B) {
    Cell<C, L> c;
    cell_get<C, L>(sc + slot(r, R::PR) * R::SW + lx - 1, R::SN, c);
    C f[9], rr, rb, rho;
    totals(c, f, rr, rb, rho);
    const int nb = slot(r, R::NR) * R::NW + lx;
    const C gx = nm[nb], gy = nm[R::NN + nb];
    C fx, fy, segc;
    csf_force(
        [&](int i, C& sx, C& sy) {
          const int q = slot(r + ey(i), R::NR) * R::NW + lx + ex(i);
          sx = nm[2 * R::NN + q];
          sy = nm[3 * R::NN + q];
        },
        nm[2 * R::NN + nb], nm[3 * R::NN + nb], gx, gy, rho, P, fx, fy);
    collide_core(f, rr, rb, rho, ph[slot(r, R::PR) * R::PW + lx + 2], fx, fy, P, post, frac,
                 segc);
    lkr_factors(segc, gx, gy, A, B);
  };

  if constexpr (R::PUSH) {
    // the split layout: each cell of the strip collided once, its red part
    // frac post_i + seg_i and post_i - red to slot i of x + e_i, or to slot
    // opp(i) of x where x + e_i is solid; a solid cell writes its own zeros
    auto push_rows = [&](int r0) {
      const int r = r0 + ty, x = x0 + tx;
      if (tid >= TX * TY || r >= y1 || x >= nx) return;
      const size_t k = (size_t)r * nx + x;
      const int lx = tx + 2;
      if (!pf[slot(r, R::PR) * R::PW + lx + 2]) {
#pragma unroll
        for (int i = 0; i < 9; ++i) out[i * n + k] = out2[i * n + k] = C(0);
        return;
      }
      C post[9], frac, A, B;
      collide(r, lx, post, frac, A, B);
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        const C red = frac * post[i] + C(wq(i)) * (C(ex(i)) * A + C(ey(i)) * B);
        size_t kt = k + (size_t)i * n;
        if (i != 0) {
          if (pf[slot(r + ey(i), R::PR) * R::PW + lx + 2 + ex(i)]) {
            int tx = x + ex(i), ty = r + ey(i);
            tx = tx < 0 ? tx + nx : (tx >= nx ? tx - nx : tx);
            ty = ty < 0 ? ty + ny : (ty >= ny ? ty - ny : ty);
            kt = (size_t)i * n + (size_t)ty * nx + tx;
          } else {
            kt = (size_t)opp(i) * n + k;   // bounced back from the solid x + e_i
          }
        }
        out[kt] = red;
        out2[kt] = post[i] - red;
      }
    };
    form_phi(y0 - 3, min(y0 + TY, y1) + 3);
    __syncthreads();
    form_normal(y0 - 1, min(y0 + TY, y1) + 1);
    for (int a = y0; a < y1; a += TY) {
      // e: this step's last row + 1 (a last step may stop short), e2 the
      // next step's
      const int e = min(a + TY, y1), e2 = min(a + 2 * TY, y1);
      __syncthreads();
      if (e < y1) form_phi(e + 3, e2 + 3);
      push_rows(a);
      __syncthreads();
      if (e < y1) form_normal(e + 1, e2 + 1);
    }
  } else {
    // the post ring of rows [r0, r1), columns x0 - 1 ... x0 + TX (a strip
    // cut short by the domain's edge collides the columns it reads)
    const int qn = min(R::QW, nx - x0 + 2);
    auto form_post = [&](int r0, int r1) {
      for (int t = tid; t < (r1 - r0) * R::QW; t += STRIP_THREADS) {
        const int lx = t % R::QW, r = r0 + t / R::QW;
        if (lx >= qn) continue;
        const int b = slot(r, R::QR) * R::QW + lx;
        const bool fluid = pf[slot(r, R::PR) * R::PW + lx + 3];
        qf[b] = fluid;
        C post[9], frac = C(0), A = C(0), B = C(0);
        if (fluid) {
          collide(r, lx + 1, post, frac, A, B);
        } else {
#pragma unroll
          for (int i = 0; i < 9; ++i) post[i] = C(0);
        }
#pragma unroll
        for (int i = 0; i < 9; ++i) po[i * R::QN + b] = post[i];
        po[9 * R::QN + b] = frac;
        po[10 * R::QN + b] = A;
        po[11 * R::QN + b] = B;
      }
    };
    // pull streaming with half-way bounce-back of the output rows
    // [r0, r0 + TY) from the post ring (the compressed layouts: the streamed
    // total and rho_r' = the sum of the streamed red parts)
    auto stream_rows = [&](int r0) {
      const int r = r0 + ty, x = x0 + tx;
      if (tid >= TX * TY || r >= y1 || x >= nx) return;
      const size_t k = (size_t)r * nx + x;
      const int lx = tx + 1;
      auto q = [&](int dy, int dx) { return slot(r + dy, R::QR) * R::QW + lx + dx; };
      // o: the streamed total PDF; red: its red part, frac * post_j + seg_j
      // at the source cell (the blue part is o - red, csf.py:1016)
      C o[9], red[9];
      C rr_new = C(0);
      if (qf[q(0, 0)]) {
        const int b = q(0, 0);
        o[0] = po[b];
        red[0] = po[9 * R::QN + b] * o[0];
        rr_new = red[0];
#pragma unroll
        for (int i = 1; i < 9; ++i) {
          // pull from the upwind cell x - e_i, or bounce back from a solid one
          int src = q(-ey(i), -ex(i)), j = i;
          if (!qf[src]) {
            src = b;
            j = opp(i);
          }
          o[i] = po[j * R::QN + src];
          const C seg = C(wq(j)) * (C(ex(j)) * po[10 * R::QN + src] +
                                    C(ey(j)) * po[11 * R::QN + src]);
          red[i] = po[9 * R::QN + src] * o[i] + seg;
          rr_new = rr_new + red[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 9; ++i) o[i] = red[i] = C(0);
      }
      store_state<S>(out, n, k, o, rr_new, geo[k]);
    };
    form_phi(y0 - 4, y0 + 4);
    __syncthreads();
    form_normal(y0 - 2, y0 + 2);
    __syncthreads();
    form_post(y0 - 1, y0 + 1);
    __syncthreads();
    for (int a = y0; a < y1; a += TY) {
      // the stream of the step before reads the post ring alone; a last
      // step may stop short
      const int e = min(a + TY, y1);
      form_phi(a + 4, e + 4);
      __syncthreads();
      form_normal(a + 2, e + 2);
      __syncthreads();
      form_post(a + 1, e + 1);
      __syncthreads();
      stream_rows(a);
    }
  }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory on the
// current device, once: done[d] is set for each device d on which it has
// (an attribute of the function on each device; a launch then costs the
// host no call for it).
template <typename K>
cudaError_t opt_in_smem(K kernel, size_t smem, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// The flow step: one launch of the strip march.  s2_in/s2_out are f_b in
// the split layout and unused in the compressed one.
template <typename S, int L>
int launch_flow(const void* s_in, const void* s2_in, void* s_out, void* s2_out,
                const void* geo_v, const CsfParams& P, cudaStream_t st) {
  using C = typename Traits<S>::C;
  constexpr size_t smem = StripRings<C, L>::bytes;
  auto kernel = strip_kernel<S, L>;
  static bool opted[64];   // this instance's devices
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in_smem(kernel, smem, opted);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((P.nx + TX - 1) / TX, (P.ny + RUN_H - 1) / RUN_H);
  kernel<<<grid, STRIP_THREADS, smem, st>>>(
      static_cast<const S*>(s_in), static_cast<const S*>(s2_in),
      static_cast<const C*>(geo_v), static_cast<S*>(s_out), static_cast<S*>(s2_out), P);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_csf_launches[1];
  return (int)err;
}
}  // namespace
