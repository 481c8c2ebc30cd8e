// Compressed CSF colour-gradient step, D2Q9, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel openlbmpm_tpu/pallas/csf.py::build_csf_fused_step
// (state_mode="compressed", steps_per_call=1) for storage "f32" and "bf16";
// the same templates also build an f64-state instance, so the card can check
// the kernel against the plain PyTorch path to ~1e-12.
//
// One step = boundary rows -> rho, phi (+ outlet phi repair) -> solid-phi
// extrapolation -> isotropic gradient -> contact-angle rotation -> unit
// normal -> curvature and CSF force -> u, tau(phi) -> SRT or MRT collision
// with the Guo source -> LKR recolouring of the red density -> pull
// streaming with half-way bounce-back.  Its formulas follow the jnp path
// (ColorGradientRK._step_csf_c and ops/), not the TPU kernel's strip
// windows, rolls and banding.
//
// Three launches per step, one thread per cell, x fastest (coalesced):
//   1. phase_kernel    state -> phi (one plane, compute type)
//   2. normal_kernel   phi -> gx, gy, n_x, n_y (four planes)
//   3. collide_stream  state, phi, normals -> state'.  A 32x8 tile collides
//      its cells plus a one-cell ring into shared memory, then pull-streams
//      from there; the ring is recomputed by each neighbouring tile.
// The boundary rows (inlet rows ny-2, ny-1; outlet rows 0-2) are applied
// on the fly wherever a kernel reads the state, in compute precision, so no
// kernel writes a boundary-corrected state back to memory: the bf16 state
// is never re-rounded on those rows (the TPU kernel rewrites them on its
// f32 window for the same reason).
//
// What bounds it: HBM bytes per cell-step.  A single fused pass would move
// 80 B (f32 state read + write) or 44 B (bf16).  This split design moves
// about 180 B (f32) or 126 B (bf16): the state is read twice (phase and
// collide_stream), phi (4 B) and the four normal planes (16 B) are written
// and read back, and the fluid and wetting planes (4 B each) are read by
// each kernel (ns_x, ns_y and den_inv only at wall cells).  Stencil
// neighbour re-reads hit L1/L2.  Fusing phase and normal into
// collide_stream (a wider ring) is the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

struct CsfParams {       // mirrored by kernels/csf.py::CsfParams
  int ny, nx;
  int inlet;             // 0 periodic, 1 neumann, 2 dirichlet
  int outlet;            // 0 periodic, 1 convective, 2 dirichlet
  int phi_repair;
  int has_wetting;
  int wetting_type;      // 1 Xu 2017, 2 Akai 2018 (inward normal)
  int tau_type;          // 1 | 2
  int mrt;
  int pad;
  double tau_r, tau_b, sigma, beta, delta, cos_t, sin_t, bfx, bfy;
  double inlet_velocity, inlet_rho, outlet_rho;
};

namespace {

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

template <typename S, typename C = typename Traits<S>::C>
__device__ __forceinline__ void load_raw(const S* __restrict__ s,
                                         const C* __restrict__ geo, size_t n,
                                         size_t k, C f[9], C& rr) {
#pragma unroll
  for (int i = 0; i < 9; ++i) f[i] = to_c(s[i * n + k]);
  if constexpr (Traits<S>::kShifted) {
    const C fl = geo[k];
#pragma unroll
    for (int i = 0; i < 9; ++i) f[i] = f[i] + C(wq(i)) * fl;
    rr = to_c(s[9 * n + k]) + to_c(s[10 * n + k]);
  } else {
    rr = to_c(s[9 * n + k]);
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

// The state at (x, y) after the inlet rows (row ny-2 rewritten, row ny-1 a
// ghost copy of it on fluid cells).
template <typename S, typename C = typename Traits<S>::C>
__device__ void load_inlet_stage(const S* __restrict__ s, const C* __restrict__ geo,
                                 const CsfParams& P, int x, int y, C f[9], C& rr) {
  const size_t n = (size_t)P.ny * P.nx;
  if (P.inlet != 0) {
    const int yi = P.ny - 2;
    if (y == P.ny - 1 && geo[(size_t)y * P.nx + x] > C(0.5)) y = yi;
    if (y == yi) {
      const size_t k = (size_t)yi * P.nx + x;
      load_raw(s, geo, n, k, f, rr);
      if (geo[k] > C(0.5)) {
        if (P.inlet == 1) inlet_neumann(f, rr, P.inlet_velocity);
        else inlet_dirichlet(f, rr, P.inlet_rho);
      }
      return;
    }
  }
  load_raw(s, geo, n, (size_t)y * P.nx + x, f, rr);
}

// The state at (x, y) after all boundary rows (ColorGradientRK._apply_bcs_c:
// inlet first, then the outlet).
template <typename S, typename C = typename Traits<S>::C>
__device__ void load_state(const S* __restrict__ s, const C* __restrict__ geo,
                           const CsfParams& P, int x, int y, C f[9], C& rr) {
  if (P.outlet == 1 && y <= 2) {
    // convective: rows 2, 1, 0 each copy the (fresh) row above on fluid cells
    int r = y;
    while (r <= 2 && geo[(size_t)r * P.nx + x] > C(0.5)) ++r;
    load_inlet_stage(s, geo, P, x, r, f, rr);
    return;
  }
  if (P.outlet == 2 && y <= 1) {
    if (y == 0 && geo[x] > C(0.5)) y = 1;  // ghost row 0 copies row 1
    if (y == 1) {
      load_inlet_stage(s, geo, P, x, 1, f, rr);
      if (geo[(size_t)P.nx + x] > C(0.5)) outlet_dirichlet(f, rr, P.outlet_rho);
      return;
    }
  }
  load_inlet_stage(s, geo, P, x, y, f, rr);
}

// phi = (rho_r - rho_b) / (rho_r + rho_b) on fluid cells, 0 elsewhere.
template <typename S, typename C = typename Traits<S>::C>
__device__ C phi_at(const S* __restrict__ s, const C* __restrict__ geo,
                    const CsfParams& P, int x, int y) {
  if (!(geo[(size_t)y * P.nx + x] > C(0.5))) return C(0);
  C f[9], rr;
  load_state(s, geo, P, x, y, f, rr);
  const C rb = sum9(f) - rr;
  const C tot = rr + rb;
  return tot != C(0) ? (rr - rb) / tot : C(0);
}

template <typename S, typename C = typename Traits<S>::C>
__global__ void phase_kernel(const S* __restrict__ s, const C* __restrict__ geo,
                             C* __restrict__ phi, CsfParams P) {
  const size_t n = (size_t)P.ny * P.nx;
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int x = (int)(k % P.nx);
  int y = (int)(k / P.nx);
  // Dirichlet-outlet repair: phi on fluid cells of rows 1 and 0 <- row 2
  if (P.phi_repair && y <= 1 && geo[k] > C(0.5)) y = 2;
  phi[k] = phi_at(s, geo, P, x, y);
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

template <typename C>
__global__ void normal_kernel(const C* __restrict__ geo, const C* __restrict__ phi,
                              C* __restrict__ nrm, CsfParams P) {
  const int nx = P.nx, ny = P.ny;
  const size_t n = (size_t)ny * nx;
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int x = (int)(k % nx), y = (int)(k / nx);
  // phi extended onto solid nodes: the w-weighted mean of fluid neighbours
  auto phi_ext = [&](int xx, int yy) -> C {
    xx = wrap(xx, nx);
    yy = wrap(yy, ny);
    const size_t kk = (size_t)yy * nx + xx;
    if (!P.has_wetting || geo[kk] > C(0.5)) return phi[kk];
    C num = C(0);
#pragma unroll
    for (int i = 1; i < 9; ++i)
      num = num + C(wq(i)) * phi[(size_t)wrap(yy + ey(i), ny) * nx + wrap(xx + ex(i), nx)];
    return num * geo[4 * n + kk];
  };
  C gx = C(0), gy = C(0);
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    const C sv = phi_ext(x + ex(i), y + ey(i));
    if (ex(i)) gx = gx + C(wq(i) * ex(i)) * sv;
    if (ey(i)) gy = gy + C(wq(i) * ey(i)) * sv;
  }
  gx = C(3) * gx;
  gy = C(3) * gy;
  if (P.has_wetting && geo[n + k] > C(0.5))
    rotate_wetting(gx, gy, geo[2 * n + k], geo[3 * n + k], P);
  const bool inward = P.wetting_type == 2;
  const C norm = sqrt(gx * gx + gy * gy);
  const bool ok = norm > C(inward ? kEps : 0.0);
  const C sgn = inward ? C(-1) : C(1);
  const C fl = geo[k];
  nrm[k] = gx;
  nrm[n + k] = gy;
  nrm[2 * n + k] = (ok ? sgn * gx / norm : C(0)) * fl;
  nrm[3 * n + k] = (ok ? sgn * gy / norm : C(0)) * fl;
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

// Post-collision total PDF of one fluid cell plus its recolouring factors:
// the red post-collision population is frac * post_i + w_i (e_ix A + e_iy B).
template <typename S, typename C = typename Traits<S>::C>
__device__ void collide_cell(const S* __restrict__ s, const C* __restrict__ geo,
                             const C* __restrict__ phi, const C* __restrict__ nrm,
                             const CsfParams& P, int x, int y, C post[9], C& frac,
                             C& A, C& B) {
  const int nx = P.nx, ny = P.ny;
  const size_t n = (size_t)ny * nx;
  const size_t k = (size_t)y * nx + x;
  C f[9], rr;
  load_state(s, geo, P, x, y, f, rr);
  const C rho = sum9(f);
  const C rb = rho - rr;
  const C ph = phi[k];
  const C gx = nrm[k], gy = nrm[n + k];

  // curvature from the unit normal's isotropic derivatives
  C dxnx = C(0), dxny = C(0), dynx = C(0), dyny = C(0);
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    const size_t kk = (size_t)wrap(y + ey(i), ny) * nx + wrap(x + ex(i), nx);
    const C sx = nrm[2 * n + kk], sy = nrm[3 * n + kk];
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
  const C nhx = nrm[2 * n + k], nhy = nrm[3 * n + k];
  const C kappa = nhx * nhy * (dxny + dynx) - nhy * nhy * dxnx - nhx * nhx * dyny;
  const C ks = C((P.wetting_type == 2 ? -0.5 : 0.5) * P.sigma) * kappa;
  C fx = ks * gx, fy = ks * gy;
  if (P.bfx != 0.0 || P.bfy != 0.0) {
    fx = fx + C(P.bfx) * rho;
    fy = fy + C(P.bfy) * rho;
  }

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
  const C segc = C(P.beta) * rr * rb / tot_safe;
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

template <typename S, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(TX * TY)
collide_stream_kernel(const S* __restrict__ s, const C* __restrict__ geo,
                      const C* __restrict__ phi, const C* __restrict__ nrm,
                      S* __restrict__ out, CsfParams P) {
  constexpr int HX = TX + 2, HY = TY + 2;
  // per ring-tile cell: post-collision total PDF (9), frac, A, B
  __shared__ C sh[12][HY][HX];
  __shared__ unsigned char shfl[HY][HX];
  const int nx = P.nx, ny = P.ny;
  const size_t n = (size_t)ny * nx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int t = tid; t < HX * HY; t += TX * TY) {
    const int lx = t % HX, ly = t / HX;
    const int cx = wrap(x0 - 1 + lx, nx), cy = wrap(y0 - 1 + ly, ny);
    const bool fluid = geo[(size_t)cy * nx + cx] > C(0.5);
    shfl[ly][lx] = fluid;
    C post[9], frac = C(0), A = C(0), B = C(0);
    if (fluid) {
      collide_cell(s, geo, phi, nrm, P, cx, cy, post, frac, A, B);
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) post[i] = C(0);
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) sh[i][ly][lx] = post[i];
    sh[9][ly][lx] = frac;
    sh[10][ly][lx] = A;
    sh[11][ly][lx] = B;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const int lx = threadIdx.x + 1, ly = threadIdx.y + 1;
  const size_t k = (size_t)y * nx + x;
  C o[9];
  C rr_new = C(0);
  if (shfl[ly][lx]) {
    o[0] = sh[0][ly][lx];
    rr_new = sh[9][ly][lx] * o[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) {
      // pull from the upwind cell x - e_i, or bounce back from a solid one
      int sx = lx - ex(i), sy = ly - ey(i), j = i;
      if (!shfl[sy][sx]) {
        sx = lx;
        sy = ly;
        j = opp(i);
      }
      o[i] = sh[j][sy][sx];
      const C seg = C(wq(j)) * (C(ex(j)) * sh[10][sy][sx] + C(ey(j)) * sh[11][sy][sx]);
      rr_new = rr_new + (sh[9][sy][sx] * o[i] + seg);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) o[i] = C(0);
  }
  store_state<S>(out, n, k, o, rr_new, geo[k]);
}

template <typename S>
int launch(const void* s_in, void* s_out, const void* geo_v, void* phi_v, void* nrm_v,
           const CsfParams& P, cudaStream_t st) {
  using C = typename Traits<S>::C;
  const S* s = static_cast<const S*>(s_in);
  S* out = static_cast<S*>(s_out);
  const C* geo = static_cast<const C*>(geo_v);
  C* phi = static_cast<C*>(phi_v);
  C* nrm = static_cast<C*>(nrm_v);
  const size_t n = (size_t)P.ny * P.nx;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  phase_kernel<S><<<blocks, threads, 0, st>>>(s, geo, phi, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  normal_kernel<C><<<blocks, threads, 0, st>>>(geo, phi, nrm, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P.nx + TX - 1) / TX, (P.ny + TY - 1) / TY);
  collide_stream_kernel<S><<<grid, dim3(TX, TY), 0, st>>>(s, geo, phi, nrm, out, P);
  return (int)cudaGetLastError();
}

}  // namespace

// storage: 0 = f64 state, 1 = f32 state, 2 = bf16 11-plane state.
// Returns a cudaError_t code (0 on success).
extern "C" int csf2d_step(int storage, const void* s_in, void* s_out, const void* geo,
                          void* phi, void* nrm, const CsfParams* params,
                          void* stream) {
  const CsfParams P = *params;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0: return launch<double>(s_in, s_out, geo, phi, nrm, P, st);
    case 1: return launch<float>(s_in, s_out, geo, phi, nrm, P, st);
    case 2: return launch<__nv_bfloat16>(s_in, s_out, geo, phi, nrm, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* csf2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
