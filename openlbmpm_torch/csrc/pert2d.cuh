// Device code of the Rothman-Keller Perturbation step (Liu et al. 2014),
// D2Q9, for NVIDIA Hopper (sm_90a), shared by pert2d.cu (K4, one step a
// launch) and csf2d_block.cuh (K3, T steps a launch): the RK-original
// equilibria, SRT/MRT relaxation, the perturbation operator, the Grunau
// tau(phi), the gradient of rho_r - rho_b and one fluid cell's collision
// with its RK-original recolouring.  The formulas follow the jnp path
// (ColorGradientRK._step_pert_c / _step_perturbation and ops/).  Include
// after csf2d.cuh.

#pragma once

#include "csf2d.cuh"

namespace {

constexpr double kSqrt2 = 1.4142135623730951;
// Perturbation constants B_i (ops/colorgrad.py::B_CONSTANTS): rest, axis,
// diagonal
constexpr double kB0 = -4.0 / 27.0, kBa = 2.0 / 27.0, kBd = 5.0 / 108.0;

__device__ __forceinline__ double pick3(const double c[3], int i) {
  return i == 0 ? c[0] : (i < 5 ? c[1] : c[2]);
}
__device__ __forceinline__ double bq(int i) {
  return i == 0 ? kB0 : (i < 5 ? kBa : kBd);
}

// rho (C_i + w_i (3 e.u + 4.5 (e.u)^2 - 1.5 u.u)) for all i
// (ops/equilibrium.py::feq_rk_original)
template <typename C>
__device__ __forceinline__ void feq_rk(C rho, C ux, C uy, C uu, const double cc[3],
                                       C feq[9]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const C eu = C(ex(i)) * ux + C(ey(i)) * uy;
    feq[i] = rho * (C(pick3(cc, i)) +
                    C(wq(i)) * (C(3.0) * eu + C(4.5) * eu * eu - C(1.5) * uu));
  }
}

// f <- f - (f - feq) / tau (SRT), or f - M^-1 S M (f - feq) with the RK
// relaxation vector and s_7 = s_8 = 1/tau (MRT)
template <typename C>
__device__ __forceinline__ void relax(C f[9], const C feq[9], C tau, int mrt) {
  if (mrt) {
    const C inv_tau = C(1) / tau;
    C sm[9];
#pragma unroll
    for (int a = 0; a < 9; ++a) {
      C m = C(0);
#pragma unroll
      for (int b = 0; b < 9; ++b)
        if (mm(a, b) != 0.0) m = m + C(mm(a, b)) * (f[b] - feq[b]);
      C sa;
      switch (a) {
        case 1: sa = C(1.64); break;
        case 2: sa = C(1.54); break;
        case 4: case 6: sa = C(1.9); break;
        case 7: case 8: sa = inv_tau; break;
        default: sa = C(0);
      }
      sm[a] = sa * m;
    }
    C out[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      C c1 = C(0);
#pragma unroll
      for (int a = 0; a < 9; ++a)
        if (mm(a, i) != 0.0 && a != 0 && a != 3 && a != 5)
          c1 = c1 + C(mm(a, i) / mnorm(a)) * sm[a];
      out[i] = f[i] - c1;
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) f[i] = out[i];
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) f[i] = f[i] - (f[i] - feq[i]) / tau;
  }
}

// f_i += (A/2) |g| (w_i (e_i.g)^2 / |g|^2 - B_i) where |g|^2 > 0
// (ops/colorgrad.py::perturbation)
template <typename C>
__device__ __forceinline__ void perturb(C f[9], C gx, C gy, C g2, C norm, double a) {
  if (!(g2 > C(0))) return;
  const C pre = C(0.5 * a) * norm;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const C eg = C(ex(i)) * gx + C(ey(i)) * gy;
    f[i] = f[i] + pre * (C(wq(i)) * eg * eg / g2 - C(bq(i)));
  }
}

// Grunau quadratic tau(phi) (ops/colorgrad.py::tau_interp_grunau)
template <typename C>
__device__ __forceinline__ C tau_grunau(C phi, const CsfParams& P) {
  const double tr = P.tau_r, tb = P.tau_b, d = P.delta;
  const double s1 = 2.0 * tr * tb / (tr + tb);
  const double s2 = 2.0 * (tr - s1) / d;
  const double s3 = -s2 / (2.0 * d);
  const double t2 = 2.0 * (s1 - tb) / d;
  const double t3 = t2 / (2.0 * d);
  if (phi > C(d)) return C(tr);
  if (phi > C(0)) return C(s1) + C(s2) * phi + C(s3) * phi * phi;
  if (phi >= C(-d)) return C(s1) + C(t2) * phi + C(t3) * phi * phi;
  return C(tb);
}

// The gradient of d = rho_r - rho_b (solid_phi on solid cells) with the
// axis and diagonal weights of P; d_at(i) gives neighbour i's d.
template <typename C, typename DAt>
__device__ __forceinline__ void pert_gradient(DAt d_at, const CsfParams& P, C& gx, C& gy) {
  gx = C(0);
  gy = C(0);
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    const C v = d_at(i);
    const double w = i < 5 ? P.grad_wa : P.grad_wd;
    if (ex(i)) gx = gx + C(w * ex(i)) * v;
    if (ey(i)) gy = gy + C(w * ey(i)) * v;
  }
}

// One fluid cell's Perturbation collision: c is its state after the
// boundary rows (overwritten), phi its phase field (outlet repair applied)
// and (gx, gy) the gradient of d around it.  post: the post-collision total
// PDF; red: its red part frac post_i + segb feq_rho_i cos_i.
template <typename C, int L>
__device__ __forceinline__ void pert_collide(Cell<C, L>& c, C phi, C gx, C gy,
                                             const CsfParams& P, C post[9], C red[9]) {
  C f[9], rr, rb, rho;
  totals(c, f, rr, rb, rho);
  const C tot = rr + rb;
  const C rho_safe = rho > C(0) ? rho : C(1);
  C mx = C(0), my = C(0);
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    if (ex(i)) mx = mx + C(ex(i)) * f[i];
    if (ey(i)) my = my + C(ey(i)) * f[i];
  }
  const C ux = mx / rho_safe, uy = my / rho_safe;
  const C uu = ux * ux + uy * uy;
  const C tau = tau_grunau(phi, P);
  const C g2 = gx * gx + gy * gy;
  const C norm = sqrt(g2);

  if constexpr (L == kSplit) {
    C feq[9];
    feq_rk(rr, ux, uy, uu, P.c_r, feq);
    relax(c.r, feq, tau, P.mrt);
    feq_rk(rb, ux, uy, uu, P.c_b, feq);
    relax(c.b, feq, tau, P.mrt);
    perturb(c.r, gx, gy, g2, norm, P.a_kr);
    perturb(c.b, gx, gy, g2, norm, P.a_kb);
#pragma unroll
    for (int i = 0; i < 9; ++i) post[i] = c.r[i] + c.b[i];
  } else {
    C feq_r[9], feq_b[9];
    feq_rk(rr, ux, uy, uu, P.c_r, feq_r);
    feq_rk(rb, ux, uy, uu, P.c_b, feq_b);
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      post[i] = f[i];
      feq_r[i] = feq_r[i] + feq_b[i];
    }
    relax(post, feq_r, tau, P.mrt);
    perturb(post, gx, gy, g2, norm, P.a_kr + P.a_kb);
  }

  // RK-original recolouring (ops/colorgrad.py::recolor_rk_original)
  const C rho_s = tot != C(0) ? tot : C(1);
  const C frac = rr / rho_s;
  const C segb = C(P.beta) * rr * rb / (rho_s * rho_s);
  const bool ok = norm > C(kEps);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    C cos_t = C(0);
    if (ok) {
      const C eg = C(ex(i)) * gx + C(ey(i)) * gy;
      cos_t = eg / norm / C(i < 5 ? 1.0 : kSqrt2);
    }
    const C feq_rho = rr * C(pick3(P.c_r, i)) + rb * C(pick3(P.c_b, i));
    red[i] = frac * post[i] + segb * feq_rho * cos_t;
  }
}

}  // namespace
