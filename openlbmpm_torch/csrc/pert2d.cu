// Rothman-Keller Perturbation step (Liu et al. 2014), D2Q9, for NVIDIA
// Hopper (sm_90a): K4.
//
// Replaces the TPU kernel openlbmpm_tpu/pallas/csf.py::build_csf_fused_step
// with variant="Perturbation" at steps_per_call=1 (_substep_pert_c
// :1246-1383, _substep_pert :1118-1243) in its three layouts:
//   K4c  compressed (f_total, rho_r), 10 planes, f32 or f64;
//   K4h  compressed, 11 bf16 planes (f32 arithmetic, as K2);
//   K4s  split (f_r, f_b), two (9, ny, nx) arrays, f32 or f64.
// The f64 instances exist so the card can hold the kernel to the plain
// PyTorch path to ~1e-12; the library is built with -fmad=false
// (kernels/build.py::EXTRA_FLAGS), so products and sums round as the plain
// path's do in every instance.
//
// The state is read through csf2d.cuh's load_state (boundary rows applied
// on the fly, in compute precision, as K1/K6 do), so the rows and the
// CsfParams block are shared with the CSF step.  The formulas follow the
// jnp path (ColorGradientRK._step_pert_c / _step_perturbation and ops/), not
// the TPU kernel's strips and rolls; the compressed equilibrium is the sum
// of the two colours' RK-original equilibria, as the plain path computes
// it (the TPU kernel's lin0/lin_a/lin_d form is equal up to rounding).
//
// One step, one launch.  The stencil reaches two cells (stream <- gradient
// <- densities) and there is no phi extrapolation, normal or curvature, so
// a 32 x TY tile (TY = 8, or 4 for f64 to keep the static shared memory
// under 48 KB):
//   A. stages d = rho_r - rho_b (solid_phi on solid cells) of its cells and
//      a two-cell ring in shared memory;
//   B. collides its cells and a one-cell ring: rho, phi (the Dirichlet-
//      outlet repair reads row 2 again), u = m / rho, Grunau tau(phi),
//      RK-original equilibria, SRT or MRT (per colour in the split layout,
//      on the total PDF in the compressed one), the gradient of d from the
//      staged ring, the perturbation operator, and the RK-original
//      recolouring; it keeps the post-collision total PDF and its red part
//      in shared memory;
//   C. pull-streams its cells with half-way bounce-back.  The compressed
//      layout stores the streamed total and rho_r' = the sum of the
//      streamed red parts; the split one stores the streamed red part and
//      f_b' = stream(post - red), as K6 does.
//
// What bounds it: HBM bytes per cell-step.  The least is the state read
// once and written once plus a 1-byte mask: 81 B (compressed f32), 45 B
// (bf16), 145 B (split f32).  This kernel reads the state in stage A and
// again in stage B (1.3-1.4x the cells with the ring, mostly from L2), and
// the fluid plane (4 or 8 B a cell) in every stage.

#include "csf2d.cuh"

namespace {

constexpr double kSqrt2 = 1.4142135623730951;
// Perturbation constants B_i (ops/colorgrad.py::B_CONSTANTS): rest, axis,
// diagonal
constexpr double kB0 = -4.0 / 27.0, kBa = 2.0 / 27.0, kBd = 5.0 / 108.0;

template <typename C> struct PertTile {
  static constexpr int TY = sizeof(C) == 8 ? 4 : 8;
};

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

template <typename S, int L, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(TX * PertTile<C>::TY)
pert_kernel(const S* __restrict__ s, const S* __restrict__ s2, const C* __restrict__ geo,
            S* __restrict__ out, S* __restrict__ out2, CsfParams P) {
  constexpr int TYL = PertTile<C>::TY;
  constexpr int AX = TX + 4, AY = TYL + 4;  // the staged densities
  constexpr int BX = TX + 2, BY = TYL + 2;  // the collided cells
  __shared__ C sd[AY][AX];
  __shared__ C sp[9][BY][BX];   // post-collision total PDF
  __shared__ C sr[9][BY][BX];   // its red part
  __shared__ unsigned char sfl[BY][BX];
  const int nx = P.nx, ny = P.ny;
  const size_t n = (size_t)ny * nx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TYL;
  const int tid = threadIdx.y * TX + threadIdx.x;

  // A. d = rho_r - rho_b on fluid cells, solid_phi elsewhere
  for (int t = tid; t < AX * AY; t += TX * TYL) {
    const int lx = t % AX, ly = t / AX;
    const int cx = wrap(x0 - 2 + lx, nx), cy = wrap(y0 - 2 + ly, ny);
    C d = C(P.solid_phi);
    if (geo[(size_t)cy * nx + cx] > C(0.5)) {
      Cell<C, L> c;
      load_state<S, L>(s, s2, geo, P, cx, cy, c);
      C f[9], rr, rb, rho;
      totals(c, f, rr, rb, rho);
      d = rr - rb;
    }
    sd[ly][lx] = d;
  }
  __syncthreads();

  // B. collide the tile and its one-cell ring
  for (int t = tid; t < BX * BY; t += TX * TYL) {
    const int lx = t % BX, ly = t / BX;
    const int cx = wrap(x0 - 1 + lx, nx), cy = wrap(y0 - 1 + ly, ny);
    const bool fluid = geo[(size_t)cy * nx + cx] > C(0.5);
    sfl[ly][lx] = fluid;
    if (!fluid) {
#pragma unroll
      for (int i = 0; i < 9; ++i) sp[i][ly][lx] = sr[i][ly][lx] = C(0);
      continue;
    }
    Cell<C, L> c;
    load_state<S, L>(s, s2, geo, P, cx, cy, c);
    C f[9], rr, rb, rho;
    totals(c, f, rr, rb, rho);
    const C tot = rr + rb;
    C phi = tot != C(0) ? (rr - rb) / tot : C(0);
    // Dirichlet-outlet repair: phi on fluid cells of rows 1 and 0 <- row 2
    if (P.phi_repair && cy <= 1) phi = phi_at<S, L>(s, s2, geo, P, cx, 2);
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

    // the gradient of d: neighbour x + e_i is staged at (lx + 1, ly + 1) + e_i
    C gx = C(0), gy = C(0);
#pragma unroll
    for (int i = 1; i < 9; ++i) {
      const C v = sd[ly + 1 + ey(i)][lx + 1 + ex(i)];
      const double w = i < 5 ? P.grad_wa : P.grad_wd;
      if (ex(i)) gx = gx + C(w * ex(i)) * v;
      if (ey(i)) gy = gy + C(w * ey(i)) * v;
    }
    const C g2 = gx * gx + gy * gy;
    const C norm = sqrt(g2);

    C post[9];
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
      sp[i][ly][lx] = post[i];
      sr[i][ly][lx] = frac * post[i] + segb * feq_rho * cos_t;
    }
  }
  __syncthreads();

  // C. pull streaming with half-way bounce-back
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const int lx = threadIdx.x + 1, ly = threadIdx.y + 1;
  const size_t k = (size_t)y * nx + x;
  C o[9], red[9];
  C rr_new = C(0);
  if (sfl[ly][lx]) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      int sx = lx - ex(i), sy = ly - ey(i), j = i;
      if (i != 0 && !sfl[sy][sx]) {
        sx = lx;
        sy = ly;
        j = opp(i);
      }
      o[i] = sp[j][sy][sx];
      red[i] = sr[j][sy][sx];
      rr_new = i == 0 ? red[0] : rr_new + red[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) o[i] = red[i] = C(0);
  }
  if constexpr (L == kSplit) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      out[i * n + k] = red[i];
      out2[i * n + k] = o[i] - red[i];
    }
  } else {
    store_state<S>(out, n, k, o, rr_new, geo[k]);
  }
}

template <typename S, int L>
int launch_pert(const void* s_in, const void* s2_in, void* s_out, void* s2_out,
                const void* geo_v, const CsfParams& P, cudaStream_t st) {
  using C = typename Traits<S>::C;
  constexpr int TYL = PertTile<C>::TY;
  const dim3 grid((P.nx + TX - 1) / TX, (P.ny + TYL - 1) / TYL);
  pert_kernel<S, L><<<grid, dim3(TX, TYL), 0, st>>>(
      static_cast<const S*>(s_in), static_cast<const S*>(s2_in),
      static_cast<const C*>(geo_v), static_cast<S*>(s_out), static_cast<S*>(s2_out), P);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: compressed 0 = f64 state, 1 = f32 state, 2 = bf16 11-plane state;
// split 3 = f64 (f_r, f_b), 4 = f32 (f_r, f_b).  s2_in and s2_out are f_b
// in the split modes and unused otherwise; geo is the model's geometry
// planes (plane 0, the fluid mask, is read).  Returns a cudaError_t code
// (0 on success; cudaErrorInvalidValue for a CSF parameter block).
extern "C" int pert2d_step(int mode, const void* s_in, const void* s2_in, void* s_out,
                           void* s2_out, const void* geo, const CsfParams* params,
                           void* stream) {
  const CsfParams P = *params;
  if (P.variant != 1) return (int)cudaErrorInvalidValue;  // a CSF block
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_pert<double, kCompressed>(s_in, s2_in, s_out, s2_out, geo, P, st);
    case 1: return launch_pert<float, kCompressed>(s_in, s2_in, s_out, s2_out, geo, P, st);
    case 2:
      return launch_pert<__nv_bfloat16, kCompressed>(s_in, s2_in, s_out, s2_out, geo, P,
                                                     st);
    case 3: return launch_pert<double, kSplit>(s_in, s2_in, s_out, s2_out, geo, P, st);
    case 4: return launch_pert<float, kSplit>(s_in, s2_in, s_out, s2_out, geo, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* pert2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
