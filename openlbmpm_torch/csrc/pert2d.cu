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
// PyTorch path to ~1e-12.  They are a library of their own, pert2d_f64.cu,
// which defines PERT2D_F64 and is built with -fmad=false
// (kernels/build.py::EXTRA_FLAGS), so its products and sums round as the
// plain path's do; this file alone builds the f32 and bf16 instances, which
// keep the FMA contraction.
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

#include "pert2d.cuh"

namespace {
template <typename C> struct PertTile {
  static constexpr int TY = sizeof(C) == 8 ? 4 : 8;
};

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
    // the gradient of d: neighbour x + e_i is staged at (lx + 1, ly + 1) + e_i
    C gx, gy;
    pert_gradient([&](int i) { return sd[ly + 1 + ey(i)][lx + 1 + ex(i)]; }, P, gx, gy);
    C post[9], red[9];
    pert_collide(c, phi, gx, gy, P, post, red);
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      sp[i][ly][lx] = post[i];
      sr[i][ly][lx] = red[i];
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
// split 3 = f64 (f_r, f_b), 4 = f32 (f_r, f_b); modes 0 and 3 with
// PERT2D_F64 defined, the others without it.  s2_in and s2_out are f_b in
// the split modes and unused otherwise; geo is the model's geometry planes
// (plane 0, the fluid mask, is read).  Returns a cudaError_t code (0 on
// success; cudaErrorInvalidValue for a CSF parameter block or a mode this
// library does not hold).
extern "C" int pert2d_step(int mode, const void* s_in, const void* s2_in, void* s_out,
                           void* s2_out, const void* geo, const CsfParams* params,
                           void* stream) {
  const CsfParams P = *params;
  if (P.variant != 1) return (int)cudaErrorInvalidValue;  // a CSF block
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
#ifdef PERT2D_F64
    case 0: return launch_pert<double, kCompressed>(s_in, s2_in, s_out, s2_out, geo, P, st);
    case 3: return launch_pert<double, kSplit>(s_in, s2_in, s_out, s2_out, geo, P, st);
#else
    case 1: return launch_pert<float, kCompressed>(s_in, s2_in, s_out, s2_out, geo, P, st);
    case 2:
      return launch_pert<__nv_bfloat16, kCompressed>(s_in, s2_in, s_out, s2_out, geo, P,
                                                     st);
    case 4: return launch_pert<float, kSplit>(s_in, s2_in, s_out, s2_out, geo, P, st);
#endif
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* pert2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
