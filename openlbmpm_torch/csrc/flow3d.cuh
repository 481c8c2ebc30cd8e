// Device code of the D3Q19 single-phase step (K11) and the D3Q19 Shan-Chen
// step (K10) for NVIDIA Hopper (sm_90a), included by flow3d_f64.cu,
// flow3d_f32.cu and flow3d_bf16.cu (one storage type each, so the three
// build side by side).  Kernels and device functions live in an unnamed
// namespace.
//
// Replaces the TPU kernels, at steps_per_call=1 on one device:
//   K11  openlbmpm_tpu/pallas/single3d.py::build_single3d_fused_step: rho,
//        u = (m + F/2) / rho with F = g rho, SRT or TRT with the Guo source;
//   K10  openlbmpm_tpu/pallas/sc3d.py::build_sc3d_fused_step: K = 1 ... 3
//        fluids with psi = rho, the D3Q19-weight interaction force
//        F_k = -rho_k (sum_j G_kj sum_i w_i e_i rho_j(x + e_i) + G_ks adh)
//        + g rho_k, adh = sum_i w_i e_i solid(x + e_i) the static adhesion
//        field, the common velocity u' = sum_k m_k/tau_k / sum_k
//        rho_k/tau_k, and per fluid SRT toward feq(u' + tau_k F_k / rho_k);
// both then pull streaming with half-way bounce-back, periodic in x, y and
// z (walls only from the mask), solid cells 0 after the step (a select,
// not a multiply).  The formulas follow the plain path (models/flow3d.py
// and ops/), not the TPU kernels' separable stencil and rho/tau-folded
// update, so the double instances agree with the plain path to rounding.
// States: f (19, nz, ny, nx) / (K, 19, nz, ny, nx) in f32 or f64, or 21
// bf16 planes a fluid (the deviations f_i - w_i rho_k, then rho_k as a
// hi/lo pair) decoded to f32 registers and rounded to nearest-even on the
// way out.  The geometry is one byte a cell (1 on fluid); the adhesion
// field is derived from it in the kernel (in double, in the order the plain
// path sums it), so no geometry plane is read beside the mask.
//
// Launches, one thread per cell (x fastest):
//   K10 only: rho_kernel  state -> rho_k (K planes, compute type), the
//             fluid-guarded density of each fluid, which the interaction
//             stencil reads at the 18 neighbours;
//   march     a block owns a 32 x TY (x, y) tile and marches up a run of
//             ZC = 16 z slabs, one thread for each cell of the tile and its
//             one-cell (x, y) ring.  It collides each slab of the ring tile
//             into a three-slab ring buffer in shared memory (K x 19
//             post-collision values a cell), then the tile's threads
//             pull-stream slab z from slabs z-1, z, z+1.  TY is 8, 4 or 2,
//             chosen so the buffer (3 x K x 19 x (34 x (TY + 2)) values)
//             fits in shared memory: 8 for K = 1 in f32, 4 for K = 2, 3 in
//             f32 and K = 1, 2 in f64, 2 for K = 3 in f64.
// So K11 is one launch a step and K10 two.  The local form of K10 (K12e,
// flow3d_local.cuh) runs rho and march on one shard's padded buffer, each
// over a range of slabs (BOX = true, a ZRange argument; the single-device
// instances take BOX = false and ignore it).
//
// What bounds it: HBM bytes per cell-step, the state in and out plus the
// one-byte mask: K11 153 B (f32), 85 B (bf16); K10 with K = 2 305 B (f32),
// 169 B (bf16).  This design adds the ring recompute (mostly L2) and, for
// K10, rho_k written and read (16 B f32, K = 2) and the state read twice.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

constexpr int kFlowMaxFluids = 3;

struct Flow3dParams {      // mirrored by kernels/flow3d.py::Flow3dParams
  int nz, ny, nx;
  int k;                   // fluids (1 for the single-phase step)
  int collision;           // single-phase: 0 SRT, 1 TRT
  int force;               // single-phase: 1 with a body force
  double tau[kFlowMaxFluids];
  double g[kFlowMaxFluids][kFlowMaxFluids];
  double gs[kFlowMaxFluids];
  double bf[3];            // body force (x, y, z)
};

namespace {

// The slabs [z0, z1) a pass of the local form runs over.
struct ZRange {
  int z0, z1;
};

constexpr int kSingleSRT = 0;
constexpr int kSingleTRT = 1;
constexpr int kShanChen = 2;

constexpr int Q = 19;
constexpr int TX = 32;
constexpr int HX = TX + 2;
constexpr int ZC = 16;     // z slabs a march block walks through

// D3Q19, the lattice's order (lattice.py): 0 rest, 1-6 axes, 7-18 face
// diagonals; opposite of i > 0 is i + 1 for odd i, i - 1 for even i.
__device__ __forceinline__ int ex(int i) {
  constexpr signed char E[Q] = {0, 1, -1, 0, 0, 0, 0, 1, -1, 1, -1, 1, -1, 1, -1, 0, 0, 0, 0};
  return E[i];
}
__device__ __forceinline__ int ey(int i) {
  constexpr signed char E[Q] = {0, 0, 0, 1, -1, 0, 0, 1, -1, -1, 1, 0, 0, 0, 0, 1, -1, 1, -1};
  return E[i];
}
__device__ __forceinline__ int ez(int i) {
  constexpr signed char E[Q] = {0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0, 1, -1, -1, 1, 1, -1, -1, 1};
  return E[i];
}
__device__ __forceinline__ int e_of(int i, int d) { return d == 0 ? ex(i) : d == 1 ? ey(i) : ez(i); }
__device__ __forceinline__ int opp(int i) { return i == 0 ? 0 : ((i & 1) ? i + 1 : i - 1); }
__device__ __forceinline__ double wq(int i) {
  return i == 0 ? 1.0 / 3.0 : (i <= 6 ? 1.0 / 18.0 : 1.0 / 36.0);
}

// v mod n for v >= -n (a tile's ring may pass a small domain more than once)
__device__ __forceinline__ int wrap_any(int v, int n) { return (v + n) % n; }

// Storage type S -> compute type C; bf16 storage holds f_i - w_i rho_k
// (planes 0-18) and rho_k as hi + lo (planes 19, 20) per fluid.
template <typename S> struct Traits {
  using C = S;
  static constexpr bool kShifted = false;
  static constexpr int kPlanes = Q;
};
template <> struct Traits<__nv_bfloat16> {
  using C = float;
  static constexpr bool kShifted = true;
  static constexpr int kPlanes = Q + 2;
};

__device__ __forceinline__ float to_c(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_c(float v) { return v; }
__device__ __forceinline__ double to_c(double v) { return v; }

template <typename C>
__device__ __forceinline__ C sumq(const C f[Q]) {
  C r = f[0];
#pragma unroll
  for (int i = 1; i < Q; ++i) r = r + f[i];
  return r;
}

// Fluid k's populations of cell idx (n cells a plane).
template <typename S, typename C = typename Traits<S>::C>
__device__ __forceinline__ void load_fluid(const S* __restrict__ f, size_t n, int k,
                                           size_t idx, C F[Q]) {
  const S* b = f + (size_t)k * Traits<S>::kPlanes * n;
  if constexpr (Traits<S>::kShifted) {
    const C rho = to_c(b[Q * n + idx]) + to_c(b[(Q + 1) * n + idx]);
#pragma unroll
    for (int i = 0; i < Q; ++i) F[i] = to_c(b[i * n + idx]) + C(wq(i)) * rho;
  } else {
#pragma unroll
    for (int i = 0; i < Q; ++i) F[i] = to_c(b[i * n + idx]);
  }
}

template <typename S, typename C = typename Traits<S>::C>
__device__ __forceinline__ void store_fluid(S* __restrict__ out, size_t n, int k, size_t idx,
                                            const C o[Q]) {
  S* b = out + (size_t)k * Traits<S>::kPlanes * n;
  if constexpr (Traits<S>::kShifted) {
    const C rho = sumq(o);
#pragma unroll
    for (int i = 0; i < Q; ++i) b[i * n + idx] = __float2bfloat16_rn(o[i] - C(wq(i)) * rho);
    const __nv_bfloat16 hi = __float2bfloat16_rn(rho);
    b[Q * n + idx] = hi;
    b[(Q + 1) * n + idx] = __float2bfloat16_rn(rho - __bfloat162float(hi));
  } else {
#pragma unroll
    for (int i = 0; i < Q; ++i) b[i * n + idx] = o[i];
  }
}

template <typename C>
__device__ __forceinline__ void momentum(const C F[Q], C m[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    C a = C(0);
#pragma unroll
    for (int i = 1; i < Q; ++i)
      if (e_of(i, d)) a = a + C(e_of(i, d)) * F[i];
    m[d] = a;
  }
}

// w_i rho (1 + 3 e.u + 4.5 (e.u)^2 - 1.5 u.u), as ops/equilibrium.py
template <typename C>
__device__ __forceinline__ C feq_i(int i, C rho, const C u[3], C uu) {
  const C eu = C(ex(i)) * u[0] + C(ey(i)) * u[1] + C(ez(i)) * u[2];
  return C(wq(i)) * rho * (C(1) + C(3) * eu + C(4.5) * eu * eu - C(1.5) * uu);
}

// K11: the single-phase collision of one fluid cell.
template <typename C, int MODE>
__device__ __forceinline__ void collide_single(const C F[Q], const Flow3dParams& P,
                                               C post[Q]) {
  const C rho = sumq(F);
  const C rs = rho > C(0) ? rho : C(1);
  C m[3], u[3], fc[3];
  momentum(F, m);
  const bool force = P.force != 0;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    fc[d] = C(P.bf[d]) * rho;
    u[d] = force ? (m[d] + C(0.5) * fc[d]) / rs : m[d] / rs;
  }
  const C uu = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
  C feq[Q], src[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    feq[i] = feq_i(i, rho, u, uu);
    const C eu = C(ex(i)) * u[0] + C(ey(i)) * u[1] + C(ez(i)) * u[2];
    // Guo source w_i [3 (e_i - u) + 9 e_i (e_i . u)] . F
    src[i] = C(wq(i)) * ((C(3) * (C(ex(i)) - u[0]) + C(9) * C(ex(i)) * eu) * fc[0] +
                         (C(3) * (C(ey(i)) - u[1]) + C(9) * C(ey(i)) * eu) * fc[1] +
                         (C(3) * (C(ez(i)) - u[2]) + C(9) * C(ez(i)) * eu) * fc[2]);
  }
  if constexpr (MODE == kSingleSRT) {
    const C tau = C(P.tau[0]);
    const C pf = C(1.0 - 0.5 / P.tau[0]);
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      post[i] = F[i] - (F[i] - feq[i]) / tau;
      if (force) post[i] = post[i] + pf * src[i];
    }
  } else {
    // symmetric part at omega_+ = 1/tau, antisymmetric at omega_- (magic 3/16)
    const double op = 1.0 / P.tau[0], om = 1.0 / (0.1875 / (P.tau[0] - 0.5) + 0.5);
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int j = opp(i);
      const C fs = C(0.5) * (F[i] + F[j]), fa = C(0.5) * (F[i] - F[j]);
      const C es = C(0.5) * (feq[i] + feq[j]), ea = C(0.5) * (feq[i] - feq[j]);
      post[i] = F[i] - C(op) * (fs - es) - C(om) * (fa - ea);
      if (force) {
        const C even = C(0.5) * (src[i] + src[j]), odd = C(0.5) * (src[i] - src[j]);
        post[i] = post[i] + (C(1.0 - 0.5 * op) * even + C(1.0 - 0.5 * om) * odd);
      }
    }
  }
}

// The interaction sums gr[k] = sum_i w_i e_i rho_k(x + e_i) of K fluids
// (rho_k at plane k * stride of rho_pl) and the static adhesion field adh =
// sum_i w_i e_i solid(x + e_i) (in double), in i order, one pass over the
// neighbours: nb(i) is neighbour i's index in rho_pl and in the one-byte
// fluid mask fl.
template <typename C, int K, typename Nb>
__device__ __forceinline__ void sc_sums(const C* __restrict__ rho_pl, size_t stride, Nb nb,
                                        const unsigned char* __restrict__ fl, C gr[K][3],
                                        double adh[3]) {
#pragma unroll
  for (int k = 0; k < K; ++k) gr[k][0] = gr[k][1] = gr[k][2] = C(0);
  adh[0] = adh[1] = adh[2] = 0.0;
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    const size_t j = nb(i);
    const bool solid = fl[j] == 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int e = e_of(i, d);
      if (!e) continue;
      if (solid) adh[d] = adh[d] + wq(i) * e;
#pragma unroll
      for (int k = 0; k < K; ++k) gr[k][d] = gr[k][d] + C(wq(i) * e) * rho_pl[k * stride + j];
    }
  }
}

// The collision of one fluid (populations f, density rho) at the common
// velocity up: SRT toward feq(u' + tau F / rho) with F = -rho (sum_j G_kj
// gr_j + G_ks adh) + g rho over nf fluids; g(j) = G_kj, gr(j, d) fluid j's
// interaction sum along d.
template <typename C, typename G, typename Gr>
__device__ __forceinline__ void sc_collide_fluid(const C f[Q], C rho, const C up[3], int nf,
                                                 G g, Gr gr, double gs, double tau_d,
                                                 const double adh[3], const double bf[3],
                                                 C post[Q]) {
  const C rs = rho > C(0) ? rho : C(1);
  const C tau = C(tau_d);
  C u[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    C gv = C(g(0)) * gr(0, d);
    for (int j = 1; j < nf; ++j) gv = gv + C(g(j)) * gr(j, d);
    const C force = -rho * (gv + C(gs) * C(adh[d])) + C(bf[d]) * rho;
    u[d] = up[d] + tau * force / rs;
  }
  const C uu = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
#pragma unroll
  for (int i = 0; i < Q; ++i) post[i] = f[i] - (f[i] - feq_i(i, rho, u, uu)) / tau;
}

// K10: the Shan-Chen collision of every fluid at one fluid cell from its
// populations F: rho_pl holds rho_k at plane k * stride, self is the
// cell's index there and nb(i) neighbour i's, which also indexes the
// one-byte fluid mask fl (the one-step march's global planes, or the T-step
// kernel's window).
template <typename C, int K, typename Nb>
__device__ __forceinline__ void sc_collide(const C* __restrict__ rho_pl, size_t stride,
                                           size_t self, Nb nb,
                                           const unsigned char* __restrict__ fl,
                                           const C F[K][Q], const Flow3dParams& P,
                                           C post[K][Q]) {
  C rho[K], gr[K][3];
  double adh[3];
#pragma unroll
  for (int k = 0; k < K; ++k) rho[k] = rho_pl[k * stride + self];
  sc_sums<C, K>(rho_pl, stride, nb, fl, gr, adh);
  // the common velocity u' (ops/macroscopic.py::sc_common_velocity)
  C den = C(0), num[3] = {C(0), C(0), C(0)};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const C it = C(1.0 / P.tau[k]);
    C m[3];
    momentum(F[k], m);
    den = k == 0 ? rho[k] * it : den + rho[k] * it;
#pragma unroll
    for (int d = 0; d < 3; ++d) num[d] = k == 0 ? m[d] * it : num[d] + m[d] * it;
  }
  den = den != C(0) ? den : C(1);
  C up[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) up[d] = num[d] / den;
#pragma unroll
  for (int k = 0; k < K; ++k)
    sc_collide_fluid(
        F[k], rho[k], up, K, [&](int j) { return P.g[k][j]; },
        [&](int j, int d) { return gr[j][d]; }, P.gs[k], P.tau[k], adh, P.bf, post[k]);
}

// K10 at the fluid cell (z, y, x) of the global state.
template <typename S, int K, typename C = typename Traits<S>::C>
__device__ void collide_sc(const S* __restrict__ f, const unsigned char* __restrict__ fl,
                           const C* __restrict__ rho_pl, const Flow3dParams& P, int z, int y,
                           int x, C post[K][Q]) {
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const size_t nxy = (size_t)ny * nx;
  const size_t n = (size_t)nz * nxy;
  const size_t idx = (size_t)z * nxy + (size_t)y * nx + x;
  C F[K][Q];
#pragma unroll
  for (int k = 0; k < K; ++k) load_fluid<S>(f, n, k, idx, F[k]);
  sc_collide<C, K>(
      rho_pl, n, idx,
      [&](int i) {
        return (size_t)wrap_any(z + ez(i), nz) * nxy + (size_t)wrap_any(y + ey(i), ny) * nx +
               wrap_any(x + ex(i), nx);
      },
      fl, F, P, post);
}

// rho_k on fluid cells, 0 on solid ones: every cell, or (BOX) the slabs R.
template <typename S, int K, bool BOX = false, typename C = typename Traits<S>::C>
__global__ void rho_kernel(const S* __restrict__ f, const unsigned char* __restrict__ fl,
                           C* __restrict__ rho, Flow3dParams P, ZRange R) {
  const size_t nxy = (size_t)P.ny * P.nx;
  const size_t n = (size_t)P.nz * nxy;
  const size_t idx =
      (BOX ? (size_t)R.z0 * nxy : 0) + (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (BOX ? (size_t)R.z1 * nxy : n)) return;
  const bool fluid = fl[idx] != 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    C F[Q];
    if (fluid) load_fluid<S>(f, n, k, idx, F);
    rho[k * n + idx] = fluid ? sumq(F) : C(0);
  }
}

// Tile height: the three-slab buffer of K x 19 values a ring cell fits in
// shared memory.
__host__ __device__ constexpr int tile_y(int k, int csize) {
  return k * csize <= 4 ? 8 : (k * csize <= 16 ? 4 : 2);
}
__host__ __device__ constexpr int ring_threads(int ty) { return (HX * (ty + 2) + 31) / 32 * 32; }

template <typename C, int K>
constexpr size_t march_smem() {
  constexpr int HY = tile_y(K, sizeof(C)) + 2;
  return sizeof(C) * 3 * K * Q * HY * HX + 3 * HY * HX;
}

// The tiles march up every slab, or (BOX) the slabs R (reading one beyond).
template <typename S, int MODE, int K, bool BOX = false, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(ring_threads(tile_y(K, sizeof(C))))
march_kernel(const S* __restrict__ f, const unsigned char* __restrict__ fl,
             const C* __restrict__ rho_pl, S* __restrict__ out, Flow3dParams P, ZRange R) {
  constexpr int TY = tile_y(K, sizeof(C));
  constexpr int HY = TY + 2;
  constexpr int NV = K * Q;
  extern __shared__ __align__(16) unsigned char smem[];
  C* sh = reinterpret_cast<C*>(smem);                       // [slot][NV][HY][HX]
  unsigned char* shfl = smem + sizeof(C) * 3 * NV * HY * HX;  // [slot][HY][HX]
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const size_t nxy = (size_t)ny * nx;
  const size_t n = (size_t)nz * nxy;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int z0 = (BOX ? R.z0 : 0) + blockIdx.z * ZC;
  const int z1 = min(z0 + ZC, BOX ? R.z1 : nz);
  const int tid = threadIdx.x;
  const int lx = tid % HX, ly = tid / HX;
  auto val = [&](int slot, int v, int yy, int xx) -> C& {
    return sh[((slot * NV + v) * HY + yy) * HX + xx];
  };
  auto flag = [&](int slot, int yy, int xx) -> unsigned char& {
    return shfl[(slot * HY + yy) * HX + xx];
  };
  // collide slab z of the ring tile into slot
  auto compute_slab = [&](int z, int slot) {
    if (tid >= HX * HY) return;
    const int cz = wrap_any(z, nz);
    const int cx = wrap_any(x0 - 1 + lx, nx), cy = wrap_any(y0 - 1 + ly, ny);
    const size_t idx = (size_t)cz * nxy + (size_t)cy * nx + cx;
    const bool fluid = fl[idx] != 0;
    flag(slot, ly, lx) = fluid;
    C post[K][Q];
    if (fluid) {
      if constexpr (MODE == kShanChen) {
        collide_sc<S, K>(f, fl, rho_pl, P, cz, cy, cx, post);
      } else {
        C F[Q];
        load_fluid<S>(f, n, 0, idx, F);
        collide_single<C, MODE>(F, P, post[0]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < Q; ++i) post[k][i] = C(0);
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < Q; ++i) val(slot, k * Q + i, ly, lx) = post[k][i];
  };

  // the tile's own cells stream: ring coordinates 1..TX, 1..TY
  const int x = x0 + lx - 1, y = y0 + ly - 1;
  const bool inside = lx >= 1 && lx <= TX && ly >= 1 && ly <= TY && x < nx && y < ny;
  compute_slab(z0 - 1, 0);
  compute_slab(z0, 1);
  for (int z = z0; z < z1; ++z) {
    compute_slab(z + 1, (z - z0 + 2) % 3);
    __syncthreads();
    const int cur = (z - z0 + 1) % 3;
    if (inside) {
      const size_t k0 = (size_t)z * nxy + (size_t)y * nx + x;
      const bool fluid = flag(cur, ly, lx) != 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        C o[Q];
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          // pull from the upwind cell x - e_i, or bounce back from a solid one
          int slot = (cur - ez(i) + 3) % 3, sx = lx - ex(i), sy = ly - ey(i), j = i;
          if (!flag(slot, sy, sx)) {
            slot = cur;
            sx = lx;
            sy = ly;
            j = opp(i);
          }
          o[i] = fluid ? val(slot, k * Q + j, sy, sx) : C(0);
        }
        store_fluid<S>(out, n, k, k0, o);
      }
    }
    __syncthreads();
  }
}

template <typename S, int MODE, int K, bool BOX = false, typename C = typename Traits<S>::C>
int launch_march(const S* f, const unsigned char* fl, const C* rho, S* out,
                 const Flow3dParams& P, cudaStream_t st, ZRange R = ZRange{}) {
  constexpr int TY = tile_y(K, sizeof(C));
  constexpr size_t smem = march_smem<C, K>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        march_kernel<S, MODE, K, BOX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int nz = BOX ? R.z1 - R.z0 : P.nz;
  const dim3 grid((P.nx + TX - 1) / TX, (P.ny + TY - 1) / TY, (nz + ZC - 1) / ZC);
  march_kernel<S, MODE, K, BOX><<<grid, ring_threads(TY), smem, st>>>(f, fl, rho, out, P, R);
  return (int)cudaGetLastError();
}

// K11: one step of the single-phase state; returns a cudaError_t code.
template <typename S>
int single3d_dispatch(const void* f_in, void* f_out, const void* fl_v, const Flow3dParams& P,
                      cudaStream_t st) {
  using C = typename Traits<S>::C;
  const S* f = static_cast<const S*>(f_in);
  S* out = static_cast<S*>(f_out);
  const unsigned char* fl = static_cast<const unsigned char*>(fl_v);
  switch (P.collision) {
    case kSingleSRT: return launch_march<S, kSingleSRT, 1>(f, fl, (const C*)nullptr, out, P, st);
    case kSingleTRT: return launch_march<S, kSingleTRT, 1>(f, fl, (const C*)nullptr, out, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename S, int K>
int launch_sc3d(const void* f_in, void* f_out, const void* fl_v, void* rho_v,
                const Flow3dParams& P, cudaStream_t st) {
  using C = typename Traits<S>::C;
  const S* f = static_cast<const S*>(f_in);
  const unsigned char* fl = static_cast<const unsigned char*>(fl_v);
  C* rho = static_cast<C*>(rho_v);
  const size_t n = (size_t)P.nz * P.ny * P.nx;
  rho_kernel<S, K><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(f, fl, rho, P, ZRange{});
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_march<S, kShanChen, K>(f, fl, rho, static_cast<S*>(f_out), P, st);
}

// K10: one step of the Shan-Chen state (P.k fluids); rho is scratch of P.k
// planes in the compute type.  Returns a cudaError_t code.
template <typename S>
int sc3d_dispatch(const void* f_in, void* f_out, const void* fl, void* rho,
                  const Flow3dParams& P, cudaStream_t st) {
  switch (P.k) {
    case 1: return launch_sc3d<S, 1>(f_in, f_out, fl, rho, P, st);
    case 2: return launch_sc3d<S, 2>(f_in, f_out, fl, rho, P, st);
    case 3: return launch_sc3d<S, 3>(f_in, f_out, fl, rho, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
