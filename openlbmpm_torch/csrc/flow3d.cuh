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
// both then stream with half-way bounce-back (a pull; K10 in f32 and f64 a
// push, which places the same values), periodic in x, y and z (walls only
// from the mask), solid cells 0 after the step (a select,
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
// Launches (one thread a cell, x fastest):
//   K11  f32 and f64 storage: single_push_kernel, one a step.  A 32 x 8
//        tile, one thread a cell: each fluid cell loads its 19 values once,
//        collides once and pushes post_i to slot i of x + e_i, or to slot
//        opp(i) of x where x + e_i is solid (each output slot written once;
//        the neighbours' flags from the one-byte mask, no shared memory, no
//        barrier).  The f64 values are the earlier pull's bit for bit (the
//        same collision arithmetic; only the placement moved); the f32
//        push's differ only by the compiler's a * b + c contractions
//        (PERF.md).
//        bf16 storage: march_kernel, one a step (bf16 cannot push: see K10
//        below).  Its collision forms each post value in turn
//        (collide_single_each), which took its registers from 142 to 71,
//        and so two blocks an SM where one fitted.  A block owns a 32 x TY
//        (x, y) tile and
//        marches up a run of ZC = 16 z slabs, one thread for each cell of
//        the tile and its one-cell (x, y) ring.  It collides each slab of
//        the ring tile into a three-slab ring buffer in shared memory (K x
//        19 post-collision values a cell), then the tile's threads
//        pull-stream slab z from slabs z-1, z, z+1.  TY is 8, 4 or 2, chosen
//        so the buffer fits in shared memory: 8 for K = 1 in f32, 4 for
//        K = 2, 3 in f32 and K = 1, 2 in f64, 2 for K = 3 in f64.
//   K10  f32 and f64 storage: sc_push_kernel, one a step.  rho_k of each
//        neighbour comes from a ring of rho_k and the fluid flag in shared
//        memory (4 slabs), which the block fills from the state it loads;
//        no rho pass, no rho scratch.  A 32 x 8 tile, one thread a cell,
//        each fluid cell collided once, post_i written to slot i of
//        x + e_i, or to slot opp(i) of x where x + e_i is solid (each output
//        slot written once; a few KB of shared memory, so registers set the
//        occupancy).  The ring fill of a thread's own cell also forms its
//        common velocity; the collision then takes one fluid at a time (its
//        populations loaded again, mostly from L1 or L2) and stores each
//        post value as it is formed, through a pointer the compiler may not
//        fold into 19 addresses: held in registers, those took 204-242
//        registers a thread and one block an SM, the push 0.68-1.17 ms at
//        128^3 (K = 2), against 128 registers, two blocks an SM and about
//        0.50 ms (PERF.md).  It marches runs of up to 16 slabs, the run
//        occupancy.cuh's.  The arithmetic is sc_collide's (sc_sums, the
//        common velocity, sc_collide_fluid_each, in its order): the f64
//        values equal those of march_kernel's Shan-Chen collision bit for
//        bit; the f32 push's differ only by the compiler's a * b + c
//        contractions (PERF.md).
//        bf16 storage: rho_kernel (rho_k into K planes of f32 scratch),
//        then march_kernel with the Shan-Chen collision (collide_sc, the
//        neighbours' rho_k from that scratch), two a step.  bf16 cannot
//        push: store_fluid encodes each value against the output cell's
//        rho, the sum of its 19 streamed values, which a push never holds.
//        A pull in one launch (the rho ring filled by the march itself, two
//        cells a side) ran 0.6882 ms at 128^3 against these two launches'
//        0.6512, and three other one-launch forms were slower too
//        (PERF.md), so bf16 keeps the two.
// The local form of K10 (K12e, flow3d_local.cuh) runs sc_push_kernel with
// BOX = true over a range of slabs (a ZRange argument; the single-device
// instances take BOX = false and ignore it).
//
// What bounds it: HBM bytes per cell-step, the state in and out plus the
// one-byte mask: K11 153 B (f32), 85 B (bf16); K10 with K = 2 305 B (f32),
// 169 B (bf16).  K11's push moves just these (its flag reads hit L1).  The
// march adds the ring recompute (mostly L2: 1.33x the collisions) and, for
// K10 in bf16, the state read twice and rho_k written and read (8 B, K =
// 2); K10's push reads the state twice (the ring fill one slab ahead, then
// the collision: the second read mostly from L1 or L2) plus its one-cell
// halo's (1.33x with the z-run's two extra slabs).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "occupancy.cuh"

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

// The Guo source w_i [3 (e_i - u) + 9 e_i (e_i . u)] . F of direction i at
// velocity u and force fc.
template <typename C>
__device__ __forceinline__ C guo_i(int i, const C u[3], const C fc[3]) {
  const C eu = C(ex(i)) * u[0] + C(ey(i)) * u[1] + C(ez(i)) * u[2];
  return C(wq(i)) * ((C(3) * (C(ex(i)) - u[0]) + C(9) * C(ex(i)) * eu) * fc[0] +
                     (C(3) * (C(ey(i)) - u[1]) + C(9) * C(ey(i)) * eu) * fc[1] +
                     (C(3) * (C(ez(i)) - u[2]) + C(9) * C(ez(i)) * eu) * fc[2]);
}

// K11: the single-phase collision of one fluid cell; out(i, post_i) takes
// each post-collision value as it is formed, i = 0, 1, ... (the push and
// the T-step march store it there and then, and march_kernel into its
// array, so no thread holds 19 equilibria, sources and post values at
// once: 71 registers in march_kernel where that array form took 142).
// TRT forms the equilibrium and source of the opposite direction again, by
// the same expressions.
template <typename C, int MODE, typename Out>
__device__ __forceinline__ void collide_single_each(const C F[Q], const Flow3dParams& P,
                                                    Out out) {
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
  if constexpr (MODE == kSingleSRT) {
    const C tau = C(P.tau[0]);
    const C pf = C(1.0 - 0.5 / P.tau[0]);
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      C post = F[i] - (F[i] - feq_i(i, rho, u, uu)) / tau;
      if (force) post = post + pf * guo_i(i, u, fc);
      out(i, post);
    }
  } else {
    // symmetric part at omega_+ = 1/tau, antisymmetric at omega_- (magic 3/16)
    const double op = 1.0 / P.tau[0], om = 1.0 / (0.1875 / (P.tau[0] - 0.5) + 0.5);
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const int j = opp(i);
      const C qi = feq_i(i, rho, u, uu), qj = feq_i(j, rho, u, uu);
      const C fs = C(0.5) * (F[i] + F[j]), fa = C(0.5) * (F[i] - F[j]);
      const C es = C(0.5) * (qi + qj), ea = C(0.5) * (qi - qj);
      C post = F[i] - C(op) * (fs - es) - C(om) * (fa - ea);
      if (force) {
        const C si = guo_i(i, u, fc), sj = guo_i(j, u, fc);
        const C even = C(0.5) * (si + sj), odd = C(0.5) * (si - sj);
        post = post + (C(1.0 - 0.5 * op) * even + C(1.0 - 0.5 * om) * odd);
      }
      out(i, post);
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

// The common velocity u' = sum_k m_k / tau_k / sum_k rho_k / tau_k
// (ops/macroscopic.py::sc_common_velocity) over fluids k = 0, 1, ... in
// turn, as sc_collide forms it (which keeps its own text, so that the T-step
// kernel compiles as it did): add_common adds fluid k's terms to den and
// num, common_velocity divides.
template <typename C>
__device__ __forceinline__ void add_common(int k, C rho, const C m[3], double tau, C& den,
                                           C num[3]) {
  const C it = C(1.0 / tau);
  den = k == 0 ? rho * it : den + rho * it;
#pragma unroll
  for (int d = 0; d < 3; ++d) num[d] = k == 0 ? m[d] * it : num[d] + m[d] * it;
}
template <typename C>
__device__ __forceinline__ void common_velocity(C den, const C num[3], C up[3]) {
  den = den != C(0) ? den : C(1);
#pragma unroll
  for (int d = 0; d < 3; ++d) up[d] = num[d] / den;
}

// The collision of one fluid (populations f, density rho) at the common
// velocity up: SRT toward feq(u' + tau F / rho) with F = -rho (sum_j G_kj
// gr_j + G_ks adh) + g rho over nf fluids; g(j) = G_kj, gr(j, d) fluid j's
// interaction sum along d.  out(i, post_i) takes each post-collision value
// as it is formed, i = 0, 1, ...
template <typename C, typename G, typename Gr, typename Out>
__device__ __forceinline__ void sc_collide_fluid_each(const C f[Q], C rho, const C up[3],
                                                      int nf, G g, Gr gr, double gs,
                                                      double tau_d, const double adh[3],
                                                      const double bf[3], Out out) {
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
  for (int i = 0; i < Q; ++i) out(i, f[i] - (f[i] - feq_i(i, rho, u, uu)) / tau);
}

// sc_collide_fluid_each into post[Q].
template <typename C, typename G, typename Gr>
__device__ __forceinline__ void sc_collide_fluid(const C f[Q], C rho, const C up[3], int nf,
                                                 G g, Gr gr, double gs, double tau_d,
                                                 const double adh[3], const double bf[3],
                                                 C post[Q]) {
  sc_collide_fluid_each(f, rho, up, nf, g, gr, gs, tau_d, adh, bf,
                        [&](int i, C v) { post[i] = v; });
}

// K10: the Shan-Chen collision of every fluid at one fluid cell from its
// populations F: rho_pl holds rho_k at plane k * stride, self is the
// cell's index there and nb(i) neighbour i's, which also indexes the
// one-byte fluid mask fl (the bf16 march's global planes, or the T-step
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

// K10 in bf16 storage, at the fluid cell (z, y, x) of the global state;
// rho_pl holds rho_kernel's planes.
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

// K10 in bf16 storage: rho_k on fluid cells, 0 on solid ones.
template <typename S, int K, typename C = typename Traits<S>::C>
__global__ void rho_kernel(const S* __restrict__ f, const unsigned char* __restrict__ fl,
                           C* __restrict__ rho, Flow3dParams P) {
  const size_t nxy = (size_t)P.ny * P.nx;
  const size_t n = (size_t)P.nz * nxy;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
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

// K11 and K10 in bf16 storage: the tiles march up every slab.
template <typename S, int MODE, int K, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(ring_threads(tile_y(K, sizeof(C))))
march_kernel(const S* __restrict__ f, const unsigned char* __restrict__ fl,
             const C* __restrict__ rho_pl, S* __restrict__ out, Flow3dParams P) {
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
  const int z0 = blockIdx.z * ZC;
  const int z1 = min(z0 + ZC, nz);
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
        collide_single_each<C, MODE>(F, P, [&](int i, C v) { post[0][i] = v; });
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

// Launches of march_kernel (K11 and K10 in bf16), sc_push_kernel (K10 in
// f32 and f64), rho_kernel (K10 in bf16) and single_push_kernel (K11 in
// f32 and f64) by this library since it was loaded, one where each launch
// is made; flow3d_kernel_launches reads them.
long long g_launches[4];

template <typename S, int MODE, int K, typename C = typename Traits<S>::C>
int launch_march(const S* f, const unsigned char* fl, const C* rho, S* out,
                 const Flow3dParams& P, cudaStream_t st) {
  constexpr int TY = tile_y(K, sizeof(C));
  constexpr size_t smem = march_smem<C, K>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        march_kernel<S, MODE, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((P.nx + TX - 1) / TX, (P.ny + TY - 1) / TY, (P.nz + ZC - 1) / ZC);
  march_kernel<S, MODE, K><<<grid, ring_threads(TY), smem, st>>>(f, fl, rho, out, P);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launches[0];
  return (int)err;
}

// K11 in f32 and f64 storage (single_push_kernel): one thread a cell, a
// TX x SPTY tile of (x, y) a block, SPZ slabs a thread.  A fluid cell loads
// its 19 values (x fastest, coalesced), collides them (collide_single_each)
// and pushes each post_i as it is formed into slot i of x + e_i, or into
// slot opp(i) of x where x + e_i is solid; a solid cell writes its own 19
// zeros.  So each output slot is written exactly once, by the thread whose
// pull would have read it: sc_push_kernel's placement with one fluid and
// no rho ring.  The neighbours' fluid flags are the one-byte mask's, read
// where they lie (L1 holds a tile's); no shared memory, no barrier.  The
// stores go through a pointer the compiler may not fold into 19 addresses
// (sc_push_kernel's lesson, above).  Two blocks an SM (about 100
// registers): the compiler's own choice, 80 registers and three blocks,
// ran 7% slower, and so did 3 x 8, 32 x 4 and 32 x 16 tiles or runs of 2
// and 4 slabs within a few percent either way (PERF.md).
constexpr int SPTY = 8;
constexpr int SPZ = 1;
constexpr int SPUSH_THREADS = TX * SPTY;

template <typename S, int MODE>
__global__ void __launch_bounds__(SPUSH_THREADS, 2)
single_push_kernel(const S* __restrict__ f, const unsigned char* __restrict__ fl,
                   S* __restrict__ out, Flow3dParams P) {
  using C = S;
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const size_t nxy = (size_t)ny * nx;
  const size_t n = (size_t)nz * nxy;
  const int x = blockIdx.x * TX + threadIdx.x % TX;
  const int y = blockIdx.y * SPTY + threadIdx.x / TX;
  if (x >= nx || y >= ny) return;
  // the offsets of x + e_i from x along each axis, wrapped (index e + 1)
  const int ox[3] = {x == 0 ? nx - 1 : -1, 0, x == nx - 1 ? 1 - nx : 1};
  const int oy[3] = {(y == 0 ? ny - 1 : -1) * nx, 0, (y == ny - 1 ? 1 - ny : 1) * nx};
  const int nxy_i = (int)nxy;
  const int z1 = min((int)(blockIdx.z + 1) * SPZ, nz);
  for (int z = blockIdx.z * SPZ; z < z1; ++z) {
    const size_t k0 = (size_t)z * nxy + (size_t)y * nx + x;
    if (!fl[k0]) {
#pragma unroll
      for (int i = 0; i < Q; ++i) out[(size_t)i * n + k0] = C(0);
      continue;
    }
    const int oz[3] = {(z == 0 ? nz - 1 : -1) * nxy_i, 0, (z == nz - 1 ? 1 - nz : 1) * nxy_i};
    unsigned fluid_nb = 0;   // bit i: x + e_i is fluid
#pragma unroll
    for (int i = 0; i < Q; ++i)
      fluid_nb |= (fl[k0 + oz[ez(i) + 1] + oy[ey(i) + 1] + ox[ex(i) + 1]] ? 1u : 0u) << i;
    C F[Q];
    load_fluid<S>(f, n, 0, k0, F);
    S* p = out + k0;   // slot i of x
    collide_single_each<C, MODE>(F, P, [&](int i, C v) {
      if ((fluid_nb >> i) & 1u) {
        p[oz[ez(i) + 1] + oy[ey(i) + 1] + ox[ex(i) + 1]] = v;
      } else {
        p[(opp(i) - i) * (ptrdiff_t)n] = v;   // bounced back from the solid x + e_i
      }
      p += n;
      asm volatile("" : "+l"(p));
    });
  }
}

template <typename S, int MODE>
int launch_single_push(const S* f, const unsigned char* fl, S* out, const Flow3dParams& P,
                       cudaStream_t st) {
  const dim3 grid((P.nx + TX - 1) / TX, (P.ny + SPTY - 1) / SPTY, (P.nz + SPZ - 1) / SPZ);
  single_push_kernel<S, MODE><<<grid, SPUSH_THREADS, 0, st>>>(f, fl, out, P);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launches[3];
  return (int)err;
}

// K11: one step of the single-phase state (f32 and f64 the push; bf16,
// which cannot push, see the note at the top, march_kernel); returns a
// cudaError_t code.
template <typename S, int MODE>
int launch_single3d(const S* f, const unsigned char* fl, S* out, const Flow3dParams& P,
                    cudaStream_t st) {
  if constexpr (Traits<S>::kShifted) {
    using C = typename Traits<S>::C;
    return launch_march<S, MODE, 1>(f, fl, (const C*)nullptr, out, P, st);
  } else {
    return launch_single_push<S, MODE>(f, fl, out, P, st);
  }
}

template <typename S>
int single3d_dispatch(const void* f_in, void* f_out, const void* fl_v, const Flow3dParams& P,
                      cudaStream_t st) {
  const S* f = static_cast<const S*>(f_in);
  S* out = static_cast<S*>(f_out);
  const unsigned char* fl = static_cast<const unsigned char*>(fl_v);
  switch (P.collision) {
    case kSingleSRT: return launch_single3d<S, kSingleSRT>(f, fl, out, P, st);
    case kSingleTRT: return launch_single3d<S, kSingleTRT>(f, fl, out, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// -- K10 --------------------------------------------------------------------

constexpr int kRhoSlots = 4;      // slabs of the push's rho ring (one barrier a slab)
constexpr int PUSH_ZMAX = 16;     // the most z slabs a push block marches through

// f32 and f64 storage (sc_push_kernel): a block owns a TX x PTY tile, one
// thread a cell, and a ring of rho_k and the fluid flag over the tile and
// one cell a side in kRhoSlots slabs of shared memory.
constexpr int PTY = 8;
constexpr int PHY = PTY + 2;
constexpr int PN = HX * PHY;                   // ring cells a slab
constexpr int PUSH_THREADS = TX * PTY;
constexpr int PUSH_HALO = 2 * HX + 2 * PTY;    // ring cells outside the tile

template <typename S, int K>
constexpr size_t push_smem() {
  return (sizeof(S) * K + 1) * kRhoSlots * PN;
}

// One step of fluid cells in f32 or f64 storage: every slab (BOX: the
// slabs [R.z0 - 1, R.z1 + 1) collided, only [R.z0, R.z1) written; rho read
// over [R.z0 - 2, R.z1 + 2)).  A block marches up zrun slabs.  Before slab
// z collides, its threads fill slab z + 1 of the ring from the state (rho_k
// the fluid-guarded sum of the 19 loaded values, as the plain path forms
// it; the first PUSH_HALO threads take a second, halo cell); one barrier a
// slab, as the slot a fill writes is one that no thread still reads.  The
// fill of a thread's own cell also forms its common velocity, which the
// thread keeps for the next slab.  The collision then takes one fluid at a
// time (sc_collide's arithmetic in its order: the neighbours' rho and flags
// from the ring, sc_sums, sc_collide_fluid_each), loading the fluid's
// populations again (mostly from L1 or L2), and pushes post_i as it is
// formed: into slot i of x + e_i, or, where x + e_i is solid, into slot
// opp(i) of x; a solid cell writes its own 19 zeros.  So each output slot
// is written exactly once, by the thread whose pull would have read it, and
// a thread holds one fluid's populations, not K.
template <typename S, int K, bool BOX = false>
__global__ void __launch_bounds__(PUSH_THREADS)
sc_push_kernel(const S* __restrict__ f, const unsigned char* __restrict__ fl,
               S* __restrict__ out, Flow3dParams P, ZRange R, int zrun) {
  using C = S;
  constexpr size_t stride = (size_t)kRhoSlots * PN;      // between two fluids' rings
  extern __shared__ __align__(16) unsigned char smem[];
  C* rr = reinterpret_cast<C*>(smem);                    // [k][slot][PHY][HX]
  unsigned char* rf = smem + sizeof(C) * K * stride;     // [slot][PHY][HX]
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const size_t nxy = (size_t)ny * nx;
  const size_t n = (size_t)nz * nxy;
  const int c0 = BOX ? R.z0 - 1 : 0, c1 = BOX ? R.z1 + 1 : nz;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * PTY;
  const int z0 = c0 + blockIdx.z * zrun;
  const int z1 = min(z0 + zrun, c1);
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int x = x0 + tx, y = y0 + ty;
  auto slot_of = [&](int z) { return (z - z0 + kRhoSlots) & (kRhoSlots - 1); };
  // rho_k (0 on a solid cell) and the fluid flag of ring cell (hx, hy) of
  // slab z; OWN (the thread's own cell) also its common velocity into up
  auto fill_cell = [&](auto own, int z, int hx, int hy, C up[3]) {
    const size_t idx = (size_t)wrap_any(z, nz) * nxy + (size_t)wrap_any(y0 - 1 + hy, ny) * nx +
                       wrap_any(x0 - 1 + hx, nx);
    const bool fluid = fl[idx] != 0;
    const int r = slot_of(z) * PN + hy * HX + hx;
    rf[r] = fluid;
    C den = C(0), num[3] = {C(0), C(0), C(0)};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      C F[Q];
      if (fluid) load_fluid<S>(f, n, k, idx, F);
      const C rho = fluid ? sumq(F) : C(0);
      rr[k * stride + r] = rho;
      if constexpr (decltype(own)::value) {
        C m[3];
        momentum(F, m);
        add_common(k, rho, m, P.tau[k], den, num);
      }
    }
    if constexpr (decltype(own)::value) common_velocity(den, num, up);
  };
  // slab z of the ring; up the own cell's common velocity
  auto fill = [&](int z, C up[3]) {
    fill_cell(std::true_type{}, z, tx + 1, ty + 1, up);
    if (tid < PUSH_HALO) {
      const int j = tid - 2 * HX;   // the rows above and below, then the two columns
      if (j < 0) fill_cell(std::false_type{}, z, tid % HX, tid < HX ? 0 : PHY - 1, up);
      else fill_cell(std::false_type{}, z, (j & 1) ? HX - 1 : 0, 1 + j / 2, up);
    }
  };
  // the offsets of x + e_i from x along each axis, wrapped (index e + 1)
  const int ox[3] = {x == 0 ? nx - 1 : -1, 0, x == nx - 1 ? 1 - nx : 1};
  const int oy[3] = {(y == 0 ? ny - 1 : -1) * nx, 0, (y == ny - 1 ? 1 - ny : 1) * nx};
  const int hx = tx + 1, hy = ty + 1;
  auto written = [&](int z) { return !BOX || (z >= R.z0 && z < R.z1); };
  auto push = [&](int z, const C up[3]) {
    const int nxy_i = (int)nxy;
    const int oz[3] = {(z == 0 ? nz - 1 : -1) * nxy_i, 0, (z == nz - 1 ? 1 - nz : 1) * nxy_i};
    const size_t k0 = (size_t)z * nxy + (size_t)y * nx + x;
    const int self = slot_of(z) * PN + hy * HX + hx;
    if (!rf[self]) {
      if (written(z)) {
#pragma unroll
        for (int v = 0; v < K * Q; ++v) out[(size_t)v * n + k0] = C(0);
      }
      return;
    }
    auto ring = [&](int i) { return slot_of(z + ez(i)) * PN + (hy + ey(i)) * HX + hx + ex(i); };
    unsigned fluid_nb = 0;   // bit i: x + e_i is fluid
#pragma unroll
    for (int i = 0; i < Q; ++i) fluid_nb |= (rf[ring(i)] ? 1u : 0u) << i;
    C gr[K][3];
    double adh[3];
    sc_sums<C, K>(rr, stride, ring, rf, gr, adh);
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      C F[Q];
      load_fluid<S>(f, n, k, k0, F);
      // slot i of x; the empty asm keeps the compiler from holding the 19
      // slots' addresses in registers (it took 204-212 registers, and one
      // block an SM, with them)
      S* p = out + (size_t)k * Q * n + k0;
      sc_collide_fluid_each(
          F, rr[k * stride + self], up, K, [&](int j) { return P.g[k][j]; },
          [&](int j, int d) { return gr[j][d]; }, P.gs[k], P.tau[k], adh, P.bf,
          [&](int i, C post) {
            if ((fluid_nb >> i) & 1u) {
              if (written(z + ez(i))) p[oz[ez(i) + 1] + oy[ey(i) + 1] + ox[ex(i) + 1]] = post;
            } else if (written(z)) {
              p[(opp(i) - i) * (ptrdiff_t)n] = post;   // bounced back from the solid x + e_i
            }
            p += n;
            asm volatile("" : "+l"(p));
          });
    }
  };
  const bool inside = x < nx && y < ny;
  C up[3], up_next[3];
  fill(z0 - 1, up);
  fill(z0, up);
  for (int z = z0; z < z1; ++z) {
    fill(z + 1, up_next);
    __syncthreads();
    if (inside) push(z, up);
#pragma unroll
    for (int d = 0; d < 3; ++d) up[d] = up_next[d];
  }
}

// K10 (f32, f64): one launch of sc_push_kernel over the domain or (BOX) the
// output slabs R.
template <typename S, int K, bool BOX = false>
int launch_push(const S* f, const unsigned char* fl, S* out, const Flow3dParams& P,
                cudaStream_t st, ZRange R = ZRange{}) {
  constexpr size_t smem = push_smem<S, K>();
  static_assert(smem <= 48 * 1024, "the push's ring needs no opt-in shared memory");
  static int capacity = 0;
  cudaError_t err;
  if (capacity == 0) {
    capacity = card_capacity(sc_push_kernel<S, K, BOX>, PUSH_THREADS, smem, err);
    if (capacity < 0) {
      capacity = 0;
      return (int)err;
    }
  }
  const int nz = BOX ? R.z1 - R.z0 + 2 : P.nz;
  const long long tiles = (long long)((P.nx + TX - 1) / TX) * ((P.ny + PTY - 1) / PTY);
  const int zrun = z_run(capacity, tiles, nz, PUSH_ZMAX);
  const dim3 grid((P.nx + TX - 1) / TX, (P.ny + PTY - 1) / PTY, (nz + zrun - 1) / zrun);
  sc_push_kernel<S, K, BOX><<<grid, PUSH_THREADS, smem, st>>>(f, fl, out, P, R, zrun);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launches[1];
  return (int)err;
}

// K10: f32 and f64 one launch of the push; bf16 (which cannot push, see
// the note at the top) rho_kernel into the scratch rho, then march_kernel.
template <typename S, int K>
int launch_sc3d(const void* f_in, void* f_out, const void* fl_v, void* rho_v,
                const Flow3dParams& P, cudaStream_t st) {
  const S* f = static_cast<const S*>(f_in);
  const unsigned char* fl = static_cast<const unsigned char*>(fl_v);
  if constexpr (Traits<S>::kShifted) {
    using C = typename Traits<S>::C;
    C* rho = static_cast<C*>(rho_v);
    const size_t n = (size_t)P.nz * P.ny * P.nx;
    rho_kernel<S, K><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(f, fl, rho, P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++g_launches[2];
    return launch_march<S, kShanChen, K>(f, fl, rho, static_cast<S*>(f_out), P, st);
  } else {
    return launch_push<S, K>(f, fl, static_cast<S*>(f_out), P, st);
  }
}

// K10: one step of the Shan-Chen state (P.k fluids); rho is scratch of P.k
// planes in the compute type for bf16 storage (unused, may be null, for f32
// and f64).  Returns a cudaError_t code.
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
