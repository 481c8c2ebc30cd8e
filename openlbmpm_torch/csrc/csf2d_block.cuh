// Temporally blocked colour-gradient step, D2Q9, for NVIDIA Hopper
// (sm_90a): K3's windows, T time steps a launch.  Since the row-march
// (march2d.cuh) runs both single-device variants of K3, these windows
// serve the local forms of both variants (K12a, csf2d_local_*.cu);
// coupled2d_block.cuh runs the CSF sub-step below in its windows too.
//
// Replaces the TPU kernel openlbmpm_tpu/pallas/csf.py::build_csf_fused_step
// with steps_per_call = T > 1, in both variants (a template parameter V):
// CSF (_substep :998, _substep_c :1033) and Perturbation (_substep_pert
// :1118, _substep_pert_c :1246), and its layouts:
//   K3c  compressed (f_total, rho_r), 10 planes, f32 or f64;
//   K3h  compressed, 11 bf16 planes, decoded to f32 once a call and
//        encoded once a call (csf.py:1633-1641, :1784-1792): between
//        sub-steps the state stays f32, so T steps of K3h are not T steps
//        of K2;
//   K3s  split (f_r, f_b), two (9, ny, nx) arrays, f32 or f64.
// Every sub-step rewrites the boundary rows of the window first, by global
// row, as _apply_bcs_window{,_c} (:374, :461) do: the inlet (row ny-2, its
// ghost ny-1), then the outlet (Dirichlet row 1 and ghost 0, or the
// convective rows 2, 1, 0 each copying the row above), then the physics of
// the T=1 kernels on the window (csf2d.cuh, pert2d.cuh), whose device
// functions it calls.  Deferred solid masking (_defer_ok :302-321) is a TPU
// saving that changes no output: solid cells are zeroed every sub-step.
//
// The window machinery is block2d.cuh's.  Rings a sub-step: CSF 4 (stream
// <- curvature <- gradient <- phi_ext <- phi), Perturbation 2 (stream <-
// gradient of rho_r - rho_b); margins: the outlet band reaches 3 rows up,
// the inlet ghost 1 row down.  Window planes (compute type):
//   CSF          state (10 compressed, 18 split), then PHI, GX, GY: phi
//                (phi_ext on solid cells), then the wetted gradient; after
//                the collision PHI, GX, GY hold frac, A and B of the LKR
//                recolouring, so the streamed red part is recomputed from
//                the source cell (frac o_i + w_j (e_j . (A, B))).
//   Perturbation state, then D (rho_r - rho_b, solid_phi on solids), PH
//                (phi, outlet repair applied), and 9 planes of the red
//                post-collision part (compressed; the split layout keeps
//                it in its f_b planes).
// The collision writes the post-collision PDF over the state planes; the
// stream pass (stream_set) moves them in place; a last pass recolours.
// The CSF sub-step's passes are device functions (csf_window_fields,
// csf_window_physics) that coupled2d_block.cuh (K5c-T) runs too.
//
// What bounds it: HBM bytes per cell-step are the state read once and
// written once a call over T, plus the geometry: 81/T B (compressed f32),
// 45/T (bf16), 145/T (split f32) at least.  What sets its pace instead is
// the recompute of the halo (the window is 1.6-4x the tile at T=2-4) and
// the latency of one 512-thread block a streaming multiprocessor (the
// window takes up to 227 KB of shared memory) across 15 barriers a CSF
// sub-step.

#pragma once

#include "pert2d.cuh"
#include "block2d.cuh"

namespace {

constexpr int kCSF = 0;
constexpr int kPert = 1;

// Window plane counts: state planes NS, then the variant's helpers.
template <int L> struct StatePlanes {
  static constexpr int NS = L == kSplit ? 18 : 10;
};
template <int V, int L> struct CsfWindow {
  static constexpr int NS = StatePlanes<L>::NS;
  static constexpr int PHI = NS;       // CSF: phi / frac;  Pert: D
  static constexpr int GX = NS + 1;    // CSF: gx / A;      Pert: PH
  static constexpr int GY = NS + 2;    // CSF: gy / B
  static constexpr int RED = NS + 2;   // Pert compressed: 9 red planes
  static constexpr int PLANES =
      V == kCSF ? NS + 3 : (L == kSplit ? NS + 2 : NS + 11);
};

// One cell of the window (cell index c, planes PL apart) to and from
// registers.
template <typename C, int L>
__device__ __forceinline__ void win_get(const C* W, size_t PL, int c, Cell<C, L>& v) {
  if constexpr (L == kSplit) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      v.r[i] = W[i * PL + c];
      v.b[i] = W[(9 + i) * PL + c];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) v.f[i] = W[i * PL + c];
    v.rr = W[9 * PL + c];
  }
}

template <typename C, int L>
__device__ __forceinline__ void win_put(C* W, size_t PL, int c, const Cell<C, L>& v) {
  if constexpr (L == kSplit) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      W[i * PL + c] = v.r[i];
      W[(9 + i) * PL + c] = v.b[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) W[i * PL + c] = v.f[i];
    W[9 * PL + c] = v.rr;
  }
}

// phi of a fluid cell's state (phi_at)
template <typename C, int L>
__device__ __forceinline__ C win_phase(const C* W, size_t PL, int c) {
  Cell<C, L> v;
  win_get(W, PL, c, v);
  C f[9], rr, rb, rho;
  totals(v, f, rr, rb, rho);
  const C tot = rr + rb;
  return tot != C(0) ? (rr - rb) / tot : C(0);
}

// phi of window cell c on global row g, with the Dirichlet-outlet repair:
// fluid cells of rows 1 and 0 take row 2's phi (0 where row 2 is solid).
template <typename C, int L>
__device__ __forceinline__ C win_phi(const C* W, size_t PL, const unsigned char* FL,
                                     int c, int ly, int g, int wx, int wy,
                                     const CsfParams& P) {
  if (!FL[c]) return C(0);
  if (P.phi_repair && g <= 1) {
    const int up = 2 - g;
    if (ly + up >= wy) return C(0);  // beyond the window: a stale cell
    const int c2 = c + up * wx;
    return FL[c2] ? win_phase<C, L>(W, PL, c2) : C(0);
  }
  return win_phase<C, L>(W, PL, c);
}

// The boundary rows of the window region r, column by column, in the
// order of ColorGradientRK._apply_bcs_c / _apply_inlet + _apply_outlet:
// inlet rewrite (row ny-2), its ghost (ny-1 <- ny-2), then the Dirichlet
// outlet (row 1, ghost 0 <- 1) or the convective rows (2 <- 3, 1 <- 2,
// 0 <- 1), each on fluid cells.
template <typename C, int L>
__device__ void window_bc_rows(C* W, size_t PL, const unsigned char* FL, const Region& r,
                               int wx, int wy, int oy, const CsfParams& P) {
  if (P.inlet == 0 && P.outlet == 0) return;
  constexpr int NS = StatePlanes<L>::NS;
  const int ny = P.ny;
  auto copy = [&](int dst, int src) {
#pragma unroll
    for (int q = 0; q < NS; ++q) W[q * PL + dst] = W[q * PL + src];
  };
  for (int lx = r.x0 + threadIdx.x; lx < r.x1; lx += kBlockThreads) {
    if (P.inlet != 0) {
      for (int ly = r.y0; ly < r.y1; ++ly) {
        const int c = ly * wx + lx;
        if (wrap(oy + ly, ny) == ny - 2 && FL[c]) {
          Cell<C, L> v;
          win_get(W, PL, c, v);
          apply_inlet(v, P);
          win_put(W, PL, c, v);
        }
      }
      for (int ly = r.y0; ly < r.y1; ++ly) {
        const int c = ly * wx + lx;
        if (ly > 0 && wrap(oy + ly, ny) == ny - 1 && FL[c]) copy(c, c - wx);
      }
    }
    if (P.outlet == 2) {
      for (int ly = r.y0; ly < r.y1; ++ly) {
        const int c = ly * wx + lx;
        if (wrap(oy + ly, ny) == 1 && FL[c]) {
          Cell<C, L> v;
          win_get(W, PL, c, v);
          apply_outlet(v, P);
          win_put(W, PL, c, v);
        }
      }
      for (int ly = r.y0; ly < r.y1; ++ly) {
        const int c = ly * wx + lx;
        if (ly + 1 < wy && wrap(oy + ly, ny) == 0 && FL[c]) copy(c, c + wx);
      }
    } else if (P.outlet == 1) {
      for (int row = 2; row >= 0; --row) {
        for (int ly = r.y0; ly < r.y1; ++ly) {
          const int c = ly * wx + lx;
          if (ly + 1 < wy && wrap(oy + ly, ny) == row && FL[c]) copy(c, c + wx);
        }
      }
    }
  }
}

// The CSF colour fields of the window region shrunk by e0 (the state as
// it stands): PHI <- phi (outlet repair on rows 0 and 1; phi_ext on solid
// cells with wetting), on shrunk(e0 + 1), then GX, GY <- the wetted colour
// gradient on shrunk(e0 + 2).  gidx(c) is window cell c's global index.
template <typename C, int L, typename Gidx>
__device__ void csf_window_fields(C* W, size_t PL, const unsigned char* FL,
                                  const C* __restrict__ geo, size_t n, Gidx gidx,
                                  const BlockShape& B, int e0, int oy, const CsfParams& P) {
  using Win = CsfWindow<kCSF, L>;
  const int wx = B.wx, wy = B.wy, ny = P.ny;
  C* PHI = W + Win::PHI * PL;
  C* GX = W + Win::GX * PL;
  C* GY = W + Win::GY * PL;
  // phi (outlet repair on rows 0 and 1)
  Region r = shrunk(B, e0);
  for (int t = threadIdx.x; t < r.area(); t += kBlockThreads) {
    const int ly = r.y0 + t / r.w(), c = ly * wx + r.x0 + t % r.w();
    PHI[c] = win_phi<C, L>(W, PL, FL, c, ly, wrap(oy + ly, ny), wx, wy, P);
  }
  __syncthreads();
  // phi extended onto solid cells: the w-weighted mean of the fluid
  // neighbours (solid neighbours count 0, their phi before the pass), num /
  // den as the reference forms it, den summed from the fluid flags
  if (P.has_wetting) {
    r = shrunk(B, e0 + 1);
    for (int t = threadIdx.x; t < r.area(); t += kBlockThreads) {
      const int c = (r.y0 + t / r.w()) * wx + r.x0 + t % r.w();
      if (FL[c]) continue;
      C num = C(0), den = C(0);
#pragma unroll
      for (int i = 1; i < 9; ++i) {
        const int cn = c + ey(i) * wx + ex(i);
        num = num + C(wq(i)) * (FL[cn] ? PHI[cn] : C(0));
        den = den + C(wq(i)) * C(FL[cn] ? 1 : 0);
      }
      PHI[c] = den > C(0) ? num / den : C(0);
    }
    __syncthreads();
  }
  // the wetted colour gradient
  r = shrunk(B, e0 + 2);
  for (int t = threadIdx.x; t < r.area(); t += kBlockThreads) {
    const int c = (r.y0 + t / r.w()) * wx + r.x0 + t % r.w();
    C gx = C(0), gy = C(0);
    if (FL[c]) {
      phi_gradient([&](int i) { return PHI[c + ey(i) * wx + ex(i)]; }, gx, gy);
      if (P.has_wetting) {
        const size_t k = gidx(c);
        if (geo[n + k] > C(0.5))
          rotate_wetting(gx, gy, geo[2 * n + k], geo[3 * n + k], P);
      }
    }
    GX[c] = gx;
    GY[c] = gy;
  }
  __syncthreads();
}

// One CSF sub-step's physics on the window, its boundary rows already
// rewritten: the colour fields, then the collision on shrunk(e0 + 3), the
// recolouring factors, the pull streaming and the red parts on
// shrunk(e0 + 4) (solid cells 0).
template <typename C, int L, typename Gidx>
__device__ void csf_window_physics(C* W, size_t PL, const unsigned char* FL,
                                   const C* __restrict__ geo, size_t n, Gidx gidx,
                                   const BlockShape& B, int e0, int oy, const CsfParams& P) {
  using Win = CsfWindow<kCSF, L>;
  constexpr int NS = Win::NS;
  const int wx = B.wx;
  C* PHI = W + Win::PHI * PL;
  C* GX = W + Win::GX * PL;
  C* GY = W + Win::GY * PL;
  csf_window_fields<C, L>(W, PL, FL, geo, n, gidx, B, e0, oy, P);
  // the collision: post over the state planes, frac over rho_r (f_b's
  // rest plane in the split layout), segc over PHI
  Region r = shrunk(B, e0 + 3);
  auto normal_of = [&](int c, C& sx, C& sy) {
    unit_normal(GX[c], GY[c], FL[c] ? C(1) : C(0), P, sx, sy);
  };
  for (int t = threadIdx.x; t < r.area(); t += kBlockThreads) {
    const int c = (r.y0 + t / r.w()) * wx + r.x0 + t % r.w();
    if (!FL[c]) continue;
    Cell<C, L> v;
    win_get(W, PL, c, v);
    C f[9], rr, rb, rho;
    totals(v, f, rr, rb, rho);
    C nhx, nhy, fx, fy;
    normal_of(c, nhx, nhy);
    csf_force([&](int i, C& sx, C& sy) { normal_of(c + ey(i) * wx + ex(i), sx, sy); },
              nhx, nhy, GX[c], GY[c], rho, P, fx, fy);
    C post[9], frac, segc;
    collide_core(f, rr, rb, rho, PHI[c], fx, fy, P, post, frac, segc);
#pragma unroll
    for (int i = 0; i < 9; ++i) W[i * PL + c] = post[i];
    W[9 * PL + c] = frac;
    PHI[c] = segc;
  }
  __syncthreads();
  // the recolouring factors: PHI <- frac, GX <- A, GY <- B
  for (int t = threadIdx.x; t < r.area(); t += kBlockThreads) {
    const int c = (r.y0 + t / r.w()) * wx + r.x0 + t % r.w();
    if (!FL[c]) continue;
    C A, Bv;
    lkr_factors(PHI[c], GX[c], GY[c], A, Bv);
    PHI[c] = W[9 * PL + c];
    GX[c] = A;
    GY[c] = Bv;
  }
  __syncthreads();
  // pull streaming of the post-collision PDF, then the red parts
  r = shrunk(B, e0 + 4);
  stream_set(W, PL, FL, wx, r);
  for (int t = threadIdx.x; t < r.area(); t += kBlockThreads) {
    const int c = (r.y0 + t / r.w()) * wx + r.x0 + t % r.w();
    if (!FL[c]) {
#pragma unroll
      for (int q = 0; q < NS; ++q) W[q * PL + c] = C(0);
      continue;
    }
    C red[9];
    C rr_new = C(0);
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const C o = W[i * PL + c];
      if (i == 0) {
        red[0] = PHI[c] * o;
        rr_new = red[0];
        continue;
      }
      int src = c - ey(i) * wx - ex(i), j = i;
      if (!FL[src]) {
        src = c;
        j = opp(i);
      }
      const C seg = C(wq(j)) * (C(ex(j)) * GX[src] + C(ey(j)) * GY[src]);
      red[i] = PHI[src] * o + seg;
      rr_new = rr_new + red[i];
    }
    if constexpr (L == kSplit) {
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        const C o = W[i * PL + c];
        W[i * PL + c] = red[i];
        W[(9 + i) * PL + c] = o - red[i];
      }
    } else {
      W[9 * PL + c] = rr_new;
    }
  }
  __syncthreads();
}

// LOCAL: the local form (K12a), one shard's centre of the padded buffers
// of G (block2d.cuh); the state and geometry planes are G.py x G.px cells.
template <typename S, int L, int V, bool LOCAL = false, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(kBlockThreads, 1)
csf_block_kernel(const S* __restrict__ s, const S* __restrict__ s2,
                 const C* __restrict__ geo, S* __restrict__ out, S* __restrict__ out2,
                 CsfParams P, BlockShape B, LocalGrid G, unsigned char* __restrict__ scratch) {
  using Win = CsfWindow<V, L>;
  constexpr int NS = Win::NS;
  extern __shared__ __align__(16) unsigned char smem[];
  C* W = window_planes<C>(B, smem, scratch);
  unsigned char* FL = window_fluid(B, smem, scratch, Win::PLANES, (int)sizeof(C));
  const int nx = P.nx, ny = P.ny;
  // the cells this launch writes (the domain, or the shard's centre) and
  // the cells of a plane
  const int tnx = LOCAL ? G.nx : nx, tny = LOCAL ? G.ny : ny;
  const size_t n = LOCAL ? (size_t)G.py * G.px : (size_t)ny * nx;
  const int wx = B.wx, wy = B.wy;
  const size_t PL = (size_t)wx * wy;

  for (int tile = blockIdx.x; tile < B.ntx * B.nty; tile += gridDim.x) {
    const int x0 = (tile % B.ntx) * B.tx, y0 = (tile / B.ntx) * B.ty;
    const int ox = x0 - B.hx, ly0 = y0 - B.hlo;
    // the global row of window row 0
    const int oy = LOCAL ? G.row0 + ly0 : ly0;
    auto gidx = [&](int c) {
      if constexpr (LOCAL) return local_index(G, ly0 + c / wx, ox + c % wx);
      else return (size_t)wrap(oy + c / wx, ny) * nx + wrap(ox + c % wx, nx);
    };

    // decode the window once
    for (int c = threadIdx.x; c < wx * wy; c += kBlockThreads) {
      const size_t k = gidx(c);
      Cell<C, L> v;
      load_raw<S, L>(s, s2, geo, n, k, v);
      win_put(W, PL, c, v);
      FL[c] = geo[k] > C(0.5);
    }
    __syncthreads();

    for (int sub = 0; sub < B.T; ++sub) {
      const int e0 = B.ring * sub;
      window_bc_rows<C, L>(W, PL, FL, shrunk(B, e0), wx, wy, oy, P);
      __syncthreads();

      if constexpr (V == kCSF) {
        csf_window_physics<C, L>(W, PL, FL, geo, n, gidx, B, e0, oy, P);
      } else {
        C* D = W + Win::PHI * PL;
        C* PH = W + Win::GX * PL;
        // d = rho_r - rho_b (solid_phi on solid cells) and phi with the
        // outlet repair
        Region r = shrunk(B, e0);
        for (int t = threadIdx.x; t < r.area(); t += kBlockThreads) {
          const int ly = r.y0 + t / r.w(), c = ly * wx + r.x0 + t % r.w();
          C d = C(P.solid_phi);
          if (FL[c]) {
            Cell<C, L> v;
            win_get(W, PL, c, v);
            C f[9], rr, rb, rho;
            totals(v, f, rr, rb, rho);
            d = rr - rb;
          }
          D[c] = d;
          PH[c] = win_phi<C, L>(W, PL, FL, c, ly, wrap(oy + ly, ny), wx, wy, P);
        }
        __syncthreads();
        // the collision: post over the state planes, the red part over the
        // red planes (compressed) or the f_b planes (split)
        C* RED = L == kSplit ? W + 9 * PL : W + Win::RED * PL;
        r = shrunk(B, e0 + 1);
        for (int t = threadIdx.x; t < r.area(); t += kBlockThreads) {
          const int c = (r.y0 + t / r.w()) * wx + r.x0 + t % r.w();
          if (!FL[c]) continue;
          Cell<C, L> v;
          win_get(W, PL, c, v);
          C gx, gy;
          pert_gradient([&](int i) { return D[c + ey(i) * wx + ex(i)]; }, P, gx, gy);
          C post[9], red[9];
          pert_collide(v, PH[c], gx, gy, P, post, red);
#pragma unroll
          for (int i = 0; i < 9; ++i) {
            W[i * PL + c] = post[i];
            RED[i * PL + c] = red[i];
          }
        }
        __syncthreads();
        r = shrunk(B, e0 + 2);
        stream_set(W, PL, FL, wx, r);
        stream_set(RED, PL, FL, wx, r);
        for (int t = threadIdx.x; t < r.area(); t += kBlockThreads) {
          const int c = (r.y0 + t / r.w()) * wx + r.x0 + t % r.w();
          if (!FL[c]) {
#pragma unroll
            for (int q = 0; q < NS; ++q) W[q * PL + c] = C(0);
            continue;
          }
          if constexpr (L == kSplit) {
#pragma unroll
            for (int i = 0; i < 9; ++i) {
              const C o = W[i * PL + c], red = RED[i * PL + c];
              W[i * PL + c] = red;
              RED[i * PL + c] = o - red;
            }
          } else {
            C rr_new = RED[c];
#pragma unroll
            for (int i = 1; i < 9; ++i) rr_new = rr_new + RED[i * PL + c];
            W[9 * PL + c] = rr_new;
          }
        }
        __syncthreads();
      }
    }

    // encode the tile once
    for (int t = threadIdx.x; t < B.tx * B.ty; t += kBlockThreads) {
      const int x = x0 + t % B.tx, y = y0 + t / B.tx;
      if (x >= tnx || y >= tny) continue;
      const int c = (B.hlo + t / B.tx) * wx + B.hx + t % B.tx;
      const size_t k = LOCAL ? (size_t)(G.fy + y) * G.px + G.fx + x : (size_t)y * nx + x;
      Cell<C, L> v;
      win_get(W, PL, c, v);
      if constexpr (L == kSplit) {
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          out[i * n + k] = v.r[i];
          out2[i * n + k] = v.b[i];
        }
      } else {
        store_state<S>(out, n, k, v.f, v.rr, geo[k]);
      }
    }
    __syncthreads();
  }
}

// The launch's tiling for T sub-steps of variant V on layout L: the
// domain's, or (LOCAL) the centre's of G, the bands by the global rows.
template <typename S, int L, int V, bool LOCAL = false>
BlockShape csf_block_shape(const CsfParams& P, int T, const LocalGrid& G = LocalGrid{}) {
  using C = typename Traits<S>::C;
  const int ring = V == kCSF ? 4 : 2;
  return block_shape(LOCAL ? G.ny : P.ny, LOCAL ? G.nx : P.nx, T, ring,
                     P.inlet != 0 ? 1 : 0, P.outlet != 0 ? 3 : 0, CsfWindow<V, L>::PLANES,
                     (int)sizeof(C), P.ny);
}

// One launch; LOCAL refuses a frame of G that does not cover the reach.
template <typename S, int L, int V, bool LOCAL = false>
int launch_csf_block(const void* s_in, const void* s2_in, void* s_out, void* s2_out,
                     const void* geo_v, void* scratch, const CsfParams& P, int T,
                     cudaStream_t st, const LocalGrid& G = LocalGrid{}) {
  using C = typename Traits<S>::C;
  const BlockShape B = csf_block_shape<S, L, V, LOCAL>(P, T, G);
  if (B.wx * B.wy > kMaxWindow) return (int)cudaErrorInvalidValue;  // T too large
  if (B.gmem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (LOCAL && !frame_covers(G, B)) return (int)cudaErrorInvalidValue;
  const size_t smem = B.gmem ? 0 : B.win_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(csf_block_kernel<S, L, V, LOCAL>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  csf_block_kernel<S, L, V, LOCAL><<<B.grid, kBlockThreads, smem, st>>>(
      static_cast<const S*>(s_in), static_cast<const S*>(s2_in),
      static_cast<const C*>(geo_v), static_cast<S*>(s_out), static_cast<S*>(s2_out), P, B,
      G, static_cast<unsigned char*>(scratch));
  return (int)cudaGetLastError();
}

}  // namespace

namespace {

// -- the local form (K12a) ------------------------------------------------------

// The local launch's tiling of the parameter block's variant (compressed).
template <typename S>
BlockShape csf_local_shape(const CsfParams& P, int T, const LocalGrid& G) {
  return P.variant == 0 ? csf_block_shape<S, kCompressed, kCSF, true>(P, T, G)
                        : csf_block_shape<S, kCompressed, kPert, true>(P, T, G);
}

// T steps of one shard's compressed state (the padded buffer s_in) into
// the centre of s_out; geo is the shard's padded geometry.
template <typename S>
int launch_csf_local(const void* s_in, void* s_out, const void* geo, void* scratch,
                     const CsfParams& P, const LocalGrid& G, int T, cudaStream_t st) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  return P.variant == 0
             ? launch_csf_block<S, kCompressed, kCSF, true>(s_in, nullptr, s_out, nullptr, geo,
                                                           scratch, P, T, st, G)
             : launch_csf_block<S, kCompressed, kPert, true>(s_in, nullptr, s_out, nullptr,
                                                            geo, scratch, P, T, st, G);
}

}  // namespace
