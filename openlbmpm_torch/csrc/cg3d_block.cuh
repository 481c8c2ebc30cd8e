// Temporally blocked D3Q19 CSF colour-gradient step (K9-T) for NVIDIA Hopper
// (sm_90a), T time steps a launch.  Each of cg3d_block_f64.cu,
// cg3d_block_f32.cu and cg3d_block_bf16.cu instantiates one storage type.
//
// Replaces the TPU kernel openlbmpm_tpu/pallas/cg3d.py::build_cg3d_fused_step
// with steps_per_call = T > 1 (:235-238, the kernel :881-958): the
// compressed state (f_total, rho_r) in f32 / f64 (K9-Tc) and bf16 (K9-Th,
// decoded to f32 once a call and encoded once), and the split state
// (f_r, f_b) in f32 / f64 (K9-Ts).  Before every sub-step the boundary
// slabs apply, selected by GLOBAL z (the TPU kernel's zrows = (i0 R - H +
// z) mod nz): the NEBB velocity inlet on slab nz-2 and its ghost nz-1,
// which copies the updated nz-2; the convective outlet copying slab 3 -> 2,
// then 2 -> 1, then 1 -> 0, each from the updated slab above; or the NEBB
// pressure outlet on slab 1 and its ghost 0.  The compressed rewrite moves
// rho_r by the slab's red fraction of the change (_apply_bcs_window_c
// :557), the split one splits each new population by that fraction
// (_apply_bcs_window :624): the two layouts part on a mixed slab, and each
// keeps its own.  Then the physics sub-step of the one-step kernel, from
// cg3d.cuh's device functions (cell_phase, extrapolated_phi, phi_gradient,
// rotate_akai, inward_normal, curvature_of, collide_core, red_part): the
// jnp formulas (the Akai rotation with its distance comparison), not the
// TPU kernel's rsqrt and squared-distance tie test.
//
// The design: the pipelined z-march of march3d.cuh, on the plan of
// kernels/march3d.py::cg3d_march_plan.  Per level s (the state after s
// steps) up to five stages, each a run of slabs of one level a wave, each
// ring [plane][slot][row][x] in the scratch:
//   load     (level 0) the input state decoded into the ring st_0 (20 or 38
//            planes), and phi_0 of it;
//   bc       with an inlet or outlet, at slabs nz-2 and 0 only: one
//            thread a column rewrites the boundary slabs of st_s in place,
//            in the reference's order (reading up to 3 slabs above,
//            finalising up to 2), and phi_s of each slab it rewrites;
//   extrap   (wetting walls) phi_s on solid cells from its fluid neighbours,
//            in place;
//   normal   phi_s one slab and row around -> g (rotated on wetting fluid
//            cells) and the unit inward normal n: gn_s (6 planes);
//   collide  n one slab and row around -> kappa, and the collision of st_s
//            at the slab -> po_s: post_i and its red part red_part(i, post_i,
//            frac, A, B, Cz) (38 planes);
//   stream   po_s one slab and row around: pull streaming with half-way
//            bounce-back of post and of its red part -> st_{s+1} (f, rho_r'
//            or f_r, f_b) and phi_{s+1}, or at the last level the output,
//            encoded once.
// Phi and the red parts ride with the stages that have the cell's values
// at hand, so no stage re-reads the state for them.  With 8 slabs a wave
// (the fastest of 1, 2, 4, 8 at 128^3, PERF.md) a level trails the one
// before by 47 slabs at configuration 5 (wetting walls, the velocity inlet,
// the convective outlet), and the state and phi rings hold 46 slabs, gn
// and po 18: 0.46 GB at 128^3 and T = 4 in f32, through HBM more than L2.
// The periodic z seam is recomputed (each level starts its downstream
// stages' reach below slab 0), nothing else in z; the plan cuts the plane
// into y-bands (a halo of 4T rows) only where the rings would outgrow their
// budget of device memory.
//
// What bounds it: HBM bytes per cell-step are the state read once and
// written once a call, plus the 4 geometry planes, over T: 161 / T B
// (compressed f32), 85 / T (bf16), 305 / T (split f32).  The rings move
// about 2 x 65 x 4 B a cell-step more (compressed f32: state 20, phi, g and
// n 6, post and red 38), most of it to and from HBM, and the grid waits at
// a barrier once a wave.

#pragma once

#include "cg3d.cuh"
#include "march3d.cuh"

namespace {

constexpr int kMaxSteps3 = 8;   // the largest T a launch takes

template <int L>
__host__ __device__ constexpr int cg3d_state_planes() {
  return L == kSplit ? 2 * Q : Q + 1;
}

// A state ring's cell at slab u + dz (ring planes in the layout's order:
// f_r then f_b, or f then rho_r) in and out of a Cell.
template <typename C, int L>
__device__ __forceinline__ void ring_get(const RingAt<C>& R, int dz, Cell<C, L>& c) {
  const C* p = R.base + R.cell_slab(dz);
  const size_t st = R.stride;
  if constexpr (L == kSplit) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      c.r[i] = p[i * st];
      c.b[i] = p[(Q + i) * st];
    }
  } else {
#pragma unroll
    for (int i = 0; i < Q; ++i) c.f[i] = p[i * st];
    c.rr = p[Q * st];
  }
}

template <typename C, int L>
__device__ __forceinline__ void ring_put(const RingAt<C>& R, int dz, const Cell<C, L>& c) {
  C* p = R.base + R.cell_slab(dz);
  const size_t st = R.stride;
  if constexpr (L == kSplit) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      p[i * st] = c.r[i];
      p[(Q + i) * st] = c.b[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < Q; ++i) p[i * st] = c.f[i];
    p[Q * st] = c.rr;
  }
}

// phi of a cell's state, 0 unless fluid.
template <typename C, int L>
__device__ __forceinline__ C phase_of(const Cell<C, L>& x, bool fluid) {
  return fluid ? cell_phase(x) : C(0);
}

// One cell of one stage of K9-T's march (march3d.cuh's MarchCell c), rings
// as kernels/march3d.py::cg3d_march_plan hands them: load st_0, phi_0; bc
// st_s, phi_s; extrap phi_s; normal phi_s, gn_s; collide st_s, phi_s, gn_s,
// po_s; stream po_s, st_{s+1}, phi_{s+1} (-1 at the last level: the output).
template <typename S, int L, typename C = typename Traits<S>::C>
__device__ __forceinline__ void cg3d_march_cell(const S* __restrict__ s_in,
                                                const S* __restrict__ s2_in,
                                                const C* __restrict__ geo,
                                                S* __restrict__ s_out, S* __restrict__ s2_out,
                                                const Cg3dParams& P, const MarchPlan& M,
                                                const MarchCell& c) {
  constexpr int NS = cg3d_state_planes<L>();
  const int nz = P.nz;
  const size_t nxy = (size_t)P.ny * P.nx;
  const size_t n = (size_t)nz * nxy;
  const size_t gidx = c.gidx(0, 0, 0, nxy);
  // whether the neighbour (dz, dy, dx), |d| <= 1, is fluid
  auto fluid_at = [&](int dz, int dy, int dx) { return geo[c.gidx(dz, dy, dx, nxy)] > C(0.5); };
  const bool fluid = geo[gidx] > C(0.5);
  const int kind = c.kind();
  if (kind == kStageLoad) {
    const State<S> st{s_in, s2_in, nullptr};
    Cell<C, L> x;
    load_cell<S, L>(st, geo, P, c.gz, c.gy, c.x, x);
    ring_put(M.ring<C>(c.ring(0), c), 0, x);
    M.ring<C>(c.ring(1), c).at(0) = phase_of(x, fluid);
  } else if (kind == kStageBc) {
    const RingAt<C> R = M.ring<C>(c.ring(0), c), PH = M.ring<C>(c.ring(1), c);
    // whether slab gz + k of this column is fluid
    auto fluid_k = [&](int k) {
      return geo[(size_t)mwrap(c.gz + k, nz) * nxy + gidx % nxy] > C(0.5);
    };
    // slab u + dst takes slab u + src's state (a fluid cell), and phi of it
    auto copy = [&](int dst, int src) {
      for (int p = 0; p < NS; ++p) R.at_slab(p, dst) = R.at_slab(p, src);
      Cell<C, L> x;
      ring_get(R, dst, x);
      PH.at_slab(0, dst) = cell_phase(x);
    };
    auto nebb = [&](int dz, bool inlet) {
      Cell<C, L> x;
      ring_get(R, dz, x);
      rewrite(x, P, inlet);
      ring_put(R, dz, x);
      PH.at_slab(0, dz) = cell_phase(x);
    };
    if (P.inlet == 1 && c.gz == nz - 2) {
      if (fluid) nebb(0, true);
      if (fluid_k(1)) copy(1, 0);
    }
    if (P.outlet == 1 && c.gz == 0) {
      for (int k = 2; k >= 0; --k)
        if (fluid_k(k)) copy(k, k + 1);
    } else if (P.outlet == 2 && c.gz == 0) {
      if (fluid_k(1)) nebb(1, false);
      if (fluid) copy(0, 1);
    }
  } else if (kind == kStageExtrap) {
    if (fluid) return;
    const RingAt<C> PH = M.ring<C>(c.ring(0), c);
    PH.at(0) = extrapolated_phi<C>([&](int i) { return fluid_at(ez(i), ey(i), ex(i)); },
                                   [&](int i) { return PH.at(0, ez(i), ey(i), ex(i)); });
  } else if (kind == kStageNormal) {
    const RingAt<C> PH = M.ring<C>(c.ring(0), c), GN = M.ring<C>(c.ring(1), c);
    C g[3], nv[3];
    phi_gradient<C>([&](int i) { return PH.at(0, ez(i), ey(i), ex(i)); }, g);
    if (P.has_wetting && geo[gidx] > C(1.5)) {
      const C ns[3] = {geo[n + gidx], geo[2 * n + gidx], geo[3 * n + gidx]};
      rotate_akai(g, ns, P);
    }
    inward_normal(g, fluid ? C(1) : C(0), nv);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      GN.at(d) = g[d];
      GN.at(3 + d) = nv[d];
    }
  } else if (kind == kStageCollide) {
    const RingAt<C> ST = M.ring<C>(c.ring(0), c), PH = M.ring<C>(c.ring(1), c);
    const RingAt<C> GN = M.ring<C>(c.ring(2), c), PO = M.ring<C>(c.ring(3), c);
    // post_i and its red part red_part(i, post_i, frac, A, B, Cz), the
    // value the stream stage carries to the cell the population reaches
    C post[Q], red[Q];
    if (fluid) {
      const C nh[3] = {GN.at(3), GN.at(4), GN.at(5)};
      const C kappa = curvature_of(
          [&](int i, int b) { return GN.at(3 + b, ez(i), ey(i), ex(i)); }, nh);
      Cell<C, L> x;
      ring_get(ST, 0, x);
      const C g[3] = {GN.at(0), GN.at(1), GN.at(2)};
      C frac, A, Bv, Cz;
      collide_core(x, PH.at(0), g, kappa, P, post, frac, A, Bv, Cz);
#pragma unroll
      for (int i = 0; i < Q; ++i) red[i] = red_part(i, post[i], frac, A, Bv, Cz);
    } else {
#pragma unroll
      for (int i = 0; i < Q; ++i) post[i] = red[i] = C(0);
    }
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      PO.at(i) = post[i];
      PO.at(Q + i) = red[i];
    }
  } else if (kind == kStageStream) {
    const RingAt<C> PO = M.ring<C>(c.ring(0), c);
    // o: the streamed total PDF; red: its red part (the blue part is
    // o - red)
    C o[Q], red[Q];
    C rr = C(0);
    if (fluid) {
      // the upwind cell x - e_i of each direction, or the cell itself with
      // the opposite population where that is solid (half-way bounce-back)
      int src[Q];
#pragma unroll
      for (int i = 0; i < Q; ++i)
        src[i] = fluid_at(-ez(i), -ey(i), -ex(i)) ? PO.cell(-ez(i), -ey(i), -ex(i)) : -1;
      const size_t ps = PO.stride;
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const int j = src[i] < 0 ? opp(i) : i;
        const C* p = PO.base + (src[i] < 0 ? PO.cell(0, 0, 0) : src[i]);
        o[i] = p[j * ps];
        red[i] = p[(Q + j) * ps];
        rr = rr + red[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < Q; ++i) o[i] = red[i] = C(0);
    }
    if (c.ring(1) < 0) {
      if constexpr (L == kSplit) {
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          s_out[i * n + gidx] = red[i];
          s2_out[i * n + gidx] = o[i] - red[i];
        }
      } else {
        Cell<C, kCompressed> x;
#pragma unroll
        for (int i = 0; i < Q; ++i) x.f[i] = o[i];
        x.rr = rr;
        encode<S, kCompressed>(s_out, n, gidx, fluid ? C(1) : C(0), x);
      }
    } else {
      Cell<C, L> x;
      if constexpr (L == kSplit) {
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          x.r[i] = red[i];
          x.b[i] = o[i] - red[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < Q; ++i) x.f[i] = o[i];
        x.rr = rr;
      }
      ring_put(M.ring<C>(c.ring(1), c), 0, x);
      M.ring<C>(c.ring(2), c).at(0) = phase_of(x, fluid);
    }
  }
}

// Resident blocks an SM the march kernel asks ptxas for: in float
// arithmetic 3 for the compressed layout (80 registers, 36 bytes spilled;
// at 1 block and up to 185 registers K9-Tc ran 1.5-2.4x slower at 128^3,
// PERF.md) and 2 for the split one (its 38 state planes spill 0.85 KB at
// 80 registers), 1 for the f64 check instances.
template <typename S, int L>
constexpr int cg3d_march_min_blocks() {
  return sizeof(typename Traits<S>::C) == 8 ? 1 : (L == kSplit ? 2 : 3);
}

template <typename S, int L, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(kMarchThreads, cg3d_march_min_blocks<S, L>())
cg3d_march_kernel(const S* __restrict__ s_in, const S* __restrict__ s2_in,
                  const C* __restrict__ geo, S* __restrict__ s_out, S* __restrict__ s2_out,
                  Cg3dParams P, const long long* __restrict__ plan,
                  unsigned char* __restrict__ scratch) {
  MarchPlan M{plan, scratch, nullptr, nullptr, nullptr};
  march_run(M, [&](const MarchCell& c) {
    cg3d_march_cell<S, L>(s_in, s2_in, geo, s_out, s2_out, P, M, c);
  });
}

template <typename S, int L>
int launch_cg3d_march_l(const void* s_in, const void* s2_in, void* s_out, void* s2_out,
                        const void* geo, void* scratch, const void* plan, const Cg3dParams& P,
                        cudaStream_t st) {
  using C = typename Traits<S>::C;
  const S* a = static_cast<const S*>(s_in);
  const S* b = static_cast<const S*>(s2_in);
  const C* g = static_cast<const C*>(geo);
  S* oa = static_cast<S*>(s_out);
  S* ob = static_cast<S*>(s2_out);
  const long long* pl = static_cast<const long long*>(plan);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  Cg3dParams p = P;
  void* args[] = {&a, &b, &g, &oa, &ob, &p, &pl, &sc};
  return march_launch(cg3d_march_kernel<S, L>, args, st);
}

// Whether (split, T) names a launch this storage type takes.
template <typename S>
bool cg3d_block_takes(int split, int T) {
  if (split && Traits<S>::kShifted) return false;   // no split bf16 layout
  return (split == 0 || split == 1) && T >= 1 && T <= kMaxSteps3;
}

// T steps a launch on the plan `plan` (device memory) with its rings in
// `scratch`; split = 0: the compressed state in s_in / s_out, 1: f_r in
// s_in / s_out and f_b in s2_in / s2_out.
template <typename S>
int launch_cg3d_march(int split, int T, const void* s_in, const void* s2_in, void* s_out,
                      void* s2_out, const void* geo, void* scratch, const void* plan,
                      const Cg3dParams& P, cudaStream_t st) {
  if (!cg3d_block_takes<S>(split, T) || scratch == nullptr || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  if constexpr (!Traits<S>::kShifted) {
    if (split)
      return launch_cg3d_march_l<S, kSplit>(s_in, s2_in, s_out, s2_out, geo, scratch, plan, P,
                                            st);
  }
  return launch_cg3d_march_l<S, kCompressed>(s_in, s2_in, s_out, s2_out, geo, scratch, plan, P,
                                             st);
}

template <typename S>
int cg3d_march_grid_of(int split, int* grid) {
  if (!cg3d_block_takes<S>(split, 1)) return (int)cudaErrorInvalidValue;
  if constexpr (!Traits<S>::kShifted) {
    if (split) return march_grid(cg3d_march_kernel<S, kSplit>, grid);
  }
  return march_grid(cg3d_march_kernel<S, kCompressed>, grid);
}

}  // namespace

// The C entry points of one storage type S (the library's).
#define CG3D_BLOCK_ENTRY_POINTS(S)                                                          \
  extern "C" int cg3d_march_step(int split, int T, const void* s_in, const void* s2_in,     \
                                 void* s_out, void* s2_out, const void* geo, void* scratch, \
                                 const void* plan, const Cg3dParams* params,                \
                                 void* stream) {                                            \
    return launch_cg3d_march<S>(split, T, s_in, s2_in, s_out, s2_out, geo, scratch, plan,   \
                                *params, static_cast<cudaStream_t>(stream));                \
  }                                                                                         \
  extern "C" int cg3d_march_grid(int split, int* grid) {                                    \
    return cg3d_march_grid_of<S>(split, grid);                                              \
  }                                                                                         \
  extern "C" int cg3d_block_max_steps(int split) {                                         \
    return cg3d_block_takes<S>(split, 1) ? kMaxSteps3 : 0;                                  \
  }                                                                                         \
  extern "C" const char* cg3d_block_error_string(int code) {                                \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                              \
  }
