// The row-march of the Shan-Chen T-step kernel K8-T for NVIDIA Hopper
// (sm_90a): T time steps a launch.  Each of sc2d_block_f64.cu,
// sc2d_block_f32.cu and sc2d_block_bf16.cu instantiates one storage type
// for K = 1, 2, 3 fluids and the original SC and EFS iso-4/8/10 stencils.
//
// Replaces the TPU kernel openlbmpm_tpu/pallas/shanchen.py::
// build_sc_fused_step with steps_per_call = T > 1 (call :824): every
// sub-step rewrites the inlet rows (_apply_inlet_window :361-401: row
// ny-1-d and its d ghost rows above), then runs the physics (psi_k, zero on
// solid cells; the collision of sc2d.cuh's sc_collide; pull streaming with
// half-way bounce-back, solid cells zeroed), then the outlet rows
// (_apply_outlet_window :402-440: the Zou-He row d and its ghosts, or the
// convective rows d+1 ... 0 each copying the row above), as :723-740.  The
// bf16 state (per fluid the deviations f_i - w_i rho_k, rho_k as a hi/lo
// pair) is decoded to f32 once a call and encoded once a call (:702-707,
// :742-753).
//
// The design: march3d.cuh's pipelined march with the rows of the domain in
// the place of the z slabs (kernels/march2d.py::sc2d_march_plan builds the
// plan on an (ny, 1, nx) grid, so a ring row is a row of nx cells and x
// wraps inside it), as the colour-gradient K3 (march2d.cuh).  One
// cooperative launch advances T steps; each stage of each level is a run of
// Z rows a wave, a grid barrier between waves; only level 0 is read from
// device memory and only level T written; the periodic y seam is recomputed
// by unwrapped rows below 0 and above ny - 1, nothing else.  Stages a level
// s (st_s: the K x 9 populations in the compute type; psi_s: psi_k of st_s,
// 0 on solid cells, formed by the thread that writes the state):
//   load     (level 0) the state decoded into the ring st_0, and psi_0;
//   bc       with an inlet, at the trigger row ny-1-d only, one thread a
//            column: the Zou-He inlet row and its d ghost rows above, in
//            place in st_s and psi_s (the order of the window kernels);
//   collide  psi_s R rows and columns around (R = the stencil's reach: 1,
//            2 for iso-8, 3 for iso-10; x wraps inside the ring row),
//            st_s at the cell: sc_collide -> po_s (K x 9 planes);
//   stream   po_s one row around: pull streaming with half-way bounce-back
//            -> st_{s+1} and psi_{s+1}, or at the last level without an
//            outlet the output, encoded;
//   outlet   with an outlet, at the trigger row 0 only, one thread a
//            column: the Zou-He row d and its ghosts below, or the
//            convective rows d + 1 ... 0, in place in st_{s+1} and
//            psi_{s+1};
//   store    (the last level, with an outlet) st_T encoded into the output:
//            the outlet rows of the last step must land before the bf16
//            encoding.
// A separate psi stage a level (reading st_s, writing psi_s) was 17-23%
// slower a step at 1024^2 on an H100 (PERF.md).
// The windows that K8-T ran on before (block2d.cuh) stay for the local form
// K12c (sc2d_block.cuh, sc2d_local.cuh).
//
// What bounds it: HBM bytes per cell-step are the state read once and
// written once a call over T, plus the geometry; the rings (K x 9 + K +
// K x 9 planes a level) spill from the 50 MB L2 to HBM at 1024^2.

#pragma once

#include "march3d.cuh"
#include "sc2d.cuh"

namespace {

// stage kinds beyond march3d.cuh's (kernels/march2d.py)
constexpr int kStageOutlet = 10;
constexpr int kStageStore = 11;

// The ring index of the cell dy rows above and dx columns right of the
// march cell (any dy; |dx| <= 3 < 2 nx: x wraps inside the ring row).
template <typename C>
__device__ __forceinline__ int sc_ring_cell(const RingAt<C>& R, int dy, int dx) {
  const int slot = dy >= -1 && dy <= 1 ? R.sb[dy + 1] : mwrap(R.c->u + dy, R.depth) * R.slab;
  const int col = dx >= -1 && dx <= 1 ? R.c->cc[dx + 1] : mwrap1(R.c->x + dx, R.c->nx);
  return slot + R.c->rr[1] + col;
}

// The K x 9 values of a state ring's cell dy rows above the march cell.
template <typename C, int K>
__device__ __forceinline__ void sc_ring_get(const RingAt<C>& R, int dy, C F[K][9]) {
  const C* p = R.base + sc_ring_cell(R, dy, 0);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 9; ++i) F[k][i] = p[(size_t)(k * 9 + i) * R.stride];
}

template <typename C, int K>
__device__ __forceinline__ void sc_ring_put(const RingAt<C>& R, int dy, const C F[K][9]) {
  C* p = R.base + sc_ring_cell(R, dy, 0);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 9; ++i) p[(size_t)(k * 9 + i) * R.stride] = F[k][i];
}

// psi_k of the K x 9 values F into a psi ring's cell dy rows above the
// march cell (0 on a solid cell); nothing where the stage has no psi ring.
template <typename C, int K>
__device__ __forceinline__ void sc_psi_put(const RingAt<C>& PS, int dy, const C F[K][9],
                                           bool fluid, const ScParams& P) {
  if (PS.base == nullptr) return;
  C* p = PS.base + sc_ring_cell(PS, dy, 0);
#pragma unroll
  for (int k = 0; k < K; ++k) p[(size_t)k * PS.stride] = fluid ? psi_of(sum9(F[k]), P) : C(0);
}

// The stages of one march cell; rings as kernels/march2d.py::sc2d_stages
// hands them: load st_0, psi_0; bc st_s, psi_s; collide st_s, psi_s, po_s;
// stream po_s, st_{s+1} (-1: the output), psi_{s+1}; outlet st_{s+1},
// psi_{s+1}; store st_T.  The last level's stream and outlet stages have
// no psi ring (-1).
template <typename S, int K, int ORDER, typename C = typename Traits<S>::C>
__device__ __forceinline__ void sc_march_cell(const S* __restrict__ f, const C* __restrict__ geo,
                                              S* __restrict__ out, const ScParams& P,
                                              const MarchPlan& M, const MarchCell& c) {
  const int ny = P.ny, nx = P.nx;
  const size_t n = (size_t)ny * nx;
  // the domain index of the cell dy rows above, dx columns right
  auto gidx = [&](int dy, int dx) -> size_t {
    const int gy = dy >= -1 && dy <= 1 ? c.gzz[dy + 1] : mwrap(c.gz + dy, ny);
    return (size_t)gy * nx + (dx >= -1 && dx <= 1 ? c.cc[dx + 1] : mwrap1(c.x + dx, nx));
  };
  auto fluid_at = [&](int dy, int dx) { return geo[gidx(dy, dx)] > C(0.5); };
  const size_t k0 = gidx(0, 0);
  const bool fluid = geo[k0] > C(0.5);
  const int kind = c.kind();
  if (kind == kStageLoad) {
    C F[K][9];
    load_raw<S, K>(f, n, k0, F);
    sc_ring_put<C, K>(M.ring<C>(c.ring(0), c), 0, F);
    sc_psi_put<C, K>(M.ring<C>(c.ring(1), c), 0, F, fluid, P);
  } else if (kind == kStageBc) {
    // the inlet row (the trigger) and its d ghost rows above
    const RingAt<C> R = M.ring<C>(c.ring(0), c), PS = M.ring<C>(c.ring(1), c);
    C F[K][9];
    sc_ring_get<C, K>(R, 0, F);
    if (fluid) {
      apply_inlet<C, K>(F, P);
      sc_ring_put<C, K>(R, 0, F);
      sc_psi_put<C, K>(PS, 0, F, true, P);
    }
    for (int r = 1; r <= P.depth; ++r) {
      if (!fluid_at(r, 0)) continue;
      sc_ring_put<C, K>(R, r, F);
      sc_psi_put<C, K>(PS, r, F, true, P);
    }
  } else if (kind == kStageOutlet) {
    // rows 0 ... d + 1 above the trigger (row 0)
    const RingAt<C> R = M.ring<C>(c.ring(0), c), PS = M.ring<C>(c.ring(1), c);
    const int d = P.depth;
    C F[K][9];
    if (P.outlet == 1) {
      sc_ring_get<C, K>(R, d, F);
      if (fluid_at(d, 0)) {
#pragma unroll
        for (int k = 0; k < K; ++k) outlet_zou_he(F[k], P.outlet_rho[k]);
        sc_ring_put<C, K>(R, d, F);
        sc_psi_put<C, K>(PS, d, F, true, P);
      }
      for (int r = d - 1; r >= 0; --r) {
        if (!fluid_at(r, 0)) continue;
        sc_ring_put<C, K>(R, r, F);
        sc_psi_put<C, K>(PS, r, F, true, P);
      }
    } else {
      for (int r = d + 1; r >= 0; --r) {
        if (!fluid_at(r, 0)) continue;
        sc_ring_get<C, K>(R, r + 1, F);
        sc_ring_put<C, K>(R, r, F);
        sc_psi_put<C, K>(PS, r, F, true, P);
      }
    }
  } else if (kind == kStageCollide) {
    const RingAt<C> ST = M.ring<C>(c.ring(0), c), PS = M.ring<C>(c.ring(1), c);
    const RingAt<C> PO = M.ring<C>(c.ring(2), c);
    C post[K][9];
    if (fluid) {
      C F[K][9];
      sc_ring_get<C, K>(ST, 0, F);
      const bool efs = ORDER != 0;
      sc_collide<C, K, ORDER>(
          F,
          [&](int j, int dx, int dy) {
            return PS.base[(size_t)j * PS.stride + sc_ring_cell(PS, dy, dx)];
          },
          geo[n + k0], geo[2 * n + k0], efs ? geo[3 * n + k0] : C(0),
          efs ? geo[4 * n + k0] : C(0), P, post);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < 9; ++i) post[k][i] = C(0);
    }
    sc_ring_put<C, K>(PO, 0, post);
  } else if (kind == kStageStream) {
    const RingAt<C> PO = M.ring<C>(c.ring(0), c);
    C o[K][9];
    if (fluid) {
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        // pull from the upwind cell x - e_i, or bounce back from a solid one
        const bool up = i == 0 || fluid_at(-ey(i), -ex(i));
        const C* p = PO.base + (up ? PO.cell(-ey(i), 0, -ex(i)) : PO.cell(0, 0, 0));
        const int j = up ? i : opp(i);
#pragma unroll
        for (int k = 0; k < K; ++k) o[k][i] = p[(size_t)(k * 9 + j) * PO.stride];
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < 9; ++i) o[k][i] = C(0);
    }
    if (c.ring(1) < 0) {
      store_state<S, K>(out, n, k0, o);
    } else {
      sc_ring_put<C, K>(M.ring<C>(c.ring(1), c), 0, o);
      sc_psi_put<C, K>(M.ring<C>(c.ring(2), c), 0, o, fluid, P);
    }
  } else if (kind == kStageStore) {
    C F[K][9];
    sc_ring_get<C, K>(M.ring<C>(c.ring(0), c), 0, F);
    store_state<S, K>(out, n, k0, F);
  }
}

// Resident blocks an SM the march kernel asks ptxas for: in float
// arithmetic 3 for up to two fluids and the nearest-neighbour stencils (80
// registers, no spills), else 2 (at 3 the iso-8 / iso-10 and three-fluid
// instances spill); 1 for the f64 check instances (PERF.md, chip_sweep.py
// k8t).
template <typename S, int K, int ORDER>
constexpr int sc_march_min_blocks() {
  if (sizeof(typename Traits<S>::C) == 8) return 1;
  return K <= 2 && ORDER <= 4 ? 3 : 2;
}

template <typename S, int K, int ORDER, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(kMarchThreads, sc_march_min_blocks<S, K, ORDER>())
sc_march_kernel(const S* __restrict__ f, const C* __restrict__ geo, S* __restrict__ out,
                ScParams P, const long long* __restrict__ plan,
                unsigned char* __restrict__ scratch) {
  MarchPlan M{plan, scratch, nullptr, nullptr, nullptr};
  march_run(M, [&](const MarchCell& c) { sc_march_cell<S, K, ORDER>(f, geo, out, P, M, c); });
}

// One launch of K8-T's march for P.k fluids and P.order (T steps on the
// plan `plan` in device memory, its rings in `scratch`).
template <typename S>
int launch_sc_march(int T, const void* f_in, void* f_out, const void* geo_v, void* scratch,
                    const void* plan, const ScParams& P, cudaStream_t st) {
  using C = typename Traits<S>::C;
  if (T < 1 || scratch == nullptr || plan == nullptr) return (int)cudaErrorInvalidValue;
  const S* f = static_cast<const S*>(f_in);
  const C* g = static_cast<const C*>(geo_v);
  S* o = static_cast<S*>(f_out);
  const long long* pl = static_cast<const long long*>(plan);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  ScParams p = P;
  void* args[] = {&f, &g, &o, &p, &pl, &sc};
#define SC_MARCH(KK, OO) \
  if (P.k == KK && P.order == OO) return march_launch(sc_march_kernel<S, KK, OO>, args, st);
#define SC_MARCH_K(KK) SC_MARCH(KK, 0) SC_MARCH(KK, 4) SC_MARCH(KK, 8) SC_MARCH(KK, 10)
  SC_MARCH_K(1) SC_MARCH_K(2) SC_MARCH_K(3)
#undef SC_MARCH_K
#undef SC_MARCH
  return (int)cudaErrorInvalidValue;
}

// The cooperative grid of the instance which = 100 K + order.
template <typename S>
int sc_march_grid_of(int which, int* grid) {
#define SC_GRID(KK, OO) \
  if (which == 100 * KK + OO) return march_grid(sc_march_kernel<S, KK, OO>, grid);
#define SC_GRID_K(KK) SC_GRID(KK, 0) SC_GRID(KK, 4) SC_GRID(KK, 8) SC_GRID(KK, 10)
  SC_GRID_K(1) SC_GRID_K(2) SC_GRID_K(3)
#undef SC_GRID_K
#undef SC_GRID
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The march's C entry points of K8-T for one storage type S.
#define SC2D_MARCH_ENTRY_POINTS(S)                                                          \
  extern "C" int sc2d_march_step(int T, const void* f_in, void* f_out, const void* geo,    \
                                 void* scratch, const void* plan, const ScParams* params,  \
                                 void* stream) {                                           \
    return launch_sc_march<S>(T, f_in, f_out, geo, scratch, plan, *params,                 \
                              static_cast<cudaStream_t>(stream));                          \
  }                                                                                         \
  extern "C" int sc2d_march_grid(int which, int* grid) {                                   \
    return sc_march_grid_of<S>(which, grid);                                                \
  }                                                                                         \
  extern "C" int sc2d_march_limits(long long* out) {                                       \
    out[0] = kMarchMaxStages;                                                               \
    out[1] = kMarchMaxRings;                                                                \
    return 0;                                                                               \
  }                                                                                         \
  extern "C" const char* sc2d_block_error_string(int code) {                               \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                              \
  }
