// Temporally blocked D3Q19 single-phase (K11-T) and Shan-Chen (K10-T)
// steps for NVIDIA Hopper (sm_90a), T time steps a launch.  Each of
// flow3d_block_f64.cu, flow3d_block_f32.cu and flow3d_block_bf16.cu
// instantiates one storage type.
//
// Replaces the TPU kernels with steps_per_call = T > 1:
//   K11-T  openlbmpm_tpu/pallas/single3d.py::build_single3d_fused_step
//          (one halo slab a sub-step :76, _substep :150, kernel :205): SRT or
//          TRT with the Guo body force;
//   K10-T  openlbmpm_tpu/pallas/sc3d.py::build_sc3d_fused_step (two halo
//          slabs a sub-step :117, _substep :218, kernel :292): K = 1 ... 3
//          fluids, psi = rho, rho_k of each sub-step's input computed from
//          it.
// The sub-steps run the one-step kernels' device code (flow3d.cuh:
// collide_single_each, sc_collide), so T steps of this kernel are T steps of
// K11 / K10; the bf16 state (21 planes a fluid) is decoded to f32 once a
// call and encoded once a call, so T steps of its bf16 instance round once
// where T one-step launches round T times.
//
// Both are the pipelined z-march of march3d.cuh, each stage a run of slabs
// of one level a wave.
//
// K11-T, on the plan of kernels/march3d.py::single3d_march_plan: T + 1
// stages, one ring a level (post_s, 19 planes):
//   collide   (level 0) the input state at the cell (bf16 decoded here):
//             collide_single_each -> post_0;
//   scollide  (levels 1 ... T - 1) post_{s-1} one slab and one row around:
//             pull streaming with half-way bounce-back -> F_s at the cell,
//             collided in the same thread -> post_s;
//   stream    post_{T-1} one slab and row around, pulled into the output
//             (bf16 encoded here: a pull holds the output cell's 19 values).
// The fluid mask is static, so every stage reads it from the global
// one-byte mask and no ring carries it.  A level trails the one before by
// 1 + Z slabs (Z slabs a wave) and its ring holds 2 Z + 2: at 128^3 in f32
// a slab of post is 1.25 MB, so the T = 4 rings take 28.5 MB at Z = 2,
// 47.5 at 4 and 85.5 at 8.  Z = 8 (march3d.py::SLABS_PER_WAVE) was the
// fastest all the same (PERF.md): fewer waves and barriers beat rings that
// stay in the 50 MB L2.
//
// K10-T, on the plan of kernels/march3d.py::sc3d_march_plan.  Per level s
// (the state after s steps) three stages:
//   load     (level 0) rho_0 of the input state (0 on solid cells) and
//            the fluid bytes into their rings;
//   collide  F_s at the slab (level 0: the input, decoded again), rho_s
//            and the fluid bytes one slab and one row around (the
//            interaction stencil and the adhesion field): sc_collide ->
//            post_s (K x 19 values a cell);
//   stream   post_s one slab and row around: pull streaming with half-way
//            bounce-back -> F_{s+1}, rho_{s+1} (the streamed cell's sum), or
//            at the last level the output, encoded once.
// With 8 slabs a wave (the fastest of 1, 2, 4, 8 at 128^3, PERF.md) a
// level trails the one before by 18 slabs and its rings hold 17 (F, from
// level 1 on) and 18 (rho, fluid bytes, post) slabs: 0.30 GB at 128^3 and
// T = 4 in f32 (K = 2), through HBM more than L2.  The domain's periodic z seam is recomputed
// (each level starts 2 (T - s) slabs below slab 0), nothing else in z; the
// plan cuts the plane into y-bands (a halo of 2T rows) only where the
// rings would outgrow their budget of device memory.
//
// What bounds it: HBM bytes per cell-step are the state read once and
// written once a call, over T: 153 / T B (K11 f32), 85 / T (bf16); K10
// with K = 2 305 / T (f32).  The rings move more (K11-T: post written and
// read once a level, 2 x 19 x 4 B a cell-step in f32, in L2 where it
// fits; K10-T about 2 x (2 x 19 + 2) x 4 B a cell-step, f32, K = 2, most
// of it to and from HBM), and the grid waits at a barrier once a wave.
// A launch takes at most kMaxSteps3 steps; the wrappers split a longer call
// (kernels/build.py::split_steps).

#pragma once

#include "flow3d.cuh"
#include "march3d.cuh"

namespace {

constexpr int kMaxSteps3 = 8;   // the largest T a launch takes

// -- K11-T: the z-march ----------------------------------------------------------

// One cell of one stage of K11-T's march (march3d.cuh's MarchCell c):
// rings (kernels/march3d.py::single3d_march_plan) collide post_0;
// scollide post_{s-1}, post_s; stream post_{T-1} (the output in device
// memory).
template <typename S, int MODE, typename C = typename Traits<S>::C>
__device__ __forceinline__ void single3d_march_cell(const S* __restrict__ f,
                                                    const unsigned char* __restrict__ fl,
                                                    S* __restrict__ out, const Flow3dParams& P,
                                                    const MarchPlan& M, const MarchCell& c) {
  const size_t nxy = (size_t)P.ny * P.nx;
  const size_t n = (size_t)P.nz * nxy;
  const size_t gidx = c.gidx(0, 0, 0, nxy);
  const int stage = c.kind();
  const bool fluid = fl[gidx] != 0;
  C v[Q];
  if (stage == kStageCollide) {
    if (fluid) load_fluid<S>(f, n, 0, gidx, v);
  } else {
    // pull from the upwind cell x - e_i, or the cell itself with the
    // opposite slot where that is solid (half-way bounce-back)
    const RingAt<C> PO = M.ring<C>(c.ring(0), c);
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const bool up = fl[c.gidx(-ez(i), -ey(i), -ex(i), nxy)] != 0;
      const int src = up ? PO.cell(-ez(i), -ey(i), -ex(i)) : PO.cell(0, 0, 0);
      v[i] = fluid ? PO.base[(size_t)(up ? i : opp(i)) * PO.stride + src] : C(0);
    }
    if (stage == kStageStream) {
      store_fluid<S>(out, n, 0, gidx, v);
      return;
    }
  }
  const RingAt<C> PN = M.ring<C>(c.ring(stage == kStageCollide ? 0 : 1), c);
  if (fluid) {
    collide_single_each<C, MODE>(v, P, [&](int i, C post) { PN.at(i) = post; });
  } else {
#pragma unroll
    for (int i = 0; i < Q; ++i) PN.at(i) = C(0);
  }
}

// Resident blocks an SM the K11-T march asks ptxas for: 2 in float
// arithmetic (96-106 registers; 3 took 80 and ran T = 4 at 128^3 1.1x
// slower, 4 took 64, spilled, and ran 1.2x slower; PERF.md), 1 for the
// f64 check instances.
template <typename S>
constexpr int single3d_march_min_blocks() {
  return sizeof(typename Traits<S>::C) == 8 ? 1 : 2;
}

template <typename S, int MODE>
__global__ void __launch_bounds__(kMarchThreads, single3d_march_min_blocks<S>())
single3d_march_kernel(const S* __restrict__ f, const unsigned char* __restrict__ fl,
                      S* __restrict__ out, Flow3dParams P, const long long* __restrict__ plan,
                      unsigned char* __restrict__ scratch) {
  MarchPlan M{plan, scratch, nullptr, nullptr, nullptr};
  march_run(M, [&](const MarchCell& c) { single3d_march_cell<S, MODE>(f, fl, out, P, M, c); });
}

template <typename S, int MODE>
int launch_single3d_march_k(const void* f_in, void* f_out, const void* fluid, void* scratch,
                            const void* plan, const Flow3dParams& P, cudaStream_t st) {
  const S* f = static_cast<const S*>(f_in);
  const unsigned char* fl = static_cast<const unsigned char*>(fluid);
  S* out = static_cast<S*>(f_out);
  const long long* pl = static_cast<const long long*>(plan);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  Flow3dParams p = P;
  void* args[] = {&f, &fl, &out, &p, &pl, &sc};
  return march_launch(single3d_march_kernel<S, MODE>, args, st);
}

// K11-T: T (1 ... kMaxSteps3) steps a launch of the single-phase state
// (P.collision SRT or TRT) on the plan `plan` (device memory) with its
// rings in `scratch`.
template <typename S>
int launch_single3d_march(int T, const void* f_in, void* f_out, const void* fluid,
                          void* scratch, const void* plan, const Flow3dParams& P,
                          cudaStream_t st) {
  if (T < 1 || T > kMaxSteps3 || plan == nullptr || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  switch (P.collision) {
    case kSingleSRT:
      return launch_single3d_march_k<S, kSingleSRT>(f_in, f_out, fluid, scratch, plan, P, st);
    case kSingleTRT:
      return launch_single3d_march_k<S, kSingleTRT>(f_in, f_out, fluid, scratch, plan, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename S>
int single3d_march_grid_of(int collision, int* grid) {
  switch (collision) {
    case kSingleSRT: return march_grid(single3d_march_kernel<S, kSingleSRT>, grid);
    case kSingleTRT: return march_grid(single3d_march_kernel<S, kSingleTRT>, grid);
    default: return (int)cudaErrorInvalidValue;
  }
}

// -- K10-T: the z-march ----------------------------------------------------------

// One cell of one stage of K10-T's march (march3d.cuh's MarchCell c):
// rings (kernels/march3d.py::sc3d_march_plan) load -1, rho_0, fl_0;
// collide F_s (-1 at level 0: the input), rho_s, fl_s, post_s; stream
// post_s, then F_{s+1}, rho_{s+1}, fl_{s+1} (-1 at the last level: the
// output).
template <typename S, int K, typename C = typename Traits<S>::C>
__device__ __forceinline__ void sc3d_march_cell(const S* __restrict__ f,
                                                const unsigned char* __restrict__ fl,
                                                S* __restrict__ out, const Flow3dParams& P,
                                                const MarchPlan& M, const MarchCell& c) {
  const size_t nxy = (size_t)P.ny * P.nx;
  const size_t n = (size_t)P.nz * nxy;
  const size_t gidx = c.gidx(0, 0, 0, nxy);
  const int kind = c.kind();
  if (kind == kStageLoad) {
    const RingAt<C> R = M.ring<C>(c.ring(1), c);
    const RingAt<unsigned char> FL = M.ring<unsigned char>(c.ring(2), c);
    const bool fluid = fl[gidx] != 0;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      C v[Q];
      load_fluid<S>(f, n, q, gidx, v);
      R.at(q) = fluid ? sumq(v) : C(0);
    }
    FL.at(0) = fluid;
  } else if (kind == kStageCollide) {
    const RingAt<C> F = M.ring<C>(c.ring(0), c), R = M.ring<C>(c.ring(1), c);
    const RingAt<unsigned char> FL = M.ring<unsigned char>(c.ring(2), c);
    const RingAt<C> PO = M.ring<C>(c.ring(3), c);
    // rho_s and the fluid bytes share their ring's shape, so one index
    // serves both (sc_collide's nb)
    C post[K][Q];
    if (FL.at(0)) {
      C v[K][Q];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        if (c.ring(0) < 0) {
          load_fluid<S>(f, n, q, gidx, v[q]);
        } else {
#pragma unroll
          for (int i = 0; i < Q; ++i) v[q][i] = F.at(q * Q + i);
        }
      }
      sc_collide<C, K>(
          R.base, (size_t)R.stride, (size_t)R.cell(0, 0, 0),
          [&](int i) { return (size_t)R.cell(ez(i), ey(i), ex(i)); }, FL.base, v, P, post);
    } else {
#pragma unroll
      for (int q = 0; q < K; ++q)
#pragma unroll
        for (int i = 0; i < Q; ++i) post[q][i] = C(0);
    }
#pragma unroll
    for (int q = 0; q < K; ++q)
#pragma unroll
      for (int i = 0; i < Q; ++i) PO.at(q * Q + i) = post[q][i];
  } else if (kind == kStageStream) {
    const RingAt<C> PO = M.ring<C>(c.ring(0), c);
    const bool last = c.ring(1) < 0;
    const bool fluid = fl[gidx] != 0;
    // the upwind cell x - e_i of each direction, or the cell itself with
    // the opposite slot where that is solid (half-way bounce-back)
    int src[Q], slot[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const bool up = fl[c.gidx(-ez(i), -ey(i), -ex(i), nxy)] != 0;
      src[i] = up ? PO.cell(-ez(i), -ey(i), -ex(i)) : PO.cell(0, 0, 0);
      slot[i] = up ? i : opp(i);
    }
#pragma unroll
    for (int q = 0; q < K; ++q) {
      C o[Q];
#pragma unroll
      for (int i = 0; i < Q; ++i)
        o[i] = fluid ? PO.base[(size_t)(q * Q + slot[i]) * PO.stride + src[i]] : C(0);
      if (last) {
        store_fluid<S>(out, n, q, gidx, o);
      } else {
        const RingAt<C> F = M.ring<C>(c.ring(1), c), R = M.ring<C>(c.ring(2), c);
#pragma unroll
        for (int i = 0; i < Q; ++i) F.at(q * Q + i) = o[i];
        R.at(q) = fluid ? sumq(o) : C(0);
      }
    }
    if (!last) M.ring<unsigned char>(c.ring(3), c).at(0) = fluid;
  }
}

// Resident blocks an SM the march kernel asks ptxas for: 2 in float
// arithmetic (128 registers; one block an SM, at up to 197, ran K = 2 at
// 128^3 1.5x slower, PERF.md), 1 for the f64 check instances.
template <typename S>
constexpr int sc3d_march_min_blocks() {
  return sizeof(typename Traits<S>::C) == 8 ? 1 : 2;
}

template <typename S, int K>
__global__ void __launch_bounds__(kMarchThreads, sc3d_march_min_blocks<S>())
sc3d_march_kernel(const S* __restrict__ f, const unsigned char* __restrict__ fl,
                  S* __restrict__ out, Flow3dParams P, const long long* __restrict__ plan,
                  unsigned char* __restrict__ scratch) {
  MarchPlan M{plan, scratch, nullptr, nullptr, nullptr};
  march_run(M, [&](const MarchCell& c) { sc3d_march_cell<S, K>(f, fl, out, P, M, c); });
}

template <typename S, int K>
int launch_sc3d_march_k(const void* f_in, void* f_out, const void* fluid, void* scratch,
                        const void* plan, const Flow3dParams& P, cudaStream_t st) {
  const S* f = static_cast<const S*>(f_in);
  const unsigned char* fl = static_cast<const unsigned char*>(fluid);
  S* out = static_cast<S*>(f_out);
  const long long* pl = static_cast<const long long*>(plan);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  Flow3dParams p = P;
  void* args[] = {&f, &fl, &out, &p, &pl, &sc};
  return march_launch(sc3d_march_kernel<S, K>, args, st);
}

// K10-T: T (1 ... kMaxSteps3) steps a launch of the Shan-Chen state of
// P.k <= kFlowMaxFluids fluids on the plan `plan` (device memory) with its
// rings in `scratch`.
template <typename S>
int launch_sc3d_march(int T, const void* f_in, void* f_out, const void* fluid, void* scratch,
                      const void* plan, const Flow3dParams& P, cudaStream_t st) {
  if (T < 1 || T > kMaxSteps3 || plan == nullptr || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  switch (P.k) {
    case 1: return launch_sc3d_march_k<S, 1>(f_in, f_out, fluid, scratch, plan, P, st);
    case 2: return launch_sc3d_march_k<S, 2>(f_in, f_out, fluid, scratch, plan, P, st);
    case 3: return launch_sc3d_march_k<S, 3>(f_in, f_out, fluid, scratch, plan, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename S>
int sc3d_march_grid_of(int k, int* grid) {
  switch (k) {
    case 1: return march_grid(sc3d_march_kernel<S, 1>, grid);
    case 2: return march_grid(sc3d_march_kernel<S, 2>, grid);
    case 3: return march_grid(sc3d_march_kernel<S, 3>, grid);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The C entry points of one storage type S (the library's).
#define FLOW3D_BLOCK_ENTRY_POINTS(S)                                                        \
  extern "C" int single3d_march_step(int T, const void* f_in, void* f_out,                \
                                     const void* fluid, void* scratch, const void* plan,    \
                                     const Flow3dParams* params, void* stream) {            \
    return launch_single3d_march<S>(T, f_in, f_out, fluid, scratch, plan, *params,          \
                                    static_cast<cudaStream_t>(stream));                     \
  }                                                                                         \
  extern "C" int single3d_march_grid(int collision, int* grid) {                            \
    return single3d_march_grid_of<S>(collision, grid);                                      \
  }                                                                                         \
  extern "C" int sc3d_march_step(int T, const void* f_in, void* f_out, const void* fluid,  \
                                 void* scratch, const void* plan,                           \
                                 const Flow3dParams* params, void* stream) {                \
    return launch_sc3d_march<S>(T, f_in, f_out, fluid, scratch, plan, *params,              \
                                static_cast<cudaStream_t>(stream));                         \
  }                                                                                         \
  extern "C" int sc3d_march_grid(int k, int* grid) { return sc3d_march_grid_of<S>(k, grid); } \
  extern "C" int flow3d_block_max_steps(int kind) {                                         \
    return kind == 0 || kind == 1 ? kMaxSteps3 : 0;                                         \
  }                                                                                         \
  extern "C" const char* flow3d_block_error_string(int code) {                              \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                              \
  }
