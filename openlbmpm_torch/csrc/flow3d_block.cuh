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
// collide_single, sc_collide), so T steps of this kernel are T steps of
// K11 / K10; the bf16 state (21 planes a fluid) is decoded to f32 once a
// call and encoded once a call, so T steps of its bf16 instance round once
// where T one-step launches round T times.
//
// K11-T: bricks with windows (block3d.cuh: a halo of T cells on every
// side, in-place swap streaming; shared memory where a brick of 128 cells
// fits, else global scratch).  A sub-step: collide shrunk(s) into the
// opposite slots, swap pass over it.
//
// K10-T: the pipelined z-march of march3d.cuh, on the plan of
// kernels/march3d.py::sc3d_march_plan.  Per level s (the state after s
// steps) three stages, each a run of slabs of one level a wave:
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
// with K = 2 305 / T (f32).  K10-T's rings move about 2 x (2 x 19 + 2) x 4
// B a cell-step more (f32, K = 2), most of it to and from HBM, and the
// grid waits at a barrier once a wave.

#pragma once

#include "flow3d.cuh"
#include "block3d.cuh"
#include "march3d.cuh"

namespace {

// -- K11-T: the brick window ---------------------------------------------------

template <typename S, int MODE, int K, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(kBlock3Threads, 1)
flow3d_block_kernel(const S* __restrict__ f, const unsigned char* __restrict__ fl,
                    S* __restrict__ out, Flow3dParams P, BlockShape3 B,
                    unsigned char* __restrict__ scratch) {
  constexpr int NV = K * Q;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base = B.gmem ? scratch + (size_t)blockIdx.x * B.win_bytes : smem;
  C* W = reinterpret_cast<C*>(base);
  const int wx = B.wx, wy = B.wy;
  const size_t PL = (size_t)wx * wy * B.wz;
  unsigned char* FL = base + align16(PL * NV * sizeof(C));
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const size_t nxy = (size_t)ny * nx;
  const size_t n = (size_t)nz * nxy;
  const int sxy = wx * wy;

  for (int tile = blockIdx.x; tile < B.ntx * B.nty * B.ntz; tile += gridDim.x) {
    const int x0 = (tile % B.ntx) * B.tx, y0 = (tile / B.ntx % B.nty) * B.ty;
    const int z0 = tile / (B.ntx * B.nty) * B.tz;
    const int ox = x0 - B.h, oy = y0 - B.h, oz = z0 - B.h;
    auto gidx = [&](int lx, int ly, int lz) {
      return (size_t)wrap3(oz + lz, nz) * nxy + (size_t)wrap3(oy + ly, ny) * nx +
             wrap3(ox + lx, nx);
    };

    // decode the window once
    for (int c = threadIdx.x; c < (int)PL; c += kBlock3Threads) {
      const size_t k = gidx(c % wx, c / wx % wy, c / sxy);
      FL[c] = fl[k] != 0;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        C F[Q];
        load_fluid<S>(f, n, q, k, F);
#pragma unroll
        for (int i = 0; i < Q; ++i) W[(q * Q + i) * PL + c] = F[i];
      }
    }
    __syncthreads();

    for (int sub = 0; sub < B.T; ++sub) {
      const int e = B.ring * sub;
      // the collision, each population into the opposite slot (0 on solid
      // cells), then the swap pass
      const Box r = shrunk3(B, e);
      for (int t = threadIdx.x; t < r.volume(); t += kBlock3Threads) {
        int lx, ly, lz;
        r.at(t, lx, ly, lz);
        const int c = r.cell(lx, ly, lz);
        C post[K][Q];
        if (FL[c]) {
          C F[K][Q];
#pragma unroll
          for (int q = 0; q < K; ++q)
#pragma unroll
            for (int i = 0; i < Q; ++i) F[q][i] = W[(q * Q + i) * PL + c];
          collide_single<C, MODE>(F[0], P, post[0]);
        } else {
#pragma unroll
          for (int q = 0; q < K; ++q)
#pragma unroll
            for (int i = 0; i < Q; ++i) post[q][i] = C(0);
        }
#pragma unroll
        for (int q = 0; q < K; ++q)
#pragma unroll
          for (int i = 0; i < Q; ++i) W[(q * Q + opp(i)) * PL + c] = post[q][i];
      }
      __syncthreads();
      swap_stream(W, PL, K, FL, r);
      __syncthreads();
    }

    // encode the brick once
    for (int t = threadIdx.x; t < B.tx * B.ty * B.tz; t += kBlock3Threads) {
      const int bx = t % B.tx, by = t / B.tx % B.ty, bz = t / (B.tx * B.ty);
      if (x0 + bx >= nx || y0 + by >= ny || z0 + bz >= nz) continue;
      const int c = ((B.h + bz) * wy + B.h + by) * wx + B.h + bx;
      const size_t k = (size_t)(z0 + bz) * nxy + (size_t)(y0 + by) * nx + x0 + bx;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        C o[Q];
#pragma unroll
        for (int i = 0; i < Q; ++i) o[i] = W[(q * Q + i) * PL + c];
        store_fluid<S>(out, n, q, k, o);
      }
    }
    __syncthreads();
  }
}

// K11-T's tiling: one ring a sub-step, 19 planes.
template <typename S>
BlockShape3 flow3d_block_shape(const Flow3dParams& P, int T) {
  using C = typename Traits<S>::C;
  return block_shape3(P.nz, P.ny, P.nx, T, 1, Q, (int)sizeof(C));
}

template <typename S>
size_t flow3d_block_scratch(const Flow3dParams& P, int T) {
  const BlockShape3 B = flow3d_block_shape<S>(P, T);
  return B.gmem ? (size_t)B.grid * B.win_bytes : 0;
}

template <typename S, int MODE>
int launch_flow3d_block_k(const void* f, void* out, const void* fl, void* scratch,
                          const Flow3dParams& P, const BlockShape3& B, cudaStream_t st) {
  const size_t smem = B.gmem ? 0 : B.win_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(flow3d_block_kernel<S, MODE, 1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  flow3d_block_kernel<S, MODE, 1><<<B.grid, kBlock3Threads, smem, st>>>(
      static_cast<const S*>(f), static_cast<const unsigned char*>(fl), static_cast<S*>(out),
      P, B, static_cast<unsigned char*>(scratch));
  return (int)cudaGetLastError();
}

// K11-T: T steps a launch of the single-phase state (P.collision SRT or
// TRT); refuses T outside 1 ... kMaxSteps3.
template <typename S>
int launch_flow3d_block(const void* f, void* out, const void* fl, void* scratch,
                        const Flow3dParams& P, int T, cudaStream_t st) {
  if (T < 1 || T > kMaxSteps3) return (int)cudaErrorInvalidValue;
  const BlockShape3 B = flow3d_block_shape<S>(P, T);
  if (B.gmem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  switch (P.collision) {
    case kSingleSRT: return launch_flow3d_block_k<S, kSingleSRT>(f, out, fl, scratch, P, B, st);
    case kSingleTRT: return launch_flow3d_block_k<S, kSingleTRT>(f, out, fl, scratch, P, B, st);
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
  extern "C" int flow3d_block_step(int kind, int T, const void* f_in, void* f_out,         \
                                   const void* fluid, void* scratch,                        \
                                   const Flow3dParams* params, void* stream) {              \
    if (kind != 0) return (int)cudaErrorInvalidValue;                                       \
    return launch_flow3d_block<S>(f_in, f_out, fluid, scratch, *params, T,                  \
                                  static_cast<cudaStream_t>(stream));                       \
  }                                                                                         \
  extern "C" long long flow3d_block_scratch_bytes(int kind, int T,                          \
                                                  const Flow3dParams* params) {             \
    if (kind != 0) return -1;                                                               \
    return (long long)flow3d_block_scratch<S>(*params, T);                                  \
  }                                                                                         \
  extern "C" int flow3d_block_shape(int kind, int T, const Flow3dParams* params,           \
                                    long long* shape) {                                     \
    if (kind != 0) return (int)cudaErrorInvalidValue;                                       \
    const BlockShape3 B = flow3d_block_shape<S>(*params, T);                                \
    const long long v[8] = {B.tx, B.ty, B.tz, B.h, B.gmem, B.grid, (long long)B.win_bytes,  \
                            kMaxSteps3};                                                    \
    for (int i = 0; i < 8; ++i) shape[i] = v[i];                                            \
    return 0;                                                                               \
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
