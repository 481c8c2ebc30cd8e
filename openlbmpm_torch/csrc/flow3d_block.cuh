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
//          fluids, psi = rho, rho_k of each sub-step's input computed in
//          the window.
// The sub-steps run the one-step kernels' device code (flow3d.cuh:
// collide_single, sc_collide), so T steps of this kernel are T steps of
// K11 / K10; the bf16 state (21 planes a fluid) is decoded to f32 once a
// call and encoded once a call, so T steps of its bf16 instance round once
// where T one-step launches round T times.
//
// The window machinery is block3d.cuh's (bricks, in-place swap streaming).
// Window planes (compute type): K x 19 populations, then (K10-T) K planes
// of rho_k, then the fluid bytes.  A sub-step:
//   K11-T  collide shrunk(s) into the opposite slots, swap pass over it;
//   K10-T  rho_k on shrunk(2s), collide shrunk(2s + 1), swap pass over it.
//
// What bounds it: HBM bytes per cell-step are the state read once and
// written once a call, over T: 153 / T B (K11 f32), 85 / T (bf16); K10
// with K = 2 305 / T (f32).  What sets its pace instead is the window:
// with h = T (K11-T) or 2T (K10-T) cells on every side of a brick of
// 128-2048 cells, the window is 2-27x the brick, recomputed every
// sub-step, and at T = 4 (f64 at T >= 2, K10-T with K >= 2) it lives in
// global scratch, so every sub-step reads and writes it through L2.

#pragma once

#include "flow3d.cuh"
#include "block3d.cuh"

namespace {

template <typename S, int MODE, int K, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(kBlock3Threads, 1)
flow3d_block_kernel(const S* __restrict__ f, const unsigned char* __restrict__ fl,
                    S* __restrict__ out, Flow3dParams P, BlockShape3 B,
                    unsigned char* __restrict__ scratch) {
  constexpr int NV = K * Q;
  constexpr int NR = MODE == kShanChen ? K : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base = B.gmem ? scratch + (size_t)blockIdx.x * B.win_bytes : smem;
  C* W = reinterpret_cast<C*>(base);
  const int wx = B.wx, wy = B.wy;
  const size_t PL = (size_t)wx * wy * B.wz;
  C* RHO = W + NV * PL;
  unsigned char* FL = base + align16(PL * (NV + NR) * sizeof(C));
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
      if constexpr (MODE == kShanChen) {
        // rho_k on fluid cells, 0 on solid ones
        Box r = shrunk3(B, e);
        for (int t = threadIdx.x; t < r.volume(); t += kBlock3Threads) {
          int lx, ly, lz;
          r.at(t, lx, ly, lz);
          const int c = r.cell(lx, ly, lz);
#pragma unroll
          for (int q = 0; q < K; ++q) {
            C F[Q];
#pragma unroll
            for (int i = 0; i < Q; ++i) F[i] = W[(q * Q + i) * PL + c];
            RHO[q * PL + c] = FL[c] ? sumq(F) : C(0);
          }
        }
        __syncthreads();
      }
      // the collision, each population into the opposite slot (0 on solid
      // cells), then the swap pass
      const Box r = shrunk3(B, MODE == kShanChen ? e + 1 : e);
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
          if constexpr (MODE == kShanChen) {
            sc_collide<C, K>(
                RHO, PL, (size_t)c,
                [&](int i) { return (size_t)(c + (ez(i) * wy + ey(i)) * wx + ex(i)); }, FL, F,
                P, post);
          } else {
            collide_single<C, MODE>(F[0], P, post[0]);
          }
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

// The launch's tiling: rings 1 (K11-T) or 2 (K10-T), K x 19 planes plus
// K rho planes (K10-T).
template <typename S>
BlockShape3 flow3d_block_shape(int kind, const Flow3dParams& P, int T) {
  using C = typename Traits<S>::C;
  const bool sc = kind == 1;
  const int k = sc ? P.k : 1;
  return block_shape3(P.nz, P.ny, P.nx, T, sc ? 2 : 1, k * Q + (sc ? k : 0), (int)sizeof(C));
}

template <typename S>
size_t flow3d_block_scratch(int kind, const Flow3dParams& P, int T) {
  const BlockShape3 B = flow3d_block_shape<S>(kind, P, T);
  return B.gmem ? (size_t)B.grid * B.win_bytes : 0;
}

template <typename S, int MODE, int K>
int launch_flow3d_block_k(const void* f, void* out, const void* fl, void* scratch,
                          const Flow3dParams& P, const BlockShape3& B, cudaStream_t st) {
  const size_t smem = B.gmem ? 0 : B.win_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(flow3d_block_kernel<S, MODE, K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  flow3d_block_kernel<S, MODE, K><<<B.grid, kBlock3Threads, smem, st>>>(
      static_cast<const S*>(f), static_cast<const unsigned char*>(fl), static_cast<S*>(out),
      P, B, static_cast<unsigned char*>(scratch));
  return (int)cudaGetLastError();
}

// T steps a launch of the single-phase (kind 0, P.collision SRT or TRT) or
// Shan-Chen (kind 1, P.k fluids) state; refuses T outside 1 ... kMaxSteps3.
template <typename S>
int launch_flow3d_block(int kind, const void* f, void* out, const void* fl, void* scratch,
                        const Flow3dParams& P, int T, cudaStream_t st) {
  if (T < 1 || T > kMaxSteps3) return (int)cudaErrorInvalidValue;
  const BlockShape3 B = flow3d_block_shape<S>(kind, P, T);
  if (B.gmem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (kind == 0) {
    switch (P.collision) {
      case kSingleSRT: return launch_flow3d_block_k<S, kSingleSRT, 1>(f, out, fl, scratch, P, B, st);
      case kSingleTRT: return launch_flow3d_block_k<S, kSingleTRT, 1>(f, out, fl, scratch, P, B, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (kind != 1) return (int)cudaErrorInvalidValue;
  switch (P.k) {
    case 1: return launch_flow3d_block_k<S, kShanChen, 1>(f, out, fl, scratch, P, B, st);
    case 2: return launch_flow3d_block_k<S, kShanChen, 2>(f, out, fl, scratch, P, B, st);
    case 3: return launch_flow3d_block_k<S, kShanChen, 3>(f, out, fl, scratch, P, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
