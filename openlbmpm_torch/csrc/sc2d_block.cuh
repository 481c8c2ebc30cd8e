// Temporally blocked Shan-Chen multicomponent step, D2Q9, for NVIDIA
// Hopper (sm_90a): K8-T, T time steps a launch.  Each of sc2d_block_f64.cu,
// sc2d_block_f32.cu and sc2d_block_bf16.cu instantiates one storage type
// for K = 1, 2, 3 fluids and the original SC and EFS iso-4/8/10 stencils.
//
// Replaces the TPU kernel openlbmpm_tpu/pallas/shanchen.py::
// build_sc_fused_step with steps_per_call = T > 1 (call :824): every
// sub-step rewrites the inlet rows of the window by global row
// (_apply_inlet_window :361-401: row ny-1-d and its d ghost rows above),
// then runs the physics (psi_k, zero on solid cells; the collision of
// sc2d.cuh's sc_collide, which the T=1 kernel calls too; pull streaming
// with half-way bounce-back, solid cells zeroed), then the outlet rows
// (_apply_outlet_window :402-440: the Zou-He row d and its ghosts, or the
// convective rows d+1 ... 0 each copying the row above), as :723-740.  The
// bf16 state (per fluid the deviations f_i - w_i rho_k, rho_k as a hi/lo
// pair) is decoded to f32 once a call and encoded once a call (:702-707,
// :742-753).  Deferred masking (_defer_ok :170-181) changes no output and
// is not copied.
//
// The window machinery is block2d.cuh's: reach(ORDER) + 1 rings a
// sub-step (stream <- collision <- psi stencil), margins d rows down (the
// inlet ghosts) and d + 2 up (the convective rows; d for Zou-He).  Window
// planes: K x 9 populations, then K psi planes.
//
// What bounds it: HBM bytes per cell-step, the state read and written once
// a call: 144/T B (K = 2, f32), 88/T (bf16) with the geometry; the halo
// recompute and one block a streaming multiprocessor set its pace.
//
// The local form (K12c: one shard of a y-decomposed domain, the TPU
// kernel's local_ny build, pallas/shanchen.py:670-690, :770-815) is the
// same body with block2d.cuh's LocalGrid load map, as the second kernel
// sc_local_kernel; sc2d_local.cuh launches it.

#pragma once

#include "sc2d.cuh"
#include "block2d.cuh"

namespace {

// The body of a launch.  LOCAL: the local form (K12c), one shard's centre
// of the padded buffers of G (block2d.cuh): the state and the geometry
// planes are G.py x G.px cells, the bands found by global row.
template <typename S, int K, int ORDER, bool LOCAL, typename C = typename Traits<S>::C>
__device__ __forceinline__ void sc_block_body(const S* __restrict__ f, const C* __restrict__ geo,
                                              S* __restrict__ out, const ScParams& P,
                                              const BlockShape& B, const LocalGrid& G,
                                              unsigned char* __restrict__ scratch) {
  constexpr int R = reach(ORDER);
  extern __shared__ __align__(16) unsigned char smem[];
  C* W = window_planes<C>(B, smem, scratch);
  unsigned char* FL = window_fluid(B, smem, scratch, K * 10, (int)sizeof(C));
  const int nx = P.nx, ny = P.ny;
  // the cells this launch writes (the domain, or the shard's centre) and
  // the cells of a plane
  const int tnx = LOCAL ? G.nx : nx, tny = LOCAL ? G.ny : ny;
  const size_t n = LOCAL ? (size_t)G.py * G.px : (size_t)ny * nx;
  const int wx = B.wx, wy = B.wy;
  const size_t PL = (size_t)wx * wy;
  C* PSI = W + (size_t)K * 9 * PL;
  const int d = P.depth;
  const bool efs = ORDER != 0;

  for (int tile = blockIdx.x; tile < B.ntx * B.nty; tile += gridDim.x) {
    const int x0 = (tile % B.ntx) * B.tx, y0 = (tile / B.ntx) * B.ty;
    const int ox = x0 - B.hx, ly0 = y0 - B.hlo;
    // the global row of window row 0
    const int oy = LOCAL ? G.row0 + ly0 : ly0;
    auto gidx = [&](int c) {
      if constexpr (LOCAL) return local_index(G, ly0 + c / wx, ox + c % wx);
      else return (size_t)wrap(oy + c / wx, ny) * nx + wrap(ox + c % wx, nx);
    };
    auto get = [&](int c, C F[K][9]) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < 9; ++i) F[k][i] = W[(k * 9 + i) * PL + c];
    };
    auto put = [&](int c, const C F[K][9]) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < 9; ++i) W[(k * 9 + i) * PL + c] = F[k][i];
    };
    auto copy = [&](int dst, int src) {
#pragma unroll
      for (int q = 0; q < K * 9; ++q) W[q * PL + dst] = W[q * PL + src];
    };

    for (int c = threadIdx.x; c < wx * wy; c += kBlockThreads) {
      const size_t k = gidx(c);
      C F[K][9];
      load_raw<S, K>(f, n, k, F);
      put(c, F);
      FL[c] = geo[k] > C(0.5);
    }
    __syncthreads();

    for (int sub = 0; sub < B.T; ++sub) {
      const int e0 = B.ring * sub;
      // inlet rows: row ny-1-d rewritten, the d rows above it copy it
      Region r = shrunk(B, e0);
      if (P.inlet != 0) {
        const int row = ny - 1 - d;
        for (int lx = r.x0 + (int)threadIdx.x; lx < r.x1; lx += kBlockThreads) {
          for (int ly = r.y0; ly < r.y1; ++ly) {
            const int c = ly * wx + lx;
            if (wrap(oy + ly, ny) == row && FL[c]) {
              C F[K][9];
              get(c, F);
              apply_inlet<C, K>(F, P);
              put(c, F);
            }
          }
          for (int ly = r.y0; ly < r.y1; ++ly) {
            const int c = ly * wx + lx, up = wrap(oy + ly, ny) - row;
            if (up > 0 && ly - up >= 0 && FL[c]) copy(c, c - up * wx);
          }
        }
        __syncthreads();
      }
      // psi_k, zero on solid cells
      for (int t = threadIdx.x; t < r.area(); t += kBlockThreads) {
        const int c = (r.y0 + t / r.w()) * wx + r.x0 + t % r.w();
#pragma unroll
        for (int k = 0; k < K; ++k) {
          C rho = C(0);
          if (FL[c]) {
            C Fk[9];
#pragma unroll
            for (int i = 0; i < 9; ++i) Fk[i] = W[(k * 9 + i) * PL + c];
            rho = psi_of(sum9(Fk), P);
          }
          PSI[k * PL + c] = rho;
        }
      }
      __syncthreads();
      // the collision in place
      r = shrunk(B, e0 + R);
      for (int t = threadIdx.x; t < r.area(); t += kBlockThreads) {
        const int c = (r.y0 + t / r.w()) * wx + r.x0 + t % r.w();
        if (!FL[c]) continue;
        const size_t k = gidx(c);
        C F[K][9], post[K][9];
        get(c, F);
        sc_collide<C, K, ORDER>(
            F, [&](int j, int dx, int dy) { return PSI[j * PL + c + dy * wx + dx]; },
            geo[n + k], geo[2 * n + k], efs ? geo[3 * n + k] : C(0),
            efs ? geo[4 * n + k] : C(0), P, post);
        put(c, post);
      }
      __syncthreads();
      // stream each fluid, then zero the solid cells
      r = shrunk(B, e0 + R + 1);
#pragma unroll
      for (int k = 0; k < K; ++k) stream_set(W + (size_t)k * 9 * PL, PL, FL, wx, r);
      for (int t = threadIdx.x; t < r.area(); t += kBlockThreads) {
        const int c = (r.y0 + t / r.w()) * wx + r.x0 + t % r.w();
        if (FL[c]) continue;
#pragma unroll
        for (int q = 0; q < K * 9; ++q) W[q * PL + c] = C(0);
      }
      __syncthreads();
      // outlet rows: the Zou-He row d and its ghosts below, or the
      // convective rows d+1 ... 0, each copying the row above
      if (P.outlet != 0) {
        for (int lx = r.x0 + (int)threadIdx.x; lx < r.x1; lx += kBlockThreads) {
          if (P.outlet == 1) {
            for (int ly = r.y0; ly < r.y1; ++ly) {
              const int c = ly * wx + lx;
              if (wrap(oy + ly, ny) == d && FL[c]) {
                C F[K][9];
                get(c, F);
#pragma unroll
                for (int k = 0; k < K; ++k) outlet_zou_he(F[k], P.outlet_rho[k]);
                put(c, F);
              }
            }
            for (int ly = r.y0; ly < r.y1; ++ly) {
              const int c = ly * wx + lx, down = d - wrap(oy + ly, ny);
              if (down > 0 && ly + down < wy && FL[c]) copy(c, c + down * wx);
            }
          } else {
            for (int row = d + 1; row >= 0; --row) {
              for (int ly = r.y0; ly < r.y1; ++ly) {
                const int c = ly * wx + lx;
                if (ly + 1 < wy && wrap(oy + ly, ny) == row && FL[c]) copy(c, c + wx);
              }
            }
          }
        }
        __syncthreads();
      }
    }

    for (int t = threadIdx.x; t < B.tx * B.ty; t += kBlockThreads) {
      const int x = x0 + t % B.tx, y = y0 + t / B.tx;
      if (x >= tnx || y >= tny) continue;
      const int c = (B.hlo + t / B.tx) * wx + B.hx + t % B.tx;
      C o[K][9];
      get(c, o);
      store_state<S, K>(out, n,
                        LOCAL ? (size_t)(G.fy + y) * G.px + G.fx + x : (size_t)y * nx + x, o);
    }
    __syncthreads();
  }
}

// Two kernels of one body, so that the single-device instance keeps its
// signature.  The body takes the parameter blocks by reference: by value,
// ptxas spilled in the f32 K = 2 iso-8 instance and K8-T took 2.5% longer
// at config 3 (PERF.md §6, K12c); by reference both configs stay within 2%
// of the kernel as it was before the local form.
template <typename S, int K, int ORDER, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(kBlockThreads, 1)
sc_block_kernel(const S* __restrict__ f, const C* __restrict__ geo, S* __restrict__ out,
                ScParams P, BlockShape B, unsigned char* __restrict__ scratch) {
  sc_block_body<S, K, ORDER, false>(f, geo, out, P, B, LocalGrid{}, scratch);
}

template <typename S, int K, int ORDER, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(kBlockThreads, 1)
sc_local_kernel(const S* __restrict__ f, const C* __restrict__ geo, S* __restrict__ out,
                ScParams P, BlockShape B, LocalGrid G, unsigned char* __restrict__ scratch) {
  sc_block_body<S, K, ORDER, true>(f, geo, out, P, B, G, scratch);
}

// The bands' reach: d rows below (the inlet ghosts), d + 2 above (the
// convective rows; d for Zou-He).
__host__ inline int sc_band_lo(const ScParams& P) { return P.inlet != 0 ? P.depth : 0; }
__host__ inline int sc_band_hi(const ScParams& P) {
  return P.outlet == 2 ? P.depth + 2 : (P.outlet == 1 ? P.depth : 0);
}

template <typename S, int K, int ORDER>
BlockShape sc_block_shape(const ScParams& P, int T) {
  using C = typename Traits<S>::C;
  return block_shape(P.ny, P.nx, T, reach(ORDER) + 1, sc_band_lo(P), sc_band_hi(P), K * 10,
                     (int)sizeof(C));
}

// The local launch's tiling: the centre's of G, the bands by the global rows.
template <typename S, int K, int ORDER>
BlockShape sc_local_block_shape(const ScParams& P, int T, const LocalGrid& G) {
  using C = typename Traits<S>::C;
  return block_shape(G.ny, G.nx, T, reach(ORDER) + 1, sc_band_lo(P), sc_band_hi(P), K * 10,
                     (int)sizeof(C), P.ny);
}

template <typename S, int K, int ORDER>
int launch_sc_block(const void* f_in, void* f_out, const void* geo_v, void* scratch,
                    const ScParams& P, int T, cudaStream_t st) {
  using C = typename Traits<S>::C;
  const BlockShape B = sc_block_shape<S, K, ORDER>(P, T);
  if (B.wx * B.wy > kMaxWindow) return (int)cudaErrorInvalidValue;  // T too large
  if (B.gmem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = B.gmem ? 0 : B.win_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(sc_block_kernel<S, K, ORDER>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sc_block_kernel<S, K, ORDER><<<B.grid, kBlockThreads, smem, st>>>(
      static_cast<const S*>(f_in), static_cast<const C*>(geo_v), static_cast<S*>(f_out), P,
      B, static_cast<unsigned char*>(scratch));
  return (int)cudaGetLastError();
}

// The tiling for P.k fluids and P.order; grid 0 for one the kernel has no
// instance of.
template <typename S>
BlockShape sc_block_shape_of(const ScParams& P, int T) {
#define SC_SHAPE(KK, OO) \
  if (P.k == KK && P.order == OO) return sc_block_shape<S, KK, OO>(P, T);
#define SC_SHAPE_K(KK) SC_SHAPE(KK, 0) SC_SHAPE(KK, 4) SC_SHAPE(KK, 8) SC_SHAPE(KK, 10)
  SC_SHAPE_K(1) SC_SHAPE_K(2) SC_SHAPE_K(3)
#undef SC_SHAPE_K
#undef SC_SHAPE
  return BlockShape{};
}

// T steps for P.k fluids; returns a cudaError_t code (0 on success).
template <typename S>
int sc2d_block_dispatch(const void* f_in, void* f_out, const void* geo, void* scratch,
                        const ScParams& P, int T, cudaStream_t st) {
  if (T < 1) return (int)cudaErrorInvalidValue;
#define SC_LAUNCH(KK, OO)               \
  if (P.k == KK && P.order == OO)       \
    return launch_sc_block<S, KK, OO>(f_in, f_out, geo, scratch, P, T, st);
#define SC_LAUNCH_K(KK) SC_LAUNCH(KK, 0) SC_LAUNCH(KK, 4) SC_LAUNCH(KK, 8) SC_LAUNCH(KK, 10)
  SC_LAUNCH_K(1) SC_LAUNCH_K(2) SC_LAUNCH_K(3)
#undef SC_LAUNCH_K
#undef SC_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace
