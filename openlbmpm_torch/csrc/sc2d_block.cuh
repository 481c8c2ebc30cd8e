// The window form of the Shan-Chen T-step step, D2Q9, for NVIDIA Hopper
// (sm_90a): the body of K12c, the local form of K8-T (one shard of a
// y-decomposed domain, the TPU kernel's local_ny build,
// pallas/shanchen.py:670-690, :770-815), which sc2d_local.cuh launches as
// sc_local_kernel.  The single-device K8-T is the row-march of
// sc2d_march.cuh.
//
// Replaces, on a shard, the TPU kernel openlbmpm_tpu/pallas/shanchen.py::
// build_sc_fused_step with steps_per_call = T (call :824): every sub-step
// rewrites the inlet rows of the window by global row (_apply_inlet_window
// :361-401: row ny-1-d and its d ghost rows above), then runs the physics
// (psi_k, zero on solid cells; the collision of sc2d.cuh's sc_collide,
// which the T=1 kernels call too; pull streaming with half-way bounce-back,
// solid cells zeroed), then the outlet rows (_apply_outlet_window :402-440:
// the Zou-He row d and its ghosts, or the convective rows d+1 ... 0 each
// copying the row above), as :723-740.  Deferred masking (_defer_ok
// :170-181) changes no output and is not copied.
//
// The window machinery is block2d.cuh's with its LocalGrid load map: the
// state and the geometry planes are G.py x G.px cells, the bands found by
// global row; reach(ORDER) + 1 rings a sub-step (stream <- collision <- psi
// stencil), margins d rows down (the inlet ghosts) and d + 2 up (the
// convective rows; d for Zou-He).  Window planes: K x 9 populations, then
// K psi planes.

#pragma once

#include "sc2d.cuh"
#include "block2d.cuh"

namespace {

// The body of a launch: one shard's centre of the padded buffers of G
// (block2d.cuh).
template <typename S, int K, int ORDER, typename C = typename Traits<S>::C>
__device__ __forceinline__ void sc_block_body(const S* __restrict__ f, const C* __restrict__ geo,
                                              S* __restrict__ out, const ScParams& P,
                                              const BlockShape& B, const LocalGrid& G,
                                              unsigned char* __restrict__ scratch) {
  constexpr int R = reach(ORDER);
  extern __shared__ __align__(16) unsigned char smem[];
  C* W = window_planes<C>(B, smem, scratch);
  unsigned char* FL = window_fluid(B, smem, scratch, K * 10, (int)sizeof(C));
  const int ny = P.ny;
  // the cells this launch writes (the shard's centre) and the cells of a
  // plane
  const int tnx = G.nx, tny = G.ny;
  const size_t n = (size_t)G.py * G.px;
  const int wx = B.wx, wy = B.wy;
  const size_t PL = (size_t)wx * wy;
  C* PSI = W + (size_t)K * 9 * PL;
  const int d = P.depth;
  const bool efs = ORDER != 0;

  for (int tile = blockIdx.x; tile < B.ntx * B.nty; tile += gridDim.x) {
    const int x0 = (tile % B.ntx) * B.tx, y0 = (tile / B.ntx) * B.ty;
    const int ox = x0 - B.hx, ly0 = y0 - B.hlo;
    // the global row of window row 0
    const int oy = G.row0 + ly0;
    auto gidx = [&](int c) { return local_index(G, ly0 + c / wx, ox + c % wx); };
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
      store_state<S, K>(out, n, (size_t)(G.fy + y) * G.px + G.fx + x, o);
    }
    __syncthreads();
  }
}

// The local kernel.  The body takes the parameter blocks by reference: by
// value, ptxas spilled in the f32 K = 2 iso-8 instance and the kernel took
// 2.5% longer at config 3 (PERF.md §6, K12c).
template <typename S, int K, int ORDER, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(kBlockThreads, 1)
sc_local_kernel(const S* __restrict__ f, const C* __restrict__ geo, S* __restrict__ out,
                ScParams P, BlockShape B, LocalGrid G, unsigned char* __restrict__ scratch) {
  sc_block_body<S, K, ORDER>(f, geo, out, P, B, G, scratch);
}

// The bands' reach: d rows below (the inlet ghosts), d + 2 above (the
// convective rows; d for Zou-He).
__host__ inline int sc_band_lo(const ScParams& P) { return P.inlet != 0 ? P.depth : 0; }
__host__ inline int sc_band_hi(const ScParams& P) {
  return P.outlet == 2 ? P.depth + 2 : (P.outlet == 1 ? P.depth : 0);
}

// The local launch's tiling: the centre's of G, the bands by the global rows.
template <typename S, int K, int ORDER>
BlockShape sc_local_block_shape(const ScParams& P, int T, const LocalGrid& G) {
  using C = typename Traits<S>::C;
  return block_shape(G.ny, G.nx, T, reach(ORDER) + 1, sc_band_lo(P), sc_band_hi(P), K * 10,
                     (int)sizeof(C), P.ny);
}

}  // namespace
