// Temporally blocked single-phase D2Q9 step for NVIDIA Hopper (sm_90a):
// K7-T, T time steps a launch.  Each of single2d_block_f64.cu,
// single2d_block_f32.cu and single2d_block_bf16.cu instantiates one
// storage type.
//
// Replaces the TPU kernel openlbmpm_tpu/pallas/single.py::
// build_single_phase_fused_step with steps_per_call = T > 1 (call :440):
// every sub-step collides (collide, single2d.cuh: SRT, TRT or MRT with the
// Guo body force), pull-streams with half-way bounce-back, zeroes the
// solid cells and then rewrites the boundary rows of the window by global
// row, as _apply_bcs_window (:252-296) does after each sub-step (:366-373):
// the Zou-He inlet on row ny-2 and outlet on row 1, then the ghost copies
// ny-1 <- ny-2 and 0 <- 1, or the convective rows 2 <- 3, 1 <- 2, 0 <- 1.
// Those copies read the current sub-step's rows inside the window, which
// is what the T=1 kernel's second launch (bc_rows) orders.  The bf16 state
// (deviations f_i - w_i rho, rho as a hi/lo pair) is decoded to f32 once a
// call and encoded once a call (single.py:348-353, :374-383).  Deferred
// masking (_defer_ok :125-135) changes no output and is not copied.
//
// The window machinery is block2d.cuh's: one ring a sub-step (stream <-
// collision), margins 1 row down (inlet ghost) and 3 up (convective; 1 for
// the Zou-He outlet).  Nine compute planes a cell.
//
// What bounds it: HBM bytes per cell-step, the state read and written once
// a call: 73/T B (f32), 45/T (bf16), 145/T (f64) with the mask; the halo
// adds (1 + 2T/64)^2 - 1 of the cells at a 64 x 64 tile.

#pragma once

#include "single2d.cuh"
#include "block2d.cuh"

namespace {

// LOCAL: the local form (K12b), one shard's centre of the padded buffers
// of G (block2d.cuh); the state and the fluid mask are G.py x G.px cells.
template <typename S, int COLL, bool FORCE, bool LOCAL = false,
          typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(kBlockThreads, 1)
single_block_kernel(const S* __restrict__ f, const unsigned char* __restrict__ fl,
                    S* __restrict__ out, Single2dParams P, BlockShape B, LocalGrid G,
                    unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  C* W = window_planes<C>(B, smem, scratch);
  unsigned char* FL = window_fluid(B, smem, scratch, 9, (int)sizeof(C));
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
    for (int c = threadIdx.x; c < wx * wy; c += kBlockThreads) {
      size_t k;
      if constexpr (LOCAL) k = local_index(G, ly0 + c / wx, ox + c % wx);
      else k = (size_t)wrap(oy + c / wx, ny) * nx + wrap(ox + c % wx, nx);
      C F[9];
      load_cell<S>(f, n, k, F);
#pragma unroll
      for (int i = 0; i < 9; ++i) W[i * PL + c] = F[i];
      FL[c] = fl[k] != 0;
    }
    __syncthreads();

    for (int sub = 0; sub < B.T; ++sub) {
      // collide in place
      Region r = shrunk(B, B.ring * sub);
      for (int t = threadIdx.x; t < r.area(); t += kBlockThreads) {
        const int c = (r.y0 + t / r.w()) * wx + r.x0 + t % r.w();
        if (!FL[c]) continue;
        C F[9], post[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) F[i] = W[i * PL + c];
        collide<S, COLL, FORCE>(F, P, post);
#pragma unroll
        for (int i = 0; i < 9; ++i) W[i * PL + c] = post[i];
      }
      __syncthreads();
      // stream, then zero the solid cells (stream(...) * fluid)
      r = shrunk(B, B.ring * sub + 1);
      stream_set(W, PL, FL, wx, r);
      for (int t = threadIdx.x; t < r.area(); t += kBlockThreads) {
        const int c = (r.y0 + t / r.w()) * wx + r.x0 + t % r.w();
        if (FL[c]) continue;
#pragma unroll
        for (int i = 0; i < 9; ++i) W[i * PL + c] = C(0);
      }
      __syncthreads();
      // the boundary rows, column by column
      if (P.inlet != 0 || P.outlet != 0) {
        auto copy = [&](int dst, int src) {
#pragma unroll
          for (int i = 0; i < 9; ++i) W[i * PL + dst] = W[i * PL + src];
        };
        auto zou_he = [&](int c, bool inlet) {
          C F[9];
#pragma unroll
          for (int i = 0; i < 9; ++i) F[i] = W[i * PL + c];
          if (inlet) inlet_zou_he(F, P);
          else outlet_zou_he(F, P);
#pragma unroll
          for (int i = 0; i < 9; ++i) W[i * PL + c] = F[i];
        };
        for (int lx = r.x0 + (int)threadIdx.x; lx < r.x1; lx += kBlockThreads) {
          for (int ly = r.y0; ly < r.y1; ++ly) {
            const int c = ly * wx + lx, g = wrap(oy + ly, ny);
            if (!FL[c]) continue;
            if (P.inlet != 0 && g == ny - 2) zou_he(c, true);
            if (P.outlet == 1 && g == 1) zou_he(c, false);
          }
          if (P.inlet != 0) {
            for (int ly = r.y0; ly < r.y1; ++ly) {
              const int c = ly * wx + lx;
              if (ly > 0 && wrap(oy + ly, ny) == ny - 1 && FL[c]) copy(c, c - wx);
            }
          }
          // the outlet's copies: 0 <- 1 (Zou-He), or 2 <- 3, 1 <- 2, 0 <- 1
          for (int row = P.outlet == 2 ? 2 : 0; P.outlet != 0 && row >= 0; --row) {
            for (int ly = r.y0; ly < r.y1; ++ly) {
              const int c = ly * wx + lx;
              if (ly + 1 < wy && wrap(oy + ly, ny) == row && FL[c]) copy(c, c + wx);
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
      C o[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) o[i] = W[i * PL + c];
      store_cell<S>(out, n,
                    LOCAL ? (size_t)(G.fy + y) * G.px + G.fx + x : (size_t)y * nx + x, o);
    }
    __syncthreads();
  }
}

// The launch's tiling: the domain's, or (LOCAL) the centre's of G, the
// bands by the global rows.
template <typename S, bool LOCAL = false>
BlockShape single_block_shape(const Single2dParams& P, int T, const LocalGrid& G = LocalGrid{}) {
  using C = typename Traits<S>::C;
  return block_shape(LOCAL ? G.ny : P.ny, LOCAL ? G.nx : P.nx, T, 1, P.inlet != 0 ? 1 : 0,
                     P.outlet == 2 ? 3 : (P.outlet == 1 ? 1 : 0), 9, (int)sizeof(C), P.ny);
}

// One launch; LOCAL refuses a frame of G that does not cover the reach.
template <typename S, int COLL, bool FORCE, bool LOCAL>
int launch_single_block(const void* f_in, void* f_out, const unsigned char* fl,
                        void* scratch, const Single2dParams& P, int T, cudaStream_t st,
                        const LocalGrid& G) {
  const BlockShape B = single_block_shape<S, LOCAL>(P, T, G);
  if (B.wx * B.wy > kMaxWindow) return (int)cudaErrorInvalidValue;  // T too large
  if (B.gmem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (LOCAL && !frame_covers(G, B)) return (int)cudaErrorInvalidValue;
  const size_t smem = B.gmem ? 0 : B.win_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(single_block_kernel<S, COLL, FORCE, LOCAL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  single_block_kernel<S, COLL, FORCE, LOCAL><<<B.grid, kBlockThreads, smem, st>>>(
      static_cast<const S*>(f_in), fl, static_cast<S*>(f_out), P, B, G,
      static_cast<unsigned char*>(scratch));
  return (int)cudaGetLastError();
}

// T steps (LOCAL: of one shard's padded buffer, into its centre); returns a
// cudaError_t code (0 on success).
template <typename S, bool LOCAL = false>
int single2d_block_dispatch(const void* f_in, void* f_out, const void* fl_v, void* scratch,
                            const Single2dParams& P, int T, cudaStream_t st,
                            const LocalGrid& G = LocalGrid{}) {
  const unsigned char* fl = static_cast<const unsigned char*>(fl_v);
  if (T < 1) return (int)cudaErrorInvalidValue;
  const bool force = P.force != 0;
  switch (P.collision) {
    case kSRT:
      return force ? launch_single_block<S, kSRT, true, LOCAL>(f_in, f_out, fl, scratch, P, T,
                                                               st, G)
                   : launch_single_block<S, kSRT, false, LOCAL>(f_in, f_out, fl, scratch, P,
                                                                T, st, G);
    case kTRT:
      return force ? launch_single_block<S, kTRT, true, LOCAL>(f_in, f_out, fl, scratch, P, T,
                                                               st, G)
                   : launch_single_block<S, kTRT, false, LOCAL>(f_in, f_out, fl, scratch, P,
                                                                T, st, G);
    case kMRT:
      return force ? launch_single_block<S, kMRT, true, LOCAL>(f_in, f_out, fl, scratch, P, T,
                                                               st, G)
                   : launch_single_block<S, kMRT, false, LOCAL>(f_in, f_out, fl, scratch, P,
                                                                T, st, G);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The local launch's tiling (single2d_local libraries).
template <typename S>
BlockShape single_local_shape(const Single2dParams& P, int T, const LocalGrid& G) {
  return single_block_shape<S, true>(P, T, G);
}

}  // namespace
