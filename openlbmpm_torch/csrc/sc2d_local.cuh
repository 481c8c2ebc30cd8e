// The local form of the Shan-Chen T-step kernel (K12c): one shard of a
// y-decomposed domain, T steps a call, for NVIDIA Hopper (sm_90a), included
// by sc2d_local_f64.cu and sc2d_local_f32.cu.
//
// Replaces the per-shard kernel of openlbmpm_tpu/pallas/shanchen.py::
// build_sc_sharded_step (:850: the local build_sc_fused_step, pallas_call
// :794, under shard_map :893-919): original SC and EFS iso-4/8/10, SRT and
// MRT, psi = rho or Peng-Robinson, the Zou-He inlet and the Zou-He /
// convective outlet rows by global row (the TPU kernel's scalar-prefetched
// row offset, :670-690, :709-716), any number of fluids, steps_per_call
// T >= 1, f32 / f64 state (bf16 refused, as there :122-123).
//
// A shard's state lives in a padded buffer (openlbmpm_torch/parallel/
// mesh.py): its centre, then a frame of rows below and above that the
// exchange fills once a call, x whole and wrapping.  The frame is the
// window's reach (block2d.cuh::block_shape): (reach + 1) T rows, plus d rows
// below for the inlet ghosts and d + 2 above for the convective rows (d
// for the Zou-He outlet), once for each copy of a band the frame can meet.
//
// K = 1 ... 3: one launch of sc2d_block.cuh's sc_local_kernel, the window
// form of K8-T's step over tiles of the shard's centre, loaded from the
// padded buffer without wrapping in y (the single-device K8-T is the
// row-march of sc2d_march.cuh).
//
// K > 3: sc2d_rt.cuh's passes in a local form, T one-step passes over row
// ranges of the buffer that shrink by reach + 1 a sub-step: sub-step s
// computes psi over rows [e, py - e), e = (reach + 1) s, the collision
// over [e + reach, py - e - reach), streaming and the outlet rows over
// [e + reach + 1, py - e - reach - 1), ping-ponging between the output and
// a second buffer, so that the last sub-step writes the output (the input
// is only read).  Each loaded cell takes the inlet rows by global row (as
// sc2d_rt.cuh's rt_load); one thread a column rewrites the outlet rows in
// K8-T's order (the Zou-He row d, then its ghosts; the convective rows
// d+1 ... 0 descending, each copying the row above).  A band row whose
// source lies outside the current range takes a stale value; the frame's
// band margins keep it outside the reach of the centre, as in the
// window.  The outlet pass runs only on a shard whose range holds an
// outlet row.
//
// What bounds it: HBM bytes.  K <= 3: the state's bytes on the shard (144/T B a
// cell-step, K = 2, f32) plus its frame's.  K > 3: per sub-step over its
// range the state read twice and written once, psi, the interaction sums,
// the forces and the post-collision populations written and read
// (sc2d_rt.cuh's simple form, about 3x the state).

#pragma once

#include "sc2d_block.cuh"
#include "sc2d_rt.cuh"

namespace {

// -- K = 1 ... 3: the window on the shard -----------------------------------

// One launch; refuses a frame of G that does not cover the window's reach.
template <typename S, int K, int ORDER>
int launch_sc_local(const void* f_in, void* f_out, const void* geo_v, void* scratch,
                    const ScParams& P, int T, cudaStream_t st, const LocalGrid& G) {
  using C = typename Traits<S>::C;
  const BlockShape B = sc_local_block_shape<S, K, ORDER>(P, T, G);
  if (B.wx * B.wy > kMaxWindow) return (int)cudaErrorInvalidValue;  // T too large
  if (B.gmem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (!frame_covers(G, B)) return (int)cudaErrorInvalidValue;
  const size_t smem = B.gmem ? 0 : B.win_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(sc_local_kernel<S, K, ORDER>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sc_local_kernel<S, K, ORDER><<<B.grid, kBlockThreads, smem, st>>>(
      static_cast<const S*>(f_in), static_cast<const C*>(geo_v), static_cast<S*>(f_out), P,
      B, G, static_cast<unsigned char*>(scratch));
  return (int)cudaGetLastError();
}

// The local launch's tiling for P.k fluids and P.order; grid 0 for one the
// template has no instance of (above kScMaxFluids).
template <typename S>
BlockShape sc_local_shape_of(const ScParams& P, int T, const LocalGrid& G) {
#define SC_SHAPE(KK, OO) \
  if (P.k == KK && P.order == OO) return sc_local_block_shape<S, KK, OO>(P, T, G);
#define SC_SHAPE_K(KK) SC_SHAPE(KK, 0) SC_SHAPE(KK, 4) SC_SHAPE(KK, 8) SC_SHAPE(KK, 10)
  SC_SHAPE_K(1) SC_SHAPE_K(2) SC_SHAPE_K(3)
#undef SC_SHAPE_K
#undef SC_SHAPE
  return BlockShape{};
}

// T steps of one shard's padded buffer into its centre, P.k = 1 ... 3;
// returns a cudaError_t code (0 on success).
template <typename S>
int sc2d_local_dispatch(const void* f_in, void* f_out, const void* geo, void* scratch,
                        const ScParams& P, int T, cudaStream_t st, const LocalGrid& G) {
  if (T < 1) return (int)cudaErrorInvalidValue;
#define SC_LAUNCH(KK, OO)         \
  if (P.k == KK && P.order == OO) \
    return launch_sc_local<S, KK, OO>(f_in, f_out, geo, scratch, P, T, st, G);
#define SC_LAUNCH_K(KK) SC_LAUNCH(KK, 0) SC_LAUNCH(KK, 4) SC_LAUNCH(KK, 8) SC_LAUNCH(KK, 10)
  SC_LAUNCH_K(1) SC_LAUNCH_K(2) SC_LAUNCH_K(3)
#undef SC_LAUNCH_K
#undef SC_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// -- K > 3: the runtime-K passes over shrinking row ranges ------------------

// The global row of buffer row ly of the shard G, in a domain of ny rows.
__host__ __device__ __forceinline__ int global_row(const LocalGrid& G, int ly, int ny) {
  const int g = (G.row0 - G.fy + ly) % ny;
  return g < 0 ? g + ny : g;
}

// Fluid k's populations at column x, buffer row ly of the state a, after
// the inlet rows (sc2d_rt.cuh::rt_load on the buffer): a fluid ghost row
// above the inlet row reads that row where the buffer holds it.
template <typename C>
__device__ __forceinline__ void rtl_load(const C* __restrict__ a, const C* __restrict__ geo,
                                         const ScParams& P, const ScTable& tb,
                                         const LocalGrid& G, int k, int x, int ly, C f[9]) {
  const size_t n = (size_t)G.py * G.px;
  const int row = P.ny - 1 - P.depth;
  int src = ly;
  bool on_row = false;
  if (P.inlet != 0) {
    const int g = global_row(G, ly, P.ny);
    on_row = g == row;
    if (g > row && ly - (g - row) >= 0 && geo[(size_t)ly * G.px + x] > C(0.5)) {
      src = ly - (g - row);
      on_row = true;
    }
  }
  const size_t idx = (size_t)src * G.px + x;
#pragma unroll
  for (int i = 0; i < 9; ++i) f[i] = a[((size_t)k * 9 + i) * n + idx];
  if (on_row && geo[idx] > C(0.5)) inlet_zou_he(f, P.inlet, tb.inlet_v(k), tb.inlet_rho(k));
}

// psi_k over buffer rows [y0, y1), 0 on solid cells.
template <typename C>
__global__ void rtl_psi_kernel(const C* __restrict__ a, const C* __restrict__ geo,
                               C* __restrict__ psi, ScParams P, ScTable tb, LocalGrid G,
                               int y0, int y1) {
  const size_t n = (size_t)G.py * G.px;
  const size_t idx = (size_t)y0 * G.px + (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)y1 * G.px) return;
  const bool fluid = geo[idx] > C(0.5);
  for (int k = 0; k < tb.k; ++k) {
    C v = C(0);
    if (fluid) {
      C F[9];
      rtl_load(a, geo, P, tb, G, k, (int)(idx % G.px), (int)(idx / G.px), F);
      v = psi_of(sum9(F), P);
    }
    psi[(size_t)k * n + idx] = v;
  }
}

// The collision of every fluid over buffer rows [y0, y1)
// (sc2d_rt.cuh::rt_collide_cell on the buffer), 0 on the solid cells.
template <typename C, int ORDER>
__global__ void rtl_collide_kernel(const C* __restrict__ a, const C* __restrict__ geo,
                                   const C* __restrict__ psi, C* __restrict__ vs,
                                   C* __restrict__ fs, C* __restrict__ post, ScParams P,
                                   ScTable tb, LocalGrid G, int y0, int y1) {
  const int px = G.px;
  const size_t n = (size_t)G.py * px;
  const size_t idx = (size_t)y0 * px + (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)y1 * px) return;
  if (!(geo[idx] > C(0.5))) {
    for (int q = 0; q < tb.k * 9; ++q) post[(size_t)q * n + idx] = C(0);
    return;
  }
  const int x = (int)(idx % px), y = (int)(idx / px);
  rt_collide_cell<C, ORDER>(
      [&](int k, C F[9]) { rtl_load(a, geo, P, tb, G, k, x, y, F); },
      [&](int j, int dx, int dy) {
        return psi[(size_t)j * n + (size_t)(y + dy) * px + wrap(x + dx, px)];
      },
      geo, vs, fs, post, n, idx, P, tb);
}

// Pull streaming with half-way bounce-back over buffer rows [y0, y1), 0 on
// solid cells.
template <typename C>
__global__ void rtl_stream_kernel(const C* __restrict__ post, const C* __restrict__ geo,
                                  C* __restrict__ b, int K, LocalGrid G, int y0, int y1) {
  const int px = G.px;
  const size_t n = (size_t)G.py * px;
  const size_t idx = (size_t)y0 * px + (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)y1 * px) return;
  const bool fluid = geo[idx] > C(0.5);
  const int x = (int)(idx % px), y = (int)(idx / px);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    size_t src = (size_t)(y - ey(i)) * px + wrap(x - ex(i), px);
    int j = i;
    if (!(geo[src] > C(0.5))) {
      src = idx;
      j = opp(i);
    }
    for (int k = 0; k < K; ++k)
      b[((size_t)k * 9 + i) * n + idx] = fluid ? post[((size_t)k * 9 + j) * n + src] : C(0);
  }
}

// The outlet rows of one column x among buffer rows [y0, y1), in place, in
// K8-T's order (sc2d_block.cuh): the Zou-He row d, then its ghosts below
// copying it; or the convective rows d+1 ... 0 descending, each copying
// the row above.  A source row outside the buffer leaves its row as it is.
template <typename C>
__global__ void rtl_outlet_kernel(C* __restrict__ b, const C* __restrict__ geo, ScParams P,
                                  ScTable tb, LocalGrid G, int y0, int y1) {
  const int px = G.px, ny = P.ny;
  const size_t n = (size_t)G.py * px;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= px) return;
  const int d = P.depth, K = tb.k;
  auto fluid = [&](int ly) { return geo[(size_t)ly * px + x] > C(0.5); };
  auto copy = [&](int dst, int src) {
    for (int q = 0; q < K * 9; ++q)
      b[(size_t)q * n + (size_t)dst * px + x] = b[(size_t)q * n + (size_t)src * px + x];
  };
  // the first buffer row of [y0, y1) whose global row is g (the others
  // follow every ny rows)
  auto first = [&](int g) { return y0 + wrap(g - global_row(G, y0, ny), ny); };
  if (P.outlet == 1) {
    for (int ly = first(d); ly < y1; ly += ny) {
      if (!fluid(ly)) continue;
      for (int k = 0; k < K; ++k) {
        C o[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) o[i] = b[((size_t)k * 9 + i) * n + (size_t)ly * px + x];
        outlet_zou_he(o, tb.outlet_rho(k));
#pragma unroll
        for (int i = 0; i < 9; ++i) b[((size_t)k * 9 + i) * n + (size_t)ly * px + x] = o[i];
      }
    }
    for (int g = 0; g < d; ++g)
      for (int ly = first(g); ly < y1; ly += ny)
        if (ly + d - g < G.py && fluid(ly)) copy(ly, ly + d - g);
  } else {
    for (int row = d + 1; row >= 0; --row)
      for (int ly = first(row); ly < y1; ly += ny)
        if (ly + 1 < G.py && fluid(ly)) copy(ly, ly + 1);
  }
}

// Compute-type planes of a runtime-K local call's scratch: psi (K), the
// interaction sums and the forces (2K each), the post-collision
// populations (9K).
template <typename S>
size_t sc2d_local_rt_scratch(const ScParams& P, const LocalGrid& G) {
  return (size_t)P.k * 14 * G.py * G.px * sizeof(S);
}

// Whether buffer rows [y0, y1) of G hold a global row of [lo, hi].
__host__ inline bool holds_rows(const LocalGrid& G, int ny, int y0, int y1, int lo, int hi) {
  for (int ly = y0; ly < y1; ++ly) {
    const int g = global_row(G, ly, ny);
    if (g >= lo && g <= hi) return true;
  }
  return false;
}

template <typename C, int ORDER>
int rtl_collide(const C* a, const C* geo, const C* psi, C* vs, C* fs, C* post,
                const ScParams& P, const ScTable& tb, const LocalGrid& G, int y0, int y1,
                cudaStream_t st) {
  const unsigned blocks = (unsigned)(((size_t)(y1 - y0) * G.px + 255) / 256);
  rtl_collide_kernel<C, ORDER><<<blocks, 256, 0, st>>>(a, geo, psi, vs, fs, post, P, tb, G,
                                                       y0, y1);
  return (int)cudaGetLastError();
}

// T steps of one shard's padded buffer f_in (P.k >= 1 fluids, f32 or f64)
// into the centre of f_out; f_tmp a buffer of its shape (read and written
// only when T > 1; may be null at T = 1), scratch
// sc2d_local_rt_scratch bytes, table the per-fluid table
// (kernels/shanchen.py::fluid_table).  Refuses an x frame and a frame that
// does not cover the reach.
template <typename S>
int launch_sc2d_local_rt(int T, const void* f_in, void* f_out, void* f_tmp, const void* geo_v,
                         void* scratch_v, const double* table, const ScParams& P,
                         const LocalGrid& G, cudaStream_t st) {
  using C = S;
  const int K = P.k;
  if (T < 1 || K < 1 || scratch_v == nullptr || table == nullptr ||
      (T > 1 && f_tmp == nullptr))
    return (int)cudaErrorInvalidValue;
  if (P.order != 0 && P.order != 4 && P.order != 8 && P.order != 10)
    return (int)cudaErrorInvalidValue;
  const int R = reach(P.order), ring = R + 1;
  const int hlo = ring * T + band_margin(ring * T, sc_band_lo(P), P.ny);
  const int hhi = ring * T + band_margin(ring * T, sc_band_hi(P), P.ny);
  if (G.fx != 0 || G.px != G.nx || G.nx != P.nx || G.ny < 1 || G.fy < hlo ||
      G.py - G.fy - G.ny < hhi)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)G.py * G.px;
  const C* geo = static_cast<const C*>(geo_v);
  C* psi = static_cast<C*>(scratch_v);
  C* vs = psi + (size_t)K * n;
  C* fs = vs + (size_t)2 * K * n;
  C* post = fs + (size_t)2 * K * n;
  const ScTable tb{table, K};
  auto blocks = [&](int y0, int y1) {
    return (unsigned)(((size_t)(y1 - y0) * G.px + 255) / 256);
  };
  const C* src = static_cast<const C*>(f_in);
  cudaError_t err;
  for (int s = 0; s < T; ++s) {
    C* dst = static_cast<C*>((T - 1 - s) % 2 == 0 ? f_out : f_tmp);
    const int e = ring * s, ys0 = e + R + 1, ys1 = G.py - e - R - 1;
    rtl_psi_kernel<C><<<blocks(e, G.py - e), 256, 0, st>>>(src, geo, psi, P, tb, G, e,
                                                           G.py - e);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int yc0 = e + R, yc1 = G.py - e - R;
    int code = 0;
    switch (P.order) {
      case 0: code = rtl_collide<C, 0>(src, geo, psi, vs, fs, post, P, tb, G, yc0, yc1, st); break;
      case 4: code = rtl_collide<C, 4>(src, geo, psi, vs, fs, post, P, tb, G, yc0, yc1, st); break;
      case 8: code = rtl_collide<C, 8>(src, geo, psi, vs, fs, post, P, tb, G, yc0, yc1, st); break;
      default: code = rtl_collide<C, 10>(src, geo, psi, vs, fs, post, P, tb, G, yc0, yc1, st);
    }
    if (code) return code;
    rtl_stream_kernel<C><<<blocks(ys0, ys1), 256, 0, st>>>(post, geo, dst, K, G, ys0, ys1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (P.outlet != 0 && holds_rows(G, P.ny, ys0, ys1, 0, P.depth + 1)) {
      rtl_outlet_kernel<C><<<(G.px + 127) / 128, 128, 0, st>>>(dst, geo, P, tb, G, ys0, ys1);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    src = dst;
  }
  return 0;
}

}  // namespace
