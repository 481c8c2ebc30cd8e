// Shan-Chen multicomponent step (K8) and its T-step form (K8-T), D2Q9, for
// any number of fluids K, looped over at run time: the instance the
// template kernels of sc2d.cuh (K = 1 ... kScMaxFluids) and sc2d_block.cuh
// hand over to above kScMaxFluids.  sc2d_rt.cu instantiates it for the
// three storage types in one library, built with -fmad=false
// (kernels/build.py::EXTRA_FLAGS), so the f64 instance rounds as the plain
// path does.
//
// Replaces openlbmpm_tpu/pallas/shanchen.py::build_sc_fused_step for K
// fluids (the TPU kernel unrolls its K x T sub-step chain for any K), at
// steps_per_call = 1 and T > 1 alike: the same physics as sc2d.cuh, from
// its device functions (inlet_zou_he, psi_of, psi_sums, momentum9,
// sc_force, sc_collide_fluid, outlet_zou_he).  The per-fluid values (tau,
// 1/tau, G_ks, the inlet and outlet targets and the K x K matrix G) are
// read from a device table (kernels/shanchen.py::fluid_table), not from
// ScParams' fixed arrays; every per-fluid value of a cell (its interaction
// sums and force) goes through global scratch planes rather than
// registers.
//
// A call: the state decoded once into a compute-type buffer (bf16: per
// fluid the deviations plus w_i rho_k), then T steps, each four launches,
// one thread per cell or column:
//   psi       inlet rows applied to the loaded cell, psi_k (0 on solid);
//   collide   the interaction sums of every fluid (2K planes), then per
//             fluid rho_k, the momentum and the force (2K planes), the
//             common velocity, then per fluid the collision (K x 9 planes);
//   stream    pull streaming with half-way bounce-back, 0 on solid cells;
//   outlet    (with an outlet) one thread a column rewrites rows 0 ... d+1
//             in place from the streamed rows above, ascending;
// then encoded once.  So T steps of the bf16 state round once, as K8-T's
// bf16 instance does, and one step as K8's.
//
// What bounds it: HBM bytes, the state in and out (36 K B a cell-step in
// f32).  This simple form moves about 3x the state a step (decode, collide
// reading the state twice, post written and read, stream) plus the psi and
// force planes; a window like sc2d_block.cuh's with runtime-K planes is
// later speed work.

#pragma once

#include "sc2d.cuh"

namespace {

// The per-fluid table: tau, 1/tau, G_ks, inlet velocity, inlet density,
// outlet density (K values each), then G (K x K, row-major).
struct ScTable {
  const double* t;
  int k;
  __device__ double tau(int i) const { return t[i]; }
  __device__ double inv_tau(int i) const { return t[k + i]; }
  __device__ double gs(int i) const { return t[2 * k + i]; }
  __device__ double inlet_v(int i) const { return t[3 * k + i]; }
  __device__ double inlet_rho(int i) const { return t[4 * k + i]; }
  __device__ double outlet_rho(int i) const { return t[5 * k + i]; }
  __device__ double g(int i, int j) const { return t[6 * k + i * k + j]; }
};

// Fluid k's populations at (x, y) of the compute-type state a after the
// inlet rows (sc2d.cuh::load_state for one fluid).
template <typename C>
__device__ __forceinline__ void rt_load(const C* __restrict__ a, const C* __restrict__ geo, const ScParams& P,
                        const ScTable& tb, int k, int x, int y, C f[9]) {
  const size_t n = (size_t)P.ny * P.nx;
  const int row = P.ny - 1 - P.depth;
  if (P.inlet != 0 && y > row && geo[(size_t)y * P.nx + x] > C(0.5)) y = row;
  const size_t idx = (size_t)y * P.nx + x;
#pragma unroll
  for (int i = 0; i < 9; ++i) f[i] = a[((size_t)k * 9 + i) * n + idx];
  if (P.inlet != 0 && y == row && geo[(size_t)row * P.nx + x] > C(0.5))
    inlet_zou_he(f, P.inlet, tb.inlet_v(k), tb.inlet_rho(k));
}

template <typename S, typename C = typename Traits<S>::C>
__global__ void rt_decode_kernel(const S* __restrict__ f, C* __restrict__ a, int K, size_t n) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  for (int k = 0; k < K; ++k) {
    C F[1][9];
    load_raw<S, 1>(f + (size_t)k * Traits<S>::kPlanes * n, n, idx, F);
#pragma unroll
    for (int i = 0; i < 9; ++i) a[((size_t)k * 9 + i) * n + idx] = F[0][i];
  }
}

template <typename S, typename C = typename Traits<S>::C>
__global__ void rt_encode_kernel(const C* __restrict__ a, S* __restrict__ out, int K, size_t n) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  for (int k = 0; k < K; ++k) {
    C o[1][9];
#pragma unroll
    for (int i = 0; i < 9; ++i) o[0][i] = a[((size_t)k * 9 + i) * n + idx];
    store_state<S, 1>(out + (size_t)k * Traits<S>::kPlanes * n, n, idx, o);
  }
}

template <typename C>
__global__ void rt_psi_kernel(const C* __restrict__ a, const C* __restrict__ geo,
                              C* __restrict__ psi, ScParams P, ScTable tb) {
  const size_t n = (size_t)P.ny * P.nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const bool fluid = geo[idx] > C(0.5);
  for (int k = 0; k < tb.k; ++k) {
    C v = C(0);
    if (fluid) {
      C F[9];
      rt_load(a, geo, P, tb, k, (int)(idx % P.nx), (int)(idx / P.nx), F);
      v = psi_of(sum9(F), P);
    }
    psi[(size_t)k * n + idx] = v;
  }
}

// The collision of every fluid at the fluid cell idx (sc2d.cuh::sc_collide
// with the fluids looped at run time): load(k, F) gives fluid k's
// populations after the inlet rows, psi_at(j, dx, dy) psi_j at an offset
// from the cell; geo, vs, fs and post are planes of n cells, vs and fs
// scratch of 2K planes each.  rt_collide_kernel and the local form's
// rtl_collide_kernel (sc2d_local.cuh) share it.
template <typename C, int ORDER, typename Load, typename PsiAt>
__device__ __forceinline__ void rt_collide_cell(Load load, PsiAt psi_at,
                                                const C* __restrict__ geo, C* __restrict__ vs,
                                                C* __restrict__ fs, C* __restrict__ post,
                                                size_t n, size_t idx, const ScParams& P,
                                                const ScTable& tb) {
  const int K = tb.k;
  auto v = [&](int j, int d) { return vs[((size_t)2 * j + d) * n + idx]; };
  for (int j = 0; j < K; ++j) {
    C vx, vy;
    psi_sums<C, ORDER>([&](int dx, int dy) { return psi_at(j, dx, dy); }, vx, vy);
    vs[(size_t)2 * j * n + idx] = vx;
    vs[((size_t)2 * j + 1) * n + idx] = vy;
  }
  const bool efs = ORDER != 0;
  const C g1 = geo[n + idx], g2 = geo[2 * n + idx];
  const C g3 = efs ? geo[3 * n + idx] : C(0), g4 = efs ? geo[4 * n + idx] : C(0);
  C den = C(0), numx = C(0), numy = C(0);
  for (int k = 0; k < K; ++k) {
    C F[9], mx, my, fx, fy;
    load(k, F);
    const C rho = sum9(F);
    momentum9(F, mx, my);
    sc_force<C, ORDER>(
        K, [&](int j) { return tb.g(k, j); }, [&](int j, int d) { return v(j, d); },
        [&](int j) { return psi_at(j, 0, 0); }, psi_at(k, 0, 0), tb.gs(k), g1, g2, g3, g4, fx,
        fy);
    if (P.bfx != 0.0 || P.bfy != 0.0) {
      fx = fx + C(P.bfx) * rho;
      fy = fy + C(P.bfy) * rho;
    }
    fs[(size_t)2 * k * n + idx] = fx;
    fs[((size_t)2 * k + 1) * n + idx] = fy;
    const C it = C(tb.inv_tau(k));
    den = den + rho * it;
    if constexpr (ORDER == 0) {
      numx = numx + mx * it;
      numy = numy + my * it;
    } else {
      numx = numx + (mx + C(0.5) * fx) * it;
      numy = numy + (my + C(0.5) * fy) * it;
    }
  }
  den = den != C(0) ? den : C(1);
  const C ux0 = numx / den, uy0 = numy / den;
  for (int k = 0; k < K; ++k) {
    C F[9], out[9];
    load(k, F);
    sc_collide_fluid<C, ORDER>(F, sum9(F), fs[(size_t)2 * k * n + idx],
                               fs[((size_t)2 * k + 1) * n + idx], ux0, uy0, tb.tau(k),
                               tb.inv_tau(k), P.mrt, out);
#pragma unroll
    for (int i = 0; i < 9; ++i) post[((size_t)k * 9 + i) * n + idx] = out[i];
  }
}

// The collision of every fluid at a fluid cell (rt_collide_cell), 0 on the
// solid cells.
template <typename C, int ORDER>
__global__ void rt_collide_kernel(const C* __restrict__ a, const C* __restrict__ geo,
                                  const C* __restrict__ psi, C* __restrict__ vs,
                                  C* __restrict__ fs, C* __restrict__ post, ScParams P,
                                  ScTable tb) {
  const int nx = P.nx, ny = P.ny;
  const size_t n = (size_t)ny * nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  if (!(geo[idx] > C(0.5))) {
    for (int q = 0; q < tb.k * 9; ++q) post[(size_t)q * n + idx] = C(0);
    return;
  }
  const int x = (int)(idx % nx), y = (int)(idx / nx);
  rt_collide_cell<C, ORDER>(
      [&](int k, C F[9]) { rt_load(a, geo, P, tb, k, x, y, F); },
      [&](int j, int dx, int dy) {
        return psi[(size_t)j * n + (size_t)wrap(y + dy, ny) * nx + wrap(x + dx, nx)];
      },
      geo, vs, fs, post, n, idx, P, tb);
}

// Pull streaming with half-way bounce-back, 0 on solid cells.
template <typename C>
__global__ void rt_stream_kernel(const C* __restrict__ post, const C* __restrict__ geo,
                                 C* __restrict__ b, ScParams P, int K) {
  const int nx = P.nx, ny = P.ny;
  const size_t n = (size_t)ny * nx;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const bool fluid = geo[idx] > C(0.5);
  const int x = (int)(idx % nx), y = (int)(idx / nx);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    size_t src = (size_t)wrap(y - ey(i), ny) * nx + wrap(x - ex(i), nx);
    int j = i;
    if (!(geo[src] > C(0.5))) {
      src = idx;
      j = opp(i);
    }
    for (int k = 0; k < K; ++k)
      b[((size_t)k * 9 + i) * n + idx] = fluid ? post[((size_t)k * 9 + j) * n + src] : C(0);
  }
}

// The outlet rows of one column x in place (sc2d.cuh's collide_stream: the
// Zou-He row d and its ghosts below, or the convective rows d+1 ... 0 each
// taking the first row above that is solid or is d+2), ascending, so every
// row reads streamed values not yet rewritten.
template <typename C>
__global__ void rt_outlet_kernel(C* __restrict__ b, const C* __restrict__ geo, ScParams P,
                                 ScTable tb) {
  const int nx = P.nx;
  const size_t n = (size_t)P.ny * nx;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= nx) return;
  const int d = P.depth;
  auto fluid_row = [&](int r) { return geo[(size_t)r * nx + x] > C(0.5); };
  for (int y = 0; y <= d + 1; ++y) {
    if (!fluid_row(y)) continue;
    int src = y;
    if (P.outlet == 2) {
      while (src <= d + 1 && fluid_row(src)) ++src;
    } else if (y <= d) {
      src = d;
    } else {
      continue;
    }
    for (int k = 0; k < tb.k; ++k) {
      C o[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) o[i] = b[((size_t)k * 9 + i) * n + (size_t)src * nx + x];
      if (P.outlet == 1 && fluid_row(d)) outlet_zou_he(o, tb.outlet_rho(k));
#pragma unroll
      for (int i = 0; i < 9; ++i) b[((size_t)k * 9 + i) * n + (size_t)y * nx + x] = o[i];
    }
  }
}

// Compute-type planes of the scratch a call needs: two state buffers and
// the post-collision populations (9K each), psi (K), the interaction sums
// and the forces (2K each).
__host__ inline size_t rt_planes(int K) { return (size_t)K * (27 + 5); }

template <typename S>
size_t sc2d_rt_scratch(const ScParams& P) {
  using C = typename Traits<S>::C;
  return rt_planes(P.k) * (size_t)P.ny * P.nx * sizeof(C);
}

template <typename C, int ORDER>
int rt_collide(const C* a, const C* geo, const C* psi, C* vs, C* fs, C* post, const ScParams& P,
               const ScTable& tb, unsigned blocks, cudaStream_t st) {
  rt_collide_kernel<C, ORDER><<<blocks, 256, 0, st>>>(a, geo, psi, vs, fs, post, P, tb);
  return (int)cudaGetLastError();
}

// T steps of the state f_in (P.k >= 1 fluids) into f_out.
template <typename S>
int launch_sc2d_rt(int T, const void* f_in, void* f_out, const void* geo_v, void* scratch,
                   const double* table, const ScParams& P, cudaStream_t st) {
  using C = typename Traits<S>::C;
  const int K = P.k;
  if (T < 1 || K < 1 || scratch == nullptr || table == nullptr)
    return (int)cudaErrorInvalidValue;
  if (P.order != 0 && P.order != 4 && P.order != 8 && P.order != 10)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)P.ny * P.nx;
  const C* geo = static_cast<const C*>(geo_v);
  C* a = static_cast<C*>(scratch);
  C* b = a + (size_t)9 * K * n;
  C* post = b + (size_t)9 * K * n;
  C* psi = post + (size_t)9 * K * n;
  C* vs = psi + (size_t)K * n;
  C* fs = vs + (size_t)2 * K * n;
  const ScTable tb{table, K};
  const unsigned blocks = (unsigned)((n + 255) / 256);
  cudaError_t err;
  rt_decode_kernel<S><<<blocks, 256, 0, st>>>(static_cast<const S*>(f_in), a, K, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int t = 0; t < T; ++t) {
    rt_psi_kernel<C><<<blocks, 256, 0, st>>>(a, geo, psi, P, tb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    int code = 0;
    switch (P.order) {
      case 0: code = rt_collide<C, 0>(a, geo, psi, vs, fs, post, P, tb, blocks, st); break;
      case 4: code = rt_collide<C, 4>(a, geo, psi, vs, fs, post, P, tb, blocks, st); break;
      case 8: code = rt_collide<C, 8>(a, geo, psi, vs, fs, post, P, tb, blocks, st); break;
      default: code = rt_collide<C, 10>(a, geo, psi, vs, fs, post, P, tb, blocks, st); break;
    }
    if (code) return code;
    rt_stream_kernel<C><<<blocks, 256, 0, st>>>(post, geo, b, P, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (P.outlet != 0) {
      rt_outlet_kernel<C><<<(P.nx + 127) / 128, 128, 0, st>>>(b, geo, P, tb);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    C* tmp = a;
    a = b;
    b = tmp;
  }
  rt_encode_kernel<S><<<blocks, 256, 0, st>>>(a, static_cast<S*>(f_out), K, n);
  return (int)cudaGetLastError();
}

}  // namespace
