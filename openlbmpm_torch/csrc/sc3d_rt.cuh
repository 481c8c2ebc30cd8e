// D3Q19 Shan-Chen step (K10) and its T-step form (K10-T) for any number of
// fluids K, looped over at run time: the instance the template kernels of
// flow3d.cuh (K = 1 ... kFlowMaxFluids) and flow3d_block.cuh hand over to
// above kFlowMaxFluids.  sc3d_rt.cu instantiates it for the three storage
// types in one library, built with -fmad=false (kernels/build.py::
// EXTRA_FLAGS), so the f64 instance rounds as the plain path does.
//
// Replaces openlbmpm_tpu/pallas/sc3d.py::build_sc3d_fused_step for K
// fluids (psi = rho), at steps_per_call = 1 and T > 1 alike: the physics of
// flow3d.cuh's K10 from its device functions (sc_sums, momentum,
// sc_collide_fluid).  The per-fluid values (tau, G_ks and the K
// x K matrix G) are read from a device table (kernels/flow3d.py::
// sc3d_table), not from Flow3dParams' fixed arrays; every per-fluid value
// of a cell (its interaction sums) goes through global scratch planes.
//
// A call: the state decoded once into a compute-type buffer (bf16: per
// fluid the deviations plus w_i rho_k), then T steps of three launches,
// one thread per cell:
//   rho       rho_k on fluid cells (K planes), 0 on solid ones;
//   collide   the interaction sums of every fluid (3K planes), the
//             adhesion field, the common velocity, then per fluid the
//             collision (19K planes);
//   stream    pull streaming with half-way bounce-back, 0 on solid cells;
// then encoded once.  So T steps of the bf16 state round once, as K10-T's
// bf16 instance does, and one step as K10's.
//
// What bounds it: HBM bytes, the state in and out (152 K B a cell-step in
// f32).  This simple form moves about 3x the state a step; a window like
// flow3d_block.cuh's with runtime-K planes is later speed work.

#pragma once

#include "flow3d.cuh"

namespace {

// The per-fluid table: tau, G_ks (K values each), then G (K x K,
// row-major).
struct Sc3Table {
  const double* t;
  int k;
  __device__ double tau(int i) const { return t[i]; }
  __device__ double gs(int i) const { return t[k + i]; }
  __device__ double g(int i, int j) const { return t[2 * k + i * k + j]; }
};

__device__ __forceinline__ size_t nb3(const Flow3dParams& P, size_t idx, int i) {
  const size_t nxy = (size_t)P.ny * P.nx;
  const int z = (int)(idx / nxy), y = (int)(idx % nxy / P.nx), x = (int)(idx % P.nx);
  return (size_t)wrap_any(z + ez(i), P.nz) * nxy + (size_t)wrap_any(y + ey(i), P.ny) * P.nx +
         wrap_any(x + ex(i), P.nx);
}

template <typename S, typename C = typename Traits<S>::C>
__global__ void rt3_decode_kernel(const S* __restrict__ f, C* __restrict__ a, int K, size_t n) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  for (int k = 0; k < K; ++k) {
    C F[Q];
    load_fluid<S>(f, n, k, idx, F);
#pragma unroll
    for (int i = 0; i < Q; ++i) a[((size_t)k * Q + i) * n + idx] = F[i];
  }
}

template <typename S, typename C = typename Traits<S>::C>
__global__ void rt3_encode_kernel(const C* __restrict__ a, S* __restrict__ out, int K,
                                  size_t n) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  for (int k = 0; k < K; ++k) {
    C o[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) o[i] = a[((size_t)k * Q + i) * n + idx];
    store_fluid<S>(out, n, k, idx, o);
  }
}

// The three passes below run over the cells [lo, hi) (n cells a plane): the
// whole domain, or a range of slabs of the local form (flow3d_local.cuh).
template <typename C>
__global__ void rt3_rho_kernel(const C* __restrict__ a, const unsigned char* __restrict__ fl,
                               C* __restrict__ rho, int K, size_t n, size_t lo, size_t hi) {
  const size_t idx = lo + (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= hi) return;
  for (int k = 0; k < K; ++k) {
    C F[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) F[i] = a[((size_t)k * Q + i) * n + idx];
    rho[(size_t)k * n + idx] = fl[idx] ? sumq(F) : C(0);
  }
}

// flow3d.cuh::sc_collide with the fluids looped at run time; gs is scratch
// of 3K planes.
template <typename C>
__global__ void rt3_collide_kernel(const C* __restrict__ a, const unsigned char* __restrict__ fl,
                                   const C* __restrict__ rho, C* __restrict__ gs,
                                   C* __restrict__ post, Flow3dParams P, Sc3Table tb, size_t lo,
                                   size_t hi) {
  const int K = tb.k;
  const size_t n = (size_t)P.nz * P.ny * P.nx;
  const size_t idx = lo + (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= hi) return;
  if (!fl[idx]) {
    for (int q = 0; q < K * Q; ++q) post[(size_t)q * n + idx] = C(0);
    return;
  }
  double adh[3];
  for (int j = 0; j < K; ++j) {
    C gr[1][3];
    sc_sums<C, 1>(rho + (size_t)j * n, n, [&](int i) { return nb3(P, idx, i); }, fl, gr, adh);
#pragma unroll
    for (int d = 0; d < 3; ++d) gs[((size_t)3 * j + d) * n + idx] = gr[0][d];
  }
  auto load = [&](int k, C F[Q]) {
#pragma unroll
    for (int i = 0; i < Q; ++i) F[i] = a[((size_t)k * Q + i) * n + idx];
  };
  C den = C(0), num[3] = {C(0), C(0), C(0)};
  for (int k = 0; k < K; ++k) {
    const C it = C(1.0 / tb.tau(k));
    const C r = rho[(size_t)k * n + idx];
    C F[Q], m[3];
    load(k, F);
    momentum(F, m);
    den = k == 0 ? r * it : den + r * it;
#pragma unroll
    for (int d = 0; d < 3; ++d) num[d] = k == 0 ? m[d] * it : num[d] + m[d] * it;
  }
  den = den != C(0) ? den : C(1);
  C up[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) up[d] = num[d] / den;
  for (int k = 0; k < K; ++k) {
    C F[Q], out[Q];
    load(k, F);
    sc_collide_fluid(
        F, rho[(size_t)k * n + idx], up, K, [&](int j) { return tb.g(k, j); },
        [&](int j, int d) { return gs[((size_t)3 * j + d) * n + idx]; }, tb.gs(k), tb.tau(k),
        adh, P.bf, out);
#pragma unroll
    for (int i = 0; i < Q; ++i) post[((size_t)k * Q + i) * n + idx] = out[i];
  }
}

// Pull streaming with half-way bounce-back, 0 on solid cells.
template <typename C>
__global__ void rt3_stream_kernel(const C* __restrict__ post,
                                  const unsigned char* __restrict__ fl, C* __restrict__ b,
                                  Flow3dParams P, int K, size_t lo, size_t hi) {
  const size_t n = (size_t)P.nz * P.ny * P.nx;
  const size_t idx = lo + (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= hi) return;
  const bool fluid = fl[idx] != 0;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    size_t src = i == 0 ? idx : nb3(P, idx, opp(i));
    int j = i;
    if (!fl[src]) {
      src = idx;
      j = opp(i);
    }
    for (int k = 0; k < K; ++k)
      b[((size_t)k * Q + i) * n + idx] = fluid ? post[((size_t)k * Q + j) * n + src] : C(0);
  }
}

// Compute-type planes of the scratch a call needs: two state buffers and
// the post-collision populations (19K each), rho (K), the interaction sums
// (3K).
template <typename S>
size_t sc3d_rt_scratch(const Flow3dParams& P) {
  using C = typename Traits<S>::C;
  return (size_t)P.k * (3 * Q + 4) * (size_t)P.nz * P.ny * P.nx * sizeof(C);
}

// T steps of the Shan-Chen state f_in (P.k >= 1 fluids) into f_out.
template <typename S>
int launch_sc3d_rt(int T, const void* f_in, void* f_out, const void* fl_v, void* scratch,
                   const double* table, const Flow3dParams& P, cudaStream_t st) {
  using C = typename Traits<S>::C;
  const int K = P.k;
  if (T < 1 || K < 1 || scratch == nullptr || table == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)P.nz * P.ny * P.nx;
  const unsigned char* fl = static_cast<const unsigned char*>(fl_v);
  C* a = static_cast<C*>(scratch);
  C* b = a + (size_t)Q * K * n;
  C* post = b + (size_t)Q * K * n;
  C* rho = post + (size_t)Q * K * n;
  C* gs = rho + (size_t)K * n;
  const Sc3Table tb{table, K};
  const unsigned blocks = (unsigned)((n + 255) / 256);
  cudaError_t err;
  rt3_decode_kernel<S><<<blocks, 256, 0, st>>>(static_cast<const S*>(f_in), a, K, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int t = 0; t < T; ++t) {
    rt3_rho_kernel<C><<<blocks, 256, 0, st>>>(a, fl, rho, K, n, 0, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rt3_collide_kernel<C><<<blocks, 256, 0, st>>>(a, fl, rho, gs, post, P, tb, 0, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rt3_stream_kernel<C><<<blocks, 256, 0, st>>>(post, fl, b, P, K, 0, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    C* tmp = a;
    a = b;
    b = tmp;
  }
  rt3_encode_kernel<S><<<blocks, 256, 0, st>>>(a, static_cast<S*>(f_out), K, n);
  return (int)cudaGetLastError();
}

}  // namespace
