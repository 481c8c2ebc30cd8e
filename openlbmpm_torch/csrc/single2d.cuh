// Single-phase D2Q9 step (K7) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel openlbmpm_tpu/pallas/single.py::
// build_single_phase_fused_step at steps_per_call=1 on one device: rho and
// u = (m + F/2) / rho with the body force F = g rho, SRT, TRT or MRT
// collision with the Guo source, pull streaming with half-way bounce-back,
// masked to the fluid, then the row boundary conditions: the Zou-He
// velocity or pressure inlet on row ny-2 with its ghost copy on ny-1, the
// Zou-He pressure outlet on row 1 with its ghost copy on row 0, or the
// convective outlet (rows 2, 1, 0 each copy the row above, so all take row
// 3).  The state is f (9, ny, nx) in f32 or f64, or (11, ny, nx) bf16: the
// deviations f_i - w_i rho and rho as a hi/lo bf16 pair, decoded to f32
// registers and rounded to nearest-even on the way out.  Each of
// single2d_f64.cu, single2d_f32.cu and single2d_bf16.cu instantiates one
// storage type, so the three libraries build side by side.
//
// The formulas follow the plain path (models/single_phase.py and ops/),
// except MRT, which runs in moment space as the TPU kernel does
// (pallas/single.py:219-242): with d = f - feq + src/2 and m_a = (M d)_a
// for the six relaxing moments, f' = f + src - sum_a M^-1[:, a] s_a m_a,
// M the Lallemand-Luo matrix (orthogonal rows, so M^-1[i][a] = M[a][i] /
// |M_a|^2).  That equals the plain path's f - M^-1 S M (f - feq) +
// M^-1 (I - S/2) M src in exact arithmetic.
//
// One or two launches per step, x fastest (coalesced):
//   1. collide_stream  a 32x8 tile: the collision of the tile plus a
//                      one-cell ring into shared memory (the ring is
//                      recomputed by each neighbouring tile), then pull
//                      streaming from there.  The Zou-He rows need only
//                      their own cell's streamed populations, so the
//                      threads of rows ny-2 and 1 apply them in registers.
//   2. bc_rows         (only with an inlet or outlet) one thread per column
//                      copies the stored cells of the rows another row
//                      copies: ny-2 to ny-1, 1 to 0, or 3 to 2 to 1 to 0
//                      (convective), each where the destination is fluid.
//                      A stored cell is copied as it is, which is what
//                      encoding the copied value gives, so the bf16 state
//                      is rounded once per step.
// Those rows read other rows' post-stream values, which another block may
// own; the second launch orders them after the first.
//
// What bounds it: HBM bytes per cell-step, the state in and out plus the
// one-byte mask: 73 B (f32), 45 B (bf16), 145 B (f64).  The ring re-reads
// (34 x 10 / (32 x 8) = 1.33x) hit L1/L2.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

struct Single2dParams {   // mirrored by kernels/single.py::Single2dParams
  int ny, nx;
  int collision;          // 0 SRT, 1 TRT, 2 MRT
  int force;              // 1 with a body force
  int inlet;              // 0 periodic, 1 zou_he_velocity, 2 zou_he_pressure
  int outlet;             // 0 periodic, 1 zou_he_pressure, 2 convective
  double tau;
  double bfx, bfy;
  double inlet_v, inlet_rho, outlet_rho;
};

namespace {

constexpr int kSRT = 0;
constexpr int kTRT = 1;
constexpr int kMRT = 2;

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int RX = TX + 2;      // tile + one-cell ring
constexpr int RY = TY + 2;
constexpr int RING = RX * RY;

// D2Q9, reference ordering: 0 rest, 1 E, 2 N, 3 W, 4 S, 5 NE, 6 NW, 7 SW, 8 SE
__host__ __device__ constexpr int ex(int i) {
  return (i == 1 || i == 5 || i == 8) - (i == 3 || i == 6 || i == 7);
}
__host__ __device__ constexpr int ey(int i) {
  return (i == 2 || i == 5 || i == 6) - (i == 4 || i == 7 || i == 8);
}
__host__ __device__ constexpr int opp(int i) {
  return i == 0 ? 0 : (i < 5 ? (i + 1) % 4 + 1 : (i - 3) % 4 + 5);
}
__host__ __device__ constexpr double wq(int i) {
  return i == 0 ? 4.0 / 9.0 : (i < 5 ? 1.0 / 9.0 : 1.0 / 36.0);
}
// Lallemand-Luo moment matrix (lattice.py::_d2q9_mrt_matrix) and the
// squared norms of its rows
__host__ __device__ constexpr int mm(int a, int b) {
  constexpr signed char M[9][9] = {
      {1, 1, 1, 1, 1, 1, 1, 1, 1},       {-4, -1, -1, -1, -1, 2, 2, 2, 2},
      {4, -2, -2, -2, -2, 1, 1, 1, 1},   {0, 1, 0, -1, 0, 1, -1, -1, 1},
      {0, -2, 0, 2, 0, 1, -1, -1, 1},    {0, 0, 1, 0, -1, 1, 1, -1, -1},
      {0, 0, -2, 0, 2, 1, 1, -1, -1},    {0, 1, -1, 1, -1, 0, 0, 0, 0},
      {0, 0, 0, 0, 0, 1, -1, 1, -1}};
  return M[a][b];
}
__host__ __device__ constexpr double mnorm(int a) {
  constexpr signed char N[9] = {9, 36, 36, 6, 12, 6, 12, 4, 4};
  return N[a];
}
// ops/collision.py::mrt_relaxation_d2q9_sc: the non-conserved moments
// 1, 2, 4, 6 relax at fixed rates, the shear moments 7, 8 at 1/tau
__host__ __device__ constexpr bool relaxes(int a) {
  return a == 1 || a == 2 || a == 4 || a == 6 || a == 7 || a == 8;
}
__host__ __device__ constexpr double s_fixed(int a) {
  return a == 1 ? 0.6 : a == 2 ? 1.5 : 1.2;
}

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// Storage type S -> compute type C; bf16 storage holds f_i - w_i rho
// (planes 0-8) and rho as hi + lo (planes 9, 10).
template <typename S> struct Traits {
  using C = S;
  static constexpr bool kShifted = false;
};
template <> struct Traits<__nv_bfloat16> {
  using C = float;
  static constexpr bool kShifted = true;
};

__device__ __forceinline__ float to_c(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_c(float v) { return v; }
__device__ __forceinline__ double to_c(double v) { return v; }

template <typename C>
__device__ __forceinline__ C sum9(const C f[9]) {
  C r = f[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) r = r + f[i];
  return r;
}

template <typename S, typename C = typename Traits<S>::C>
__device__ __forceinline__ void load_cell(const S* __restrict__ f, size_t n, size_t idx,
                                          C F[9]) {
  if constexpr (Traits<S>::kShifted) {
    const C rho = to_c(f[9 * n + idx]) + to_c(f[10 * n + idx]);
#pragma unroll
    for (int i = 0; i < 9; ++i) F[i] = to_c(f[i * n + idx]) + C(wq(i)) * rho;
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) F[i] = to_c(f[i * n + idx]);
  }
}

template <typename S, typename C = typename Traits<S>::C>
__device__ __forceinline__ void store_cell(S* __restrict__ out, size_t n, size_t idx,
                                           const C o[9]) {
  if constexpr (Traits<S>::kShifted) {
    const C rho = sum9(o);
#pragma unroll
    for (int i = 0; i < 9; ++i) out[i * n + idx] = __float2bfloat16_rn(o[i] - C(wq(i)) * rho);
    const __nv_bfloat16 hi = __float2bfloat16_rn(rho);
    out[9 * n + idx] = hi;
    out[10 * n + idx] = __float2bfloat16_rn(rho - __bfloat162float(hi));
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) out[i * n + idx] = o[i];
  }
}

// Post-collision populations of one fluid cell (F: its populations) of a
// state stored as S.
template <typename S, int COLL, bool FORCE, typename C = typename Traits<S>::C>
__device__ __forceinline__ void collide(const C F[9], const Single2dParams& P, C post[9]) {
  const C rho = sum9(F);
  const C rs = rho > C(0) ? rho : C(1);
  C mx = C(0), my = C(0);
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    if (ex(i)) mx = mx + C(ex(i)) * F[i];
    if (ey(i)) my = my + C(ey(i)) * F[i];
  }
  C fx = C(0), fy = C(0), ux, uy;
  if constexpr (FORCE) {
    fx = C(P.bfx) * rho;
    fy = C(P.bfy) * rho;
    ux = (mx + C(0.5) * fx) / rs;
    uy = (my + C(0.5) * fy) / rs;
  } else {
    ux = mx / rs;
    uy = my / rs;
  }
  const C uu = ux * ux + uy * uy;
  C feq[9], src[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const C eu = C(ex(i)) * ux + C(ey(i)) * uy;
    feq[i] = C(wq(i)) * rho * (C(1) + C(3) * eu + C(4.5) * eu * eu - C(1.5) * uu);
    // Guo source w_i [3 (e_i - u) + 9 e_i (e_i . u)] . F
    src[i] = FORCE ? C(wq(i)) * ((C(3) * (C(ex(i)) - ux) + C(9) * C(ex(i)) * eu) * fx +
                                 (C(3) * (C(ey(i)) - uy) + C(9) * C(ey(i)) * eu) * fy)
                   : C(0);
  }
  if constexpr (COLL == kSRT) {
    const C tau = C(P.tau);
    const C pf = C(1.0 - 0.5 / P.tau);
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      post[i] = F[i] - (F[i] - feq[i]) / tau;
      if constexpr (FORCE) post[i] = post[i] + pf * src[i];
    }
  } else if constexpr (COLL == kTRT) {
    // symmetric part at omega_+ = 1/tau, antisymmetric at omega_- (magic 3/16)
    const double op = 1.0 / P.tau, om = 1.0 / (0.1875 / (P.tau - 0.5) + 0.5);
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const int j = opp(i);
      const C fs = C(0.5) * (F[i] + F[j]), fa = C(0.5) * (F[i] - F[j]);
      const C es = C(0.5) * (feq[i] + feq[j]), ea = C(0.5) * (feq[i] - feq[j]);
      post[i] = F[i] - C(op) * (fs - es) - C(om) * (fa - ea);
      if constexpr (FORCE) {
        const C even = C(0.5) * (src[i] + src[j]), odd = C(0.5) * (src[i] - src[j]);
        post[i] = post[i] + (C(1.0 - 0.5 * op) * even + C(1.0 - 0.5 * om) * odd);
      }
    }
  } else {
    C d[9], sm[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) d[i] = FORCE ? F[i] - feq[i] + C(0.5) * src[i] : F[i] - feq[i];
#pragma unroll
    for (int a = 0; a < 9; ++a) {
      if (!relaxes(a)) continue;
      C m = C(0);
#pragma unroll
      for (int b = 0; b < 9; ++b)
        if (mm(a, b) != 0) m = m + C(mm(a, b)) * d[b];
      sm[a] = (a >= 7 ? C(1.0 / P.tau) : C(s_fixed(a))) * m;
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      C c = C(0);
#pragma unroll
      for (int a = 0; a < 9; ++a)
        if (relaxes(a) && mm(a, i) != 0) c = c + C(mm(a, i) / mnorm(a)) * sm[a];
      post[i] = (FORCE ? F[i] + src[i] : F[i]) - c;
    }
  }
}

// Zou-He inlet on a row's cell (ops/boundaries.py::zou_he_velocity_top /
// zou_he_pressure_top): unknowns f4, f7, f8.
template <typename C>
__device__ __forceinline__ void inlet_zou_he(C f[9], const Single2dParams& P) {
  const C known = f[0] + f[1] + f[3] + C(2) * (f[2] + f[5] + f[6]);
  const C d13 = C(0.5) * (f[1] - f[3]);
  if (P.inlet == 1) {
    const C vy = C(P.inlet_v);
    const C rho = known / C(1.0 + P.inlet_v);
    f[4] = f[2] - C(2.0 / 3.0) * rho * vy;
    f[7] = f[5] + d13 - rho * vy / C(6);
    f[8] = f[6] - d13 - rho * vy / C(6);
    return;
  }
  const C rt = C(P.inlet_rho);
  const C rv = rt * (C(-1) + known / rt);
  f[4] = f[2] - C(2.0 / 3.0) * rv;
  f[7] = f[5] + d13 - rv / C(6);
  f[8] = f[6] - d13 - rv / C(6);
}

// Zou-He pressure outlet (zou_he_pressure_bottom): unknowns f2, f5, f6.
template <typename C>
__device__ __forceinline__ void outlet_zou_he(C f[9], const Single2dParams& P) {
  const C rt = C(P.outlet_rho);
  const C rv = rt * (C(1) - (f[0] + f[1] + f[3] + C(2) * (f[4] + f[7] + f[8])) / rt);
  const C d31 = C(0.5) * (f[3] - f[1]);
  f[2] = f[4] + C(2.0 / 3.0) * rv;
  f[5] = f[7] + d31 + rv / C(6);
  f[6] = f[8] - d31 + rv / C(6);
}

template <typename S, int COLL, bool FORCE, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(TX * TY)
collide_stream_kernel(const S* __restrict__ f, const unsigned char* __restrict__ fl,
                      S* __restrict__ out, Single2dParams P) {
  __shared__ C sh_post[9 * RING];
  __shared__ unsigned char sh_fl[RING];
  const int nx = P.nx, ny = P.ny;
  const size_t n = (size_t)ny * nx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;

  for (int t = tid; t < RING; t += TX * TY) {
    const int cx = wrap(x0 - 1 + t % RX, nx), cy = wrap(y0 - 1 + t / RX, ny);
    const size_t idx = (size_t)cy * nx + cx;
    const bool fluid = fl[idx] != 0;
    sh_fl[t] = fluid;
    C post[9];
    if (fluid) {
      C F[9];
      load_cell<S>(f, n, idx, F);
      collide<S, COLL, FORCE>(F, P, post);
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) post[i] = C(0);
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) sh_post[i * RING + t] = post[i];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const int lx = threadIdx.x + 1, ly = threadIdx.y + 1;
  const int at = ly * RX + lx;
  C o[9];
  if (sh_fl[at]) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      // pull from the upwind cell x - e_i, or bounce back from a solid one
      const int src = (ly - ey(i)) * RX + lx - ex(i);
      o[i] = sh_fl[src] ? sh_post[i * RING + src] : sh_post[opp(i) * RING + at];
    }
    if (P.inlet != 0 && y == ny - 2) inlet_zou_he(o, P);
    if (P.outlet == 1 && y == 1) outlet_zou_he(o, P);
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) o[i] = C(0);
  }
  store_cell<S>(out, n, (size_t)y * nx + x, o);
}

// The ghost and convective rows: stored cells copied within each column.
template <typename S>
__global__ void bc_rows_kernel(const unsigned char* __restrict__ fl, S* __restrict__ out,
                               Single2dParams P) {
  constexpr int NP = Traits<S>::kShifted ? 11 : 9;
  const int nx = P.nx, ny = P.ny;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= nx) return;
  const size_t n = (size_t)ny * nx;
  auto copy = [&](int dst, int src) {
    if (!fl[(size_t)dst * nx + x]) return;
#pragma unroll
    for (int p = 0; p < NP; ++p)
      out[p * n + (size_t)dst * nx + x] = out[p * n + (size_t)src * nx + x];
  };
  if (P.inlet != 0) copy(ny - 1, ny - 2);
  if (P.outlet == 1) {
    copy(0, 1);
  } else if (P.outlet == 2) {
    copy(2, 3);
    copy(1, 2);
    copy(0, 1);
  }
}

template <typename S, int COLL, bool FORCE>
int launch_single(const void* f_in, void* f_out, const unsigned char* fl,
                  const Single2dParams& P, cudaStream_t st) {
  const S* f = static_cast<const S*>(f_in);
  S* out = static_cast<S*>(f_out);
  const dim3 grid((P.nx + TX - 1) / TX, (P.ny + TY - 1) / TY);
  collide_stream_kernel<S, COLL, FORCE><<<grid, dim3(TX, TY), 0, st>>>(f, fl, out, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || (P.inlet == 0 && P.outlet == 0)) return (int)err;
  bc_rows_kernel<S><<<(P.nx + 127) / 128, 128, 0, st>>>(fl, out, P);
  return (int)cudaGetLastError();
}

template <typename S, int COLL>
int launch_force(const void* f_in, void* f_out, const unsigned char* fl,
                 const Single2dParams& P, cudaStream_t st) {
  return P.force ? launch_single<S, COLL, true>(f_in, f_out, fl, P, st)
                 : launch_single<S, COLL, false>(f_in, f_out, fl, P, st);
}

// One step; returns a cudaError_t code (0 on success).
template <typename S>
int single2d_dispatch(const void* f_in, void* f_out, const void* fl_v, const Single2dParams& P,
                      cudaStream_t st) {
  const unsigned char* fl = static_cast<const unsigned char*>(fl_v);
  switch (P.collision) {
    case kSRT: return launch_force<S, kSRT>(f_in, f_out, fl, P, st);
    case kTRT: return launch_force<S, kTRT>(f_in, f_out, fl, P, st);
    case kMRT: return launch_force<S, kMRT>(f_in, f_out, fl, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
