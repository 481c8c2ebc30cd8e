// Rothman-Keller Perturbation step (Liu et al. 2014), D2Q9, for NVIDIA
// Hopper (sm_90a): K4.
//
// Replaces the TPU kernel openlbmpm_tpu/pallas/csf.py::build_csf_fused_step
// with variant="Perturbation" at steps_per_call=1 (_substep_pert_c
// :1246-1383, _substep_pert :1118-1243) in its three layouts:
//   K4c  compressed (f_total, rho_r), 10 planes, f32 or f64;
//   K4h  compressed, 11 bf16 planes (f32 arithmetic, as K2);
//   K4s  split (f_r, f_b), two (9, ny, nx) arrays, f32 or f64.
// The f64 instances exist so the card can hold the kernel to the plain
// PyTorch path to ~1e-12.  They are a library of their own, pert2d_f64.cu,
// which defines PERT2D_F64 and is built with -fmad=false
// (kernels/build.py::EXTRA_FLAGS), so its products and sums round as the
// plain path's do; this file alone builds the f32 and bf16 instances, which
// keep the FMA contraction.
//
// The state is read through csf2d.cuh's load_state (boundary rows applied
// on the fly, in compute precision, as K1/K6 do), so the rows and the
// CsfParams block are shared with the CSF step.  The formulas follow the
// jnp path (ColorGradientRK._step_pert_c / _step_perturbation and ops/), not
// the TPU kernel's strips and rolls; the compressed equilibrium is the sum
// of the two colours' RK-original equilibria, as the plain path computes
// it (the TPU kernel's lin0/lin_a/lin_d form is equal up to rounding).
//
// One step, one launch: pert_strip_kernel, the strip march of csf2d.cuh's
// K1 with the Perturbation's shorter reach (stream <- gradient <-
// densities; no phi extrapolation, normal or curvature).  A block of
// PERT_THREADS (9 warps) owns a strip of TX = 32 columns and a run of
// RUN_H = 32 rows and steps down it TY = 8 rows at a time, a barrier
// between the stages:
//   d        d = rho_r - rho_b (solid_phi on solid cells) and phi of TY new
//            rows 3 ahead of the output rows, over the strip and a
//            2-column halo (one round of the block's threads), the fluid
//            flags, and each cell's decoded state (boundary rows applied),
//            kept for the collision; phi rides 2 rows ahead of the
//            collided rows so that the Dirichlet-outlet repair of rows 0
//            and 1 reads row 2's phi from the ring;
//   collide  TY rows 1 ahead (a 1-column halo) from the kept state: Grunau
//            tau(phi), RK-original equilibria, SRT or MRT (per colour in
//            the split layout, on the total PDF in the compressed one), the
//            gradient of d from the ring, the perturbation operator and the
//            RK-original recolouring -> post and its red part (18 planes);
//   stream   the pull of the TY output rows: the compressed layout stores
//            the streamed total and rho_r' = the sum of the streamed red
//            parts.
// The split layout (K4s) pushes instead: each cell collided
// once, its red part and post - red written to slot i of x + e_i, or to
// slot opp(i) of x where x + e_i is solid (f_b' = stream(post - red), as
// K6 does), with no post ring.  The rings carry the rows an earlier step
// formed; only the x halo and the rows above each run are formed twice.
// pert2d.cuh's pert_gradient and pert_collide are the cell bodies, shared
// with the T-step march (march2d.cuh::pert_march_kernel).
//
// What bounds it: the least bytes a cell-step are the state read once and
// written once plus a 1-byte mask: 81 B (compressed f32), 45 B (bf16), 145
// B (split f32).  The march reads the state for 1.4x its cells (the
// 2-column halo and 3 rows above and below each run of 32), the re-reads
// mostly from L2, and runs at a seventh to two fifths of the bytes' bound
// (PERF.md): the stages' latency and the warps in flight an SM (4 blocks
// in float) bind it.  The one-tile kernel before it (a 32 x 8 tile, 32 x 4
// in f64) loaded the state twice over 1.69x and 1.33x its cells and
// collided 1.33x of them.

#include "pert2d.cuh"

namespace {

// The rings of a strip (shared memory, compute type C; csf2d.cuh's
// StripRings for the CSF step): rows of TX + 2h cells, row r of the domain
// in slot (r - y0 + 4) mod depth.
//   dp     d = rho_r - rho_b (solid_phi on solid cells) and phi (0 on solid
//          cells), a 2-column halo, 2 rows ahead of the collided rows, so
//          that the Dirichlet-outlet repair of rows 0 and 1 finds row 2's
//          phi in the ring, and with them the cells' state as the d pass
//          decoded it, kept for the collision over its columns (a 1-column
//          halo);
//   post   post and its red part (18 planes) and the fluid flag, a
//          1-column halo, 1 row ahead of the output rows (the pull's
//          reach).
// The split layout pushes and keeps no post ring.
// threads a block: the d pass's TX + 4 columns of TY rows in one round
// (the collision's TX + 2 too); TX * TY of them stream a step's rows
constexpr int PERT_THREADS = (TX + 4) * TY;
template <typename C, int L>
struct PertRings {
  static constexpr bool PUSH = L == kSplit;
  static constexpr int DW = TX + 4, DR = TY + 3;
  static constexpr int QW = PUSH ? 0 : TX + 2, QR = TY + 2;
  static constexpr int SW = TX + 2;
  static constexpr int DN = DR * DW, QN = QR * QW, SN = DR * SW;
  static constexpr size_t bytes =
      sizeof(C) * (2 * (size_t)DN + 18 * QN + cell_planes<L>() * SN) + DN + QN;
};

// resident blocks an SM asked of ptxas (chip_sweep.py 2dcg): 4 in float
// in both layouts (the layout L lets a sweep tell them apart)
template <typename C, int L>
__host__ __device__ constexpr int pert_min_blocks() {
  return sizeof(C) == 8 ? 1 : 4;
}

// One Perturbation step by the strip march: a block of PERT_THREADS threads
// owns TX columns of a run of RUN_H rows and steps down it TY rows at a
// time (d and phi of TY new rows, then the collision of TY new rows, then
// the pull of TY output rows; or, split, the collision of the step's own
// rows pushed to their slots), a barrier between.
template <typename S, int L, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(PERT_THREADS, pert_min_blocks<C, L>())
pert_strip_kernel(const S* __restrict__ s, const S* __restrict__ s2,
                  const C* __restrict__ geo, S* __restrict__ out, S* __restrict__ out2,
                  CsfParams P) {
  using R = PertRings<C, L>;
  extern __shared__ __align__(16) unsigned char strip_smem[];
  C* const dp = reinterpret_cast<C*>(strip_smem);   // d, then phi
  C* const po = dp + 2 * R::DN;                     // post, then red
  C* const sc = po + 18 * R::QN;                    // the kept state
  unsigned char* const df = reinterpret_cast<unsigned char*>(sc + cell_planes<L>() * R::SN);
  unsigned char* const qf = df + R::DN;
  const int nx = P.nx, ny = P.ny;
  const size_t n = (size_t)ny * nx;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * RUN_H;
  const int y1 = min(y0 + RUN_H, ny);
  const int tid = threadIdx.x;
  // the output cell of thread tid < TX * TY in a step's rows
  const int ty = tid / TX, tx = tid % TX;
  auto slot = [&](int r, int depth) { return (r - y0 + 4) % depth; };

  // d, phi and the fluid flag of rows [r0, r1), columns x0 - 2 ... x0 + TX + 1,
  // and the state of columns x0 - 1 ... x0 + TX
  auto form_d = [&](int r0, int r1) {
    for (int t = tid; t < (r1 - r0) * R::DW; t += PERT_THREADS) {
      const int lx = t % R::DW, r = r0 + t / R::DW;
      const int x = wrap(x0 - 2 + lx, nx), y = wrap(r, ny);
      const int b = slot(r, R::DR) * R::DW + lx;
      C d = C(P.solid_phi), phi = C(0);
      const bool fluid = geo[(size_t)y * nx + x] > C(0.5);
      if (fluid) {
        Cell<C, L> c;
        load_state<S, L>(s, s2, geo, P, x, y, c);
        if (lx >= 1 && lx < TX + 3)
          cell_put<C, L>(sc + slot(r, R::DR) * R::SW + lx - 1, R::SN, c);
        C f[9], rr, rb, rho;
        totals(c, f, rr, rb, rho);
        d = rr - rb;
        const C tot = rr + rb;
        phi = tot != C(0) ? (rr - rb) / tot : C(0);
      }
      df[b] = fluid;
      dp[b] = d;
      dp[R::DN + b] = phi;
    }
  };
  // The collision of the fluid cell of row y, unwrapped row r, at dp ring
  // column lx, from the state the d pass kept: post and its red part.
  auto collide = [&](int y, int r, int lx, C post[9], C red[9]) {
    Cell<C, L> c;
    cell_get<C, L>(sc + slot(r, R::DR) * R::SW + lx - 1, R::SN, c);
    // Dirichlet-outlet repair: phi on fluid cells of rows 1 and 0 <- row 2
    const int pr = P.phi_repair && y <= 1 ? r + 2 - y : r;
    const C phi = dp[R::DN + slot(pr, R::DR) * R::DW + lx];
    // the gradient of d from the ring around the cell
    C gx, gy;
    pert_gradient([&](int i) { return dp[slot(r + ey(i), R::DR) * R::DW + lx + ex(i)]; }, P,
                  gx, gy);
    pert_collide(c, phi, gx, gy, P, post, red);
  };

  if constexpr (R::PUSH) {
    // the split layout: each cell of the strip collided once, red_i and
    // post_i - red_i to slot i of x + e_i, or to slot opp(i) of x where
    // x + e_i is solid; a solid cell writes its own zeros
    auto push_rows = [&](int r0) {
      const int r = r0 + ty, x = x0 + tx;
      if (tid >= TX * TY || r >= y1 || x >= nx) return;
      const size_t k = (size_t)r * nx + x;
      const int lx = tx + 2;
      if (!df[slot(r, R::DR) * R::DW + lx]) {
#pragma unroll
        for (int i = 0; i < 9; ++i) out[i * n + k] = out2[i * n + k] = C(0);
        return;
      }
      C post[9], red[9];
      collide(r, r, lx, post, red);
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        size_t kt = k + (size_t)i * n;
        if (i != 0) {
          if (df[slot(r + ey(i), R::DR) * R::DW + lx + ex(i)]) {
            int tx = x + ex(i), ty = r + ey(i);
            tx = tx < 0 ? tx + nx : (tx >= nx ? tx - nx : tx);
            ty = ty < 0 ? ty + ny : (ty >= ny ? ty - ny : ty);
            kt = (size_t)i * n + (size_t)ty * nx + tx;
          } else {
            kt = (size_t)opp(i) * n + k;   // bounced back from the solid x + e_i
          }
        }
        out[kt] = red[i];
        out2[kt] = post[i] - red[i];
      }
    };
    form_d(y0 - 1, y0 + 2);
    for (int a = y0; a < y1; a += TY) {
      const int e = min(a + TY, y1);   // a last step may stop short
      __syncthreads();
      form_d(a + 2, e + 2);
      __syncthreads();
      push_rows(a);
    }
  } else {
    // the post ring of rows [r0, r1), columns x0 - 1 ... x0 + TX (a strip
    // cut short by the domain's edge collides the columns it reads)
    const int qn = min(R::QW, nx - x0 + 2);
    auto form_post = [&](int r0, int r1) {
      for (int t = tid; t < (r1 - r0) * R::QW; t += PERT_THREADS) {
        const int lx = t % R::QW, r = r0 + t / R::QW;
        if (lx >= qn) continue;
        const int b = slot(r, R::QR) * R::QW + lx;
        const bool fluid = df[slot(r, R::DR) * R::DW + lx + 1];
        qf[b] = fluid;
        C post[9], red[9];
        if (fluid) {
          collide(wrap(r, ny), r, lx + 1, post, red);
        } else {
#pragma unroll
          for (int i = 0; i < 9; ++i) post[i] = red[i] = C(0);
        }
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          po[i * R::QN + b] = post[i];
          po[(9 + i) * R::QN + b] = red[i];
        }
      }
    };
    // pull streaming with half-way bounce-back of the output rows
    // [r0, r0 + TY) from the post ring
    auto stream_rows = [&](int r0) {
      const int r = r0 + ty, x = x0 + tx;
      if (tid >= TX * TY || r >= y1 || x >= nx) return;
      const size_t k = (size_t)r * nx + x;
      const int lx = tx + 1;
      auto q = [&](int dy, int dx) { return slot(r + dy, R::QR) * R::QW + lx + dx; };
      C o[9], red[9];
      C rr_new = C(0);
      if (qf[q(0, 0)]) {
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          int src = q(-ey(i), -ex(i)), j = i;
          if (i != 0 && !qf[src]) {
            src = q(0, 0);
            j = opp(i);
          }
          o[i] = po[j * R::QN + src];
          red[i] = po[(9 + j) * R::QN + src];
          rr_new = i == 0 ? red[0] : rr_new + red[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 9; ++i) o[i] = red[i] = C(0);
      }
      store_state<S>(out, n, k, o, rr_new, geo[k]);
    };
    form_d(y0 - 2, y0 + 3);
    __syncthreads();
    form_post(y0 - 1, y0 + 1);
    __syncthreads();
    for (int a = y0; a < y1; a += TY) {
      // the stream of the step before reads the post ring alone; a last
      // step may stop short
      const int e = min(a + TY, y1);
      form_d(a + 3, e + 3);
      __syncthreads();
      form_post(a + 1, e + 1);
      __syncthreads();
      stream_rows(a);
    }
  }
}

template <typename S, int L>
int launch_pert(const void* s_in, const void* s2_in, void* s_out, void* s2_out,
                const void* geo_v, const CsfParams& P, cudaStream_t st) {
  using C = typename Traits<S>::C;
  constexpr size_t smem = PertRings<C, L>::bytes;
  auto kernel = pert_strip_kernel<S, L>;
  static bool opted[64];   // this instance's devices (csf2d.cuh's opt_in_smem)
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in_smem(kernel, smem, opted);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((P.nx + TX - 1) / TX, (P.ny + RUN_H - 1) / RUN_H);
  kernel<<<grid, PERT_THREADS, smem, st>>>(
      static_cast<const S*>(s_in), static_cast<const S*>(s2_in),
      static_cast<const C*>(geo_v), static_cast<S*>(s_out), static_cast<S*>(s2_out), P);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_csf_launches[2];
  return (int)err;
}

}  // namespace

// mode: compressed 0 = f64 state, 1 = f32 state, 2 = bf16 11-plane state;
// split 3 = f64 (f_r, f_b), 4 = f32 (f_r, f_b); modes 0 and 3 with
// PERT2D_F64 defined, the others without it.  s2_in and s2_out are f_b in
// the split modes and unused otherwise; geo is the model's geometry planes
// (plane 0, the fluid mask, is read).  Returns a cudaError_t code (0 on
// success; cudaErrorInvalidValue for a CSF parameter block or a mode this
// library does not hold).
extern "C" int pert2d_step(int mode, const void* s_in, const void* s2_in, void* s_out,
                           void* s2_out, const void* geo, const CsfParams* params,
                           void* stream) {
  const CsfParams P = *params;
  if (P.variant != 1) return (int)cudaErrorInvalidValue;  // a CSF block
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
#ifdef PERT2D_F64
    case 0: return launch_pert<double, kCompressed>(s_in, s2_in, s_out, s2_out, geo, P, st);
    case 3: return launch_pert<double, kSplit>(s_in, s2_in, s_out, s2_out, geo, P, st);
#else
    case 1: return launch_pert<float, kCompressed>(s_in, s2_in, s_out, s2_out, geo, P, st);
    case 2:
      return launch_pert<__nv_bfloat16, kCompressed>(s_in, s2_in, s_out, s2_out, geo, P,
                                                     st);
    case 4: return launch_pert<float, kSplit>(s_in, s2_in, s_out, s2_out, geo, P, st);
#endif
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launches of pert_strip_kernel since the library was loaded (the third
// of csf2d.cuh's g_csf_launches; the others 0 here).
extern "C" void pert2d_kernel_launches(long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = g_csf_launches[i];
}

extern "C" const char* pert2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
