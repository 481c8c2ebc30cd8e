// Device code of the D3Q19 CSF colour-gradient step for NVIDIA Hopper
// (sm_90a), included by cg3d_f64.cu, cg3d_f32.cu and cg3d_bf16.cu (one
// storage type each, so the three build side by side).  Kernels and device
// functions live in an unnamed namespace.
//
// Replaces the TPU kernel openlbmpm_tpu/pallas/cg3d.py::build_cg3d_fused_step
// at steps_per_call=1 in both state layouts, a template parameter L here:
//   kCompressed  state_mode="compressed", storage "f32" (K9c, float or
//                double) and "bf16" (K9h): (f_total, rho_r), 20 planes, or
//                21 bf16 planes (deviations f_i - w_i*fl, rho_r hi/lo);
//   kSplit       state_mode="split" (K9s): f_r and f_b, (19, nz, ny, nx)
//                each, float or double.
// The formulas follow the port's plain path (models/flow3d.py and ops/,
// which follow the jnp ColorGradientRK3D), not the TPU kernel's separable
// stencils, rsqrt and squared-distance tie test, so the double instances
// agree with the plain path to rounding.
//
// One step, two launches (three with an inlet or outlet):
//   0. bc_kernel       (only with an inlet or outlet) one thread per (y, x)
//      column rewrites the boundary slabs as the TPU kernel's jnp prologue
//      does (_bc_prologue_c, _bc_prologue_c_bf16, _bc_prologue_split):
//      NEBB velocity inlet on z = nz-2 and its ghost nz-1; convective
//      copies z = 2, 1, 0, or the NEBB pressure outlet on z = 1 and its
//      ghost 0.  It writes those slabs, in storage type, to a 5-slab
//      scratch that the later kernels read in place of the state's slabs
//      (so a bf16 slab is re-encoded exactly as the prologue re-encodes it).
//   1. fields_kernel   state -> g (3 planes: the isotropic gradient of the
//      extended phase field, Akai-rotated on wetting fluid cells) and kappa
//      (one plane, 0 off fluid): 16 B a cell in f32.  A block owns an
//      (x, y) tile (32 x 16; 32 x 12 in the split layout) and marches a run
//      of z slabs (at most 32; 48 split; shorter where the card would
//      otherwise hold fewer blocks than it can: 32 at 128^3, 9 on a quarter
//      of it) with rings in shared memory: phi and the geometry code over
//      the tile and 3 cells a side (8 slabs), phi extended in place onto
//      the solid cells with a fluid neighbour (geo code < -0.5), the unit
//      inward normals and fluid flags over the tile and 1 cell a side (4
//      slabs).  Four phases, one cell a thread (736 threads, 576 split: one
//      for each cell within 2 of the tile; the outer band goes to the first
//      threads as a second cell): phi of a slab (its state read whatever
//      the cell's code, so that the loads go out together; in the band and
//      on the run's two end slabs only wetting fluid cells, all that an
//      extension reads there, read the state), the extension, g and the
//      normal (the wetting cells' surface normals loaded before the
//      extension runs), kappa.  Between two barriers they run on slabs two
//      apart (phi of h, the extension of h - 2, the normals of h - 4, kappa
//      of h - 6, going up; mirrored going down), so one barrier a slab, and
//      a phase's loads wait while other warps compute.  Runs alternate up
//      and down the column, so that two runs sharing a boundary read its
//      slabs at the same time and the second read hits L2.  The split
//      layout's tile leaves a thread 96 registers, not 80: its phi reads 38
//      values a cell, which spilled at 32 x 16.  Recompute for phi, the
//      costly phase (it reads the state; mostly from L2): (36 x 20) /
//      (32 x 16) = 1.41 in (x, y), (36 x 16) / (32 x 12) = 1.5 split, and
//      (run + 4) / run in z.  At 128^3 f32 on an H100 the kernel takes
//      about 202 us (split 300) against the 231 of the four passes it
//      replaced (PERF.md).  The cell arithmetic is the device functions
//      cell_phase, extrapolated_phi, phi_gradient, rotate_akai,
//      inward_normal and curvature_of, so every value is the one those four
//      passes (phase, extrap, normal, curvature) wrote, bit for bit.
//   2. collide_stream  state, g, kappa -> state'.  A block owns a TX x TY
//      (x, y) tile (32 x 8) and marches a run of ZC = 16 z slabs (up or
//      down, alternating as fields_kernel's runs do), one
//      thread for each cell of the tile and its one-cell (x, y) ring (340
//      of 352 threads).  It collides each slab of the ring tile into a
//      three-slab ring buffer in shared memory (post-collision total PDF,
//      red fraction and the three recolouring amplitudes: 23 values a
//      cell; phi at the cell from the cell's own state, as cell_phase
//      forms it), then the tile's 256 threads pull-stream slab z from slabs
//      z-1, z, z+1; rho_r' is the sum of the streamed red PDFs.
//      Recompute: (34*10)/(32*8) = 1.33 in (x, y), (ZC + 2)/ZC = 1.125 in
//      z: 1.49x the cells collided.  Two blocks an SM in float arithmetic.
//
// The coupled step (K9t: transport=, state_mode="compressed", T=1, the
// TPU step at pallas/cg3d.py:1324-1355) adds D3Q7 tracers g (NT, 7, nz,
// ny, nx), f64 in the f64 library and f32 otherwise (never bf16), to
// collide_stream (collide_stream_tracer_kernel, coupled_stream_body: the
// flow's march as collide_stream_body's, kept as a body of its own so that
// K9's instances compile as they did), so it is the same launches as K9: bc (with an inlet or outlet),
// fields, collide_stream.  compute_slab takes each ring cell as load_cell
// sees it (after the boundary slabs, which the TPU step applies as its jnp
// prologue): beside the flow's collision, the flag bits fluid and rho_r <
// criteria (the epilogue's domain, from the post-slab rho_r; a solid cell
// reads its rho_r alone) and the velocity the flow collides with
// (cell_velocity on the same values: one u for both).  In the next interval,
// beside the flow's pull (the lighter half), tracer_collide applies each
// tracer's SRT J-scheme collision on that u; its four in-plane values (+-x,
// +-y) go to a one-slab ring per tracer, which the tile's threads stream
// in the interval after (tracer_stream, beside the next collision); the
// rest value and the two z values stay with the thread, which collides
// the same (x, y) column slab after slab: it writes the rest slot at once,
// and once it holds slabs z - d and z, the slot -z of the lower and +z of
// the upper.  Every slot applies the hard interface bounce-back after
// streaming as tracer_slot does, from the flags of the cell and its upwind
// neighbour and the two candidates.  One tracer takes an instance that
// knows its count (NT = 1): its populations are loaded before the flow's
// collision and held in registers, with its z values of the slab before;
// other counts loop at run time with those z values in shared memory.  A
// launch takes as many tracers as shared memory holds (16 in float, 2 in
// double), a further launch each further group.  Shared
// memory: the flow's 94.9 KB (float) and 8.2 KB a tracer, so two blocks an
// SM up to two tracers.  One more barrier a run.
//
// The local form (K12d, cg3d_local.cuh) runs the same kernels on one shard's
// padded buffer, each over a box of slabs and rows: BOX = true and a Box3
// argument (the single-device instances take BOX = false and ignore it),
// and for collide_stream a kernel of its own, collide_stream_box_kernel,
// around the same body (collide_stream_tracer_kernel's BOX instances with
// tracers).  K9t's least bytes add the tracer in and out: with one f32
// tracer 2 x 28 B a cell; the fused form reads g once for each ring cell
// (1.33x, mostly from L2) and writes g' once.
//
// What bounds it: the least work is HBM bytes, the state in and out plus
// the 4 geometry planes: 176 B a cell (f32), 100 B (bf16), 320 B (split
// f32).  This design moves about 260 / 170 / 400 B: the state read twice
// (fields and collide_stream; the rings' recompute mostly hits L2), g and
// kappa written once and read once (32 B f32), the code plane read by
// each kernel.  The TPU kernel keeps phi, the normals and kappa in VMEM
// for each z-block; on the H100 the four helper passes that wrote and
// re-read phi (one plane) and g, n, kappa (seven) took 231 of 594 us a
// step at 128^3 (PERF.md), and fields_kernel keeps all but g and kappa in
// shared memory.  collide_stream is latency-bound rather than byte-bound
// (bf16 storage saves it almost nothing): 16-22 warps an SM, two barriers
// a slab.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "occupancy.cuh"

struct Cg3dParams {      // mirrored by kernels/cg3d.py::Cg3dParams
  int nz, ny, nx;
  int inlet;             // 0 periodic, 1 velocity (NEBB)
  int outlet;            // 0 periodic, 1 convective, 2 dirichlet (NEBB)
  int has_wetting;
  int tau_type;          // 1 | 2
  int pad;
  double tau_r, tau_b, sigma, beta, delta, cos_t, sin_t, bfx, bfy, bfz;
  double inlet_vz, outlet_rho;
};

struct Tracer3dParams {  // mirrored by kernels/cg3d.py::Tracer3dParams
  int nt;
  int interface;         // 0 none, 1 bounceback
  double criteria;
};

namespace {

// The cells a pass of the local form runs over: slabs [z0, z1) and rows
// [y0, y1) of the padded buffer, every x.
struct Box3 {
  int z0, z1, y0, y1;
};

constexpr int kCompressed = 0;
constexpr int kSplit = 1;
constexpr int Q = 19;

constexpr double kEps = 1.0e-8;

// collide_stream's tile and z-run, and fields_kernel's (chip_sweep.py k9
// times copies with other values; PERF.md has the sweep)
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int HX = TX + 2;
constexpr int HY = TY + 2;
constexpr int ZC = 16;    // z slabs a collide_stream block marches through
constexpr int NSH = 23;   // shared values per ring cell: post (19), frac, A, B, C
constexpr int RING_THREADS = (HX * HY + 31) / 32 * 32;   // one thread a ring cell

constexpr int FX = 32;    // fields_kernel's tile: FX x FY, FX x FY_SPLIT in the split layout
constexpr int FY = 16;
constexpr int FY_SPLIT = 12;
constexpr int FZ = 32;    // the most z slabs a fields_kernel block marches through
constexpr int FZ_SPLIT = 48;   // the same in the split layout
// fields_kernel's rings and threads in layout L: the phi ring is the tile
// and 3 cells a side, the normal ring the tile and 1 cell a side; one
// thread a cell within 2 of the tile, and the outer band of the phi ring
// (2 QW + 2 QH - 4 cells) goes to the first threads as a second cell.  The
// split layout's shorter tile leaves a thread 96 registers in place of 80:
// its phi reads 38 values a cell, which spilled at 80 (PERF.md)
template <int L> struct FieldTile {
  static constexpr int Y = L == kSplit ? FY_SPLIT : FY;
  static constexpr int Z = L == kSplit ? FZ_SPLIT : FZ;
  static constexpr int QW = FX + 6, QH = Y + 6, NW = FX + 2, NH = Y + 2;
  static constexpr int THREADS = ((FX + 4) * (Y + 4) + 31) / 32 * 32;
  static constexpr int BAND = 2 * QW + 2 * QH - 4;
  static_assert(BAND <= THREADS, "a thread takes at most one band cell");
};
constexpr int kFieldPlanes = 4;   // g (3), kappa

// D3Q19, the lattice's order (lattice.py): 0 rest, 1-6 axes, 7-18 face
// diagonals; opposite of i > 0 is i + 1 for odd i, i - 1 for even i.
__device__ __forceinline__ int ex(int i) {
  constexpr signed char E[Q] = {0, 1, -1, 0, 0, 0, 0, 1, -1, 1, -1, 1, -1, 1, -1, 0, 0, 0, 0};
  return E[i];
}
__device__ __forceinline__ int ey(int i) {
  constexpr signed char E[Q] = {0, 0, 0, 1, -1, 0, 0, 1, -1, -1, 1, 0, 0, 0, 0, 1, -1, 1, -1};
  return E[i];
}
__device__ __forceinline__ int ez(int i) {
  constexpr signed char E[Q] = {0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0, 1, -1, -1, 1, 1, -1, -1, 1};
  return E[i];
}
__device__ __forceinline__ int opp(int i) { return i == 0 ? 0 : ((i & 1) ? i + 1 : i - 1); }
__device__ __forceinline__ double wq(int i) {
  return i == 0 ? 1.0 / 3.0 : (i <= 6 ? 1.0 / 18.0 : 1.0 / 36.0);
}

// v mod n for v in [-n, 2n), without an integer division: the stencil
// offsets here are one cell
__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}
// v mod n for v >= -n (a tile's ring may pass a small domain more than once)
__device__ __forceinline__ int wrap_any(int v, int n) { return (v + n) % n; }
// v mod n for any v
__device__ __forceinline__ int pmod(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// Storage type S -> compute type C.  bf16 storage holds f_i - w_i*fl.
// The buffer index k of this thread's cell: thread t of the whole domain,
// or (BOX) the t-th cell of the box B in buffer order.  False past the last.
template <bool BOX>
__device__ __forceinline__ bool cell_index(const Cg3dParams& P, const Box3& B, size_t& k) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (BOX) {
    const size_t row = (size_t)(B.y1 - B.y0) * P.nx;
    if (t >= (size_t)(B.z1 - B.z0) * row) return false;
    k = ((size_t)(B.z0 + (int)(t / row)) * P.ny + B.y0) * P.nx + t % row;
    return true;
  } else {
    k = t;
    return k < (size_t)P.nz * P.ny * P.nx;
  }
}

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

// One cell's state in compute precision: the total PDF and rho_r
// (compressed), or the colour PDFs (split).
template <typename C, int L> struct Cell;
template <typename C> struct Cell<C, kCompressed> {
  C f[Q];
  C rr;
};
template <typename C> struct Cell<C, kSplit> {
  C r[Q];
  C b[Q];
};

// Scratch slot of slab z when the boundary slabs redirect it (-1: read the
// state): 0-2 the outlet slabs z = 0-2, 3 and 4 the inlet slabs nz-2, nz-1.
__device__ __forceinline__ int bc_slot(const Cg3dParams& P, int z) {
  if (P.outlet != 0 && z <= (P.outlet == 1 ? 2 : 1)) return z;
  if (P.inlet != 0 && z >= P.nz - 2) return z - (P.nz - 2) + 3;
  return -1;
}

// Decode stored values (stride apart from index k) of a cell whose fluid
// flag is fl.
template <typename S, int L, typename C = typename Traits<S>::C>
__device__ __forceinline__ void decode(const S* __restrict__ p, size_t stride, size_t k,
                                       C fl, Cell<C, L>& c) {
  if constexpr (L == kSplit) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      c.r[i] = to_c(p[i * stride + k]);
      c.b[i] = to_c(p[(Q + i) * stride + k]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < Q; ++i) c.f[i] = to_c(p[i * stride + k]);
    if constexpr (Traits<S>::kShifted) {
#pragma unroll
      for (int i = 0; i < Q; ++i) c.f[i] = c.f[i] + C(wq(i)) * fl;
      c.rr = to_c(p[Q * stride + k]) + to_c(p[(Q + 1) * stride + k]);
    } else {
      c.rr = to_c(p[Q * stride + k]);
    }
  }
}

template <typename S, int L, typename C = typename Traits<S>::C>
__device__ __forceinline__ void encode(S* __restrict__ p, size_t stride, size_t k, C fl,
                                       const Cell<C, L>& c) {
  if constexpr (L == kSplit) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      p[i * stride + k] = c.r[i];
      p[(Q + i) * stride + k] = c.b[i];
    }
  } else if constexpr (Traits<S>::kShifted) {
#pragma unroll
    for (int i = 0; i < Q; ++i) p[i * stride + k] = __float2bfloat16_rn(c.f[i] - C(wq(i)) * fl);
    const __nv_bfloat16 hi = __float2bfloat16_rn(c.rr);
    p[Q * stride + k] = hi;
    p[(Q + 1) * stride + k] = __float2bfloat16_rn(c.rr - __bfloat162float(hi));
  } else {
#pragma unroll
    for (int i = 0; i < Q; ++i) p[i * stride + k] = c.f[i];
    p[Q * stride + k] = c.rr;
  }
}

// Pointers of the state: s holds all planes of the compressed layout, or
// f_r (s) and f_b (s2) in the split one; bc is the boundary-slab scratch
// [plane][5][ny][nx] (nullptr without boundary slabs).
template <typename S> struct State {
  const S* s;
  const S* s2;
  const S* bc;
};

// The cell (z, y, x) as the physics sees it: after the boundary slabs.
template <typename S, int L, typename C = typename Traits<S>::C>
__device__ __forceinline__ void load_cell(const State<S>& st, const C* __restrict__ geo,
                                          const Cg3dParams& P, int z, int y, int x,
                                          Cell<C, L>& c) {
  const size_t nxy = (size_t)P.ny * P.nx;
  const size_t k2 = (size_t)y * P.nx + x;
  const size_t k = (size_t)z * nxy + k2;
  const C fl = geo[k] > C(0.5) ? C(1) : C(0);
  const int slot = st.bc ? bc_slot(P, z) : -1;
  if (slot >= 0) {
    decode<S, L>(st.bc, 5 * nxy, (size_t)slot * nxy + k2, fl, c);
    return;
  }
  const size_t n = (size_t)P.nz * nxy;
  if constexpr (L == kSplit) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      c.r[i] = to_c(st.s[i * n + k]);
      c.b[i] = to_c(st.s2[i * n + k]);
    }
  } else {
    decode<S, L>(st.s, n, k, fl, c);
  }
}

template <typename C>
__device__ __forceinline__ C sumq(const C f[Q]) {
  C r = f[0];
#pragma unroll
  for (int i = 1; i < Q; ++i) r = r + f[i];
  return r;
}

// sum over the directions with e_z = 0, +1, -1 (in the lattice's order)
template <typename C>
__device__ __forceinline__ C sum_ez(const C f[Q], int sign) {
  C r = C(0);
#pragma unroll
  for (int i = 0; i < Q; ++i)
    if (ez(i) == sign) r = r + f[i];
  return r;
}

// NEBB values of the unknown directions of a boundary cell's total PDF ft
// (the others kept): nf_i = feq_i + ft_opp(i) - feq_opp(i) at u = (0, 0,
// vz).  Inlet (unknown e_z = -1): vz given, rho = (S_0 + 2 S_+) / (1 + vz);
// outlet (unknown e_z = +1): rho given, vz = 1 - (S_0 + 2 S_-) / rho.  The
// constants are rounded where the jnp prologue rounds them (its inlet
// polynomial and 1 + vz, and its outlet w_i * rho, are Python floats).
template <typename C>
__device__ __forceinline__ void nebb_slab(const C ft[Q], const Cg3dParams& P, bool inlet,
                                          C nf[Q]) {
  if (inlet) {
    const double vz = P.inlet_vz;
    const C rho = (sum_ez(ft, 0) + C(2.0) * sum_ez(ft, 1)) / C(1.0 + vz);
    auto feq = [&](int i) {
      const double eu = ez(i) * vz;
      return C(wq(i)) * rho * C(1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * vz * vz);
    };
#pragma unroll
    for (int i = 0; i < Q; ++i)
      nf[i] = ez(i) == -1 ? feq(i) + (ft[opp(i)] - feq(opp(i))) : ft[i];
  } else {
    const C vz = C(1.0) - (sum_ez(ft, 0) + C(2.0) * sum_ez(ft, -1)) / C(P.outlet_rho);
    auto feq = [&](int i) {
      const C eu = C(ez(i)) * vz;
      return C(wq(i) * P.outlet_rho) *
             (C(1) + C(3) * eu + C(4.5) * eu * eu - C(1.5) * vz * vz);
    };
#pragma unroll
    for (int i = 0; i < Q; ++i)
      nf[i] = ez(i) == 1 ? feq(i) + (ft[opp(i)] - feq(opp(i))) : ft[i];
  }
}

// The NEBB rewrite of one fluid cell of a boundary slab, in place.
template <typename C>
__device__ void rewrite(Cell<C, kCompressed>& c, const Cg3dParams& P, bool inlet) {
  C nf[Q];
  nebb_slab(c.f, P, inlet, nf);
  const C tot = sumq(c.f);
  const C ratio = c.rr / (tot != C(0) ? tot : C(1));
  C dsum = C(0);
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    if (ez(i) == (inlet ? -1 : 1)) {
      dsum = dsum + (nf[i] - c.f[i]);
      c.f[i] = nf[i];
    }
  }
  c.rr = c.rr + ratio * dsum;
}

template <typename C>
__device__ void rewrite(Cell<C, kSplit>& c, const Cg3dParams& P, bool inlet) {
  C ft[Q], nf[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) ft[i] = c.r[i] + c.b[i];
  nebb_slab(ft, P, inlet, nf);
  const C tot = sumq(ft);
  const C ratio = sumq(c.r) / (tot != C(0) ? tot : C(1));
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    if (ez(i) == (inlet ? -1 : 1)) {
      c.r[i] = ratio * nf[i];
      c.b[i] = (C(1) - ratio) * nf[i];
    }
  }
}

// Boundary slabs of one (y, x) column into the scratch.  Each rewritten or
// copied slab is encoded in storage type and, where a later slab copies it,
// decoded again, as the bf16 prologue does (identity for float / double).
template <typename S, int L, typename C = typename Traits<S>::C>
__global__ void bc_kernel(State<S> st, const C* __restrict__ geo, S* __restrict__ bc,
                          Cg3dParams P) {
  const size_t nxy = (size_t)P.ny * P.nx;
  const size_t k2 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k2 >= nxy) return;
  const size_t bs = 5 * nxy;
  State<S> raw = st;
  raw.bc = nullptr;
  const int y = (int)(k2 / P.nx), x = (int)(k2 % P.nx);
  auto fl_at = [&](int z) { return geo[(size_t)z * nxy + k2] > C(0.5) ? C(1) : C(0); };
  auto load = [&](int z, Cell<C, L>& c) { load_cell<S, L>(raw, geo, P, z, y, x, c); };
  auto store = [&](int slot, int z, const Cell<C, L>& c) {
    encode<S, L>(bc, bs, (size_t)slot * nxy + k2, fl_at(z), c);
  };
  auto reload = [&](int slot, int z, Cell<C, L>& c) {
    decode<S, L>(bc, bs, (size_t)slot * nxy + k2, fl_at(z), c);
  };
  Cell<C, L> c, g;
  if (P.inlet == 1) {
    const int z = P.nz - 2;
    load(z, c);
    if (fl_at(z) > C(0.5)) rewrite(c, P, true);
    store(3, z, c);
    if (fl_at(z + 1) > C(0.5)) g = c;   // the ghost copies the rewritten cell
    else load(z + 1, g);
    store(4, z + 1, g);
  }
  if (P.outlet == 1) {
    load(3, c);
    for (int z = 2; z >= 0; --z) {
      if (z < 2) reload(z + 1, z + 1, c);
      if (!(fl_at(z) > C(0.5))) load(z, c);
      store(z, z, c);
    }
  } else if (P.outlet == 2) {
    load(1, c);
    if (fl_at(1) > C(0.5)) rewrite(c, P, false);
    store(1, 1, c);
    if (fl_at(0) > C(0.5)) reload(1, 1, g);
    else load(0, g);
    store(0, 0, g);
  }
}

// The cell's total PDF, colour densities and total density as the jnp
// physics forms them: compressed rho_b = sum f - rho_r, split per colour.
template <typename C>
__device__ __forceinline__ void totals(const Cell<C, kCompressed>& c, C f[Q], C& rr, C& rb) {
#pragma unroll
  for (int i = 0; i < Q; ++i) f[i] = c.f[i];
  rr = c.rr;
  rb = sumq(f) - rr;
}

template <typename C>
__device__ __forceinline__ void totals(const Cell<C, kSplit>& c, C f[Q], C& rr, C& rb) {
#pragma unroll
  for (int i = 0; i < Q; ++i) f[i] = c.r[i] + c.b[i];
  rr = sumq(c.r);
  rb = sumq(c.b);
}

// phi = (rho_r - rho_b) / (rho_r + rho_b) of a fluid cell.
template <typename C, int L>
__device__ __forceinline__ C cell_phase(const Cell<C, L>& c) {
  C f[Q], rr, rb;
  totals(c, f, rr, rb);
  const C tot = rr + rb;
  return tot != C(0) ? (rr - rb) / tot : C(0);
}

// Akai 2018 contact-angle rotation of the gradient on a wetting fluid cell
// (ops/colorgrad.py::rotate_gradient_on_wetting_akai_nd).
template <typename C>
__device__ void rotate_akai(C g[3], const C ns[3], const Cg3dParams& P) {
  const C cos_t = C(P.cos_t), sin_t = C(P.sin_t);
  const C norm = sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
  const bool ok = norm > C(kEps);
  C u[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) u[d] = ok ? -g[d] / norm : C(0);
  const C dot = fmin(fmax(u[0] * ns[0] + u[1] * ns[1] + u[2] * ns[2], C(-1)), C(1));
  const C sin_gs = sqrt(fmax(C(1) - dot * dot, C(0)));
  const bool oks = sin_gs > C(1.0e-9);
  const C c1 = oks ? sin_t * dot / sin_gs : C(0);
  const C c2 = oks ? sin_t / sin_gs : C(0);
  C n1[3], n2[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    n1[d] = (cos_t - c1) * ns[d] + c2 * u[d];
    n2[d] = (cos_t + c1) * ns[d] - c2 * u[d];
  }
  const C d1 = sqrt((n1[0] - u[0]) * (n1[0] - u[0]) + (n1[1] - u[1]) * (n1[1] - u[1]) +
                    (n1[2] - u[2]) * (n1[2] - u[2]));
  const C d2 = sqrt((n2[0] - u[0]) * (n2[0] - u[0]) + (n2[1] - u[1]) * (n2[1] - u[1]) +
                    (n2[2] - u[2]) * (n2[2] - u[2]));
  if (d1 == d2) return;  // ties keep their gradient
  const bool pick1 = d1 < d2;
#pragma unroll
  for (int d = 0; d < 3; ++d) g[d] = -norm * (pick1 ? n1[d] : n2[d]);
}

// phi of a solid cell extended from its neighbours: the w-weighted mean of
// the fluid ones, num / den as ops/colorgrad.py::solid_phi_extrapolate forms
// it (0 without fluid neighbours); fluid_at(i) and phi_at(i) read neighbour
// i = x + e_i.
template <typename C, typename FluidAt, typename PhiAt>
__device__ __forceinline__ C extrapolated_phi(FluidAt fluid_at, PhiAt phi_at) {
  C num = C(0), den = C(0);
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    if (fluid_at(i)) {
      num = num + C(wq(i)) * phi_at(i);
      den = den + C(wq(i));
    }
  }
  return den > C(0) ? num / den : C(0);
}

// g = 3 sum_i w_i e_i phi(x + e_i) of the (extended) phase field; phi_at(i)
// reads neighbour i.
template <typename C, typename PhiAt>
__device__ __forceinline__ void phi_gradient(PhiAt phi_at, C g[3]) {
  g[0] = g[1] = g[2] = C(0);
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    const C sv = phi_at(i);
    if (ex(i)) g[0] = g[0] + C(wq(i) * ex(i)) * sv;
    if (ey(i)) g[1] = g[1] + C(wq(i) * ey(i)) * sv;
    if (ez(i)) g[2] = g[2] + C(wq(i) * ez(i)) * sv;
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) g[d] = C(3) * g[d];
}

// The unit inward normal n = -g/|g| times the fluid flag fl (0 where |g| is
// below kEps).
template <typename C>
__device__ __forceinline__ void inward_normal(const C g[3], C fl, C n[3]) {
  const C norm = sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
  const bool ok = norm > C(kEps);
#pragma unroll
  for (int d = 0; d < 3; ++d) n[d] = (ok ? -g[d] / norm : C(0)) * fl;
}

// The curvature kappa = sum_ab (n_a n_b - delta_ab) d_a n_b of the unit
// normals at a fluid cell with normal nh, the partials by the isotropic
// stencil (ops/colorgrad.py::csf_force_nd); n_at(i, b) reads component b of
// neighbour i's normal.
template <typename C, typename NAt>
__device__ __forceinline__ C curvature_of(NAt n_at, const C nh[3]) {
  C dn[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) dn[a][b] = C(0);
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    const C s[3] = {n_at(i, 0), n_at(i, 1), n_at(i, 2)};
    const int e[3] = {ex(i), ey(i), ez(i)};
    const double w3 = 3.0 * wq(i);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (!e[a]) continue;
#pragma unroll
      for (int b = 0; b < 3; ++b) dn[a][b] = dn[a][b] + C(w3 * e[a]) * s[b];
    }
  }
  C kappa = C(0);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) kappa = kappa + (nh[a] * nh[b] - C(a == b ? 1 : 0)) * dn[a][b];
  return kappa;
}

// Whether a block's z-run marches up (blockIdx.z even) or down; a run that
// shares a boundary with the next marches the other way.
__device__ __forceinline__ bool up_run() { return (blockIdx.z & 1) == 0; }

// fields_kernel: the state (after the boundary slabs) -> g (planes 0-2 of
// fld, every cell of the output region) and kappa (plane 3, 0 off fluid);
// the design is in the note at the top.  BOX: the output region is the
// box's slabs and rows (every x), else the whole domain.  A block marches
// `zrun` slabs.
template <typename S, int L, bool BOX, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(FieldTile<L>::THREADS)
fields_kernel(State<S> st, const C* __restrict__ geo, C* __restrict__ fld, Cg3dParams P,
              Box3 box, int zrun) {
  // rings: phi and the geometry code [8 slots][QH][QW], the normals and
  // the fluid flag [4 slots][4][NH][NW] (FieldTile<L>)
  using FT = FieldTile<L>;
  extern __shared__ __align__(16) unsigned char smem[];
  C* sphi = reinterpret_cast<C*>(smem);
  C* scode = sphi + 8 * FT::QH * FT::QW;
  C* snrm = scode + 8 * FT::QH * FT::QW;
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const size_t nxy = (size_t)ny * nx;
  const size_t n = (size_t)nz * nxy;
  const int x0 = blockIdx.x * FX;
  const int y0 = (BOX ? box.y0 : 0) + blockIdx.y * FT::Y;
  const int z0 = (BOX ? box.z0 : 0) + blockIdx.z * zrun;
  const int z1 = min(z0 + zrun, BOX ? box.z1 : nz);
  const int y1 = BOX ? box.y1 : ny;
  const bool wet = P.has_wetting != 0;
  const int t = threadIdx.x;
  // ring slots of the unwrapped slab z (z >= -7): phi ring coordinates
  // (lx, ly) are the tile's plus 3, normal ring coordinates the tile's
  // plus 1
  auto pi = [&](int z, int ly, int lx) { return ((z & 7) * FT::QH + ly) * FT::QW + lx; };
  auto ni = [&](int z, int d, int my, int mx) {
    return (((z & 3) * 4 + d) * FT::NH + my) * FT::NW + mx;
  };
  // this thread's cell within 2 of the tile, and its band cell (t <
  // FT::BAND): the top and bottom rows, then the left and right columns
  const bool inner = t < (FX + 4) * (FT::Y + 4);
  const int ix = 1 + t % (FX + 4), iy = 1 + t / (FX + 4);
  const int b = t < 2 * FT::QW ? t : t - 2 * FT::QW;
  const int bx = t < 2 * FT::QW ? b % FT::QW : (b & 1) * (FT::QW - 1);
  const int by = t < 2 * FT::QW ? (b / FT::QW) * (FT::QH - 1) : 1 + b / 2;
  const int cy = pmod(y0 - 3 + iy, ny), cx = pmod(x0 - 3 + ix, nx);
  const int byy = pmod(y0 - 3 + by, ny), bxx = pmod(x0 - 3 + bx, nx);

  // phi of slab h over the phi ring (0 on solid cells until the extension)
  // and the geometry code.  Within 2 of the tile the state is read whatever
  // the code, so that its loads go out with the code's.  In the outer band
  // and on the run's end slabs z0 - 3 and z1 + 2 only wetting fluid cells
  // are read, after their code is back: they are the only fluid cells an
  // extension reads there (every fluid neighbour of a solid cell wets), and
  // nothing else reads those cells' phi
  auto phase = [&](int h) {
    const int cz = pmod(h, nz);
    const bool edge = h == z0 - 3 || h == z1 + 2;
    if (inner) {
      const C code = geo[(size_t)cz * nxy + (size_t)cy * nx + cx];
      Cell<C, L> c;
      if (!edge) load_cell<S, L>(st, geo, P, cz, cy, cx, c);
      C v = C(0);
      if (edge) {
        if (wet && code > C(1.5)) {
          load_cell<S, L>(st, geo, P, cz, cy, cx, c);
          v = cell_phase(c);
        }
      } else if (code > C(0.5)) {
        v = cell_phase(c);
      }
      sphi[pi(h, iy, ix)] = v;
      scode[pi(h, iy, ix)] = code;
    }
    if (wet && t < FT::BAND) {
      const C code = geo[(size_t)cz * nxy + (size_t)byy * nx + bxx];
      C v = C(0);
      if (code > C(1.5)) {
        Cell<C, L> c;
        load_cell<S, L>(st, geo, P, cz, byy, bxx, c);
        v = cell_phase(c);
      }
      sphi[pi(h, by, bx)] = v;
      scode[pi(h, by, bx)] = code;
    }
  };
  // phi extended onto the solid cells with a fluid neighbour of slab z
  // within 2 of the tile, in place (it reads only fluid cells)
  auto extend = [&](int z) {
    if (!inner || !(scode[pi(z, iy, ix)] < C(-0.5))) return;
    sphi[pi(z, iy, ix)] = extrapolated_phi<C>(
        [&](int i) { return scode[pi(z + ez(i), iy + ey(i), ix + ex(i))] > C(0.5); },
        [&](int i) { return sphi[pi(z + ez(i), iy + ey(i), ix + ex(i))]; });
  };
  // the solid-surface normal of slab z's cell of this thread's normal (0
  // unless it wets), loaded before the extension so that the loads are in
  // flight while it runs
  const int mx = t % FT::NW, my = t / FT::NW;
  auto surface = [&](int z, C ns[3]) {
    ns[0] = ns[1] = ns[2] = C(0);
    if (!wet || t >= FT::NW * FT::NH || !(scode[pi(z, my + 2, mx + 2)] > C(1.5))) return;
    const size_t k = (size_t)pmod(z, nz) * nxy + (size_t)pmod(y0 - 1 + my, ny) * nx +
                     pmod(x0 - 1 + mx, nx);
    ns[0] = geo[n + k];
    ns[1] = geo[2 * n + k];
    ns[2] = geo[3 * n + k];
  };
  // g (rotated on wetting fluid cells by the surface normal ns) and the
  // unit inward normal of slab z within 1 of the tile, with the cell's
  // fluid flag; g of the tile's cells of the run to fld
  auto normal = [&](int z, const C ns[3]) {
    if (t >= FT::NW * FT::NH) return;
    const int x = x0 - 1 + mx, y = y0 - 1 + my;
    C g[3], nv[3];
    phi_gradient<C>(
        [&](int i) { return sphi[pi(z + ez(i), my + 2 + ey(i), mx + 2 + ex(i))]; }, g);
    const C code = scode[pi(z, my + 2, mx + 2)];
    if (wet && code > C(1.5)) rotate_akai(g, ns, P);
    inward_normal(g, code > C(0.5) ? C(1) : C(0), nv);
#pragma unroll
    for (int d = 0; d < 3; ++d) snrm[ni(z, d, my, mx)] = nv[d];
    snrm[ni(z, 3, my, mx)] = code > C(0.5) ? C(1) : C(0);
    if (z >= z0 && z < z1 && mx >= 1 && mx <= FX && my >= 1 && my <= FT::Y && x < nx && y < y1) {
      const size_t k = ((size_t)z * ny + y) * nx + x;
#pragma unroll
      for (int d = 0; d < 3; ++d) fld[d * n + k] = g[d];
    }
  };
  // kappa of slab z on the tile (0 off fluid) to fld
  auto curvature = [&](int z) {
    if (t >= FX * FT::Y) return;
    const int tx = t % FX, ty = t / FX;
    const int x = x0 + tx, y = y0 + ty;
    if (x >= nx || y >= y1) return;
    const int mx = tx + 1, my = ty + 1;
    C kappa = C(0);
    if (snrm[ni(z, 3, my, mx)] > C(0.5)) {
      const C nh[3] = {snrm[ni(z, 0, my, mx)], snrm[ni(z, 1, my, mx)], snrm[ni(z, 2, my, mx)]};
      kappa = curvature_of(
          [&](int i, int b) { return snrm[ni(z + ez(i), b, my + ey(i), mx + ex(i))]; }, nh);
    }
    fld[3 * n + ((size_t)z * ny + y) * nx + x] = kappa;
  };

  // One barrier a slab: between two barriers the four phases run on slabs
  // two apart (phi of h, the extension of h - 2d, the normals of h - 4d
  // and kappa of h - 6d, d the direction of the march), so that each reads
  // only what earlier intervals wrote and no phase writes a slot another
  // reads in the same interval (phi and codes 8 slots, the normals 4).
  // Runs march up where blockIdx.z is even and down where it is odd, so
  // that two runs that share a boundary read the slabs around it at the
  // same time and the second read hits L2.
  const int d = up_run() ? 1 : -1;
  const int first = d > 0 ? z0 - 3 : z1 + 2;
  for (int j = 0; j <= z1 - z0 + 8; ++j) {
    const int h = first + d * j, e = h - 2 * d, m = h - 4 * d, k = h - 6 * d;
    C ns[3];
    if (j <= z1 - z0 + 5) phase(h);
    if (m >= z0 - 1 && m <= z1) surface(m, ns);
    if (wet && e >= z0 - 2 && e <= z1 + 1) extend(e);
    if (m >= z0 - 1 && m <= z1) normal(m, ns);
    if (k >= z0 && k < z1) curvature(k);
    __syncthreads();
  }
}

template <typename C>
__device__ __forceinline__ C tau_at(C phi, C rr, C rb, const Cg3dParams& P) {
  if (phi > C(P.delta)) return C(P.tau_r);
  if (phi < C(-P.delta)) return C(P.tau_b);
  if (P.tau_type == 1)
    return C(0.5) + C(1) / ((C(1) + phi) / C(2.0 * (P.tau_r - 0.5)) +
                            (C(1) - phi) / C(2.0 * (P.tau_b - 0.5)));
  C tot = rr + rb;
  tot = tot != C(0) ? tot : C(1);
  const C mu = C(1) / ((rr / tot) * C(3.0 / (P.tau_r - 0.5)) +
                       (rb / tot) * C(3.0 / (P.tau_b - 0.5)));
  return C(3) * mu + C(0.5);
}

// The CSF force F (with the body force) and the velocity u = (m + F/2) /
// rho of a fluid cell from its total PDF, density, colour gradient g and
// curvature kappa: the one u the flow collides with and the coupled
// tracer is advected by.
template <typename C>
__device__ __forceinline__ void cell_velocity(const C f[Q], C rho, const C g[3], C kappa,
                                              const Cg3dParams& P, C F[3], C u[3]) {
  const C ks = C(-0.5 * P.sigma) * kappa;
  const double bf[3] = {P.bfx, P.bfy, P.bfz};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    F[d] = ks * g[d];
    if (bf[d] != 0.0) F[d] = F[d] + C(bf[d]) * rho;
  }
  const C rho_safe = rho > C(0) ? rho : C(1);
  C m[3] = {C(0), C(0), C(0)};
#pragma unroll
  for (int i = 1; i < Q; ++i) {
    if (ex(i)) m[0] = m[0] + C(ex(i)) * f[i];
    if (ey(i)) m[1] = m[1] + C(ey(i)) * f[i];
    if (ez(i)) m[2] = m[2] + C(ez(i)) * f[i];
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) u[d] = (m[d] + C(0.5) * F[d]) / rho_safe;
}

// Post-collision total PDF of one fluid cell c (phase ph, colour gradient
// g, curvature kappa) and its recolouring terms: the red post-collision
// population is frac * post_i + w_i e_i . (A, B, Cz) (red_part).
template <typename C, int L>
__device__ __forceinline__ void collide_core(const Cell<C, L>& c, C ph, const C g[3], C kappa,
                             const Cg3dParams& P, C post[Q], C& frac, C& A, C& B, C& Cz) {
  C f[Q], rr, rb;
  totals(c, f, rr, rb);
  const C rho = rr + rb;
  C F[3], u[3];
  cell_velocity(f, rho, g, kappa, P, F, u);
  const C tau = tau_at(ph, rr, rb, P);
  const C pref = C(1) - C(0.5) / tau;
  const C uu = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const C e0 = C(ex(i)), e1 = C(ey(i)), e2 = C(ez(i));
    const C eu = e0 * u[0] + e1 * u[1] + e2 * u[2];
    const C feq = C(wq(i)) * rho * (C(1) + C(3) * eu + C(4.5) * eu * eu - C(1.5) * uu);
    const C src = C(wq(i)) * ((C(3) * (e0 - u[0]) + C(9) * e0 * eu) * F[0] +
                              (C(3) * (e1 - u[1]) + C(9) * e1 * eu) * F[1] +
                              (C(3) * (e2 - u[2]) + C(9) * e2 * eu) * F[2]);
    post[i] = f[i] - (f[i] - feq) / tau + pref * src;
  }

  // LKR recolouring terms
  const C tot_safe = rho != C(0) ? rho : C(1);
  frac = rr / tot_safe;
  const C segc = C(P.beta) * rr * rb / tot_safe;
  const C norm = sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
  if (norm > C(kEps)) {
    A = segc * (g[0] / norm);
    B = segc * (g[1] / norm);
    Cz = segc * (g[2] / norm);
  } else {
    A = B = Cz = C(0);
  }
}

// The red part frac * o + w_j e_j . (A, B, Cz) of population j (value o)
// of a cell with the recolouring terms frac, A, B, Cz (the T-step kernel's;
// collide_stream_kernel forms the same sum inline from its shared-memory
// ring: through this function, or an accessor form of it, the one-step
// kernel needs more registers and runs slower on an H100).
template <typename C>
__device__ __forceinline__ C red_part(int j, C o, C frac, C A, C B, C Cz) {
  const C seg = C(wq(j)) * (C(ex(j)) * A + C(ey(j)) * B + C(ez(j)) * Cz);
  return frac * o + seg;
}

// collide_core at the fluid cell (z, y, x) of the global state: phi from
// the cell's state, g and kappa from fields_kernel's planes fld.
template <typename S, int L, typename C = typename Traits<S>::C>
__device__ __forceinline__ void collide_cell(const State<S>& st, const C* __restrict__ geo,
                             const C* __restrict__ fld, const Cg3dParams& P, int z, int y,
                             int x, C post[Q], C& frac, C& A, C& B, C& Cz) {
  const size_t nxy = (size_t)P.ny * P.nx;
  const size_t n = (size_t)P.nz * nxy;
  const size_t k = (size_t)z * nxy + (size_t)y * P.nx + x;
  Cell<C, L> c;
  load_cell<S, L>(st, geo, P, z, y, x, c);
  const C g[3] = {fld[k], fld[n + k], fld[2 * n + k]};
  collide_core(c, cell_phase(c), g, fld[3 * n + k], P, post, frac, A, B, Cz);
}

// rho_r of the cell (z, y, x) as load_cell sees it (after the boundary
// slabs), compressed layout: decode's rho_r alone.
template <typename S, typename C = typename Traits<S>::C>
__device__ __forceinline__ C cell_rr(const State<S>& st, const Cg3dParams& P, int z, int y,
                                     int x) {
  const size_t nxy = (size_t)P.ny * P.nx;
  const size_t k2 = (size_t)y * P.nx + x;
  const int slot = st.bc ? bc_slot(P, z) : -1;
  const S* p = slot >= 0 ? st.bc : st.s;
  const size_t stride = slot >= 0 ? 5 * nxy : (size_t)P.nz * nxy;
  const size_t k = (slot >= 0 ? (size_t)slot : (size_t)z) * nxy + k2;
  if constexpr (Traits<S>::kShifted)
    return to_c(p[Q * stride + k]) + to_c(p[(Q + 1) * stride + k]);
  else
    return to_c(p[Q * stride + k]);
}

// D3Q7 (lattice.py): 0 rest, then +x, -x, +y, -y, +z, -z, so direction
// i > 0 lies on axis (i - 1) / 2, positive for odd i, and opp() above gives
// its opposite.  Per-tracer table row (compute type): tau, then J_0..J_6
// (kernels/cg3d.py::tracer3d_table).
constexpr int Q7 = 7;
constexpr int kTracerRow = 1 + Q7;
__device__ __forceinline__ int e7(int i, int axis) {
  return (i > 0 && (i - 1) / 2 == axis) ? ((i & 1) ? 1 : -1) : 0;
}

// Flag bits of a ring cell in the coupled step.
constexpr unsigned char kInDomain = 1;   // rho_r < criteria
constexpr unsigned char kFluid = 2;

// The coupled step's tracers (K9t): g and g_out (NT, 7, nz, ny, nx) in the
// compute type, tab the (NT, 8) table, and the z-run of the launch (the
// kernels without tracers take an empty one and march runs of ZC).
template <typename C> struct TracerArgs {
  const C* g;
  C* g_out;
  const C* tab;
  Tracer3dParams T;
  int zrun;
};

// Tracer slot i of a cell x after streaming and the hard interface repair,
// the TPU epilogue's six-axis loop as a gather: fx and fs the flag bytes of
// x and of s = x - e_i, pulled the post-collision value of slot i at s,
// bounced that of slot opp(i) at x.  Streaming gives pulled where s is
// fluid, else bounced (half-way bounce-back), 0 on a solid x.  The repair
// returns into slot i at x (in the domain, s not) the streamed opp(i) of s,
// which pulls from x itself: bounced if x is fluid, else pulled, 0 on a
// solid s; and drops slot i at x outside the domain where s is in it.  The
// epilogue reads g_i only outside the domain and writes only inside it
// (slot opp(i)) or zeroes outside it (slot i), so no axis reads what
// another wrote; only fluid cells' post-collision values are ever taken.
template <typename S, typename C>
__device__ __forceinline__ C tracer_slot(int i, unsigned char fx, unsigned char fs, C pulled,
                                         C bounced, const Tracer3dParams& T) {
  const bool fluid = fx & kFluid, d = fx & kInDomain;
  const bool fluid_s = fs & kFluid, ds = fs & kInDomain;
  const bool repair = T.interface;
  if (repair && d && !ds) return fluid_s ? (fluid ? bounced : pulled) : C(0);   // returned
  if (repair && !d && ds) return C(0);                                           // dropped
  return fluid ? (fluid_s ? pulled : bounced) : C(0);
}

// Shared memory of collide_stream: the three-slab ring (NSH values a
// cell) and its flags; with tracers, from tracer_offset on, per tracer the
// four in-plane (+-x, +-y) post-collision values of the ring tile's newest
// slab and each ring cell's +z and -z values of the slab before it.
template <typename S, int L>
__host__ __device__ constexpr size_t smem_bytes() {
  using C = typename Traits<S>::C;
  return sizeof(C) * 3 * NSH * HY * HX + 3 * HY * HX;
}
template <typename S>
__host__ __device__ constexpr size_t tracer_offset() {
  return (smem_bytes<S, kCompressed>() + 15) / 16 * 16;
}
template <typename C>
__host__ __device__ constexpr size_t tracer_bytes() {
  return sizeof(C) * 6 * HY * HX;
}

// The body of collide_stream: BOX, the tiles cover the box's slabs and
// rows (the ring reaches one cell beyond them); without, the whole domain.
template <typename S, int L, bool BOX, typename C>
__device__ __forceinline__ void collide_stream_body(State<S> st, const C* __restrict__ geo,
                                                    const C* __restrict__ fld,
                                                    S* __restrict__ out, S* __restrict__ out2,
                                                    Cg3dParams P, Box3 box) {
  // three slabs of the ring tile: [slot][value][HY][HX], then fluid flags
  extern __shared__ __align__(16) unsigned char smem[];
  C* sh = reinterpret_cast<C*>(smem);
  unsigned char* shfl = smem + sizeof(C) * 3 * NSH * HY * HX;
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const size_t nxy = (size_t)ny * nx;
  const size_t n = (size_t)nz * nxy;
  const int x0 = blockIdx.x * TX, y0 = (BOX ? box.y0 : 0) + blockIdx.y * TY;
  const int z0 = (BOX ? box.z0 : 0) + blockIdx.z * ZC;
  const int z1 = min(z0 + ZC, BOX ? box.z1 : nz);
  // one thread per ring-tile cell: lx = tid % HX, ly = tid / HX
  const int tid = threadIdx.x;
  const int lx = tid % HX, ly = tid / HX;
  auto val = [&](int slot, int v, int ly, int lx) -> C& {
    return sh[((slot * NSH + v) * HY + ly) * HX + lx];
  };
  auto flag = [&](int slot, int ly, int lx) -> unsigned char& {
    return shfl[(slot * HY + ly) * HX + lx];
  };
  // collide slab z of the ring tile into slot
  auto compute_slab = [&](int z, int slot) {
    const int cz = wrap(z, nz);
    if (tid < HX * HY) {
      const int cx = wrap_any(x0 - 1 + lx, nx), cy = wrap_any(y0 - 1 + ly, ny);
      const bool fluid = geo[(size_t)cz * nxy + (size_t)cy * nx + cx] > C(0.5);
      flag(slot, ly, lx) = fluid;
      C post[Q], frac = C(0), A = C(0), B = C(0), Cz = C(0);
      if (fluid) {
        collide_cell<S, L>(st, geo, fld, P, cz, cy, cx, post, frac, A, B, Cz);
      } else {
#pragma unroll
        for (int i = 0; i < Q; ++i) post[i] = C(0);
      }
#pragma unroll
      for (int i = 0; i < Q; ++i) val(slot, i, ly, lx) = post[i];
      val(slot, Q, ly, lx) = frac;
      val(slot, Q + 1, ly, lx) = A;
      val(slot, Q + 2, ly, lx) = B;
      val(slot, Q + 3, ly, lx) = Cz;
    }
  };

  // the tile's own cells stream: ring coordinates 1..TX, 1..TY
  const int x = x0 + lx - 1, y = y0 + ly - 1;
  const bool inside =
      lx >= 1 && lx <= TX && ly >= 1 && ly <= TY && x < nx && y < (BOX ? box.y1 : ny);
  // the ring slot of slab z; the run marches up or down as fields_kernel's
  auto slot_of = [&](int z) { return (z - z0 + 1) % 3; };
  const int d = up_run() ? 1 : -1;
  const int first = d > 0 ? z0 : z1 - 1;
  compute_slab(first - d, slot_of(first - d));
  compute_slab(first, slot_of(first));
  for (int j = 0; j < z1 - z0; ++j) {
    const int z = first + d * j;
    compute_slab(z + d, slot_of(z + d));
    __syncthreads();
    const int cur = slot_of(z);
    if (inside) {
      const size_t k = (size_t)z * nxy + (size_t)y * nx + x;
      // o: the streamed total PDF; red: its red part, frac * post_j +
      // w_j e_j . (A, B, C) at the source cell (the blue part is o - red)
      C o[Q], red[Q];
      C rr_new = C(0);
      if (flag(cur, ly, lx)) {
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          // pull from the upwind cell x - e_i, or bounce back from a solid one
          int slot = (cur - ez(i) + 3) % 3, sx = lx - ex(i), sy = ly - ey(i), j = i;
          if (!flag(slot, sy, sx)) {
            slot = cur;
            sx = lx;
            sy = ly;
            j = opp(i);
          }
          o[i] = val(slot, j, sy, sx);
          const C seg = C(wq(j)) * (C(ex(j)) * val(slot, Q + 1, sy, sx) +
                                    C(ey(j)) * val(slot, Q + 2, sy, sx) +
                                    C(ez(j)) * val(slot, Q + 3, sy, sx));
          red[i] = val(slot, Q, sy, sx) * o[i] + seg;
          rr_new = rr_new + red[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < Q; ++i) o[i] = red[i] = C(0);
      }
      if constexpr (L == kSplit) {
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          out[i * n + k] = red[i];
          out2[i * n + k] = o[i] - red[i];
        }
      } else {
        Cell<C, kCompressed> c;
#pragma unroll
        for (int i = 0; i < Q; ++i) c.f[i] = o[i];
        c.rr = rr_new;
        encode<S, kCompressed>(out, n, k, geo[k] > C(0.5) ? C(1) : C(0), c);
      }
    }
    __syncthreads();
  }
}

// The body of the coupled collide_stream (K9t, compressed layout): the
// flow as collide_stream_body (kept apart, so that K9's instances compile
// as they did), and the D3Q7 tracers of tr collide and stream in the same
// march, see the note at the top; NT > 0 of them known when compiled
// (their populations loaded before the flow's collision of the slab and
// held in registers, with their z values of the slab before), or any
// number (NT = 0: tr.T.nt, read where used).
template <typename S, bool BOX, typename C, int NT>
__device__ __forceinline__ void coupled_stream_body(State<S> st, const C* __restrict__ geo,
                                                    const C* __restrict__ fld,
                                                    S* __restrict__ out, Cg3dParams P, Box3 box,
                                                    TracerArgs<C> tr) {
  constexpr int L = kCompressed;
  // three slabs of the ring tile: [slot][value][HY][HX], then fluid flags
  extern __shared__ __align__(16) unsigned char smem[];
  C* sh = reinterpret_cast<C*>(smem);
  unsigned char* shfl = smem + sizeof(C) * 3 * NSH * HY * HX;
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const size_t nxy = (size_t)ny * nx;
  const size_t n = (size_t)nz * nxy;
  const int x0 = blockIdx.x * TX, y0 = (BOX ? box.y0 : 0) + blockIdx.y * TY;
  const int zc = tr.zrun;
  const int z0 = (BOX ? box.z0 : 0) + blockIdx.z * zc;
  const int z1 = min(z0 + zc, BOX ? box.z1 : nz);
  // one thread per ring-tile cell: lx = tid % HX, ly = tid / HX
  const int tid = threadIdx.x;
  const int lx = tid % HX, ly = tid / HX;
  auto val = [&](int slot, int v, int ly, int lx) -> C& {
    return sh[((slot * NSH + v) * HY + ly) * HX + lx];
  };
  auto flag = [&](int slot, int ly, int lx) -> unsigned char& {
    return shfl[(slot * HY + ly) * HX + lx];
  };
  // what compute_slab keeps of the ring cell it collided last for
  // tracer_collide: its index, fluid flag, velocity and flag bits (fluid,
  // in the domain); NT > 0: its tracers' populations, and their +z and -z
  // post-collision values of the slab before
  bool t_fluid = false;
  C t_u[3];
  unsigned char t_flags = 0;
  size_t t_kc = 0;
  constexpr int NR = NT > 0 ? NT : 1;
  C t_g[NR][Q7], t_prev[NR][2];
  // the cell's index, and (NT > 0) its tracers' loads issued before the
  // flow's collision
  auto tracer_load = [&](int cz, int cy, int cx, bool fluid) {
    t_kc = (size_t)cz * nxy + (size_t)cy * nx + cx;
    if constexpr (NT > 0) {
      if (fluid) {
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int i = 0; i < Q7; ++i) t_g[t][i] = tr.g[(size_t)(t * Q7 + i) * n + t_kc];
      }
    }
  };
  // collide_cell, keeping the cell's rho_r and the velocity its
  // collision formed (cell_velocity on the same values)
  auto collide_tracer_cell = [&](int cz, int cy, int cx, C post[Q], C& frac, C& A, C& B,
                                 C& Cz, C& rr) {
    const size_t k = t_kc;
    Cell<C, L> c;
    load_cell<S, L>(st, geo, P, cz, cy, cx, c);
    const C g[3] = {fld[k], fld[n + k], fld[2 * n + k]};
    collide_core(c, cell_phase(c), g, fld[3 * n + k], P, post, frac, A, B, Cz);
    C f[Q], rb, F[3];
    totals(c, f, rr, rb);
    cell_velocity(f, rr + rb, g, fld[3 * n + k], P, F, t_u);
  };
  // collide slab z of the ring tile into slot
  auto compute_slab = [&](int z, int slot) {
    const int cz = wrap(z, nz);
    if (tid < HX * HY) {
      const int cx = wrap_any(x0 - 1 + lx, nx), cy = wrap_any(y0 - 1 + ly, ny);
      const bool fluid = geo[(size_t)cz * nxy + (size_t)cy * nx + cx] > C(0.5);
      tracer_load(cz, cy, cx, fluid);
      C post[Q], frac = C(0), A = C(0), B = C(0), Cz = C(0);
      C rr = C(0);
      if (fluid) {
        collide_tracer_cell(cz, cy, cx, post, frac, A, B, Cz, rr);
      } else {
#pragma unroll
        for (int i = 0; i < Q; ++i) post[i] = C(0);
      }
#pragma unroll
      for (int i = 0; i < Q; ++i) val(slot, i, ly, lx) = post[i];
      val(slot, Q, ly, lx) = frac;
      val(slot, Q + 1, ly, lx) = A;
      val(slot, Q + 2, ly, lx) = B;
      val(slot, Q + 3, ly, lx) = Cz;
      if (!fluid) rr = cell_rr<S>(st, P, cz, cy, cx);
      t_fluid = fluid;
      t_flags = (fluid ? kFluid : 0) | (rr < C(tr.T.criteria) ? kInDomain : 0);
      flag(slot, ly, lx) = t_flags;
    }
  };

  // the tile's own cells stream: ring coordinates 1..TX, 1..TY
  const int x = x0 + lx - 1, y = y0 + ly - 1;
  const bool inside =
      lx >= 1 && lx <= TX && ly >= 1 && ly <= TY && x < nx && y < (BOX ? box.y1 : ny);
  // the ring slot of slab z; the run marches up or down as fields_kernel's
  auto slot_of = [&](int z) { return (z - z0 + 1) % 3; };
  const int d = up_run() ? 1 : -1;
  // [tracer][value][HY][HX], values 0-3 slots 1-4 of the newest slab,
  // 4 and 5 (NT = 0) slots 5 and 6 (+z, -z) of the slab before
  C* tsh = reinterpret_cast<C*>(smem + tracer_offset<S>());
  auto tval = [&](int t, int v, int ly, int lx) -> C& {
    return tsh[((t * 6 + v) * HY + ly) * HX + lx];
  };
  auto in_run = [&](int z) { return z >= z0 && z < z1; };
  // the tracers of the ring cell compute_slab(z) collided last: the
  // SRT J-scheme collision g_i - (g_i - C (J_i + e_i.u/2)) / tau on its
  // velocity, the four in-plane values to the tracer ring; the tile's
  // cells write their rest slot at z and (has_prev: the column's slab
  // z - d was collided before) the two z slots between slabs z - d and z,
  // which need no other thread's values
  auto tracer_collide = [&](int z, bool has_prev) {
    if (tid >= HX * HY) return;
    const int cz = wrap(z, nz);
    // the column's slabs lo < hi: the slot -z of lo and +z of hi
    const int lo = d > 0 ? z - 1 : z, hi = lo + 1;
    const unsigned char fp = has_prev ? flag(slot_of(z - d), ly, lx) : 0;
    const unsigned char flo = d > 0 ? fp : t_flags, fhi = d > 0 ? t_flags : fp;
#pragma unroll
    for (int t = 0; t < (NT > 0 ? NT : tr.T.nt); ++t) {
      C gp[Q7];
      if (t_fluid) {
        const C* row = tr.tab + t * kTracerRow;
        C gv[Q7];
        C conc = C(0);
#pragma unroll
        for (int i = 0; i < Q7; ++i) {
          if constexpr (NT > 0)
            gv[i] = t_g[t][i];
          else
            gv[i] = tr.g[(size_t)(t * Q7 + i) * n + t_kc];
          conc = conc + gv[i];
        }
        const C tau = row[0];
#pragma unroll
        for (int i = 0; i < Q7; ++i) {
          const C eu = i == 0 ? C(0) : ((i & 1) ? t_u[(i - 1) / 2] : -t_u[(i - 1) / 2]);
          const C geq = conc * (row[1 + i] + C(0.5) * eu);
          gp[i] = gv[i] - (gv[i] - geq) / tau;
        }
      } else {
#pragma unroll
        for (int i = 0; i < Q7; ++i) gp[i] = C(0);
      }
#pragma unroll
      for (int i = 1; i <= 4; ++i) tval(t, i - 1, ly, lx) = gp[i];
      if (inside) {
        C* go = tr.g_out + (size_t)t * Q7 * n;
        const size_t k2 = (size_t)y * nx + x;
        if (in_run(z)) go[(size_t)cz * nxy + k2] = t_fluid ? gp[0] : C(0);
        if (has_prev) {
          C p5, p6;   // +z, -z of the slab before
          if constexpr (NT > 0) {
            p5 = t_prev[t][0];
            p6 = t_prev[t][1];
          } else {
            p5 = tval(t, 4, ly, lx);
            p6 = tval(t, 5, ly, lx);
          }
          const C g5lo = d > 0 ? p5 : gp[5];
          const C g6hi = d > 0 ? gp[6] : p6;
          if (in_run(lo))
            go[6 * n + (size_t)wrap(lo, nz) * nxy + k2] =
                tracer_slot<S>(6, flo, fhi, g6hi, g5lo, tr.T);
          if (in_run(hi))
            go[5 * n + (size_t)wrap(hi, nz) * nxy + k2] =
                tracer_slot<S>(5, fhi, flo, g5lo, g6hi, tr.T);
        }
        if constexpr (NT > 0) {
          t_prev[t][0] = gp[5];
          t_prev[t][1] = gp[6];
        } else {
          tval(t, 4, ly, lx) = gp[5];
          tval(t, 5, ly, lx) = gp[6];
        }
      }
    }
  };
  // the tile's tracer slots 1-4 (+-x, +-y) of slab z, from the ring of
  // the slab's in-plane values
  auto tracer_stream = [&](int z) {
    if (!inside) return;
    const int s = slot_of(z);
    const unsigned char fx = flag(s, ly, lx);
    const size_t k = (size_t)z * nxy + (size_t)y * nx + x;
#pragma unroll
    for (int t = 0; t < (NT > 0 ? NT : tr.T.nt); ++t) {
      C* go = tr.g_out + (size_t)t * Q7 * n;
#pragma unroll
      for (int i = 1; i <= 4; ++i) {
        const int sx = lx - e7(i, 0), sy = ly - e7(i, 1);
        go[i * n + k] = tracer_slot<S>(i, fx, flag(s, sy, sx), tval(t, i - 1, sy, sx),
                                       tval(t, opp(i) - 1, ly, lx), tr.T);
      }
    }
  };

  // the tracers of a slab collide in the interval after the flow's
  // collision of the slab (beside the flow's pull, the lighter half), and
  // stream in-plane in the next (beside the flow's collision)
  const int first = d > 0 ? z0 : z1 - 1;
  compute_slab(first - d, slot_of(first - d));
  tracer_collide(first - d, false);
  compute_slab(first, slot_of(first));
  tracer_collide(first, true);
  __syncthreads();
  for (int j = 0; j < z1 - z0; ++j) {
    const int z = first + d * j;
    compute_slab(z + d, slot_of(z + d));
    tracer_stream(z);
    __syncthreads();
    tracer_collide(z + d, true);
    const int cur = slot_of(z);
    if (inside) {
      const size_t k = (size_t)z * nxy + (size_t)y * nx + x;
      // o: the streamed total PDF; red: its red part, frac * post_j +
      // w_j e_j . (A, B, C) at the source cell (the blue part is o - red)
      C o[Q], red[Q];
      C rr_new = C(0);
      if ((flag(cur, ly, lx) & kFluid) != 0) {
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          // pull from the upwind cell x - e_i, or bounce back from a solid one
          int slot = (cur - ez(i) + 3) % 3, sx = lx - ex(i), sy = ly - ey(i), j = i;
          if (!(flag(slot, sy, sx) & kFluid)) {
            slot = cur;
            sx = lx;
            sy = ly;
            j = opp(i);
          }
          o[i] = val(slot, j, sy, sx);
          const C seg = C(wq(j)) * (C(ex(j)) * val(slot, Q + 1, sy, sx) +
                                    C(ey(j)) * val(slot, Q + 2, sy, sx) +
                                    C(ez(j)) * val(slot, Q + 3, sy, sx));
          red[i] = val(slot, Q, sy, sx) * o[i] + seg;
          rr_new = rr_new + red[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < Q; ++i) o[i] = red[i] = C(0);
      }
      Cell<C, kCompressed> c;
#pragma unroll
      for (int i = 0; i < Q; ++i) c.f[i] = o[i];
      c.rr = rr_new;
      encode<S, kCompressed>(out, n, k, geo[k] > C(0.5) ? C(1) : C(0), c);
    }
    __syncthreads();
  }
}

// Two blocks an SM in float arithmetic, as the box kernel below: 80
// registers for the compressed instances (as without the bound), and the
// split ones 7.5% faster than at 118 (an H100, PERF.md).
template <typename S, int L, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(RING_THREADS, sizeof(C) == 4 ? 2 : 1)
collide_stream_kernel(State<S> st, const C* __restrict__ geo, const C* __restrict__ fld,
                      S* __restrict__ out, S* __restrict__ out2, Cg3dParams P) {
  collide_stream_body<S, L, false, C>(st, geo, fld, out, out2, P, Box3{});
}

// The local form's collide_stream over the box B.  Its float instance is
// held to two blocks an SM: left free, ptxas gives it 94 registers and one
// block an SM, and the local step ran 1.46x the one-device step at 256^3
// (an H100 measurement, PERF.md).
template <typename S, int L, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(RING_THREADS, sizeof(C) == 4 ? 2 : 1)
collide_stream_box_kernel(State<S> st, const C* __restrict__ geo, const C* __restrict__ fld,
                          S* __restrict__ out, S* __restrict__ out2, Cg3dParams P, Box3 B) {
  collide_stream_body<S, L, true, C>(st, geo, fld, out, out2, P, B);
}

// The coupled step's collide_stream (K9t, compressed): over the domain, or
// (BOX) the box B of the local form; NT tracers (0: tr.T.nt).
template <typename S, bool BOX, int NT, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(RING_THREADS, sizeof(C) == 4 ? 2 : 1)
collide_stream_tracer_kernel(State<S> st, const C* __restrict__ geo, const C* __restrict__ fld,
                             S* __restrict__ out, Cg3dParams P, Box3 B, TracerArgs<C> tr) {
  coupled_stream_body<S, BOX, C, NT>(st, geo, fld, out, P, B, tr);
}

// Launches of bc_kernel, fields_kernel and collide_stream (either form) by
// this library since it was loaded, one where each launch is made;
// cg3d_kernel_launches reads them.
long long g_launches[3];

template <typename C, int L>
constexpr size_t fields_smem_bytes() {
  using FT = FieldTile<L>;
  return sizeof(C) * (16 * FT::QH * FT::QW + 16 * FT::NH * FT::NW);
}

// fields_kernel over the domain or (BOX) the box B: g and kappa into the
// four planes fld.  The z-run is occupancy.cuh's (at most FieldTile<L>::Z):
// a quarter of 128^3 (K12d on a (4, 1) mesh) takes runs of 9 slabs, 1.4x
// faster than runs of 32 that leave three quarters of the card idle
// (PERF.md).
template <typename S, int L, bool BOX = false, typename C = typename Traits<S>::C>
int launch_fields_kernel(const State<S>& st, const C* geo, C* fld, const Cg3dParams& P,
                         cudaStream_t stream, Box3 B = Box3{}) {
  using FT = FieldTile<L>;
  static int capacity = 0;
  constexpr size_t smem = fields_smem_bytes<C, L>();
  if (capacity == 0) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          fields_kernel<S, L, BOX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    cudaError_t err;
    capacity = card_capacity(fields_kernel<S, L, BOX>, FT::THREADS, smem, err);
    if (capacity < 0) {
      capacity = 0;
      return (int)err;
    }
  }
  const int ny = BOX ? B.y1 - B.y0 : P.ny, nz = BOX ? B.z1 - B.z0 : P.nz;
  const long long tiles = (long long)((P.nx + FX - 1) / FX) * ((ny + FT::Y - 1) / FT::Y);
  const int zrun = z_run(capacity, tiles, nz, FT::Z);
  const dim3 grid((P.nx + FX - 1) / FX, (ny + FT::Y - 1) / FT::Y,
                  (unsigned)((nz + zrun - 1) / zrun));
  fields_kernel<S, L, BOX><<<grid, FT::THREADS, smem, stream>>>(st, geo, fld, P, B, zrun);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launches[1];
  return (int)err;
}

// Launches 0 and 1 of a step (the boundary slabs, the fields); with
// boundary slabs, st.bc is set to their scratch.  fld holds g and kappa (4
// planes); bc is the boundary-slab scratch (nullptr without an inlet or
// outlet).
template <typename S, int L, typename C = typename Traits<S>::C>
int launch_fields(State<S>& st, const C* geo, C* fld, S* bc, const Cg3dParams& P,
                  cudaStream_t stream) {
  const size_t nxy = (size_t)P.ny * P.nx;
  const int threads = 256;
  if (bc != nullptr && (P.inlet || P.outlet)) {
    bc_kernel<S, L><<<(unsigned)((nxy + threads - 1) / threads), threads, 0, stream>>>(
        st, geo, bc, P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++g_launches[0];
    st.bc = bc;
  }
  return launch_fields_kernel<S, L>(st, geo, fld, P, stream);
}

// Launch 2, collide_stream, over the domain or (BOX) the box B.  s2_out is
// f_b in the split layout.
template <typename S, int L, bool BOX = false, typename C = typename Traits<S>::C>
int launch_collide_stream(const State<S>& st, const C* geo, const C* fld, void* s_out,
                          void* s2_out, const Cg3dParams& P, cudaStream_t stream,
                          Box3 B = Box3{}) {
  static bool configured = false;
  constexpr size_t smem = smem_bytes<S, L>();
  if (!configured) {
    cudaError_t err;
    if constexpr (BOX)
      err = cudaFuncSetAttribute(collide_stream_box_kernel<S, L>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    else
      err = cudaFuncSetAttribute(collide_stream_kernel<S, L>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int ny = BOX ? B.y1 - B.y0 : P.ny, nz = BOX ? B.z1 - B.z0 : P.nz;
  const dim3 grid((P.nx + TX - 1) / TX, (ny + TY - 1) / TY, (nz + ZC - 1) / ZC);
  if constexpr (BOX)
    collide_stream_box_kernel<S, L><<<grid, RING_THREADS, smem, stream>>>(
        st, geo, fld, static_cast<S*>(s_out), static_cast<S*>(s2_out), P, B);
  else
    collide_stream_kernel<S, L><<<grid, RING_THREADS, smem, stream>>>(
        st, geo, fld, static_cast<S*>(s_out), static_cast<S*>(s2_out), P);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launches[2];
  return (int)err;
}

// The fields alone (launches 0 and 1): g and kappa of the state after its
// boundary slabs into fld.
template <typename S, int L>
int launch_cg3d_fields(const void* s_in, const void* s2_in, const void* geo_v, void* fld_v,
                       void* bc_v, const Cg3dParams& P, cudaStream_t stream) {
  using C = typename Traits<S>::C;
  State<S> st{static_cast<const S*>(s_in), static_cast<const S*>(s2_in), nullptr};
  return launch_fields<S, L>(st, static_cast<const C*>(geo_v), static_cast<C*>(fld_v),
                             static_cast<S*>(bc_v), P, stream);
}

// The step's launches.  s2_in/s2_out are f_b in the split layout.
template <typename S, int L>
int launch_cg3d(const void* s_in, const void* s2_in, void* s_out, void* s2_out,
                const void* geo_v, void* fld_v, void* bc_v, const Cg3dParams& P,
                cudaStream_t stream) {
  using C = typename Traits<S>::C;
  const C* geo = static_cast<const C*>(geo_v);
  C* fld = static_cast<C*>(fld_v);
  State<S> st{static_cast<const S*>(s_in), static_cast<const S*>(s2_in), nullptr};
  const int err = launch_fields<S, L>(st, geo, fld, static_cast<S*>(bc_v), P, stream);
  if (err) return err;
  return launch_collide_stream<S, L>(st, geo, fld, s_out, s2_out, P, stream);
}

// The coupled collide_stream (K9t) over the domain or (BOX) the box B:
// g, g_out (NT, 7, ...) and tab as TracerArgs takes them.  A launch takes
// as many tracers as the card's shared memory per block holds beside the
// ring (16 in float arithmetic, 2 in double); above that, each further
// group of tracers is one more launch, which writes the same flow values
// again.  Its z-run is occupancy.cuh's (at most ZC) at the first group's
// shared memory: a K12d shard's quarter of 128^3 takes runs of 8, which
// fill the card that runs of 16 left half idle.
template <typename S, bool BOX = false, typename C = typename Traits<S>::C>
int launch_coupled_stream(const State<S>& st, const C* geo, const C* fld, void* s_out,
                          const Cg3dParams& P, cudaStream_t stream, Box3 B, const C* g,
                          C* g_out, const C* tab, const Tracer3dParams& T) {
  constexpr size_t base = tracer_offset<S>(), per = tracer_bytes<C>();
  static int limit = 0;              // shared memory bytes a block may take
  static size_t configured[2] = {};  // the largest request set so far, by instance
  static int capacity[2] = {};       // blocks the card holds at once, by instance,
  static size_t counted[2] = {};     // at this shared memory
  cudaError_t err;
  if (limit == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if ((size_t)limit < base + per) return (int)cudaErrorInvalidConfiguration;
  const int group = (int)(((size_t)limit - base) / per);
  // one tracer takes the instance that knows its count
  auto kernel_of = [](int nt) {
    return nt == 1 ? collide_stream_tracer_kernel<S, BOX, 1>
                   : collide_stream_tracer_kernel<S, BOX, 0>;
  };
  auto smem_of = [&](int nt) { return base + (size_t)nt * per; };
  auto configure = [&](int nt) {
    const int inst = nt == 1 ? 1 : 0;
    if (smem_of(nt) <= configured[inst]) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel_of(nt), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_of(nt));
    if (e == cudaSuccess) configured[inst] = smem_of(nt);
    return e;
  };
  const int nt0 = T.nt < group ? T.nt : group, inst0 = nt0 == 1 ? 1 : 0;
  if ((err = configure(nt0)) != cudaSuccess) return (int)err;
  if (counted[inst0] != smem_of(nt0)) {
    capacity[inst0] = card_capacity(kernel_of(nt0), RING_THREADS, smem_of(nt0), err);
    if (capacity[inst0] < 0) return (int)err;
    counted[inst0] = smem_of(nt0);
  }
  const int ny = BOX ? B.y1 - B.y0 : P.ny, nz = BOX ? B.z1 - B.z0 : P.nz;
  const long long tiles = (long long)((P.nx + TX - 1) / TX) * ((ny + TY - 1) / TY);
  const int zrun = z_run(capacity[inst0], tiles, nz, ZC);
  const dim3 grid((P.nx + TX - 1) / TX, (ny + TY - 1) / TY, (unsigned)((nz + zrun - 1) / zrun));
  const size_t n = (size_t)P.nz * P.ny * P.nx;
  for (int t0 = 0; t0 == 0 || t0 < T.nt; t0 += group) {
    Tracer3dParams Tg = T;
    Tg.nt = T.nt - t0 < group ? T.nt - t0 : group;
    if ((err = configure(Tg.nt)) != cudaSuccess) return (int)err;
    const size_t off = (size_t)t0 * Q7 * n;
    const auto kernel = kernel_of(Tg.nt);
    kernel<<<grid, RING_THREADS, smem_of(Tg.nt), stream>>>(
        st, geo, fld, static_cast<S*>(s_out), P, B,
        TracerArgs<C>{g + off, g_out + off, tab + (size_t)t0 * kTracerRow, Tg, zrun});
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++g_launches[2];
  }
  return 0;
}

// The coupled step's launches (compressed layout): K9's boundary slabs and
// fields, then the coupled collide_stream.  g_in and g_out are (NT, 7, nz,
// ny, nx) in the compute type, tab the (NT, 8) tracer table.
template <typename S>
int launch_cg3d_coupled(const void* s_in, void* s_out, const void* geo_v, void* fld_v,
                        void* bc_v, const void* g_in, void* g_out, const void* tab_v,
                        const Cg3dParams& P, const Tracer3dParams& T, cudaStream_t stream) {
  using C = typename Traits<S>::C;
  const C* geo = static_cast<const C*>(geo_v);
  C* fld = static_cast<C*>(fld_v);
  State<S> st{static_cast<const S*>(s_in), nullptr, nullptr};
  const int err = launch_fields<S, kCompressed>(st, geo, fld, static_cast<S*>(bc_v), P, stream);
  if (err) return err;
  return launch_coupled_stream<S>(st, geo, fld, s_out, P, stream, Box3{},
                                  static_cast<const C*>(g_in), static_cast<C*>(g_out),
                                  static_cast<const C*>(tab_v), T);
}

}  // namespace
