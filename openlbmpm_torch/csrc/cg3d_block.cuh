// Temporally blocked D3Q19 CSF colour-gradient step (K9-T) for NVIDIA Hopper
// (sm_90a), T time steps a launch.  Each of cg3d_block_f64.cu,
// cg3d_block_f32.cu and cg3d_block_bf16.cu instantiates one storage type.
//
// Replaces the TPU kernel openlbmpm_tpu/pallas/cg3d.py::build_cg3d_fused_step
// with steps_per_call = T > 1 (:235-238, the kernel :881-958): the
// compressed state (f_total, rho_r) in f32 / f64 (K9-Tc) and bf16 (K9-Th,
// decoded to f32 once a call and encoded once), and the split state
// (f_r, f_b) in f32 / f64 (K9-Ts).  Before every sub-step the boundary
// slabs apply inside the window, selected by GLOBAL z (the TPU kernel's
// zrows = (i0 R - H + z) mod nz): the NEBB velocity inlet on slab nz-2 and
// its ghost nz-1, which copies the updated nz-2; the convective outlet
// copying slab 3 -> 2, then 2 -> 1, then 1 -> 0, each from the updated
// slab above; or the NEBB pressure outlet on slab 1 and its ghost 0.  The
// compressed rewrite moves rho_r by the slab's red fraction of the change
// (_apply_bcs_window_c :557), the split one splits each new population by
// that fraction (_apply_bcs_window :624): the two layouts part on a mixed
// slab, and each keeps its own.  Then the physics sub-step of the one-step
// kernel, from cg3d.cuh's device functions (cell_phase, extrapolated_phi,
// phi_gradient, rotate_akai, inward_normal, curvature_of, collide_core,
// red_part): the jnp formulas (the Akai rotation with its distance
// comparison), not the TPU kernel's rsqrt and squared-distance tie test.
//
// Window.  Each block owns a brick of tx x ty x tz cells and loads a window
// around it once a call, wrapping periodically, with a halo of hx = 4T
// cells on every x and y side, hzlo = (4 + blo) T below and hzhi = (4 +
// bhi) T above.  A physics sub-step reaches 4 cells (phi and its solid
// extrapolation, the gradient and normal, the curvature, collision and
// streaming); the boundary slabs reach blo = 1 slab below (the inlet's
// ghost copy reads nz-2) and bhi = 3 above (the convective cascade: slab 0
// ends as slab 3's value) or 1 (the pressure outlet's ghost copy), and only
// in z.  (The TPU kernel shrinks by one slab a side for the slabs, shrink =
// 5 at :787, which covers the cascade only while its windows' edges avoid
// slabs 1 and 2.)  Sub-step s works on the window shrunk by 4s in x and y
// and by (4 + blo) s, (4 + bhi) s in z, so no stencil reads outside the
// window and the brick is exact after T sub-steps.
//
// Window planes (compute type): the state (20 compressed, 38 split), then
// phi, g (3), n (3) and kappa; then one flag byte a cell (1 fluid, 2 wet).
// A sub-step, one barrier after each stage: boundary slabs (one thread a
// (y, x) column, in the reference's order), phi, its extrapolation onto
// solid cells (wetting walls only), gradient and normal, curvature, the
// collision (post-collision population i into slot opp(i) of the first 19
// state planes; frac, A, B, Cz over phi and g), block3d.cuh's in-place swap
// streaming, then rho_r' (compressed) or the colour split (split) from the
// streamed populations and the recolouring terms of each source cell.
// The windows live in global scratch (kGmem3Blocks resident blocks, the
// grid looping over the bricks): at 28 values a cell, a brick of 128 cells
// at T = 2 needs a window of ~20k cells, some 2.3 MB in f32, far over the
// 227 KB of shared memory.
//
// What bounds it: HBM bytes per cell-step are the state read once and
// written once a call, plus the 4 geometry planes, over T: 161 / T B
// (compressed f32), 85 / T (bf16), 305 / T (split f32).  What sets its
// pace instead is the window: with a halo of 4T-7T cells a side, every
// sub-step recomputes a window several times the brick, each stage a pass
// over it through L2 and HBM.

#pragma once

#include "cg3d.cuh"
#include "block3d.cuh"

namespace {

// A launch's tiling, computed on the host (cg3d_block_shape) and passed by
// value.
struct Cg3dBlockShape {
  int T;
  int blo, bhi;          // z slabs the boundary slabs consume below / above
  int tx, ty, tz;        // brick
  int hx, hzlo, hzhi;    // halo: each x and y side, below and above in z
  int wx, wy, wz;        // window
  int ntx, nty, ntz;     // bricks in x, y and z
  int grid;              // blocks launched
  size_t win_bytes;      // bytes of one window (planes, then the flag bytes)
};

// The brick (x, y, z), chosen by measurement over 32x16x16, 32x32x16,
// 64x16x8 and 16x16x16 on the H100 (PERF.md).
constexpr int kCg3dBrickX = 32, kCg3dBrickY = 16, kCg3dBrickZ = 16;

template <int L>
__host__ __device__ constexpr int cg3d_state_planes() {
  return L == kSplit ? 2 * Q : Q + 1;
}

// The tiling of T sub-steps of layout L in compute values of csize bytes,
// with at most `blocks` resident blocks.
template <int L>
__host__ inline Cg3dBlockShape cg3d_block_shape(const Cg3dParams& P, int T, int csize,
                                                int blocks) {
  Cg3dBlockShape b{};
  b.T = T;
  b.blo = P.inlet ? 1 : 0;
  b.bhi = P.outlet == 1 ? 3 : (P.outlet == 2 ? 1 : 0);
  b.tx = kCg3dBrickX;
  b.ty = kCg3dBrickY;
  b.tz = kCg3dBrickZ;
  b.hx = 4 * T;
  b.hzlo = (4 + b.blo) * T;
  b.hzhi = (4 + b.bhi) * T;
  b.wx = b.tx + 2 * b.hx;
  b.wy = b.ty + 2 * b.hx;
  b.wz = b.tz + b.hzlo + b.hzhi;
  b.ntx = (P.nx + b.tx - 1) / b.tx;
  b.nty = (P.ny + b.ty - 1) / b.ty;
  b.ntz = (P.nz + b.tz - 1) / b.tz;
  const size_t cells = (size_t)b.wx * b.wy * b.wz;
  b.win_bytes = align16(cells * (cg3d_state_planes<L>() + 8) * csize) + align16(cells);
  const int bricks = b.ntx * b.nty * b.ntz;
  b.grid = bricks < blocks ? bricks : blocks;
  return b;
}

__device__ __forceinline__ Box box_of(int x0, int x1, int y0, int y1, int z0, int z1,
                                      const Cg3dBlockShape& B) {
  return Box{x0, x1, y0, y1, z0, z1, B.wx, B.wy, B.wz};
}

__device__ __forceinline__ Box shrink(const Box& r, int e) {
  return Box{r.x0 + e, r.x1 - e, r.y0 + e, r.y1 - e, r.z0 + e, r.z1 - e, r.wx, r.wy, r.wz};
}

template <typename S, int L, typename C = typename Traits<S>::C>
__global__ void __launch_bounds__(kBlock3Threads)
cg3d_block_kernel(const S* __restrict__ s_in, const S* __restrict__ s2_in,
                  const C* __restrict__ geo, S* __restrict__ s_out, S* __restrict__ s2_out,
                  Cg3dParams P, Cg3dBlockShape B, unsigned char* __restrict__ scratch) {
  constexpr int NS = cg3d_state_planes<L>();
  constexpr int PHI = NS, GR = NS + 1, NR = NS + 4, KAP = NS + 7;
  unsigned char* base = scratch + (size_t)blockIdx.x * B.win_bytes;
  C* W = reinterpret_cast<C*>(base);
  const int wx = B.wx, wy = B.wy;
  const size_t PL = (size_t)wx * wy * B.wz;
  unsigned char* FL = base + align16(PL * (NS + 8) * sizeof(C));
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const size_t nxy = (size_t)ny * nx;
  const size_t n = (size_t)nz * nxy;
  const int sxy = wx * wy;
  auto at = [&](int p, int c) -> C& { return W[(size_t)p * PL + c]; };
  auto nb = [&](int c, int i) { return c + (ez(i) * wy + ey(i)) * wx + ex(i); };
  auto fluid = [&](int c) { return (FL[c] & 1) != 0; };
  auto get = [&](int c, Cell<C, L>& x) {
    if constexpr (L == kSplit) {
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        x.r[i] = at(i, c);
        x.b[i] = at(Q + i, c);
      }
    } else {
#pragma unroll
      for (int i = 0; i < Q; ++i) x.f[i] = at(i, c);
      x.rr = at(Q, c);
    }
  };
  auto put = [&](int c, const Cell<C, L>& x) {
    if constexpr (L == kSplit) {
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        at(i, c) = x.r[i];
        at(Q + i, c) = x.b[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < Q; ++i) at(i, c) = x.f[i];
      at(Q, c) = x.rr;
    }
  };
  auto for_box = [&](const Box& r, auto&& fn) {
    const int v = r.volume();
    for (int t = threadIdx.x; t < v; t += kBlock3Threads) {
      int lx, ly, lz;
      r.at(t, lx, ly, lz);
      fn(lx, ly, lz, r.cell(lx, ly, lz));
    }
  };
  const State<S> st{s_in, s2_in, nullptr};

  for (int tile = blockIdx.x; tile < B.ntx * B.nty * B.ntz; tile += gridDim.x) {
    const int x0 = (tile % B.ntx) * B.tx, y0 = (tile / B.ntx % B.nty) * B.ty;
    const int z0 = tile / (B.ntx * B.nty) * B.tz;
    const int ox = x0 - B.hx, oy = y0 - B.hx, oz = z0 - B.hzlo;
    auto gidx = [&](int lx, int ly, int lz) {
      return (size_t)wrap3(oz + lz, nz) * nxy + (size_t)wrap3(oy + ly, ny) * nx +
             wrap3(ox + lx, nx);
    };

    // decode the window once
    for (int c = threadIdx.x; c < (int)PL; c += kBlock3Threads) {
      const int lx = c % wx, ly = c / wx % wy, lz = c / sxy;
      const int gz = wrap3(oz + lz, nz), gy = wrap3(oy + ly, ny), gx = wrap3(ox + lx, nx);
      const C code = geo[(size_t)gz * nxy + (size_t)gy * nx + gx];
      FL[c] = (code > C(0.5) ? 1 : 0) | (code > C(1.5) ? 2 : 0);
      Cell<C, L> x;
      load_cell<S, L>(st, geo, P, gz, gy, gx, x);
      put(c, x);
    }
    __syncthreads();

    for (int sub = 0; sub < B.T; ++sub) {
      const int e = 4 * sub;
      int zlo = (4 + B.blo) * sub, zhi = B.wz - (4 + B.bhi) * sub;
      if (P.inlet || P.outlet) {
        // the boundary slabs, one thread a (y, x) column of the valid box
        const int w = wx - 2 * e, cols = w * (wy - 2 * e);
        for (int t = threadIdx.x; t < cols; t += kBlock3Threads) {
          const int lx = e + t % w, ly = e + t / w;
          auto cell = [&](int lz) { return (lz * wy + ly) * wx + lx; };
          // fn(lz) for each window slab of the valid range holding global slab zg
          auto each = [&](int zg, auto&& fn) {
            for (int lz = wrap3(zg - oz, nz); lz < zhi; lz += nz)
              if (lz >= zlo) fn(lz);
          };
          auto copy = [&](int dst, int src) {
            if (!fluid(cell(dst)) || src < zlo || src >= zhi) return;
            for (int p = 0; p < NS; ++p) at(p, cell(dst)) = at(p, cell(src));
          };
          auto nebb = [&](int lz, bool inlet) {
            if (!fluid(cell(lz))) return;
            Cell<C, L> x;
            get(cell(lz), x);
            rewrite(x, P, inlet);
            put(cell(lz), x);
          };
          if (P.inlet == 1) {
            each(nz - 2, [&](int lz) { nebb(lz, true); });
            each(nz - 1, [&](int lz) { copy(lz, lz - 1); });
          }
          if (P.outlet == 1) {
            for (int k = 2; k >= 0; --k) each(k, [&](int lz) { copy(lz, lz + 1); });
          } else if (P.outlet == 2) {
            each(1, [&](int lz) { nebb(lz, false); });
            each(0, [&](int lz) { copy(lz, lz + 1); });
          }
        }
        __syncthreads();
        zlo += B.blo;
        zhi -= B.bhi;
      }
      const Box r0 = box_of(e, wx - e, e, wy - e, zlo, zhi, B);

      // phi (0 on solid cells)
      for_box(r0, [&](int, int, int, int c) {
        C v = C(0);
        if (fluid(c)) {
          Cell<C, L> x;
          get(c, x);
          v = cell_phase(x);
        }
        at(PHI, c) = v;
      });
      __syncthreads();
      if (P.has_wetting) {
        // phi extended onto solid cells, in place (reads fluid cells only)
        for_box(shrink(r0, 1), [&](int, int, int, int c) {
          if (fluid(c)) return;
          at(PHI, c) = extrapolated_phi<C>([&](int i) { return fluid(nb(c, i)); },
                                           [&](int i) { return at(PHI, nb(c, i)); });
        });
        __syncthreads();
      }
      // the colour gradient (rotated on wetting fluid cells) and the normal
      for_box(shrink(r0, 2), [&](int lx, int ly, int lz, int c) {
        C g[3], nv[3];
        phi_gradient<C>([&](int i) { return at(PHI, nb(c, i)); }, g);
        if (P.has_wetting && (FL[c] & 2)) {
          const size_t k = gidx(lx, ly, lz);
          const C ns[3] = {geo[n + k], geo[2 * n + k], geo[3 * n + k]};
          rotate_akai(g, ns, P);
        }
        inward_normal(g, fluid(c) ? C(1) : C(0), nv);
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          at(GR + d, c) = g[d];
          at(NR + d, c) = nv[d];
        }
      });
      __syncthreads();
      // the curvature of fluid cells
      const Box r3 = shrink(r0, 3);
      for_box(r3, [&](int, int, int, int c) {
        C kappa = C(0);
        if (fluid(c)) {
          const C nh[3] = {at(NR, c), at(NR + 1, c), at(NR + 2, c)};
          kappa = curvature_of([&](int i, int b) { return at(NR + b, nb(c, i)); }, nh);
        }
        at(KAP, c) = kappa;
      });
      __syncthreads();
      // the collision: post_i into slot opp(i), frac and (A, B, Cz) over phi
      // and g (each cell reads and writes only its own values)
      for_box(r3, [&](int, int, int, int c) {
        C post[Q], frac = C(0), A = C(0), Bv = C(0), Cz = C(0);
        if (fluid(c)) {
          Cell<C, L> x;
          get(c, x);
          const C g[3] = {at(GR, c), at(GR + 1, c), at(GR + 2, c)};
          collide_core(x, at(PHI, c), g, at(KAP, c), P, post, frac, A, Bv, Cz);
        } else {
#pragma unroll
          for (int i = 0; i < Q; ++i) post[i] = C(0);
        }
#pragma unroll
        for (int i = 0; i < Q; ++i) at(opp(i), c) = post[i];
        at(PHI, c) = frac;
        at(GR, c) = A;
        at(GR + 1, c) = Bv;
        at(GR + 2, c) = Cz;
      });
      __syncthreads();
      swap_stream(W, PL, 1, FL, r3);
      __syncthreads();
      // slot i now holds the streamed population o_i: pulled from x - e_i,
      // or bounced back (post_opp(i) of the cell itself) where that is
      // solid; its red part takes the source cell's recolouring terms
      for_box(shrink(r0, 4), [&](int, int, int, int c) {
        const bool fl = fluid(c);
        C rr = C(0);
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          C o = C(0), red = C(0);
          if (fl) {
            int src = nb(c, opp(i)), j = i;
            if (!fluid(src)) {
              src = c;
              j = opp(i);
            }
            o = at(i, c);
            red = red_part(j, o, at(PHI, src), at(GR, src), at(GR + 1, src), at(GR + 2, src));
            rr = rr + red;
          }
          if constexpr (L == kSplit) {
            at(i, c) = red;
            at(Q + i, c) = o - red;
          }
        }
        if constexpr (L == kCompressed) at(Q, c) = rr;
      });
      __syncthreads();
    }

    // encode the brick once
    for (int t = threadIdx.x; t < B.tx * B.ty * B.tz; t += kBlock3Threads) {
      const int bx = t % B.tx, by = t / B.tx % B.ty, bz = t / (B.tx * B.ty);
      if (x0 + bx >= nx || y0 + by >= ny || z0 + bz >= nz) continue;
      const int c = ((B.hzlo + bz) * wy + B.hx + by) * wx + B.hx + bx;
      const size_t k = (size_t)(z0 + bz) * nxy + (size_t)(y0 + by) * nx + x0 + bx;
      if constexpr (L == kSplit) {
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          s_out[i * n + k] = at(i, c);
          s2_out[i * n + k] = at(Q + i, c);
        }
      } else {
        Cell<C, kCompressed> x;
        get(c, x);
        encode<S, kCompressed>(s_out, n, k, fluid(c) ? C(1) : C(0), x);
      }
    }
    __syncthreads();
  }
}

template <typename S, int L>
Cg3dBlockShape cg3d_block_tiling(const Cg3dParams& P, int T) {
  using C = typename Traits<S>::C;
  return cg3d_block_shape<L>(P, T, (int)sizeof(C), kGmem3Blocks);
}

template <typename S, int L>
int launch_cg3d_block_l(const void* s_in, const void* s2_in, void* s_out, void* s2_out,
                        const void* geo, void* scratch, const Cg3dParams& P,
                        const Cg3dBlockShape& B, cudaStream_t st) {
  using C = typename Traits<S>::C;
  cg3d_block_kernel<S, L><<<B.grid, kBlock3Threads, 0, st>>>(
      static_cast<const S*>(s_in), static_cast<const S*>(s2_in), static_cast<const C*>(geo),
      static_cast<S*>(s_out), static_cast<S*>(s2_out), P, B,
      static_cast<unsigned char*>(scratch));
  return (int)cudaGetLastError();
}

// Whether (split, T) names a launch this storage type takes.
template <typename S>
bool cg3d_block_takes(int split, int T) {
  if (split && Traits<S>::kShifted) return false;   // no split bf16 layout
  return (split == 0 || split == 1) && T >= 1 && T <= kMaxSteps3;
}

template <typename S>
Cg3dBlockShape cg3d_block_shape_of(int split, int T, const Cg3dParams& P) {
  return split ? cg3d_block_tiling<S, kSplit>(P, T)
               : cg3d_block_tiling<S, kCompressed>(P, T);
}

// T steps a launch; split = 0: the compressed state in s_in / s_out, 1:
// f_r in s_in / s_out and f_b in s2_in / s2_out.  scratch holds
// cg3d_block_scratch bytes.
template <typename S>
int launch_cg3d_block(int split, int T, const void* s_in, const void* s2_in, void* s_out,
                      void* s2_out, const void* geo, void* scratch, const Cg3dParams& P,
                      cudaStream_t st) {
  if (!cg3d_block_takes<S>(split, T) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const Cg3dBlockShape B = cg3d_block_shape_of<S>(split, T, P);
  if constexpr (!Traits<S>::kShifted) {
    if (split)
      return launch_cg3d_block_l<S, kSplit>(s_in, s2_in, s_out, s2_out, geo, scratch, P, B, st);
  }
  return launch_cg3d_block_l<S, kCompressed>(s_in, s2_in, s_out, s2_out, geo, scratch, P, B,
                                            st);
}

}  // namespace

// The C entry points of one storage type S (the library's).
#define CG3D_BLOCK_ENTRY_POINTS(S)                                                          \
  extern "C" int cg3d_block_step(int split, int T, const void* s_in, const void* s2_in,     \
                                 void* s_out, void* s2_out, const void* geo, void* scratch, \
                                 const Cg3dParams* params, void* stream) {                  \
    return launch_cg3d_block<S>(split, T, s_in, s2_in, s_out, s2_out, geo, scratch,         \
                                *params, static_cast<cudaStream_t>(stream));                \
  }                                                                                         \
  extern "C" long long cg3d_block_scratch_bytes(int split, int T,                           \
                                                const Cg3dParams* params) {                 \
    if (!cg3d_block_takes<S>(split, T)) return -1;                                          \
    const Cg3dBlockShape B = cg3d_block_shape_of<S>(split, T, *params);                     \
    return (long long)B.grid * (long long)B.win_bytes;                                      \
  }                                                                                         \
  extern "C" int cg3d_block_shape(int split, int T, const Cg3dParams* params,               \
                                  long long* shape) {                                       \
    if (!cg3d_block_takes<S>(split, T)) return (int)cudaErrorInvalidValue;                  \
    const Cg3dBlockShape B = cg3d_block_shape_of<S>(split, T, *params);                     \
    const long long v[8] = {B.tx, B.ty, B.tz, B.hx, B.hzlo, B.hzhi, B.grid,                 \
                            (long long)B.win_bytes};                                        \
    for (int i = 0; i < 8; ++i) shape[i] = v[i];                                            \
    return 0;                                                                               \
  }                                                                                         \
  extern "C" const char* cg3d_block_error_string(int code) {                                \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                              \
  }
