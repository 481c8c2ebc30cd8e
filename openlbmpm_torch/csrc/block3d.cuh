// Temporal blocking of the 3-D single-phase step for NVIDIA Hopper
// (sm_90a): the window machinery of flow3d_block.cuh's K11-T.  Include it
// after the step's own header (flow3d.cuh), which defines Q, ex, ey, ez and
// opp of D3Q19 (the lattice's order: opposite pairs (1, 2), (3, 4), ...
// (17, 18)).  (K10-T and K9-T march along z instead: march3d.cuh.)
//
// Replaces the TPU kernel's z-slab windows (pallas/single3d.py with
// steps_per_call = T > 1).  One launch advances T steps of a domain
// periodic in x, y and z (walls come only from the mask).  Each block owns
// a brick of tx x ty x tz cells and loads a window around it, h = ring * T
// cells on every side, wrapping periodically; ring = the cells one
// sub-step's stencils reach (single-phase 1: streaming).  The state is
// decoded to the compute type into the window once, the block runs T
// sub-steps there, and only the brick is encoded and written back.  Stage
// j of sub-step s runs on the window shrunk by ring * s + j cells on every
// side, so no stencil reads outside the window and the brick is exact
// after T sub-steps.
//
// Streaming is in place and needs no second buffer and no registers (the
// swap scheme, Mattila et al. 2007): the collision stores each cell's
// post-collision population i in slot opp(i), and then, for every fluid
// cell x of the region and every pair (i, opp(i)) with i odd whose upwind
// cell x - e_i is fluid, slot i of x and slot opp(i) of x - e_i swap.
// Each (cell, slot) belongs to exactly one swap, so the pass has no races
// and one barrier; a slot whose partner is solid keeps its value, which is
// the half-way bounce-back.  Solid cells hold 0 (the collision writes it),
// as the one-step kernels leave them.
//
// The window lives in dynamic shared memory when a brick of 128 cells or
// more fits (232,448 bytes a block); otherwise in a global scratch buffer,
// one window per resident block, with the grid looping over the bricks.
// The same code serves both (generic pointers).  The largest T is
// kMaxSteps3; a launch beyond it is refused.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBlock3Threads = 256;  // threads a block
constexpr int kMaxSteps3 = 8;        // the largest T a launch takes
constexpr size_t kSmem3Max = 232448;  // dynamic shared memory a block can opt into
constexpr int kGmem3Blocks = 264;    // resident blocks with a global window

// A launch's tiling, computed on the host (block_shape3) and passed by
// value.
struct BlockShape3 {
  int T, ring;           // sub-steps, rings a sub-step
  int tx, ty, tz;        // brick
  int h;                 // halo cells on every side (ring * T)
  int wx, wy, wz;        // window
  int ntx, nty, ntz;     // bricks in x, y and z
  int gmem;              // 1: the windows live in global scratch
  int grid;              // blocks launched
  size_t win_bytes;      // bytes of one window (planes, then the fluid bytes)
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// v mod n for any v (a window's halo may pass a small domain several times)
__device__ __forceinline__ int wrap3(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// The tiling of an nz x ny x nx domain for T sub-steps of `ring` rings, for
// a window of `planes` compute values of `csize` bytes a cell plus a fluid
// byte: the largest brick of a fixed list (at least 128 cells) whose window
// fits shared memory, else a 16 x 8 x 8 brick in global scratch.
__host__ inline BlockShape3 block_shape3(int nz, int ny, int nx, int T, int ring, int planes,
                                         int csize) {
  static const int cand[][3] = {{32, 8, 8}, {16, 8, 8}, {16, 8, 4}, {8, 8, 4}, {8, 4, 4}};
  static const int global_brick[3] = {16, 8, 8};
  BlockShape3 b{};
  b.T = T;
  b.ring = ring;
  b.h = ring * T;
  auto bytes = [&](const int* c) {
    const size_t cells = (size_t)(c[0] + 2 * b.h) * (c[1] + 2 * b.h) * (c[2] + 2 * b.h);
    return align16(cells * planes * csize) + align16(cells);
  };
  const int* pick = nullptr;
  for (const auto& c : cand)
    if (bytes(c) <= kSmem3Max) {
      pick = c;
      break;
    }
  b.gmem = pick == nullptr;
  if (b.gmem) pick = global_brick;
  b.tx = pick[0];
  b.ty = pick[1];
  b.tz = pick[2];
  b.wx = b.tx + 2 * b.h;
  b.wy = b.ty + 2 * b.h;
  b.wz = b.tz + 2 * b.h;
  b.ntx = (nx + b.tx - 1) / b.tx;
  b.nty = (ny + b.ty - 1) / b.ty;
  b.ntz = (nz + b.tz - 1) / b.tz;
  b.win_bytes = bytes(pick);
  const int bricks = b.ntx * b.nty * b.ntz;
  b.grid = b.gmem ? (bricks < kGmem3Blocks ? bricks : kGmem3Blocks) : bricks;
  return b;
}

// A box of window cells [x0, x1) x [y0, y1) x [z0, z1): the window shrunk
// by e on every side; at(t) gives the coordinates of its t-th cell (x
// fastest), cell() a cell's window index.
struct Box {
  int x0, x1, y0, y1, z0, z1, wx, wy, wz;
  __device__ int volume() const { return (x1 - x0) * (y1 - y0) * (z1 - z0); }
  __device__ void at(int t, int& lx, int& ly, int& lz) const {
    const int w = x1 - x0, hgt = y1 - y0;
    lx = x0 + t % w;
    ly = y0 + (t / w) % hgt;
    lz = z0 + t / (w * hgt);
  }
  __device__ int cell(int lx, int ly, int lz) const { return (lz * wy + ly) * wx + lx; }
};

__device__ __forceinline__ Box shrunk3(const BlockShape3& B, int e) {
  return Box{e, B.wx - e, e, B.wy - e, e, B.wz - e, B.wx, B.wy, B.wz};
}

// The swap pass of in-place pull streaming with half-way bounce-back over
// box r, on `sets` sets of 19 planes (set k's plane i at (k Q + i) PL),
// which hold the post-collision populations in the opposite slots.
template <typename C>
__device__ void swap_stream(C* W, size_t PL, int sets, const unsigned char* __restrict__ FL,
                            const Box& r) {
  for (int t = threadIdx.x; t < r.volume(); t += kBlock3Threads) {
    int lx, ly, lz;
    r.at(t, lx, ly, lz);
    const int c = r.cell(lx, ly, lz);
    if (!FL[c]) continue;
#pragma unroll
    for (int i = 1; i < Q; i += 2) {
      const int sx = lx - ex(i), sy = ly - ey(i), sz = lz - ez(i);
      if (sx < 0 || sx >= r.wx || sy < 0 || sy >= r.wy || sz < 0 || sz >= r.wz) continue;
      const int cs = r.cell(sx, sy, sz);
      if (!FL[cs]) continue;
      for (int k = 0; k < sets; ++k) {
        C* a = W + ((size_t)k * Q + i) * PL + c;
        C* b = W + ((size_t)k * Q + opp(i)) * PL + cs;
        const C v = *a;
        *a = *b;
        *b = v;
      }
    }
  }
}

}  // namespace
