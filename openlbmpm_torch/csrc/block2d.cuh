// Temporal blocking of the 2-D steps for NVIDIA Hopper (sm_90a): the
// window machinery shared by csf2d_block.cuh (K3), coupled2d_block.cuh
// (K5c-T), sc2d_block.cuh (K8-T) and single2d_block.cuh (K7-T).  Include it after the step's own header
// (csf2d.cuh, sc2d.cuh or single2d.cuh), which defines ex, ey, opp and wrap.
//
// Replaces the TPU kernels' strip windows (pallas/csf.py, shanchen.py,
// single.py with steps_per_call = T > 1).  One launch advances T steps.
// Each block owns a tile of tx x ty cells and loads a window around it:
// hx columns on each side, hlo rows below and hhi rows above, wrapping
// periodically in x and y.  hx = ring * T, ring = the cells one sub-step's
// stencils reach (CSF 4, Perturbation 2, Shan-Chen reach + 1, single-phase
// 1).  The state is decoded to the compute type into the window once, the
// block runs T sub-steps there, and only the tile is encoded and written
// back.  Sub-step s computes stage j on the window shrunk by ring * s + j
// cells on every side, so no stencil reads outside the window and the
// tile is exact after T sub-steps.
//
// Boundary rows are rewritten inside the window by global row
// ((window row + oy) mod ny), so every window that holds a boundary row,
// a wrapped halo row included, rewrites it alike.  A row copy reads a
// source row up to m rows further from the tile (the convective outlet's
// row 3, the inlet ghost's row ny-2 below ny-1).  Where the valid edge of
// the window passes through such a band, the band's rows go stale; that
// happens once per band, since the edge only moves inwards, so hhi and
// hlo carry the band's reach m once for each copy of the band the halo can
// meet (block_shape).
//
// The streaming pass is in place: one pair of opposite directions at a
// time, every thread pulls its cells' two values into registers, the
// block synchronises, then writes them (stream_pair).  So one state buffer
// suffices, and a window holds at most kMaxWindow cells: the launchers
// refuse a T whose smallest window exceeds that (CSF past T = 9, the
// single-phase step past T = 36).
//
// The window lives in dynamic shared memory when it fits (232,448 bytes a
// block); otherwise (the f64 instances, and the widest f32 ones) in a
// global scratch buffer, one window per resident block, with the grid
// looping over the tiles.  The same code serves both (generic pointers).
//
// The local form (one shard of a decomposed domain, K12a and K12b: the
// TPU kernels' local_ny / local_nx builds, pallas/csf.py:1572-1590,
// :1895-1920, pallas/single.py:418) is the same window with another load
// map.  A shard's state lives in a padded buffer (LocalGrid): its centre,
// then a frame of rows below and above and, on a mesh with an x axis,
// columns on each side, which the exchange (openlbmpm_torch/parallel/
// mesh.py) fills with the neighbouring shards' cells before a launch.  The
// tiles cover the centre only, a window reads the buffer without wrapping
// in y (nor in x with an x frame), and boundary rows are found by global
// row, wrap(row0 + local row, ny).  A window cell beyond the buffer (the
// last tiles' rounding) is clamped to its edge: it lies beyond the frame,
// so outside the reach of any centre cell.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBlockThreads = 512;   // threads a block
constexpr int kCellsPerThread = 12;  // window cells a thread holds in the stream pass
constexpr int kMaxWindow = kBlockThreads * kCellsPerThread;
constexpr size_t kSmemMax = 232448;  // dynamic shared memory a block can opt into
constexpr int kGmemBlocks = 264;     // resident blocks with a global window

// A launch's tiling, computed on the host (block_shape) and passed by
// value.
struct BlockShape {
  int T, ring;       // sub-steps, rings a sub-step
  int tx, ty;        // tile
  int hx, hlo, hhi;  // halo columns each side, rows below and above
  int wx, wy;        // window
  int ntx, nty;      // tiles in x and y
  int gmem;          // 1: the windows live in global scratch
  int grid;          // blocks launched
  size_t win_bytes;  // bytes of one window (planes, then the fluid bytes)
};

// Rows of halo beyond ring * T for a band of boundary rows whose copies
// reach m rows outwards: m for each copy of the band the halo can cross
// (a halo longer than ny meets the band again).  ny is the global row
// count: the bands repeat every ny rows, not every shard.
__host__ inline int band_margin(int ring_rows, int m, int ny) {
  if (m == 0) return 0;
  int copies = 1;
  while ((ring_rows + m * copies) / ny + 1 > copies) ++copies;
  return m * copies;
}

// The tiling of an ny x nx domain for T sub-steps of `ring` rings, with
// boundary bands reaching mlo rows below and mhi rows above, for a window
// of `planes` compute values of `csize` bytes a cell plus a fluid byte.
// Takes the largest tile (of a fixed list, at least 128 cells) whose window
// fits shared memory and the stream pass's registers; else a global window
// for the largest tile within the stream pass's registers.  A local launch
// tiles its shard's ny x nx centre and gives the global row count gny for
// the bands (0: ny).
__host__ inline BlockShape block_shape(int ny, int nx, int T, int ring, int mlo, int mhi,
                                       int planes, int csize, int gny = 0) {
  static const int cand[][2] = {{64, 64}, {64, 32}, {32, 32}, {32, 24}, {32, 16},
                                {32, 8},  {16, 16}, {16, 8},  {8, 8},   {8, 4},
                                {4, 4}};
  BlockShape b{};
  b.T = T;
  b.ring = ring;
  b.hx = ring * T;
  if (gny <= 0) gny = ny;
  b.hlo = ring * T + band_margin(ring * T, mlo, gny);
  b.hhi = ring * T + band_margin(ring * T, mhi, gny);
  const size_t per_cell = (size_t)planes * csize + 1;
  int pick = -1, fallback = -1;
  for (int c = 0; c < (int)(sizeof(cand) / sizeof(cand[0])); ++c) {
    const int wx = cand[c][0] + 2 * b.hx, wy = cand[c][1] + b.hlo + b.hhi;
    if (wx * wy > kMaxWindow) continue;
    if (fallback < 0) fallback = c;
    // a tile under 128 cells recomputes its halo too often: a global window
    if (cand[c][0] * cand[c][1] >= 128 && (size_t)wx * wy * per_cell + 16 <= kSmemMax) {
      pick = c;
      break;
    }
  }
  b.gmem = pick < 0;
  if (pick < 0) pick = fallback;
  if (pick < 0) pick = (int)(sizeof(cand) / sizeof(cand[0])) - 1;
  b.tx = cand[pick][0];
  b.ty = cand[pick][1];
  b.wx = b.tx + 2 * b.hx;
  b.wy = b.ty + b.hlo + b.hhi;
  b.ntx = (nx + b.tx - 1) / b.tx;
  b.nty = (ny + b.ty - 1) / b.ty;
  // planes, aligned to 16 bytes, then the fluid bytes
  b.win_bytes = ((size_t)b.wx * b.wy * planes * csize + 15) / 16 * 16 +
                ((size_t)b.wx * b.wy + 15) / 16 * 16;
  const int tiles = b.ntx * b.nty;
  b.grid = b.gmem ? (tiles < kGmemBlocks ? tiles : kGmemBlocks) : tiles;
  return b;
}

// The largest T whose launch (shape_of(T), a BlockShape) has a window of
// at most kMaxWindow cells, the launchers' refusal: the windows only grow
// with T, so the first T that does not fit ends the search.  0 when no T
// fits, or when shape_of names no instance (grid 0).
template <typename ShapeOf>
__host__ int window_max_steps(ShapeOf shape_of) {
  int t = 0;
  while (t < 4096) {
    const BlockShape B = shape_of(t + 1);
    if (B.grid == 0 || B.wx * B.wy > kMaxWindow) break;
    ++t;
  }
  return t;
}

// Where a local launch's shard lives: its centre of ny x nx cells starts
// at row fy and column fx of a py x px buffer (a plane of the state and of
// the geometry); fx = 0 means no x frame (px = nx, the shard spans the
// global width and x wraps).  row0 is the global row of centre row 0.
// Mirrored by the ints of the csf2d_local / coupled2d_local /
// single2d_local entry points (kernels/build.py::local_ints).
struct LocalGrid {
  int ny, nx;
  int py, px;
  int fy, fx;
  int row0;
};

// The buffer index of the cell y rows above and x columns right of the
// centre's first cell, clamped to the buffer (x wraps without an x frame).
__device__ __forceinline__ size_t local_index(const LocalGrid& G, int y, int x) {
  const int r = min(max(G.fy + y, 0), G.py - 1);
  const int c = G.fx == 0 ? wrap(x, G.nx) : min(max(G.fx + x, 0), G.px - 1);
  return (size_t)r * G.px + c;
}

// Whether the frame of G covers a launch's reach B (hlo rows below, hhi
// above, hx columns a side), and the buffer holds its centre.
__host__ inline bool frame_covers(const LocalGrid& G, const BlockShape& B) {
  if (G.ny < 1 || G.nx < 1 || G.fy < B.hlo || G.py - G.fy - G.ny < B.hhi) return false;
  return G.fx == 0 ? G.px == G.nx : G.fx >= B.hx && G.px - G.fx - G.nx >= B.hx;
}

// The ints that lead every local library's entry points (T, then the
// LocalGrid), and the grid they name.
#define LOCAL_INTS int T, int ny, int nx, int py, int px, int fy, int fx, int row0
#define LOCAL_GRID LocalGrid{ny, nx, py, px, fy, fx, row0}

// The scratch, tiling and error-string entry points of the local library
// `prefix` (kernels/build.py::block_fns): shape_fn(params, T, grid) is the
// launch's BlockShape.
#define LOCAL_INFO_ENTRY_POINTS(prefix, Params, shape_fn)                              \
  extern "C" long long prefix##_block_scratch_bytes(LOCAL_INTS, const Params* params) { \
    const BlockShape B = shape_fn(*params, T, LOCAL_GRID);                             \
    return B.gmem ? (long long)B.grid * (long long)B.win_bytes : 0;                    \
  }                                                                                    \
  extern "C" int prefix##_block_shape(LOCAL_INTS, const Params* params,                \
                                      long long* shape) {                              \
    const BlockShape B = shape_fn(*params, T, LOCAL_GRID);                             \
    const long long v[8] = {B.tx, B.ty, B.hx, B.hlo, B.hhi, B.gmem, B.grid,            \
                            (long long)B.win_bytes};                                   \
    for (int i = 0; i < 8; ++i) shape[i] = v[i];                                       \
    return 0;                                                                          \
  }                                                                                    \
  extern "C" const char* prefix##_block_error_string(int code) {                       \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                         \
  }

// A rectangle of window cells [x0, x1) x [y0, y1): the window shrunk by e
// on every side.
struct Region {
  int x0, x1, y0, y1;
  __device__ int w() const { return x1 - x0; }
  __device__ int area() const { return (x1 - x0) * (y1 - y0); }
};

__device__ __forceinline__ Region shrunk(const BlockShape& B, int e) {
  return Region{e, B.wx - e, e, B.wy - e};
}

// Pull streaming with half-way bounce-back of one pair of opposite
// directions (i, opp(i)) on one set of populations, in place: plane pi
// (direction i) and po (direction opp(i)) of the window, on the fluid
// cells of region r (whose neighbours lie in the window).
template <typename C>
__device__ __forceinline__ void stream_pair(C* pi, C* po, int i,
                                            const unsigned char* __restrict__ fl, int wx,
                                            const Region& r) {
  const int d = ey(i) * wx + ex(i);  // window offset of e_i
  const int area = r.area(), w = r.w();
  C vi[kCellsPerThread], vo[kCellsPerThread];
#pragma unroll
  for (int k = 0; k < kCellsPerThread; ++k) {
    const int t = threadIdx.x + k * kBlockThreads;
    if (t < area) {
      const int c = (r.y0 + t / w) * wx + r.x0 + t % w;
      if (fl[c]) {
        // o_i(x) = post_i(x - e_i), or post_opp(x) from a solid upwind cell
        vi[k] = fl[c - d] ? pi[c - d] : po[c];
        vo[k] = fl[c + d] ? po[c + d] : pi[c];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kCellsPerThread; ++k) {
    const int t = threadIdx.x + k * kBlockThreads;
    if (t < area) {
      const int c = (r.y0 + t / w) * wx + r.x0 + t % w;
      if (fl[c]) {
        pi[c] = vi[k];
        po[c] = vo[k];
      }
    }
  }
  __syncthreads();
}

// The four pairs of one set of nine planes (plane q at base + q * plane).
template <typename C>
__device__ __forceinline__ void stream_set(C* base, size_t plane,
                                           const unsigned char* __restrict__ fl, int wx,
                                           const Region& r) {
  stream_pair(base + 1 * plane, base + 3 * plane, 1, fl, wx, r);
  stream_pair(base + 2 * plane, base + 4 * plane, 2, fl, wx, r);
  stream_pair(base + 5 * plane, base + 7 * plane, 5, fl, wx, r);
  stream_pair(base + 6 * plane, base + 8 * plane, 6, fl, wx, r);
}

// The window of this block: its compute planes and fluid bytes, in shared
// memory or in the block's slice of the global scratch.
template <typename C>
__device__ __forceinline__ C* window_planes(const BlockShape& B, unsigned char* smem,
                                            unsigned char* scratch) {
  unsigned char* base = B.gmem ? scratch + (size_t)blockIdx.x * B.win_bytes : smem;
  return reinterpret_cast<C*>(base);
}

__device__ __forceinline__ unsigned char* window_fluid(const BlockShape& B,
                                                       unsigned char* smem,
                                                       unsigned char* scratch, int planes,
                                                       int csize) {
  unsigned char* base = B.gmem ? scratch + (size_t)blockIdx.x * B.win_bytes : smem;
  return base + ((size_t)B.wx * B.wy * planes * csize + 15) / 16 * 16;
}

}  // namespace
