// The z-march of the 3-D T-step kernels for NVIDIA Hopper (sm_90a): the
// executor that K11-T and K10-T (flow3d_block.cuh), K9-T (cg3d_block.cuh)
// and the 2-D row-march (march2d.cuh) share.
//
// One cooperative launch advances T steps.  The plan (built on the host by
// kernels/march3d.py, a table of int64 words in device memory) cuts each
// step into stages, gives each stage a ring of z slabs per quantity it
// writes (in the scratch buffer the wrapper allocates), and lists for every
// wave the (stage, slab) entries that run in it; the waves run one after
// another with a grid-wide barrier between them, and the bands of rows one
// after another.  Within a wave the entries' cells are dealt to the grid's
// warps in chunks of 32 consecutive cells (x fastest, so a warp reads
// consecutive values of a ring row), chunk c to entry c mod E, so that
// every SM holds a mix of the wave's cheap and costly stages; the body of
// the family computes each cell of each stage.  The plan guarantees that
// nothing read in a wave is written in it and that no ring slot is reused
// while a reader still needs it, so the grid barrier is the only
// synchronisation.
//
// Table (kernels/march3d.py::Plan.tensor): a header of 16 words (version,
// stages, rings, waves, entries, bands, band rows, ring rows W, halo H, nz,
// ny, nx, T, slabs a wave, scratch bytes, family), the stages (kind, level,
// e = rows beyond the band a side, four ring ids, a spare word), the rings
// (byte offset, planes, depth, item size), the waves' first entries and
// their largest cell count, and the entries (stage, unwrapped slab u, its
// cells).  A ring array is [plane][slot][row][x], slot = u mod depth; with
// one band W = ny and rows wrap inside the ring (the domain is periodic in
// y), with several a stage's rows never leave the ring.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMarchThreads = 256;   // threads a block of the cooperative grid

// stage kinds (kernels/march3d.py)
constexpr int kStageLoad = 0;
constexpr int kStageCollide = 1;
constexpr int kStageStream = 2;
constexpr int kStageBc = 3;
constexpr int kStageExtrap = 4;
constexpr int kStageNormal = 5;
// (march2d.cuh's stages take 6 ... 8)
constexpr int kStageStreamCollide = 9;   // K11-T: pull one level, collide the next

// header words
constexpr int kHdrStages = 1, kHdrRings = 2, kHdrWaves = 3, kHdrBands = 5, kHdrBandRows = 6,
              kHdrRows = 7, kHdrHalo = 8, kHdrNz = 9, kHdrNy = 10, kHdrNx = 11;
constexpr int kHeaderWords = 16, kStageWords = 8, kRingWords = 4, kEntryWords = 3;
// the most stages and rings a plan may hold (kernels/march3d.py checks):
// each block keeps its own copy of their words in shared memory
constexpr int kMarchMaxStages = 64, kMarchMaxRings = 48;

// v mod n for any v
__device__ __forceinline__ int mwrap(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}
// v mod n for v in [-n, 2n)
__device__ __forceinline__ int mwrap1(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// The cell a thread works on for one entry: the stage's words, the
// unwrapped slab u, the ring row and x, the domain slab and row, and for
// d = -1, 0, +1 the ring rows' offsets (row * nx), the columns and the
// domain's slabs and rows of the neighbours.
struct MarchCell {
  const int* stage;          // kind, level, e, four ring ids
  int u, lr, x, gz, gy, nx;
  int rr[3], cc[3];          // ring row offsets, columns
  int gzz[3], gyy[3];        // domain slab, row of the neighbours
  __device__ int kind() const { return (int)stage[0]; }
  __device__ int ring(int j) const { return stage[3 + j]; }
  // the domain index of the neighbour (dz, dy, dx), |d| <= 1
  __device__ size_t gidx(int dz, int dy, int dx, size_t nxy) const {
    return (size_t)gzz[dz + 1] * nxy + (size_t)gyy[dy + 1] * nx + cc[dx + 1];
  }
};

// One ring array around one cell: value (plane, dz, dy, dx) with |d| <= 1,
// or (plane) at slab u + dz for any dz (at_slab).
template <typename T>
struct RingAt {
  T* base;
  int depth, stride, slab;   // slots, values a plane, values a slot
  int sb[3];                 // slot offsets of u - 1, u, u + 1
  const MarchCell* c;
  __device__ int cell(int dz, int dy, int dx) const {
    return sb[dz + 1] + c->rr[dy + 1] + c->cc[dx + 1];
  }
  __device__ T& at(int plane, int dz = 0, int dy = 0, int dx = 0) const {
    return base[(size_t)plane * stride + cell(dz, dy, dx)];
  }
  // the cell's index at slab u + dz, any dz
  __device__ int cell_slab(int dz) const {
    return (dz >= -1 && dz <= 1 ? sb[dz + 1] : mwrap(c->u + dz, depth) * slab) + c->rr[1] +
           c->cc[1];
  }
  __device__ T& at_slab(int plane, int dz) const {
    return base[(size_t)plane * stride + cell_slab(dz)];
  }
};

struct MarchPlan {
  const long long* w;
  unsigned char* scratch;
  // the block's shared copies of the stage words (kStageWords ints a
  // stage) and of the rings' byte offsets and depths (march_run fills them)
  const int* stage_tab;
  const long long* ring_off;
  const int* ring_depth;
  __device__ const long long* stages() const { return w + kHeaderWords; }
  __device__ const long long* rings() const { return stages() + kStageWords * w[kHdrStages]; }
  __device__ const long long* wave_ptr() const { return rings() + kRingWords * w[kHdrRings]; }
  __device__ const long long* wave_cells() const { return wave_ptr() + w[kHdrWaves] + 1; }
  __device__ const long long* entries() const { return wave_cells() + w[kHdrWaves]; }
  // the ring of id `id` (a stage's ring word) around cell c; a null view
  // for -1
  template <typename T>
  __device__ RingAt<T> ring(int id, const MarchCell& c) const {
    RingAt<T> r;
    r.c = &c;
    if (id < 0) {
      r.base = nullptr;
      r.depth = 1;
      r.stride = r.slab = 0;
      r.sb[0] = r.sb[1] = r.sb[2] = 0;
      return r;
    }
    r.base = reinterpret_cast<T*>(scratch + ring_off[id]);
    r.depth = ring_depth[id];
    r.slab = (int)(w[kHdrRows] * w[kHdrNx]);
    r.stride = r.depth * r.slab;
    const int s = mwrap(c.u, r.depth);
    r.sb[1] = s * r.slab;
    r.sb[0] = (s == 0 ? r.depth - 1 : s - 1) * r.slab;
    r.sb[2] = (s == r.depth - 1 ? 0 : s + 1) * r.slab;
    return r;
  }
};

// Run every band and wave of the plan, body(cell) for each cell of each
// entry; a grid barrier after each wave.
template <typename Body>
__device__ void march_run(MarchPlan& M, Body&& body) {
  namespace cgr = cooperative_groups;
  cgr::grid_group grid = cgr::this_grid();
  __shared__ int stage_tab[kMarchMaxStages * kStageWords];
  __shared__ long long ring_off[kMarchMaxRings];
  __shared__ int ring_depth[kMarchMaxRings];
  const long long* w = M.w;
  for (int k = threadIdx.x; k < (int)w[kHdrStages] * kStageWords; k += blockDim.x)
    stage_tab[k] = (int)M.stages()[k];
  for (int k = threadIdx.x; k < (int)w[kHdrRings]; k += blockDim.x) {
    ring_off[k] = M.rings()[kRingWords * k];
    ring_depth[k] = (int)M.rings()[kRingWords * k + 2];
  }
  __syncthreads();
  M.stage_tab = stage_tab;
  M.ring_off = ring_off;
  M.ring_depth = ring_depth;
  const int waves = (int)w[kHdrWaves], bands = (int)w[kHdrBands];
  const int band_rows = (int)w[kHdrBandRows], halo = (int)w[kHdrHalo];
  const int rows = (int)w[kHdrRows];
  const int nz = (int)w[kHdrNz], ny = (int)w[kHdrNy], nx = (int)w[kHdrNx];
  const long long* ptr = M.wave_ptr();
  const long long* cells = M.wave_cells();
  const long long* entries = M.entries();
  const int gsize = gridDim.x * blockDim.x;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  for (int b = 0; b < bands; ++b) {
    const int y0 = b * band_rows;
    for (int wv = 0; wv < waves; ++wv) {
      const int e0 = (int)ptr[wv], ne = (int)ptr[wv + 1] - e0;
      const int chunks = ((int)cells[wv] + 31) / 32;   // a warp's worth, per entry
      const int total = ne * chunks * 32;
      for (int it = gtid; it < total; it += gsize) {
        const int ch = it >> 5;
        const long long* en = entries + kEntryWords * (e0 + ch % ne);
        const int i = (ch / ne) * 32 + (it & 31);
        if (i >= (int)en[2]) continue;
        MarchCell c;
        c.stage = stage_tab + kStageWords * en[0];
        c.u = (int)en[1];
        c.nx = nx;
        c.lr = halo - (int)c.stage[2] + i / nx;
        c.x = i % nx;
        c.gz = mwrap(c.u, nz);
        c.gy = bands == 1 ? c.lr : mwrap(y0 - halo + c.lr, ny);
#pragma unroll
        for (int d = -1; d <= 1; ++d) {
          c.rr[d + 1] = mwrap1(c.lr + d, rows) * nx;
          c.cc[d + 1] = mwrap1(c.x + d, nx);
          c.gzz[d + 1] = mwrap1(c.gz + d, nz);
          c.gyy[d + 1] = mwrap1(c.gy + d, ny);
        }
        body(c);
      }
      grid.sync();
    }
  }
}

// The cooperative grid of a march kernel: its resident blocks an SM times
// the SMs (0 blocks: the launch cannot run).
template <typename Kernel>
int march_grid(Kernel kernel, int* grid) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kMarchThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *grid = per * sms;
  return per > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// One cooperative launch of a march kernel with its argument pointers.
template <typename Kernel>
int march_launch(Kernel kernel, void** args, cudaStream_t st) {
  int grid = 0;
  const int err = march_grid(kernel, &grid);
  if (err) return err;
  const cudaError_t e =
      cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kMarchThreads), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
