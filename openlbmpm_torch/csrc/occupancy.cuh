// The z-run of the kernels that march a tile column up a run of z slabs
// (flow3d.cuh's sc_push_kernel, cg3d.cuh's fields_kernel and coupled
// collide_stream): the shortest run (at least 4 slabs, at most the
// kernel's longest) whose grid the card holds at once.  A box a quarter of
// 128^3 (the local forms on a (4, 1) mesh) then takes runs of 8 or 9
// slabs, where the longest runs leave most of the card idle (PERF.md).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// The blocks of `kernel` the card holds at once, `threads` threads and
// `smem` bytes of dynamic shared memory each (a request above 48 KB set on
// the kernel first): -1, and the error in err, on a failure.
template <typename Kernel>
int card_capacity(Kernel kernel, int threads, size_t smem, cudaError_t& err) {
  int dev = 0, sms = 0, per = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads, smem);
  if (err == cudaSuccess && per < 1) err = cudaErrorInvalidConfiguration;
  return err == cudaSuccess ? per * sms : -1;
}

// The z-run over nz slabs of a grid of `tiles` tile columns, the card
// holding `capacity` blocks: each column takes capacity / tiles runs where
// the card holds two grids of columns or more, else one.
inline int z_run(long long capacity, long long tiles, int nz, int zmax) {
  const long long runs = capacity >= 2 * tiles ? capacity / tiles : 1;
  const long long zrun = (nz + runs - 1) / runs;
  return (int)(zrun < 4 ? 4 : (zrun > zmax ? zmax : zrun));
}

}  // namespace
