// The local form of the D3Q19 CSF step and its coupled D3Q7 tracer step
// (K12d): one shard of a z- or (z, y)-decomposed domain, for NVIDIA Hopper
// (sm_90a), included by cg3d_local_f64.cu and cg3d_local_f32.cu.
//
// Replaces the per-shard kernel of openlbmpm_tpu/pallas/cg3d.py::
// build_cg3d_sharded_step (the local build_cg3d_fused_step, pallas_call
// :1096, under shard_map :1427-1472), compressed f32 / f64 state, T = 1,
// with or without D3Q7 tracers (z meshes only, as there).
//
// A shard's state lives in a padded buffer (parallel/mesh.py): its nz x ny
// centre, fz = 4 slabs of frame below and above and, on a (z, y) mesh,
// fy = 4 rows on each side (fy = 0: the shard spans every row and y wraps
// in the kernels as on one device); x is whole and wraps.  A call is:
//   slabs   (local_bc_kernel, before the exchange; only on a shard that
//           holds a boundary slab in its centre) the boundary slabs of the
//           centre rewritten in place, found by global slab index (buffer
//           slab g - z0 + fz of global slab g), each value as bc_kernel
//           forms it.  The exchange that follows ships post-slab values,
//           as the JAX builder's jnp prologue runs on the global array
//           before its exchange (:1474, :1519-1522).  So no frame ever
//           holds a stale boundary slab, and the passes below need no slab
//           logic: the convective cascade (slab 0 takes slab 3's value)
//           stays inside the bottom shard's centre, which holds slabs 0-3
//           because a shard is at least 4 slabs deep.
//   physics the single-device K9 / K9t kernels of cg3d.cuh with BOX = true,
//           each over the cells of the buffer within its reach of the
//           centre, in slabs and (fy > 0) rows: fields 1 (its rings read
//           the normals at 2, the extended phi at 3 and the phi of wetting
//           fluid cells at 4) and collide_stream 0 (it collides reach 1 in
//           its ring, the tracers with the flow in the coupled form).
//           Neighbours stay inside the buffer, so z and split y never wrap;
//           only collide_stream writes the centre, of the state and of the
//           tracers.
// The frame is the step's reach, 4 (kernels/cg3d.py::LOCAL_REACH: the
// fields' phi ring 3 cells beyond their box of reach 1), in z and in split
// y alike.
//
// What bounds it: as K9 / K9t, HBM bytes: the state in and out, plus the
// frames' reads and copies.  The helper passes run over up to nz + 8 slabs
// a shard (fields_kernel's rings reach 4 slabs beyond its box of nz + 2).

#pragma once

#include "cg3d.cuh"

struct Local3 {  // mirrored by kernels/cg3d.py::Local3
  int nz, ny;    // the shard's centre: slabs and rows
  int fz, fy;    // its frame: slabs below (and above), rows on each side (0: y unsplit)
  int z0;        // the global slab of its first centre slab
  int gnz;       // global slabs
};

namespace {

// The cells of the buffer at most d cells beyond the centre (every row
// when y is not split); P holds the buffer's extents.
inline Box3 reach_box(const Local3& G, const Cg3dParams& P, int d) {
  return Box3{G.fz - d, G.fz + G.nz + d, G.fy ? G.fy - d : 0, G.fy ? G.fy + G.ny + d : P.ny};
}

// The boundary slabs of one (y, x) column of the centre, in place (see the
// note above): the NEBB inlet on global slab gnz - 2 and its ghost gnz - 1
// where this shard holds them, the convective copies (2, 1, 0) or the NEBB
// pressure outlet (1 and its ghost 0) where it holds slab 0.
template <typename S, typename C = typename Traits<S>::C>
__global__ void local_bc_kernel(S* __restrict__ s, const C* __restrict__ geo, Cg3dParams P,
                                Local3 G) {
  const size_t nxy = (size_t)P.ny * P.nx;
  const size_t n = (size_t)P.nz * nxy;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)G.ny * P.nx) return;
  const size_t k2 = (size_t)G.fy * P.nx + t;
  auto at = [&](int g) { return (size_t)(g - G.z0 + G.fz) * nxy + k2; };
  auto fluid = [&](int g) { return geo[at(g)] > C(0.5); };
  Cell<C, kCompressed> c;
  auto load = [&](int g) { decode<S, kCompressed>(s, n, at(g), C(1), c); };
  auto store = [&](int g) { encode<S, kCompressed>(s, n, at(g), C(1), c); };
  if (P.inlet == 1 && G.z0 + G.nz == G.gnz) {
    const int g = G.gnz - 2;
    load(g);
    if (fluid(g)) {
      rewrite(c, P, true);
      store(g);
    }
    if (fluid(g + 1)) store(g + 1);  // the ghost copies the rewritten cell
  }
  if (G.z0 != 0) return;
  if (P.outlet == 1) {
    load(3);
    for (int g = 2; g >= 0; --g) {
      if (fluid(g)) store(g);
      else load(g);
    }
  } else if (P.outlet == 2) {
    load(1);
    if (fluid(1)) {
      rewrite(c, P, false);
      store(1);
    }
    if (fluid(0)) store(0);
  }
}

template <typename S>
int launch_local_bc(void* s, const void* geo, const Cg3dParams& P, const Local3& G,
                    cudaStream_t stream) {
  using C = typename Traits<S>::C;
  const size_t cols = (size_t)G.ny * P.nx;
  local_bc_kernel<S><<<(unsigned)((cols + 255) / 256), 256, 0, stream>>>(
      static_cast<S*>(s), static_cast<const C*>(geo), P, G);
  return (int)cudaGetLastError();
}

// The physics of one shard a call: fields_kernel (without the boundary
// slabs, applied before the exchange), then collide_stream, with tracers
// (g_in not null) the coupled one; each over its reach.  P holds the
// buffer's extents (nz, ny the padded slabs and rows).
template <typename S>
int launch_cg3d_local(const void* s_in, void* s_out, const void* geo_v, void* fld_v,
                      const void* g_in, void* g_out, const void* tab_v, const Cg3dParams& P,
                      const Tracer3dParams& T, const Local3& G, cudaStream_t stream) {
  using C = typename Traits<S>::C;
  const C* geo = static_cast<const C*>(geo_v);
  C* fld = static_cast<C*>(fld_v);
  const State<S> st{static_cast<const S*>(s_in), nullptr, nullptr};
  const int ferr =
      launch_fields_kernel<S, kCompressed, true>(st, geo, fld, P, stream, reach_box(G, P, 1));
  if (ferr) return ferr;
  const Box3 centre = reach_box(G, P, 0);
  if (g_in != nullptr)
    return launch_coupled_stream<S, true>(st, geo, fld, s_out, P, stream, centre,
                                          static_cast<const C*>(g_in), static_cast<C*>(g_out),
                                          static_cast<const C*>(tab_v), T);
  return launch_collide_stream<S, kCompressed, true>(st, geo, fld, s_out, nullptr, P, stream,
                                                     centre);
}

}  // namespace
