"""Domain decomposition over a mesh of shards: the counterpart of
``openlbmpm_tpu/parallel/mesh.py`` (``make_mesh``, ``shard_domain``) and of
the halo choreography of the JAX sharded builders (``lax.ppermute`` rings
under ``shard_map``, ``pallas/csf.py:2027-2085``, ``pallas/single.py:
483-500``, ``pallas/cg3d.py:1427-1472``, ``pallas/sc3d.py:443-468``).

A mesh is a (y, x) grid of shards, shard k at coordinates (k // px,
k % px).  It splits the first two spatial axes of a domain, the "rows"
and "columns" below: (y, x) of a 2-D domain (..., ny, nx), (z, y) of a 3-D
one (..., nz, ny, nx), whose x is never split (as the JAX 3-D builders
shard z over the mesh axis "y" and y over "x").  Shard k holds the rows
[iy * R/py, (iy + 1) * R/py) and the columns [ix * C/px, (ix + 1) * C/px)
of the global R x C (x nx) domain.  Every function takes the domain's rank
from the shape it is given.  Two meshes say where the shards live and how
they talk; the caller names one, and nothing here picks one for it:

* ``ProcessMesh``: one shard a rank of a ``torch.distributed`` process
  group, which the caller has initialised (NCCL for CUDA tensors, gloo for
  CPU ones); halos travel by ``batch_isend_irecv`` of contiguous staging
  buffers;
* ``LocalMesh``: all shards in this process, on one device; halos travel
  by device copies.  One card can prove the kernels and the exchange's
  choreography only this way: NCCL refuses two ranks on one card.

A shard's state lives padded (``Frame``): its centre, ``lo`` rows below,
``hi`` rows above and, on a mesh with an x axis, ``x`` columns on each
side (in 3-D: z slabs below and above, y rows on each side).  The local
kernels read a whole padded buffer and write the centre of a second one;
``exchange`` fills the frame of the buffer about to be read, columns first
and then rows of the column-padded buffer, so the corner cells ride the
row exchange (``pallas/csf.py:1963-1972``, ``pallas/cg3d.py:1443-1472``).
The exchange is one hop: a frame may not be deeper than the shard it comes
from.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Frame", "LocalGrid", "Mesh", "LocalMesh", "ProcessMesh",
           "make_mesh", "ppermute", "shard_domain", "gather_domain",
           "exchange", "band_margin", "frame_of", "embed_local",
           "take_centre", "ShardedState", "ShardedStep"]

@dataclass(frozen=True)
class Frame:
    """A padded buffer's frame: rows below and above the centre, columns
    on each side (0: no x frame, the shard spans the global width and its
    x axis wraps)."""
    lo: int
    hi: int
    x: int = 0


@dataclass(frozen=True)
class LocalGrid:
    """Where one shard lives, as the local kernels take it (csrc/
    block2d.cuh ``LocalGrid``): its ny x nx centre at row fy and column fx
    of a py x px buffer, and the global row and column of its first centre
    cell.  Rows and columns are the split axes (z and y of a 3-D domain);
    ``tail`` holds the extents of the unsplit axes after them (() in 2-D,
    (nx,) in 3-D)."""
    ny: int
    nx: int
    py: int
    px: int
    fy: int
    fx: int
    row0: int
    col0: int
    tail: tuple = ()

    def ints(self, steps: int) -> tuple:
        """The local libraries' leading ints: T, then the grid."""
        return (steps, self.ny, self.nx, self.py, self.px, self.fy, self.fx,
                self.row0)

    def centre(self, t: torch.Tensor) -> torch.Tensor:
        """The centre (a view) of a padded buffer ``(..., py, px, *tail)``."""
        return t[_at(slice(self.fy, self.fy + self.ny),
                     slice(self.fx, self.fx + self.nx), len(self.tail))]


def _at(rows, cols, tail: int) -> tuple:
    """The index of `rows` and `cols` of the split axes of an array whose
    last `tail` axes are unsplit."""
    return (Ellipsis, rows, cols) + (slice(None),) * tail


def band_margin(ring_rows: int, m: int, ny: int) -> int:
    """Rows of halo beyond `ring_rows` for a band of boundary rows whose
    copies reach `m` rows outwards, with `ny` the global rows (mirror of
    ``csrc/block2d.cuh::band_margin``)."""
    if m == 0:
        return 0
    copies = 1
    while (ring_rows + m * copies) // ny + 1 > copies:
        copies += 1
    return m * copies


def frame_of(ring: int, steps: int, mlo: int, mhi: int, ny: int,
             x_axis: bool) -> Frame:
    """The frame a local window kernel of `ring` rings a sub-step needs for
    `steps` sub-steps, with boundary bands reaching `mlo` rows below and
    `mhi` above in a domain of `ny` global rows (mirror of
    ``csrc/block2d.cuh::block_shape``'s hlo, hhi and hx)."""
    r = ring * steps
    return Frame(r + band_margin(r, mlo, ny), r + band_margin(r, mhi, ny),
                 r if x_axis else 0)


class Mesh:
    """A (py, px) grid of shards on `device`."""

    def __init__(self, shape, device):
        py, px = (int(v) for v in shape)
        if py < 1 or px < 1:
            raise ValueError(f"mesh shape {shape}: positive sizes")
        self.shape = (py, px)
        self.device = torch.device(device)

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def coords(self, k: int) -> tuple[int, int]:
        return divmod(k, self.shape[1])

    def neighbour(self, k: int, axis: str, shift: int) -> int:
        """The shard `shift` steps from shard k along the ring `axis`."""
        iy, ix = self.coords(k)
        py, px = self.shape
        if axis == "y":
            return ((iy + shift) % py) * px + ix
        if axis == "x":
            return iy * px + (ix + shift) % px
        raise ValueError(f"axis {axis!r}: y | x")

    def local_ids(self) -> list[int]:
        """The shards held by this process."""
        raise NotImplementedError

    def _transfer(self, sends, axis: str, shift: int):
        raise NotImplementedError


class LocalMesh(Mesh):
    """All the shards in this process, on one device (``device``)."""

    def local_ids(self) -> list[int]:
        return list(range(self.size))

    def _transfer(self, sends, axis, shift):
        # what shard k receives is what its upstream neighbour sent, as it
        # stands (no copy: the caller copies it into its frame)
        return [sends[self.neighbour(k, axis, -shift)]
                for k in self.local_ids()]

    def __repr__(self):
        return f"LocalMesh(shape={self.shape}, device={self.device})"


class ProcessMesh(Mesh):
    """One shard a rank of the process group `group` (the default group
    when None), shard k on group rank k; the group is the caller's, made
    with ``torch.distributed.init_process_group``.  `device` is this rank's
    (``cuda:<i>`` with NCCL, ``cpu`` with gloo)."""

    def __init__(self, shape, device, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh: no process group; call "
                               "torch.distributed.init_process_group first")
        super().__init__(shape, device)
        self.group = group
        self.rank = dist.get_rank(group)
        world = dist.get_world_size(group)
        if world != self.size:
            raise ValueError(f"mesh {self.shape} holds {self.size} shards; "
                             f"the process group has {world} ranks")

    def local_ids(self) -> list[int]:
        return [self.rank]

    def _peer(self, k: int) -> int:
        import torch.distributed as dist
        return k if self.group is None else dist.get_global_rank(
            self.group, k)

    def _transfer(self, sends, axis, shift):
        import torch.distributed as dist

        (views,) = sends
        dst = self.neighbour(self.rank, axis, shift)
        src = self.neighbour(self.rank, axis, -shift)
        if dst == self.rank:   # a ring of one: ppermute is a local copy
            return [views]
        # edge rows of a (planes, rows, cols) buffer are strided across the
        # planes: one contiguous staging buffer a message
        flat = torch.cat([v.reshape(-1) for v in views])
        got = torch.empty_like(flat)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, flat, self._peer(dst), self.group),
            dist.P2POp(dist.irecv, got, self._peer(src), self.group)])
        for r in reqs:
            r.wait()
        out, at = [], 0
        for v in views:
            out.append(got[at:at + v.numel()].view(v.shape))
            at += v.numel()
        return [out]

    def __repr__(self):
        return (f"ProcessMesh(shape={self.shape}, rank={self.rank}, "
                f"device={self.device})")


def make_mesh(n_devices: int | None = None,
              shape: tuple[int, int] | None = None, *, kind: str,
              device="cuda", group=None) -> Mesh:
    """A (y, x) mesh of the shape of the JAX ``make_mesh``: `shape`, or
    1 x `n_devices` (x-only decomposition).  `kind` names the mesh:
    "local" (``LocalMesh`` on `device`; `shape` or `n_devices` required)
    or "process" (``ProcessMesh`` over `group`, by default 1 x the group's
    size; `device` "cuda" gives this rank the card of its rank, and more
    CUDA ranks than cards raise; "cpu" runs gloo)."""
    if shape is None and n_devices is not None:
        shape = (1, int(n_devices))
    if kind == "local":
        if shape is None:
            raise ValueError("a local mesh needs shape or n_devices")
        from .._device import resolve_device
        return LocalMesh(shape, resolve_device(device))
    if kind != "process":
        raise ValueError(f"kind {kind!r}: local | process")
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a process mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if shape is None:
        shape = (1, world)
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if world > count:
            raise RuntimeError(f"{world} CUDA ranks on {count} card(s): "
                               "NCCL takes one rank a card")
        dev = torch.device("cuda", rank if dev.index is None else dev.index)
    return ProcessMesh(shape, dev, group)


def ppermute(mesh: Mesh, tensors, axis: str, shift: int):
    """The counterpart of ``lax.ppermute`` over the ring `axis` ("y" or
    "x"): `tensors` holds one tensor (or a tuple of tensors) for each shard
    of ``mesh.local_ids()``, each sent to the shard `shift` steps along the
    ring; returns what each of them receives, as new tensors.  Along an
    axis of size 1 it is a local copy."""
    sends = [[t] if torch.is_tensor(t) else list(t) for t in tensors]
    got = mesh._transfer(sends, axis, shift)
    out = [[r.clone() for r in g] for g in got]
    return [o[0] if torch.is_tensor(t) else tuple(o)
            for o, t in zip(out, tensors)]


def _shift_into(mesh, shards, axis, shift, src_of, dst_of):
    """Each shard's `src_of` regions to the `dst_of` regions of the shard
    `shift` steps along `axis`."""
    sends = [[src_of(t) for t in sh] for sh in shards]
    for sh, got in zip(shards, mesh._transfer(sends, axis, shift)):
        for t, r in zip(sh, got):
            dst_of(t).copy_(r)


def exchange(mesh: Mesh, shards, frame: Frame, *centre: int) -> None:
    """Fill the frames of the padded buffers of the shards held here, in
    place: `shards` has one tuple of tensors ``(..., lo + ny + hi,
    x + nx + x, *tail)`` a shard of ``mesh.local_ids()``, `centre` the
    shard's centre ``(ny, nx, *tail)`` (rows and columns of the split axes,
    then the unsplit extents).  Columns first (the centre rows), then rows
    (whole padded rows)."""
    ny, nx, *tail = centre
    lo, hi, fx = frame.lo, frame.hi, frame.x
    if lo > ny or hi > ny or fx > nx:
        raise ValueError(f"frame {frame} deeper than the {ny}x{nx} shard: "
                         "the exchange is one hop")

    def at(rows, cols=slice(None)):
        return lambda t: t[_at(rows, cols, len(tail))]
    cy = slice(lo, lo + ny)
    if fx:
        _shift_into(mesh, shards, "x", 1, at(cy, slice(nx, fx + nx)),
                    at(cy, slice(0, fx)))
        _shift_into(mesh, shards, "x", -1, at(cy, slice(fx, 2 * fx)),
                    at(cy, slice(fx + nx, None)))
    if lo:
        _shift_into(mesh, shards, "y", 1, at(slice(ny, lo + ny)),
                    at(slice(0, lo)))
    if hi:
        _shift_into(mesh, shards, "y", -1, at(slice(lo, lo + hi)),
                    at(slice(lo + ny, None)))


def _grid(mesh: Mesh, k: int, frame: Frame, shape) -> LocalGrid:
    """Shard k's grid in a domain of global spatial `shape` (rows, columns,
    then the unsplit extents)."""
    py, px = mesh.shape
    iy, ix = mesh.coords(k)
    ny, nx, *tail = shape
    yl, xl = ny // py, nx // px
    return LocalGrid(yl, xl, frame.lo + yl + frame.hi, xl + 2 * frame.x,
                     frame.lo, frame.x, iy * yl, ix * xl, tuple(tail))


def _rows_cols(g: LocalGrid, shape):
    """The global rows and columns of the padded buffer of `g` (wrapping)."""
    ny, nx = shape[:2]
    rows = (torch.arange(g.py) + g.row0 - g.fy) % ny
    cols = (torch.arange(g.px) + g.col0 - g.fx) % nx
    return rows, cols


def shard_domain(array, mesh: Mesh, frame: Frame, dtype=None, rank: int = 2):
    """The padded buffers of the shards held here of a global array whose
    last `rank` axes are the domain, ``(..., ny, nx)`` or ``(..., nz, ny,
    nx)`` (a numpy array, such as the JAX model's state, or a tensor),
    frames filled from the global array as the exchange would fill them,
    on ``mesh.device``, in `dtype` (or the array's)."""
    a = array if torch.is_tensor(array) else torch.from_numpy(
        np.array(array))
    shape = tuple(a.shape[a.ndim - rank:])
    _check_divides(mesh, shape)
    out = []
    for k in mesh.local_ids():
        rows, cols = _rows_cols(_grid(mesh, k, frame, shape), shape)
        out.append(a[_at(rows[:, None], cols[None, :], rank - 2)].to(
            device=mesh.device, dtype=dtype or a.dtype).contiguous())
    return out


def _check_divides(mesh, shape):
    py, px = mesh.shape
    if shape[0] % py or shape[1] % px:
        raise ValueError(f"a {'x'.join(map(str, shape))} domain on a "
                         f"{py}x{px} mesh")


def gather_domain(mesh: Mesh, buffers, frame: Frame, *shape: int):
    """The global array ``(..., *shape)`` (`shape` the domain's, ``(ny,
    nx)`` or ``(nz, ny, nx)``) from the padded buffers of the shards held
    here (their centres), on the buffers' device: on a ``ProcessMesh``
    every rank gets it (an all-gather)."""
    _check_divides(mesh, shape)
    grids = [_grid(mesh, k, frame, shape) for k in range(mesh.size)]
    if isinstance(mesh, ProcessMesh):
        import torch.distributed as dist

        (b,) = buffers
        mine = grids[mesh.rank].centre(b).contiguous()
        parts = [torch.empty_like(mine) for _ in range(mesh.size)]
        dist.all_gather(parts, mine, group=mesh.group)
    else:
        parts = [g.centre(b) for g, b in zip(grids, buffers)]
    lead = parts[0].shape[:parts[0].ndim - len(shape)]
    out = parts[0].new_empty((*lead, *shape))
    for g, p in zip(grids, parts):
        out[_at(slice(g.row0, g.row0 + g.ny), slice(g.col0, g.col0 + g.nx),
                len(g.tail))] = p
    return out


def embed_local(buf: torch.Tensor, grid: LocalGrid, fill: torch.Tensor):
    """A copy of the global array `fill` ``(..., ny, nx, *tail)`` with the
    padded buffer `buf` written at its global rows and columns (wrapping),
    the centre last: where the buffer overlaps itself (a frame reaching
    round the domain) the centre wins, which equals the frame wherever the
    frame is the exchange's copy.  The plain versions of the local kernels
    step this array and take the centre back (``take_centre``)."""
    tail = len(grid.tail)
    shape = fill.shape[fill.ndim - 2 - tail:]
    rows, cols = _rows_cols(grid, shape)
    out = fill.clone()
    out[_at(rows[:, None], cols[None, :], tail)] = buf
    r0, c0 = grid.row0, grid.col0
    out[_at(slice(r0, r0 + grid.ny), slice(c0, c0 + grid.nx), tail)] = \
        grid.centre(buf)
    return out


def take_centre(x: torch.Tensor, grid: LocalGrid) -> torch.Tensor:
    """The shard `grid`'s centre (a view) of a global array `x` ``(..., ny,
    nx, *tail)``: what the plain versions of the local kernels take back
    from the domain they stepped."""
    return x[_at(slice(grid.row0, grid.row0 + grid.ny),
                 slice(grid.col0, grid.col0 + grid.nx), len(grid.tail))]


class ShardedState:
    """A sharded state: for each shard held here, a tuple of padded
    buffers (the flow state, and with transport the tracer PDFs), and the
    spare tuple the next call writes.  A step updates it in place (the two
    tuples swap), so the state a step returns is the one it was given."""

    def __init__(self, bufs):
        self.bufs = [tuple(b) for b in bufs]
        self.spare = [tuple(torch.empty_like(t) for t in b) for b in self.bufs]


class ShardedStep:
    """``step(state) -> state``: `steps_per_call` time steps of a
    ``ShardedState`` on `mesh` (a decomposition of the domain of spatial
    `shape`, ``(ny, nx)`` or ``(nz, ny, nx)``, with frame `frame`): for each
    shard k held here ``prologue(k, grid, ins)`` if given (it rewrites the
    centre of the padded buffers `ins` in place, as the JAX builders' jnp
    prologue rewrites the global array before its exchange), the exchange
    of the frames, then ``local(k, grid, ins, outs)``, which writes T steps
    of the padded buffers `ins` into the centres of `outs`.

    ``shard(*arrays)`` builds the state from global arrays (numpy or
    tensors, such as the JAX model's), ``gather(state)`` returns the global
    tensors, ``exchange(state)`` fills the frames alone."""

    def __init__(self, mesh: Mesh, shape, frame: Frame, local,
                 steps_per_call: int, dtypes, prologue=None):
        self.mesh = mesh
        self.shape = tuple(int(v) for v in shape)
        self.ny, self.nx = self.shape[-2:]
        self.frame = frame
        self.local = local
        self.prologue = prologue
        self.steps_per_call = int(steps_per_call)
        self.dtypes = tuple(dtypes)
        self.ids = mesh.local_ids()
        self.grids = [_grid(mesh, k, frame, self.shape) for k in self.ids]

    def shard(self, *arrays) -> ShardedState:
        per = [shard_domain(a, self.mesh, self.frame, dtype=d,
                            rank=len(self.shape))
               for a, d in zip(arrays, self.dtypes)]
        return ShardedState(zip(*per))

    def gather(self, state: ShardedState):
        out = tuple(gather_domain(self.mesh, [b[i] for b in state.bufs],
                                  self.frame, *self.shape)
                    for i in range(len(self.dtypes)))
        return out[0] if len(out) == 1 else out

    def exchange(self, state: ShardedState) -> None:
        g = self.grids[0]
        exchange(self.mesh, state.bufs, self.frame, g.ny, g.nx, *g.tail)

    def __call__(self, state: ShardedState) -> ShardedState:
        if self.prologue is not None:
            for k, g, ins in zip(self.ids, self.grids, state.bufs):
                self.prologue(k, g, ins)
        self.exchange(state)
        for k, g, ins, outs in zip(self.ids, self.grids, state.bufs,
                                   state.spare):
            self.local(k, g, ins, outs)
        state.bufs, state.spare = state.spare, state.bufs
        return state
