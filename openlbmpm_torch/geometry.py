"""Geometry construction: masks, pore images, buffer layers, wetting metadata
(the port's own copy of ``openlbmpm_tpu/geometry.py``, numpy only).

Divergence from the reference: instead of compacting pore voxels
into a sparse node list with indirection tables
(reference ``ShanChen2D/ShanChenD2Q9.py:587-641``,
``RKCG2D/RKD2Q9.py:603-736``), we keep dense ``(ny, nx)``
boolean masks and express every neighbor interaction as a shifted/rolled
array op.  Wetting metadata (solid-surface normals, wetting masks, the
solid-phi extrapolation stencil) becomes masked convolutions computed once on
the host — semantics match the reference's wetting-solid catalog and its
"-2 - k" index trick (``RKD2Q9.py:657-736``, ``AcceleratedRKGPU2D.py:1560-1632``)
without the sparse data structure.

Conventions (same as the reference):
  - arrays are indexed ``[y, x]``; flow direction in the canonical configs is
    -y (inlet at the top rows, outlet at the bottom rows);
  - the domain wraps periodically at array edges (the reference's neighbor
    fill wraps, ``OptimizedD2Q9GPU.py:31-35``); walls must be made of solid
    voxels, not array edges.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .lattice import D2Q9, ISO_STENCILS

__all__ = [
    "Geometry",
    "open_channel",
    "box_with_walls",
    "from_solid_mask",
    "load_structure_image",
    "add_buffer_layers",
    "duplicate_domain",
    "solid_normals",
    "wetting_masks",
]


@dataclasses.dataclass
class Geometry:
    """Dense geometry description.

    Attributes:
      is_solid: (ny, nx) bool, True on solid voxels.
      is_fluid: (ny, nx) bool, complement of is_solid.
      porosity: fluid fraction.
    """

    is_solid: np.ndarray

    def __post_init__(self):
        self.is_solid = np.asarray(self.is_solid, dtype=bool)

    @property
    def is_fluid(self) -> np.ndarray:
        return ~self.is_solid

    @property
    def shape(self) -> tuple[int, ...]:
        return self.is_solid.shape

    @property
    def ny(self) -> int:
        return self.is_solid.shape[0]

    @property
    def nx(self) -> int:
        return self.is_solid.shape[1]

    @property
    def porosity(self) -> float:
        return float(self.is_fluid.mean())

    @property
    def num_fluid_nodes(self) -> int:
        return int(self.is_fluid.sum())


def open_channel(nx: int, ny: int, open_rows: int = 10) -> Geometry:
    """Channel with solid side walls except `open_rows` at top and bottom.

    Mirrors ``SimpleGeometry.defineGeometry``
    (reference ``ShanChen2D/SimpleGeometry.py:11-27``): the whole
    domain is pore space; the x = 0 and x = nx-1 columns are solid except for
    the first/last ``open_rows`` rows, which remain open as inlet/outlet
    slots.
    """
    solid = np.zeros((ny, nx), dtype=bool)
    solid[open_rows:ny - open_rows, 0] = True
    solid[open_rows:ny - open_rows, nx - 1] = True
    return Geometry(is_solid=solid)


def box_with_walls(nx: int, ny: int) -> Geometry:
    """All-pore box with solid side walls along the full height.

    This is the RK color-gradient default domain (side walls sealed, inlet
    and outlet at top/bottom rows; ``RKD2Q9.py:416-443``).
    """
    solid = np.zeros((ny, nx), dtype=bool)
    solid[:, 0] = True
    solid[:, nx - 1] = True
    return Geometry(is_solid=solid)


def from_solid_mask(is_solid: np.ndarray) -> Geometry:
    return Geometry(is_solid=np.asarray(is_solid, dtype=bool))


def load_structure_image(path: str, threshold: float = 0.5) -> np.ndarray:
    """Load a pore-structure image into a bool solid mask.

    Replaces ``scipy.ndimage.imread`` usage in ``ShanChenD2Q9.py:544-585``.
    Pixels above `threshold` (of the normalized grayscale) are solid.
    Crops to the bounding box of the solid phase like ``__processImage``.
    """
    try:
        from PIL import Image  # pillow ships with matplotlib env
        img = np.asarray(Image.open(path).convert("L"), dtype=np.float64) / 255.0
    except ImportError:  # pragma: no cover - fallback reader
        import matplotlib.image as mpimg
        img = mpimg.imread(path)
        if img.ndim == 3:
            img = img[..., :3].mean(axis=-1)
    solid = img > threshold
    ys, xs = np.nonzero(solid)
    if ys.size:
        solid = solid[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    return solid


def add_buffer_layers(
    solid: np.ndarray,
    n_layers: int = 20,
    top: bool = True,
    bottom: bool = True,
    seal_sides: bool = True,
) -> np.ndarray:
    """Prepend/append open buffer rows and optionally seal the side walls.

    Mirrors the buffer-layer padding in ``ShanChenD2Q9.py:578-585`` and
    ``RKD2Q9.py:373-414`` (configurable layer count).
    """
    solid = np.asarray(solid, dtype=bool).copy()
    if seal_sides:
        solid[:, 0] = True
        solid[:, -1] = True
    ny, nx = solid.shape
    buf = np.zeros((n_layers, nx), dtype=bool)
    if seal_sides:
        buf[:, 0] = True
        buf[:, -1] = True
    parts = []
    if bottom:
        parts.append(buf)
    parts.append(solid)
    if top:
        parts.append(buf)
    return np.concatenate(parts, axis=0)


def duplicate_domain(solid: np.ndarray, times_x: int = 1, times_y: int = 1,
                     mirror: bool = True) -> np.ndarray:
    """Tile the domain to build a larger periodic REV.

    The reference mirrors the image into an x-y tiling
    (``__expandImageDomain``, ``ShanChenD2Q9.py:514-541``); with
    ``mirror=True`` alternate tiles are flipped so the tiling is continuous.
    """
    solid = np.asarray(solid, dtype=bool)
    rows = []
    for iy in range(times_y):
        row_tiles = []
        for ix in range(times_x):
            tile = solid
            if mirror and (ix % 2 == 1):
                tile = tile[:, ::-1]
            if mirror and (iy % 2 == 1):
                tile = tile[::-1, :]
            row_tiles.append(tile)
        rows.append(np.concatenate(row_tiles, axis=1))
    return np.concatenate(rows, axis=0)


def _roll2(a: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """Value at (y, x) of a(y + dy, x + dx) with periodic wrap."""
    return np.roll(np.roll(a, -dy, axis=0), -dx, axis=1)


def solid_normals(is_solid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unit vectors normal to the solid surface, on every fluid node.

    n_s(x) = normalize( sum_c w(|c|^2) * c * [solid at x + c] ) with the
    8th-order isotropy stencil — a dense masked-convolution reformulation of
    ``RKD2Q9.calVectorNormaltoSolid`` (``RKD2Q9.py:768-899``).  The vector
    points from the fluid node toward the solid.  Nodes with no solid in the
    stencil get (0, 0).

    Returns (nsx, nsy) float64 arrays of shape (ny, nx).
    """
    st = ISO_STENCILS[8]
    solid = np.asarray(is_solid, dtype=np.float64)
    sx = np.zeros_like(solid)
    sy = np.zeros_like(solid)
    for (dx, dy), w in zip(st.offsets, st.weights):
        s = _roll2(solid, int(dx), int(dy))
        sx += w * dx * s
        sy += w * dy * s
    norm = np.sqrt(sx * sx + sy * sy)
    safe = norm > 0
    nsx = np.where(safe, sx / np.where(safe, norm, 1.0), 0.0)
    nsy = np.where(safe, sy / np.where(safe, norm, 1.0), 0.0)
    fluid = ~np.asarray(is_solid, dtype=bool)
    return nsx * fluid, nsy * fluid


def _roll_nd(a: np.ndarray, offs) -> np.ndarray:
    """Value at x of a(x + off) with periodic wrap; offs = (dx, dy[, dz])
    in the lattice's (x, y[, z]) component order, arrays indexed
    [z, ]y, x."""
    out = a
    for axis, d in zip(range(a.ndim - 1, -1, -1), offs):
        out = np.roll(out, -int(d), axis=axis)
    return out


def solid_normals_nd(is_solid: np.ndarray, lat) -> tuple[np.ndarray, ...]:
    """Unit solid-surface normals on fluid nodes via the lattice's own
    weighted stencil — the 3D counterpart of :func:`solid_normals`."""
    solid = np.asarray(is_solid, dtype=np.float64)
    dim = lat.dim
    acc = [np.zeros_like(solid) for _ in range(dim)]
    for i in range(1, lat.q):
        s = _roll_nd(solid, lat.e[i])
        w = float(lat.w[i])
        for d in range(dim):
            ed = int(lat.e[i, d])
            if ed:
                acc[d] += w * ed * s
    norm = np.sqrt(sum(c * c for c in acc))
    safe = norm > 0
    fluid = ~np.asarray(is_solid, dtype=bool)
    return tuple(np.where(safe, c / np.where(safe, norm, 1.0), 0.0) * fluid
                 for c in acc)


def wetting_masks_nd(is_solid: np.ndarray, lat) -> tuple[np.ndarray, np.ndarray]:
    """(wetting_fluid, wetting_solid) masks for any lattice dimension."""
    solid = np.asarray(is_solid, dtype=bool)
    fluid = ~solid
    any_solid = np.zeros_like(solid)
    any_fluid = np.zeros_like(solid)
    for i in range(1, lat.q):
        any_solid |= _roll_nd(solid, lat.e[i])
        any_fluid |= _roll_nd(fluid, lat.e[i])
    return fluid & any_solid, solid & any_fluid


def wetting_masks(is_solid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Boolean (wetting_fluid, wetting_solid) masks.

    - wetting_fluid: fluid nodes with >= 1 solid voxel in the 3x3 box
      (``RKD2Q9.sortOutFluidNodesToSolid``, ``RKD2Q9.py:741-763``);
    - wetting_solid: solid voxels with >= 1 fluid node among the 8 neighbors
      (``RKD2Q9.optimizeFluidandSolidArray``, ``RKD2Q9.py:657-736``).
    """
    solid = np.asarray(is_solid, dtype=bool)
    fluid = ~solid
    any_solid = np.zeros_like(solid)
    any_fluid = np.zeros_like(solid)
    for dx, dy in D2Q9.e[1:]:
        any_solid |= _roll2(solid, int(dx), int(dy))
        any_fluid |= _roll2(fluid, int(dx), int(dy))
    return fluid & any_solid, solid & any_fluid


def extrude_image_3d(solid2d: np.ndarray, nz: int,
                     buffer_slabs: int = 8,
                     seal_xy: bool = True) -> np.ndarray:
    """Extrude a 2D pore-image cross-section into a 3D (nz, ny, nx) solid
    mask along the flow (z) axis, with open buffer slabs at both z faces
    (the 3D analogue of the reference's buffer layers,
    ``ShanChenD2Q9.py:578-585``; the 3D config
    ``IniFiles/RKtwophasesetup3D.ini:5-7`` drives an imaged pore
    structure).  ``seal_xy`` closes the four lateral faces."""
    s2 = np.asarray(solid2d, bool)
    core = np.broadcast_to(s2, (max(nz - 2 * buffer_slabs, 1),) + s2.shape)
    core = core.copy()
    buf = np.zeros((buffer_slabs,) + s2.shape, bool)
    solid = np.concatenate([buf, core, buf], axis=0)[:nz]
    if seal_xy:
        solid[:, 0, :] = solid[:, -1, :] = True
        solid[:, :, 0] = solid[:, :, -1] = True
    return solid


def image_stack_3d(paths, threshold: float = 0.5,
                   buffer_slabs: int = 8,
                   seal_xy: bool = True) -> np.ndarray:
    """Stack per-slice pore images (the micro-CT workflow) into a 3D solid
    mask [z, y, x], cropped to the common shape, plus z-face buffer
    slabs."""
    slices = [load_structure_image(p, threshold) for p in paths]
    ny = min(s.shape[0] for s in slices)
    nx = min(s.shape[1] for s in slices)
    core = np.stack([s[:ny, :nx] for s in slices])
    buf = np.zeros((buffer_slabs, ny, nx), bool)
    solid = np.concatenate([buf, core, buf], axis=0)
    if seal_xy:
        solid[:, 0, :] = solid[:, -1, :] = True
        solid[:, :, 0] = solid[:, :, -1] = True
    return solid
