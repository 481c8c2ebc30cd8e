"""Lattice descriptors: the port's own copy of ``openlbmpm_tpu/lattice.py``
(numpy only; ``tests/test_torch_import.py`` holds the tables equal).

Each lattice is a static (hashable, numpy-backed) descriptor holding the
velocity set, quadrature weights, opposite-direction table and the MRT
transformation machinery.  Values mirror the reference implementation so the
physics match bit-for-bit in float64:

- D2Q9 ordering and weights: reference ``ShanChen2D/SimpleD2Q9.py:75-88``
  (0:(0,0), 1:E, 2:N, 3:W, 4:S, 5:NE, 6:NW, 7:SW, 8:SE).
- D2Q9 MRT matrix (Lallemand-Luo): ``SimpleD2Q9.py:107-124`` and
  ``RKCG2D/RKD2Q9.py:308-337``.
- D2Q5 transport ordering: ``RKCG2D/AccelerateTransport2DRK.py:51-75``
  (0:rest, 1:E, 2:W, 3:N, 4:S) with J-scheme weights
  (``Transport2DRK.py:404-410``) and the 5x5 MRT matrix
  (``Transport2DRK.py:316-321``).
- High-isotropy interaction stencils (orders 4/8/10) used by the explicit
  forcing scheme: offsets from ``ShanChen2D/ExplicitD2Q9GPU.py:392-625``,
  weights from ``ShanChenD2Q9.py:1675-1689``.

The 3D lattices (D3Q19 flow / D3Q7 transport) restore the capability promised
by the reference ``main.py:72-81`` whose 3D modules are absent from the
snapshot.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

__all__ = [
    "Lattice",
    "D2Q9",
    "D2Q5",
    "D3Q19",
    "D3Q7",
    "ISO_STENCILS",
    "IsoStencil",
]


@dataclasses.dataclass(frozen=True)
class Lattice:
    """A static lattice descriptor.

    Attributes:
      name: human-readable name, e.g. "D2Q9".
      e: (Q, D) int array of lattice velocities; component order is
         (x, y[, z]).
      w: (Q,) float64 quadrature weights.
      opp: (Q,) int indices of the opposite direction of each velocity.
      cs2: squared lattice speed of sound (1/3 for all lattices here).
      M: optional (Q, Q) MRT transformation matrix (moments = M @ f).
    """

    name: str
    e: np.ndarray
    w: np.ndarray
    opp: np.ndarray
    cs2: float = 1.0 / 3.0
    M: np.ndarray | None = None

    def __post_init__(self):
        object.__setattr__(self, "e", np.asarray(self.e, dtype=np.int32))
        object.__setattr__(self, "w", np.asarray(self.w, dtype=np.float64))
        object.__setattr__(self, "opp", np.asarray(self.opp, dtype=np.int32))
        if self.M is not None:
            object.__setattr__(self, "M", np.asarray(self.M, dtype=np.float64))
        # Sanity: e[opp[i]] == -e[i]
        assert np.all(self.e[self.opp] == -self.e), self.name
        assert abs(self.w.sum() - 1.0) < 1e-12, self.name

    @property
    def q(self) -> int:
        return self.e.shape[0]

    @property
    def dim(self) -> int:
        return self.e.shape[1]

    @cached_property
    def M_inv(self) -> np.ndarray:
        if self.M is None:
            raise ValueError(f"{self.name} has no MRT matrix")
        return np.linalg.inv(self.M)

    @cached_property
    def ex(self) -> np.ndarray:
        return self.e[:, 0].astype(np.float64)

    @cached_property
    def ey(self) -> np.ndarray:
        return self.e[:, 1].astype(np.float64)

    @cached_property
    def ez(self) -> np.ndarray:
        if self.dim < 3:
            raise ValueError(f"{self.name} is {self.dim}D")
        return self.e[:, 2].astype(np.float64)

    @cached_property
    def e_norm(self) -> np.ndarray:
        """|e_i| per direction (used by LKR recoloring)."""
        return np.sqrt((self.e.astype(np.float64) ** 2).sum(axis=1))

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, Lattice) and other.name == self.name


def _d2q9_mrt_matrix() -> np.ndarray:
    """Lallemand-Luo moment matrix in the reference's direction ordering.

    Rows: rho, e(energy), eps, j_x, q_x, j_y, q_y, p_xx, p_xy.
    Mirrors ``RKD2Q9.py:309-336`` / ``SimpleD2Q9.py:107-124``.
    """
    M = np.zeros((9, 9), dtype=np.float64)
    M[0, :] = 1.0
    M[1, :] = [-4.0, -1.0, -1.0, -1.0, -1.0, 2.0, 2.0, 2.0, 2.0]
    M[2, :] = [4.0, -2.0, -2.0, -2.0, -2.0, 1.0, 1.0, 1.0, 1.0]
    M[3, :] = [0.0, 1.0, 0.0, -1.0, 0.0, 1.0, -1.0, -1.0, 1.0]   # e_x
    M[4, :] = [0.0, -2.0, 0.0, 2.0, 0.0, 1.0, -1.0, -1.0, 1.0]
    M[5, :] = [0.0, 0.0, 1.0, 0.0, -1.0, 1.0, 1.0, -1.0, -1.0]   # e_y
    M[6, :] = [0.0, 0.0, -2.0, 0.0, 2.0, 1.0, 1.0, -1.0, -1.0]
    M[7, :] = [0.0, 1.0, -1.0, 1.0, -1.0, 0.0, 0.0, 0.0, 0.0]    # e_x^2-e_y^2
    M[8, :] = [0.0, 0.0, 0.0, 0.0, 0.0, 1.0, -1.0, 1.0, -1.0]    # e_x*e_y
    return M


D2Q9 = Lattice(
    name="D2Q9",
    e=[(0, 0), (1, 0), (0, 1), (-1, 0), (0, -1),
       (1, 1), (-1, 1), (-1, -1), (1, -1)],
    w=[4 / 9] + [1 / 9] * 4 + [1 / 36] * 4,
    opp=[0, 3, 4, 1, 2, 7, 8, 5, 6],
    M=_d2q9_mrt_matrix(),
)


def _d2q5_mrt_matrix() -> np.ndarray:
    """Transport D2Q5 moment matrix, ``Transport2DRK.py:316-321``."""
    M = np.ones((5, 5), dtype=np.float64)
    M[1, :] = [0.0, 1.0, -1.0, 0.0, 0.0]    # e_x
    M[2, :] = [0.0, 0.0, 0.0, 1.0, -1.0]    # e_y
    M[3, :] = [4.0, -1.0, -1.0, -1.0, -1.0]
    M[4, :] = [0.0, 1.0, 1.0, -1.0, -1.0]
    return M


D2Q5 = Lattice(
    name="D2Q5",
    e=[(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)],
    w=[1 / 3] + [1 / 6] * 4,
    opp=[0, 2, 1, 4, 3],
    M=_d2q5_mrt_matrix(),
)


def _d3q19_velocities() -> list[tuple[int, int, int]]:
    e = [(0, 0, 0)]
    # 6 axis directions
    e += [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    # 12 face diagonals
    e += [(1, 1, 0), (-1, -1, 0), (1, -1, 0), (-1, 1, 0),
          (1, 0, 1), (-1, 0, -1), (1, 0, -1), (-1, 0, 1),
          (0, 1, 1), (0, -1, -1), (0, 1, -1), (0, -1, 1)]
    return e


def _opposites_from_e(e: np.ndarray) -> np.ndarray:
    e = np.asarray(e)
    opp = np.zeros(len(e), dtype=np.int32)
    for i, v in enumerate(e):
        (j,) = np.where((e == -v).all(axis=1))[0]
        opp[i] = j
    return opp


_E19 = np.asarray(_d3q19_velocities())
D3Q19 = Lattice(
    name="D3Q19",
    e=_E19,
    w=[1 / 3] + [1 / 18] * 6 + [1 / 36] * 12,
    opp=_opposites_from_e(_E19),
)

_E7 = np.asarray([(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                  (0, 0, 1), (0, 0, -1)])
D3Q7 = Lattice(
    name="D3Q7",
    e=_E7,
    w=[1 / 4] + [1 / 8] * 6,
    opp=_opposites_from_e(_E7),
)


# ---------------------------------------------------------------------------
# High-isotropy interaction stencils (explicit forcing scheme, Porter 2012)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IsoStencil:
    """Interaction stencil of a given isotropy order.

    offsets: (N, 2) int array of (dx, dy) neighbor offsets.
    weights: (N,) float64 weights w(|c|^2).
    """

    order: int
    offsets: np.ndarray
    weights: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "offsets", np.asarray(self.offsets, np.int32))
        object.__setattr__(self, "weights", np.asarray(self.weights, np.float64))

    def __hash__(self):
        return hash(("iso", self.order))


def _iso_stencil(order: int) -> IsoStencil:
    """Build the 2D isotropy stencil of the given order.

    Weight tables follow ``ShanChenD2Q9.py:1675-1689`` (orders 4/8/10); the
    mapping weight-by-|c|^2 follows Sbragaglia et al. 2007 as used by Porter
    et al. 2012.
    """
    w_by_c2 = {
        4: {1: 1 / 3, 2: 1 / 12},
        8: {1: 4 / 21, 2: 4 / 45, 4: 1 / 60, 5: 2 / 315, 8: 1 / 5040},
        10: {1: 262 / 1785, 2: 93 / 1190, 4: 7 / 340, 5: 6 / 595,
             8: 9 / 9520, 9: 2 / 5355, 10: 1 / 7140},
    }[order]
    max_r = {4: 1, 8: 2, 10: 3}[order]
    offsets, weights = [], []
    for dy in range(-max_r, max_r + 1):
        for dx in range(-max_r, max_r + 1):
            c2 = dx * dx + dy * dy
            if c2 in w_by_c2:
                offsets.append((dx, dy))
                weights.append(w_by_c2[c2])
    return IsoStencil(order=order, offsets=np.array(offsets),
                      weights=np.array(weights))


ISO_STENCILS: dict[int, IsoStencil] = {k: _iso_stencil(k) for k in (4, 8, 10)}
