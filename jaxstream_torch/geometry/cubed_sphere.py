"""Equiangular (gnomonic) cubed-sphere geometry.

Counterpart of :mod:`jaxstream.geometry.cubed_sphere` (the eager grid;
the lazy grid comes later).  Every metric term is computed once in
float64 numpy with the same formulas and then cast to the run dtype in
one step, so the tensors are bitwise equal to the JAX package's.

Layout: scalars ``(6, M, M)``, vectors ``(3, 6, M, M)`` with the
Cartesian component leading, ``M = n + 2*halo``, index ``[face, j, i]``
with ``i`` along alpha and ``j`` along beta.  ``*_xf`` quantities live
at the left alpha-face of a cell, ``*_yf`` at the bottom beta-face.

Face layout: faces 0..3 are equatorial at longitudes 0, 90, 180, 270
degrees, face 4 the north cap, face 5 the south cap; each face map
``P(X, Y) = c0 + cx*X + cy*Y`` (normalized) is right-handed with
``X = tan(alpha)``, ``Y = tan(beta)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device

__all__ = [
    "FACE_AXES",
    "NUM_FACES",
    "extended_coords",
    "face_points",
    "CubedSphereGrid",
    "build_grid",
]

NUM_FACES = 6

# (c0, cx, cy) per face; P = c0 + cx*X + cy*Y, right-handed: cx x cy = c0.
FACE_AXES = np.array(
    [
        [[1, 0, 0], [0, 1, 0], [0, 0, 1]],    # 0: +x, lon 0
        [[0, 1, 0], [-1, 0, 0], [0, 0, 1]],   # 1: +y, lon 90E
        [[-1, 0, 0], [0, -1, 0], [0, 0, 1]],  # 2: -x, lon 180
        [[0, -1, 0], [1, 0, 0], [0, 0, 1]],   # 3: -y, lon 270E
        [[0, 0, 1], [0, 1, 0], [-1, 0, 0]],   # 4: +z, north
        [[0, 0, -1], [0, 1, 0], [1, 0, 0]],   # 5: -z, south
    ],
    dtype=np.float64,
)


def extended_coords(n: int, halo: int):
    """1-D equiangular coordinates of the halo-extended grid (float64).

    Returns ``(ac, af, d)``: cell-center coords (M,), left-face coords
    (M,), and the spacing ``d = (pi/2)/n``.
    """
    m = n + 2 * halo
    d = (np.pi / 2) / n
    ac = -np.pi / 4 + (np.arange(m) - halo + 0.5) * d
    return ac, ac - 0.5 * d, d


def face_points(face: int, alpha, beta) -> np.ndarray:
    """Unit-sphere Cartesian points ``(..., 3)`` for equiangular coords."""
    c0, cx, cy = FACE_AXES[face]
    x = np.tan(np.asarray(alpha, dtype=np.float64))
    y = np.tan(np.asarray(beta, dtype=np.float64))
    p = (
        c0[(None,) * x.ndim]
        + x[..., None] * cx[(None,) * x.ndim]
        + y[..., None] * cy[(None,) * y.ndim]
    )
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


def _basis_and_metric(face: int, alpha, beta, radius: float):
    """Covariant/dual bases and metric at equiangular coords (float64)."""
    c0, cx, cy = FACE_AXES[face]
    x = np.tan(np.asarray(alpha, dtype=np.float64))
    y = np.tan(np.asarray(beta, dtype=np.float64))
    shp = np.broadcast_shapes(x.shape, y.shape)
    x = np.broadcast_to(x, shp)
    y = np.broadcast_to(y, shp)
    p = c0 + x[..., None] * cx + y[..., None] * cy
    rho = np.linalg.norm(p, axis=-1, keepdims=True)
    rhat = p / rho

    dx_da = 1.0 + x * x
    dy_db = 1.0 + y * y
    pc_x = np.sum(rhat * cx, axis=-1, keepdims=True)
    pc_y = np.sum(rhat * cy, axis=-1, keepdims=True)
    e_a = radius * dx_da[..., None] * (cx - rhat * pc_x) / rho
    e_b = radius * dy_db[..., None] * (cy - rhat * pc_y) / rho

    gaa = np.sum(e_a * e_a, axis=-1)
    gab = np.sum(e_a * e_b, axis=-1)
    gbb = np.sum(e_b * e_b, axis=-1)
    det = gaa * gbb - gab * gab
    inv_aa = gbb / det
    inv_ab = -gab / det
    inv_bb = gaa / det
    return {
        "r": radius * rhat,
        "rhat": rhat,
        "e_a": e_a,
        "e_b": e_b,
        "a_a": inv_aa[..., None] * e_a + inv_ab[..., None] * e_b,
        "a_b": inv_ab[..., None] * e_a + inv_bb[..., None] * e_b,
        "sqrtg": np.sqrt(det),
        "inv_gaa": inv_aa,
        "inv_gab": inv_ab,
        "inv_gbb": inv_bb,
    }


@dataclasses.dataclass(frozen=True, eq=False)
class CubedSphereGrid:
    """Precomputed cubed-sphere geometry on the halo-extended grid.

    Every tensor lives on ``device`` in ``dtype``; see the module
    docstring for the layout.
    """

    n: int
    halo: int
    radius: float
    dalpha: float
    device: torch.device
    dtype: torch.dtype
    # Cell-center quantities.
    xyz: torch.Tensor
    khat: torch.Tensor
    lon: torch.Tensor
    lat: torch.Tensor
    e_a: torch.Tensor
    e_b: torch.Tensor
    a_a: torch.Tensor
    a_b: torch.Tensor
    sqrtg: torch.Tensor
    area: torch.Tensor
    # Left/bottom cell-face quantities for fluxes.
    sqrtg_xf: torch.Tensor
    a_a_xf: torch.Tensor
    sqrtg_yf: torch.Tensor
    a_b_yf: torch.Tensor
    ginv_aa_xf: torch.Tensor
    ginv_ab_xf: torch.Tensor
    ginv_bb_yf: torch.Tensor
    ginv_ab_yf: torch.Tensor

    @property
    def m(self) -> int:
        return self.n + 2 * self.halo

    def interior(self, field):
        """Slice the interior ``(..., 6, n, n)`` out of an extended field."""
        h = self.halo
        return field[..., h : h + self.n, h : h + self.n]

    def total_area(self) -> float:
        return float(torch.sum(self.interior(self.area)))


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def build_grid(n: int, halo: int = 2, radius: float = 1.0,
               dtype: torch.dtype = torch.float32, device=None):
    """Build the grid geometry on ``device`` (default: the GPU).

    Metric terms are computed in float64 numpy and cast once to
    ``dtype`` — the same values as ``jaxstream.geometry.cubed_sphere.
    build_grid(metrics='eager')``.
    """
    dev = resolve_device(device)
    ac, af, d = extended_coords(n, halo)

    cc: dict = {k: [] for k in ("xyz", "khat", "e_a", "e_b", "a_a", "a_b",
                                "sqrtg")}
    xf: dict = {k: [] for k in ("sqrtg", "a_a", "inv_gaa", "inv_gab")}
    yf: dict = {k: [] for k in ("sqrtg", "a_b", "inv_gbb", "inv_gab")}
    lon_l, lat_l = [], []
    for f in range(NUM_FACES):
        # Centers: alpha varies along axis -1 (i), beta along axis -2 (j).
        bb, aa = np.meshgrid(ac, ac, indexing="ij")
        g = _basis_and_metric(f, aa, bb, radius)
        cc["xyz"].append(g["r"])
        cc["khat"].append(g["rhat"])
        for k in ("e_a", "e_b", "a_a", "a_b", "sqrtg"):
            cc[k].append(g[k])
        lon_l.append(np.arctan2(g["rhat"][..., 1], g["rhat"][..., 0]))
        lat_l.append(np.arcsin(np.clip(g["rhat"][..., 2], -1.0, 1.0)))
        # Alpha-faces: alpha at af, beta at centers.
        bb2, aa2 = np.meshgrid(ac, af, indexing="ij")
        gx = _basis_and_metric(f, aa2, bb2, radius)
        xf["sqrtg"].append(gx["sqrtg"])
        xf["a_a"].append(gx["a_a"])
        xf["inv_gaa"].append(gx["inv_gaa"])
        xf["inv_gab"].append(gx["inv_gab"])
        # Beta-faces: alpha at centers, beta at af.
        bb3, aa3 = np.meshgrid(af, ac, indexing="ij")
        gy = _basis_and_metric(f, aa3, bb3, radius)
        yf["sqrtg"].append(gy["sqrtg"])
        yf["a_b"].append(gy["a_b"])
        yf["inv_gbb"].append(gy["inv_gbb"])
        yf["inv_gab"].append(gy["inv_gab"])

    npdt = _np_dtype(dtype)

    def T(arr):
        return torch.from_numpy(np.ascontiguousarray(arr.astype(npdt))).to(dev)

    def S(arrs):
        return T(np.stack(arrs))

    def V(arrs):
        # (6, M, M, 3) -> (3, 6, M, M): component-leading vector layout.
        return T(np.moveaxis(np.stack(arrs), -1, 0))

    sqrtg = np.stack(cc["sqrtg"])
    return CubedSphereGrid(
        n=n, halo=halo, radius=radius, dalpha=d, device=dev, dtype=dtype,
        xyz=V(cc["xyz"]), khat=V(cc["khat"]), lon=S(lon_l), lat=S(lat_l),
        e_a=V(cc["e_a"]), e_b=V(cc["e_b"]), a_a=V(cc["a_a"]),
        a_b=V(cc["a_b"]), sqrtg=S(cc["sqrtg"]), area=T(sqrtg * d * d),
        sqrtg_xf=S(xf["sqrtg"]), a_a_xf=V(xf["a_a"]),
        sqrtg_yf=S(yf["sqrtg"]), a_b_yf=V(yf["a_b"]),
        ginv_aa_xf=S(xf["inv_gaa"]), ginv_ab_xf=S(xf["inv_gab"]),
        ginv_bb_yf=S(yf["inv_gbb"]), ginv_ab_yf=S(yf["inv_gab"]),
    )
