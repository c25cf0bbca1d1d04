"""Equiangular (gnomonic) cubed-sphere geometry.

Counterpart of :mod:`jaxstream.geometry.cubed_sphere`.  The eager grid
(:class:`CubedSphereGrid`) computes every metric term once in float64
numpy with the same formulas and then casts it to the run dtype in one
step, so its tensors are bitwise equal to the JAX package's.  The lazy
grid (:class:`LazyCubedSphereGrid`) stores only the 1-D gnomonic
coordinates and evaluates each metric attribute as a torch expression in
the run dtype on every access, as the JAX package's lazy grid emits jnp
expressions.  :func:`sphere_to_face_coords` is the inverse gnomonic map
(float64 numpy, the JAX function's operations).

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
    "sphere_to_face_coords",
    "CubedSphereGrid",
    "LazyCubedSphereGrid",
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


def sphere_to_face_coords(xyz):
    """Inverse gnomonic map: unit vectors -> ``(face, alpha, beta)``.

    ``xyz``: (..., 3) points on (or off: they are centrally projected to)
    the unit sphere.  The owning face is the one whose outward axis has
    the largest positive projection, which partitions the sphere exactly
    (ties on edges go to the lowest face index); ``alpha``/``beta`` lie in
    [-pi/4, pi/4].  Float64 numpy throughout, bit for bit the JAX
    package's function.
    """
    p = np.asarray(xyz, dtype=np.float64)
    c0 = FACE_AXES[:, 0, :]                        # (6, 3)
    proj = np.tensordot(p, c0, axes=([-1], [-1]))  # (..., 6)
    face = np.argmax(proj, axis=-1)
    fa = FACE_AXES[face]                           # (..., 3, 3)
    d0 = np.sum(p * fa[..., 0, :], axis=-1)
    dx = np.sum(p * fa[..., 1, :], axis=-1)
    dy = np.sum(p * fa[..., 2, :], axis=-1)
    return face, np.arctan2(dx, d0), np.arctan2(dy, d0)


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


class LazyCubedSphereGrid:
    """Metric terms computed on access from 1-D coordinate tensors.

    The equiangular metric is rank-1 separable: with ``X = tan(alpha)``
    varying only along columns and ``Y = tan(beta)`` only along rows,
    every metric quantity is a closed-form elementwise function of
    broadcast 1-D tensors and per-face constant frames.  The 1-D
    coordinates are computed in float64 numpy and cast once; each metric
    attribute is then a torch expression in ``dtype`` on ``device``,
    evaluated anew at every access (PyTorch runs eagerly, so nothing
    fuses it into the consumer as XLA does), with the JAX package's
    operations in its order.  Same attribute surface as
    :class:`CubedSphereGrid`; like the JAX lazy grid, the inverse-metric
    attributes keep their broadcast shape ``(1, M, M)`` and ``sqrtg`` is
    expanded to ``(6, M, M)``.
    """

    def __init__(self, n: int, halo: int, radius: float,
                 dtype: torch.dtype, device: torch.device):
        self.n = n
        self.halo = halo
        self.radius = radius
        self.dtype = dtype
        self.device = device
        ac, af, d = extended_coords(n, halo)
        self.dalpha = d

        def T(a):
            return torch.from_numpy(
                np.ascontiguousarray(a.astype(_np_dtype(dtype)))).to(device)

        # The only stored geometry: 2 x (M,) gnomonic coordinates.
        self._xc = T(np.tan(ac))
        self._xf = T(np.tan(af))
        # Per-face frames as (3, 6, 1, 1), component leading.
        fa = np.transpose(FACE_AXES, (2, 1, 0))[:, :, :, None, None]
        self._c0, self._cx, self._cy = (T(fa[:, i]) for i in range(3))
        # The scalars of the expressions, as 0-d tensors in the run dtype
        # (made once: no host-to-device copy per access).
        self._one, self._R, self._dd = (
            torch.tensor(v, dtype=dtype, device=device)
            for v in (1.0, radius, d * d))

    @property
    def m(self) -> int:
        return self.n + 2 * self.halo

    def interior(self, field):
        h = self.halo
        return field[..., h : h + self.n, h : h + self.n]

    def total_area(self) -> float:
        return float(torch.sum(self.interior(self.area)))

    def _xy(self, at: str):
        """Broadcastable (1, 1, M) / (1, M, 1) X, Y at centers (cc),
        alpha-faces (xf) or beta-faces (yf)."""
        xc = self._xc[None, None, :]
        yc = self._xc[None, :, None]
        if at == "cc":
            return xc, yc
        if at == "xf":
            return self._xf[None, None, :], yc
        if at == "yf":
            return xc, self._xf[None, :, None]
        raise ValueError(at)

    def _basis(self, at: str) -> dict:
        """The metric expressions at one point set: the float64 formulas
        of :func:`_basis_and_metric`, with the closed-form 2x2 metric of
        the equiangular map (``g_aa = R^2 (1+X^2)^2 (1+Y^2) / rho^4``,
        ``g_bb`` likewise, ``g_ab = -R^2 (1+X^2)(1+Y^2) X Y / rho^4``,
        ``sqrtg = R^2 (1+X^2)(1+Y^2) / rho^3``)."""
        x, y = self._xy(at)
        one = self._one
        rho2 = one + x * x + y * y
        rho = torch.sqrt(rho2)
        p = self._c0 + x[None] * self._cx + y[None] * self._cy
        rhat = p / rho[None]
        dx_da = one + x * x
        dy_db = one + y * y
        pc_x = torch.sum(rhat * self._cx, dim=0)
        pc_y = torch.sum(rhat * self._cy, dim=0)
        R = self._R
        e_a = (R * dx_da / rho)[None] * (self._cx - rhat * pc_x[None])
        e_b = (R * dy_db / rho)[None] * (self._cy - rhat * pc_y[None])
        R2 = R * R
        rho4 = rho2 * rho2
        gcom = R2 * dx_da * dy_db / rho4
        gaa = gcom * dx_da
        gbb = gcom * dy_db
        gab = -gcom * x * y
        det = gaa * gbb - gab * gab
        sqrtg = R2 * dx_da * dy_db / (rho2 * rho)
        inv_aa = gbb / det
        inv_ab = -gab / det
        inv_bb = gaa / det
        return {
            "rhat": rhat,
            "e_a": e_a,
            "e_b": e_b,
            "a_a": inv_aa[None] * e_a + inv_ab[None] * e_b,
            "a_b": inv_ab[None] * e_a + inv_bb[None] * e_b,
            "sqrtg": sqrtg.expand(self._c0.shape[1], self.m, self.m),
            "inv_gaa": inv_aa,
            "inv_gab": inv_ab,
            "inv_gbb": inv_bb,
        }

    # -- CubedSphereGrid's attribute surface ------------------------------
    @property
    def xyz(self):
        return self._R * self._basis("cc")["rhat"]

    @property
    def khat(self):
        return self._basis("cc")["rhat"]

    @property
    def lon(self):
        r = self._basis("cc")["rhat"]
        return torch.atan2(r[1], r[0])

    @property
    def lat(self):
        r = self._basis("cc")["rhat"]
        return torch.asin(torch.clamp(r[2], -1.0, 1.0))

    @property
    def e_a(self):
        return self._basis("cc")["e_a"]

    @property
    def e_b(self):
        return self._basis("cc")["e_b"]

    @property
    def a_a(self):
        return self._basis("cc")["a_a"]

    @property
    def a_b(self):
        return self._basis("cc")["a_b"]

    @property
    def sqrtg(self):
        return self._basis("cc")["sqrtg"]

    @property
    def area(self):
        return self.sqrtg * self._dd

    @property
    def sqrtg_xf(self):
        return self._basis("xf")["sqrtg"]

    @property
    def a_a_xf(self):
        return self._basis("xf")["a_a"]

    @property
    def sqrtg_yf(self):
        return self._basis("yf")["sqrtg"]

    @property
    def a_b_yf(self):
        return self._basis("yf")["a_b"]

    @property
    def ginv_aa_xf(self):
        return self._basis("xf")["inv_gaa"]

    @property
    def ginv_ab_xf(self):
        return self._basis("xf")["inv_gab"]

    @property
    def ginv_bb_yf(self):
        return self._basis("yf")["inv_gbb"]

    @property
    def ginv_ab_yf(self):
        return self._basis("yf")["inv_gab"]


#: The metric attributes of both grids, in :class:`CubedSphereGrid`'s
#: field order.
METRIC_ATTRS = tuple(f.name for f in dataclasses.fields(CubedSphereGrid)
                     if f.name not in ("n", "halo", "radius", "dalpha",
                                       "device", "dtype"))


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def build_grid(n: int, halo: int = 2, radius: float = 1.0,
               dtype: torch.dtype = torch.float32, device=None,
               metrics: str = "eager"):
    """Build the grid geometry on ``device`` (default: the GPU).

    ``metrics='eager'``: a :class:`CubedSphereGrid` whose metric terms
    are computed in float64 numpy and cast once to ``dtype``, the same
    values as ``jaxstream.geometry.cubed_sphere.build_grid(metrics=
    'eager')``.  ``metrics='lazy'``: a :class:`LazyCubedSphereGrid`,
    whose metric chain evaluates in ``dtype`` on every access (use
    float32 or wider).
    """
    dev = resolve_device(device)
    if metrics == "lazy":
        return LazyCubedSphereGrid(n, halo, radius, dtype, dev)
    if metrics != "eager":
        raise ValueError(f"metrics must be 'eager' or 'lazy', got {metrics!r}")
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
