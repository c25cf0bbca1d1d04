"""The Cartesian shallow-water right-hand side: closed-form metric terms,
the plain RHS cores and the wrapper of the CUDA RHS kernel.

Counterpart of :mod:`jaxstream.ops.pallas.swe_rhs`.  The equiangular
metric is rank-1 separable: every quantity the RHS needs is a
closed-form function of ``X = tan(alpha)`` along a row and
``Y = tan(beta)`` along a column, so the kernels rebuild it per cell from
two coordinate vectors and the per-face frame instead of streaming metric
fields from memory.

* :func:`coord_rows`, :func:`_basis` (the general basis: rhat, sqrtg,
  e_a/e_b, the inverse metric through its 2x2 determinant) and
  :func:`_fast_frame` (the orthonormal-frame closed forms, shared with
  the covariant kernels);
* :func:`rhs_core` and :func:`rhs_core_fast`: the two cores of the
  Cartesian RHS (upwind PLR-MC mass flux, vorticity, Bernoulli gradient,
  Coriolis, tangent projection) for all faces at once, with the JAX
  package's operations in its order;
* :class:`SweRhs` (:func:`make_swe_rhs_pallas`): the RHS of ghost-filled
  extended faces.  CUDA tensors launch ``csrc/swe_rhs.cu`` (the port of
  the Pallas kernel ``make_swe_rhs_pallas``), CPU tensors run the plain
  version :func:`swe_rhs_reference`, which is :func:`rhs_core`.

Layouts: ``h``, ``b`` ``(6, M, M)``; the Cartesian velocity ``v``
component-leading ``(3, 6, M, M)``; tendencies ``(6, n, n)`` /
``(3, 6, n, n)``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...geometry.cubed_sphere import FACE_AXES, extended_coords
from ..reconstruct import plr_face_states
from ._launch import KernelBase, _P, _check_tensors, _entry

__all__ = ["coord_rows", "_fast_frame", "_basis", "pick_recon", "rhs_core",
           "rhs_core_fast", "swe_rhs_reference", "SweRhs",
           "make_swe_rhs_pallas"]


def coord_rows(n: int, halo: int, device):
    """Gnomonic coordinate rows/columns (float32) plus face frames.

    Returns ``(x_row, xf_row, x_col, xf_col, frames)``: ``(1, M)`` /
    ``(M, 1)`` tan-coordinates of cell centers and left faces, and the
    ``(6, 3, 3)`` face-frame table (c0, cx, cy per face).
    """
    ac, af, _ = extended_coords(n, halo)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(
            a.astype(np.float32))).to(device)

    xc, xf = np.tan(ac), np.tan(af)
    return (T(xc)[None, :], T(xf)[None, :], T(xc)[:, None], T(xf)[:, None],
            T(FACE_AXES))


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (an exact f32 scalar)."""
    return float(np.float32(x))


def _frame_vec(frames, k):
    """Frame vector ``k`` (0: c0, 1: cx, 2: cy) of every face as three
    ``(F, 1, 1)`` components, the JAX kernels' per-face scalars."""
    return tuple(frames[:, k, i].reshape(-1, 1, 1) for i in range(3))


def _basis(xr, yc, c0, cx, cy, radius: float, need):
    """Metric quantities on the grid ``xr`` x ``yc`` ((1, mx) x (my, 1)).

    ``c0``/``cx``/``cy``: the face frame, three components each,
    broadcastable against the grid.  Returns a dict restricted to
    ``need`` (``"rhat"``, ``"sqrtg"``, ``"e"``, ``"a"``); the operations
    of the JAX package's ``_basis`` in its order, float32 throughout.
    """
    R = _f32(radius)
    R2 = _f32(R * R)
    x2 = xr * xr
    y2 = yc * yc
    rho2 = 1.0 + x2 + y2
    inv_rho = torch.rsqrt(rho2)
    inv_rho2 = inv_rho * inv_rho
    dxda = 1.0 + x2
    dydb = 1.0 + y2

    out = {}
    p = [c0[i] + xr * cx[i] + yc * cy[i] for i in range(3)]
    rhat = [p[i] * inv_rho for i in range(3)]
    if "rhat" in need:
        out["rhat"] = rhat
    if "sqrtg" in need:
        out["sqrtg"] = R2 * dxda * dydb * inv_rho * inv_rho2
    if "e" in need or "a" in need:
        pcx = rhat[0] * cx[0] + rhat[1] * cx[1] + rhat[2] * cx[2]
        pcy = rhat[0] * cy[0] + rhat[1] * cy[1] + rhat[2] * cy[2]
        fa = R * dxda * inv_rho
        fb = R * dydb * inv_rho
        e_a = [fa * (cx[i] - rhat[i] * pcx) for i in range(3)]
        e_b = [fb * (cy[i] - rhat[i] * pcy) for i in range(3)]
        if "e" in need:
            out["e_a"] = e_a
            out["e_b"] = e_b
        if "a" in need:
            # Closed-form 2x2 inverse metric of the equiangular map.
            inv_rho4 = inv_rho2 * inv_rho2
            gcom = R2 * dxda * dydb * inv_rho4
            gaa = gcom * dxda
            gbb = gcom * dydb
            gab = -gcom * xr * yc
            inv_det = 1.0 / (gaa * gbb - gab * gab)
            inv_aa = gbb * inv_det
            inv_ab = -gab * inv_det
            inv_bb = gaa * inv_det
            out["a_a"] = [inv_aa * e_a[i] + inv_ab * e_b[i] for i in range(3)]
            out["a_b"] = [inv_ab * e_a[i] + inv_bb * e_b[i] for i in range(3)]
    return out


def _fast_frame(xr, yc, radius: float):
    """Scalar metric fields from the orthonormal-frame closed forms.

    ``xr``: (..., 1, mx) row of X; ``yc``: (..., my, 1) column of Y.
    Same operations, in the same order, as the JAX package's
    ``_fast_frame`` (float32 throughout).
    """
    R = _f32(radius)
    R2 = _f32(R * R)
    x2r = xr * xr
    y2c = yc * yc
    dxda_r = 1.0 + x2r
    dydb_c = 1.0 + y2c
    rho2 = dxda_r + y2c
    inv_rho = torch.rsqrt(rho2)
    inv_rho2 = inv_rho * inv_rho
    inv_R2dxda_r = 1.0 / (R2 * dxda_r)
    inv_dydb_c = 1.0 / dydb_c
    sg_row = R2 * dxda_r
    return {
        "x": xr, "y": yc,
        "inv_rho": inv_rho, "inv_rho2": inv_rho2,
        "fa": (R * dxda_r) * inv_rho,
        "fb": (R * dydb_c) * inv_rho,
        "inv_aa": rho2 * inv_R2dxda_r,
        "inv_bb": (rho2 * inv_R2dxda_r) * (dxda_r * inv_dydb_c),
        "inv_ab": rho2 * ((xr * inv_R2dxda_r) * (yc * inv_dydb_c)),
        "sqrtg": (sg_row * dydb_c) * (inv_rho2 * inv_rho),
        "inv_sqrtg": ((1.0 / sg_row) * inv_dydb_c) * (rho2 * rho2 * inv_rho),
        # Flux-form (sqrtg-folded) inverse metric: sqrtg g^aa = (1+Y^2)/rho,
        # sqrtg g^bb = (1+X^2)/rho, sqrtg g^ab = X Y / rho.
        "fg_aa": dydb_c * inv_rho,
        "fg_bb": dxda_r * inv_rho,
        "fg_ab": (xr * yc) * inv_rho,
    }


def pick_recon(scheme: str, halo: int, n: int, limiter: str):
    """Face-state reconstruction of the cores: ``recon(q, axis) -> (qL,
    qR)``.  PLR only; PPM waits for ROADMAP queue A item 1."""
    if scheme != "plr":
        raise NotImplementedError(
            f"scheme={scheme!r}: only PLR is ported (PPM is ROADMAP "
            "queue A item 1, ops/reconstruct.py)")

    def recon(q, axis):
        return plr_face_states(q, axis, halo, n, limiter)

    return recon


def _upwind(u, qL, qR):
    return torch.clamp(u, min=0.0) * qL + torch.clamp(u, max=0.0) * qR


def rhs_core(frames, xr, xfr, yc, yfc, hf, v, bf, *, n, halo, d, radius,
             gravity, omega, limiter="mc"):
    """The Cartesian SWE right-hand side of all faces at once, through
    the general basis :func:`_basis` (plain torch).

    ``frames`` (F, 3, 3) the faces' frames; ``xr``/``xfr`` (1, M) and
    ``yc``/``yfc`` (M, 1) coordinate rows/columns; ``hf``, ``bf``
    (F, M, M) and ``v`` (3, F, M, M) (or three (F, M, M)) with edge
    ghosts filled (corners are never read by a kept output).  Returns
    interior ``(dh, [dv0, dv1, dv2])``.  The operations and their order
    follow the JAX package's ``rhs_core``.
    """
    h0, h1 = halo, halo + n
    inv2d = _f32(1.0 / (2.0 * d))
    inv_d = _f32(1.0 / d)
    c0, cx, cy = (_frame_vec(frames, k) for k in range(3))
    g = _f32(gravity)
    two_omega = _f32(2.0 * omega)
    recon = pick_recon("plr", halo, n, limiter)

    # ---- continuity: dh = -div(h v), PLR-upwind flux form ------------
    bx = _basis(xfr[:, h0:h1 + 1], yc[h0:h1], c0, cx, cy, radius,
                need=("a", "sqrtg"))
    vxf = [0.5 * (v[i][:, h0:h1, h0 - 1:h1] + v[i][:, h0:h1, h0:h1 + 1])
           for i in range(3)]
    ux = (vxf[0] * bx["a_a"][0] + vxf[1] * bx["a_a"][1]
          + vxf[2] * bx["a_a"][2])
    qL, qR = recon(hf[:, h0:h1, :], -1)
    fx = bx["sqrtg"] * _upwind(ux, qL, qR)

    by = _basis(xr[:, h0:h1], yfc[h0:h1 + 1], c0, cx, cy, radius,
                need=("a", "sqrtg"))
    vyf = [0.5 * (v[i][:, h0 - 1:h1, h0:h1] + v[i][:, h0:h1 + 1, h0:h1])
           for i in range(3)]
    uy = (vyf[0] * by["a_b"][0] + vyf[1] * by["a_b"][1]
          + vyf[2] * by["a_b"][2])
    qL, qR = recon(hf[:, :, h0:h1], -2)
    fy = by["sqrtg"] * _upwind(uy, qL, qR)

    bc = _basis(xr[:, h0:h1], yc[h0:h1], c0, cx, cy, radius,
                need=("rhat", "sqrtg", "a"))
    inv_sg = 1.0 / bc["sqrtg"]
    inv_sg_d = inv_sg * inv_d
    dh = -((fx[..., 1:] - fx[..., :-1])
           + (fy[..., 1:, :] - fy[..., :-1, :])) * inv_sg_d

    # ---- momentum: vector-invariant with Cartesian velocity ----------
    b0, b1 = h0 - 1, h1 + 1
    bb = _basis(xr[:, b0:b1], yc[b0:b1], c0, cx, cy, radius, need=("e",))
    vb = [v[i][:, b0:b1, b0:b1] for i in range(3)]
    va = vb[0] * bb["e_a"][0] + vb[1] * bb["e_a"][1] + vb[2] * bb["e_a"][2]
    vbeta = (vb[0] * bb["e_b"][0] + vb[1] * bb["e_b"][1]
             + vb[2] * bb["e_b"][2])
    dvb_da = (vbeta[:, 1:-1, 2:] - vbeta[:, 1:-1, :-2]) * inv2d
    dva_db = (va[:, 2:, 1:-1] - va[:, :-2, 1:-1]) * inv2d
    zeta = (dvb_da - dva_db) * inv_sg

    ke = 0.5 * (vb[0] * vb[0] + vb[1] * vb[1] + vb[2] * vb[2])
    bern = g * (hf[:, b0:b1, b0:b1] + bf[:, b0:b1, b0:b1]) + ke
    dpa = (bern[:, 1:-1, 2:] - bern[:, 1:-1, :-2]) * inv2d
    dpb = (bern[:, 2:, 1:-1] - bern[:, :-2, 1:-1]) * inv2d

    k = bc["rhat"]
    absv = zeta + two_omega * k[2]
    vi = [v[i][:, h0:h1, h0:h1] for i in range(3)]
    # Tangentialize, then k x v, then assemble and re-project.
    vdotk = vi[0] * k[0] + vi[1] * k[1] + vi[2] * k[2]
    vt = [vi[i] - k[i] * vdotk for i in range(3)]
    kxv = [k[1] * vt[2] - k[2] * vt[1],
           k[2] * vt[0] - k[0] * vt[2],
           k[0] * vt[1] - k[1] * vt[0]]
    a_a, a_b = bc["a_a"], bc["a_b"]
    dv = [-absv * kxv[i] - (a_a[i] * dpa + a_b[i] * dpb) for i in range(3)]
    dvdotk = dv[0] * k[0] + dv[1] * k[1] + dv[2] * k[2]
    return dh, [dv[i] - k[i] * dvdotk for i in range(3)]


def rhs_core_fast(frames, xr, xfr, yc, yfc, hf, v, bf, *, n, halo, d,
                  radius, gravity, omega, limiter="mc"):
    """The flop-lean twin of :func:`rhs_core` (same discretization): the
    metric algebra runs through :func:`_fast_frame`'s scalar forms and the
    three frame dot products of ``v``.  Arguments and result as for
    :func:`rhs_core`; the operations follow the JAX package's
    ``rhs_core_fast``."""
    h0, h1 = halo, halo + n
    inv2d = _f32(1.0 / (2.0 * d))
    inv_d = _f32(1.0 / d)
    c0, cx, cy = (_frame_vec(frames, k) for k in range(3))
    g = _f32(gravity)
    two_omega = _f32(2.0 * omega)
    recon = pick_recon("plr", halo, n, limiter)

    def dots(vl):
        """(v.c0, v.cx, v.cy): the only 3-vector contractions needed."""
        return (vl[0] * c0[0] + vl[1] * c0[1] + vl[2] * c0[2],
                vl[0] * cx[0] + vl[1] * cx[1] + vl[2] * cx[2],
                vl[0] * cy[0] + vl[1] * cy[1] + vl[2] * cy[2])

    def covariant(F, d0, dxx, dyy):
        """(v.e_a, v.e_b) from the frame dots."""
        vp = d0 + F["x"] * dxx + F["y"] * dyy
        u = vp * F["inv_rho2"]
        return F["fa"] * (dxx - F["x"] * u), F["fb"] * (dyy - F["y"] * u)

    # ---- continuity ------------------------------------------------------
    Fx = _fast_frame(xfr[:, h0:h1 + 1], yc[h0:h1], radius)
    vxf = [0.5 * (v[i][:, h0:h1, h0 - 1:h1] + v[i][:, h0:h1, h0:h1 + 1])
           for i in range(3)]
    vea, veb = covariant(Fx, *dots(vxf))
    ux = Fx["inv_aa"] * vea + Fx["inv_ab"] * veb       # v . a_a
    qL, qR = recon(hf[:, h0:h1, :], -1)
    fx = Fx["sqrtg"] * _upwind(ux, qL, qR)

    Fy = _fast_frame(xr[:, h0:h1], yfc[h0:h1 + 1], radius)
    vyf = [0.5 * (v[i][:, h0 - 1:h1, h0:h1] + v[i][:, h0:h1 + 1, h0:h1])
           for i in range(3)]
    vea, veb = covariant(Fy, *dots(vyf))
    uy = Fy["inv_ab"] * vea + Fy["inv_bb"] * veb       # v . a_b
    qL, qR = recon(hf[:, :, h0:h1], -2)
    fy = Fy["sqrtg"] * _upwind(uy, qL, qR)

    Fc = _fast_frame(xr[:, h0:h1], yc[h0:h1], radius)
    inv_sg_d = Fc["inv_sqrtg"] * inv_d
    dh = -((fx[..., 1:] - fx[..., :-1])
           + (fy[..., 1:, :] - fy[..., :-1, :])) * inv_sg_d

    # ---- momentum --------------------------------------------------------
    b0, b1 = h0 - 1, h1 + 1
    Fb = _fast_frame(xr[:, b0:b1], yc[b0:b1], radius)
    vb = [v[i][:, b0:b1, b0:b1] for i in range(3)]
    va, vbeta = covariant(Fb, *dots(vb))
    dvb_da = (vbeta[:, 1:-1, 2:] - vbeta[:, 1:-1, :-2]) * inv2d
    dva_db = (va[:, 2:, 1:-1] - va[:, :-2, 1:-1]) * inv2d
    zeta = (dvb_da - dva_db) * Fc["inv_sqrtg"]

    ke = 0.5 * (vb[0] * vb[0] + vb[1] * vb[1] + vb[2] * vb[2])
    bern = g * (hf[:, b0:b1, b0:b1] + bf[:, b0:b1, b0:b1]) + ke
    dpa = (bern[:, 1:-1, 2:] - bern[:, 1:-1, :-2]) * inv2d
    dpb = (bern[:, 2:, 1:-1] - bern[:, :-2, 1:-1]) * inv2d

    # grad = a_a dpa + a_b dpb in the constant frame: A cx + B cy + C c0.
    ca = Fc["inv_aa"] * dpa + Fc["inv_ab"] * dpb
    cb = Fc["inv_ab"] * dpa + Fc["inv_bb"] * dpb
    uu = ca * Fc["fa"]
    ww = cb * Fc["fb"]
    tt = (uu * Fc["x"] + ww * Fc["y"]) * Fc["inv_rho2"]
    A = uu - tt * Fc["x"]
    B = ww - tt * Fc["y"]
    C = -tt
    grad = [A * cx[i] + B * cy[i] + C * c0[i] for i in range(3)]

    # rhat at centers, componentwise from the frame.
    ir = Fc["inv_rho"]
    k = [ir * (c0[i] + Fc["x"] * cx[i] + Fc["y"] * cy[i]) for i in range(3)]
    absv = zeta + two_omega * k[2]
    vi = [v[i][:, h0:h1, h0:h1] for i in range(3)]
    vdotk = vi[0] * k[0] + vi[1] * k[1] + vi[2] * k[2]
    vt = [vi[i] - k[i] * vdotk for i in range(3)]
    kxv = [k[1] * vt[2] - k[2] * vt[1],
           k[2] * vt[0] - k[0] * vt[2],
           k[0] * vt[1] - k[1] * vt[0]]
    dv = [-absv * kxv[i] - grad[i] for i in range(3)]
    dvdotk = dv[0] * k[0] + dv[1] * k[1] + dv[2] * k[2]
    return dh, [dv[i] - k[i] * dvdotk for i in range(3)]


class _SweBase(KernelBase):
    """Float32 constants, coordinate rows and face frames of the Cartesian
    right-hand side: what the Cartesian kernels' wrappers share.

    ``interpret=True`` runs the plain version on any device (the port's
    counterpart of the JAX kernels' interpret mode)."""

    def __init__(self, n: int, halo: int, dalpha: float, radius: float,
                 gravity: float, omega: float, scheme: str = "plr",
                 limiter: str = "mc", interpret: bool = False,
                 device="cuda"):
        if scheme != "plr" or limiter != "mc":
            raise NotImplementedError(
                f"the Cartesian kernels implement PLR with the MC limiter; "
                f"got scheme={scheme!r}, limiter={limiter!r} (other "
                "reconstructions: ROADMAP queue A item 1; backend='jnp' "
                "runs every ported limiter)")
        if halo < 2:
            raise ValueError(f"PLR needs halo >= 2, got {halo}")
        self.n, self.halo, self.m = n, halo, n + 2 * halo
        self.dalpha, self.radius = float(dalpha), float(radius)
        self.gravity, self.omega = float(gravity), float(omega)
        self.limiter = limiter
        self.interpret = bool(interpret)
        R = _f32(self.radius)
        # The kernels' float32 constants, rounded as the cores round them.
        self._rhs_consts = (
            R, _f32(R * R), _f32(self.gravity), _f32(2.0 * self.omega),
            _f32(1.0 / (2.0 * self.dalpha)), _f32(1.0 / self.dalpha))
        self.device = torch.device(device)
        x_row, xf_row, x_col, xf_col, frames = coord_rows(n, halo, self.device)
        self.coords = (x_row, xf_row, x_col, xf_col)
        self.frames = frames.contiguous()                 # (6, 3, 3)
        self._xc = x_row.reshape(-1).contiguous()
        self._xf = xf_row.reshape(-1).contiguous()

    def _core(self, hf, v, bf, fast: bool):
        """:func:`rhs_core_fast` (``fast``) or :func:`rhs_core` with these
        constants, coordinate rows and frames."""
        core = rhs_core_fast if fast else rhs_core
        x_row, xf_row, x_col, xf_col = self.coords
        return core(self.frames.to(hf.dtype), x_row.to(hf.dtype),
                    xf_row.to(hf.dtype), x_col.to(hf.dtype),
                    xf_col.to(hf.dtype), hf, v, bf, n=self.n,
                    halo=self.halo, d=self.dalpha, radius=self.radius,
                    gravity=self.gravity, omega=self.omega,
                    limiter=self.limiter)

    def _plain(self, t) -> bool:
        """True where the plain version runs: ``interpret``, or a CPU
        tensor."""
        return self.interpret or not self._on_cuda(t)


def swe_rhs_reference(rhs, h_ext, v_ext, b_ext):
    """The plain PyTorch version of the Cartesian RHS kernel.

    ``rhs`` is a :class:`SweRhs` (its constants and coordinate rows); the
    operands as for calling it.  :func:`rhs_core` over the six faces.
    Used on CPU tensors by the wrapper, and by the tests and
    ``chip_smoke.py`` to hold the CUDA kernel against it; it also runs in
    float64.  Returns ``(dh (6, n, n), dv (3, 6, n, n))``.
    """
    dh, dv = rhs._core(h_ext, v_ext, b_ext, fast=False)
    return dh, torch.stack(dv)


def _rhs_kernel():
    """The Cartesian RHS kernel: 8 tensor pointers; n, halo; 6 float
    constants; the stream."""
    return _entry("swe_rhs", "swe_rhs_f32",
                  [_P] * 8 + [ctypes.c_int] * 2 + [ctypes.c_float] * 6
                  + [_P])


class SweRhs(_SweBase):
    """The Cartesian right-hand side of ghost-filled extended faces.

    ``rhs(h_ext, v_ext, b_ext) -> (dh, dv)``: ``h_ext``, ``b_ext``
    (6, M, M), ``v_ext`` (3, 6, M, M) with ghosts filled; interior
    tendencies ``dh`` (6, n, n) and ``dv`` (3, 6, n, n).  CUDA tensors
    launch ``csrc/swe_rhs.cu`` (the port of the Pallas kernel
    ``make_swe_rhs_pallas``); CPU tensors, or any tensors with
    ``interpret=True``, run :func:`swe_rhs_reference`.  There is no other
    path: a kernel that fails to build or launch raises.
    """

    #: Launches of the CUDA kernel, all instances together (the plain
    #: version does not count).
    launches = 0

    def _check(self, h_ext, v_ext, b_ext):
        m = self.m
        _check_tensors({"h_ext": (h_ext, (6, m, m)),
                        "v_ext": (v_ext, (3, 6, m, m)),
                        "b_ext": (b_ext, (6, m, m))}, self.device)

    def __call__(self, h_ext, v_ext, b_ext):
        self._check(h_ext, v_ext, b_ext)
        if self._plain(h_ext):
            return swe_rhs_reference(self, h_ext, v_ext, b_ext)
        n = self.n
        dh = h_ext.new_empty((6, n, n))
        dv = h_ext.new_empty((3, 6, n, n))
        rc = _rhs_kernel()(
            self.frames.data_ptr(), h_ext.data_ptr(), v_ext.data_ptr(),
            b_ext.data_ptr(), self._xc.data_ptr(), self._xf.data_ptr(),
            dh.data_ptr(), dv.data_ptr(), n, self.halo, *self._rhs_consts,
            self._stream())
        if rc != 0:
            raise RuntimeError(f"swe_rhs kernel launch failed: cudaError "
                               f"{rc} (n={n}, halo={self.halo})")
        SweRhs.launches += 1
        return dh, dv

    def reference(self, h_ext, v_ext, b_ext):
        """The plain version on the same arguments (tests and smoke)."""
        return swe_rhs_reference(self, h_ext, v_ext, b_ext)


def make_swe_rhs_pallas(n: int, halo: int, dalpha: float, radius: float,
                        gravity: float, omega: float, scheme: str = "plr",
                        limiter: str = "mc", interpret: bool = False,
                        device="cuda"):
    """``rhs(h_ext, v_ext, b_ext) -> (dh, dv)``: the Cartesian RHS kernel
    (a :class:`SweRhs`), drop-in for the stencil section of
    :meth:`ShallowWater.rhs`."""
    return SweRhs(n, halo, dalpha, radius, gravity, omega, scheme=scheme,
                  limiter=limiter, interpret=interpret, device=device)
