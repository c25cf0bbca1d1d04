"""Finite-volume operators of the shallow-water models.

Counterpart of :mod:`jaxstream.ops.fv`: the covariant operators and the
Cartesian-velocity ones (:func:`flux_divergence`, :func:`gradient`,
:func:`vorticity`, :func:`kinetic_energy`).  The
operators take extended fields ``(..., 6, M, M)`` whose ghosts have been
filled and return interior-shaped results ``(..., 6, n, n)``; same
stencils and operand order as the JAX package.  Together with the halo
exchangers they form the classic (unfused) path that is the port's own
oracle for the fused stepper.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F

from ..geometry.connectivity import (EDGE_E, EDGE_N, EDGE_S, EDGE_W,
                                     build_connectivity, edge_pairs)
from ..geometry.cubed_sphere import CubedSphereGrid
from .reconstruct import _sl, plr_face_states

__all__ = [
    "embed_interior",
    "flux_divergence",
    "gradient",
    "vorticity",
    "kinetic_energy",
    "contravariant",
    "covariant_components",
    "covariant_face_normal_velocity",
    "flux_divergence_faces",
    "laplacian",
    "vorticity_cov",
]


def embed_interior(grid: CubedSphereGrid, arr, fill: float = 0.0):
    """Pad an interior ``(..., 6, n, n)`` tensor out to ``(..., 6, M, M)``."""
    h = grid.halo
    return F.pad(arr, (h, h, h, h), value=fill)


def contravariant(grid: CubedSphereGrid, v):
    """Contravariant ``(u^alpha, u^beta)`` of a Cartesian (3, 6, M, M)."""
    return torch.sum(v * grid.a_a, dim=0), torch.sum(v * grid.a_b, dim=0)


def covariant_components(grid: CubedSphereGrid, v):
    """Covariant ``(v.e_a, v.e_b)`` of a Cartesian vector: (2, 6, M, M)."""
    return torch.stack([torch.sum(v * grid.e_a, dim=0),
                        torch.sum(v * grid.e_b, dim=0)])


def covariant_face_normal_velocity(grid: CubedSphereGrid, u,
                                   symmetrize: bool = True):
    """Face-normal contravariant velocity from covariant components.

    ``u``: (2, 6, M, M).  Averages the covariant pair to the face and
    raises the index with the face inverse metric.  Returns ``(ux, uy)``
    shaped (6, n, n+1) / (6, n+1, n).  ``symmetrize`` replaces both
    panels' edge-face values with the averaged outward value so seam
    fluxes match exactly (mass conservation).
    """
    h, n = grid.halo, grid.n
    ubar = 0.5 * (_sl(u, h - 1, h + n, -1) + _sl(u, h, h + n + 1, -1))
    ubar = _sl(ubar, h, h + n, -2)
    iaa = _sl(_sl(grid.ginv_aa_xf, h, h + n + 1, -1), h, h + n, -2)
    iab = _sl(_sl(grid.ginv_ab_xf, h, h + n + 1, -1), h, h + n, -2)
    ux = iaa * ubar[0] + iab * ubar[1]
    vbar = 0.5 * (_sl(u, h - 1, h + n, -2) + _sl(u, h, h + n + 1, -2))
    vbar = _sl(vbar, h, h + n, -1)
    iab2 = _sl(_sl(grid.ginv_ab_yf, h, h + n + 1, -2), h, h + n, -1)
    ibb = _sl(_sl(grid.ginv_bb_yf, h, h + n + 1, -2), h, h + n, -1)
    uy = iab2 * vbar[0] + ibb * vbar[1]
    if symmetrize:
        ux, uy = _symmetrize_edge_fluxes(ux, uy, n)
    return ux, uy


def vorticity_cov(grid: CubedSphereGrid, u):
    """Relative vorticity from covariant components: (2,6,M,M) -> (6,n,n)."""
    h, n, d = grid.halo, grid.n, grid.dalpha
    dub_da = (_sl(_sl(u[1], h + 1, h + n + 1, -1), h, h + n, -2)
              - _sl(_sl(u[1], h - 1, h + n - 1, -1), h, h + n, -2)) / (2 * d)
    dua_db = (_sl(_sl(u[0], h + 1, h + n + 1, -2), h, h + n, -1)
              - _sl(_sl(u[0], h - 1, h + n - 1, -2), h, h + n, -1)) / (2 * d)
    return (dub_da - dua_db) / grid.interior(grid.sqrtg)


@lru_cache(maxsize=1)
def _edge_pair_table():
    return edge_pairs(build_connectivity())


# Outward-normal sign of the stored +alpha/+beta face flux at each edge.
_OUT_SIGN = {EDGE_S: -1.0, EDGE_W: -1.0, EDGE_N: 1.0, EDGE_E: 1.0}


def _edge_view(fx, fy, face, edge, n):
    """The panel-boundary face-flux strip ``(n,)`` of one face edge."""
    if edge == EDGE_S:
        return fy[..., face, 0, :]
    if edge == EDGE_N:
        return fy[..., face, n, :]
    if edge == EDGE_W:
        return fx[..., face, :, 0]
    if edge == EDGE_E:
        return fx[..., face, :, n]
    raise ValueError(edge)


def _symmetrize_edge_fluxes(fx, fy, n):
    """Make panel-edge values exactly antisymmetric across shared edges.

    Each face edge belongs to exactly one pair, so updating clones in
    place is the JAX package's functional update, value for value.
    """
    fx, fy = fx.clone(), fy.clone()
    new = []
    for link, back in _edge_pair_table():
        s_a = _edge_view(fx, fy, link.face, link.edge, n)
        s_b = _edge_view(fx, fy, back.face, back.edge, n)
        if link.reversed_:
            s_b = torch.flip(s_b, dims=[-1])
        out_a = _OUT_SIGN[link.edge] * s_a
        out_b = _OUT_SIGN[back.edge] * s_b
        avg = 0.5 * (out_a - out_b)
        new_a = _OUT_SIGN[link.edge] * avg
        new_b = _OUT_SIGN[back.edge] * (-avg)
        if link.reversed_:
            new_b = torch.flip(new_b, dims=[-1])
        new.append((link, new_a))
        new.append((back, new_b))
    for link, strip in new:
        _edge_view(fx, fy, link.face, link.edge, n).copy_(strip)
    return fx, fy


def _face_normal_velocity(grid: CubedSphereGrid, v):
    """Contravariant normal velocity at the interior-bounding faces of a
    Cartesian ``v`` (3, 6, M, M): ``ux`` = u^alpha at the n+1 x-faces of
    each interior row (6, n, n+1), ``uy`` = u^beta at the y-faces
    (6, n+1, n).  The cell-centered v is averaged to the face and dotted
    with the face dual basis."""
    h, n = grid.halo, grid.n
    vxf = 0.5 * (_sl(v, h - 1, h + n, -1) + _sl(v, h, h + n + 1, -1))
    vxf = _sl(vxf, h, h + n, -2)
    aaxf = _sl(_sl(grid.a_a_xf, h, h + n + 1, -1), h, h + n, -2)
    ux = torch.sum(vxf * aaxf, dim=0)
    vyf = 0.5 * (_sl(v, h - 1, h + n, -2) + _sl(v, h, h + n + 1, -2))
    vyf = _sl(vyf, h, h + n, -1)
    abyf = _sl(_sl(grid.a_b_yf, h, h + n + 1, -2), h, h + n, -1)
    uy = torch.sum(vyf * abyf, dim=0)
    return ux, uy


def flux_divergence(grid: CubedSphereGrid, q, v, scheme: str = "plr",
                    limiter: str = "mc", conservative_edges: bool = False):
    """Divergence of the advective flux ``div(q v)`` of a Cartesian
    velocity ``v`` (3, 6, M, M) on interior cells; ``q`` (6, M, M).
    ``conservative_edges`` also averages the two panels' edge fluxes
    (:func:`_symmetrize_edge_fluxes`).  Returns (6, n, n)."""
    ux, uy = _face_normal_velocity(grid, v)
    return flux_divergence_faces(grid, q, ux, uy, scheme=scheme,
                                 limiter=limiter,
                                 conservative_edges=conservative_edges)


def flux_divergence_faces(grid: CubedSphereGrid, q, ux, uy,
                          scheme: str = "plr", limiter: str = "mc",
                          conservative_edges: bool = False):
    """Divergence of the upwind PLR flux ``div(q u)`` on interior cells.

    ``q``: (6, M, M) extended scalar; ``ux`` (6, n, n+1) / ``uy``
    (6, n+1, n) contravariant face-normal velocities.  Returns (6, n, n).
    ``conservative_edges`` replaces both panels' edge fluxes with their
    averaged outward value.
    """
    if scheme != "plr":
        raise NotImplementedError(
            f"scheme={scheme!r}: only PLR is ported (PPM is ROADMAP "
            "queue A item 1, ops/reconstruct.py)")
    h, n, d = grid.halo, grid.n, grid.dalpha

    qx = _sl(q, h, h + n, -2)
    qL, qR = plr_face_states(qx, -1, h, n, limiter=limiter)
    sgx = _sl(_sl(grid.sqrtg_xf, h, h + n + 1, -1), h, h + n, -2)
    fx = sgx * (torch.clamp(ux, min=0.0) * qL + torch.clamp(ux, max=0.0) * qR)

    qy = _sl(q, h, h + n, -1)
    qL, qR = plr_face_states(qy, -2, h, n, limiter=limiter)
    sgy = _sl(_sl(grid.sqrtg_yf, h, h + n + 1, -2), h, h + n, -1)
    fy = sgy * (torch.clamp(uy, min=0.0) * qL + torch.clamp(uy, max=0.0) * qR)

    if conservative_edges:
        fx, fy = _symmetrize_edge_fluxes(fx, fy, n)

    sg_c = grid.interior(grid.sqrtg)
    return ((_sl(fx, 1, None, -1) - _sl(fx, 0, -1, -1))
            + (_sl(fy, 1, None, -2) - _sl(fy, 0, -1, -2))) / (sg_c * d)


def gradient(grid: CubedSphereGrid, psi):
    """Tangent-plane gradient of a scalar as a Cartesian 3-vector:
    ``psi`` (6, M, M) extended -> (3, 6, n, n); centered differences."""
    h, n, d = grid.halo, grid.n, grid.dalpha
    dpa = (_sl(_sl(psi, h + 1, h + n + 1, -1), h, h + n, -2)
           - _sl(_sl(psi, h - 1, h + n - 1, -1), h, h + n, -2)) / (2 * d)
    dpb = (_sl(_sl(psi, h + 1, h + n + 1, -2), h, h + n, -1)
           - _sl(_sl(psi, h - 1, h + n - 1, -2), h, h + n, -1)) / (2 * d)
    return grid.interior(grid.a_a) * dpa + grid.interior(grid.a_b) * dpb


def vorticity(grid: CubedSphereGrid, v):
    """Radial relative vorticity of a Cartesian ``v`` (3, 6, M, M) on
    interior cells: ``(d v_beta/d alpha - d v_alpha/d beta) / sqrtg`` with
    the covariant components ``v . e_alpha``; (6, n, n)."""
    h, n, d = grid.halo, grid.n, grid.dalpha
    va = torch.sum(v * grid.e_a, dim=0)
    vb = torch.sum(v * grid.e_b, dim=0)
    dvb_da = (_sl(_sl(vb, h + 1, h + n + 1, -1), h, h + n, -2)
              - _sl(_sl(vb, h - 1, h + n - 1, -1), h, h + n, -2)) / (2 * d)
    dva_db = (_sl(_sl(va, h + 1, h + n + 1, -2), h, h + n, -1)
              - _sl(_sl(va, h - 1, h + n - 1, -2), h, h + n, -1)) / (2 * d)
    return (dvb_da - dva_db) / grid.interior(grid.sqrtg)


def kinetic_energy(v):
    """``|v|^2 / 2`` of a Cartesian vector field (any trailing shape)."""
    return 0.5 * torch.sum(v * v, dim=0)


def laplacian(grid: CubedSphereGrid, psi):
    """Laplace-Beltrami operator in conservative flux form.

    ``lap(psi) = (1/sqrtg) [d_a(sqrtg (g^aa psi_a + g^ab psi_b))
    + d_b(sqrtg (g^ab psi_a + g^bb psi_b))]`` with the stored face
    metrics; iterated, with a ghost refill between applications, it is
    the classic path's del^4 hyperdiffusion.  ``psi``: ``(..., 6, M, M)``
    with ghosts and corners filled -> ``(..., 6, n, n)``.
    """
    h, n, d = grid.halo, grid.n, grid.dalpha

    # x-faces i = h..h+n on interior rows; d/d beta at the face averages
    # the centered row derivatives of the two abutting cells.
    pr = _sl(psi, h, h + n, -2)
    dpa = (_sl(pr, h, h + n + 1, -1) - _sl(pr, h - 1, h + n, -1)) / d
    dpb_c = (_sl(psi, h + 1, h + n + 1, -2)
             - _sl(psi, h - 1, h + n - 1, -2)) / (2 * d)
    dpb_f = 0.5 * (_sl(dpb_c, h - 1, h + n, -1) + _sl(dpb_c, h, h + n + 1, -1))
    sgx = _sl(_sl(grid.sqrtg_xf, h, h + n + 1, -1), h, h + n, -2)
    iaa = _sl(_sl(grid.ginv_aa_xf, h, h + n + 1, -1), h, h + n, -2)
    iab = _sl(_sl(grid.ginv_ab_xf, h, h + n + 1, -1), h, h + n, -2)
    fx = sgx * (iaa * dpa + iab * dpb_f)

    # y-faces j = h..h+n on interior columns.
    pc = _sl(psi, h, h + n, -1)
    dpb = (_sl(pc, h, h + n + 1, -2) - _sl(pc, h - 1, h + n, -2)) / d
    dpa_c = (_sl(psi, h + 1, h + n + 1, -1)
             - _sl(psi, h - 1, h + n - 1, -1)) / (2 * d)
    dpa_f = 0.5 * (_sl(dpa_c, h - 1, h + n, -2) + _sl(dpa_c, h, h + n + 1, -2))
    sgy = _sl(_sl(grid.sqrtg_yf, h, h + n + 1, -2), h, h + n, -1)
    ibb = _sl(_sl(grid.ginv_bb_yf, h, h + n + 1, -2), h, h + n, -1)
    iab2 = _sl(_sl(grid.ginv_ab_yf, h, h + n + 1, -2), h, h + n, -1)
    fy = sgy * (ibb * dpb + iab2 * dpa_f)

    sg_c = grid.interior(grid.sqrtg)
    return ((_sl(fx, 1, None, -1) - _sl(fx, 0, -1, -1))
            + (_sl(fy, 1, None, -2) - _sl(fy, 0, -1, -2))) / (sg_c * d)
