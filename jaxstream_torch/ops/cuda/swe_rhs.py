"""Closed-form metric terms shared by the plain stage and the kernels.

Counterparts of :func:`jaxstream.ops.pallas.swe_rhs.coord_rows` and
``_fast_frame``.  The equiangular metric is rank-1 separable: every
quantity the covariant stage needs is a closed-form function of
``X = tan(alpha)`` along a row and ``Y = tan(beta)`` along a column, so
the stage rebuilds it per cell from two coordinate vectors instead of
streaming metric fields from memory.  The CUDA stage kernel
(``csrc/cov_stage.cu``) evaluates the same expressions per cell.
"""

from __future__ import annotations

import numpy as np
import torch

from ...geometry.cubed_sphere import FACE_AXES, extended_coords

__all__ = ["coord_rows", "_fast_frame"]


def coord_rows(n: int, halo: int, device):
    """Gnomonic coordinate rows/columns (float32) plus face frames.

    Returns ``(x_row, xf_row, x_col, xf_col, frames)``: ``(1, M)`` /
    ``(M, 1)`` tan-coordinates of cell centers and left faces, and the
    ``(6, 3, 3)`` face-frame table.
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
