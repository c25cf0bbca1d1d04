"""Scalar diagnostics (counterpart of :mod:`jaxstream.utils.diagnostics`):
conservation integrals, Williamson's error norms and the area-weighted
ensemble statistics."""

from __future__ import annotations

import torch

from ..geometry.cubed_sphere import CubedSphereGrid

__all__ = ["total_mass", "total_energy", "potential_enstrophy",
           "error_norms", "ensemble_area_weights", "ensemble_spread",
           "ensemble_mean_rmse", "ensemble_mean_drift"]


def _wsum(grid: CubedSphereGrid, field_int: torch.Tensor) -> torch.Tensor:
    return torch.sum(field_int * grid.interior(grid.area))


def total_mass(grid: CubedSphereGrid, h_int: torch.Tensor) -> torch.Tensor:
    """Integral of h over the sphere (``h_int`` interior (6, n, n))."""
    return _wsum(grid, h_int)


def total_energy(grid: CubedSphereGrid, h_int: torch.Tensor,
                 v_int: torch.Tensor, gravity: float,
                 b_int=0.0) -> torch.Tensor:
    """Integral of ``h |v|^2/2 + g h (h/2 + b)``; ``v_int`` the Cartesian
    velocity (3, 6, n, n)."""
    ke = 0.5 * torch.sum(v_int * v_int, dim=0)
    return _wsum(grid, h_int * ke + gravity * h_int * (0.5 * h_int + b_int))


def potential_enstrophy(grid: CubedSphereGrid, h_int: torch.Tensor,
                        abs_vort_int: torch.Tensor) -> torch.Tensor:
    """Integral of ``(zeta + f)^2 / (2h)``."""
    return _wsum(grid, abs_vort_int**2 / (2.0 * h_int))


def error_norms(grid: CubedSphereGrid, field_int: torch.Tensor,
                ref_int: torch.Tensor) -> dict:
    """Williamson's normalized l1, l2 and linf norms of ``field - ref``
    (interior (6, n, n) tensors)."""
    w = grid.interior(grid.area)
    diff = field_int - ref_int
    l1 = torch.sum(torch.abs(diff) * w) / torch.sum(torch.abs(ref_int) * w)
    l2 = torch.sqrt(torch.sum(diff**2 * w) / torch.sum(ref_int**2 * w))
    linf = torch.max(torch.abs(diff)) / torch.max(torch.abs(ref_int))
    return {"l1": l1, "l2": l2, "linf": linf}


# -- ensemble statistics: the one definition of the area-weighted spread,
# RMSE and drift, over a member-leading (B, 6, n, n) height.

def ensemble_area_weights(grid: CubedSphereGrid, dtype=None) -> torch.Tensor:
    """Normalized interior cell-area weights (sum 1)."""
    w = grid.interior(grid.area)
    w = w / torch.sum(w)
    return w.to(dtype) if dtype is not None else w


def ensemble_spread(h_b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Area-weighted RMS ensemble spread of ``h_b`` ``(B, 6, n, n)``:
    ``sqrt(sum_cells w * var_members)``, the variance with ``B - 1``
    (ddof = 1)."""
    return torch.sqrt(torch.sum(w * torch.var(h_b, dim=0, correction=1)))


def ensemble_mean_rmse(h_b: torch.Tensor, ref: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """Area-weighted RMSE of the ensemble mean against ``ref``."""
    err = torch.mean(h_b, dim=0) - ref
    return torch.sqrt(torch.sum(w * err * err))


def ensemble_mean_drift(h_b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Area-weighted RMS distance of the ensemble mean from member 0."""
    return ensemble_mean_rmse(h_b, h_b[0], w)
