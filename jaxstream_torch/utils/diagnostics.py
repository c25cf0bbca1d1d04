"""Scalar diagnostics (counterpart of :mod:`jaxstream.utils.diagnostics`)."""

from __future__ import annotations

import torch

from ..geometry.cubed_sphere import CubedSphereGrid

__all__ = ["total_mass", "error_norms"]


def total_mass(grid: CubedSphereGrid, h_int: torch.Tensor) -> torch.Tensor:
    """Integral of h over the sphere (``h_int`` interior (6, n, n))."""
    return torch.sum(h_int * grid.interior(grid.area))


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
