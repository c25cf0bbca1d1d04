"""Scalar diagnostics (counterpart of :mod:`jaxstream.utils.diagnostics`)."""

from __future__ import annotations

import torch

from ..geometry.cubed_sphere import CubedSphereGrid

__all__ = ["total_mass"]


def total_mass(grid: CubedSphereGrid, h_int: torch.Tensor) -> torch.Tensor:
    """Integral of h over the sphere (``h_int`` interior (6, n, n))."""
    return torch.sum(h_int * grid.interior(grid.area))
