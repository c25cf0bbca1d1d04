"""Shared shallow-water setup (counterpart of
:class:`jaxstream.models.shallow_water.SWEBase`).

The Cartesian-velocity ``ShallowWater`` model is not ported yet
(ROADMAP queue A item 10).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..geometry.cubed_sphere import CubedSphereGrid
from .base import Model

__all__ = ["SWEBase"]


class SWEBase(Model):
    """Scheme validation, Coriolis parameter and filled topography.

    ``nu4``: the del^4 hyperdiffusion coefficient (m^4/s); 0 turns the
    filter off."""

    def __init__(self, grid: CubedSphereGrid, gravity: float, omega: float,
                 b_ext: Optional[torch.Tensor] = None, scheme: str = "plr",
                 limiter: str = "mc", nu4: float = 0.0):
        super().__init__(grid)
        if scheme != "plr":
            raise NotImplementedError(
                f"scheme={scheme!r}: only PLR is ported (PPM is ROADMAP "
                "queue A item 1, ops/reconstruct.py)")
        self.gravity = gravity
        self.omega = omega
        self.scheme = scheme
        self.limiter = limiter
        self.nu4 = nu4
        # Coriolis parameter f = 2 Omega sin(lat) at interior centers.
        self.fcor = 2.0 * omega * torch.sin(grid.interior(grid.lat))
        # Bottom topography, extended, with its ghosts filled once here
        # (the stages read it one ring deep).
        if b_ext is None:
            b_ext = torch.zeros_like(grid.sqrtg)
        if b_ext.device != grid.device:
            raise ValueError(f"b_ext is on {b_ext.device}, the grid on "
                             f"{grid.device}")
        self.b_ext = self.exchange(b_ext)
