"""Thermal diffusion on the cubed sphere (counterpart of
:class:`jaxstream.models.diffusion.ThermalDiffusion`):
``dT/dt = kappa lap(T)`` with the conservative Laplace-Beltrami operator.
"""

from __future__ import annotations

from ..geometry.cubed_sphere import CubedSphereGrid
from ..ops.fv import laplacian
from .base import Model, State

__all__ = ["ThermalDiffusion"]


class ThermalDiffusion(Model):
    """State ``{"T": (6, n, n)}``."""

    def __init__(self, grid: CubedSphereGrid, kappa: float):
        super().__init__(grid)
        self.kappa = kappa

    def initial_state(self, t_ext) -> State:
        return {"T": self.grid.interior(t_ext)}

    def rhs(self, state: State, t) -> State:
        t_ext = self.fill(state["T"])
        return {"T": self.kappa * laplacian(self.grid, t_ext)}
