"""Tracer advection on the cubed sphere (counterpart of
:class:`jaxstream.models.advection.TracerAdvection`).

Flux-form finite-volume transport of a scalar by a prescribed Cartesian
wind that is exact in the ghosts (no vector exchange), PLR or PPM face
states, stepped by SSPRK3.  Williamson TC1 is this model with the
solid-body wind and the cosine bell.
"""

from __future__ import annotations

from ..geometry.cubed_sphere import CubedSphereGrid
from ..ops.fv import flux_divergence
from .base import Model, State

__all__ = ["TracerAdvection"]


class TracerAdvection(Model):
    """State ``{"q": (6, n, n)}``; ``wind_ext`` the Cartesian wind (3, 6,
    M, M), valid in the ghosts.  ``scheme="ppm"`` needs halo >= 3."""

    def __init__(self, grid: CubedSphereGrid, wind_ext, scheme: str = "plr",
                 limiter: str = "mc"):
        super().__init__(grid)
        if scheme == "ppm" and grid.halo < 3:
            raise ValueError("PPM advection needs a grid built with halo >= 3")
        self.wind_ext = wind_ext
        self.scheme = scheme
        self.limiter = limiter

    def initial_state(self, q_ext) -> State:
        return {"q": self.grid.interior(q_ext)}

    def rhs(self, state: State, t) -> State:
        q_ext = self.fill(state["q"])
        dq = -flux_divergence(self.grid, q_ext, self.wind_ext,
                              scheme=self.scheme, limiter=self.limiter)
        return {"q": dq}
