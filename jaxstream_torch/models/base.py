"""Model base: grid, scalar halo exchange and stepping wired together.

Counterpart of :class:`jaxstream.models.base.Model`.  State is a dict of
interior tensors ``(6, n, n)`` (scalars) / ``(c, 6, n, n)`` (vectors).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..geometry.cubed_sphere import CubedSphereGrid
from ..ops.fv import embed_interior
from ..parallel.halo import make_halo_exchanger
from ..stepping import integrate, make_stepper

State = Dict[str, torch.Tensor]


class Model:
    """Base class wiring grid + halo exchange + stepping together."""

    def __init__(self, grid: CubedSphereGrid):
        self.grid = grid
        self.exchange = make_halo_exchanger(grid.n, grid.halo)

    def rhs(self, state: State, t) -> State:  # pragma: no cover - interface
        raise NotImplementedError

    def fill(self, interior: torch.Tensor) -> torch.Tensor:
        """Embed an interior tensor and fill its ghosts."""
        return self.exchange(embed_interior(self.grid, interior))

    def make_step(self, dt: float, scheme: str = "ssprk3") -> Callable:
        return make_stepper(self.rhs, dt, scheme)

    def run(self, state: State, nsteps: int, dt: float, t0: float = 0.0,
            scheme: str = "ssprk3"):
        """Integrate ``nsteps``; returns ``(state, t)``."""
        return integrate(self.make_step(dt, scheme), state, t0, nsteps, dt)
