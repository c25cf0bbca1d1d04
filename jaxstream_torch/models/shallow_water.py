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
    """Scheme validation, the RHS backend, Coriolis parameter and filled
    topography.

    ``nu4``: the del^4 hyperdiffusion coefficient (m^4/s); 0 turns the
    filter off.  ``backend`` picks the classic ``rhs``'s stencil section,
    with the JAX package's names so that one config drives either
    package: ``'jnp'`` the torch operators (the reference and parity
    oracle), ``'pallas'`` the fused kernel from ``_make_pallas_rhs`` (a
    CUDA launch on CUDA tensors, its plain version on CPU tensors),
    ``'pallas_interpret'`` the port's counterpart of interpret mode: an
    explicit request for the kernel's plain version on any device.  Both
    kernel backends need a float32 grid.  Subclasses provide
    ``_make_pallas_rhs(interpret)``."""

    def __init__(self, grid: CubedSphereGrid, gravity: float, omega: float,
                 b_ext: Optional[torch.Tensor] = None, scheme: str = "plr",
                 limiter: str = "mc", nu4: float = 0.0,
                 backend: str = "jnp"):
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
        if backend not in ("jnp", "pallas", "pallas_interpret"):
            raise ValueError(f"unknown backend {backend!r}")
        self._pallas_rhs = None
        if backend.startswith("pallas"):
            if grid.dtype != torch.float32:
                raise ValueError(
                    f"backend='pallas' supports float32 grids only (the "
                    f"kernel is f32); got grid dtype {grid.dtype}. Use "
                    f"backend='jnp' or build the grid with "
                    f"dtype=torch.float32.")
            self._pallas_rhs = self._make_pallas_rhs(
                interpret=(backend == "pallas_interpret"))
        self.backend = backend
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

    def _make_pallas_rhs(self, interpret: bool):  # pragma: no cover
        raise NotImplementedError
