"""Shallow-water equations on the cubed sphere with a Cartesian 3-vector
velocity (counterpart of :mod:`jaxstream.models.shallow_water`).

    dh/dt = -div(h v),
    dv/dt = -(zeta + f) k x v - grad(g (h + b) + |v|^2 / 2),

with v kept tangent to the sphere by projection.  :class:`SWEBase` is
the setup shared with the covariant model; :class:`ShallowWater` runs
the Cartesian form three ways, as the JAX package does:

* :meth:`ShallowWater.rhs`, stepped by :meth:`make_step` (the classic
  path): two halo exchanges, then the torch operators of
  :mod:`jaxstream_torch.ops.fv` (``backend='jnp'``) or one launch of the
  CUDA RHS kernel (``backend='pallas'``,
  :func:`~jaxstream_torch.ops.cuda.swe_rhs.make_swe_rhs_pallas`);
* :meth:`make_fused_step` over :meth:`extend_state`: per RK stage one
  strip route and one launch of the in-kernel-exchange stage kernel
  (default), or with ``in_kernel_exchange=False`` a concat-layout
  exchange of h and v and one launch of the fused stage kernel
  (:mod:`jaxstream_torch.ops.cuda.swe_step`).

On CPU tensors, or with ``backend='pallas_interpret'``, the kernels'
plain PyTorch versions run instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..geometry.cubed_sphere import CubedSphereGrid
from ..ops.fv import (embed_interior, flux_divergence, gradient,
                      kinetic_energy, laplacian, vorticity)
from ..ops.reconstruct import LIMITERS
from .base import Model, State

__all__ = ["SWEBase", "ShallowWater"]


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
        if limiter not in LIMITERS:
            raise NotImplementedError(
                f"limiter={limiter!r}: not ported (ROADMAP queue A item 1, "
                "ops/reconstruct.py); available: " + ", ".join(LIMITERS))
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


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


class ShallowWater(SWEBase):
    """State ``{"h": (6, n, n), "v": (3, 6, n, n)}``, v Cartesian."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.khat_int = self.grid.interior(self.grid.khat)

    def _make_pallas_rhs(self, interpret: bool):
        from ..ops.cuda.swe_rhs import make_swe_rhs_pallas

        g = self.grid
        return make_swe_rhs_pallas(
            g.n, g.halo, g.dalpha, g.radius, self.gravity, self.omega,
            scheme=self.scheme, limiter=self.limiter, interpret=interpret,
            device=g.device)

    def initial_state(self, h_ext, v_ext) -> State:
        return {"h": self.grid.interior(h_ext).contiguous(),
                "v": self.grid.interior(v_ext).contiguous()}

    # -- the fused extended-state path --------------------------------------
    def extend_state(self, state: State, with_strips: bool = False) -> State:
        """Interior state -> extended state (ghosts zeroed; filled on use).
        ``with_strips=True`` adds the raw strip carry (``sh_sn``,
        ``sh_we``, ``sv_sn``, ``sv_we``) of the in-kernel-exchange
        stepper."""
        g = self.grid
        y = {k: embed_interior(g, v) for k, v in state.items()}
        if with_strips:
            from ..ops.cuda.swe_step import raw_strips

            y["sh_sn"], y["sh_we"] = raw_strips(y["h"], g.n, g.halo)
            y["sv_sn"], y["sv_we"] = raw_strips(y["v"], g.n, g.halo)
        return y

    def restrict_state(self, y_ext: State) -> State:
        """Extended state -> interior state (contiguous; strips dropped)."""
        return {k: self.grid.interior(v).contiguous()
                for k, v in y_ext.items() if k in ("h", "v")}

    def make_fused_step(self, dt: float, in_kernel_exchange: bool = True):
        """SSPRK3 step over the extended state, one fused kernel per stage.

        With ``in_kernel_exchange`` (default) the halo fill happens inside
        the kernel from the routed strip carry (state ``{"h", "v",
        "sh_sn", "sh_we", "sv_sn", "sv_we"}``, from ``extend_state(state,
        with_strips=True)``); otherwise a concat-layout exchange of h and v
        runs before each stage (state ``{"h", "v"}``).  Requires
        ``backend='pallas'`` (or ``'pallas_interpret'``) and ``nu4 ==
        0``, as in the JAX package; use :meth:`make_step` otherwise.
        """
        if self._pallas_rhs is None:
            raise ValueError("make_fused_step requires backend='pallas'")
        if self.nu4 != 0.0:
            raise ValueError("make_fused_step does not support nu4 > 0")
        from ..ops.cuda import swe_step

        g = self.grid
        interpret = self.backend == "pallas_interpret"
        if in_kernel_exchange:
            return swe_step.make_fused_ssprk3_step_inkernel(
                g.n, g.halo, g.dalpha, g.radius, self.gravity, self.omega,
                dt, self.b_ext, scheme=self.scheme, limiter=self.limiter,
                interpret=interpret)
        from ..parallel.halo import make_concat_exchanger

        return swe_step.make_fused_ssprk3_step(
            g.n, g.halo, g.dalpha, g.radius, self.gravity, self.omega, dt,
            make_concat_exchanger(g.n, g.halo), self.b_ext,
            scheme=self.scheme, limiter=self.limiter, interpret=interpret)

    # -- the classic path -----------------------------------------------------
    def _hyperdiffuse(self, q_ext):
        """-nu4 del^4 q (interior), with a ghost refill between the two
        Laplacians."""
        l1 = laplacian(self.grid, q_ext)
        return -self.nu4 * laplacian(self.grid, self.fill(l1))

    def rhs(self, state: State, t) -> State:
        grid = self.grid
        k = self.khat_int
        h_ext = self.fill(state["h"])
        v_ext = self.fill(state["v"])

        if self._pallas_rhs is not None:
            dh, dv = self._pallas_rhs(h_ext, v_ext, self.b_ext)
            if self.nu4 > 0.0:
                dh = dh + self._hyperdiffuse(h_ext)
                # Project the del^4 term alone, then add it.
                dv_hyp = self._hyperdiffuse(v_ext)
                dv_hyp = dv_hyp - k * torch.sum(dv_hyp * k, dim=0)
                dv = dv + dv_hyp
            return {"h": dh, "v": dv}

        # Continuity: dh/dt = -div(h v).
        dh = -flux_divergence(grid, h_ext, v_ext, scheme=self.scheme,
                              limiter=self.limiter)
        # Momentum, vector-invariant.
        zeta = vorticity(grid, v_ext)
        bern_ext = self.gravity * (h_ext + self.b_ext) + kinetic_energy(v_ext)
        grad_b = gradient(grid, bern_ext)
        v_int = grid.interior(v_ext)
        # Tangentialize before use so any radial drift cannot feed back.
        v_int = v_int - k * torch.sum(v_int * k, dim=0)
        dv = -(zeta + self.fcor) * _cross(k, v_int) - grad_b
        if self.nu4 > 0.0:
            dh = dh + self._hyperdiffuse(h_ext)
            # The componentwise Laplacian of a tangent field is not
            # tangent: add it before the projection below.
            dv = dv + self._hyperdiffuse(v_ext)
        # Project the full tendency onto the tangent plane.
        dv = dv - k * torch.sum(dv * k, dim=0)
        return {"h": dh, "v": dv}
