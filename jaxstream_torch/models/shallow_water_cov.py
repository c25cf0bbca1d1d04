"""Covariant-component shallow water (counterpart of
:class:`jaxstream.models.shallow_water_cov.CovariantShallowWater`).

    dh/dt   = -(1/sqrtg) [ d_a(sqrtg u^a h*) + d_b(sqrtg u^b h*) ]
    du_a/dt =  (zeta + f) sqrtg u^b - d_a(g (h + b) + K)
    du_b/dt = -(zeta + f) sqrtg u^a - d_b(g (h + b) + K)

with ``u^i = g^ij u_j``, ``K = (u^a u_a + u^b u_b)/2`` and
``zeta = (d_a u_b - d_b u_a)/sqrtg``.  Two paths, as in the JAX package:

* :meth:`CovariantShallowWater.rhs` — the classic path: halo exchange
  plus the finite-volume operators of :mod:`jaxstream_torch.ops.fv`,
  stepped by :meth:`make_step`.  It runs on any device and is the port's
  own oracle for the fused path.
  With ``backend='pallas'`` its stencil section is one launch of the
  CUDA RHS kernel per call (:func:`~jaxstream_torch.ops.cuda.swe_cov.
  make_cov_rhs_pallas`).
* :meth:`make_fused_step` — the compact fused SSPRK3 stepper: per stage
  one strip route and one launch of the CUDA stage kernel (its plain
  PyTorch version on the CPU).  With ``nu4 > 0``, by ``nu4_mode``:
  ``'split'`` adds one route and one launch of the CUDA del^4 filter
  kernel per step; ``'refused'`` fuses the filter into the stage-1 kernel
  (3 kernels, 3 routes per step); ``'stage'`` runs the in-stage kernel
  pair in every stage (6 kernels, 6 routes).  ``compact=False`` steps the
  extended carry of :meth:`extend_state` with the in-kernel-fill stage
  kernel (3 kernels, 3 routes per step).

With ``nu4 > 0`` the classic ``rhs`` adds ``-nu4 lap(fill(lap q))`` to
every prognostic, as the JAX package's jnp path does, after the kernel on
``backend='pallas'`` too.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..geometry.cubed_sphere import CubedSphereGrid
from ..ops.fv import (covariant_components, covariant_face_normal_velocity,
                      embed_interior, flux_divergence_faces, laplacian,
                      vorticity_cov)
from ..parallel.vector_halo import make_vector_halo_exchanger
from .base import State
from .shallow_water import SWEBase

__all__ = ["CovariantShallowWater"]


def _not_ported(knob: str, item: str):
    raise NotImplementedError(
        f"make_fused_step({knob}) is not ported yet: ROADMAP {item}")


class CovariantShallowWater(SWEBase):
    """State ``{"h": (6, n, n), "u": (2, 6, n, n)}``, u covariant."""

    def __init__(self, grid: CubedSphereGrid, gravity: float, omega: float,
                 b_ext: Optional[torch.Tensor] = None, scheme: str = "plr",
                 limiter: str = "mc", nu4: float = 0.0,
                 backend: str = "jnp"):
        super().__init__(grid, gravity, omega, b_ext=b_ext, scheme=scheme,
                         limiter=limiter, nu4=nu4, backend=backend)
        self.exchange_u = make_vector_halo_exchanger(grid)
        # Cell-center inverse metric on the extended grid, g^ij = a^i . a^j.
        self.ginv_aa = torch.sum(grid.a_a * grid.a_a, dim=0)
        self.ginv_ab = torch.sum(grid.a_a * grid.a_b, dim=0)
        self.ginv_bb = torch.sum(grid.a_b * grid.a_b, dim=0)

    def _make_pallas_rhs(self, interpret: bool):
        from ..ops.cuda.swe_cov import make_cov_rhs_pallas

        return make_cov_rhs_pallas(
            self.grid, self.gravity, self.omega, scheme=self.scheme,
            limiter=self.limiter, interpret=interpret)

    # -- states -------------------------------------------------------------
    def initial_state(self, h_ext, v_ext) -> State:
        """From extended Cartesian fields (the IC functions' output)."""
        return {
            "h": self.grid.interior(h_ext).contiguous(),
            "u": self.grid.interior(
                covariant_components(self.grid, v_ext)).contiguous(),
        }

    def compact_state(self, state: State) -> State:
        """Interior state -> the compact fused-stepper carry."""
        from ..ops.cuda.swe_cov import pack_strips_cov_split

        g = self.grid
        sn, we = pack_strips_cov_split(state["h"], state["u"], g.n, g.halo)
        return {"h": state["h"], "u": state["u"],
                "strips_sn": sn, "strips_we": we}

    def extend_state(self, state: State, with_strips: bool = False) -> State:
        """Interior state -> extended state; ``with_strips=True`` adds the
        packed strips of the extended-carry stepper
        (``make_fused_step(dt, compact=False)``)."""
        from ..ops.cuda.swe_cov import pack_strips_cov

        g = self.grid
        y = {k: embed_interior(g, v) for k, v in state.items()}
        if with_strips:
            y["strips"] = pack_strips_cov(y["h"], y["u"], g.n, g.halo)
        return y

    def restrict_state(self, y: State) -> State:
        """A carry -> the interior state: the interior of an extended
        ``(..., 6, M, M)`` carry (contiguous, as the kernels take it), a
        compact one as it is; strips dropped."""
        g = self.grid
        return {k: g.interior(v).contiguous() if v.shape[-1] == g.m else v
                for k, v in y.items() if k in ("h", "u")}

    # -- fused path ----------------------------------------------------------
    def make_fused_step(self, dt: float, compact: bool = True,
                        carry_dtype=None, h_offset: float = 0.0,
                        h_scale: float = 1.0, u_scale: float = 1.0,
                        nu4_mode: str = "split", temporal_block: int = 1,
                        ensemble: int = 0, precision=None):
        """The fused SSPRK3 step ``step(y, t) -> y``.

        Ported: f32 carry, one step per call, one member, f32 arithmetic.
        ``compact=True`` (the production path) steps ``y =
        compact_state(state)``.  With ``nu4 == 0`` it is
        :func:`make_fused_ssprk3_cov_compact` and ``nu4_mode`` is
        ignored, as in the JAX package.  With ``nu4 > 0``, ``nu4_mode``
        picks the del^4 stepper: ``'split'``
        :func:`make_fused_ssprk3_cov_split_nu4` (three stages, then one
        filter launch), ``'refused'``
        :func:`make_fused_ssprk3_cov_refused_nu4` (the filter fused into
        stage 1) or ``'stage'`` :func:`make_fused_ssprk3_cov_nu4` (the
        in-stage kernel pair, the parity oracle).  ``compact=False``
        steps the extended carry ``y = extend_state(state,
        with_strips=True)`` with :func:`make_fused_ssprk3_cov_inkernel`
        (nu4 == 0 only).

        The JAX package's refusals stand: ``compact=False`` with
        ``nu4 > 0``, ``ensemble > 0`` or a carry encoding raises
        ``ValueError``.  Every other knob of the JAX package raises
        ``NotImplementedError`` naming its ROADMAP item.  One difference:
        the JAX package builds the fused step only with
        ``backend='pallas'``; the port builds it on every backend, since
        its stage wrappers launch their kernels on CUDA tensors whatever
        the classic ``rhs`` runs.
        """
        from ..ops.cuda.swe_cov import (make_fused_ssprk3_cov_compact,
                                        make_fused_ssprk3_cov_inkernel,
                                        make_fused_ssprk3_cov_nu4,
                                        make_fused_ssprk3_cov_refused_nu4,
                                        make_fused_ssprk3_cov_split_nu4)

        if nu4_mode not in ("split", "stage", "refused"):
            raise ValueError(f"nu4_mode must be 'split', 'stage' or "
                             f"'refused', got {nu4_mode!r}")
        encoded = (carry_dtype is not None or h_offset or h_scale != 1.0
                   or u_scale != 1.0)
        # The JAX package's own refusals.
        if ensemble and not compact:
            raise ValueError(
                "ensemble > 0 requires the compact carry (the "
                "extended-state stepper has no batched form)")
        if self.nu4 != 0.0:
            if not compact:
                raise ValueError("nu4 > 0 requires the compact carry")
            if encoded:
                raise ValueError("carry_dtype/h_offset/h_scale/u_scale are "
                                 "not supported on the nu4 paths")
        if encoded and not compact:
            raise ValueError("carry_dtype/h_offset/u_scale require the "
                             "compact carry")
        if encoded:
            _not_ported("carry_dtype/h_offset/h_scale/u_scale",
                        "queue A item 5 (16-bit carry encodings)")
        if temporal_block != 1:
            _not_ported(f"temporal_block={temporal_block}",
                        "queue A item 5 (temporal_block)")
        if ensemble:
            _not_ported(f"ensemble={ensemble}",
                        "queue A item 5 (the ensemble member axis)")
        if precision is not None:
            _not_ported(f"precision={precision!r}",
                        "queue A item 5 (ops/pallas/precision.py)")
        if self.grid.dtype != torch.float32:
            raise ValueError(
                f"the fused stepper runs float32 grids only (the stage "
                f"kernel is f32); got {self.grid.dtype}. Use make_step or "
                f"build the grid with dtype=torch.float32.")
        args = (self.grid, self.gravity, self.omega, dt, self.b_ext)
        kw = {"scheme": self.scheme, "limiter": self.limiter}
        if not compact:
            return make_fused_ssprk3_cov_inkernel(*args, **kw)
        if self.nu4 != 0.0:
            make = {"split": make_fused_ssprk3_cov_split_nu4,
                    "refused": make_fused_ssprk3_cov_refused_nu4,
                    "stage": make_fused_ssprk3_cov_nu4}[nu4_mode]
            return make(*args, self.nu4, **kw)
        return make_fused_ssprk3_cov_compact(*args, **kw)

    # -- classic path --------------------------------------------------------
    def _fill_u(self, u_int):
        return self.exchange_u(embed_interior(self.grid, u_int))

    def rhs(self, state: State, t) -> State:
        grid = self.grid
        h_ext = self.fill(state["h"])
        u_ext = self._fill_u(state["u"])
        if self._pallas_rhs is not None:
            dh, du = self._pallas_rhs(h_ext, u_ext, self.b_ext)
        else:
            dh, du = self._rhs_jnp(h_ext, u_ext)

        if self.nu4 > 0.0:
            l1h = laplacian(grid, h_ext)
            dh = dh - self.nu4 * laplacian(grid, self.fill(l1h))
            l1u = laplacian(grid, u_ext)
            du = du - self.nu4 * laplacian(grid, self._fill_u(l1u))
        return {"h": dh, "u": du}

    def _rhs_jnp(self, h_ext, u_ext):
        """The stencil section of :meth:`rhs` as torch operators."""
        grid = self.grid
        # Contravariant components and kinetic energy on the extended
        # grid (the Bernoulli gradient reads one ghost deep).
        uc_a = self.ginv_aa * u_ext[0] + self.ginv_ab * u_ext[1]
        uc_b = self.ginv_ab * u_ext[0] + self.ginv_bb * u_ext[1]
        ke = 0.5 * (uc_a * u_ext[0] + uc_b * u_ext[1])

        ux, uy = covariant_face_normal_velocity(grid, u_ext)
        dh = -flux_divergence_faces(grid, h_ext, ux, uy, scheme=self.scheme,
                                    limiter=self.limiter)

        zeta = vorticity_cov(grid, u_ext)
        bern = self.gravity * (h_ext + self.b_ext) + ke
        h_, n, d = grid.halo, grid.n, grid.dalpha
        dba = (bern[..., h_:h_ + n, h_ + 1:h_ + n + 1]
               - bern[..., h_:h_ + n, h_ - 1:h_ + n - 1]) / (2 * d)
        dbb = (bern[..., h_ + 1:h_ + n + 1, h_:h_ + n]
               - bern[..., h_ - 1:h_ + n - 1, h_:h_ + n]) / (2 * d)

        absv = (zeta + self.fcor) * grid.interior(grid.sqrtg)
        dua = absv * grid.interior(uc_b) - dba
        dub = -absv * grid.interior(uc_a) - dbb
        return dh, torch.stack([dua, dub])
