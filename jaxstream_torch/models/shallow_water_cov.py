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

import numpy as np
import torch

from ..geometry.cubed_sphere import CubedSphereGrid
from ..ops.fv import (covariant_components, covariant_face_normal_velocity,
                      embed_interior, flux_divergence_faces, laplacian,
                      vorticity_cov)
from ..parallel.vector_halo import make_vector_halo_exchanger
from ..plan.rules import fail as plan_fail
from .base import State
from .shallow_water import SWEBase

__all__ = ["CovariantShallowWater", "ENSEMBLE_STATE_AXES",
           "ENSEMBLE_CARRY_AXES"]

#: Member-axis position per key of the batched interior state ``{"h": (B,
#: 6, n, n), "u": (2, B, 6, n, n)}`` (u's component axis first).
ENSEMBLE_STATE_AXES = {"h": 0, "u": 1}
#: Ditto for the batched compact fused-stepper carry.
ENSEMBLE_CARRY_AXES = {"h": 0, "u": 1, "strips_sn": 0, "strips_we": 0}

class CovariantShallowWater(SWEBase):
    """State ``{"h": (6, n, n), "u": (2, 6, n, n)}``, u covariant."""

    #: make_fused_step handles nu4 > 0 (the ``nu4_mode`` steppers);
    #: Simulation's fused-path guard reads this capability flag.
    fused_supports_nu4 = True

    def __init__(self, grid: CubedSphereGrid, gravity: float, omega: float,
                 b_ext: Optional[torch.Tensor] = None, scheme: str = "plr",
                 limiter: str = "mc", nu4: float = 0.0,
                 backend: str = "jnp"):
        super().__init__(grid, gravity, omega, b_ext=b_ext, scheme=scheme,
                         limiter=limiter, nu4=nu4, backend=backend)
        self.exchange_u = make_vector_halo_exchanger(
            grid, components="covariant")
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

    @staticmethod
    def stack_ensemble(states) -> State:
        """A list of interior states -> one batched ensemble state
        ``{"h": (B, 6, n, n), "u": (2, B, 6, n, n)}``
        (:data:`ENSEMBLE_STATE_AXES`)."""
        return {"h": torch.stack([s["h"] for s in states], dim=0),
                "u": torch.stack([s["u"] for s in states], dim=1)}

    @staticmethod
    def member_state(batched: State, i: int) -> State:
        """One member's interior state out of a batched ensemble state."""
        return {"h": batched["h"][i], "u": batched["u"][:, i]}

    def ensemble_compact_state(self, batched: State) -> State:
        """Batched interior state -> the batched compact carry: the strip
        pack on the member axis folded into the face axis, then unfolded,
        so each member's strips are the unbatched pack's."""
        from ..ops.cuda.swe_cov import pack_strips_cov_split

        g = self.grid
        h, u = batched["h"], batched["u"]
        B = h.shape[0]
        sn, we = pack_strips_cov_split(
            h.reshape((B * 6,) + tuple(h.shape[2:])),
            u.reshape((2, B * 6) + tuple(u.shape[3:])), g.n, g.halo)
        return {"h": h, "u": u,
                "strips_sn": sn.reshape((B, 6) + tuple(sn.shape[1:])),
                "strips_we": we.reshape((B, 6) + tuple(we.shape[1:]))}

    @staticmethod
    def encode_carry(y: State, carry_dtype=None, h_offset: float = 0.0,
                     h_scale: float = 1.0, u_scale: float = 1.0) -> State:
        """A :meth:`compact_state` carry in the stepper's storage encoding
        (per-field dtype; h stored as ``(h - h_offset) / h_scale``, u as
        ``u / u_scale``; integer storage rounded to nearest even and
        saturated)."""
        if carry_dtype is None:
            if h_offset or h_scale != 1.0 or u_scale != 1.0:
                carry_dtype = torch.float32
            else:
                return y
        dt_h, dt_u = (tuple(carry_dtype)
                      if isinstance(carry_dtype, (tuple, list))
                      else (carry_dtype,) * 2)

        def enc(x, off, scale, dt):
            if off:
                x = x - float(np.float32(off))
            if scale != 1.0:
                x = x / float(np.float32(scale))
            if not dt.is_floating_point:
                info = torch.iinfo(dt)
                return torch.round(x).clamp(info.min, info.max).to(dt)
            return x.to(dt)

        out = dict(y)
        out["h"] = enc(y["h"], h_offset, h_scale, dt_h)
        out["u"] = enc(y["u"], 0.0, u_scale, dt_u)
        return out

    @staticmethod
    def decode_carry(y: State, h_offset: float = 0.0, h_scale: float = 1.0,
                     u_scale: float = 1.0) -> State:
        """Inverse of :meth:`encode_carry`: back to absolute float32."""
        def dec(x, off, scale):
            x = x.to(torch.float32)
            if scale != 1.0:
                x = x * float(np.float32(scale))
            return x + float(np.float32(off)) if off else x

        out = dict(y)
        out["h"] = dec(y["h"], h_offset, h_scale)
        out["u"] = dec(y["u"], 0.0, u_scale)
        return out

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
                        ensemble: int = 0, ensemble_impl: str = "kernel",
                        precision=None):
        """The fused SSPRK3 step ``step(y, t) -> y``.

        ``compact=True`` (the production path) steps ``y =
        compact_state(state)``.  With ``nu4 == 0`` it is
        :func:`make_fused_ssprk3_cov_multistep` and ``nu4_mode`` is
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

        The JAX package's knobs: ``carry_dtype`` / ``h_offset`` /
        ``h_scale`` / ``u_scale`` (compact, nu4 == 0, one member:
        initialise with :meth:`encode_carry`), ``temporal_block = k``
        (k exact steps per call, ``steps_per_call`` set), ``ensemble =
        B`` (compact, nu4 == 0: the batched carry of
        :meth:`ensemble_compact_state`, one launch per stage over all
        members with ``ensemble_impl='kernel'``, or
        :func:`~jaxstream_torch.stepping.vmap_ensemble` over the
        one-member step with ``'vmap'``) and ``precision`` (the stage
        policy of :mod:`jaxstream_torch.ops.cuda.precision`; not on the
        ``'stage'`` oracle; the extended carry takes its compute half
        only).  Its refusals are the rule table's
        (:func:`jaxstream_torch.plan.rules.fail`: a ``PlanError``, a
        ``ValueError``, with the JAX messages).  One difference: the JAX package builds the fused step only with
        ``backend='pallas'``; the port builds it on every backend, since
        its stage wrappers launch their kernels on CUDA tensors whatever
        the classic ``rhs`` runs.
        """
        from ..ops.cuda.precision import resolve_stage_precision
        from ..ops.cuda.swe_cov import (make_fused_ssprk3_cov_inkernel,
                                        make_fused_ssprk3_cov_multistep,
                                        make_fused_ssprk3_cov_nu4,
                                        make_fused_ssprk3_cov_refused_nu4,
                                        make_fused_ssprk3_cov_split_nu4)
        from ..stepping import blocked, vmap_ensemble

        if nu4_mode not in ("split", "stage", "refused"):
            raise ValueError(f"nu4_mode must be 'split', 'stage' or "
                             f"'refused', got {nu4_mode!r}")
        precision = resolve_stage_precision(precision)
        if temporal_block < 1:
            raise ValueError(
                f"temporal_block must be >= 1, got {temporal_block}")
        if ensemble < 0:
            raise ValueError(f"ensemble must be >= 0, got {ensemble}")
        if ensemble:
            if ensemble_impl not in ("kernel", "vmap"):
                raise ValueError(f"ensemble_impl must be 'kernel' or "
                                 f"'vmap', got {ensemble_impl!r}")
            if not compact:
                raise ValueError(
                    "ensemble > 0 requires the compact carry (the "
                    "extended-state stepper has no batched form)")
            if self.nu4 != 0.0:
                plan_fail("fused-ensemble-nu4")
            if carry_dtype is not None:
                plan_fail("carry-needs-single-member")
        encoded = (carry_dtype is not None or h_offset or h_scale != 1.0
                   or u_scale != 1.0)
        if self.grid.dtype != torch.float32:
            raise ValueError(
                f"the fused stepper runs float32 grids only (the stage "
                f"kernel is f32); got {self.grid.dtype}. Use make_step or "
                f"build the grid with dtype=torch.float32.")

        def _blocked(step1):
            if temporal_block == 1:
                return step1
            step = blocked(step1, temporal_block, dt)
            step.steps_per_call = temporal_block
            return step

        args = (self.grid, self.gravity, self.omega, dt, self.b_ext)
        kw = {"scheme": self.scheme, "limiter": self.limiter}
        if self.nu4 != 0.0:
            if not compact:
                raise ValueError("nu4 > 0 requires the compact carry")
            if encoded:
                plan_fail("nu4-no-carry-encoding")
            if nu4_mode == "stage" and precision is not None:
                plan_fail("nu4-stage-oracle-f32")
            if nu4_mode == "stage":
                return _blocked(make_fused_ssprk3_cov_nu4(
                    *args, self.nu4, **kw))
            make = {"split": make_fused_ssprk3_cov_split_nu4,
                    "refused": make_fused_ssprk3_cov_refused_nu4}[nu4_mode]
            return _blocked(make(*args, self.nu4, precision=precision,
                                 **kw))
        if compact:
            kernel_ensemble = ensemble if ensemble_impl == "kernel" else 0
            step = make_fused_ssprk3_cov_multistep(
                *args, temporal_block, carry_dtype=carry_dtype,
                h_offset=h_offset, h_scale=h_scale, u_scale=u_scale,
                ensemble=kernel_ensemble, precision=precision, **kw)
            if ensemble and ensemble_impl == "vmap":
                step = vmap_ensemble(step, ENSEMBLE_CARRY_AXES)
                step.ensemble = ensemble
            if temporal_block > 1:
                step.steps_per_call = temporal_block
            return step
        if encoded:
            raise ValueError("carry_dtype/h_offset/u_scale/_ablate_seam "
                             "require the compact carry")
        return _blocked(make_fused_ssprk3_cov_inkernel(
            *args, precision=precision, **kw))

    def to_cartesian(self, state: State) -> torch.Tensor:
        """Interior covariant velocity -> Cartesian (3, 6, n, n)."""
        g = self.grid
        iaa, iab, ibb = (g.interior(self.ginv_aa), g.interior(self.ginv_ab),
                         g.interior(self.ginv_bb))
        ua = iaa * state["u"][0] + iab * state["u"][1]
        ub = iab * state["u"][0] + ibb * state["u"][1]
        return (ua[None] * g.interior(g.e_a)
                + ub[None] * g.interior(g.e_b))

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
