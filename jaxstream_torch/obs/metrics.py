"""On-device metric streams: the invariant ladder, computed in the loop.

Counterpart of :mod:`jaxstream.obs.metrics`.  Williamson et al. (1992)
define the conservation ladder a shallow-water run monitors (mass,
energy, potential enstrophy); the run-health scalars (h min/max, max
|v|, local CFL number, non-finite count) catch a blowup while it is
still cheap.

* :data:`METRICS` registers named scalar reductions (:class:`MetricSpec`)
  over the interior state;
* :func:`build_metric_set` resolves a config's names against a model and
  state family into a :class:`MetricSet`, whose ``values(state)`` is ONE
  stacked ``(k_metrics,)`` tensor on the state's device — what
  :func:`jaxstream_torch.stepping.integrate_with_metrics` writes into its
  ``(k_metrics, samples)`` device buffer;
* :func:`fetch_buffer` is the single device-to-host copy of a segment.

The metrics are plain torch reductions on the device, as the JAX ones
are jnp outside any Pallas kernel; nothing reads a value back to the
host.  A member-batched state (scalar field of rank 4) reports member 0
with the non-finite count over every member.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict

import numpy as np
import torch

from ..utils import diagnostics as diag

__all__ = ["MetricSpec", "METRICS", "MetricSet", "build_metric_set",
           "default_metrics", "fetch_buffer", "member_nonfinite_specs",
           "resolve_metric_names", "state_family", "CONSERVED"]

#: Invariants whose relative drift vs step 0 is worth a sink column.
CONSERVED = ("mass", "energy", "enstrophy", "tracer_mass", "heat")


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One named scalar metric: ``fn(ctx) -> 0-d tensor``.

    ``requires``: the capability tags a run must provide, a subset of
    ``{"swe", "cov", "advection", "diffusion", "ensemble"}``; empty means
    every family.
    """
    name: str
    doc: str
    requires: frozenset
    fn: Callable


class _Ctx:
    """Per-sample intermediates shared between metric functions (built
    once per ``MetricSet.values`` call; ``max_speed`` and ``cfl`` share
    one ``speed2``).  A member-batched state exposes member 0 through
    ``field0`` / ``u0``; ``all_arrays`` keeps the whole batch."""

    def __init__(self, ms: "MetricSet", state):
        self.ms = ms
        self.state = state
        self.grid = ms.grid
        self.dt = ms.dt
        self.gravity = ms.gravity
        self.b_int = ms.b_int
        f = state[ms.field_key]
        self.batched = f.ndim == 4
        self.field0 = f[0] if self.batched else f
        self._cache: Dict[str, object] = {}

    def _memo(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    @property
    def u0(self):
        u = self.state["u" if "u" in self.state else "v"]
        return u[:, 0] if self.batched else u

    @property
    def speed2(self):
        def mk():
            u = self.u0
            if self.ms.cov:
                iaa, iab, ibb = self.ms.ginv_int
                uc_a = iaa * u[0] + iab * u[1]
                uc_b = iab * u[0] + ibb * u[1]
                return uc_a * u[0] + uc_b * u[1]
            return torch.sum(u * u, dim=0)
        return self._memo("speed2", mk)

    @property
    def vcart(self):
        def mk():
            if self.ms.cov:
                return self.ms.model.to_cartesian({"u": self.u0})
            return self.u0
        return self._memo("vcart", mk)

    @property
    def absvort(self):
        def mk():
            from ..ops.fv import vorticity_cov

            m = self.ms.model
            return vorticity_cov(self.grid, m._fill_u(self.u0)) + m.fcor
        return self._memo("absvort", mk)

    @property
    def all_arrays(self):
        return list(self.state.values())

    @property
    def field_all(self):
        """The full (possibly member-batched) primary field."""
        return self.state[self.ms.field_key]

    @property
    def area_w(self):
        """Normalized interior cell-area weights (the shared formula of
        the ensemble statistics)."""
        return self._memo(
            "area_w", lambda: diag.ensemble_area_weights(self.grid))


METRICS: Dict[str, MetricSpec] = {}


def _register(name, doc, requires, fn):
    METRICS[name] = MetricSpec(name, doc, frozenset(requires), fn)


def _count_nonfinite(arrays, dtype):
    total = 0
    for a in arrays:
        total = total + torch.sum(~torch.isfinite(a))
    # A float, so that it stacks with the invariants.
    return torch.as_tensor(total).to(dtype)


_register("mass", "integral h dA (member 0)", {"swe"},
          lambda c: diag.total_mass(c.grid, c.field0))
_register("energy", "integral [h|v|^2/2 + g h (h/2 + b)] dA", {"swe"},
          lambda c: diag.total_energy(c.grid, c.field0, c.vcart,
                                      c.gravity, c.b_int))
_register("enstrophy", "integral (zeta + f)^2 / (2h) dA", {"swe", "cov"},
          lambda c: diag.potential_enstrophy(c.grid, c.field0, c.absvort))
_register("h_min", "min h (blowups go negative first)", {"swe"},
          lambda c: torch.min(c.field0))
_register("h_max", "max h", {"swe"},
          lambda c: torch.max(c.field0))
_register("max_speed", "max |v| (m/s)", {"swe"},
          lambda c: torch.sqrt(torch.max(c.speed2)))
# Local 2-D CFL: per-cell (sqrt(g h) + |v|) (1/dx_a + 1/dx_b) from the
# metric cell spacings, max over cells, times dt.  A negative h makes it
# NaN, which the NaN guard catches.
_register("cfl", "dt * max_cell (sqrt(gh) + |v|)(1/dxa + 1/dxb)", {"swe"},
          lambda c: c.dt * torch.max(
              (torch.sqrt(c.gravity * c.field0) + torch.sqrt(c.speed2))
              * c.ms.inv_dx))
_register("nonfinite_count", "number of non-finite state entries "
          "(all members)", set(),
          lambda c: _count_nonfinite(c.all_arrays, c.field0.dtype))
# Ensemble statistics of a member-batched state ('ensemble' is a
# capability only such states provide).
_register("h_spread", "area-RMS ensemble spread of h "
          "(sqrt of weighted mean member variance)",
          {"swe", "ensemble"},
          lambda c: diag.ensemble_spread(c.field_all, c.area_w))
_register("ens_mean_drift", "area-RMS distance of the ensemble-mean "
          "h from member 0",
          {"swe", "ensemble"},
          lambda c: diag.ensemble_mean_drift(c.field_all, c.area_w))
_register("tracer_mass", "integral q dA", {"advection"},
          lambda c: diag.total_mass(c.grid, c.field0))
_register("tracer_max", "max q (shape preservation)", {"advection"},
          lambda c: torch.max(c.field0))
_register("heat", "integral T dA", {"diffusion"},
          lambda c: diag.total_mass(c.grid, c.field0))


def member_nonfinite_specs(members: int):
    """One ``nonfinite_m{i}`` row per member of a member-batched state:
    the names :class:`~jaxstream_torch.obs.monitor.HealthMonitor`
    attributes a guard event to a member from.  The member axis of an
    interior prognostic leaf is ``ndim - 4`` (``(B, 6, n, n)`` scalars,
    ``(c, B, 6, n, n)`` vectors)."""

    def mk(i):
        def fn(c, _i=i):
            return _count_nonfinite(
                [a.select(a.ndim - 4, _i) for a in c.all_arrays],
                c.field0.dtype)
        return fn

    return tuple(
        MetricSpec(f"nonfinite_m{i}",
                   f"number of non-finite state entries in member {i}",
                   frozenset(), mk(i))
        for i in range(members))


def state_family(state) -> str:
    """'swe' | 'advection' | 'diffusion' from the prognostic keys."""
    if "h" in state:
        return "swe"
    if "q" in state:
        return "advection"
    if "T" in state:
        return "diffusion"
    raise ValueError(
        f"cannot infer a model family from state keys {sorted(state)}")


def default_metrics(family: str, cov: bool) -> tuple:
    """The default metric ladder for one model family."""
    if family == "swe":
        names = ["mass", "energy"]
        if cov:
            names.append("enstrophy")
        return tuple(names + ["h_min", "h_max", "max_speed", "cfl",
                              "nonfinite_count"])
    if family == "advection":
        return ("tracer_mass", "tracer_max", "nonfinite_count")
    return ("heat", "nonfinite_count")


@dataclasses.dataclass
class MetricSet:
    """Resolved metrics for one run: ``values(state) -> (k,)`` tensor.

    ``state`` is the interior prognostic dict, optionally member-batched;
    carry keys that are not prognostics (strips) are dropped by the
    caller.
    """
    names: tuple
    specs: tuple
    grid: object
    model: object
    dt: float
    gravity: float
    field_key: str
    cov: bool
    b_int: object = None
    ginv_int: object = None
    inv_dx: object = None

    @property
    def k(self) -> int:
        return len(self.names)

    def values(self, state) -> torch.Tensor:
        ctx = _Ctx(self, state)
        vals = [torch.as_tensor(s.fn(ctx)) for s in self.specs]
        common = functools.reduce(torch.promote_types,
                                  [v.dtype for v in vals])
        return torch.stack([v.to(common) for v in vals])


def resolve_metric_names(names, family: str, cov: bool,
                         batched: bool = False) -> tuple:
    """Config value -> validated metric-name tuple.

    Accepts a list/tuple, a comma-separated string, or ``"default"`` /
    ``""`` (the family ladder).  Unknown names and metrics a family
    cannot provide raise with the valid set listed; ``batched`` adds the
    ``ensemble`` capability.
    """
    if isinstance(names, str):
        names = (default_metrics(family, cov)
                 if names.strip() in ("", "default")
                 else tuple(s.strip() for s in names.split(",") if s.strip()))
    else:
        names = tuple(names)
        if not names:
            names = default_metrics(family, cov)
    caps = {family} | ({"cov"} if cov else set()) \
        | ({"ensemble"} if batched else set())
    valid = sorted(n for n, s in METRICS.items() if s.requires <= caps)
    for n in names:
        if n not in METRICS:
            raise ValueError(
                f"unknown observability metric {n!r}; registered: "
                f"{sorted(METRICS)}")
        if not METRICS[n].requires <= caps:
            raise ValueError(
                f"observability metric {n!r} is not available for this "
                f"run (needs {sorted(METRICS[n].requires)}); valid here: "
                f"{valid}")
    return names


def build_metric_set(grid, model, example_state, names, dt: float,
                     gravity: float, member_rows: bool = False) -> MetricSet:
    """Resolve ``names`` against a model and state; precompute statics.

    ``example_state``: an interior prognostic dict (for the family and
    batch detection only).  ``model`` may be ``None`` for the scalar
    families; the SWE metrics need it.  ``member_rows``: on a
    member-batched state, append one ``nonfinite_m{i}`` row per member.
    """
    family = state_family(example_state)
    cov = family == "swe" and "u" in example_state
    field_key = {"swe": "h", "advection": "q", "diffusion": "T"}[family]
    field = example_state[field_key]
    batched = getattr(field, "ndim", 0) == 4
    names = resolve_metric_names(names, family, cov, batched=batched)
    specs = tuple(METRICS[n] for n in names)
    if member_rows and batched:
        extra = member_nonfinite_specs(field.shape[0])
        names = names + tuple(s.name for s in extra)
        specs = specs + extra
    ms = MetricSet(names=names, specs=specs, grid=grid, model=model,
                   dt=dt, gravity=gravity, field_key=field_key, cov=cov)
    if family == "swe":
        if model is None:
            raise ValueError("SWE observability metrics need the model")
        b = getattr(model, "b_ext", None)
        ms.b_int = grid.interior(b) if b is not None else 0.0
        if cov:
            ms.ginv_int = (grid.interior(model.ginv_aa),
                           grid.interior(model.ginv_ab),
                           grid.interior(model.ginv_bb))
        if "cfl" in names:
            # Per-cell inverse spacings from the metric basis: dx_i =
            # |e_i| * dalpha, evaluated once (eager and lazy grids alike).
            na = torch.sqrt(torch.sum(grid.e_a * grid.e_a, dim=0))
            nb = torch.sqrt(torch.sum(grid.e_b * grid.e_b, dim=0))
            ms.inv_dx = grid.interior(1.0 / (na * grid.dalpha)
                                      + 1.0 / (nb * grid.dalpha))
    return ms


def fetch_buffer(buf: torch.Tensor) -> np.ndarray:
    """THE one device-to-host copy of a segment's metric buffer (which
    also waits for the segment); a module-level seam, so that tests can
    count the fetches."""
    return buf.detach().cpu().numpy()
