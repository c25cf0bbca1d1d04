"""The end-to-end simulation run (counterpart of :mod:`jaxstream.simulation`).

``config -> grid -> initial conditions -> [rank mesh] -> segmented step
loop with history and restart -> diagnostics``, config-driven end to end,
on the device the caller gives (the GPU unless it asks for the CPU).

* The run is a loop of segments, each ``gcd(history_stride,
  checkpoint_stride)`` steps long (the whole run without strides): the
  JAX package's segmentation, so that the two packages write their
  history and checkpoints at the same steps.  Inside a segment the
  state stays on the device; the host touches it only at history and
  checkpoint boundaries.
* Single-device shallow-water runs with ``backend: pallas`` and
  ``time.scheme: ssprk3`` take the model's fused stepper, as the JAX
  package does: the compact carry on the covariant model (its CUDA stage
  kernel, with ``nu4 > 0`` the ``nu4_mode``'s del^4 kernels), the
  extended carry with in-kernel exchange on the Cartesian one.  A
  segment is ``prep -> integrate -> restrict_state``.  Every other run
  takes the classic step (``make_stepper_for``).
* ``parallelization.use_shard_map: true`` with ``num_devices > 1`` runs
  the explicit covariant tiers on virtual ranks; ``self.state`` stays
  the global state, cut into the ranks' blocks for each segment.
* Restart is automatic: with a checkpoint stride, a run resumes from
  the newest saved step (regridded if its resolution differs).

* ``ensemble.members > 1`` (one device): a perturbed-IC batched state;
  covariant ``pallas`` runs with ``nu4 == 0`` take the batched fused
  stepper (every member in one launch per stage), the rest the classic
  step over the member axis.  ``diagnostics()`` then reports member 0's
  invariants and the ensemble's height spread.
* ``precision:`` (stage, strips, carry) rides the single-device fused
  covariant stepper; a carry encoding wraps its prep and every exit.
* ``grid.metrics: lazy`` builds a :class:`~.geometry.cubed_sphere.
  LazyCubedSphereGrid` (metric terms evaluated on access).
* ``observability:`` (``interval > 0``): each segment runs
  :func:`~.stepping.integrate_with_metrics` (the same state operations in
  the same order, one ``+ dt`` per call as the JAX package's
  instrumented loop) and keeps the metric ladder in a device buffer
  fetched once per segment; the health monitor checks it under the guard
  policy, the sink writes the JAX package's JSONL records, and a failure
  flushes the flight recorder into a crash bundle under ``flight_dir``.
* ``io.async_pipeline.enabled``: segment k+1 is dispatched before segment
  k's boundary is resolved; its copies ride a side stream and its writes
  go to one background writer thread, in the synchronous path's order.

Not ported yet, and refused with ``NotImplementedError`` naming the
config key and ROADMAP item: the TT tier, the tiers' ensembles, a
bfloat16 grid, TT history, data assimilation and the GSPMD tier.  The
capability plan (``plan_for``) is not ported; the rules it applies to
the runs ported here are checked where the run is built.
"""

from __future__ import annotations

import functools
import logging
import math
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ._device import resolve_device
from .config import Config, load_config
from .geometry.cubed_sphere import build_grid
from .io.async_pipeline import BackgroundWriter, HostFetch
from .io.checkpoint import CheckpointManager
from .io.history import HistoryWriter, save_geometry
from .models.advection import TracerAdvection
from .models.diffusion import ThermalDiffusion
from .models.shallow_water import ShallowWater
from .obs import flight
from .obs import metrics as obs_metrics
from .obs.monitor import HealthMonitor
from .obs.sink import TelemetrySink, run_manifest
from .parallel.mesh import setup_sharding, shard_state, unshard_state
from .parallel.sharded_model import make_stepper_for
from .physics import initial_conditions as ics
from .stepping import integrate, integrate_with_metrics, jit_integrate
from .utils import diagnostics as diag
from .utils.logging import get_logger

__all__ = ["Simulation", "run_from_config", "IC_FAMILY"]

log = get_logger(__name__)

#: The prognostic keys of every dense state family: what the in-loop
#: metric functions see (a fused carry's strips are dropped first).
_PROG_KEYS = ("h", "u", "v", "q", "T")


class _ObsRuntime:
    """Per-Simulation telemetry wiring (built by ``_build_obs``)."""

    def __init__(self, cfg, metric_set, metric_fn, monitor, sink, ref):
        self.cfg = cfg                  # the ObservabilityConfig block
        self.ms = metric_set
        self.metric_fn = metric_fn      # fn(loop_carry, t) -> (k,) tensor
        self.monitor = monitor
        self.sink = sink
        self.ref = ref                  # step-0 metric values (np, (k,))
        self.wrote_initial = False


def _run_tasks(tasks):
    """One async boundary's writes, in order, as ONE writer task: the
    queue bound counts segments, and a failure aborts the boundary's
    remaining writes."""
    for fn, args in tasks:
        fn(*args)


_DTYPES = {"float32": torch.float32, "float64": torch.float64}

#: initial-condition name -> model family it drives
IC_FAMILY = {
    "tc1": "advection",
    "cosine_bell": "advection",
    "checkerboard": "diffusion",
    "tc2": "shallow_water",
    "tc5": "shallow_water",
    "tc6": "shallow_water",
    "galewsky": "shallow_water",
}

#: The JAX package's pointer for a precision or ``nu4_mode`` knob on a
#: run that does not take the fused stepper (its plan rule
#: ``precision-needs-fused-path``).
_NEEDS_FUSED = (
    "the precision: block (stage/strips/carry != f32) and "
    "model.nu4_mode != 'split' ride the single-device fused "
    "covariant stepper: they need model.backend: pallas, "
    "time.scheme: ssprk3, model.numerics: dense and "
    "parallelization.num_devices: 1 (sharded tiers take the "
    "wire accounting only — scripts/comm_probe.py "
    "--strip-dtype bf16)")


def _refuse(knob: str, item: str):
    raise NotImplementedError(
        f"{knob} is not ported yet: ROADMAP {item}")


def _refuse_unported(cfg: Config) -> None:
    """Refuse every config knob the port does not run yet, before any
    build; each message names the key and its ROADMAP item."""
    m, par, io = cfg.model, cfg.parallelization, cfg.io
    if m.numerics == "tt":
        _refuse("model.numerics: tt (the factored TT tier)",
                "queue A item 8 (A11)")
    if cfg.ensemble.members > 1 and par.num_devices > 1:
        _refuse(f"ensemble.members: {cfg.ensemble.members} with "
                f"parallelization.num_devices: {par.num_devices} (the "
                "tiers' ensembles)", "queue A item 4 (A8)")
    if cfg.grid.dtype not in _DTYPES:
        _refuse(f"grid.dtype: {cfg.grid.dtype} (grids are float32 or "
                "float64)", "queue A item 5")
    if io.history_tt_rank > 0:
        _refuse(f"io.history_tt_rank: {io.history_tt_rank} (TT-compressed "
                "history)", "queue A item 8 (A11)")
    if cfg.da.cycles > 0:
        _refuse(f"da.cycles: {cfg.da.cycles} (ensemble data assimilation)",
                "queue A item 6 (A7)")
    if par.num_devices > 1 and not par.use_shard_map:
        _refuse(f"parallelization.num_devices: {par.num_devices} with "
                "use_shard_map: false (the GSPMD tier)",
                "queue A item 4 (A8)")


def _validate(cfg: Config) -> None:
    """The JAX package's own value checks of the knobs the port runs."""
    m = cfg.model
    if cfg.ensemble.members < 1:
        raise ValueError(
            f"ensemble.members must be >= 1, got {cfg.ensemble.members}")
    if m.numerics not in ("dense", "tt"):
        raise ValueError(
            f"model.numerics={m.numerics!r}; valid: 'dense' "
            "(production solvers) or 'tt' (factored-panel tier)")
    p = cfg.precision
    if p.stage not in ("f32", "bf16"):
        raise ValueError(
            f"precision.stage={p.stage!r}; valid: 'f32', 'bf16'")
    if p.strips not in ("auto", "f32", "bf16"):
        raise ValueError(f"precision.strips={p.strips!r}; valid: 'auto', "
                         "'f32', 'bf16'")
    if p.carry not in ("f32", "bf16", "mixed16"):
        raise ValueError(f"precision.carry={p.carry!r}; valid: 'f32', "
                         "'bf16', 'mixed16'")
    if m.nu4_mode not in ("split", "stage", "refused"):
        raise ValueError(f"nu4_mode must be 'split', 'stage' or 'refused', "
                         f"got {m.nu4_mode!r}")
    if cfg.grid.metrics not in ("eager", "lazy"):
        raise ValueError(f"metrics must be 'eager' or 'lazy', got "
                         f"{cfg.grid.metrics!r}")


class Simulation:
    """Config -> grid -> model+IC -> [rank mesh] -> run loop -> outputs.

    ``device``: where the run lives (default: the GPU).
    ``parallelization.device_type`` is a name only and does not move it.
    """

    def __init__(self, config: Any = None, device=None):
        self.config: Config = load_config(config)
        cfg = self.config
        _validate(cfg)
        _refuse_unported(cfg)
        self.device = resolve_device(device)
        mcfg = cfg.model
        halo = cfg.grid.halo
        if mcfg.scheme == "ppm":
            halo = max(halo, 3)
        self.grid = build_grid(cfg.grid.n, halo=halo, radius=cfg.grid.radius,
                               dtype=_DTYPES[cfg.grid.dtype],
                               device=self.device, metrics=cfg.grid.metrics)
        self.t = 0.0
        self.step_count = 0
        self.setup = None
        self.members = cfg.ensemble.members
        self._classic_run = None
        self.model, self.state = self._build_model_and_state()

        par = cfg.parallelization
        if self.members > 1:
            self.state = self._build_ensemble_state()
        if par.num_devices > 1:
            self.setup = setup_sharding(cfg, device=self.device)
        # The tiers take the precision spec only where they run (they
        # refuse a non-f32 policy); one device takes the fused stepper.
        pspec = ({"stage": cfg.precision.stage,
                  "strips": cfg.precision.strips}
                 if par.num_devices > 1 else None)
        self._step = make_stepper_for(
            self.model, self.setup, self.state, cfg.time.dt,
            cfg.time.scheme, temporal_block=par.temporal_block,
            ensemble=self.members if self.members > 1 else 0,
            precision=pspec)

        # Single-device fused stepper, under the JAX package's guards.
        self._fused_step = None
        self._fused_prep = None
        # Decode of a 16-bit carry encoding (precision.carry), applied to
        # every carry exit so that the state, history, checkpoints and
        # diagnostics see absolute f32 fields; None: the f32 carry.
        self._fused_post = None
        m = self.model
        tb = par.temporal_block
        pkw, p_enc, p_dec = self._resolve_precision()
        touched = bool(pkw) or p_enc is not None
        fusable = (self.setup is None
                   and cfg.time.scheme == "ssprk3"
                   and getattr(m, "backend", "").startswith("pallas"))
        if (self.members > 1 and fusable
                and getattr(m, "nu4", 0.0) == 0.0
                and hasattr(m, "ensemble_compact_state")):
            # The batched fused path: the member axis folds into the
            # stage kernels' faces, one launch per stage for every member.
            try:
                self._fused_step = m.make_fused_step(
                    cfg.time.dt, temporal_block=tb, ensemble=self.members,
                    **pkw)
            except (TypeError, ValueError) as e:
                self._fused_failed(e, touched, "batched fused stepper",
                                   "the vmapped classic path")
            else:
                if p_enc is not None:
                    self._fused_prep = (
                        lambda s, _e=p_enc: _e(m.ensemble_compact_state(s)))
                else:
                    self._fused_prep = m.ensemble_compact_state
                log.info("using batched ensemble fused SSPRK3 stepper "
                         "(%d members per kernel launch)", self.members)
        elif (self.members == 1 and fusable
                and (getattr(m, "nu4", 0.0) == 0.0
                     or getattr(m, "fused_supports_nu4", False))
                and hasattr(m, "make_fused_step")):
            try:
                if not hasattr(m, "compact_state") and (
                        pkw.get("precision") or p_enc is not None):
                    raise ValueError(
                        "precision: block needs the compact-carry fused "
                        "stepper (this model only has the extended-state "
                        "form)")
                self._fused_step = self._make_fused(m, cfg.time.dt, tb, pkw)
            except (TypeError, ValueError) as e:
                self._fused_failed(e, touched, "fused stepper",
                                   "the classic path")
            else:
                if hasattr(m, "compact_state"):
                    if p_enc is not None:
                        self._fused_prep = (
                            lambda s, _e=p_enc: _e(m.compact_state(s)))
                        self._fused_post = p_dec
                    else:
                        self._fused_prep = m.compact_state
                    log.info("using compact fused SSPRK3 stepper "
                             "(interior-only carry)")
                else:
                    self._fused_prep = functools.partial(
                        m.extend_state, with_strips=True)
                    log.info("using fused extended-state SSPRK3 stepper")
        if touched and self._fused_step is None:
            raise ValueError(_NEEDS_FUSED)

        io = cfg.io
        self.history: Optional[HistoryWriter] = None
        self.checkpoints: Optional[CheckpointManager] = None
        self._segment_cache: Dict[int, Callable] = {}
        #: Host seconds spent writing history frames and checkpoints
        #: (the loop waits on them), summed over this object's runs.
        self.host_wait = 0.0
        # The same seconds since the last telemetry record (its
        # host_wait_s); under the async pipeline, the seconds its submits
        # blocked.  The writer thread starts with the first async run.
        self._host_wait = 0.0
        self._writer: Optional[BackgroundWriter] = None
        self._copy_stream = None
        self._t_carry = None         # the async loop's latest dispatched t
        if io.history_stride > 0:
            save_geometry(io.history_path + ".geometry", self.grid)
            self.history = HistoryWriter(
                io.history_path,
                attrs={"model": mcfg.name, "ic": mcfg.initial_condition,
                       "numerics": mcfg.numerics, "members": self.members})
        # Crash forensics: a dump-once latch, and the lineage of a resumed
        # run (the newest committed bundle in the flight dir).
        self._flight_dumped = False
        self._resume_lineage: Optional[dict] = None
        if io.checkpoint_stride > 0:
            self.checkpoints = CheckpointManager(io.checkpoint_path)
            self._maybe_resume()
            if self.step_count > 0:
                self._resume_lineage = self._find_lineage()
        # Telemetry last: its reference sees the resumed state, and the
        # guard's postmortem needs the checkpoint manager.
        self._obs = self._build_obs()

    # ------------------------------------------------------------------ build
    @staticmethod
    def _fused_failed(e, touched: bool, what: str, fallback: str):
        """A fused stepper that failed to build: a precision block or a
        nu4_mode has no classic form (``ValueError``); otherwise only the
        model's own validation (a ``ValueError``, a refusal the JAX package
        makes too) falls back, and a ``TypeError`` propagates, as every
        ``NotImplementedError`` and kernel build or launch failure does."""
        if touched:
            raise ValueError(
                f"precision: block configured but the {what} failed to "
                f"build ({type(e).__name__}: {e}); the policy has no "
                "classic-path form, so refusing to silently run "
                "f32") from e
        if isinstance(e, TypeError):
            raise e
        log.warning("%s unavailable (%s: %s); falling back to %s", what,
                    type(e).__name__, e, fallback)

    def _resolve_precision(self):
        """``precision:`` and ``model.nu4_mode`` -> ``(kwargs, encode,
        decode)``: the fused stepper's kwargs (``precision``, ``nu4_mode``
        and the ``carry_dtype`` / ``h_offset`` / ``h_scale`` encoding) and
        the carry hooks (``encode`` wraps the prep, ``decode`` every carry
        exit; both None for the f32 carry, ``encode`` alone narrowing the
        strips under a 16-bit strips policy).  The JAX package's rule: the
        mixed16 offset is the initial h's mid-range, so re-encoding at a
        segment boundary (a round of an on-grid value) is exact and the
        segment length never changes the trajectory."""
        from .ops.cuda.precision import (encode_strips, mixed16_encoding,
                                         resolve_stage_precision)
        from .plan.rules import fail as plan_fail

        pcfg = self.config.precision
        kw = {}
        if self.config.model.nu4_mode != "split":
            kw["nu4_mode"] = self.config.model.nu4_mode
        if pcfg.stage != "f32" or pcfg.strips not in ("auto", "f32"):
            kw["precision"] = {"stage": pcfg.stage, "strips": pcfg.strips}
        pol = resolve_stage_precision(kw.get("precision"))
        narrow = ((lambda y, _p=pol: encode_strips(y, _p))
                  if pol is not None and pol.strips == "bf16" else None)
        if pcfg.carry == "f32":
            return kw, narrow, None
        if self.members > 1:
            plan_fail("carry-needs-single-member")
        m = self.model
        if m is None or not hasattr(m, "encode_carry"):
            raise ValueError(
                "illegal capability plan: precision.carry != 'f32' needs "
                "the covariant dense model (model.numerics: dense, "
                "shallow-water family)")
        h = self.state["h"]
        if pcfg.carry == "mixed16":
            cd, off, hs = mixed16_encoding(h)
        else:
            off = float(0.5 * (float(torch.min(h)) + float(torch.max(h))))
            cd, hs = (torch.bfloat16, torch.bfloat16), 1.0
        kw.update(carry_dtype=cd, h_offset=off, h_scale=hs)
        if narrow is not None:
            def enc(s):
                return narrow(m.encode_carry(s, cd, off, hs))
        else:
            def enc(s):
                return m.encode_carry(s, cd, off, hs)

        def dec(s):
            return m.decode_carry(s, off, hs)

        return kw, enc, dec

    @staticmethod
    def _make_fused(m, dt: float, tb: int, pkw: dict):
        """The fused step, honouring temporal_block where the model takes
        the knob; exact k-step fusion through stepping.blocked where it
        does not (the Cartesian model)."""
        try:
            return m.make_fused_step(dt, temporal_block=tb, **pkw)
        except TypeError:
            if pkw:
                raise
        step = m.make_fused_step(dt)
        if tb > 1:
            from .stepping import blocked

            step = blocked(step, tb, dt)
            step.steps_per_call = tb
        return step

    @property
    def stepper_kind(self) -> str:
        """``'compact'``, ``'extended'`` (the fused carries) or
        ``'classic'``: which stepper the run takes."""
        if self._fused_step is None:
            return "classic"
        return "compact" if hasattr(self.model, "compact_state") \
            else "extended"

    def _build_obs(self) -> Optional[_ObsRuntime]:
        """Wire the ``observability:`` block into this run (or None): the
        resolved :class:`~.obs.metrics.MetricSet`, the metric function the
        instrumented segments call, the :class:`HealthMonitor` (policy !=
        'off'), the JSONL sink, and the step-0 reference values the drift
        columns are measured against (the resume point on a resumed
        run)."""
        o = self.config.observability
        if o.interval <= 0:
            return None
        tb = self.config.parallelization.temporal_block
        if o.interval % tb:
            raise ValueError(
                f"observability.interval={o.interval} must be a multiple "
                f"of parallelization.temporal_block={tb} (samples are "
                "taken at stepper-call boundaries)")
        # Segments are gcd(history_stride, checkpoint_stride) steps: a
        # longer interval would leave every segment without a sample.
        io = self.config.io
        strides = [s for s in (io.history_stride, io.checkpoint_stride)
                   if s > 0]
        seg = math.gcd(*strides) if strides else 0
        if seg and o.interval > seg:
            raise ValueError(
                f"observability.interval={o.interval} exceeds the "
                f"compiled segment length {seg} (= gcd of "
                f"io.history_stride/io.checkpoint_stride): every segment "
                "would take zero samples and the guards could never "
                "fire; lower the interval or raise the io strides")
        p, tc = self.config.physics, self.config.time
        ex = {k: v for k, v in self.state.items() if k in _PROG_KEYS}
        # An ensemble with guards gets one non-finite row per member, so
        # that a guard event names the offending member.
        ms = obs_metrics.build_metric_set(
            self.grid, self.model, ex, o.metrics, tc.dt, p.gravity,
            member_rows=(self.members > 1 and o.guards != "off"))
        m, setup = self.model, self.setup
        if self._fused_step is not None:
            post = self._fused_post

            def loop_prep(y):
                s = m.restrict_state(y)
                return post(s) if post is not None else s
        elif setup is not None:
            # The tiers step the ranks' blocks: the metrics see the whole
            # sphere, gathered once per sample.
            def loop_prep(y):
                return unshard_state(setup, y)
        else:
            def loop_prep(y):
                return {k: v for k, v in y.items() if k in _PROG_KEYS}

        def metric_fn(y, t):
            del t
            return ms.values(loop_prep(y))

        monitor = None
        if o.guards != "off":
            monitor = HealthMonitor(ms.names, o.guards, o.cfl_limit,
                                    on_breach=self._postmortem_checkpoint)
        sink = None
        if o.sink:
            cfg = self.config
            manifest = run_manifest(
                ms.names, o.interval, o.guards,
                config={
                    "grid_n": cfg.grid.n, "dtype": cfg.grid.dtype,
                    "dt": tc.dt, "scheme": tc.scheme,
                    "initial_condition": cfg.model.initial_condition,
                    "numerics": cfg.model.numerics,
                    "members": self.members,
                    "num_devices": cfg.parallelization.num_devices,
                    "use_shard_map": cfg.parallelization.use_shard_map,
                    "temporal_block": tb,
                    "stepper": self.stepper_kind,
                }, device=self.device)
            sink = TelemetrySink(o.sink, manifest)
            if self._resume_lineage is not None:
                sink.write({
                    "kind": "resume",
                    "bundle": self._resume_lineage["bundle"],
                    "checkpoint_step":
                        self._resume_lineage["checkpoint_step"],
                    "step": self.step_count,
                    "path": self._resume_lineage["path"],
                })
        ref = ms.values(ex).detach().cpu().numpy()
        log.info("observability: %d metrics every %d steps (guards=%s%s)",
                 ms.k, o.interval, o.guards,
                 f", sink={o.sink}" if o.sink else "")
        return _ObsRuntime(o, ms, metric_fn, monitor, sink, ref)

    def _postmortem_checkpoint(self, event=None):
        """The 'checkpoint_and_raise' breach callback: save the current
        (possibly corrupt) state for inspection, with the guard event's
        ``member`` in the checkpoint's meta.  The HealthError's last-good
        step is the restart target.  Queued background saves are drained
        first; under the async loop ``self.state`` is the latest
        dispatched segment's output."""
        if self.checkpoints is None:
            log.warning(
                "guard policy 'checkpoint_and_raise' with no checkpoint "
                "manager (io.checkpoint_stride is 0) — raising without "
                "a postmortem save")
            return
        if self._writer is not None and self._writer.alive:
            try:
                self._writer.flush()
            except Exception as e:  # the postmortem save must still run
                log.warning("async writer flush before postmortem failed "
                            "(%s: %s)", type(e).__name__, e)
        # Under the async loop the state is the latest dispatched
        # segment's, one boundary ahead of self.t.
        t = self.t if self._t_carry is None else float(self._t_carry)
        member = (event or {}).get("member")
        self.checkpoints.save(self.step_count, self.state, t,
                              meta={"postmortem": True, "member": member})
        log.warning("guard breach: postmortem checkpoint saved at step "
                    "%d%s", self.step_count,
                    f" (member {member})" if member is not None else "")

    # ------------------------------------------------------ crash forensics
    def _find_lineage(self) -> Optional[dict]:
        """The newest committed crash bundle in the flight dir, verified
        readable: the incident this resumed run descends from.  None
        without a flight dir or a bundle, or when the newest is torn."""
        fdir = flight.resolve_flight_dir(self.config)
        bdir = flight.latest_bundle(fdir) if fdir else None
        if bdir is None:
            return None
        try:
            manifest, _ = flight.read_bundle(bdir)
        except flight.TornBundleError as e:
            log.warning("resume: latest crash bundle %s is torn (%s); "
                        "resuming without lineage", bdir, e)
            return None
        return {"bundle": manifest["bundle_id"], "path": bdir,
                "checkpoint_step": self.step_count}

    def _device_memory(self) -> Optional[dict]:
        """The allocator's counters of the run's GPU (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        return {"bytes_in_use": torch.cuda.memory_allocated(self.device),
                "peak_bytes_in_use":
                    torch.cuda.max_memory_allocated(self.device),
                "bytes_limit": torch.cuda.get_device_properties(
                    self.device).total_memory}

    def _flight_dump(self, reason: str) -> None:
        """Flush the flight ring as an atomic crash bundle and typed
        ``flight`` / ``crash`` sink records: once per incident, only with
        ``observability.flight_dir``, never raising (forensics must not
        mask the exception in flight)."""
        if self._flight_dumped:
            return
        fdir = flight.resolve_flight_dir(self.config)
        if not fdir:
            return
        self._flight_dumped = True
        try:
            cfg = self.config
            ckpt = None
            if self.checkpoints is not None:
                step = self.checkpoints.latest_step()
                if step is not None:
                    ckpt = {"step": step, "path": self.checkpoints.path}
            writer = flight.BundleWriter(fdir)
            writer.commit(
                reason,
                config={"grid_n": cfg.grid.n, "dt": cfg.time.dt,
                        "members": self.members,
                        "step": self.step_count,
                        "guards": cfg.observability.guards},
                device_memory=self._device_memory(),
                checkpoint=ckpt)
            obs = self._obs
            if obs is not None and obs.sink is not None:
                events, threads, dropped = flight.RECORDER.dump()
                obs.sink.write({
                    "kind": "flight", "events": len(events),
                    "threads": len(threads), "dropped": dropped})
                obs.sink.write({
                    "kind": "crash", "bundle": writer.bundle_id,
                    "path": writer.path, "reason": reason})
        except Exception as e:
            log.warning("flight bundle dump failed (%s: %s)",
                        type(e).__name__, e)

    def _ensure_writer(self) -> BackgroundWriter:
        if self._writer is None or not self._writer.alive:
            self._writer = BackgroundWriter(
                self.config.io.async_pipeline.max_pending_segments)
        return self._writer

    def close(self):
        """Release background resources: drain and join the async writer
        thread, close the telemetry sink.  Idempotent."""
        if self._writer is not None:
            w, self._writer = self._writer, None
            w.close()
        if self._obs is not None and self._obs.sink is not None:
            self._obs.sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _build_model_and_state(self):
        cfg = self.config
        m, p, g = cfg.model, cfg.physics, self.grid
        name = m.initial_condition
        family = IC_FAMILY.get(name)
        if family is None:
            raise ValueError(
                f"unknown initial_condition {name!r}; valid: {sorted(IC_FAMILY)}"
            )
        allowed = {"auto", family}
        if family == "shallow_water":
            allowed.add("shallow_water_cov")
        if m.name not in allowed:
            raise ValueError(
                f"model.name={m.name!r} is incompatible with "
                f"initial_condition={name!r} (which drives {family!r})"
            )
        fields = self._ic_fields(name, family)
        if family == "advection":
            model = TracerAdvection(g, fields["wind"], scheme=m.scheme,
                                    limiter=m.limiter)
            return model, model.initial_state(fields["q"])
        if family == "diffusion":
            model = ThermalDiffusion(g, kappa=p.diffusivity)
            return model, model.initial_state(fields["T"])
        cls = ShallowWater
        if m.name == "shallow_water_cov":
            from .models.shallow_water_cov import CovariantShallowWater

            cls = CovariantShallowWater
        b_ext = fields["b_ext"]
        model = cls(
            g, gravity=p.gravity, omega=p.omega, b_ext=b_ext,
            scheme=m.scheme, limiter=m.limiter, nu4=p.hyperdiffusion,
            backend=m.backend,
        )
        return model, model.initial_state(fields["h"], fields["v"])

    def _build_ensemble_state(self):
        """The batched perturbed-IC state ``{"h": (B, 6, n, n), "u"|"v":
        (c, B, 6, n, n)}``: member 0 unperturbed, members 1..B-1 from
        :func:`~.physics.initial_conditions.perturbed_ensemble` (height
        only, deterministic in ``ensemble.seed``)."""
        cfg = self.config
        ens = cfg.ensemble
        name = cfg.model.initial_condition
        family = IC_FAMILY.get(name)
        if family != "shallow_water":
            raise ValueError(
                f"ensemble.members > 1 supports the shallow-water family "
                f"(tc2/tc5/tc6/galewsky); initial_condition={name!r} "
                f"drives {family!r}")
        fields = self._ic_fields(name, family)
        h_b = ics.perturbed_ensemble(self.grid, fields["h"], ens.members,
                                     seed=ens.seed, amplitude=ens.amplitude)
        states = [self.model.initial_state(h_b[i], fields["v"])
                  for i in range(ens.members)]
        vkey = "u" if "u" in states[0] else "v"
        return {"h": torch.stack([s["h"] for s in states]),
                vkey: torch.stack([s[vkey] for s in states], dim=1)}

    def _ic_fields(self, name: str, family: str):
        """The extended IC fields of one IC family."""
        cfg = self.config
        m, p, g = cfg.model, cfg.physics, self.grid
        if family == "advection":
            u0 = 2 * math.pi * g.radius / (12 * 86400.0)
            return {"wind": ics.solid_body_wind(g, u0, alpha_rot=m.ic_angle),
                    "q": ics.cosine_bell(g)}
        if family == "diffusion":
            return {"T": ics.checkerboard(g)}
        b_ext = None
        if name == "tc2":
            h, v = ics.williamson_tc2(g, p.gravity, p.omega,
                                      alpha_rot=m.ic_angle)
        elif name == "tc5":
            h, v, b_ext = ics.williamson_tc5(g, p.gravity, p.omega)
        elif name == "tc6":
            h, v = ics.williamson_tc6(g, p.gravity, p.omega)
        else:
            h, v = ics.galewsky(g, p.gravity, p.omega)
        return {"h": h, "v": v, "b_ext": b_ext}

    # ---------------------------------------------------------------- running
    def _maybe_resume(self):
        step = self.checkpoints.latest_step()
        if step is None:
            return
        # Host-side restore: inspect (and possibly regrid) before the
        # state goes to the device.
        from .io.regrid import infer_resolution, regrid_state

        state, t = self.checkpoints.restore_host(step)
        if any(k.endswith("__ttA") for k in state):
            raise ValueError(
                "checkpoint/run numerics mismatch: the checkpoint is "
                "factored (TT) but the run is dense, and the port has no "
                "TT tier (ROADMAP queue A item 8 (A11)); point "
                "io.checkpoint_path elsewhere")
        n_new = self.config.grid.n
        if self.members > 1:
            # The checkpoint holds the member-batched arrays: checked
            # against this run and placed as they are (no regrid).
            hb = np.asarray(state["h"]) if "h" in state else None
            if hb is None or hb.ndim != 4:
                raise ValueError(
                    "ensemble.members > 1 but the checkpoint state is "
                    "not member-batched — it was written by an "
                    "unbatched run; point io.checkpoint_path elsewhere")
            if hb.shape[0] != self.members:
                raise ValueError(
                    f"checkpoint has {hb.shape[0]} ensemble members but "
                    f"the run configures {self.members}; set "
                    f"ensemble.members: {hb.shape[0]} (per-member resume: "
                    "CheckpointManager.restore_member)")
            if hb.shape[-1] != n_new:
                raise ValueError(
                    f"ensemble checkpoint is C{hb.shape[-1]} but the run "
                    f"is C{n_new}: cross-resolution resume is "
                    "unbatched-dense-only")
            self.state = {k: torch.from_numpy(np.array(v, order="C")).to(
                self.device) for k, v in state.items()}
            self.t = t
            self.step_count = step
            log.info("resumed %d-member ensemble state from checkpoint "
                     "step %d (t=%.0f s)", self.members, step, self.t)
            return
        n_ckpt = infer_resolution(state)   # raises clearly on ambiguity
        if n_ckpt != n_new:
            log.info("resuming across resolutions: checkpoint C%d -> "
                     "run C%d (conservative regrid)", n_ckpt, n_new)
            state = regrid_state(state, n_new, dtype=self.grid.dtype)
        self.state = {k: torch.from_numpy(np.array(v, order="C")).to(
            self.device) for k, v in state.items()}
        self.t = t
        self.step_count = step
        log.info("resumed from checkpoint step %d (t=%.0f s)", step, self.t)

    def _build_segment_fn(self, k: int):
        """The ``k``-step segment.

        Without telemetry: ``fn(y, t) -> (y, t)``.  With
        ``observability.interval > 0`` and at least one sample inside the
        segment, the loop is :func:`~.stepping.integrate_with_metrics`
        (the same state operations in the same order, one ``+ dt`` per
        call as the JAX package's instrumented loop), with signature
        ``fn(y, t, step0) -> (y, t, buf)`` and an ``obs_samples``
        attribute, the buffer's column count."""
        dt = self.config.time.dt
        active = (self._fused_step if self._fused_step is not None
                  else self._step)
        # A blocked stepper advances steps_per_call steps per call.
        spc = getattr(active, "steps_per_call", 1)
        if k % spc:
            raise ValueError(
                f"segment of {k} steps is not a multiple of "
                f"parallelization.temporal_block={spc}; make "
                "io.history_stride/io.checkpoint_stride and the "
                "total step count multiples of temporal_block")
        obs = self._obs
        samples = every = 0
        if obs is not None:
            every = obs.cfg.interval // spc
            samples = (k // spc) // every
        if self._fused_step is not None:
            m, fused, prep = self.model, self._fused_step, self._fused_prep
            post = self._fused_post or (lambda s: s)
            if samples > 0:
                mfn, fault = obs.metric_fn, obs.cfg.fault_step

                def fn(y, t, step0, _n=k // spc, _dt=dt * spc):
                    y_c, t, buf = integrate_with_metrics(
                        fused, prep(y), t, _n, _dt, mfn, every, samples,
                        step0, steps_per_call=spc, fault_step=fault)
                    return post(m.restrict_state(y_c)), t, buf

                fn.obs_samples = samples
                return fn

            def fn(y, t, _k=k // spc, _dt=dt * spc):
                y_c, t = integrate(fused, prep(y), t, _k, _dt)
                return post(m.restrict_state(y_c)), t

            return fn
        setup = self.setup
        if samples > 0:
            step, mfn, fault = self._step, obs.metric_fn, obs.cfg.fault_step
            cut = ((lambda y: shard_state(setup, y)) if setup is not None
                   else (lambda y: y))
            glue = ((lambda y: unshard_state(setup, y)) if setup is not None
                    else (lambda y: y))

            def fn(y, t, step0, _n=k // spc, _dt=dt * spc):
                y_l, t, buf = integrate_with_metrics(
                    step, cut(y), t, _n, _dt, mfn, every, samples, step0,
                    steps_per_call=spc, fault_step=fault)
                return glue(y_l), t, buf

            fn.obs_samples = samples
            return fn
        # unroll=1 (one time add per call), as the JAX package's
        # classic segments.
        if self._classic_run is None:
            self._classic_run = jit_integrate(self._step, dt * spc, unroll=1)
        run = self._classic_run

        if setup is None:
            def fn(y, t, _k=k // spc):
                return run(y, t, _k)
        else:
            def fn(y, t, _k=k // spc):
                y_l, t = run(shard_state(setup, y), t, _k)
                return unshard_state(setup, y_l), t

        return fn

    def _segment_fn(self, k: int) -> Callable:
        fn = self._segment_cache.get(k)
        if fn is None:
            fn = self._build_segment_fn(k)
            self._segment_cache[k] = fn
        return fn

    def _run_segment(self, k: int):
        fn = self._segment_fn(k)
        if getattr(fn, "obs_samples", 0) > 0:
            # An instrumented segment: its metric buffer is fetched with
            # ONE device-to-host copy, which also waits for the segment,
            # so ``wall`` is the segment's wall time.
            step0, t0 = self.step_count, self.t
            wall0 = time.perf_counter()
            self.state, t, buf = fn(self.state, self.t, step0)
            host = obs_metrics.fetch_buffer(buf)
            wall = time.perf_counter() - wall0
            self.t = float(t)
            self.step_count += k
            self._ingest_telemetry(host, step0, t0, k, wall,
                                   self.step_count, self.t)
            return
        self.state, t = fn(self.state, self.t)
        self.t = float(t)
        self.step_count += k

    def _ingest_telemetry(self, host, step0: int, t0: float, k: int,
                          wall: float, step_end: int, t_end: float,
                          emit: Optional[Callable] = None):
        """One fetched ``(k_metrics, samples)`` buffer -> a ``segment``
        record and the guard check.  Sample j is global step ``step0 +
        (j+1) * interval``.  The record goes first, so a guard's raise
        leaves it on disk; guard events are emitted even when the policy
        raises.  ``emit`` overrides the destination (the async pipeline
        routes records through its writer, FIFO with the history and
        checkpoint tasks)."""
        obs = self._obs
        if emit is None and obs.sink is not None:
            emit = obs.sink.write
        interval = obs.cfg.interval
        names = obs.ms.names
        samples = host.shape[1]
        steps = step0 + interval * np.arange(1, samples + 1)
        dt = self.config.time.dt
        ts = t0 + interval * dt * np.arange(1, samples + 1)
        drift = {}
        for i, n in enumerate(names):
            if n in obs_metrics.CONSERVED:
                v0 = float(obs.ref[i])
                d = float(host[i, -1]) - v0
                drift[n] = d / abs(v0) if v0 else d
        if emit is not None:
            rate = k / wall if wall > 0 else float("inf")
            chips = (self.config.parallelization.num_devices
                     if self.setup is not None else 1)
            host_wait, self._host_wait = self._host_wait, 0.0
            emit({
                "kind": "segment",
                "step": step_end, "t": t_end, "steps": k,
                "wall_s": wall, "steps_per_sec": rate,
                "sim_days_per_sec_per_chip":
                    rate * dt / 86400.0 / chips,
                "host_wait_s": host_wait,
                "metrics": {n: float(host[i, -1])
                            for i, n in enumerate(names)},
                "drift": drift,
                "samples": {"step": steps.tolist(),
                            **{n: host[i].tolist()
                               for i, n in enumerate(names)}},
            })
        if obs.monitor is not None:
            n0 = len(obs.monitor.events)
            try:
                obs.monitor.check(steps, ts, host)
            finally:
                if emit is not None:
                    for ev in obs.monitor.events[n0:]:
                        emit(ev)

    def _emit(self):
        if self.history is not None:
            self.history.append(self.state, self.t)
        # The log lines cost a diagnostics pass and a host transfer:
        # only pay it when they are shown.
        if log.isEnabledFor(logging.INFO):
            for k, v in self.diagnostics().items():
                log.info("step %-8d t=%10.0fs  %s=%.10g",
                         self.step_count, self.t, k, v)

    @staticmethod
    def _fetch_scalars(out) -> Dict[str, float]:
        """One host transfer for a dict of device scalars: stacked on
        the device in their common dtype (an exact widening), then
        copied once."""
        if not out:
            return {}
        vals = [torch.as_tensor(v) for v in out.values()]
        common = functools.reduce(torch.promote_types,
                                  [v.dtype for v in vals])
        host = torch.stack([v.to(common) for v in vals]).cpu().numpy()
        return {k: float(host[i]) for i, k in enumerate(out)}

    def diagnostics(self) -> Dict[str, float]:
        """Scalar invariants of the current state (model-appropriate),
        computed on the device and fetched with one transfer."""
        g, s = self.grid, self.state
        out: Dict[str, Any] = {}
        if "h" in s and self.members > 1:
            # Member 0's invariants and the ensemble's height spread: the
            # per-cell cross-member std (population), at its max.
            p = self.config.physics
            vkey = "u" if "u" in s else "v"
            s0 = {"h": s["h"][0], vkey: s[vkey][:, 0]}
            out["mass_m0"] = diag.total_mass(g, s0["h"])
            b = self.model.b_ext
            b_int = g.interior(b) if b is not None else 0.0
            v = s0["v"] if "v" in s0 else self.model.to_cartesian(s0)
            out["energy_m0"] = diag.total_energy(g, s0["h"], v, p.gravity,
                                                 b_int)
            out["h_spread_max"] = torch.max(torch.std(
                s["h"].to(torch.float32), dim=0, correction=0))
            return self._fetch_scalars(out)
        if "h" in s:
            p = self.config.physics
            out["mass"] = diag.total_mass(g, s["h"])
            b = self.model.b_ext
            b_int = g.interior(b) if b is not None else 0.0
            # Covariant models carry "u"; energy wants the Cartesian vector.
            v = s["v"] if "v" in s else self.model.to_cartesian(s)
            out["energy"] = diag.total_energy(g, s["h"], v, p.gravity,
                                              b_int)
        elif "q" in s:
            out["tracer_mass"] = diag.total_mass(g, s["q"])
            out["tracer_max"] = torch.max(s["q"])
        elif "T" in s:
            out["heat"] = diag.total_mass(g, s["T"])
        return self._fetch_scalars(out)

    def total_steps(self) -> int:
        tc = self.config.time
        if tc.nsteps > 0:
            return tc.nsteps
        return int(round(tc.duration_days * 86400.0 / tc.dt))

    def _synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, nsteps: Optional[int] = None):
        """Integrate to ``nsteps`` total (default: the config's duration).

        Returns the final state (``self.state``).  History and
        checkpoints fire on their strides; between strides the state
        stays on the device.  On any exception the flight ring is
        flushed into a crash bundle (with ``observability.flight_dir``)
        before it propagates.
        """
        total = self.total_steps() if nsteps is None else nsteps
        start = self.step_count
        io = self.config.io
        strides = [s for s in (io.history_stride, io.checkpoint_stride)
                   if s > 0]
        seg = math.gcd(*strides) if strides else 0
        wall0 = time.perf_counter()
        if self.step_count == 0 and self.history is not None:
            self._emit()  # record the initial condition
            self.host_wait += time.perf_counter() - wall0
        obs = self._obs
        if (obs is not None and obs.sink is not None
                and not obs.wrote_initial):
            # The step-0 record: the drift columns' anchor, in the file.
            obs.sink.write({
                "kind": "segment", "step": self.step_count, "t": self.t,
                "steps": 0, "wall_s": 0.0, "steps_per_sec": 0.0,
                "sim_days_per_sec_per_chip": 0.0,
                "metrics": {n: float(obs.ref[i])
                            for i, n in enumerate(obs.ms.names)},
                "drift": {n: 0.0 for n in obs.ms.names
                          if n in obs_metrics.CONSERVED},
            })
            obs.wrote_initial = True
        try:
            if io.async_pipeline.enabled:
                self._run_loop_async(total, seg, io)
            else:
                while self.step_count < total:
                    k = (min(seg, total - self.step_count) if seg
                         else total - self.step_count)
                    self._run_segment(k)
                    flight.record("segment", step=self.step_count, k=k)
                    w0 = time.perf_counter()
                    if (io.history_stride
                            and self.step_count % io.history_stride == 0):
                        self._emit()
                    if (self.checkpoints is not None
                            and self.step_count % io.checkpoint_stride == 0):
                        self.checkpoints.save(self.step_count, self.state,
                                              self.t)
                        flight.record("checkpoint", step=self.step_count)
                    waited = time.perf_counter() - w0
                    self.host_wait += waited
                    self._host_wait += waited
        except BaseException as e:
            # HealthError or any other failure: flush the black box
            # before unwinding.
            self._flight_dump(type(e).__name__)
            raise
        self._synchronize()
        wall = time.perf_counter() - wall0
        ran = self.step_count - start
        days = ran * self.config.time.dt / 86400.0
        log.info(
            "ran %d steps (%.2f sim-days) in %.2fs wall -> %.2f sim-days/sec",
            ran, days, wall, days / wall if wall > 0 else float("inf"),
        )
        return self.state

    # --------------------------------------------------------- async pipeline
    def _run_loop_async(self, total: int, seg: int, io):
        """The ``io.async_pipeline`` segment loop.

        Double-buffered: segment k+1 is dispatched with segment k's
        boundary unresolved.  The boundary's device-to-host copies (the
        metric buffer; at a history or checkpoint boundary an on-device
        copy of the state, a buffer of its own) were started on the side
        stream right behind segment k, and only with segment k+1 in
        flight does the host wait for them.  A resolved boundary hands its
        writes to the bounded background writer as one task; at the
        queue bound ``submit`` blocks (the backpressure: host memory stays
        at ``max_pending_segments`` queued + 1 writing + 1 unresolved).
        The time carry stays the segment's own scalar between segments,
        the value the synchronous loop round-trips through ``float``.  On
        any exception the writer is still flushed before it propagates.
        """
        obs = self._obs
        writer = None
        if (self.history is not None or self.checkpoints is not None
                or (obs is not None and obs.sink is not None)):
            writer = self._ensure_writer()
        if self.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        t_carry = self._t_carry = self.t
        self._seg_anchor = time.perf_counter()
        t_host = self.t              # resolved host time (trails one segment)
        pending = None
        raised = False
        try:
            while self.step_count < total:
                k = (min(seg, total - self.step_count) if seg
                     else total - self.step_count)
                fn = self._segment_fn(k)
                samples = getattr(fn, "obs_samples", 0)
                step0 = self.step_count
                buf = None
                if samples > 0:
                    self.state, t_carry, buf = fn(self.state, t_carry, step0)
                else:
                    self.state, t_carry = fn(self.state, t_carry)
                self._t_carry = t_carry
                self.step_count += k
                want_hist = bool(
                    io.history_stride
                    and self.step_count % io.history_stride == 0
                    and self.history is not None)
                want_ckpt = bool(
                    self.checkpoints is not None and io.checkpoint_stride
                    and self.step_count % io.checkpoint_stride == 0)
                snap = None
                if want_hist or want_ckpt:
                    # The boundary's snapshot is a device buffer of its
                    # own, so nothing the next segment writes reaches the
                    # copy in flight.
                    snap = {k_: v.clone() for k_, v in self.state.items()}
                b = {
                    "k": k, "step0": step0, "step_end": self.step_count,
                    "samples": samples, "t": float(t_carry),
                    "buf": (HostFetch(buf, self._copy_stream)
                            if samples > 0 else None),
                    "state": (HostFetch(snap, self._copy_stream)
                              if snap is not None else None),
                    "hist": want_hist, "ckpt": want_ckpt,
                }
                # The double buffer: resolve the previous boundary only
                # now, with this segment in flight (popped first, so that
                # a raise in the resolve cannot resolve it twice).
                prev, pending = pending, None
                if prev is not None:
                    t_host = self._resolve_boundary(prev, t_host, writer)
                pending = b
            prev, pending = pending, None
            if prev is not None:
                t_host = self._resolve_boundary(prev, t_host, writer)
        except BaseException:
            raised = True
            # A pending boundary is computed already: the synchronous
            # loop would have written it before the segment that raised,
            # so land its I/O (never masking the exception in flight).
            if pending is not None:
                try:
                    self._resolve_boundary(pending, t_host, writer)
                except Exception:
                    log.warning("could not land the in-flight boundary "
                                "during exception unwind", exc_info=True)
                pending = None
            raise
        finally:
            self._t_carry = None
            if writer is not None:
                try:
                    writer.flush()
                except Exception:
                    if not raised:
                        raise
                    log.warning("async writer flush failed during "
                                "exception unwind", exc_info=True)
        self.t = float(t_carry)

    def _resolve_boundary(self, b, t_prev: float, writer) -> float:
        """Resolve one dispatched segment's host copies and hand its
        boundary writes to the background writer as ONE task, in the
        synchronous order (segment record, guard events, history append,
        checkpoint save).  Called with the next segment dispatched;
        returns the boundary's host time.  A guard's raise still submits
        the records gathered so far and skips the history and checkpoint
        writes, as the synchronous loop does."""
        t_host = b["t"]
        self.t = t_host
        now = time.perf_counter()
        wall = now - self._seg_anchor
        self._seg_anchor = now
        flight.record("segment", step=b["step_end"], k=b["k"],
                      wall_s=round(wall, 6))
        host_state = (b["state"].resolve() if b["state"] is not None
                      else None)
        tasks = []
        try:
            if b["samples"] > 0:
                host = b["buf"].resolve()
                emit = None
                obs = self._obs
                if obs is not None and obs.sink is not None:
                    sink_write = obs.sink.write

                    def emit(rec):
                        tasks.append((sink_write, (rec,)))
                self._ingest_telemetry(host, b["step0"], t_prev, b["k"],
                                       wall, b["step_end"], t_host,
                                       emit=emit)
            if b["hist"]:
                tasks.append((self.history.append, (host_state, t_host)))
            if b["ckpt"]:
                flight.record("checkpoint", step=b["step_end"])
                tasks.append((self.checkpoints.save,
                              (b["step_end"], host_state, t_host)))
        finally:
            if tasks:
                w0 = time.perf_counter()
                writer.submit(_run_tasks, tasks)
                waited = time.perf_counter() - w0
                self.host_wait += waited
                self._host_wait += waited
        return t_host


def run_from_config(source: Any, nsteps: Optional[int] = None, device=None):
    """One-call entry: build a Simulation from ``source`` and run it."""
    sim = Simulation(source, device=device)
    sim.run(nsteps)
    return sim
