"""The continuous-batching ensemble server (counterpart of
:mod:`jaxstream.serve.server`).

One :class:`EnsembleServer` deployment fixes the grid, dt and physics
(the ``grid:``/``time:``/``physics:``/``model:`` sections) and serves
:class:`ScenarioRequest` traffic by packing requests into the member
axis of a batched stepper:

* **Shape-bucketed batching**: batch sizes come from ``serve.buckets``
  (default ``1,4,16``); each bucket's stepper is built and run once at
  its first use (the warm-up) and kept.  PyTorch compiles nothing per
  call, so the zero-recompile claim is a count the port defines:
  :meth:`EnsembleServer.compile_count` is three callables per warm
  bucket (segment, extract, inject, as the JAX package counts its
  executables) plus every CUDA kernel library first opened while the
  server exists.  Warm-up moves it; serving after warm-up must not.
* **Per-member run-length masking**
  (:func:`jaxstream_torch.stepping.integrate_masked`): a member that
  finishes mid-segment is frozen bit for bit at its own final step, and
  its slot is refilled from the queue at the next segment boundary.
  The remaining-step vector goes to the device once per segment, from
  pinned memory without blocking; nothing inside a segment syncs.
* **Slot refill at boundaries**: a finished member is extracted into a
  tensor of its own (its device-to-host copy then runs on a side stream
  behind the next segment) and the incoming request is written in
  place into the same slot of the carry.
* **Which stepper a bucket runs**: grouped servers
  (``serve.group_by_orography: true``) under ``model.backend: pallas``
  with SSPRK3 and no del^4 run ``model.make_fused_step(dt, ensemble=B)``
  (``fused``: B1's kernel for B = 1, B1's member fold for B > 1);
  otherwise grouped servers run the classic stepper over each member
  (``vmap``).  Mixed-orography servers (the default) run the classic
  SSPRK3 over each member with the member's own orography rebound on a
  copy of the model (``vmap_b``; under ``pallas`` each RHS is one launch
  of B4).  A ``fused`` bucket whose kernel fails to build or launch
  raises: unlike the JAX package the port does not fall back to
  ``vmap``, which would hide a broken card.
* **Health-guarded eviction, async results, tracing, the metrics
  registry, the flight recorder**: as the JAX server, with the health
  count and every result fetched through
  :class:`~jaxstream_torch.io.async_pipeline.HostFetch` and finalized on
  the background writer thread.

**Threads.** Only the serving thread launches work on the GPU.  The
writer thread waits on a finished copy's event and reads pinned host
memory; the gateway's HTTP thread touches bytes.  The kernels launch on
the serving thread's current stream; the side stream of the copies is
entered only around the copies.

* **Warm pools** (``serve.warm_pool``, ``compile_cache``, ``speculate``;
  :mod:`.warmpool`): a bucket's kernel libraries and host-built tables
  persist on disk, so that a restarted server builds no table and runs
  no ``nvcc``; the speculative compiler warms the buckets next to the
  active cap on a thread and a CUDA stream of its own.

Not ported yet (ROADMAP queue A): ``serve.placement.mode`` ``member``
and ``panel`` (item 4, A8), which pass the JAX package's rule checks and
are then refused.
"""

from __future__ import annotations

import contextlib
import copy
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import _build
from .._device import resolve_device
from ..config import Config, load_config
from ..geometry.cubed_sphere import build_grid
from ..io.async_pipeline import BackgroundWriter, HostFetch
from ..obs import flight
from ..obs import perf as obs_perf
from ..obs import trace as obs_trace
from ..obs.monitor import HealthMonitor
from ..obs.registry import (HOST_WAIT_BUCKETS_S, LATENCY_BUCKETS_S,
                            WALL_BUCKETS_S, MetricsRegistry)
from ..obs.sink import TelemetrySink, run_manifest
from ..ops.cuda import tables as _tables
from ..physics import initial_conditions as ics
from ..plan import rules as _plan_rules
from ..plan.rules import RULES_VERSION as _PLAN_RULES_VERSION
from ..stepping import SCHEMES, integrate_masked, vmap_ensemble
from ..utils.logging import get_logger
from .placement import PLACEMENT_MODES, BucketPlan, plan_placement
from .queue import (AdmissionRefused, HeadroomRefused, QueueFull,
                    RequestQueue, ServerDraining)
from .request import RequestResult, ScenarioRequest
from . import warmpool as _warmpool

__all__ = ["EnsembleServer", "serve_requests", "SERVE_WRITER_THREAD_NAME"]

log = get_logger(__name__)

#: Thread name of the server's background result writer.
SERVE_WRITER_THREAD_NAME = "jaxstream-serve-writer"

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _refuse(knob: str, item: str):
    raise NotImplementedError(f"{knob} is not ported yet: ROADMAP {item}")


def _member_nonfinite(y, axes):
    """Per-member nonfinite count over the prognostic carry keys,
    ``(B,)`` int32 on the carry's device: the serving loop's health
    stream, fetched at the boundary."""
    total = None
    for k, ax in axes.items():
        a = y[k]
        dims = tuple(i for i in range(a.dim()) if i != ax)
        bad = torch.sum(~torch.isfinite(a), dim=dims, dtype=torch.int32)
        total = bad if total is None else total + bad
    return total


class _Slot:
    """One member slot's host bookkeeping."""

    def __init__(self, req: ScenarioRequest):
        self.req = req
        self.done = 0                       # steps executed so far


class _Bucket:
    """One (group, B) runtime: its segment, extract and inject callables.

    ``seg(carry, rem) -> (carry, rem, nonfinite)`` runs one masked
    segment; ``extract(carry, i)`` returns member ``i``'s interior state
    as tensors of their own; ``inject(carry, i, member)`` writes a
    member carry into slot ``i`` in place and returns the carry.
    ``libraries`` counts the kernel libraries first opened while the
    bucket was built and warmed (less those a warm-pool entry gave);
    ``compiles`` is 3 for a bucket built cold, 0 for one its pool entry
    gave; ``warmup`` what its warm-up took (seconds, rung, table and
    ``nvcc`` builds)."""

    def __init__(self, group: str, B: int, impl: str, seg_fn, extract_fn,
                 inject_fn, stack, member_carry, plan: BucketPlan,
                 device: torch.device, proof=None, cost=None):
        self.group = group
        self.B = B
        self.impl = impl
        self.seg = seg_fn
        self.extract = extract_fn
        self.inject = inject_fn
        self.plan = plan
        self.proof = proof
        self.cost = cost
        self.device = device
        self.libraries = 0
        self.compiles = 3
        self.warmup = {}
        self._stack = stack
        self._member_carry = member_carry

    def stack(self, trees):
        """Member trees -> the batch carry."""
        return self._stack(trees)

    def put_member(self, tree):
        """One member tree -> the inject operand."""
        return self._member_carry(tree)

    def put_rem(self, rem):
        """The host ``(B,)`` remaining-step vector on the device: copied
        from a pinned buffer without blocking the host (the caching host
        allocator keeps the buffer until the copy has run)."""
        if self.device.type != "cuda":
            return torch.tensor(np.asarray(rem), dtype=torch.int32)
        host = torch.empty(self.B, dtype=torch.int32, pin_memory=True)
        host.numpy()[:] = rem
        return host.to(self.device, non_blocking=True)


class EnsembleServer:
    """Config -> warm bucketed steppers -> packed request serving.

    ``config`` is the :class:`jaxstream_torch.config.Config` surface
    (grid/time/physics/model and the ``serve:`` block); ``device`` where
    the deployment runs (default: the GPU; ``"cpu"`` only when asked).
    ``on_result`` is called with each :class:`RequestResult` from the
    background writer thread; ``on_segment`` from the SERVING thread at
    every segment boundary with the per-slot progress dicts
    (``id``/``steps_done``/``nsteps``/``t``/``bucket``/``done``),
    strictly before any of that boundary's finalizations are queued.
    Use as a context manager, or call :meth:`close` when done.
    """

    def __init__(self, config=None,
                 on_result: Optional[Callable] = None,
                 on_segment: Optional[Callable] = None,
                 device=None):
        self.config: Config = load_config(config)
        cfg = self.config
        s = cfg.serve
        if cfg.model.numerics != "dense":
            _plan_rules.fail("serve-dense")
        if cfg.model.name != "shallow_water_cov":
            _plan_rules.fail("serve-covariant")
        if (cfg.precision.stage != "f32"
                or cfg.precision.strips not in ("auto", "f32")
                or cfg.precision.carry != "f32"):
            _plan_rules.fail("serve-f32")
        if cfg.parallelization.temporal_block > 1:
            _plan_rules.fail("serve-no-temporal-block")
        if (cfg.parallelization.use_shard_map
                or cfg.parallelization.tiles_per_edge > 1):
            _plan_rules.fail("serve-placement-not-shard-flags")
        if s.guards not in ("off", "evict", "halt"):
            raise ValueError(
                f"serve.guards={s.guards!r}; valid: 'off', 'evict', "
                "'halt'")
        try:
            self.buckets = tuple(sorted(
                {int(b) for b in str(s.buckets).split(",") if b.strip()}))
        except ValueError:
            raise ValueError(
                f"serve.buckets={s.buckets!r} must be a comma-separated "
                "list of positive ints") from None
        if not self.buckets or min(self.buckets) < 1:
            raise ValueError(
                f"serve.buckets={s.buckets!r} must name at least one "
                "positive batch size")
        if s.segment_steps < 1:
            raise ValueError(
                f"serve.segment_steps must be >= 1, got {s.segment_steps}")

        # ------------------------------------------------ placement plan
        self._grouping = bool(s.group_by_orography)
        p = s.placement
        if p.mode not in PLACEMENT_MODES:
            raise ValueError(
                f"serve.placement.mode={p.mode!r}; valid: "
                f"{PLACEMENT_MODES}")
        if p.mode != "off":
            if p.mode == "member" and cfg.model.backend != "jnp":
                _plan_rules.fail("serve-member-jnp")
            if p.mode == "panel":
                if not self._grouping:
                    _plan_rules.fail("serve-panel-grouping")
                if cfg.time.scheme != "ssprk3":
                    _plan_rules.fail("serve-panel-ssprk3")
            _refuse(f"serve.placement.mode: {p.mode} (multi-chip "
                    "serving)", "queue A item 4 (A8)")
        if s.speculate and not s.warm_pool:
            raise ValueError(
                "serve.speculate requires serve.warm_pool — a "
                "speculative compile is only worth its thread when "
                "the executable persists for the next process too")
        if cfg.grid.dtype not in _DTYPES:
            _refuse(f"grid.dtype: {cfg.grid.dtype} (grids are float32 or "
                    "float64)", "queue A item 5")
        self._plans: Dict[int, BucketPlan] = plan_placement(
            self.buckets, 1, "off")

        self.device = resolve_device(device)
        halo = cfg.grid.halo
        if cfg.model.scheme == "ppm":
            halo = max(halo, 3)
        self.grid = build_grid(cfg.grid.n, halo=halo,
                               radius=cfg.grid.radius,
                               dtype=_DTYPES[cfg.grid.dtype],
                               device=self.device,
                               metrics=cfg.grid.metrics)
        self.queue = RequestQueue(s.queue_capacity)
        self.monitor = (HealthMonitor(
            (), policy="warn" if s.guards == "evict" else "halt")
            if s.guards != "off" else None)
        self.on_result = on_result
        self.on_segment = on_segment
        self.results: Dict[str, RequestResult] = {}
        self.stats = {
            "submitted": 0, "refused": 0, "completed": 0, "evicted": 0,
            "batches": 0, "segments": 0, "refills": 0,
            "member_steps": 0, "occupancy_sum": 0.0,
            "utilization_sum": 0.0, "warmup_compiles": 0,
            "host_wait_s": 0.0, "resizes": 0, "last_occupancy": 0.0,
            "boundary_s": 0.0, "table_builds": 0,
        }
        #: The ACTIVE bucket cap: every configured bucket stays warm;
        #: packing uses only buckets <= the cap, so a resize never
        #: builds anything.
        self._active_max = max(self.buckets)
        self._draining = False
        self._models: Dict[str, object] = {}
        self._ics: Dict[str, tuple] = {}
        self._bases: Dict[str, ics.EnsembleBasis] = {}
        self._b_zero = None
        self._b_oro = None
        self._buckets: Dict[tuple, _Bucket] = {}
        self._writer: Optional[BackgroundWriter] = None
        #: The side stream of every device-to-host copy (one per server).
        self._copy_stream = None
        #: Kernel libraries open before this server: compile_count
        #: counts the ones opened since (less those warm-pool entries
        #: gave, ``_pool_libs``).
        self._libs0 = _build.loaded_libraries()
        self._pool_libs = set()
        #: Request-scoped tracing (serve.trace): one RequestTrace per
        #: in-flight admitted request; spans land in the sink at
        #: finalize, or, on sink-less servers only, in ``trace_spans``.
        self._trace_on = bool(s.trace)
        self._traces: Dict[str, obs_trace.RequestTrace] = {}
        self.trace_spans: Dict[str, List[dict]] = {}
        #: The sink has two writers when tracing is on (span records from
        #: the writer thread, serve/guard records from the serving
        #: thread): serialize them.
        self._sink_lock = threading.Lock()
        self.metrics = MetricsRegistry()
        self._init_metrics()
        self._compiles_seen: Dict[tuple, int] = {}
        self._cost_stamps = bool(s.cost_stamps)
        self.memory_watcher = None
        if s.memory_watch:
            self.memory_watcher = obs_perf.MemoryWatcher(
                devices=[self.device], registry=self.metrics,
                sink_write=self._sink_write)
        self._sink = None
        if s.sink:
            manifest_cfg = {
                "serving": True, "grid_n": cfg.grid.n,
                "dt": cfg.time.dt, "buckets": list(self.buckets),
                "segment_steps": s.segment_steps,
                "queue_capacity": s.queue_capacity,
                "guards": s.guards,
                "placement": p.mode,
                "group_by_orography": self._grouping,
                "rules_version": _PLAN_RULES_VERSION,
            }
            # The manifest names the opt-in knobs only when they are on.
            if self._trace_on:
                manifest_cfg["trace"] = True
            if s.memory_watch:
                manifest_cfg["memory_watch"] = True
            if s.cost_stamps:
                manifest_cfg["cost_stamps"] = True
            self._sink = TelemetrySink(s.sink, run_manifest(
                config=manifest_cfg, device=self.device))
        self._fault_fired = False
        self._closed = False
        #: The serving black box: a live crash bundle re-committed at
        #: segment boundaries (throttled) and on every admit, whose
        #: open-request manifest names every admitted-but-unfinished
        #: request.  ``_resident`` mirrors the batch loop's resident ids.
        self._resident: List[str] = []
        self._blackbox: Optional[flight.BundleWriter] = None
        self._flight_last = 0.0
        self._flight_min_interval = 0.25
        self._flight_reason = "live"
        fdir = flight.resolve_flight_dir(cfg)
        if fdir:
            self._blackbox = flight.BundleWriter(fdir)
        #: The warm pool (``serve.warm_pool``), the probe-gated shared
        #: library directory (``serve.compile_cache``) and the
        #: speculative compiler (``serve.speculate``).  The build lock
        #: serializes first-use bucket builds between the serving thread
        #: and the speculator; the deployment digest folds the config
        #: fields the plan key does not carry into every entry key.
        self._deploy_digest = _warmpool.deployment_digest(cfg)
        self._build_lock = threading.RLock()
        self._warmpool: Optional[_warmpool.WarmPool] = None
        self._speculator = None
        #: Entries persist only when ``serve.warm_pool`` names a
        #: directory; a compile-cache-only deployment still gets a pool
        #: (it owns the probe verdict) with load and save off.
        self._pool_entries = bool(s.warm_pool)
        if s.warm_pool or s.compile_cache:
            self._warmpool = _warmpool.WarmPool(
                s.warm_pool or s.compile_cache + ".pool",
                compile_cache=s.compile_cache, sink_write=self._sink_write,
                counter_inc=self.metrics.counter_inc, device=self.device)
            if s.compile_cache:
                self._warmpool.enable_compile_cache()
        if s.speculate:
            self._speculator = _warmpool.SpeculativeCompiler(self)

    # --------------------------------------------------- flight recorder
    def _open_requests(self) -> dict:
        """Queued + in-flight request ids with trace ids — the crash
        bundle's admitted-but-unfinished manifest."""
        return flight.open_request_manifest(self.queue.snapshot(),
                                            list(self._resident))

    def flight_commit(self, force: bool = False,
                      reason: str = "live") -> None:
        """(Re-)commit the live crash bundle.  Throttled unless forced;
        never raises out of the serving loop."""
        bb = self._blackbox
        if bb is None:
            return
        if reason != "live":
            self._flight_reason = reason
        reason = self._flight_reason
        now = time.perf_counter()
        if not force and now - self._flight_last < self._flight_min_interval:
            return
        self._flight_last = now
        try:
            bb.commit(
                reason,
                config={"serving": True, "grid_n": self.config.grid.n,
                        "buckets": list(self.buckets),
                        "segment_steps": self.config.serve.segment_steps},
                proofs=self.bucket_proofs(),
                cost_stamps=self.bucket_costs(),
                device_memory=self.memory_snapshot(),
                open_requests=self._open_requests(),
                extra={"stats": {k: v for k, v in self.stats.items()
                                 if isinstance(v, int)}})
        except Exception as e:     # forensics must never kill serving
            log.warning("flight bundle commit failed (%s: %s)",
                        type(e).__name__, e)

    def flight_dump(self, reason: str) -> None:
        """Force one bundle commit (crash path) and announce it in the
        serve sink as typed ``flight`` + ``crash`` records."""
        if self._blackbox is None:
            return
        self.flight_commit(force=True, reason=reason)
        try:
            events, threads, dropped = flight.RECORDER.dump()
            self._sink_write({"kind": "flight", "events": len(events),
                              "threads": len(threads),
                              "dropped": dropped})
            self._sink_write({"kind": "crash",
                              "bundle": self._blackbox.bundle_id,
                              "path": self._blackbox.path,
                              "reason": reason})
        except Exception as e:
            log.warning("flight dump sink records failed (%s: %s)",
                        type(e).__name__, e)

    def _init_metrics(self):
        """Declare the scrape surface up front (names, types, bucket
        ladders and HELP text are the JAX package's)."""
        m = self.metrics
        m.counter("jaxstream_requests_submitted_total",
                  "requests admitted by submit()")
        m.counter("jaxstream_requests_completed_total",
                  "requests that reached a final state, by status")
        m.counter("jaxstream_requests_shed_total",
                  "typed admission refusals, by shed status")
        m.counter("jaxstream_segments_total",
                  "compiled masked segments executed")
        m.counter("jaxstream_member_steps_total",
                  "member-steps of work advanced")
        m.counter("jaxstream_guard_events_total",
                  "health-guard trips (member evictions)")
        m.counter("jaxstream_compiles_total",
                  "compiled executables per plan key (warmup included; "
                  "a moving counter at steady state is a recompile)")
        m.counter("jaxstream_warmpool_hits_total",
                  "warm-pool entry loads, by rung")
        m.counter("jaxstream_warmpool_misses_total",
                  "warm-pool misses, by reason")
        m.counter("jaxstream_warmpool_saves_total",
                  "warm-pool entries persisted, by rung")
        m.gauge("jaxstream_queue_depth", "request queue depth")
        m.gauge("jaxstream_queue_capacity", "request queue bound")
        m.gauge("jaxstream_active_bucket_cap",
                "largest batch-size bucket packing may use")
        m.gauge("jaxstream_occupancy",
                "slot occupancy of the last segment (active/B)")
        m.gauge("jaxstream_chip_occupancy",
                "per-member-shard slot occupancy of the last segment")
        m.gauge("jaxstream_chip_utilization",
                "per-member-shard advanced-step fraction of the last "
                "segment")
        m.histogram("jaxstream_request_latency_seconds",
                    LATENCY_BUCKETS_S,
                    "submit-to-result end-to-end latency")
        m.histogram("jaxstream_segment_wall_seconds", WALL_BUCKETS_S,
                    "wall seconds per compiled masked segment")
        m.histogram("jaxstream_host_wait_seconds", HOST_WAIT_BUCKETS_S,
                    "residual health-stream d2h block per boundary")
        m.gauge_set("jaxstream_queue_depth", 0)
        m.gauge_set("jaxstream_queue_capacity",
                    self.config.serve.queue_capacity)
        m.gauge_set("jaxstream_active_bucket_cap", self._active_max)

    def _sink_write(self, rec: dict) -> None:
        """Serialized sink write (serving thread + writer thread when
        tracing; the lock is uncontended otherwise)."""
        if self._sink is None:
            return
        with self._sink_lock:
            self._sink.write(rec)

    # ------------------------------------------------------------ lifecycle
    def close(self):
        """Drain the result writer and close the telemetry sink."""
        if self._closed:
            return
        self._closed = True
        if self._speculator is not None:
            sp, self._speculator = self._speculator, None
            sp.close()
        if self._writer is not None:
            w, self._writer = self._writer, None
            w.close()
        if self._sink is not None:
            self._sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Graceful-drain entry: close admissions NOW — every later
        :meth:`submit` raises :class:`ServerDraining` — while admitted
        requests serve to their own final step."""
        self._draining = True
        flight.record("serve.drain", queue_depth=len(self.queue))

    # ------------------------------------------------------- live resize
    @property
    def active_buckets(self) -> tuple:
        """The bucket sizes packing may currently use."""
        active = tuple(b for b in self.buckets if b <= self._active_max)
        return active or (min(self.buckets),)

    def resize(self, max_bucket: int, reason: str = "",
               queue_depth: Optional[int] = None,
               occupancy: Optional[float] = None) -> int:
        """Live-resize the active bucket cap (autoscaling).

        ``max_bucket`` must be a configured bucket, so a resize among
        warm buckets builds nothing.  A scale-up to a bucket whose
        stamped headroom is below ``serve.min_headroom_frac`` raises
        :class:`HeadroomRefused` with a typed record.  Returns the
        previous cap; records an ``autoscale`` sink event."""
        if max_bucket not in self.buckets:
            raise ValueError(
                f"resize target {max_bucket} is not a configured "
                f"bucket {list(self.buckets)} — resizes must land on "
                "warm executables (add the size to serve.buckets)")
        if max_bucket > self._active_max:
            refusal = self.headroom_refusal(max_bucket)
            if refusal is not None:
                self.record_headroom_refusal(refusal,
                                             action="resize_refused")
                raise HeadroomRefused(
                    f"resize target {max_bucket} refused: stamped "
                    f"headroom {refusal['headroom_frac']:.4f} < "
                    f"serve.min_headroom_frac "
                    f"{refusal['min_headroom_frac']:.4f}")
        old, self._active_max = self._active_max, int(max_bucket)
        self.metrics.gauge_set("jaxstream_active_bucket_cap",
                               self._active_max)
        if old != max_bucket:
            self.stats["resizes"] += 1
            log.info("serve: resized active bucket cap %d -> %d%s",
                     old, max_bucket, f" ({reason})" if reason else "")
        flight.record("serve.resize", from_bucket=old,
                      to_bucket=int(max_bucket),
                      reason=reason or "manual")
        if self._sink is not None:
            self._sink_write({
                "kind": "autoscale", "from_bucket": old,
                "to_bucket": int(max_bucket),
                "queue_depth": (len(self.queue) if queue_depth is None
                                else int(queue_depth)),
                "occupancy": round(
                    self.stats["last_occupancy"] if occupancy is None
                    else float(occupancy), 4),
                "reason": reason or "manual",
            })
        if self._speculator is not None:
            self._speculator.nudge(self._active_max)
        return old

    def headroom_refusal(self, B: int) -> Optional[dict]:
        """The typed refusal record for scaling to bucket ``B``, or None
        (= allowed): only a plan with a stamped ``headroom_frac`` below
        ``serve.min_headroom_frac`` is refused."""
        plan = self._plans.get(int(B))
        hf = getattr(plan, "headroom_frac", None)
        if hf is None:
            return None
        mn = self.config.serve.min_headroom_frac
        if hf >= mn:
            return None
        return {"kind": "headroom", "action": "", "bucket": int(B),
                "headroom_frac": round(float(hf), 4),
                "min_headroom_frac": float(mn)}

    def record_headroom_refusal(self, refusal: dict,
                                action: str) -> None:
        """Write one headroom refusal as a typed sink record and a flight
        event."""
        rec = dict(refusal)
        rec["action"] = action
        self._sink_write(rec)
        flight.record("serve.headroom_refused", bucket=rec["bucket"],
                      action=action,
                      headroom_frac=rec["headroom_frac"])

    # ------------------------------------------------------------- building
    def _group(self, req: ScenarioRequest) -> str:
        """The request's batching group: its orography group under
        ``group_by_orography: true``, the single ``'any'`` group
        otherwise."""
        return req.group if self._grouping else "any"

    def _pop(self, group: str) -> Optional[ScenarioRequest]:
        return self.queue.pop(group if self._grouping else None)

    def _ic(self, family: str):
        """Cached base IC fields ``(h_ext, v_ext, b_ext)`` per family."""
        if family not in self._ics:
            p, m, g = self.config.physics, self.config.model, self.grid
            b_ext = None
            if family == "tc2":
                h, v = ics.williamson_tc2(g, p.gravity, p.omega,
                                          alpha_rot=m.ic_angle)
            elif family == "tc5":
                h, v, b_ext = ics.williamson_tc5(g, p.gravity, p.omega)
            elif family == "tc6":
                h, v = ics.williamson_tc6(g, p.gravity, p.omega)
            else:
                h, v = ics.galewsky(g, p.gravity, p.omega)
            self._ics[family] = (h, v, b_ext)
        return self._ics[family]

    def _b_ext(self, family: str):
        """The request's orography field on the mixed-batch path: the
        TC5 mountain for 'tc5', cached zeros for the flat families.  The
        mountain's ghosts are filled through the model's exchange, as a
        baked static's are, so the stencils read identical ghosts."""
        if family == "tc5":
            if self._b_oro is None:
                self._b_oro = self._model("any").exchange(
                    self._ic("tc5")[2])
            return self._b_oro
        if self._b_zero is None:
            self._b_zero = torch.zeros_like(self.grid.sqrtg)
        return self._b_zero

    def _model(self, group: str):
        """Cached model per batching group: 'oro' bakes the TC5
        orography; 'flat' and the mixed-batch 'any' group are
        flat-bottom (the mountain then rides the carry)."""
        if group not in self._models:
            from ..models.shallow_water_cov import CovariantShallowWater

            p, m = self.config.physics, self.config.model
            b_ext = self._ic("tc5")[2] if group == "oro" else None
            self._models[group] = CovariantShallowWater(
                self.grid, gravity=p.gravity, omega=p.omega, b_ext=b_ext,
                scheme=m.scheme, limiter=m.limiter,
                nu4=p.hyperdiffusion, backend=m.backend)
        return self._models[group]

    def _request_state(self, req: ScenarioRequest):
        """A request's interior initial state (deterministic in seed):
        the perturbed height is member 1 of ``perturbed_ensemble(grid, h,
        2, seed, amplitude)``, built from host arrays kept per family
        (:class:`~jaxstream_torch.physics.initial_conditions.
        EnsembleBasis`), so that nothing here reads the device.  ``ic:
        'array'`` states go to the device as they are (byte-preserving)."""
        if req.ic == "array":
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in req.state.items()}
        h, v, _ = self._ic(req.ic)
        if req.seed >= 0 and req.amplitude != 0.0:
            basis = self._bases.get(req.ic)
            if basis is None:
                basis = self._bases[req.ic] = ics.EnsembleBasis(
                    self.grid, h)
            h = basis.member(req.seed, req.amplitude)
        return self._model(self._group(req)).initial_state(h, v)

    def validate_request(self, req: ScenarioRequest) -> None:
        """Admission-time deployment validation (raises ValueError): an
        ``ic: 'array'`` state's shapes and dtype against the grid."""
        if req.ic != "array":
            return
        n = self.grid.n
        dtype = str(np.dtype(self.config.grid.dtype))
        expect = {"h": (6, n, n), "u": (2, 6, n, n)}
        for k, shape in expect.items():
            a = req.state[k]
            if tuple(a.shape) != shape:
                raise ValueError(
                    f"request {req.id!r}: ic 'array' field {k!r} has "
                    f"shape {tuple(a.shape)}; this deployment serves "
                    f"C{n} interior states of shape {shape}")
            if str(a.dtype) != dtype:
                raise ValueError(
                    f"request {req.id!r}: ic 'array' field {k!r} has "
                    f"dtype {a.dtype}; this deployment serves "
                    f"{dtype} states (byte-preserving continuations "
                    f"need the exact dtype)")

    def _member_tree(self, req: ScenarioRequest):
        """The request's member tree: interior state, plus its
        orography on the mixed-batch path."""
        st = self._request_state(req)
        if not self._grouping:
            st = dict(st)
            st["b"] = self._b_ext(req.ic)
        return st

    def _impl_for(self, group: str) -> str:
        """The stepper a bucket runs: ``vmap_b`` on mixed-orography
        servers; ``fused`` on grouped ones where the kernels run the
        configuration (SSPRK3, a pallas backend, no del^4), else
        ``vmap``.  No fallback chain: a ``fused`` bucket that cannot
        build or launch raises."""
        if not self._grouping:
            return "vmap_b"
        cfg = self.config
        if (cfg.time.scheme == "ssprk3"
                and cfg.model.backend.startswith("pallas")
                and cfg.physics.hyperdiffusion == 0.0):
            return "fused"
        return "vmap"

    def _bucket_proof(self, B: int, impl: str):
        """The bucket's normalized plan and its proof stamp."""
        from ..plan.plan import CapabilityPlan
        from ..plan.proof import build_proof
        from ..plan.rules import normalize as plan_normalize

        cfg = self.config
        tier = {"fused": "fused", "vmap": "classic",
                "vmap_b": "classic"}[impl]
        splan = plan_normalize(CapabilityPlan(
            tier=tier, n=cfg.grid.n, halo=self.grid.halo,
            scheme=cfg.time.scheme, ensemble=B,
            donate=cfg.serve.donate, serving=True, placement="off",
            serve_grouping=self._grouping, num_devices=1,
            backend=("pallas" if impl == "fused"
                     else cfg.model.backend),
            covariant=True))
        return splan, build_proof(splan)

    def _build_bucket(self, group: str, B: int, impl: str,
                      planned) -> _Bucket:
        """The bucket's callables; ``planned`` is its
        :meth:`_bucket_proof`."""
        from ..models.shallow_water_cov import (ENSEMBLE_CARRY_AXES,
                                                ENSEMBLE_STATE_AXES)

        cfg = self.config
        model = self._model(group)
        dt, seg = cfg.time.dt, cfg.serve.segment_steps
        plan = self._plans[B]

        if impl == "fused":
            step = model.make_fused_step(dt, ensemble=B)
            axes = dict(ENSEMBLE_CARRY_AXES)
            member_carry = model.compact_state

            def stack(trees):
                return model.ensemble_compact_state(
                    model.stack_ensemble(trees))
        elif impl == "vmap":
            axes = dict(ENSEMBLE_STATE_AXES)
            step = vmap_ensemble(model.make_step(dt, cfg.time.scheme),
                                 axes)
            member_carry = dict
            stack = model.stack_ensemble
        else:                                   # vmap_b
            # The mountain is a per-member carry key read by a per-step
            # rebind of the model's b_ext on a shallow copy: the classic
            # rhs takes b_ext at every call (and so does the RHS kernel's
            # wrapper), so nothing derived from it at construction goes
            # stale.
            axes = {"h": 0, "u": 1, "b": 0}
            scheme_fn = SCHEMES[cfg.time.scheme]

            def one(y, t, _m=model, _dt=dt):
                mm = copy.copy(_m)
                mm.b_ext = y["b"]
                out = scheme_fn(mm.rhs, {"h": y["h"], "u": y["u"]},
                                t, _dt)
                return {"h": out["h"], "u": out["u"], "b": y["b"]}

            step = vmap_ensemble(one, axes)
            member_carry = dict

            def stack(trees):
                return {"h": torch.stack([tr["h"] for tr in trees]),
                        "u": torch.stack([tr["u"] for tr in trees],
                                         dim=1),
                        "b": torch.stack([tr["b"] for tr in trees])}

        # The health stream counts the prognostics only (the orography
        # key is constant per member).
        nf_axes = {k: axes[k] for k in ("h", "u")}

        def seg_fn(y, rem):
            y, _, rem = integrate_masked(step, y, 0.0, rem, seg, dt, axes)
            return y, rem, _member_nonfinite(y, nf_axes)

        def extract_fn(y, i):
            # Tensors of their own: the in-place inject into the same
            # slot must not reach what the side-stream copy reads.
            return {k: y[k].select(axes[k], int(i)).clone()
                    for k in ("h", "u")}

        def inject_fn(y, i, member):
            for k, ax in axes.items():
                y[k].select(ax, int(i)).copy_(member[k])
            return y

        splan, proof = planned
        cost = obs_perf.build_cost(splan, plan_key=proof.plan_key)
        return _Bucket(group, B, impl, seg_fn, extract_fn, inject_fn,
                       stack, member_carry, plan, self.device,
                       proof=proof, cost=cost)

    def _bucket(self, group: str, B: int,
                side_stream: bool = False) -> _Bucket:
        """The warm (group, B) runtime — built and probed on first use
        (the probe run IS the warm-up).  Under ``serve.warm_pool`` its
        tables and kernel libraries come from the pool where an entry
        holds them (no table build, no ``nvcc``), and a cold build saves
        them.  The build lock serializes first-use builds between the
        serving thread and the speculator (``side_stream``: the build
        and its probe run on a CUDA stream of their own)."""
        key = (group, B)
        bk = self._buckets.get(key)
        if bk is not None:
            return bk
        with self._build_lock:
            bk = self._buckets.get(key)
            if bk is not None:      # raced the speculator; it won
                return bk
            impl = self._impl_for(group)
            # The group's model and the shared IC fields are the
            # server's, built once (not tables of any one bucket) and on
            # the caller's current stream: the serving thread reads them
            # on its stream, so they must not come from a side stream.
            self._warm_member_tree(group)
            stream = (torch.cuda.Stream(self.device)
                      if side_stream and self.device.type == "cuda"
                      else None)
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                bk = self._build_warm(group, B, impl, stream)
            self._stamp_bucket(bk)
            self._buckets[key] = bk
            self.stats["warmup_compiles"] = self.compile_count()
            log.info("serve: bucket (%s, B=%d) warm (%s stepper on %s, "
                     "%.3f s, rung %s)", group, B, impl, self.device,
                     bk.warmup["seconds"], bk.warmup["rung"])
            return bk

    def _build_warm(self, group: str, B: int, impl: str, stream):
        """Build bucket (group, B) from its pool entry's tables where there
        is one, probe it, and save a cold build's entry."""
        t0 = time.perf_counter()
        libs0 = _build.loaded_libraries()
        nvcc0 = _build.nvcc_builds
        entry = ekey = ident = None
        planned = self._bucket_proof(B, impl)
        pool = self._warmpool if self._pool_entries else None
        if pool is not None:
            proof = planned[1]
            # The plan key names the strategy, not the bucket or the
            # batching group: fold both in, as the JAX server does.
            ident = f"{proof.plan_key or 'unplanned'}/{group}/B{B}"
            ekey = _warmpool.entry_key(
                ident, proof.schedule_fingerprint, proof.rules_version,
                self._deploy_digest, "bucket",
                environment=pool.environment)
            entry = pool.load(ekey, ident, device=self.device)
        store = _tables.TableStore(entry.tables if entry else None)
        with _tables.using(store), _build.recording() as used:
            bk = self._build_bucket(group, B, impl, planned)
            t_warm = time.perf_counter()
            self._warm_bucket(bk, stream)
        bk.cost.compile_seconds = round(time.perf_counter() - t_warm, 4)
        given = set(entry.libraries) if entry is not None else set()
        opened = _build.loaded_libraries() - libs0
        self._pool_libs |= opened & given
        bk.libraries = len(opened - given)
        bk.compiles = 0 if entry is not None else 3
        rung = entry.rung if entry is not None else None
        if entry is None and pool is not None:
            pool.save(ekey, store.tables, used, plan_key=ident)
        bk.warmup = {"seconds": round(time.perf_counter() - t0, 4),
                     "rung": rung or "cold",
                     "table_builds": store.builds,
                     "nvcc_builds": _build.nvcc_builds - nvcc0}
        self.stats["table_builds"] += store.builds
        return bk

    def _warm_member_tree(self, group: str):
        family = "tc5" if group == "oro" else "tc2"
        st = self._model(group).initial_state(*self._ic(family)[:2])
        if not self._grouping:
            st = dict(st)
            st["b"] = self._b_ext(family)
        return st

    def _synchronize(self, stream=None):
        if stream is not None:
            stream.synchronize()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warm_bucket(self, bk: _Bucket, stream=None):
        """One dummy masked segment + extract + inject: builds (and
        probes) every kernel the bucket will ever launch; on ``stream``
        (the speculator's), waited for there alone."""
        st = self._warm_member_tree(bk.group)
        carry = bk.stack([st] * bk.B)
        rem = np.zeros(bk.B, np.int64)
        rem[0] = self.config.serve.segment_steps
        carry, _, nf = bk.seg(carry, bk.put_rem(rem))
        ex = bk.extract(carry, 0)
        carry = bk.inject(carry, 0, bk.put_member(st))
        self._synchronize(stream)
        del ex, nf, carry

    def _stamp_bucket(self, bk: _Bucket) -> None:
        """Under ``serve.cost_stamps``: the bucket's measured footprint
        (one more probe segment, :func:`~jaxstream_torch.obs.perf.
        measure_cost`), the advisory headroom on its plan when the memory
        watcher knows the capacity, and one typed 'perf' sink record."""
        if not self._cost_stamps:
            return
        seg = self.config.serve.segment_steps
        try:
            st = self._warm_member_tree(bk.group)
            carry = bk.stack([st] * bk.B)
            rem = np.zeros(bk.B, np.int64)
            rem[0] = seg
            obs_perf.measure_cost(
                bk.seg, carry, bk.put_rem(rem),
                analytic=bk.cost.analytic, steps=seg,
                xla_visible=bk.cost.xla_visible, stamp=bk.cost,
                device=self.device)
        except Exception as e:
            bk.cost.memory = {
                "unavailable": f"measure failed "
                               f"({type(e).__name__}: {e})"}
            log.warning("serve: cost stamp for bucket (%s, B=%d) "
                        "unavailable (%s: %s)", bk.group, bk.B,
                        type(e).__name__, e)
        limit = None
        if self.memory_watcher is not None:
            if self.memory_watcher.last is None:
                self.memory_watcher.poll()
            limit = self.memory_watcher.limit_bytes()
        footprint = bk.cost.memory.get("total_bytes")
        if footprint and limit:
            bk.plan = bk.plan.with_headroom(footprint, limit)
            self._plans[bk.B] = bk.plan
        if self._sink is not None:
            self._sink_write({
                "kind": "perf", "plan": bk.cost.plan_key,
                "bucket": bk.B, "group": bk.group,
                "compile_seconds": bk.cost.compile_seconds,
                "memory": bk.cost.memory,
                "analytic": bk.cost.analytic, "xla": bk.cost.xla,
                "flops_ratio": bk.cost.flops_ratio,
                "bytes_ratio": bk.cost.bytes_ratio,
                "in_band": bk.cost.in_band,
                "headroom_frac": bk.plan.headroom_frac,
            })

    def warmup(self, groups=("flat",), buckets=None):
        """Build and probe the bucket set so that the first real traffic
        finds warm buckets.  ``groups``: 'flat' and/or 'oro' (every name
        maps to the single packed group on the mixed-orography
        default).  Returns :meth:`compile_count`."""
        for g in groups:
            if g not in ("flat", "oro", "any"):
                raise ValueError(f"unknown batching group {g!r}")
            if not self._grouping:
                g = "any"
            for B in (buckets or self.buckets):
                self._bucket(g, B)
        self._observe_perf()
        return self.compile_count()

    def compile_count(self) -> int:
        """What the server has built: three callables per bucket built
        cold (segment, extract, inject — the JAX package's three
        executables; a warm-pool hit builds none) plus every kernel
        library first opened while this server exists, less those its
        pool entries gave.  Serving after warm-up must leave it
        unchanged; a restart from a full pool makes it 0."""
        return (sum(bk.compiles for bk in list(self._buckets.values()))
                + len(_build.loaded_libraries() - self._libs0
                      - self._pool_libs))

    def bucket_warmups(self) -> Dict[str, dict]:
        """Per warm bucket: its warm-up's wall seconds, the pool rung it
        came from (``cold`` for a build), and its table and ``nvcc``
        builds."""
        return {f"{g}/B{B}": dict(bk.warmup)
                for (g, B), bk in sorted(self._buckets.items())}

    def warm_groups(self) -> tuple:
        """Batching groups the speculative compiler warms: those that
        already have buckets, else the deployment's default group."""
        groups = {g for (g, _B) in list(self._buckets)}
        if not groups:
            groups = {"any" if not self._grouping else "flat"}
        return tuple(sorted(groups))

    def warmpool_summary(self) -> Optional[dict]:
        """The warm pool's ``/v1/stats`` surface (None = pool off):
        counters, per-rung hits, probe verdicts, and what the
        speculative compiler built and skipped."""
        if self._warmpool is None:
            return None
        out = self._warmpool.summary()
        if self._speculator is not None:
            out["speculative_built"] = [
                list(t) for t in self._speculator.built]
            out["speculative_skipped"] = len(self._speculator.skipped)
        return out

    def placement_summary(self) -> Optional[dict]:
        """The resolved per-bucket placement: None, since the port serves
        ``placement.mode: off`` only."""
        return None

    def bucket_proofs(self) -> Dict[str, Optional[dict]]:
        """Per warm bucket: the proof stamp of its masked segment."""
        return {f"{g}/B{B}": (bk.proof.to_json()
                              if bk.proof is not None else None)
                for (g, B), bk in sorted(self._buckets.items())}

    def bucket_costs(self) -> Dict[str, Optional[dict]]:
        """Per warm bucket: its cost stamp, with the plan's advisory
        headroom."""
        out: Dict[str, Optional[dict]] = {}
        for (g, B), bk in sorted(self._buckets.items()):
            if bk.cost is None:
                out[f"{g}/B{B}"] = None
                continue
            d = bk.cost.to_json()
            d["headroom_frac"] = bk.plan.headroom_frac
            out[f"{g}/B{B}"] = d
        return out

    def bucket_impls(self) -> Dict[str, str]:
        """Per warm bucket: the stepper it runs (``fused``, ``vmap`` or
        ``vmap_b``)."""
        return {f"{g}/B{B}": bk.impl
                for (g, B), bk in sorted(self._buckets.items())}

    def memory_snapshot(self) -> Optional[dict]:
        """The memory watcher's latest record (None when
        ``serve.memory_watch`` is off or nothing polled yet)."""
        return (self.memory_watcher.last
                if self.memory_watcher is not None else None)

    # ------------------------------------------------------------ admission
    def refusal_reasons(self) -> List[str]:
        """Why a :meth:`submit` would be refused right now ([] =
        admissible): the one definition admission and the gateway's
        ``/v1/ready`` both read."""
        reasons = []
        if self._draining:
            reasons.append("draining")
        mx = self.config.serve.max_guard_events
        if (mx > 0 and self.monitor is not None
                and len(self.monitor.events) >= mx):
            reasons.append("admission_refused")
        if len(self.queue) >= self.queue.capacity:
            reasons.append("queue_full")
        return reasons

    def submit(self, req: ScenarioRequest, block: bool = False,
               timeout: Optional[float] = None) -> None:
        """Admit one request (raises :class:`QueueFull` at capacity,
        :class:`AdmissionRefused` once ``serve.max_guard_events`` guard
        trips have accumulated, :class:`ServerDraining` after
        :meth:`begin_drain`)."""
        if self._closed:
            raise RuntimeError("EnsembleServer is closed")
        self.validate_request(req)
        reasons = self.refusal_reasons()
        if "draining" in reasons:
            self.stats["refused"] += 1
            raise ServerDraining(
                f"server refused {req.id!r}: draining — admissions are "
                "closed while in-flight requests run to completion")
        if "admission_refused" in reasons:
            self.stats["refused"] += 1
            raise AdmissionRefused(
                f"server refused {req.id!r}: {len(self.monitor.events)} "
                f"guard events >= serve.max_guard_events="
                f"{self.config.serve.max_guard_events} — the "
                "deployment is unhealthy; investigate before admitting "
                "more traffic")
        req.submitted_wall = time.perf_counter()
        if self._trace_on:
            # Registered BEFORE the queue publishes the request: the
            # serving thread may pop it the instant submit returns.
            self._traces[req.id] = obs_trace.RequestTrace(
                req.id, t0=req.submitted_wall)
        try:
            self.queue.submit(req, block=block, timeout=timeout)
        except Exception:
            self._traces.pop(req.id, None)
            raise
        if self._draining and self.queue.remove(req):
            # begin_drain raced the enqueue: take the request back out
            # and refuse it, or the serving loop already owns it.
            self._traces.pop(req.id, None)
            self.stats["refused"] += 1
            raise ServerDraining(
                f"server refused {req.id!r}: draining began during "
                "admission — the request was withdrawn, not stranded")
        self.stats["submitted"] += 1
        self.metrics.counter_inc("jaxstream_requests_submitted_total")
        self.flight_commit(force=True)

    # -------------------------------------------------------------- serving
    def serve(self):
        """Drain the queue: pack -> masked segments -> refill, batch by
        batch, until no requests remain.  Returns ``self.results``."""
        try:
            while True:
                req = self.queue.pop()
                if req is None:
                    break
                self._run_batch(req)
        except BaseException as e:
            self.flight_dump(reason=type(e).__name__)
            raise
        finally:
            if self._writer is not None:
                self._writer.flush()
        return self.results

    def serve_forever(self, stop=None, idle_wait: float = 0.01,
                      tick: Optional[Callable] = None,
                      idle_tick_s: float = 0.25):
        """Network-serving loop: drain batches until ``stop`` (a
        ``threading.Event``) is set, parking ``idle_wait`` seconds
        between empty polls; after :meth:`begin_drain`, exit once the
        queue is empty and every admitted request has finished.
        ``tick(self)`` runs at every segment boundary (the autoscale
        hook) and at most once per ``idle_tick_s`` while idle."""
        last_idle_tick = float("-inf")
        try:
            while stop is None or not stop.is_set():
                req = self.queue.pop()
                if req is None and self._draining:
                    # A submit may have enqueued between the pop above
                    # and the flag read: exit only on an empty queue
                    # seen AFTER the draining flag.
                    req = self.queue.pop()
                    if req is None:
                        break
                if req is None:
                    self.stats["last_occupancy"] = 0.0
                    now = time.monotonic()
                    if now - last_idle_tick >= idle_tick_s:
                        last_idle_tick = now
                        self._tick(tick)
                    time.sleep(idle_wait)
                    continue
                self._run_batch(req, tick=tick)
                last_idle_tick = float("-inf")
                if self._writer is not None:
                    self._writer.flush()
        except BaseException as e:
            self.flight_dump(reason=type(e).__name__)
            raise
        finally:
            if self._writer is not None:
                self._writer.flush()
        return self.results

    def _ensure_writer(self) -> BackgroundWriter:
        if self._writer is None or not self._writer.alive:
            self._writer = BackgroundWriter(
                max_pending=8, name=SERVE_WRITER_THREAD_NAME)
        return self._writer

    def _fetch(self, tree) -> HostFetch:
        """Start a tree's device-to-host copies on the server's side
        stream."""
        if self.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return HostFetch(tree, stream=self._copy_stream)

    def _observe_perf(self) -> None:
        """Segment-boundary observability: the build counter per plan
        key (``jaxstream_compiles_total``; a library opened outside any
        bucket's warm-up counts under ``kernel_libraries``) and, under
        ``serve.memory_watch``, one device-memory poll."""
        attributed = 0
        for key, bk in list(self._buckets.items()):
            cur = bk.compiles + bk.libraries
            attributed += bk.libraries
            prev = self._compiles_seen.get(key, 0)
            if cur > prev:
                self._compiles_seen[key] = cur
                plan = (bk.proof.plan_key if bk.proof is not None
                        else f"{key[0]}/B{key[1]}")
                self.metrics.counter_inc("jaxstream_compiles_total",
                                         cur - prev, plan=plan)
                flight.record("compile", delta=cur - prev, plan=plan)
        extra = (len(_build.loaded_libraries() - self._libs0)
                 - attributed)
        prev = self._compiles_seen.get("kernel_libraries", 0)
        if extra > prev:
            self._compiles_seen["kernel_libraries"] = extra
            self.metrics.counter_inc("jaxstream_compiles_total",
                                     extra - prev,
                                     plan="kernel_libraries")
            flight.record("compile", delta=extra - prev,
                          plan="kernel_libraries")
        if self.memory_watcher is not None:
            rec = self.memory_watcher.poll()
            if rec is not None and rec.get("bytes_in_use"):
                flight.record("memory.watermark",
                              bytes_in_use=max(rec["bytes_in_use"]),
                              peak_bytes=max(rec["peak_bytes"] or [0]))

    def _tick(self, tick) -> None:
        """Boundary observers + the autoscale hook; a policy bug must
        not kill serving."""
        self._observe_perf()
        if tick is None:
            return
        try:
            tick(self)
        except Exception as e:
            log.warning("serve: autoscale tick failed (%s: %s)",
                        type(e).__name__, e)

    def _run_batch(self, first: ScenarioRequest, tick=None):
        """One batch's life: pack up to the best bucket, then segment /
        evict / extract / refill until every slot drains.  A resize by
        ``tick`` away from this batch's cap stops the refill, so the
        batch winds down and ``serve_forever`` re-packs."""
        cfg = self.config
        s, dt = cfg.serve, cfg.time.dt
        group = self._group(first)
        # The resize cap is read ONCE per batch: the packing decision and
        # the wind-down comparison derive from the same read.
        cap0 = self._active_max
        active = (tuple(b for b in self.buckets if b <= cap0)
                  or (min(self.buckets),))
        batch: List[ScenarioRequest] = [first]
        while len(batch) < max(active):
            r = self._pop(group)
            if r is None:
                break
            batch.append(r)
        B = next(b for b in active if b >= len(batch))
        bk = self._bucket(group, B)
        plan = bk.plan
        plan_key = bk.proof.plan_key if bk.proof is not None else None
        self.stats["batches"] += 1

        if self._trace_on:
            t_pack = time.perf_counter()
            for r in batch:
                self._mark(r.id, obs_trace.PACK, t_pack)
        trees = [self._member_tree(r) for r in batch]
        carry = bk.stack(trees + [trees[0]] * (B - len(batch)))
        slots: List[Optional[_Slot]] = (
            [_Slot(r) for r in batch] + [None] * (B - len(batch)))
        rem = np.zeros(B, np.int64)
        rem[:len(batch)] = [r.nsteps for r in batch]
        seg = s.segment_steps
        m_shards = plan.member_shards
        per_shard = B // m_shards
        allow_refill = True

        while any(sl is not None for sl in slots):
            w0 = time.perf_counter()
            active_mask = [sl is not None for sl in slots]
            active_before = sum(active_mask)
            resident = [(i, sl.req.id) for i, sl in enumerate(slots)
                        if sl is not None]
            self._resident = [rid for _, rid in resident]
            carry, _, nf = bk.seg(carry, bk.put_rem(rem))
            # The health stream's copy chases the segment on the side
            # stream while the host does the boundary work that does not
            # depend on it: completion is arithmetic on `rem`, so the
            # incoming requests' states are built now.
            nf_fetch = self._fetch(nf)
            new_rem = np.maximum(rem - seg, 0)
            n_free_pred = sum(
                1 for i, sl in enumerate(slots)
                if sl is not None and new_rem[i] == 0)
            prepped: List[tuple] = []
            for _ in range(n_free_pred if allow_refill else 0):
                r = self._pop(group)
                if r is None:
                    break
                if self._trace_on:
                    self._mark(r.id, obs_trace.PACK)
                prepped.append((r, self._member_tree(r)))
            hw0 = time.perf_counter()
            nf_host = np.asarray(nf_fetch.resolve(),
                                 np.float64).reshape(-1)
            hw1 = time.perf_counter()
            host_wait = hw1 - hw0
            wall = hw1 - w0
            steps_by_slot = rem - new_rem
            member_steps = int(np.sum(steps_by_slot))
            rem = new_rem
            for i, sl in enumerate(slots):
                if sl is not None:
                    sl.done = sl.req.nsteps - int(rem[i])
            if self._trace_on:
                for i, rid in resident:
                    self._mark(rid, obs_trace.SEGMENT, w0, bucket=B,
                               plan=plan_key, chip=0,
                               steps=int(steps_by_slot[i]))
                    self._mark(rid, obs_trace.HOST_WAIT, hw0)
                    self._mark(rid, obs_trace.BOUNDARY, hw1)
            if self.on_segment is not None:
                progress = [
                    {"id": sl.req.id, "steps_done": sl.done,
                     "nsteps": sl.req.nsteps, "t": sl.done * dt,
                     "bucket": B, "done": bool(rem[i] == 0)}
                    for i, sl in enumerate(slots) if sl is not None]
                try:
                    self.on_segment(progress)
                except Exception as e:   # a subscriber bug must not
                    log.warning(         # kill the batch
                        "serve: on_segment hook failed (%s: %s)",
                        type(e).__name__, e)
            # Testing hook: host-side injection into the health STREAM
            # (never the state), mirroring observability.fault_step.
            fi = s.fault_member
            if (fi >= 0 and cfg.observability.fault_step >= 0
                    and not self._fault_fired and fi < B
                    and slots[fi] is not None
                    and slots[fi].done >= cfg.observability.fault_step):
                nf_host[fi] = max(nf_host[fi], 1.0)
                self._fault_fired = True
            completed = evicted = 0
            if self.monitor is not None:
                counts = np.where(
                    [sl is not None for sl in slots], nf_host, 0.0)
                steps = [sl.done if sl is not None else 0 for sl in slots]
                ts = [d * dt for d in steps]
                # 'halt' raises here (HealthError): the popped refills go
                # back to the queue head (admitted traffic is never lost
                # to a guard trip).
                try:
                    events = self.monitor.check_members(steps, ts, counts)
                except BaseException:
                    if prepped:
                        self.queue.requeue(r for r, _ in prepped)
                    raise
                for ev in events:
                    i = ev["member"]
                    self._finish(slots[i], "evicted", None, ev)
                    rem[i] = 0
                    slots[i] = None
                    evicted += 1
                    if self._sink is not None:
                        self._sink_write(ev)
                if events:
                    self.metrics.counter_inc(
                        "jaxstream_guard_events_total", len(events))
            for i, sl in enumerate(slots):
                if sl is not None and rem[i] == 0:
                    fetch = self._fetch(bk.extract(carry, i))
                    self._finish(sl, "ok", fetch)
                    slots[i] = None
                    completed += 1
            refilled = 0
            if allow_refill:
                for i in range(B):
                    if slots[i] is not None:
                        continue
                    if prepped:
                        r, tree = prepped.pop(0)
                    else:
                        r = self._pop(group)
                        if r is None:
                            break
                        if self._trace_on:
                            self._mark(r.id, obs_trace.PACK)
                        tree = self._member_tree(r)
                    carry = bk.inject(carry, i, bk.put_member(tree))
                    rem[i] = r.nsteps
                    slots[i] = _Slot(r)
                    refilled += 1
            # Free slots >= predicted completions, and the refill scans
            # every slot consuming prepped first: a popped request left
            # over would be lost traffic.
            if prepped:
                raise RuntimeError(
                    "serve refill invariant broken: speculatively popped "
                    f"requests left unslotted: "
                    f"{[r.id for r, _ in prepped]}")
            st = self.stats
            st["segments"] += 1
            st["last_occupancy"] = active_before / B
            st["refills"] += refilled
            st["member_steps"] += member_steps
            st["occupancy_sum"] += active_before / B
            st["utilization_sum"] += member_steps / (B * seg)
            st["completed"] += completed
            st["evicted"] += evicted
            st["host_wait_s"] += host_wait
            m = self.metrics
            m.counter_inc("jaxstream_segments_total")
            if member_steps:
                m.counter_inc("jaxstream_member_steps_total",
                              member_steps)
            if completed:
                m.counter_inc("jaxstream_requests_completed_total",
                              completed, status="ok")
            if evicted:
                m.counter_inc("jaxstream_requests_completed_total",
                              evicted, status="evicted")
            m.gauge_set("jaxstream_queue_depth", len(self.queue))
            m.gauge_set("jaxstream_occupancy", active_before / B)
            m.observe("jaxstream_segment_wall_seconds", wall,
                      buckets=WALL_BUCKETS_S)
            m.observe("jaxstream_host_wait_seconds", host_wait,
                      buckets=HOST_WAIT_BUCKETS_S)
            for j in range(m_shards):
                occ_j = (sum(active_mask[j * per_shard:
                                         (j + 1) * per_shard])
                         / per_shard)
                util_j = (float(np.sum(
                    steps_by_slot[j * per_shard:(j + 1) * per_shard]))
                    / (per_shard * seg))
                m.gauge_set("jaxstream_chip_occupancy", occ_j,
                            chip=str(j))
                m.gauge_set("jaxstream_chip_utilization", util_j,
                            chip=str(j))
            if self._sink is not None:
                rec = {
                    "kind": "serve", "bucket": B, "group": group,
                    "plan": plan_key,
                    "proof_verdict": (bk.proof.verdict
                                      if bk.proof is not None
                                      else None),
                    "occupancy": round(active_before / B, 4),
                    "utilization": round(member_steps / (B * seg), 4),
                    "queue_depth": len(self.queue),
                    "wall_s": round(wall, 6),
                    "host_wait_s": round(host_wait, 6),
                    "completed": completed, "evicted": evicted,
                    "refilled": refilled, "member_steps": member_steps,
                }
                if self._trace_on:
                    rec["trace_ids"] = [
                        obs_trace.trace_id_for(rid)
                        for _, rid in resident]
                self._sink_write(rec)
            flight.record("serve.boundary", bucket=B,
                          active=active_before, completed=completed,
                          evicted=evicted, refilled=refilled,
                          queue_depth=len(self.queue))
            self._tick(tick)
            self._resident = [sl.req.id for sl in slots
                              if sl is not None]
            self.flight_commit()
            # The host's boundary work after the health fetch (evict,
            # extract, refill, telemetry): the port's own stat.
            st["boundary_s"] += time.perf_counter() - hw1
            if allow_refill and self._active_max != cap0:
                allow_refill = False
                log.info("serve: active cap resized %d -> %d mid-"
                         "batch; batch (B=%d) winds down without "
                         "refilling", cap0, self._active_max, B)

    def _mark(self, rid: str, name: str, t: Optional[float] = None,
              **attrs) -> None:
        """Add one trace mark for an in-flight request (no-op for
        untraced ids)."""
        tr = self._traces.get(rid)
        if tr is not None:
            tr.mark(name, t, **attrs)

    def _finish(self, slot: _Slot, status: str,
                fetch: Optional[HostFetch], event: Optional[dict] = None):
        """Queue one request's finalization on the background writer:
        the copies (already in flight) resolve there, overlapping the
        next segment."""
        if self._trace_on:
            self._mark(slot.req.id, obs_trace.FINALIZE_WAIT)
        self._ensure_writer().submit(
            self._finalize, slot.req, status, slot.done, fetch, event)

    def _finalize(self, req: ScenarioRequest, status: str, done: int,
                  fetch: Optional[HostFetch], event: Optional[dict]):
        tr = self._traces.pop(req.id, None) if self._trace_on else None
        if tr is not None:
            tr.mark(obs_trace.RESULT_FETCH)
        fields = {}
        if fetch is not None:
            host = fetch.resolve()
            # Copies out of the fetch's pinned buffers: a result may live
            # as long as its caller keeps it, and pinned memory is only
            # held while a copy is in flight, so the host allocator's
            # cache serves the next fetches.
            fields = {k: np.array(host[k]) for k in req.outputs
                      if k in host}
        if tr is not None:
            tr.mark(obs_trace.WRITER_FLUSH)
        t_final = done * self.config.time.dt
        out_dir = self.config.serve.output_dir
        if out_dir and fields:
            from ..io.history import HistoryWriter

            hw = HistoryWriter(
                os.path.join(out_dir, req.id),
                attrs={"request": req.id, "ic": req.ic,
                       "nsteps": req.nsteps, "status": status})
            hw.append(fields, t_final)
        # The result-ready instant: latency_s and the trace root close on
        # the same stamp, so the span tree's leaves sum to the latency.
        t_end = time.perf_counter()
        latency = (t_end - req.submitted_wall
                   if req.submitted_wall is not None else 0.0)
        res = RequestResult(
            id=req.id, ic=req.ic, nsteps=req.nsteps, status=status,
            t_final=t_final, steps_run=done, latency_s=latency,
            fields=fields, guard_event=event)
        if tr is not None:
            spans = tr.finish(status, t_end)
            if self._sink is not None:
                for sp in spans:
                    self._sink_write(sp)
            else:
                self.trace_spans[req.id] = spans
        self.metrics.observe("jaxstream_request_latency_seconds",
                             latency, buckets=LATENCY_BUCKETS_S,
                             status=status)
        self.results[req.id] = res
        if self.on_result is not None:
            self.on_result(res)

    # ------------------------------------------------------------ reporting
    @property
    def occupancy_mean(self) -> float:
        n = self.stats["segments"]
        return self.stats["occupancy_sum"] / n if n else 0.0

    @property
    def utilization_mean(self) -> float:
        n = self.stats["segments"]
        return self.stats["utilization_sum"] / n if n else 0.0

    def latencies(self) -> np.ndarray:
        return np.asarray(sorted(
            r.latency_s for r in self.results.values()))


def serve_requests(config, requests, warm_groups=None, device=None):
    """One-call serving: build a server, admit ``requests`` (serving a
    batch whenever the queue is full), drain, close.  Returns the
    server (results in ``server.results``, counters in
    ``server.stats``)."""
    server = EnsembleServer(config, device=device)
    try:
        if warm_groups:
            server.warmup(groups=warm_groups)
        pending = list(requests)
        while pending:
            while pending:
                try:
                    server.submit(pending[0])
                except QueueFull:
                    break
                pending.pop(0)
            req = server.queue.pop()
            if req is not None:
                server._run_batch(req)
        server.serve()
    finally:
        server.close()
    return server
