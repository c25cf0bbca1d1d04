"""The performance observatory's serving half: per-plan cost stamps and
live device-memory telemetry (counterpart of :mod:`jaxstream.obs.perf`,
lines 106-450 there).

* **Cost stamps** (:class:`CostStamp`): every serving bucket carries one
  beside its proof stamp.  The *analytic* half (flops and bytes per
  step from :func:`jaxstream_torch.utils.profiling.
  analytic_cov_step_cost`) is pure arithmetic; the *measured* half
  (:func:`measure_cost`, under ``serve.cost_stamps``) is what the port
  can observe: PyTorch runs eagerly and has no compiler to ask for a
  cost analysis, so the footprint is the peak-allocated delta of one
  probe call on the GPU and the compiler's flop count is the typed
  ``{"unavailable": reason}`` form, which leaves the flop ratio unset.
* **Live memory telemetry** (:class:`MemoryWatcher`): polls the CUDA
  caching allocator (``torch.cuda.memory_stats``) and the device's
  capacity (``torch.cuda.mem_get_info``) at segment boundaries into
  registry gauges (``jaxstream_device_memory_bytes_in_use`` /
  ``_peak_bytes`` / ``_limit_bytes`` per chip) and typed ``memory`` sink
  records.  On the CPU, which keeps no allocator stats, the first poll
  emits one typed-unavailable record and later polls are no-ops.

The bench-history half of the JAX module (``parse_bench_point`` ...
``write_broken_bench_history``) serves the perf ledger, not the server,
and is not ported yet (ROADMAP queue A item 3).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

__all__ = [
    "CostStamp", "build_cost",
    "measure_cost", "plan_analytic_cost", "analytic_cost",
    "roofline_json", "headroom_fraction",
    "MemoryWatcher", "device_memory_record", "device_memory_stats",
]

#: Tiers whose per-step arithmetic the covariant analytic model
#: describes.
_ANALYTIC_TIERS = ("fused", "classic", "face", "face_block", "gspmd",
                   "cartesian_shard")

#: Why a port stamp has no compiler cost analysis.
_NO_COMPILER = ("PyTorch runs eagerly: no compiler cost analysis to "
                "read (the JAX package reads XLA's)")


@dataclasses.dataclass
class CostStamp:
    """One built stepper's cost accounting (the JAX stamp's fields).

    ``analytic`` is per STEP (one batched step advances all members);
    ``xla`` is the compiler's count in the JAX package and the typed
    ``{"unavailable": reason}`` form here; ``memory`` the footprint
    dict or ``{"unavailable": reason}``; ``compile_seconds`` the
    bucket's build and first run.
    """
    plan_key: Optional[str] = None
    analytic: Optional[dict] = None      # per-step {"flops","bytes","ai"}
    xla: Optional[dict] = None           # {"unavailable": reason} here
    memory: dict = dataclasses.field(
        default_factory=lambda: {"unavailable": "not measured"})
    compile_seconds: Optional[float] = None
    flops_ratio: Optional[float] = None
    bytes_ratio: Optional[float] = None
    in_band: Optional[bool] = None       # None = not checkable
    xla_visible: bool = True             # False: kernel-backed plans

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self):
        mem = (f"{self.memory.get('total_bytes', 0)}B"
               if "total_bytes" in self.memory
               else self.memory.get("unavailable", "?"))
        ratio = ("-" if self.flops_ratio is None
                 else f"{self.flops_ratio:.2f}")
        cs = ("-" if self.compile_seconds is None
              else f"{self.compile_seconds:.2f}s")
        return (f"cost[{self.plan_key or '?'}] mem={mem} "
                f"flops_ratio={ratio} compile={cs}")


def plan_analytic_cost(plan) -> Optional[dict]:
    """Per-step analytic cost of one (duck-typed) capability plan, as the
    JAX package computes it; None for tiers the covariant stencil model
    does not describe."""
    tier = getattr(plan, "tier", None)
    n = int(getattr(plan, "n", 0) or 0)
    if tier not in _ANALYTIC_TIERS or n <= 0:
        return None
    from ..utils.profiling import analytic_cov_step_cost

    carry = getattr(plan, "carry", "f32")
    nu4 = None
    if getattr(plan, "nu4", False):
        mode = getattr(plan, "nu4_mode", "split")
        nu4 = mode if mode in ("split", "refused") else "split"
    precision = ("bf16" if getattr(plan, "stage", "f32") == "bf16"
                 else None)
    c = analytic_cov_step_cost(
        n, ensemble=max(1, int(getattr(plan, "ensemble", 1) or 1)),
        carry_bytes=(2 if carry in ("bf16", "mixed16") else None),
        nu4=nu4, precision=precision)
    scale = 1.4 if not getattr(plan, "covariant", True) else 1.0
    out = {
        "flops": c["flops"] * scale,
        "bytes": c["bytes"] * scale,
        "ai": c["ai"],
        "basis": ("analytic_cov_step_cost"
                  + ("_x1.4_cartesian" if scale != 1.0 else "")),
    }
    if c.get("bf16_flop_fraction"):
        out["bf16_flop_fraction"] = c["bf16_flop_fraction"]
    return out


def build_cost(plan, plan_key: Optional[str] = None) -> CostStamp:
    """The analytic-only cost stamp every built stepper carries."""
    backend = str(getattr(plan, "backend", "jnp"))
    return CostStamp(
        plan_key=plan_key,
        analytic=plan_analytic_cost(plan),
        xla_visible=not backend.startswith("pallas"))


def measure_cost(fn, *args, plan_key: Optional[str] = None,
                 analytic: Optional[dict] = None, steps: int = 1,
                 xla_visible: bool = True,
                 stamp: Optional[CostStamp] = None,
                 device=None, **kwargs) -> CostStamp:
    """Run ``fn(*args, **kwargs)`` once and stamp what the port can see.

    On a CUDA ``device``: the allocator's peak is reset, the call runs
    and is synchronised, and ``memory`` records the peak-allocated delta
    over what was allocated before the call (``total_bytes``, the
    footprint the headroom fraction is taken from).  On the CPU
    ``memory`` is the typed unavailable form.  ``xla`` is always the
    typed unavailable form (no compiler cost analysis), so
    ``flops_ratio``, ``bytes_ratio`` and ``in_band`` stay None.
    ``steps`` is recorded as the JAX stamp records it.
    """
    out = stamp if stamp is not None else CostStamp(plan_key=plan_key)
    if plan_key is not None:
        out.plan_key = plan_key
    if analytic is not None:
        out.analytic = analytic
    out.xla_visible = bool(xla_visible)
    out.xla = {"unavailable": _NO_COMPILER, "steps": int(steps)}
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        fn(*args, **kwargs)
        out.memory = {"unavailable": (
            "the CPU keeps no allocator statistics; the footprint is "
            "measured on the GPU")}
        return out
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    out.memory = {"total_bytes": int(peak - base),
                  "peak_bytes": int(peak), "base_bytes": int(base),
                  "probe_seconds": round(wall, 6),
                  "basis": "peak allocated delta of one probe call"}
    return out


def analytic_cost(n: int, **kwargs) -> dict:
    """The one analytic cost model, re-exported for the probe CLIs."""
    from ..utils.profiling import analytic_cov_step_cost

    return analytic_cov_step_cost(n, **kwargs)


def roofline_json(steps_per_sec: float, n: int, scale: float = 1.0,
                  bytes_scale: float = 1.0, ensemble: int = 1,
                  carry_bytes: Optional[int] = None,
                  nu4: Optional[str] = None,
                  precision: Optional[str] = None) -> dict:
    """Roofline numbers for one covariant-stepper rate, as JSON, against
    the H100's float32 roof (:data:`~jaxstream_torch.utils.profiling.
    H100_SXM5`).  The JAX form's keys; under ``precision='bf16'`` the
    bf16 share of the flops is reported, and the mixed roof is not (the
    port defines no bf16 roof)."""
    from ..utils.profiling import (H100_SXM5, Roofline,
                                   analytic_cov_step_cost)

    c = analytic_cov_step_cost(n, ensemble=ensemble,
                               carry_bytes=carry_bytes, nu4=nu4,
                               precision=precision)
    r = Roofline(c["flops"] * scale, c["bytes"] * scale * bytes_scale,
                 1.0 / steps_per_sec, H100_SXM5)
    out = {
        "achieved_tflops": round(r.achieved_tflops, 3),
        "pct_of_compute_roof": round(
            100 * r.achieved_tflops / r.roof.peak_tflops, 1),
        "achieved_gbps": round(r.achieved_gbps, 1),
        "pct_of_hbm": round(100 * r.achieved_gbps / r.roof.hbm_gbps, 1),
        "ai": round(r.ai, 3),
    }
    if carry_bytes is not None and carry_bytes != 4:
        out["carry_bytes"] = carry_bytes
    if precision == "bf16":
        out["bf16_flop_fraction"] = round(c["bf16_flop_fraction"], 3)
    return out


# ------------------------------------------------------ memory watcher
def device_memory_stats(device) -> Optional[dict]:
    """The JAX ``memory_stats()`` keys for one torch device: the caching
    allocator's bytes in use and peak, and the device's capacity; None
    for a device that keeps no allocator stats (the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(dev)
    _free, total = torch.cuda.mem_get_info(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                          0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(total)}


def _read_stats(stats: dict, in_use_default: int = 0):
    in_use = int(stats.get("bytes_in_use", in_use_default))
    peak = int(stats.get("peak_bytes_in_use", in_use))
    limit = stats.get("bytes_limit",
                      stats.get("bytes_reservable_limit", 0))
    return in_use, peak, int(limit or 0)


class MemoryWatcher:
    """Per-chip device-memory polling at segment-boundary cadence.

    ``poll()`` reads :func:`device_memory_stats` for every watched device
    and publishes the result three ways: registry gauges
    (``jaxstream_device_memory_bytes_in_use`` / ``_peak_bytes`` /
    ``_limit_bytes``, labeled ``chip``), a typed ``memory`` sink record
    per poll, and ``self.last``.  A backend with no allocator stats (the
    CPU) gets ONE typed-unavailable record at the first poll; later
    polls return None.  ``stats_fn`` is injectable (tests feed fake
    stats).  Off == the watcher is never constructed.
    """

    def __init__(self, devices=None, registry=None,
                 sink_write: Optional[Callable] = None,
                 stats_fn: Optional[Callable] = None):
        if devices is None:
            devices = [torch.device("cuda", torch.cuda.current_device())]
        self.devices = list(devices)
        self.registry = registry
        self._sink_write = sink_write
        self._stats_fn = stats_fn or device_memory_stats
        self.polls = 0
        self.available: Optional[bool] = None   # unknown until polled
        self.last: Optional[dict] = None
        self._unavailable_reported = False
        if registry is not None:
            registry.gauge("jaxstream_device_memory_bytes_in_use",
                           "per-chip device memory currently in use")
            registry.gauge("jaxstream_device_memory_peak_bytes",
                           "per-chip peak device memory in use")
            registry.gauge("jaxstream_device_memory_limit_bytes",
                           "per-chip device memory capacity")

    def poll(self) -> Optional[dict]:
        stats = [self._stats_fn(d) for d in self.devices]
        if all(s is None for s in stats):
            self.available = False
            if self._unavailable_reported:
                return None
            self._unavailable_reported = True
            rec = {
                "kind": "memory", "devices": len(self.devices),
                "bytes_in_use": [], "peak_bytes": [], "limit_bytes": [],
                "unavailable": (
                    "no allocator statistics for any watched device — "
                    "the CPU keeps none (the GPU's caching allocator "
                    "does)"),
            }
            self.last = rec
            if self._sink_write is not None:
                self._sink_write(rec)
            return rec
        self.available = True
        self.polls += 1
        in_use, peak, limit = [], [], []
        for s in stats:
            i, p, lim = _read_stats(s or {})
            in_use.append(i)
            peak.append(p)
            limit.append(lim)
        rec = {"kind": "memory", "devices": len(self.devices),
               "bytes_in_use": in_use, "peak_bytes": peak,
               "limit_bytes": limit}
        self.last = rec
        if self.registry is not None:
            g = self.registry.gauge_set
            for j in range(len(self.devices)):
                g("jaxstream_device_memory_bytes_in_use", in_use[j],
                  chip=str(j))
                g("jaxstream_device_memory_peak_bytes", peak[j],
                  chip=str(j))
                g("jaxstream_device_memory_limit_bytes", limit[j],
                  chip=str(j))
        if self._sink_write is not None:
            self._sink_write(rec)
        return rec

    def limit_bytes(self) -> Optional[int]:
        """Smallest per-device capacity seen (None when unknown)."""
        if not self.last:
            return None
        limits = [v for v in self.last.get("limit_bytes", []) if v]
        return min(limits) if limits else None


def device_memory_record(devices=None, stats_fn=None) -> dict:
    """One-shot device-memory snapshot: a throwaway watcher's single
    poll, always returning a record."""
    w = MemoryWatcher(devices=devices, stats_fn=stats_fn)
    rec = w.poll()
    if rec is None:                   # the first poll always reports
        raise RuntimeError("memory watcher's first poll reported nothing")
    return rec


def headroom_fraction(footprint_bytes: Optional[float],
                      limit_bytes: Optional[float]) -> Optional[float]:
    """Advisory per-device headroom: ``1 - footprint/limit`` (None when
    either side is unknown)."""
    if not footprint_bytes or not limit_bytes:
        return None
    return round(1.0 - float(footprint_bytes) / float(limit_bytes), 4)
