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

* **The bench-history ledger** (:func:`parse_bench_point`,
  :func:`load_bench_history`, :func:`check_trajectory`,
  :func:`render_trajectory`, :func:`broken_bench_history`,
  :func:`write_broken_bench_history`; the JAX module's lines 446-733,
  stdlib arithmetic kept as it is): the recorded ``BENCH_r*.json``
  rounds as machine-normalized trajectory points, and the gate of the
  last one against the best comparable history, which
  ``scripts/torch_perf_ledger.py`` drives.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import time
from typing import Callable, List, Optional, Sequence

import torch

__all__ = [
    "CostStamp", "build_cost",
    "measure_cost", "plan_analytic_cost", "analytic_cost",
    "roofline_json", "headroom_fraction",
    "MemoryWatcher", "device_memory_record", "device_memory_stats",
    "DEFAULT_MAX_REGRESSION", "DEFAULT_MAX_FOOTPRINT_GROWTH",
    "parse_bench_point", "load_bench_history", "check_trajectory",
    "render_trajectory", "broken_bench_history",
    "write_broken_bench_history",
]

#: The ledger's default bands: a section more than 10% below the best
#: comparable point, or a footprint grown more than 50%, regresses.
DEFAULT_MAX_REGRESSION = 0.10
DEFAULT_MAX_FOOTPRINT_GROWTH = 0.50

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


# -------------------------------------------------------------- ledger
_HW_RE = re.compile(r"\bon (tpu|gpu|cpu)\b")


def _hardware_class(hardware: str) -> str:
    if hardware in ("tpu", "gpu"):
        return "accelerator"
    if hardware == "cpu":
        return "cpu"
    return "unknown"


def parse_bench_point(obj: dict, label: str = "?") -> dict:
    """One BENCH round -> one machine-normalized trajectory point.

    Accepts the round envelope (``{"n", "cmd", "rc", "tail",
    "parsed"}``) or a bare bench stdout record.  Normalization rules
    (docs/DESIGN.md): the hardware id comes from the record's own
    ``hardware`` field (round 19+) or the warmup log line in the
    envelope tail (historic rounds; ``unknown`` when neither exists);
    smoke records and every non-accelerator point are
    ``reported_only``; section values are sim-days/sec/chip with
    variant entries read from either the round-4 scalar or the
    round-6+ ``{"sim_days_per_sec": ...}`` dict form; zero/suppressed
    entries are dropped (a gate breach is not a trajectory point).
    """
    parsed = obj.get("parsed", obj) if isinstance(obj, dict) else {}
    if not isinstance(parsed, dict):
        parsed = {}
    tail = str(obj.get("tail", "")) if isinstance(obj, dict) else ""
    smoke = bool(parsed.get("smoke"))
    hardware = parsed.get("hardware")
    if not hardware:
        m = _HW_RE.search(tail)
        if m:
            hardware = m.group(1)
        elif not smoke and parsed.get("value"):
            # Historic envelopes (r01-r05) predate the recorded
            # ``hardware`` field, and the envelope's tail keeps only the
            # LAST stderr lines — the warmup "on tpu" line survives in
            # some rounds (r01) and scrolls out in others (r05).
            # Normalization rule: a full (non-smoke) bench whose
            # headline gated green IS the recorded accelerator run —
            # the C384 gates cannot complete on CPU in the round's
            # budget — unless the tail explicitly says otherwise.
            hardware = "tpu"
        else:
            hardware = "unknown"
    hw_class = _hardware_class(hardware)
    point = {
        "label": label,
        "round": obj.get("n") if isinstance(obj, dict) else None,
        "hardware": hardware,
        "hardware_class": hw_class,
        "smoke": smoke,
        "reported_only": smoke or hw_class != "accelerator",
        "sections": {},
        "pct_of_roof": (parsed.get("roofline") or {}).get(
            "pct_of_compute_roof"),
        "footprint_bytes": None,
        "compile_seconds": None,
        "dt60_equivalent": parsed.get("dt60_equivalent"),
    }
    secs = point["sections"]
    value = parsed.get("value")
    if isinstance(value, (int, float)) and value > 0:
        secs["headline"] = float(value)
    for name, v in (parsed.get("variants") or {}).items():
        val = v.get("sim_days_per_sec") if isinstance(v, dict) else v
        if isinstance(val, (int, float)) and val > 0:
            secs[f"variant:{name}"] = float(val)
    ens = parsed.get("ensemble") or {}
    if isinstance(ens, dict):
        for k, v in ens.items():
            if (k.startswith("B") and isinstance(v, dict)
                    and isinstance(v.get("sim_days_per_sec"),
                                   (int, float))
                    and v["sim_days_per_sec"] > 0):
                secs[f"ensemble:{k}"] = float(v["sim_days_per_sec"])
    srv = parsed.get("serving") or {}
    packed = srv.get("packed") if isinstance(srv, dict) else None
    if (isinstance(packed, dict)
            and isinstance(packed.get("agg_sim_days_per_sec_per_chip"),
                           (int, float))):
        secs["serving:packed"] = float(
            packed["agg_sim_days_per_sec_per_chip"])
    # Round 21 (warm pools): the cold_start bench section lands as
    # warm-over-cold SPEEDUP ratios (higher is better, like every
    # other section), so future rounds gate scale-up latency the way
    # throughput is gated today.
    cold = parsed.get("cold_start") or {}
    if isinstance(cold, dict):
        for src, name in (("warm_speedup", "cold_start:warm_speedup"),
                          ("resize_speedup",
                           "cold_start:resize_speedup")):
            val = cold.get(src)
            if isinstance(val, (int, float)) and val > 0:
                secs[name] = float(val)
    perf = parsed.get("perf") or {}
    cost = perf.get("cost") or {}
    mem = cost.get("memory") or {}
    if isinstance(mem.get("total_bytes"), (int, float)):
        point["footprint_bytes"] = int(mem["total_bytes"])
    if isinstance(cost.get("compile_seconds"), (int, float)):
        point["compile_seconds"] = float(cost["compile_seconds"])
    # The stamped stepper rung (cov_fused vs classic): footprints are
    # only comparable within one rung — a Pallas-compile fallback must
    # not be gated against a fused footprint (or vice versa).
    point["rung"] = perf.get("rung")
    return point


def load_bench_history(root: str) -> List[dict]:
    """Every ``BENCH_r*.json`` under ``root``, as trajectory points in
    round order."""
    points = []
    for path in sorted(glob.glob(os.path.join(root, "BENCH_r*.json"))):
        with open(path) as fh:
            obj = json.load(fh)
        points.append(parse_bench_point(
            obj, label=os.path.basename(path).rsplit(".", 1)[0]))
    return points


def check_trajectory(points: Sequence[dict],
                     max_regression: float = DEFAULT_MAX_REGRESSION,
                     max_footprint_growth: float =
                     DEFAULT_MAX_FOOTPRINT_GROWTH) -> dict:
    """Gate the LAST point against the best comparable history.

    Comparable = same section name, same hardware class.  An enforced
    candidate additionally requires the historical point to be
    enforced itself (a smoke window must never set the bar); a
    reported-only candidate (CPU smoke) compares against ANY
    same-class point and produces advisories, never failures —
    ``enforced`` says which mode ran, so a CI consumer can distinguish
    "passed" from "nothing to gate".
    """
    if not points:
        raise ValueError("check_trajectory needs at least one point")
    cand = points[-1]
    same_class = [p for p in points[:-1]
                  if p["hardware_class"] == cand["hardware_class"]]
    enforced = not cand["reported_only"]
    # An ENFORCED candidate only gates against enforced history (a
    # smoke window must never set the bar); a reported-only candidate
    # still gets ADVISORIES against any same-class point — a CPU
    # smoke trend that halves should say so, even if it cannot gate.
    prior = ([p for p in same_class if not p["reported_only"]]
             if enforced else same_class)
    regressions, advisories = [], []
    sink = regressions if enforced else advisories
    compared = 0
    for name, val in sorted(cand["sections"].items()):
        best = max((p["sections"][name] for p in prior
                    if name in p["sections"]), default=None)
        if best is None:
            continue
        compared += 1
        floor = best * (1.0 - max_regression)
        if val < floor:
            sink.append({
                "section": name, "value": round(val, 4),
                "best": round(best, 4),
                "change_pct": round(100.0 * (val / best - 1.0), 1),
                "detail": (
                    f"{name}: {val:.4f} sim-days/sec/chip is "
                    f"{100 * (1 - val / best):.1f}% below the best "
                    f"recorded {cand['hardware_class']} point "
                    f"({best:.4f}) — beyond the "
                    f"{100 * max_regression:.0f}% band"),
            })
    fp = cand.get("footprint_bytes")
    # Footprints only compare within one stamped rung: the classic
    # fallback's executable is a structurally different program from
    # the fused one — gating across the rung flip would fail healthy
    # runs (and mask genuinely grown fused footprints).
    prior_fp = [p["footprint_bytes"] for p in prior
                if p.get("footprint_bytes")
                and p.get("rung") == cand.get("rung")]
    if fp and prior_fp:
        compared += 1
        smallest = min(prior_fp)
        if fp > smallest * (1.0 + max_footprint_growth):
            sink.append({
                "section": "footprint", "value": fp,
                "best": smallest,
                "change_pct": round(100.0 * (fp / smallest - 1.0), 1),
                "detail": (
                    f"footprint: {fp} bytes is "
                    f"{100 * (fp / smallest - 1):.0f}% above the "
                    f"smallest recorded comparable footprint "
                    f"({smallest}) — beyond the "
                    f"{100 * max_footprint_growth:.0f}% band (a "
                    f"silently fatter hot path is a regression)"),
            })
    return {
        "ok": not regressions,
        "enforced": enforced,
        #: A green ENFORCED verdict with compared_sections == 0 is a
        #: VACUOUS pass (no comparable history yet — e.g. the first
        #: accelerator run after a new section lands); CI consumers
        #: must read this count, not just ``ok``.
        "compared_sections": compared,
        "points": len(points),
        "candidate": cand["label"],
        "hardware_class": cand["hardware_class"],
        "max_regression_pct": round(100 * max_regression, 1),
        "max_footprint_growth_pct": round(
            100 * max_footprint_growth, 1),
        "regressions": regressions,
        "advisories": advisories,
    }


def render_trajectory(points: Sequence[dict]) -> str:
    """The human trend table (``scripts/perf_ledger.py`` default)."""
    lines = [f"{'round':<10} {'hw':<8} {'mode':<13} {'headline':>9} "
             f"{'dt60':>7} {'%roof':>6} {'footprint':>12} "
             f"{'compile':>8}  sections"]
    for p in points:
        head = p["sections"].get("headline")
        dt60 = p.get("dt60_equivalent")
        roof = p.get("pct_of_roof")
        fp = p.get("footprint_bytes")
        cs = p.get("compile_seconds")
        def cell(v, width, spec):
            return (format(v, spec) if v is not None
                    else format("-", f">{width}"))

        lines.append(
            f"{p['label']:<10} {p['hardware']:<8} "
            f"{'reported-only' if p['reported_only'] else 'enforced':<13} "
            f"{cell(head, 9, '>9.4f')} {cell(dt60, 7, '>7.4f')} "
            f"{cell(roof, 6, '>6.1f')} {cell(fp, 12, '>12d')} "
            f"{cell(cs, 8, '>8.2f')}  {len(p['sections'])}")
        for name in sorted(p["sections"]):
            if name == "headline":
                continue
            lines.append(f"  {'':<8} {name:<28} "
                         f"{p['sections'][name]:>9.4f}")
    return "\n".join(lines)


# ------------------------------------------------- seeded-broken fixture
def broken_bench_history() -> List[dict]:
    """The ledger's regression corpus (``analysis/fixtures.py``
    pattern of the JAX package): a clean accelerator round followed by a candidate with a
    30% throughput regression AND a silently-grown footprint.  The
    check MUST fail on it — tier-1 asserts the gate cannot lose its
    teeth (``perf_regression`` fixture + ``perf_ledger.py check``)."""
    good = {
        "n": 1, "cmd": "fixture", "rc": 0,
        "tail": "bench: warmup 10 steps (incl. compile) 7.6s on tpu",
        "parsed": {
            "metric": "sim_days_per_sec_per_chip_TC5_C384",
            "value": 3.0, "unit": "sim-days/sec/chip",
            "hardware": "tpu",
            "variants": {"mixed16_carry": 3.19},
            "perf": {"cost": {"compile_seconds": 20.0,
                              "memory": {"total_bytes": 1_000_000_000}}},
        },
    }
    bad = {
        "n": 2, "cmd": "fixture", "rc": 0,
        "tail": "bench: warmup 10 steps (incl. compile) 8.1s on tpu",
        "parsed": {
            "metric": "sim_days_per_sec_per_chip_TC5_C384",
            "value": 2.1, "unit": "sim-days/sec/chip",   # -30%
            "hardware": "tpu",
            "variants": {"mixed16_carry": 3.21},
            "perf": {"cost": {"compile_seconds": 21.0,
                              "memory": {"total_bytes": 1_600_000_000}}},
        },
    }
    return [good, bad]


def write_broken_bench_history(dirpath: str) -> List[str]:
    """Materialize the broken corpus as ``BENCH_r*.json`` files (for
    driving ``scripts/perf_ledger.py check`` end to end)."""
    paths = []
    for obj in broken_bench_history():
        p = os.path.join(dirpath, f"BENCH_r{obj['n']:02d}.json")
        with open(p, "w") as fh:
            json.dump(obj, fh)
        paths.append(p)
    return paths
