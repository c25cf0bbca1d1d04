"""Roofline analysis and steady-state timing.

Counterpart of :mod:`jaxstream.utils.profiling`, for PyTorch on an
NVIDIA GPU:

* :class:`HardwareRoof` and :data:`H100_SXM5`, the one roof the port
  defines: NVIDIA's H100 SXM5 datasheet, 3 350 GB/s of HBM3 and
  67 TFLOP/s float32 outside the tensor cores (the stencil kernels use
  no tensor core).  No TPU figure is carried over;
* :func:`analytic_cov_step_cost`, the hand-counted flops and bytes of one
  fused covariant SSPRK3 step, the JAX package's counts unchanged;
* :class:`Roofline` and :func:`roofline`, a measured time against a roof;
* :func:`median_chain_seconds`, :func:`steady_state_rate` and
  :class:`StepTimer`, which block on the device of the result's first
  CUDA tensor (nothing more for CPU tensors);
* :func:`device_seconds`, the GPU's time for a piece of work replayed
  as a CUDA graph, and :func:`trace`, a ``torch.profiler`` trace.

The JAX package's ``cost_analysis`` asks XLA's cost model for a compiled
program's flops and bytes; PyTorch has no such model, and the port's
work is in hand-written kernels that no cost model sees, so it has no
counterpart: :func:`roofline` takes a ``{"flops", "bytes"}`` cost such
as :func:`analytic_cov_step_cost`'s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import statistics
import time
from typing import Callable, Dict, Sequence

import torch

__all__ = [
    "HardwareRoof", "H100_SXM5", "mixed_vpu_roof", "analytic_cov_step_cost",
    "roofline", "Roofline", "block_until_ready", "StepTimer",
    "median_chain_seconds", "steady_state_rate", "device_seconds", "trace",
]


@dataclasses.dataclass(frozen=True)
class HardwareRoof:
    """Peak memory bandwidth and compute for a roofline chart."""
    name: str
    hbm_gbps: float          # GB/s
    peak_tflops: float       # TFLOP/s at the working precision

    @property
    def ridge(self) -> float:
        """Flops/byte where the machine turns compute-bound."""
        return self.peak_tflops * 1e12 / (self.hbm_gbps * 1e9)


#: NVIDIA H100 SXM5 (80 GB HBM3), from NVIDIA's datasheet: HBM3 bandwidth
#: and the float32 rate of the CUDA cores (not the tensor cores).  A card
#: capped below its 700 W limit runs slower under load.
H100_SXM5 = HardwareRoof("NVIDIA H100 SXM5 f32 (datasheet)", 3350.0, 67.0)


def mixed_vpu_roof(bf16_fraction: float, f32_roof: HardwareRoof,
                   bf16_roof: HardwareRoof) -> HardwareRoof:
    """Effective roof for a kernel running a bf16/f32 op mix.

    Time to issue F flops with fraction ``phi`` at the bf16 rate is
    ``F*((1-phi)/P32 + phi/P16)``: the harmonic blend, not the linear
    one.  ``phi = 0`` returns the f32 roof's peak; ``phi = 1`` the bf16
    roof's.  Both roofs are the caller's: the port defines no bf16 roof.
    """
    if not 0.0 <= bf16_fraction <= 1.0:
        raise ValueError(
            f"bf16_fraction must be in [0, 1], got {bf16_fraction}")
    peak = 1.0 / ((1.0 - bf16_fraction) / f32_roof.peak_tflops
                  + bf16_fraction / bf16_roof.peak_tflops)
    return HardwareRoof(
        f"{f32_roof.name} + {100 * bf16_fraction:.0f}% bf16",
        f32_roof.hbm_gbps, peak)


# Per-cell flop counts of the covariant fused SSPRK3 stage
# (rhs_core_cov + the RK combine), each elementwise add/mul/min/max/abs/
# select/rsqrt one flop: continuity 2 x (17 + the reconstruction's
# count), divergence 9, momentum 44, combine 12; 137 for PLR-MC.  The
# JAX package's derivation (jaxstream/utils/profiling.py:123-171) holds
# unchanged, and so do its bf16 share and its del^4 filter counts.
_RECON_FLOPS = {"none": 6, "minmod": 14, "mc": 19, "vanleer": 16}
_BF16_STAGE_FLOPS = {"none": 2 * (4 + 4), "minmod": 2 * (4 + 11),
                     "mc": 2 * (4 + 15), "vanleer": 2 * (4 + 13)}
_NU4_FILTER_FLOPS = 3 * (2 * 34 + 2)
_NU4_FIELD_PASSES = {"split": 6, "refused": 3}


def analytic_cov_step_cost(n: int, *, limiter: str = "mc",
                           dtype_bytes: int = 4, stages: int = 3,
                           n_faces: int = 6,
                           ensemble: int = 1,
                           carry_bytes: int = None,
                           nu4: str = None,
                           precision: str = None) -> Dict[str, float]:
    """Analytic flops/bytes for ONE fused covariant SSPRK3 step at C``n``.

    The JAX package's model, count for count: per stage each face reads
    its 3-field carry, the 3-field y0 (stages 2-3) and the orography, and
    writes 3 fields (7 + 10 (stages - 1) field passes, the strips folded
    in).  ``ensemble = B`` scales flops and bytes together;
    ``carry_bytes`` (default ``dtype_bytes``) sizes the carry's passes,
    the orography stays at ``dtype_bytes``; ``nu4 = 'split' |
    'refused'`` adds the del^4 filter's 210 flops per cell and 6 or 3
    field passes; ``precision = 'bf16'`` tags the share of flops the
    bf16 stage policy runs in bfloat16.

    Returns ``{"flops", "bytes", "ai", "flops_per_cell_stage",
    "bf16_flop_fraction"}``.
    """
    if ensemble < 1:
        raise ValueError(f"ensemble must be >= 1, got {ensemble}")
    if nu4 not in (None, "split", "refused"):
        raise ValueError(f"nu4 must be None, 'split' or 'refused', "
                         f"got {nu4!r}")
    if precision not in (None, "f32", "bf16"):
        raise ValueError(f"precision must be None, 'f32' or 'bf16', "
                         f"got {precision!r}")
    if carry_bytes is None:
        carry_bytes = dtype_bytes
    recon = _RECON_FLOPS.get(limiter, _RECON_FLOPS["mc"])
    per_cell_stage = 2 * (17 + recon) + 9 + 44 + 12
    cells = n_faces * n * n * ensemble
    flops = float(per_cell_stage * cells * stages)
    field_passes = 7 + 10 * (stages - 1)
    carry_passes = field_passes - stages
    nbytes = float(cells * (carry_passes * carry_bytes
                            + stages * dtype_bytes))
    bf16_flops = 0.0
    if precision == "bf16":
        bf16_flops = float(
            _BF16_STAGE_FLOPS.get(limiter, _BF16_STAGE_FLOPS["mc"])
            * cells * stages)
    if nu4 is not None:
        flops += float(_NU4_FILTER_FLOPS * cells)
        nbytes += float(_NU4_FIELD_PASSES[nu4] * cells * dtype_bytes)
    return {
        "flops": flops,
        "bytes": nbytes,
        "ai": flops / nbytes,
        "flops_per_cell_stage": float(per_cell_stage),
        "bf16_flop_fraction": bf16_flops / flops if flops else 0.0,
    }


@dataclasses.dataclass(frozen=True)
class Roofline:
    """One point on the roofline chart, with the roof it's plotted against."""
    flops: float
    bytes: float
    seconds: float
    roof: HardwareRoof

    @property
    def ai(self) -> float:
        return self.flops / self.bytes if self.bytes else float("inf")

    @property
    def achieved_tflops(self) -> float:
        return self.flops / self.seconds / 1e12

    @property
    def achieved_gbps(self) -> float:
        return self.bytes / self.seconds / 1e9

    @property
    def bound(self) -> str:
        """Chart-side classification: which side of the ridge the AI is on."""
        return "memory" if self.ai < self.roof.ridge else "compute"

    @property
    def binding(self) -> str:
        """Which resource the measured run leans on harder: achieved over
        peak, per resource (the right label when memory traffic and
        arithmetic overlap)."""
        cu = self.achieved_tflops / self.roof.peak_tflops
        mu = self.achieved_gbps / self.roof.hbm_gbps
        return "compute" if cu >= mu else "memory"

    @property
    def roof_tflops(self) -> float:
        """Attainable TFLOP/s at this AI (the roofline itself)."""
        return min(self.roof.peak_tflops, self.ai * self.roof.hbm_gbps * 1e-3)

    @property
    def efficiency(self) -> float:
        """Achieved / attainable at this AI (1.0 = on the roof)."""
        return self.achieved_tflops / self.roof_tflops if self.roof_tflops else 0.0

    def report(self) -> str:
        cu = 100 * self.achieved_tflops / self.roof.peak_tflops
        mu = 100 * self.achieved_gbps / self.roof.hbm_gbps
        return (
            f"roofline [{self.roof.name}]: AI={self.ai:.3f} flops/byte "
            f"(ridge {self.roof.ridge:.1f}); "
            f"achieved {self.achieved_tflops:.2f} TFLOP/s ({cu:.0f}% of "
            f"compute roof), {self.achieved_gbps:.0f} GB/s ({mu:.0f}% of "
            f"HBM) -> {self.binding}-bound; "
            f"attainable at this AI {self.roof_tflops:.2f} TFLOP/s "
            f"({100 * self.efficiency:.0f}%)"
        )


def roofline(cost: Dict[str, float], seconds: float,
             roof: HardwareRoof = H100_SXM5) -> Roofline:
    """Roofline point of one measured execution of work ``cost``
    (``{"flops", "bytes"}``, e.g. :func:`analytic_cov_step_cost`'s)."""
    return Roofline(float(cost["flops"]), float(cost["bytes"]), seconds, roof)


def _first_cuda_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree if tree.is_cuda else None
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for item in items:
        found = _first_cuda_tensor(item)
        if found is not None:
            return found
    return None


def block_until_ready(tree):
    """Wait for the device of ``tree``'s first CUDA tensor (tensors,
    dicts, lists and tuples are walked in order) and return ``tree``.
    Nothing more for CPU tensors, which PyTorch computes eagerly."""
    t = _first_cuda_tensor(tree)
    if t is not None:
        torch.cuda.synchronize(t.device)
    return tree


def median_chain_seconds(fn, args, iters: int, reps: int = 5):
    """Median wall seconds of one blocking ``fn(*args)`` call, / iters.

    ``fn`` must chain ``iters`` dependent repetitions of the measured
    operation (each consuming the previous one's output), so the
    per-iteration figure is the operation's serial latency.  The first
    call (builds, warm-up) is discarded; the median of ``reps`` timed
    calls is returned.
    """
    block_until_ready(fn(*args))
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2] / iters


def steady_state_rate(run, y, k1: int = 3000, k2: int = 15000):
    """Steps/s of ``run(y, k)`` with its fixed cost per call removed.

    ``run`` integrates ``k`` steps from carry ``y`` and returns the new
    carry.  Timing two window sizes and differencing removes the
    per-call intercept: ``rate = (k2 - k1) / (T2 - T1)``.  A pair with
    ``T2 <= T1`` (a disturbed window) is measured again, up to three
    times.

    Returns ``(rate, y_final)``; the caller warms up first.
    """
    def window(y, k):
        t0 = time.perf_counter()
        y = block_until_ready(run(y, k))
        return y, time.perf_counter() - t0

    for attempt in range(3):
        y, t1 = window(y, k1)
        y, t2 = window(y, k2)
        if t2 > t1:
            return (k2 - k1) / (t2 - t1), y
    raise RuntimeError(
        f"steady_state_rate: inconsistent windows (t1={t1:.4f}s for {k1} "
        f"steps, t2={t2:.4f}s for {k2}) after 3 attempts")


class StepTimer:
    """Steady-state step timing: ``out = timer.time(step_fn, state)``.

    Blocks on the result each rep, so each sample is one full round
    trip; the first ``discard`` samples (builds, warm-up) are dropped from
    the stats.
    """

    def __init__(self, discard: int = 1):
        self.discard = discard
        self.samples: list = []

    def time(self, fn: Callable, *args, reps: int = 10, **kwargs):
        out = None
        for _ in range(self.discard + reps):
            t0 = time.perf_counter()
            out = block_until_ready(fn(*args, **kwargs))
            self.samples.append(time.perf_counter() - t0)
        return out

    @property
    def kept(self) -> Sequence[float]:
        return self.samples[self.discard:]

    @staticmethod
    def _percentile(sorted_samples: Sequence[float], q: float) -> float:
        """Nearest-rank (ceil) percentile: the smallest sample >= the
        q-quantile, exact for all n >= 1."""
        return sorted_samples[max(0, math.ceil(q * len(sorted_samples)) - 1)]

    def stats(self) -> Dict[str, float]:
        k = sorted(self.kept)
        if not k:
            return {}
        return {
            "n": len(k),
            "mean_s": statistics.fmean(k),
            "min_s": k[0],
            "p50_s": self._percentile(k, 0.50),
            "p90_s": self._percentile(k, 0.90),
            "p99_s": self._percentile(k, 0.99),
        }

    def sim_days_per_sec(self, dt: float, steps_per_call: int = 1) -> float:
        s = self.stats()
        if not s:
            return 0.0
        return steps_per_call * dt / 86400.0 / s["p50_s"]


def device_seconds(fn: Callable, replays: int = 3):
    """Seconds the GPU takes for the work ``fn()`` enqueues, with no host
    in the way; None on a host without CUDA (``fn`` then runs once), or
    where that work cannot be captured as a CUDA graph (a host sync).

    ``fn`` runs once on a side stream (warm-up), once under CUDA-graph
    capture, and the graph is replayed ``replays`` times between CUDA
    events: its kernels run back to back, as a compiled loop runs them,
    so the figure is the device's time alone.  (Summing
    ``torch.profiler``'s kernel times instead was unreliable on the
    H100 when a process took many short traces: one in eight saw none of
    its kernels, others a share.)  The wrappers count the launches of
    the warm-up and the capture; replays launch nothing from the host.
    """
    if not torch.cuda.is_available():
        fn()
        return None
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError:
        torch.cuda.synchronize()
        return None
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3 / replays


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace(dir):`` record host and GPU activity with
    ``torch.profiler`` and write it to ``dir/trace.json`` (Chrome trace
    format: ``chrome://tracing``, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
