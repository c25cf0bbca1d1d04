"""Drive jaxstream_torch's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Two paths, both at C384, halo 2, float32, PLR + MC, through the port's
entry points:

* Williamson TC5 (flow over a mountain), dt = 75 s, stepped by the
  compact fused SSPRK3 stepper: per step three strip routes (torch ops)
  and three launches of the hand-written CUDA stage kernel
  (``jaxstream_torch/csrc/cov_stage.cu``);
* the Galewsky barotropic-instability jet, dt = 60 s, nu4 = 1e14, stepped
  by the split del^4 stepper: the same three routes and stage launches,
  then a fourth route and one launch of the CUDA filter kernel
  (``jaxstream_torch/csrc/cov_nu4_filter.cu``).

Phases, each fatal on failure:

1. the card, its power limit, and the kernel builds (one nvcc per
   source, all started together; -Xptxas -v);
2. the kernel against its plain PyTorch version at C384, as stage 1
   and as stage 2 (<= 1e-5 of each output's max), and as stage 3 with
   y0 = -2 yc, where the outputs are the scaled tendency g*L alone
   (<= 1e-4 of its max: f32 roundoff of the tendency is ~1e-5);
3. three fused steps against three steps of the port's classic path
   (<= 2e-4 of max, the JAX package's fused-vs-jnp budget);
4. a warm-up and a timed window of integration through the port's
   entry points, gated like ``bench.py`` (finite, 3000 < h < 6500 m,
   mass drift < 1e-3), with the stage launch count checked against
   3 x steps; then kernel, plain-version and router times;
5. a short window traced by ``torch.profiler`` for the device's busy
   share (apart from the timed window, so tracing costs it nothing);
6. the filter kernel against its plain version at C384 on the Galewsky
   state after one step (<= 1e-5 of each output's max), and an increment
   probe: the filter with nu4 scaled until damp*max|lap(lap q)| is
   1e3 x max|q|, whose outputs are the filter term itself (<= 1e-4 of
   its max, the tolerance of ``tests/test_torch_nu4.py``);
7. three split steps against three classic del^4 steps (<= 2e-3 of max,
   the JAX package's own split-vs-classic budget);
8. the Galewsky jet to day 6 (8 640 steps), gated as
   ``bench.py::bench_galewsky`` gates it (finite, 8500 < h < 10800 m,
   mass drift < 1e-3, 5e-5 < max|zeta| north of 0.2 rad < 5e-4,
   max|zeta| south of -0.2 rad < 5e-6), with the filter launches checked
   against the steps and the stage launches against 3 x steps;
9. a timed window of 2 000 Galewsky steps, its breakdown (4 routes,
   3 stage launches, 1 filter launch, the rest), the filter's time
   against its plain version and its bound, and a traced window.

It prints a JSON line of the kernels, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result, without a CUDA device or without the rest of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

STEP_DT = 75.0
N = 384
WARM_STEPS = 20
TIMED_STEPS = 2000
PROFILED_STEPS = 50
# H100 SXM data-sheet peaks: HBM3 bytes/s
# and float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Per cell per stage (jaxstream/utils/profiling.py: 137 for PLR-MC).
FLOPS_PER_CELL = 137
# Per cell of the del^4 filter, counted from its plain version's ops: 22
# per Laplacian per field (two Laplacians, three fields), 2 per field
# for the damp, 31 for the metric terms the kernel shares between them
# (a square root or a division counts as one).
FILTER_FLOPS_PER_CELL = 169
KERNEL_TOL = 1e-5
# The tendency alone is ill-conditioned in float32 (its flux differences
# cancel): two f32 evaluations differ by ~1e-5 of its max.
TENDENCY_TOL = 1e-4
FUSED_VS_CLASSIC_TOL = 2e-4
# Galewsky: bench.py::bench_galewsky's configuration and day-6 run.
GAL_DT = 60.0
GAL_NU4 = 1.0e14
GAL_DAY6_STEPS = 8640
# The filter's increment probe: lap(lap q) in float32 cancels; the plain
# version at f32 against its float64 evaluation measured up to 2.2e-6 of
# the probe's max at C8-C48 on the CPU (tests/test_torch_nu4.py).
PROBE_TOL = 1e-4
PROBE_MARGIN = 1e3
SPLIT_VS_CLASSIC_TOL = 2e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(ref: torch.Tensor, x: torch.Tensor) -> float:
    ref, x = ref.double(), x.double()
    return float((ref - x).abs().max() / (ref.abs().max() + 1e-300))


def event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(args, outs, n: int, flops_per_cell: int) -> tuple:
    """Least time of one launch: bytes (each input read once, each output
    written once) over the memory rate, flops over the f32 rate."""
    moved = sum(t.numel() * t.element_size() for t in list(args) + list(outs))
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops_per_cell * 6 * n * n / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), moved


def device_busy(run, nsteps: int, step_us: float, card: str,
                names: tuple) -> None:
    """Trace ``run()`` (``nsteps`` steps) with ``torch.profiler`` and log
    the device's busy share of an untraced ``step_us`` step, and each
    named kernel's device time per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / nsteps
    if busy <= 0.0:
        log("device busy share: not measured (the profiler saw no device "
            "time)")
        return
    per_kernel = {nm: sum(e.self_device_time_total for e in rows
                          if nm in e.key) / nsteps for nm in names}
    per = ", ".join(f"{nm} {us:.1f}" for nm, us in per_kernel.items())
    kernels = sum(e.count for e in rows) / nsteps
    log(f"device (torch.profiler, {nsteps} traced steps): busy "
        f"{busy:.1f} us/step = {busy / step_us:.1%} of the untraced "
        f"{step_us:.1f} us step (idle {1 - busy / step_us:.1%}); us/step: "
        f"{per}; {kernels:.0f} kernels/step; card {card}")


def galewsky_path(card: str) -> dict:
    """Phases 6-9: the Galewsky jet with the split del^4 filter.  Returns
    the filter kernel's record for the kernels line."""
    from jaxstream_torch.config import (EARTH_GRAVITY, EARTH_OMEGA,
                                        EARTH_RADIUS)
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.ops.fv import vorticity_cov
    from jaxstream_torch.physics.initial_conditions import galewsky
    from jaxstream_torch.stepping import integrate

    Stage, Filter = swe_cov.CovStageCompact, swe_cov.CovNu4Filter
    t0 = time.perf_counter()
    grid = build_grid(N, halo=2, radius=EARTH_RADIUS, dtype=torch.float32)
    h_ext, v_ext = galewsky(grid, EARTH_GRAVITY, EARTH_OMEGA)
    model = CovariantShallowWater(grid, gravity=EARTH_GRAVITY,
                                  omega=EARTH_OMEGA, nu4=GAL_NU4)
    step = model.make_fused_step(GAL_DT)
    s0 = model.initial_state(h_ext, v_ext)
    y0 = model.compact_state(s0)
    torch.cuda.synchronize()
    log(f"setup: C{N} grid, Galewsky, model (nu4 {GAL_NU4:g}), split "
        f"stepper in {time.perf_counter() - t0:.2f} s on {grid.device}")

    # ---- 6. filter kernel vs plain, on the state after one step ----------
    route, filt = step.route, step.filter
    y1 = step(y0, 0.0)
    args = (y1["h"], y1["u"]) + route(y1["strips_sn"], y1["strips_we"])
    # At nu4 = 1e14, dt = 60 the filter moves q by a small share of q, so
    # agreement of the outputs says little of lap(lap q).  The probe
    # scales nu4 until damp*max|l2| is PROBE_MARGIN x max|q| for every
    # field: its outputs are the filter term.
    exact = filt.reference(*[a.double() for a in args])
    q = (args[0], args[1][0], args[1][1])
    incr = [float((a.double() - b).abs().max() / a.abs().max())
            for a, b in zip(q, (exact[0], exact[1][0], exact[1][1]))]
    probe = swe_cov.make_cov_nu4_filter(
        grid, GAL_NU4 * PROBE_MARGIN / min(incr), filt.dt_eff)
    log(f"filter increment at nu4 {GAL_NU4:g}, dt {GAL_DT:g}: max|dq|/max|q| "
        f"h {incr[0]:.3e}, u_a {incr[1]:.3e}, u_b {incr[2]:.3e}; probe nu4 "
        f"{probe.nu4:.4e}")
    names = ("h", "u", "strips_sn", "strips_we")
    max_abs = 0.0
    for label, f, tol in (("filter", filt, KERNEL_TOL),
                          ("probe (filter term alone)", probe, PROBE_TOL)):
        before = Filter.launches
        out = f(*args)
        torch.cuda.synchronize()
        if Filter.launches != before + 1:
            raise RuntimeError(f"{label} did not count its launch")
        ref = f.reference(*args)
        errs = {nm: rel_err(r, x) for nm, r, x in zip(names, ref, out)}
        max_abs = max([max_abs] + [float((r - x).abs().max())
                                   for r, x in zip(ref, out)])
        finite = all(bool(torch.isfinite(x).all()) for x in out)
        bitwise = all(torch.equal(r, x) for r, x in zip(ref, out))
        line = (f"filter kernel vs plain C{N} {label}: max rel diff "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f" (tol {tol:g}); finite={finite} bitwise={bitwise}"
                + f"; max |h| {float(out[0].abs().max()):.4e}")
        if f is probe:
            f64 = f.reference(*[a.double() for a in args])
            line += "; plain f32 vs f64: " + ", ".join(
                f"{k} {rel_err(r, x):.3e}"
                for k, r, x in zip(names, f64, ref))
        log(line)
        if not finite or max(errs.values()) > tol:
            raise RuntimeError(f"filter kernel disagrees with plain ({label})")

    # ---- 7. split vs classic del^4, 3 steps --------------------------------
    yf, _ = integrate(step, y0, 0.0, 3, GAL_DT)
    yc, _ = integrate(model.make_step(GAL_DT), s0, 0.0, 3, GAL_DT)
    errs = {k: rel_err(yc[k], yf[k]) for k in ("h", "u")}
    log(f"split vs classic del^4 C{N}, 3 steps: max rel diff "
        f"h {errs['h']:.3e}, u {errs['u']:.3e} (tol {SPLIT_VS_CLASSIC_TOL:g})")
    if max(errs.values()) > SPLIT_VS_CLASSIC_TOL:
        raise RuntimeError("split step disagrees with the classic path")
    del yf, yc

    # ---- 8. main path: the jet to day 6, gated as bench_galewsky ----------
    Stage.launches = 0
    Filter.launches = 0
    t0 = time.perf_counter()
    y, t = integrate(step, y0, 0.0, GAL_DAY6_STEPS, GAL_DT)
    torch.cuda.synchronize()
    wall6 = time.perf_counter() - t0
    launches = (Stage.launches, Filter.launches)
    if launches != (3 * GAL_DAY6_STEPS, GAL_DAY6_STEPS):
        raise RuntimeError(f"launches (stage, filter) {launches} != "
                           f"(3 x, 1 x) {GAL_DAY6_STEPS} steps")
    h = y["h"].double()
    area = grid.interior(grid.area).double()
    mass0 = float(torch.sum(area * s0["h"].double()))
    drift = abs(float(torch.sum(area * h)) - mass0) / mass0
    zeta = vorticity_cov(grid, model._fill_u(y["u"])).double()
    lat = grid.interior(grid.lat)
    z_n = float(zeta.abs()[lat > 0.2].max())
    z_s = float(zeta.abs()[lat < -0.2].max())
    finite = bool(torch.isfinite(h).all())
    hmin, hmax = float(h.min()), float(h.max())
    gate = (finite and 8500.0 < hmin and hmax < 10800.0 and drift < 1e-3
            and 5e-5 < z_n < 5e-4 and z_s < 5e-6)
    log(f"gate Galewsky C{N} nu4 (split) day {t / 86400.0:g}: "
        f"finite={finite} h_range=[{hmin:.1f}, {hmax:.1f}] (in (8500, "
        f"10800)) mass_drift={drift:.3e} (<1e-3) max|zeta| N={z_n:.3e} (in "
        f"(5e-5, 5e-4)) S={z_s:.3e} (<5e-6); launches stage {launches[0]} = "
        f"3 x {GAL_DAY6_STEPS}, filter {launches[1]} = {GAL_DAY6_STEPS}; "
        f"{GAL_DAY6_STEPS} steps in {wall6:.2f} s -> "
        f"{'passed' if gate else 'FAILED'}")
    if not gate:
        raise RuntimeError("Galewsky day-6 gate failed")

    # ---- 9. timed window, breakdown, filter times, traced window --------
    t0 = time.perf_counter()
    y, t = integrate(step, y, t, TIMED_STEPS, GAL_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not bool(torch.isfinite(y["h"]).all()):
        raise RuntimeError("Galewsky state not finite after the timed window")
    steps_s = TIMED_STEPS / wall
    step_us = 1e6 / steps_s
    log(f"main path C{N} Galewsky nu4 dt={GAL_DT:g}: {TIMED_STEPS} steps in "
        f"{wall:.3f} s -> {steps_s:.1f} steps/s, {step_us:.1f} us/step, "
        f"{steps_s * GAL_DT / 86400.0:.4f} sim-days/s; card {card}")

    gsn, gwe = route(y["strips_sn"], y["strips_we"])
    fargs = (y["h"], y["u"], gsn, gwe)
    a1 = (y["h"], y["u"], gsn, gwe, model.b_ext)
    a2 = (y["h"], y["u"], y["h"], y["u"], gsn, gwe, model.b_ext)
    st1, st2, st3 = step.stages
    stage_us = 1e3 * sum(event_ms(lambda: st(*a), 200)
                         for st, a in ((st1, a1), (st2, a2), (st3, a2)))
    r_ms = event_ms(lambda: route(y["strips_sn"], y["strips_we"]), 200)
    k_ms = event_ms(lambda: filt(*fargs), 200)
    p_ms = event_ms(lambda: filt.reference(*fargs), 10)
    bound, by, nbytes = bound_ms(fargs, filt(*fargs), N, FILTER_FLOPS_PER_CELL)
    log(f"filter kernel: {k_ms * 1e3:.2f} us/launch, bound "
        f"{bound * 1e3:.2f} us ({by}, {nbytes / 1e6:.2f} MB, "
        f"{FILTER_FLOPS_PER_CELL} flops/cell), {bound / k_ms:.1%} of bound, "
        f"{nbytes / (k_ms * 1e-3) / 1e12:.2f} TB/s; plain {p_ms * 1e3:.1f} "
        f"us; card {card}")
    other = step_us - stage_us - 1e3 * (4 * r_ms + k_ms)
    log(f"Galewsky step {step_us:.1f} us = routers 4 x {r_ms * 1e3:.2f} us + "
        f"stage kernels {stage_us:.1f} us + filter {k_ms * 1e3:.2f} us + "
        f"{other:.1f} us other; card {card}")
    device_busy(lambda: integrate(step, y, t, PROFILED_STEPS, GAL_DT),
                PROFILED_STEPS, step_us, card,
                ("cov_stage_kernel", "cov_nu4_filter_kernel"))
    return {
        "name": "cov_nu4_filter",
        "route": "cuda",
        "source": "jaxstream_torch/csrc/cov_nu4_filter.cu",
        "replaces": "jaxstream/ops/pallas/swe_cov.py:2544",
        "launches": launches[1],
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the GPU", file=sys.stderr)
        return 1

    from jaxstream_torch import _build
    from jaxstream_torch.config import (EARTH_GRAVITY, EARTH_OMEGA,
                                        EARTH_RADIUS)
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.physics.initial_conditions import williamson_tc5
    from jaxstream_torch.stepping import integrate
    from jaxstream_torch.utils.diagnostics import total_mass

    Stage = swe_cov.CovStageCompact

    # ---- 1. card and build ----------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {card}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.KERNELS)) as pool:
        built = list(pool.map(_build.build, _build.KERNELS))
    log(f"build: {len(built)} kernel(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for b in built:
        log(f"build {b.name}: {b.path.name} nvcc {b.seconds:.2f} s")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")

    # ---- the port's main path, through its entry points -----------------
    t0 = time.perf_counter()
    grid = build_grid(N, halo=2, radius=EARTH_RADIUS, dtype=torch.float32)
    h_ext, v_ext, b_ext = williamson_tc5(grid, EARTH_GRAVITY, EARTH_OMEGA)
    model = CovariantShallowWater(grid, gravity=EARTH_GRAVITY,
                                  omega=EARTH_OMEGA, b_ext=b_ext)
    step = model.make_fused_step(STEP_DT)
    s0 = model.initial_state(h_ext, v_ext)
    y0 = model.compact_state(s0)
    torch.cuda.synchronize()
    log(f"setup: C{N} grid, TC5, model, stepper in "
        f"{time.perf_counter() - t0:.2f} s on {grid.device}")

    # ---- 2. kernel vs plain, at the main path's shapes -------------------
    route = step.route
    st1, st2, st3 = step.stages
    gsn, gwe = route(y0["strips_sn"], y0["strips_we"])
    args1 = (s0["h"], s0["u"], gsn, gwe, model.b_ext)
    before = Stage.launches
    k1 = st1(*args1)
    torch.cuda.synchronize()
    if Stage.launches != before + 1:
        raise RuntimeError("stage 1 did not count its launch")
    gsn2, gwe2 = route(k1[2], k1[3])
    args2 = (s0["h"], s0["u"], k1[0], k1[1], gsn2, gwe2, model.b_ext)
    k2 = st2(*args2)
    torch.cuda.synchronize()
    if Stage.launches != before + 2:
        raise RuntimeError("stage 2 did not count its launch")
    # At dt = 75 s the stage's increment g*L is a small share of yc, so
    # agreement of the outputs above says little of the tendency L.
    # Stage 3 with y0 = -2*yc isolates it: f32(2/3) is exactly
    # 2*f32(1/3), so a*y0 + b*yc is exactly 0 and the outputs are g*L(yc).
    args3 = (-2.0 * k1[0], -2.0 * k1[1], k1[0], k1[1], gsn2, gwe2,
             model.b_ext)
    k3 = st3(*args3)
    torch.cuda.synchronize()
    if Stage.launches != before + 3:
        raise RuntimeError("stage 3 did not count its launch")
    max_abs = 0.0
    names = ("h", "u", "strips_sn", "strips_we")
    for label, stage, args, out, tol in (
            ("stage 1 (a=0)", st1, args1, k1, KERNEL_TOL),
            ("stage 2 (a=0.75)", st2, args2, k2, KERNEL_TOL),
            ("stage 3, y0=-2yc (g*L alone)", st3, args3, k3, TENDENCY_TOL)):
        ref = stage.reference(*args)
        errs = {nm: rel_err(r, x) for nm, r, x in zip(names, ref, out)}
        max_abs = max([max_abs] + [float((r - x).abs().max())
                                   for r, x in zip(ref, out)])
        finite = all(bool(torch.isfinite(x).all()) for x in out)
        bitwise = all(torch.equal(r, x) for r, x in zip(ref, out))
        log(f"kernel vs plain C{N} {label}: max rel diff "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (tol {tol:g}); finite={finite} bitwise={bitwise}"
            + f"; max |h| {float(out[0].abs().max()):.4e}")
        if not finite or max(errs.values()) > tol:
            raise RuntimeError(f"kernel disagrees with plain ({label})")

    # ---- 3. fused vs classic, 3 steps ------------------------------------
    yf, _ = integrate(step, y0, 0.0, 3, STEP_DT)
    yc, _ = integrate(model.make_step(STEP_DT), s0, 0.0, 3, STEP_DT)
    errs = {k: rel_err(yc[k], yf[k]) for k in ("h", "u")}
    log(f"fused vs classic C{N}, 3 steps: max rel diff "
        f"h {errs['h']:.3e}, u {errs['u']:.3e} (tol "
        f"{FUSED_VS_CLASSIC_TOL:g})")
    if max(errs.values()) > FUSED_VS_CLASSIC_TOL:
        raise RuntimeError("fused step disagrees with the classic path")
    del yf, yc

    # ---- 4. main path: warm-up, timed window, gate -----------------------
    y, t = integrate(step, y0, 0.0, WARM_STEPS, STEP_DT)
    torch.cuda.synchronize()
    Stage.launches = 0
    t0 = time.perf_counter()
    y, t = integrate(step, y, t, TIMED_STEPS, STEP_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = Stage.launches
    if launches != 3 * TIMED_STEPS:
        raise RuntimeError(f"stage launches {launches} != 3 x "
                           f"{TIMED_STEPS} steps")
    h = y["h"].double()
    area = grid.interior(grid.area).double()
    mass0 = float(torch.sum(area * s0["h"].double()))
    drift = abs(float(torch.sum(area * h)) - mass0) / mass0
    finite = bool(torch.isfinite(h).all())
    hmin, hmax = float(h.min()), float(h.max())
    days = (WARM_STEPS + TIMED_STEPS + 3) * STEP_DT / 86400.0
    gate = finite and 3000.0 < hmin and hmax < 6500.0 and drift < 1e-3
    log(f"gate C{N} TC5 after {days:.2f} d: finite={finite} "
        f"h_range=[{hmin:.1f}, {hmax:.1f}] (in (3000, 6500)) "
        f"mass_drift={drift:.3e} (<1e-3) total_mass="
        f"{float(total_mass(grid, y['h'])):.6e} -> "
        f"{'passed' if gate else 'FAILED'}")
    if not gate:
        raise RuntimeError("TC5 gate failed")
    steps_s = TIMED_STEPS / wall
    log(f"main path C{N} TC5 dt={STEP_DT:g}: {TIMED_STEPS} steps in "
        f"{wall:.3f} s -> {steps_s:.1f} steps/s, "
        f"{1e6 / steps_s:.1f} us/step, "
        f"{steps_s * STEP_DT / 86400.0:.3f} sim-days/s; stage launches "
        f"{launches} = 3 x {TIMED_STEPS}; card {card}")

    # Kernel, plain and router times on the run's own state.
    gsn, gwe = route(y["strips_sn"], y["strips_we"])
    a1 = (y["h"], y["u"], gsn, gwe, model.b_ext)
    a2 = (y["h"], y["u"], y["h"], y["u"], gsn, gwe, model.b_ext)
    forms = (("stage 1", st1, a1), ("stage 2", st2, a2),
             ("stage 3", st3, a2))
    ms, plain, bounds, bound_by = [], [], [], set()
    for label, stage, args in forms:
        k_ms = event_ms(lambda: stage(*args), 200)
        p_ms = event_ms(lambda: stage.reference(*args), 10)
        bound, by, nbytes = bound_ms(args, stage(*args), N, FLOPS_PER_CELL)
        ms.append(k_ms)
        plain.append(p_ms)
        bounds.append(bound)
        bound_by.add(by)
        log(f"{label} kernel: {k_ms * 1e3:.2f} us/launch, bound "
            f"{bound * 1e3:.2f} us ({by}, {nbytes / 1e6:.1f} MB), "
            f"{bound / k_ms:.1%} of bound, "
            f"{nbytes / (k_ms * 1e-3) / 1e12:.2f} TB/s; plain "
            f"{p_ms * 1e3:.1f} us; card {card}")
    r_ms = event_ms(lambda: route(y["strips_sn"], y["strips_we"]), 200)
    step_us = 1e6 / steps_s
    log(f"router: {r_ms * 1e3:.2f} us/call (3 per step); step {step_us:.1f}"
        f" us = stage kernels {sum(ms) * 1e3:.1f} us + routers "
        f"{3 * r_ms * 1e3:.1f} us + {step_us - 1e3 * (sum(ms) + 3 * r_ms):.1f}"
        f" us other; card {card}")

    # ---- 5. device busy share: a traced window, apart from the timed one
    device_busy(lambda: integrate(step, y, t, PROFILED_STEPS, STEP_DT),
                PROFILED_STEPS, step_us, card, ("cov_stage_kernel",))

    filter_record = galewsky_path(card)
    # The same TC5 route again: host drift across the run, apart from any
    # cost of the Galewsky path itself.
    r2_ms = event_ms(lambda: route(y["strips_sn"], y["strips_we"]), 200)
    log(f"router (TC5 carry) after the Galewsky phases: {r2_ms * 1e3:.2f} "
        f"us/call (before them: {r_ms * 1e3:.2f}); card {card}")

    mean = lambda v: sum(v) / len(v)
    report = {"kernels": [{
        "name": "cov_stage_compact",
        "route": "cuda",
        "source": "jaxstream_torch/csrc/cov_stage.cu",
        "replaces": "jaxstream/ops/pallas/swe_cov.py:1989",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": mean(ms),
        "plain_ms": mean(plain),
        "bound_ms": mean(bounds),
        "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
        "library_ms": None,
    }, filter_record]}
    log(json.dumps(report))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
