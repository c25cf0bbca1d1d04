"""Drive jaxstream_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

The main path is the Williamson TC5 (flow over a mountain) integration
at C384, halo 2, float32, PLR + MC, dt = 75 s, stepped by the compact
fused SSPRK3 stepper: per step three strip routes (torch ops) and three
launches of the hand-written CUDA stage kernel
(``jaxstream_torch/csrc/cov_stage.cu``).  Phases, each fatal on failure:

1. the card, its power limit, and the kernel build (nvcc, -Xptxas -v);
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
   share (apart from the timed window, so tracing costs it nothing).

It prints a JSON line of the kernels, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result, without a CUDA device or without the rest of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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
KERNEL_TOL = 1e-5
# The tendency alone is ill-conditioned in float32 (its flux differences
# cancel): two f32 evaluations differ by ~1e-5 of its max.
TENDENCY_TOL = 1e-4
FUSED_VS_CLASSIC_TOL = 2e-4


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


def stage_bound_ms(args, outs, n: int) -> tuple:
    """Least time of one stage: bytes (each input read once, each output
    written once) over the memory rate, flops over the f32 rate."""
    moved = sum(t.numel() * t.element_size() for t in list(args) + list(outs))
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_CELL * 6 * n * n / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), moved


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
    built = [_build.build(name) for name in _build.KERNELS]
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
        bound, by, nbytes = stage_bound_ms(args, stage(*args), N)
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        y, t = integrate(step, y, t, PROFILED_STEPS, STEP_DT)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / PROFILED_STEPS
    stage_busy = sum(e.self_device_time_total for e in rows
                     if "cov_stage_kernel" in e.key) / PROFILED_STEPS
    kernels = sum(e.count for e in rows) / PROFILED_STEPS
    if busy > 0.0:
        log(f"device (torch.profiler, {PROFILED_STEPS} traced steps): busy "
            f"{busy:.1f} us/step = {busy / step_us:.1%} of the untraced "
            f"{step_us:.1f} us step (idle {1 - busy / step_us:.1%}); stage "
            f"kernels {stage_busy:.1f} us/step; {kernels:.0f} kernels/step; "
            f"card {card}")
    else:
        log("device busy share: not measured (the profiler saw no device "
            "time)")

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
    }]}
    log(json.dumps(report))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
