"""The Galewsky / del^4 step-budget bisection: the in-stage step's time
split into per-lever floors.

Counterpart of ``experiments/nu4_bisect.py`` (a timing harness outside
the JAX package).  It times eight chains on the Galewsky jet (dt = 60 s,
nu4 = 1e14, zero orography), each feeding its outputs back into its
inputs:

* ``step``: the in-stage del^4 stepper (``make_fused_ssprk3_cov_nu4``);
* ``stage A+r+B+r``: kernel A, a route, kernel B, a route;
* ``A + route``: kernel A and one route;
* ``B``: kernel B (its ghost fill, three Laplacians, the combine);
* ``route``: the strip router alone;
* ``B[full]``, ``B[nofill]``, ``B[nolap]``: kernel B rebuilt with the
  ghost fill or the Laplacian ablated (:class:`Nu4BisectB`), whose
  differences give the fill's and the Laplacians' cost.

Each chain reports the wall microseconds per iteration of the host loop
(two-window differencing, as the JAX harness's ``timeit``) and, on the
GPU, the device microseconds per iteration: the GPU's time for a window
of the chain replayed as a CUDA graph, with no host in the way
(:func:`~jaxstream_torch.utils.profiling.device_seconds`).  The JAX
chains are compiled loops with no per-iteration dispatch, so the device
figure is their counterpart; the wall figure adds the host's dispatch.

The B chains feed B's output back as l1, so their values grow towards
inf/NaN: the chains measure time only.  The ablated kernels are checked
on fresh states (``tests/test_torch_nu4_bisect.py``,
``tests/test_torch_kernels_emulated.py``, ``chip_smoke.py`` phase 34).

Run on the GPU: ``python -m jaxstream_torch.experiments.nu4_bisect [n
[iters]]``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

import torch

from .._device import resolve_device
from ..config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from ..geometry.cubed_sphere import build_grid
from ..models.shallow_water_cov import CovariantShallowWater
from ..ops.cuda._launch import KernelBase, _P, _check_tensors, _entry
from ..ops.cuda.swe_cov import (CovStageNu4, _fill, cov_stage_nu4_b_reference,
                                lap_core, make_cov_stage_nu4,
                                make_fused_ssprk3_cov_nu4,
                                pack_strips_cov_split)
from ..physics.initial_conditions import galewsky
from ..utils.profiling import block_until_ready, device_seconds

__all__ = ["MODES", "Nu4BisectB", "nu4_bisect_b_reference", "timeit", "run",
           "main"]

#: Kernel B's modes, in the order of the C entry's ``mode`` argument.
MODES = ("full", "nofill", "nolap")

DT = 60.0
NU4 = 1.0e14
#: Iterations of each chain's device-timed window (at most the short
#: window).
DEVICE_ITERS = 50


def nu4_bisect_b_reference(stage, mode, h_adv, u_adv, l1h, l1u, gsn, gwe):
    """The plain PyTorch version of kernel B in ``mode``.

    ``stage`` is the :class:`CovStageNu4` whose constants B uses.
    ``full`` is :func:`cov_stage_nu4_b_reference`; ``nolap`` fills l1's
    ghosts and corners as ``full`` does and takes l1 itself where
    ``full`` takes ``lap(l1)``; ``nofill`` takes ``lap`` of l1 padded
    with zeros (no routed ghost, no corner).  Returns ``(h, u,
    strips_sn, strips_we)``.
    """
    if mode == "full":
        return cov_stage_nu4_b_reference(stage, h_adv, u_adv, l1h, l1u, gsn,
                                         gwe)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    n, h = stage.n, stage.halo
    x_row, xf_row, x_col, xf_col = stage.coords
    out = []
    for fi, (adv, l1) in enumerate(((h_adv, l1h), (u_adv[0], l1u[0]),
                                    (u_adv[1], l1u[1]))):
        if mode == "nolap":
            l1f = _fill(l1, gsn, gwe, fi, n, h, corners=True)
            l2 = l1f[:, h:h + n, h:h + n]
        else:
            l1f = l1.new_zeros((6, n + 2 * h, n + 2 * h))
            l1f[:, h:h + n, h:h + n] = l1
            l2 = lap_core(x_row, xf_row, x_col, xf_col, l1f, n=n, halo=h,
                          d=stage.dalpha, radius=stage.radius)
        out.append(adv - stage.damp * l2)
    h_new, u_new = out[0], torch.stack(out[1:])
    sn, we = pack_strips_cov_split(h_new, u_new, n, h)
    return h_new, u_new, sn, we


def _ablated_kernel():
    """Kernel B in any mode: 12 tensor pointers; n, halo, mode; R^2, 1/d,
    0.5/d, damp; the stream."""
    return _entry("cov_stage_nu4", "cov_stage_nu4_b_ablated_f32",
                  [_P] * 12 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4
                  + [_P])


class Nu4BisectB(KernelBase):
    """Kernel B of ``stage`` (a :class:`CovStageNu4`) in ``mode``: the
    port of the JAX harness's ``variant_b`` (``experiments/
    nu4_bisect.py:163-209``).

    ``b(h_adv, u_adv, l1h, l1u, gsn, gwe) -> (h, u, strips_sn,
    strips_we)``, as ``stage.call_b``.  CUDA tensors launch
    ``csrc/cov_stage_nu4.cu``'s kernel B body in the mode's instantiation
    (``full`` is the in-stage pair's own B); CPU tensors run
    :func:`nu4_bisect_b_reference`.  The JAX ``nofill`` leaves the
    ablated ghosts as whatever its scratch held; here they are 0, so the
    kernel is held bitwise against its plain version.
    """

    #: Launches of the ablated-entry kernel, all modes and instances
    #: together (the plain version does not count).
    launches = 0

    def __init__(self, stage: CovStageNu4, mode: str):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.stage, self.mode = stage, mode
        self.device = stage.device

    def __call__(self, h_adv, u_adv, l1h, l1u, gsn, gwe):
        st = self.stage
        n, h = st.n, st.halo
        _check_tensors({"h_adv": (h_adv, (6, n, n)),
                        "u_adv": (u_adv, (2, 6, n, n)),
                        "l1h": (l1h, (6, n, n)), "l1u": (l1u, (2, 6, n, n)),
                        "gsn": (gsn, (6, 6 * h + 2, n)),
                        "gwe": (gwe, (6, n, 6 * h + 2))}, self.device)
        if not self._on_cuda(h_adv):
            return self.reference(h_adv, u_adv, l1h, l1u, gsn, gwe)
        outs = (torch.empty_like(h_adv), torch.empty_like(u_adv),
                h_adv.new_empty((6, 6 * h, n)),
                h_adv.new_empty((6, n, 6 * h)))
        rc = _ablated_kernel()(
            h_adv.data_ptr(), u_adv.data_ptr(), l1h.data_ptr(),
            l1u.data_ptr(), gsn.data_ptr(), gwe.data_ptr(),
            st._xc.data_ptr(), st._xf.data_ptr(),
            *[t.data_ptr() for t in outs], n, h, MODES.index(self.mode),
            *st._bconsts, self._stream())
        if rc != 0:
            raise RuntimeError(f"cov_stage_nu4 ablated kernel B ({self.mode})"
                               f" launch failed: cudaError {rc} (n={n}, "
                               f"halo={h})")
        Nu4BisectB.launches += 1
        return outs

    def reference(self, h_adv, u_adv, l1h, l1u, gsn, gwe):
        """The plain version on the same arguments."""
        return nu4_bisect_b_reference(self.stage, self.mode, h_adv, u_adv,
                                      l1h, l1u, gsn, gwe)


def timeit(fn, *args, iters=2000):
    """Wall seconds per iteration of ``fn(k, *args)`` (``k`` chained
    iterations): both windows (iters/4 and iters) run once as a warm-up,
    then once each timed, and their difference over ``iters - iters/4``
    removes the per-call cost."""
    small, big = iters // 4, iters
    for k in (small, big):
        block_until_ready(fn(k, *args))
    t0 = time.perf_counter()
    block_until_ready(fn(small, *args))
    t1 = time.perf_counter()
    block_until_ready(fn(big, *args))
    t2 = time.perf_counter()
    return ((t2 - t1) - (t1 - t0)) / (big - small)


def _counts():
    return {"A": CovStageNu4.launches_a, "B": CovStageNu4.launches_b,
            "B14": Nu4BisectB.launches}


def run(n: int = 384, iters: int = 2000, device=None) -> dict:
    """Time the chains at C``n``; returns ``{"n", "iters",
    "device_iters", "device", "chains": {name: {"wall_us", "device_us",
    "launches"}}}``.

    ``wall_us``: host-loop microseconds per iteration (:func:`timeit`);
    ``device_us``: the GPU's microseconds per iteration over a window of
    ``device_iters``, timed by
    :func:`~jaxstream_torch.utils.profiling.device_seconds` (None off
    the GPU); ``launches``: each
    counter's launches over :func:`timeit`'s
    four windows, ``2 * (iters // 4 + iters)`` iterations (A, B: the
    in-stage pair's; B14: :class:`Nu4BisectB`'s), 0 for the plain
    versions.
    """
    dev = resolve_device(device)
    G, OM = EARTH_GRAVITY, EARTH_OMEGA
    grid = build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=torch.float32,
                      device=dev)
    hh = grid.halo
    model = CovariantShallowWater(grid, gravity=G, omega=OM, nu4=NU4)
    y0 = model.compact_state(model.initial_state(*galewsky(grid, G, OM)))
    bz = torch.zeros((6, grid.m, grid.m), dtype=torch.float32, device=dev)
    step = make_fused_ssprk3_cov_nu4(grid, G, OM, DT, bz, NU4)
    route = step.route
    sa, sb = make_cov_stage_nu4(grid, G, OM, DT, 0.0, 1.0, NU4)

    def run_step(k, y):
        for _ in range(k):
            y = step(y, 0.0)
        return y

    def run_stage(k, hc, uc, gsn, gwe):
        for _ in range(k):
            ha, ua, l1h, l1u, sn, we = sa(hc, uc, gsn, gwe, bz)
            g2sn, g2we = route(sn, we)
            hc, uc, sn2, we2 = sb(ha, ua, l1h, l1u, g2sn, g2we)
            gsn, gwe = route(sn2, we2)
        return hc, uc, gsn, gwe

    def run_a(k, hc, uc, gsn, gwe):
        for _ in range(k):
            hc, uc, l1h, l1u, sn, we = sa(hc, uc, gsn, gwe, bz)
            gsn, gwe = route(sn, we)
        return hc, uc, gsn, gwe

    gsn0, gwe0 = route(y0["strips_sn"], y0["strips_we"])
    ha, ua, l1h, l1u, sn1, we1 = sa(y0["h"], y0["u"], gsn0, gwe0, bz)
    gsn1, gwe1 = route(sn1, we1)

    def chain_b(b):
        def run_b(k, ha, ua, l1h, l1u):
            for _ in range(k):
                ho, uo, _, _ = b(ha, ua, l1h, l1u, gsn1, gwe1)
                ha, ua, l1h, l1u = ho, uo, ho, uo   # values diverge
            return ha, ua, l1h, l1u
        return run_b

    def run_route(k, sn, we):
        for _ in range(k):
            gsn, gwe = route(sn, we)
            # Fold the ghosts back to strip shapes to close the chain.
            sn, we = gsn[:, :6 * hh], gwe[:, :, :6 * hh]
        return sn, we

    chains = {"step": (run_step, (y0,)),
              "stage A+r+B+r": (run_stage, (y0["h"], y0["u"], gsn0, gwe0)),
              "A + route": (run_a, (y0["h"], y0["u"], gsn0, gwe0)),
              "B": (chain_b(sb), (ha, ua, l1h, l1u)),
              "route": (run_route, (sn1, we1))}
    for mode in MODES:
        chains[f"B[{mode}]"] = (chain_b(Nu4BisectB(sb.__self__, mode)),
                                (ha, ua, l1h, l1u))

    traced = max(1, min(DEVICE_ITERS, iters // 4))
    out = {}
    for name, (fn, args) in chains.items():
        before = _counts()
        wall = timeit(fn, *args, iters=iters)
        launches = {c: v - before[c] for c, v in _counts().items()}
        busy = (device_seconds(lambda: fn(traced, *args))
                if dev.type == "cuda" else None)
        out[name] = {"wall_us": wall * 1e6,
                     "device_us": (None if busy is None
                                   else busy / traced * 1e6),
                     "launches": launches}
    return {"n": n, "iters": iters, "device_iters": traced,
            "device": str(dev), "chains": out}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 384
    iters = int(argv[1]) if len(argv) > 1 else 2000
    res = run(n, iters)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    except OSError:
        card = ""
    for name, c in res["chains"].items():
        dev_us = ("not measured" if c["device_us"] is None
                  else f"{c['device_us']:8.1f} us")
        print(f"{name:14s}: wall {c['wall_us']:8.1f} us, device {dev_us} "
              f"per iteration; launches {c['launches']}")
    print(f"card: {card or 'unknown'}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
