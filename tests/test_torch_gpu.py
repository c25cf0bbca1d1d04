"""The CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``gpu``: it needs a CUDA card and ``nvcc`` (the kernels are built
from ``jaxstream_torch/csrc/`` at first use) and skips, with its reason,
where there is none.  Run it on the card with
``python -m pytest tests/test_torch_gpu.py -q -m gpu``.
"""

import pytest
import torch

from jaxstream_torch.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream_torch.experiments import swe_cov_nbr as nbr
from jaxstream_torch.experiments import swe_mega as mega
from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.models.shallow_water import ShallowWater
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops.cuda import swe_cov as tcov
from jaxstream_torch.ops.cuda import swe_rhs as tsr
from jaxstream_torch.ops.cuda import swe_step as tss
from jaxstream_torch.physics.initial_conditions import (galewsky,
                                                        williamson_tc5)

# Budget for f32 op-order roundoff (rsqrtf against torch.rsqrt, per-cell
# against row-broadcast metrics); the kernel, built with -fmad=false, has
# matched the plain version bitwise on the H100.
TOL = 1e-5
# The tendency alone (the last case below) is ill-conditioned in float32:
# any two f32 evaluations differ by ~1e-5 of its max.
TENDENCY_TOL = 1e-4
# The filter's increment probe: its outputs are lap(lap q) scaled, whose
# f32 evaluation cancels (tests/test_torch_nu4.py, PROBE_TOL).
PROBE_TOL = 1e-4


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / (a.double().abs().max() + 1e-300))


@pytest.mark.gpu
def test_stage_kernel_matches_plain_c48():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stage kernel has no CPU form)")
    g = build_grid(48, halo=2, radius=EARTH_RADIUS, device="cuda")
    h, v, b = williamson_tc5(g, EARTH_GRAVITY, EARTH_OMEGA)
    m = CovariantShallowWater(g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                              b_ext=b)
    s0 = m.initial_state(h, v)
    y = m.compact_state(s0)
    route = tcov.make_cov_strip_router_split(g)
    gsn, gwe = route(y["strips_sn"], y["strips_we"])
    # The last case is stage 3 with y0 = -2*yc: its base a*y0 + b*yc is
    # exactly 0, so the outputs are the scaled tendency g*L alone, which
    # the full outputs hide under yc at this dt.
    cases = [(a, bb, None) for a, bb in tcov.SSPRK3_COEFFS]
    cases.append(tcov.SSPRK3_COEFFS[2] + (-2.0,))
    for a, bb, y0_scale in cases:
        stage = tcov.make_cov_stage_compact(
            g.n, g.halo, g.dalpha, g.radius, EARTH_GRAVITY, EARTH_OMEGA,
            75.0, a, bb, device=g.device)
        args = [s0["h"], s0["u"], gsn, gwe, m.b_ext]
        if y0_scale is not None:
            args = [y0_scale * s0["h"], y0_scale * s0["u"]] + args
        elif a != 0.0:
            args = [s0["h"], s0["u"]] + args
        before = tcov.CovStageCompact.launches
        out = stage(*args)
        torch.cuda.synchronize()
        assert tcov.CovStageCompact.launches == before + 1
        ref = stage.reference(*args)
        for name, x, r in zip(("h", "u", "strips_sn", "strips_we"), out, ref):
            assert bool(torch.all(torch.isfinite(x))), name
            tol = TOL if y0_scale is None else TENDENCY_TOL
            assert _rel(r, x) <= tol, (name, _rel(r, x))


@pytest.mark.gpu
def test_filter_kernel_matches_plain_c48():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the filter kernel has no CPU form)")
    g = build_grid(48, halo=2, radius=EARTH_RADIUS, device="cuda")
    m = CovariantShallowWater(g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                              nu4=1.0e14)
    step = m.make_fused_step(480.0)
    y = step(m.compact_state(m.initial_state(
        *galewsky(g, EARTH_GRAVITY, EARTH_OMEGA))), 0.0)
    args = (y["h"], y["u"]) + step.route(y["strips_sn"], y["strips_we"])
    filt = step.filter
    # The probe scales nu4 until damp*max|l2| is 1e3 x max|q| for every
    # field, so its outputs are the filter term, which the full outputs
    # hide under q (see tests/test_torch_nu4.py for its tolerance).
    exact = filt.reference(*[t.double() for t in args])
    ratio = min(float((a.double() - b).abs().max() / a.abs().max())
                for a, b in zip((args[0], args[1][0], args[1][1]),
                                (exact[0], exact[1][0], exact[1][1])))
    probe = tcov.make_cov_nu4_filter(g, filt.nu4 * 1e3 / ratio, filt.dt_eff)
    for f, tol in ((filt, TOL), (probe, PROBE_TOL)):
        before = tcov.CovNu4Filter.launches
        out = f(*args)
        torch.cuda.synchronize()
        assert tcov.CovNu4Filter.launches == before + 1
        ref = f.reference(*args)
        for name, x, r in zip(("h", "u", "strips_sn", "strips_we"), out, ref):
            assert bool(torch.all(torch.isfinite(x))), name
            assert _rel(r, x) <= tol, (name, _rel(r, x))


def _galewsky_c48(nu4_mode):
    """The C48 Galewsky model (nu4 = 1e14), its ``nu4_mode`` stepper and
    the carry after one step of it."""
    g = build_grid(48, halo=2, radius=EARTH_RADIUS, device="cuda")
    m = CovariantShallowWater(g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                              nu4=1.0e14)
    step = m.make_fused_step(480.0, nu4_mode=nu4_mode)
    y = step(m.compact_state(m.initial_state(
        *galewsky(g, EARTH_GRAVITY, EARTH_OMEGA))), 0.0)
    return g, m, step, y


def _probe_scale(q, out):
    """``PROBE_MARGIN / min over fields of max|dq| / max|q|``: the factor
    on nu4 that makes the filter term 1e3 x the state."""
    return 1e3 / min(float((a.double() - b.double()).abs().max()
                           / a.double().abs().max()) for a, b in zip(q, out))


@pytest.mark.gpu
def test_refused_kernel_matches_plain_c48():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the re-fused stage kernel has no "
                    "CPU form)")
    g, m, step, y = _galewsky_c48("refused")
    args = (y["h"], y["u"]) + step.route(y["strips_sn"], y["strips_we"]) \
        + (m.b_ext,)
    st = step.stage1f
    # The probe scales nu4 until the filtered base h0f, u0f is the filter
    # term alone (see tests/test_torch_nu4_modes.py).
    exact = st.reference(*[t.double() for t in args])
    scale = _probe_scale((args[0], args[1][0], args[1][1]),
                         (exact[2], exact[3][0], exact[3][1]))
    probe = tcov.make_cov_stage_refused_nu4(g, EARTH_GRAVITY, EARTH_OMEGA,
                                            st.dt, st.nu4 * scale)
    names = ("h1", "u1", "h0f", "u0f", "strips_sn", "strips_we")
    for s, tol in ((st, TOL), (probe, PROBE_TOL)):
        before = tcov.CovStageRefusedNu4.launches
        out = s(*args)
        torch.cuda.synchronize()
        assert tcov.CovStageRefusedNu4.launches == before + 1
        ref = s.reference(*args)
        for name, x, r in zip(names, out, ref):
            assert bool(torch.all(torch.isfinite(x))), name
            assert _rel(r, x) <= tol, (name, _rel(r, x))


@pytest.mark.gpu
def test_stage_nu4_kernels_match_plain_c48():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the in-stage del^4 kernels have "
                    "no CPU form)")
    g, m, step, y = _galewsky_c48("stage")
    route = step.route
    gsn, gwe = route(y["strips_sn"], y["strips_we"])
    for st in step.stages[:2]:
        args = (y["h"], y["u"], gsn, gwe, m.b_ext)
        if st.with_y0:
            args = (y["h"], y["u"]) + args
        before = tcov.CovStageNu4.launches_a
        out_a = st.call_a(*args)
        torch.cuda.synchronize()
        assert tcov.CovStageNu4.launches_a == before + 1
        ref_a = st.reference_a(*args)
        for name, x, r in zip(("h_adv", "u_adv", "l1h", "l1u", "sn", "we"),
                              out_a, ref_a):
            assert bool(torch.all(torch.isfinite(x))), name
            assert _rel(r, x) <= TOL, (name, _rel(r, x))
        bargs = tuple(ref_a[:4]) + route(ref_a[4], ref_a[5])
        # B's probe: damp scaled until the output is the filter term.
        exact = st.reference_b(*[t.double() for t in bargs])
        scale = _probe_scale((bargs[0], bargs[1][0], bargs[1][1]),
                             (exact[0], exact[1][0], exact[1][1]))
        probe = tcov.CovStageNu4(g.n, g.halo, g.dalpha, g.radius,
                                 EARTH_GRAVITY, EARTH_OMEGA, st.dt, st.a,
                                 st.b, st.nu4 * scale, device=g.device)
        for s, tol in ((st, TOL), (probe, PROBE_TOL)):
            before = tcov.CovStageNu4.launches_b
            out = s.call_b(*bargs)
            torch.cuda.synchronize()
            assert tcov.CovStageNu4.launches_b == before + 1
            for name, x, r in zip(("h", "u", "sn", "we"), out,
                                  s.reference_b(*bargs)):
                assert bool(torch.all(torch.isfinite(x))), name
                assert _rel(r, x) <= tol, (name, _rel(r, x))


def _tc5_c48():
    g = build_grid(48, halo=2, radius=EARTH_RADIUS, device="cuda")
    h, v, b = williamson_tc5(g, EARTH_GRAVITY, EARTH_OMEGA)
    m = CovariantShallowWater(g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                              b_ext=b)
    return g, m, m.initial_state(h, v)


def _check(name, call, ref, args, tol):
    out = call(*args)
    torch.cuda.synchronize()
    for k, (x, r) in enumerate(zip(out, ref(*args))):
        assert bool(torch.all(torch.isfinite(x))), (name, k)
        assert _rel(r, x) <= tol, (name, k, _rel(r, x))


@pytest.mark.gpu
def test_rhs_kernel_matches_plain_c48():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the RHS kernel has no CPU form)")
    g, m, s0 = _tc5_c48()
    h_ext, u_ext = m.fill(s0["h"]), m._fill_u(s0["u"])
    sym = tcov.sym_edge_normals(g, u_ext)
    rhs = tcov.make_cov_rhs_pallas(g, EARTH_GRAVITY, EARTH_OMEGA)
    kern = rhs.kernel
    one = tcov.make_cov_rhs_pallas(g, EARTH_GRAVITY, EARTH_OMEGA, n_faces=1,
                                   external_sym=True)
    before = tcov.CovRhs.launches
    # The outputs are the tendencies themselves (no RK combine).
    _check("six faces", kern, kern.reference,
           (kern.fz[:, None], h_ext, u_ext, m.b_ext) + sym, TOL)
    for f in (0, 3):
        args = (kern.fz[f:f + 1, None], h_ext[f:f + 1],
                u_ext[:, f:f + 1].contiguous(), m.b_ext[f:f + 1],
                sym[0][f:f + 1], sym[1][f:f + 1])
        _check(f"face {f}", one, one.reference, args, TOL)
    assert tcov.CovRhs.launches == before + 3


@pytest.mark.gpu
def test_stage_inkernel_matches_plain_c48():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the extended-carry stage kernel "
                    "has no CPU form)")
    g, m, s0 = _tc5_c48()
    step = m.make_fused_step(75.0 * 384 / 48, compact=False)
    y1 = step(m.extend_state(s0, with_strips=True), 0.0)
    ghosts = step.route(y1["strips"])
    yc = (y1["h"], y1["u"])
    y0 = (m.fill(s0["h"]), m._fill_u(s0["u"]))
    # The last case is stage 3 with y0 = -2*yc: the interiors are the
    # scaled tendency g*L alone.
    cases = [(st, yc if st.with_y0 else ()) for st in step.stages]
    cases[1] = (step.stages[1], y0)
    cases.append((step.stages[2], (-2.0 * yc[0], -2.0 * yc[1])))
    for k, (st, base) in enumerate(cases):
        before = tcov.CovStageInkernel.launches
        _check(f"case {k}", st, st.reference,
               base + yc + (ghosts, m.b_ext), TOL if k < 3 else TENDENCY_TOL)
        assert tcov.CovStageInkernel.launches == before + 1


@pytest.mark.gpu
def test_stage_nbr_matches_plain_c48():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the neighbour-read stage kernel "
                    "has no CPU form)")
    g, m, s0 = _tc5_c48()
    step = nbr.make_fused_ssprk3_cov_nbr(g, EARTH_GRAVITY, EARTH_OMEGA,
                                         75.0 * 384 / 48, m.b_ext)
    y0 = m.extend_state(s0)
    y1 = step(y0, 0.0)
    yc = (y1["h"], y1["u"])
    base = (y0["h"], y0["u"])
    # The last case is stage 3 with y0 = -2*yc: the interiors are the
    # scaled tendency g*L alone.
    cases = [(st, base if st.with_y0 else ()) for st in step.stages]
    cases.append((step.stages[2], (-2.0 * yc[0], -2.0 * yc[1])))
    for k, (st, b0) in enumerate(cases):
        before = nbr.CovStageNbr.launches
        _check(f"case {k}", st, st.reference, b0 + yc + (m.b_ext,),
               TOL if k < 3 else TENDENCY_TOL)
        assert nbr.CovStageNbr.launches == before + 1


@pytest.mark.gpu
def test_step_mega_matches_plain_c48():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the whole-step kernel has no CPU "
                    "form)")
    g, m, s0 = _tc5_c48()
    step = mega.make_fused_ssprk3_cov_mega(g, EARTH_GRAVITY, EARTH_OMEGA,
                                           75.0 * 384 / 48, m.b_ext)
    kern = step.kernel
    y = m.compact_state(s0)
    for k in range(2):             # the TC5 state, then after a step
        args = (y["h"], y["u"], y["strips_sn"], y["strips_we"], m.b_ext)
        before = mega.CovMegaStep.launches
        _check(f"step {k}", kern, kern.reference, args, TOL)
        assert mega.CovMegaStep.launches == before + 1
        assert kern.blocks >= 1
        y = step(y, 0.0)


def _cart_c48():
    """The Cartesian TC5 model at C48 (backend 'pallas'), its state, and
    the state after one in-kernel fused step."""
    g = build_grid(48, halo=2, radius=EARTH_RADIUS, device="cuda")
    h, v, b = williamson_tc5(g, EARTH_GRAVITY, EARTH_OMEGA)
    m = ShallowWater(g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA, b_ext=b,
                     backend="pallas")
    s0 = m.initial_state(h, v)
    step = m.make_fused_step(75.0 * 384 / 48)
    return g, m, s0, step, step(m.extend_state(s0, with_strips=True), 0.0)


@pytest.mark.gpu
def test_swe_rhs_kernel_matches_plain_c48():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Cartesian RHS kernel has no "
                    "CPU form)")
    g, m, s0, step, y1 = _cart_c48()
    kern = m._pallas_rhs
    before = tsr.SweRhs.launches
    # The initial state and the state after a step (TC5's initial wind
    # has a zero z-component, which hides some operation orders).
    for s in (s0, m.restrict_state(y1)):
        _check("swe rhs", kern, kern.reference,
               (m.fill(s["h"]), m.fill(s["v"]), m.b_ext), TOL)
    assert tsr.SweRhs.launches == before + 2


@pytest.mark.gpu
def test_swe_stage_kernels_match_plain_c48():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Cartesian stage kernels have "
                    "no CPU form)")
    g, m, s0, step, y1 = _cart_c48()
    dt = 75.0 * 384 / 48
    y0 = (m.fill(s0["h"]), m.fill(s0["v"]))
    s1 = m.restrict_state(y1)
    yc = (m.fill(s1["h"]), m.fill(s1["v"]))
    ghosts = step.route(y1["sh_sn"], y1["sh_we"], y1["sv_sn"], y1["sv_we"])
    ink = (y1["h"], y1["v"])
    # Stages 1-3, the general core in stage 2, and stage 3 with y0 =
    # -2*yc: the interiors are the scaled tendency g*L alone.
    for k, (a, b) in enumerate(tss.SSPRK3_COEFFS + (tss.SSPRK3_COEFFS[1],
                                                    tss.SSPRK3_COEFFS[2])):
        fast = k != 3
        base = () if a == 0.0 else y0
        if k == 4:
            base = (-2.0 * yc[0], -2.0 * yc[1])
        tol = TENDENCY_TOL if k == 4 else TOL
        st = tss.make_swe_stage_pallas(g.n, g.halo, g.dalpha, g.radius,
                                       EARTH_GRAVITY, EARTH_OMEGA, dt, a, b,
                                       fast=fast, device=g.device)
        before = tss.SweStage.launches
        _check(f"concat stage {k}", st, st.reference,
               base + yc + (m.b_ext,), tol)
        assert tss.SweStage.launches == before + 1
        if k == 4:
            base = (-2.0 * ink[0], -2.0 * ink[1])
        st = tss.make_swe_stage_inkernel(g.n, g.halo, g.dalpha, g.radius,
                                         EARTH_GRAVITY, EARTH_OMEGA, dt, a,
                                         b, fast=fast, device=g.device)
        before = tss.SweStageInkernel.launches
        _check(f"in-kernel stage {k}", st, st.reference,
               base + ink + (ghosts, m.b_ext), tol)
        assert tss.SweStageInkernel.launches == before + 1
