"""The CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``gpu``: it needs a CUDA card and ``nvcc`` (the kernels are built
from ``jaxstream_torch/csrc/`` at first use) and skips, with its reason,
where there is none.  Run it on the card with
``python -m pytest tests/test_torch_gpu.py -q -m gpu``.
"""

import pytest
import torch

from jaxstream_torch.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream_torch.experiments import nu4_bisect as nb
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
from jaxstream_torch.stepping import integrate

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


def _stage_matches_plain(n):
    """The stage kernel in its three SSPRK3 forms and with y0 = -2*yc at
    C``n``: bitwise equal to its plain version (the budgets say how far
    two f32 evaluations could differ; the kernel meets 0)."""
    g = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cuda")
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
            assert torch.equal(x, r), name


@pytest.mark.gpu
def test_stage_kernel_matches_plain_c48():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stage kernel has no CPU form)")
    _stage_matches_plain(48)


@pytest.mark.gpu
def test_stage_kernel_matches_plain_c40():
    """C40: every tile of the faces-in-block grid is ragged or on an
    edge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stage kernel has no CPU form)")
    _stage_matches_plain(40)


def _filter_matches_plain(n):
    """The filter kernel and its probe at C``n``, on the Galewsky carry
    after one split step: bitwise equal to the plain version."""
    g = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cuda")
    m = CovariantShallowWater(g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                              nu4=1.0e14)
    step = m.make_fused_step(60.0 * 384 / n)
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
            assert torch.equal(x, r), name


@pytest.mark.gpu
def test_filter_kernel_matches_plain_c48():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the filter kernel has no CPU form)")
    _filter_matches_plain(48)


@pytest.mark.gpu
def test_filter_kernel_matches_plain_c40():
    """C40: every tile of the faces-in-block grid is ragged or on an
    edge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the filter kernel has no CPU form)")
    _filter_matches_plain(40)


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


def _tc5_nu4_c48():
    """The C48 TC5 model (its mountain orography; the Galewsky jet's is
    zero) at nu4 = 1e14, its in-stage stepper and the carry after one
    step of it."""
    g = build_grid(48, halo=2, radius=EARTH_RADIUS, device="cuda")
    h, v, b = williamson_tc5(g, EARTH_GRAVITY, EARTH_OMEGA)
    m = CovariantShallowWater(g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                              b_ext=b, nu4=1.0e14)
    step = m.make_fused_step(75.0 * 384 / 48, nu4_mode="stage")
    return g, m, step, step(m.compact_state(m.initial_state(h, v)), 0.0)


@pytest.mark.gpu
def test_stage_nu4_kernels_match_plain_c48():
    """Kernels A and B as stages 1 and 2 on the Galewsky jet and on TC5
    (A bitwise; B with its probe)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the in-stage del^4 kernels have "
                    "no CPU form)")
    for case in (_galewsky_c48("stage"), _tc5_nu4_c48()):
        _stage_nu4_matches_plain(*case)


def _stage_nu4_matches_plain(g, m, step, y):
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
            assert torch.equal(x, r), name
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


@pytest.mark.gpu
def test_stage_nu4_b_ablated_matches_plain_c48():
    """B14 in its three modes, at nu4 = 1e14 and at the probe's nu4,
    bitwise vs its plain version; ``full`` also bitwise vs B7's B."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the ablated kernel B has no CPU "
                    "form)")
    g, m, step, y = _galewsky_c48("stage")
    route = step.route
    st = step.stages[0]
    out_a = st.reference_a(y["h"], y["u"],
                           *route(y["strips_sn"], y["strips_we"]), m.b_ext)
    bargs = tuple(out_a[:4]) + route(out_a[4], out_a[5])
    exact = st.reference_b(*[t.double() for t in bargs])
    scale = _probe_scale((bargs[0], bargs[1][0], bargs[1][1]),
                         (exact[0], exact[1][0], exact[1][1]))
    probe = tcov.CovStageNu4(g.n, g.halo, g.dalpha, g.radius, EARTH_GRAVITY,
                             EARTH_OMEGA, st.dt, st.a, st.b, st.nu4 * scale,
                             device=g.device)
    for s in (st, probe):
        for mode in nb.MODES:
            b = nb.Nu4BisectB(s, mode)
            before = nb.Nu4BisectB.launches
            out = b(*bargs)
            torch.cuda.synchronize()
            assert nb.Nu4BisectB.launches == before + 1
            for k, (x, r) in enumerate(zip(out, b.reference(*bargs))):
                assert bool(torch.all(torch.isfinite(x))), (mode, k)
                assert torch.equal(x, r), (mode, k, _rel(r, x))
            if mode == "full":
                assert all(torch.equal(x, r)
                           for x, r in zip(out, s.call_b(*bargs)))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [48, 72, 74], ids=["c48", "c72", "c74"])
def test_nu4_faces_kernels_match_plain(n):
    """B3 on the Galewsky jet and on TC5's orography, B as stages 1 and 2,
    and B14's three modes, at nu4 = 1e14 and at a probe's (1e21: the
    filter term dominant), from the carry after one step and after
    eleven: bitwise.  C72 has 3 x 3 tile positions (ragged last columns);
    C74's last tiles are ragged by 2 and 10 cells."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the del^4 kernels have no CPU "
                    "form)")
    g = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cuda")
    h, v, b = williamson_tc5(g, EARTH_GRAVITY, EARTH_OMEGA)
    models = {
        "Galewsky": (CovariantShallowWater(
            g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA, nu4=1.0e14),
            galewsky(g, EARTH_GRAVITY, EARTH_OMEGA), 60.0 * 384 / n),
        "TC5": (CovariantShallowWater(
            g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA, b_ext=b,
            nu4=1.0e14), (h, v), 75.0 * 384 / n)}
    for label, (m, ic, dt) in models.items():
        y0 = m.compact_state(m.initial_state(*ic))
        step = m.make_fused_step(dt, nu4_mode="refused")
        probe = tcov.make_cov_stage_refused_nu4(g, EARTH_GRAVITY,
                                                EARTH_OMEGA, dt, 1.0e21)
        y1 = step(y0, 0.0)
        y11, _ = integrate(step, y1, dt, 10, dt)
        for y in (y1, y11):
            args = (y["h"], y["u"]) + step.route(
                y["strips_sn"], y["strips_we"]) + (m.b_ext,)
            for st, tol in ((step.stage1f, TOL), (probe, PROBE_TOL)):
                before = tcov.CovStageRefusedNu4.launches
                _check(f"B3 {label}", st, st.reference, args, tol, exact=True)
                assert tcov.CovStageRefusedNu4.launches == before + 1
    m, ic, dt = models["Galewsky"]
    step = m.make_fused_step(dt, nu4_mode="stage")
    y1 = step(m.compact_state(m.initial_state(*ic)), 0.0)
    y11, _ = integrate(step, y1, dt, 10, dt)
    for y in (y1, y11):
        gsn, gwe = step.route(y["strips_sn"], y["strips_we"])
        for st in step.stages[:2]:
            args = (y["h"], y["u"], gsn, gwe, m.b_ext)
            if st.with_y0:
                args = (y["h"], y["u"]) + args
            out_a = st.reference_a(*args)
            bargs = tuple(out_a[:4]) + step.route(out_a[4], out_a[5])
            probe = tcov.CovStageNu4(g.n, g.halo, g.dalpha, g.radius,
                                     EARTH_GRAVITY, EARTH_OMEGA, st.dt, st.a,
                                     st.b, 1.0e21, device=g.device)
            for s, tol in ((st, TOL), (probe, PROBE_TOL)):
                before = tcov.CovStageNu4.launches_b
                _check("B", s.call_b, s.reference_b, bargs, tol, exact=True)
                assert tcov.CovStageNu4.launches_b == before + 1
                out = s.call_b(*bargs)
                for mode in nb.MODES:
                    kb = nb.Nu4BisectB(s, mode)
                    _check(f"B14 {mode}", kb, kb.reference, bargs, tol,
                           exact=True)
                    if mode == "full":
                        assert all(torch.equal(x, r) for x, r in
                                   zip(kb(*bargs), out))


def _tc5(n):
    g = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cuda")
    h, v, b = williamson_tc5(g, EARTH_GRAVITY, EARTH_OMEGA)
    m = CovariantShallowWater(g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                              b_ext=b)
    return g, m, m.initial_state(h, v)


def _tc5_c48():
    return _tc5(48)


def _check(name, call, ref, args, tol, exact=False):
    out = call(*args)
    torch.cuda.synchronize()
    for k, (x, r) in enumerate(zip(out, ref(*args))):
        assert bool(torch.all(torch.isfinite(x))), (name, k)
        assert _rel(r, x) <= tol, (name, k, _rel(r, x))
        assert not exact or torch.equal(x, r), (name, k)


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
def test_stacked_rhs_kernel_matches_plain_c48():
    """B4's stacked form (the face tier's) over views of a stacked ``q``
    (R, 3, M, M): the six faces in groups of 3 and 3, and of 3, 2 and 1,
    from the TC5 state and after a classic step, one launch each: bitwise
    equal to the stacked plain version, to each face's one-face plain
    version and to the six-face form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the RHS kernel has no CPU form)")
    g, m, s0 = _tc5_c48()
    six = tcov.make_cov_rhs_pallas(g, EARTH_GRAVITY, EARTH_OMEGA).kernel
    one = tcov.make_cov_rhs_pallas(g, EARTH_GRAVITY, EARTH_OMEGA, n_faces=1,
                                   external_sym=True)
    fz = six.fz[:, None]
    for state in (s0, m.make_step(600.0)(s0, 0.0)):
        he, ue = m.fill(state["h"]), m._fill_u(state["u"])
        ssn, swe = tcov.sym_edge_normals(g, ue)
        ref6 = six.reference(fz, he, ue, m.b_ext, ssn, swe)
        q = torch.cat([he[:, None], ue.transpose(0, 1)], dim=1)
        for keys, sizes in (([(0, 0)] * 6, [3, 3]),
                            ([(0, 0)] * 5 + [(0, 1)], [3, 2, 1])):
            groups = tcov.RankGroups(keys, *(
                t.expand((6,) + tuple(t.shape)) for t in six.coords))
            assert [len(grp) for grp in groups.ranks] == sizes
            args = (fz, groups, q[:, 0:1], q[:, 1:3].unsqueeze(2),
                    m.b_ext[:, None], ssn[:, None], swe[:, None])
            before = tcov.CovRhs.launches
            dh, du = one.stacked(*args)
            torch.cuda.synchronize()
            assert tcov.CovRhs.launches == before + 1
            for x, r in zip((dh, du), one.stacked_reference(*args)):
                assert bool(torch.all(torch.isfinite(x))), sizes
                assert torch.equal(x, r), (sizes, _rel(r, x))
            assert torch.equal(dh[:, 0], ref6[0])
            assert torch.equal(du[:, :, 0].transpose(0, 1), ref6[1])
            for f in range(6):
                want = one.reference(fz[f:f + 1], he[f:f + 1],
                                     ue[:, f:f + 1], m.b_ext[f:f + 1],
                                     ssn[f:f + 1], swe[f:f + 1])
                assert torch.equal(dh[f], want[0]), (sizes, f)
                assert torch.equal(du[f], want[1]), (sizes, f)
        out6 = six(fz, he, ue, m.b_ext, ssn, swe)
        for x, r in zip(out6, ref6):
            assert torch.equal(x, r)


def _block_operands(g, m, state, s, cores):
    """Every block of the s x s split of each face at C48 (``cores``: the
    interior windows B5 reads, else the extended blocks B6 reads with the
    face's sym rows cut to the block and seeded ones inside the face)."""
    from jaxstream_torch.ops.cuda.swe_rhs import coord_rows

    he, ue = m.fill(state["h"]), m._fill_u(state["u"])
    ssn, swe = tcov.sym_edge_normals(g, ue)
    n, h = g.n // s, g.halo
    xr, xfr, yc, yfc, frames = coord_rows(g.n, h, g.device)
    fz = frames[:, None, :, 2].contiguous()
    gen = torch.Generator(device="cpu").manual_seed(5)
    for f in range(6):
        for iy in range(s):
            for ix in range(s):
                o = 0 if cores else h
                ry = slice(h - o + iy * n, h + o + (iy + 1) * n)
                rx = slice(h - o + ix * n, h + o + (ix + 1) * n)
                args = (fz[f:f + 1], xr[:, rx].contiguous(),
                        xfr[:, rx].contiguous(), yc[ry].contiguous(),
                        yfc[ry].contiguous(), he[f:f + 1, ry, rx].contiguous(),
                        ue[:, f:f + 1, ry, rx].contiguous(),
                        m.b_ext[f:f + 1, ry, rx].contiguous())
                if not cores:
                    args += tuple(
                        torch.randn(sh, generator=gen).to(g.device)
                        for sh in ((1, 2, n), (1, n, 2)))
                    if s == 1:
                        args = args[:8] + (ssn[f:f + 1], swe[f:f + 1])
                yield args


@pytest.mark.gpu
def test_block_rhs_kernels_match_plain_c48():
    """B5 (the interior pass) and B6 (one block, runtime coordinates) on
    whole faces and on the 2 x 2 split, from the TC5 state and after a
    classic step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the block RHS kernels have no CPU "
                    "form)")
    g, m, s0 = _tc5_c48()
    s1 = m.make_step(600.0)(s0, 0.0)
    for s in (1, 2):
        consts = (g.n // s, g.halo, g.dalpha, g.radius, EARTH_GRAVITY,
                  EARTH_OMEGA)
        for make, cores, cls in (
                (tcov.make_cov_rhs_interior_local, True, tcov.CovRhsInterior),
                (tcov.make_cov_rhs_pallas_local, False, tcov.CovRhsLocal)):
            kern = make(*consts, device=g.device)
            before = cls.launches
            count = 0
            for state in (s0, s1):
                for args in _block_operands(g, m, state, s, cores):
                    out = kern(*args)
                    torch.cuda.synchronize()
                    for k, (x, r) in enumerate(zip(out,
                                                   kern.reference(*args))):
                        assert bool(torch.all(torch.isfinite(x))), (s, k)
                        assert _rel(r, x) <= TOL, (cls.__name__, s, k,
                                                   _rel(r, x))
                    count += 1
            assert cls.launches == before + count == before + 12 * s * s


@pytest.mark.gpu
@pytest.mark.parametrize("cores", [True, False], ids=["B5", "B6"])
def test_stacked_block_rhs_kernels_match_plain_c48(cores):
    """B5 and B6 in one launch over a tier's stacked ranks: the six faces
    (two groups of three), the 24 blocks of the 2 x 2 split (eight
    groups), and six of them in groups of 3, 2 and 1, from the TC5 state
    and after a classic step: bitwise equal to the stacked plain version
    and to each rank's per-block plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the block RHS kernels have no CPU "
                    "form)")
    g, m, s0 = _tc5_c48()
    s1 = m.make_step(600.0)(s0, 0.0)
    make = (tcov.make_cov_rhs_interior_local if cores
            else tcov.make_cov_rhs_pallas_local)
    cls = tcov.CovRhsInterior if cores else tcov.CovRhsLocal
    for s, ranks in ((1, range(6)), (2, range(24)),
                     (2, [0, 4, 8, 12, 16, 1])):
        kern = make(g.n // s, g.halo, g.dalpha, g.radius, EARTH_GRAVITY,
                    EARTH_OMEGA, device=g.device)
        for state in (s0, s1):
            blocks = list(_block_operands(g, m, state, s, cores))
            per = [blocks[r] for r in ranks]
            keys = [((r // s) % s, r % s) for r in ranks]
            groups = tcov.RankGroups(keys, *(
                torch.stack([a[k] for a in per]) for k in (1, 2, 3, 4)))
            args = (torch.cat([a[0] for a in per]), groups,
                    torch.cat([a[5] for a in per])[:, None],
                    torch.stack([a[6] for a in per]),
                    torch.cat([a[7] for a in per])[:, None])
            if not cores:
                args += tuple(torch.stack([a[k] for a in per])
                              for k in (8, 9))
            before = cls.launches
            out = kern.stacked(*args)
            torch.cuda.synchronize()
            assert cls.launches == before + 1
            for x, r in zip(out, kern.stacked_reference(*args)):
                assert bool(torch.all(torch.isfinite(x))), s
                assert torch.equal(x, r), (s, _rel(r, x))
            for i, a in enumerate(per):
                for x, r in zip((out[0][i], out[1][i]), kern.reference(*a)):
                    assert torch.equal(x, r), (s, i)


def _stage_inkernel_matches_plain(n):
    """B8's stages 1-3 and the stage-3 probe at C``n``, on the carry after
    one step: bitwise equal to the plain version, one launch each."""
    g, m, s0 = _tc5(n)
    step = m.make_fused_step(75.0 * 384 / n, compact=False)
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
        _check(f"C{n} case {k}", st, st.reference,
               base + yc + (ghosts, m.b_ext), TOL if k < 3 else TENDENCY_TOL,
               exact=True)
        assert tcov.CovStageInkernel.launches == before + 1


def _stage_nbr_matches_plain(n):
    """B13's stages 1-3 and the stage-3 probe at C``n``, on the state
    after one step: bitwise equal to the plain version, one launch
    each."""
    g, m, s0 = _tc5(n)
    step = nbr.make_fused_ssprk3_cov_nbr(g, EARTH_GRAVITY, EARTH_OMEGA,
                                         75.0 * 384 / n, m.b_ext)
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
        _check(f"C{n} case {k}", st, st.reference, b0 + yc + (m.b_ext,),
               TOL if k < 3 else TENDENCY_TOL, exact=True)
        assert nbr.CovStageNbr.launches == before + 1


@pytest.mark.gpu
def test_stage_inkernel_matches_plain_c48():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the extended-carry stage kernel "
                    "has no CPU form)")
    _stage_inkernel_matches_plain(48)


@pytest.mark.gpu
def test_stage_nbr_matches_plain_c48():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the neighbour-read stage kernel "
                    "has no CPU form)")
    _stage_nbr_matches_plain(48)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [72, 74], ids=["c72", "c74"])
def test_whole_block_stages_match_plain_larger_grids(n):
    """B8 and B13 on 3 x 3 tile positions (C72: ragged last columns, a
    middle tile that reads no ghost) and on tiles ragged by 2 and 10
    cells (C74)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the whole-block stage kernels "
                    "have no CPU form)")
    _stage_inkernel_matches_plain(n)
    _stage_nbr_matches_plain(n)


@pytest.mark.gpu
def test_step_mega_matches_plain_c48():
    """B12 on the grid the card holds at once and on one of 5 blocks (fewer
    than the 8 work items: the metric recomputed per item), from the TC5
    state, after one step and after 20: bitwise equal to its plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the whole-step kernel has no CPU "
                    "form)")
    g, m, s0 = _tc5_c48()
    step = mega.make_fused_ssprk3_cov_mega(g, EARTH_GRAVITY, EARTH_OMEGA,
                                           75.0 * 384 / 48, m.b_ext)
    kern = step.kernel
    small = mega.CovMegaStep(g, EARTH_GRAVITY, EARTH_OMEGA, 75.0 * 384 / 48,
                             max_blocks=5)
    y = m.compact_state(s0)
    for k in range(21):            # the TC5 state, after 1 and 20 steps
        if k in (0, 1, 20):
            args = (y["h"], y["u"], y["strips_sn"], y["strips_we"], m.b_ext)
            for kn in (kern, small):
                before = mega.CovMegaStep.launches
                out = kn(*args)
                torch.cuda.synchronize()
                assert mega.CovMegaStep.launches == before + 1
                for j, (x, r) in enumerate(zip(out, kn.reference(*args))):
                    assert bool(torch.all(torch.isfinite(x))), (k, j)
                    assert torch.equal(x, r), (k, j, _rel(r, x))
            assert kern.blocks >= 8 and small.blocks == 5
        y = step(y, 0.0)


def _cart(n):
    """The Cartesian TC5 model at C``n`` (backend 'pallas'), its state,
    and the state after one in-kernel fused step."""
    g = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cuda")
    h, v, b = williamson_tc5(g, EARTH_GRAVITY, EARTH_OMEGA)
    m = ShallowWater(g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA, b_ext=b,
                     backend="pallas")
    s0 = m.initial_state(h, v)
    step = m.make_fused_step(75.0 * 384 / n)
    return g, m, s0, step, step(m.extend_state(s0, with_strips=True), 0.0)


def _cart_c48():
    return _cart(48)


def _swe_rhs_matches_plain(m, states):
    """B9 on each state's filled frames: bitwise, one launch each."""
    kern = m._pallas_rhs
    for s in states:
        before = tsr.SweRhs.launches
        _check("swe rhs", kern, kern.reference,
               (m.fill(s["h"]), m.fill(s["v"]), m.b_ext), TOL, exact=True)
        assert tsr.SweRhs.launches == before + 1


@pytest.mark.gpu
def test_swe_rhs_kernel_matches_plain_c48():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Cartesian RHS kernel has no "
                    "CPU form)")
    g, m, s0, step, y1 = _cart_c48()
    # The initial state and the state after a step (TC5's initial wind
    # has a zero z-component, which hides some operation orders).
    _swe_rhs_matches_plain(m, (s0, m.restrict_state(y1)))


@pytest.mark.gpu
def test_swe_stage_kernels_match_plain_c48():
    """Both Cartesian stage kernels in both cores, bitwise, from the carry
    after one step and after eleven."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Cartesian stage kernels have "
                    "no CPU form)")
    g, m, s0, step, y1 = _cart_c48()
    dt = 75.0 * 384 / 48
    y11, _ = integrate(step, y1, dt, 10, dt)
    for y in (y1, y11):
        _swe_stages_match_plain(g, m, s0, step, y, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [48, 72, 74], ids=["c48", "c72", "c74"])
def test_swe_faces_kernels_match_plain(n):
    """B9 and B10 (and B11) on 3 x 3 tile positions (C72: ragged last
    columns, a middle tile that reads no ghost), on tiles ragged by 2 and
    10 cells (C74) and at C48, from the carry after one step and after
    eleven: bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Cartesian kernels have no "
                    "CPU form)")
    g, m, s0, step, y1 = _cart(n)
    dt = 75.0 * 384 / n
    y11, _ = integrate(step, y1, dt, 10, dt)
    for y in (y1, y11):
        _swe_rhs_matches_plain(m, (m.restrict_state(y),))
        _swe_stages_match_plain(g, m, s0, step, y, dt)


def _swe_stages_match_plain(g, m, s0, step, y1, dt):
    y0 = (m.fill(s0["h"]), m.fill(s0["v"]))
    s1 = m.restrict_state(y1)
    yc = (m.fill(s1["h"]), m.fill(s1["v"]))
    ghosts = step.route(y1["sh_sn"], y1["sh_we"], y1["sv_sn"], y1["sv_we"])
    ink = (y1["h"], y1["v"])
    # Stages 1-3, the general core in stages 1 and 2, and stage 3 with y0
    # = -2*yc: the interiors are the scaled tendency g*L alone.
    coeffs = tss.SSPRK3_COEFFS + (tss.SSPRK3_COEFFS[1],
                                  tss.SSPRK3_COEFFS[2],
                                  tss.SSPRK3_COEFFS[0])
    for k, (a, b) in enumerate(coeffs):
        fast = k not in (3, 5)
        base = () if a == 0.0 else y0
        if k == 4:
            base = (-2.0 * yc[0], -2.0 * yc[1])
        tol = TENDENCY_TOL if k == 4 else TOL
        st = tss.make_swe_stage_pallas(g.n, g.halo, g.dalpha, g.radius,
                                       EARTH_GRAVITY, EARTH_OMEGA, dt, a, b,
                                       fast=fast, device=g.device)
        before = tss.SweStage.launches
        _check(f"concat stage {k}", st, st.reference,
               base + yc + (m.b_ext,), tol, exact=True)
        assert tss.SweStage.launches == before + 1
        if k == 4:
            base = (-2.0 * ink[0], -2.0 * ink[1])
        st = tss.make_swe_stage_inkernel(g.n, g.halo, g.dalpha, g.radius,
                                         EARTH_GRAVITY, EARTH_OMEGA, dt, a,
                                         b, fast=fast, device=g.device)
        before = tss.SweStageInkernel.launches
        _check(f"in-kernel stage {k}", st, st.reference,
               base + ink + (ghosts, m.b_ext), tol, exact=True)
        assert tss.SweStageInkernel.launches == before + 1
