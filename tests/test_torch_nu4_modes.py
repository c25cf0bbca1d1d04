"""Port parity: the re-fused and in-stage del^4 steppers.

``nu4_mode='refused'`` (the filter fused into stage 1) and
``nu4_mode='stage'`` (the in-stage kernel pair A / B) on the Galewsky jet.
Same inputs go through the JAX package, its Pallas kernels in interpret
mode at C8 as its own fast tier runs them, and the port's plain versions.
Budgets:

* the plain re-fused stage against ``make_cov_stage_refused_nu4
  (interpret=True)`` on the same routed ghosts: 1e-6 of each of its six
  outputs' max (f32 roundoff);
* plain A against JAX ``call_a`` and plain B against ``call_b``, as stage
  1 and stage 2, each side fed its own package's router output (the ghost
  blocks are bitwise equal; the sym rows differ by the prescale's
  rounding, since the JAX pair routes unprescaled and scales in kernel
  A): 1e-6;
* increment probes: at nu4 = 1e15 the filter moves q by ~1e-7 of its
  value, so the outputs say little of ``lap(lap q)``.  A probe with nu4
  scaled until the filter term is 1e3 x the state has the filter term as
  its filtered base (re-fused) or output (B); held to PROBE_TOL against
  the other package and against a float64 evaluation;
* one re-fused step and one in-stage step against the JAX interpret-mode
  steppers: 1e-6;
* re-fused vs split at C16, 3 steps: 1e-5, mass 1e-6
  (``tests/test_precision.py:249``'s budget);
* in-stage vs the classic del^4 step: 5e-4 (``tests/test_cov_swe.py:463``);
  in-stage vs split: 2e-3, mass 1e-5 (``tests/test_cov_swe.py:495``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.ops.pallas import swe_cov as jsc
from jaxstream.physics.initial_conditions import galewsky as jax_galewsky

from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.interop import to_torch
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops.cuda import swe_cov as tsc
from jaxstream_torch.physics.initial_conditions import galewsky

TOL = 1e-6
# As tests/test_torch_nu4.py: the probe's outputs are lap(lap q) scaled,
# whose float32 evaluation cancels (1.2e-7 to 2.2e-6 of its max at
# C8-C48 for the split filter).
PROBE_TOL = 1e-4
PROBE_MARGIN = 1e3
NU4 = 1.0e15
DT = 300.0
G, OM = EARTH_GRAVITY, EARTH_OMEGA
KEYS = ("h", "u", "strips_sn", "strips_we")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _J(t):
    return jnp.asarray(t.numpy())


def _probe_scale(q, out):
    """The factor on nu4 that makes the filter term PROBE_MARGIN x the
    state for the field where it is weakest; ``out`` from a float64
    evaluation."""
    return PROBE_MARGIN / min(float((a.double() - b).abs().max()
                                    / a.double().abs().max())
                              for a, b in zip(q, out))


@pytest.fixture(scope="module")
def c8():
    """Galewsky at C8: both grids and models (nu4 = 1e15), the states,
    and each package's routed ghosts of the initial carry."""
    jg = jax_build_grid(8, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    tg = build_grid(8, halo=2, radius=EARTH_RADIUS, device="cpu")
    jm = JaxCov(jg, gravity=G, omega=OM, nu4=NU4, backend="pallas_interpret")
    tm = CovariantShallowWater(tg, gravity=G, omega=OM, nu4=NU4)
    js = jm.initial_state(*jax_galewsky(jg, G, OM))
    ts = tm.initial_state(*galewsky(tg, G, OM))
    jy = jm.compact_state(js)
    return jg, tg, jm, tm, js, ts, jy


def _modes(n):
    """The port's C``n`` Galewsky model (nu4 = 1e15), its initial state
    and a stepper per nu4 mode."""
    tg = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cpu")
    tm = CovariantShallowWater(tg, gravity=G, omega=OM, nu4=NU4)
    s0 = tm.initial_state(*galewsky(tg, G, OM))
    return tg, tm, s0, {mode: tm.make_fused_step(DT, nu4_mode=mode)
                        for mode in ("split", "refused", "stage")}


def test_refused_stage_matches_jax_interpret(c8):
    jg, tg, jm, tm, js, ts, jy = c8
    # The re-fused stepper routes with the prescaled router in both
    # packages: feed both kernels the JAX router's ghosts.
    gsn, gwe = jsc.make_cov_strip_router_split(jg, prescale_sym=True)(
        jy["strips_sn"], jy["strips_we"])
    args = tuple(to_torch(a, device="cpu")
                 for a in (js["h"], js["u"], gsn, gwe, jm.b_ext))
    names = ("h1", "u1", "h0f", "u0f", "strips_sn", "strips_we")

    st = tsc.make_cov_stage_refused_nu4(tg, G, OM, DT, NU4)
    before = tsc.CovStageRefusedNu4.launches
    out = st(*args)
    assert tsc.CovStageRefusedNu4.launches == before    # plain: no launch
    jout = jsc.make_cov_stage_refused_nu4(jg, G, OM, DT, NU4,
                                          interpret=True)(
        *[_J(t) for t in args])
    for name, x, y in zip(names, jout, out):
        assert tuple(x.shape) == tuple(y.shape), name
        assert _rel(x, y.numpy()) <= TOL, (name, _rel(x, y.numpy()))
    sn, we = tsc.pack_strips_cov_split(out[0], out[1], tg.n, tg.halo)
    assert torch.equal(sn, out[4]) and torch.equal(we, out[5])
    assert not torch.equal(out[2], args[0])       # the filter did act

    # The increment probe: h0f, u0f are the filter term itself.
    exact = st.reference(*[t.double() for t in args])
    nu4_p = NU4 * _probe_scale((args[0], args[1][0], args[1][1]),
                               (exact[2], exact[3][0], exact[3][1]))
    probe = tsc.make_cov_stage_refused_nu4(tg, G, OM, DT, nu4_p)
    out = probe(*args)
    jout = jsc.make_cov_stage_refused_nu4(jg, G, OM, DT, nu4_p,
                                          interpret=True)(
        *[_J(t) for t in args])
    exact = probe.reference(*[t.double() for t in args])
    assert float(out[2].abs().max()) > 100.0 * float(args[0].abs().max())
    for name, x, y, r in zip(names, jout, out, exact):
        errs = (_rel(x, y.numpy()), _rel(r, y.numpy()), _rel(r, x))
        assert max(errs) <= PROBE_TOL, (name, errs)


@pytest.mark.parametrize("stage", [0, 1], ids=["stage1", "stage2"])
def test_stage_pair_matches_jax_interpret(c8, stage):
    jg, tg, jm, tm, js, ts, jy = c8
    a, b = tsc.SSPRK3_COEFFS[stage]
    # Each package routes with its own router: the JAX pair's is the
    # unprescaled one, the port's the prescaled one.
    jroute = jsc.make_cov_strip_router_split(jg)
    troute = tsc.make_cov_strip_router_split(tg)
    jg_sn, jg_we = jroute(jy["strips_sn"], jy["strips_we"])
    ty = tm.compact_state(ts)
    tg_sn, tg_we = troute(ty["strips_sn"], ty["strips_we"])
    assert torch.equal(tg_sn[:, :6 * tg.halo],
                       to_torch(jg_sn, device="cpu")[:, :6 * tg.halo])
    jargs = (js["h"], js["u"], jg_sn, jg_we, jm.b_ext)
    targs = (ts["h"], ts["u"], tg_sn, tg_we, tm.b_ext)
    if a != 0.0:
        jargs = (js["h"], js["u"]) + jargs
        targs = (ts["h"], ts["u"]) + targs

    ta, tb = tsc.make_cov_stage_nu4(tg, G, OM, DT, a, b, NU4)
    st = ta.__self__
    ja, jb = jsc.make_cov_stage_nu4(jg, G, OM, DT, a, b, NU4, interpret=True)
    before = (tsc.CovStageNu4.launches_a, tsc.CovStageNu4.launches_b)
    out_a = ta(*targs)
    jout_a = ja(*jargs)
    for name, x, y in zip(("h_adv", "u_adv", "l1h", "l1u", "sn", "we"),
                          jout_a, out_a):
        assert _rel(x, y.numpy()) <= TOL, (name, _rel(x, y.numpy()))
    # The advective half is the compact stage's, whatever the corners.
    ref = tsc.make_cov_stage_compact(tg.n, tg.halo, tg.dalpha, tg.radius, G,
                                     OM, DT, a, b, device="cpu")(*targs)
    assert torch.equal(out_a[0], ref[0]) and torch.equal(out_a[1], ref[1])

    bargs = tuple(out_a[:4]) + troute(out_a[4], out_a[5])
    jbargs = tuple(jout_a[:4]) + jroute(jout_a[4], jout_a[5])
    out_b = tb(*bargs)
    assert (tsc.CovStageNu4.launches_a,
            tsc.CovStageNu4.launches_b) == before   # plain: no launch
    for name, x, y in zip(KEYS, jb(*jbargs), out_b):
        assert _rel(x, y.numpy()) <= TOL, (name, _rel(x, y.numpy()))

    # B's probe, on the port's inputs in both packages.
    exact = st.reference_b(*[t.double() for t in bargs])
    nu4_p = NU4 * _probe_scale((bargs[0], bargs[1][0], bargs[1][1]),
                               (exact[0], exact[1][0], exact[1][1]))
    probe = tsc.CovStageNu4(tg.n, tg.halo, tg.dalpha, tg.radius, G, OM, DT,
                            a, b, nu4_p, device="cpu")
    out = probe.call_b(*bargs)
    jout = jsc.make_cov_stage_nu4(jg, G, OM, DT, a, b, nu4_p,
                                  interpret=True)[1](*[_J(t) for t in bargs])
    exact = probe.reference_b(*[t.double() for t in bargs])
    assert float(out[0].abs().max()) > 100.0 * float(bargs[0].abs().max())
    for name, x, y, r in zip(KEYS, jout, out, exact):
        errs = (_rel(x, y.numpy()), _rel(r, y.numpy()), _rel(r, x))
        assert max(errs) <= PROBE_TOL, (name, errs)


@pytest.mark.parametrize("mode", ["refused", "stage"])
def test_step_matches_jax_interpret(c8, mode):
    jg, tg, jm, tm, js, ts, jy = c8
    make = {"refused": jsc.make_fused_ssprk3_cov_refused_nu4,
            "stage": jsc.make_fused_ssprk3_cov_nu4}[mode]
    jy1 = make(jg, G, OM, DT, jm.b_ext, NU4, interpret=True)(jy, 0.0)
    ty1 = tm.make_fused_step(DT, nu4_mode=mode)(tm.compact_state(ts), 0.0)
    assert set(ty1) == set(jy1)
    for k in KEYS:
        assert _rel(jy1[k], ty1[k].numpy()) <= TOL, (k, _rel(jy1[k], ty1[k]))


def test_refused_matches_split_c16():
    tg, tm, s0, steps = _modes(16)
    ys = yr = tm.compact_state(s0)
    for _ in range(3):
        ys = steps["split"](ys, 0.0)
        yr = steps["refused"](yr, 0.0)
    for k in ("h", "u"):
        assert _rel(ys[k], yr[k]) <= 1e-5, (k, _rel(ys[k], yr[k]))
    area = tg.interior(tg.area).double()
    m0 = float(torch.sum(area * s0["h"].double()))
    assert abs(float(torch.sum(area * yr["h"].double())) - m0) / m0 < 1e-6


def test_stage_matches_classic_and_split_c16():
    tg, tm, s0, steps = _modes(16)
    ys = yp = tm.compact_state(s0)
    yc = s0
    classic = tm.make_step(DT)
    for _ in range(3):
        ys = steps["stage"](ys, 0.0)
        yp = steps["split"](yp, 0.0)
        yc = classic(yc, 0.0)
    for k in ("h", "u"):
        assert bool(torch.isfinite(ys[k]).all()), k
        assert _rel(yc[k], ys[k]) <= 5e-4, (k, _rel(yc[k], ys[k]))
        assert _rel(ys[k], yp[k]) <= 2e-3, (k, _rel(ys[k], yp[k]))
    area = tg.interior(tg.area).double()
    m0 = float(torch.sum(area * s0["h"].double()))
    assert abs(float(torch.sum(area * yp["h"].double())) - m0) / m0 < 1e-5
    assert abs(float(torch.sum(area * ys["h"].double())) - m0) / m0 < 1e-5


def test_plain_versions_do_not_count_launches(c8):
    jg, tg, jm, tm, js, ts, jy = c8
    counts = lambda: (tsc.CovStageCompact.launches,
                      tsc.CovStageRefusedNu4.launches,
                      tsc.CovStageNu4.launches_a, tsc.CovStageNu4.launches_b)
    before = counts()
    y = tm.compact_state(ts)
    for mode in ("refused", "stage"):
        step = tm.make_fused_step(DT, nu4_mode=mode)
        y1 = step(y, 0.0)
        assert bool(torch.isfinite(y1["h"]).all())
        st = step.stage1f if mode == "refused" else step.stages[0]
        gsn, gwe = step.route(y["strips_sn"], y["strips_we"])
        if mode == "refused":
            st.reference(y["h"], y["u"], gsn, gwe, tm.b_ext)
        else:
            st.reference_a(y["h"], y["u"], gsn, gwe, tm.b_ext)
    assert counts() == before
