"""Port parity: the Galewsky jet and the split del^4 filter.

Same inputs, made from the Galewsky IC and a numpy seed, go through the
JAX package and the port; the JAX side runs as its own fast tier runs it
(jnp, or the Pallas kernels in interpret mode at C8).  Budgets:

* the Galewsky IC: bitwise (same float64 numpy arithmetic, one cast);
* ``laplacian`` and the classic ``rhs`` with ``nu4`` at float64:
  <= 1e-12 relative;
* the plain filter against ``make_cov_nu4_filter(interpret=True)`` on the
  same routed ghosts: 1e-6 of each output's max (f32 roundoff);
* the increment probe: at ``nu4 = 1e15`` the filter moves q by ~1e-7 of
  its value, so the outputs say little of ``lap(lap q)``.  A probe filter
  with ``nu4`` scaled until ``damp max|l2|`` is 1e3 x ``max|q|`` has the
  filter term as its outputs.  Held to PROBE_TOL against the other
  package and against a float64 evaluation;
* one split step against the JAX interpret-mode split stepper: 1e-6
  (the compact-step budget of ``test_torch_stage.py``; it also covers
  the stages and the filter sharing the prescaled router);
* the split step against the classic del^4 step: 2e-3, mass 1e-5 (the
  JAX package's own budget, ``tests/test_cov_swe.py:630``).
"""

import re

import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

import jax
import jax.numpy as jnp

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.ops import fv as jfv
from jaxstream.ops.pallas import swe_cov as jsc
from jaxstream.physics.initial_conditions import galewsky as jax_galewsky

from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.interop import to_numpy, to_torch
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops import fv as tfv
from jaxstream_torch.ops.cuda import swe_cov as tsc
from jaxstream_torch.physics.initial_conditions import galewsky

F64_REL = 1e-12
TOL = 1e-6
# The probe's outputs are lap(lap q) scaled: a fourth difference whose
# float32 evaluation cancels.  The plain filter at f32 against its own
# float64 evaluation, on the Galewsky state after one step, measured
# 1.2e-7 (C8) to 2.2e-6 (C48) of the probe's max
# (test_probe_f32_roundoff, growing about 2x per doubling of n);
# chip_smoke.py reports the same figure at C384.  1e-4 leaves room.
PROBE_TOL = 1e-4
# Scale of the probe's filter term over the state.
PROBE_MARGIN = 1e3
SPLIT_TOL = 2e-3
NU4 = 1.0e15
DT = 300.0


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _grids(n, dtype=torch.float32):
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (jax_build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=jd),
            build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=dtype,
                       device="cpu"))


@pytest.fixture(scope="module")
def c8():
    """Galewsky at C8: both grids, both models (nu4 = 1e15), states."""
    jg, tg = _grids(8)
    jh, jv = jax_galewsky(jg, EARTH_GRAVITY, EARTH_OMEGA)
    th, tv = galewsky(tg, EARTH_GRAVITY, EARTH_OMEGA)
    jm = JaxCov(jg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA, nu4=NU4,
                backend="pallas_interpret")
    tm = CovariantShallowWater(tg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                               nu4=NU4)
    return jg, tg, jm, tm, jm.initial_state(jh, jv), tm.initial_state(th, tv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_galewsky_bitwise(dtype):
    jg, tg = _grids(12, dtype)
    ja = jax_galewsky(jg, EARTH_GRAVITY, EARTH_OMEGA)
    ta = galewsky(tg, EARTH_GRAVITY, EARTH_OMEGA)
    assert len(ja) == len(ta) == 2
    for a, b in zip(ja, ta):
        assert b.dtype == dtype
        assert np.asarray(a).dtype == b.numpy().dtype
        assert np.array_equal(np.asarray(a), b.numpy())


def test_laplacian_f64():
    jg, tg = _grids(10, torch.float64)
    rng = np.random.default_rng(5)
    psi = rng.standard_normal((2, 6, tg.m, tg.m)) + 3.0
    for q in (psi[0], psi):              # scalar, and with a leading axis
        a = jfv.laplacian(jg, jnp.asarray(q))
        b = tfv.laplacian(tg, torch.from_numpy(q))
        assert tuple(b.shape) == q.shape[:-2] + (10, 10)
        assert _rel(a, b.numpy()) <= F64_REL


def test_classic_rhs_nu4_f64_matches_jnp():
    """Port classic rhs with nu4 = 1e15 vs the JAX jnp rhs, f64, C12."""
    jg, tg = _grids(12, torch.float64)
    jm = JaxCov(jg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA, nu4=NU4)
    tm = CovariantShallowWater(tg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                               nu4=NU4)
    js = jm.initial_state(*jax_galewsky(jg, EARTH_GRAVITY, EARTH_OMEGA))
    rng = np.random.default_rng(6)
    s = {k: np.asarray(v) * (1.0 + 1e-3 * rng.standard_normal(v.shape))
         for k, v in js.items()}
    jr = jm.rhs({k: jnp.asarray(v) for k, v in s.items()}, 0.0)
    tr = tm.rhs({k: torch.from_numpy(v) for k, v in s.items()}, 0.0)
    for k in ("h", "u"):
        assert _rel(jr[k], tr[k].numpy()) <= F64_REL, k
    # The del^4 term is ~1e-4 of the h tendency here, so hold it on its
    # own too: rhs(nu4) - rhs(0) in each package (the subtraction costs
    # ~1e-16 of the tendency, ~1e-12 of the term).
    jr0 = JaxCov(jg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA).rhs(
        {k: jnp.asarray(v) for k, v in s.items()}, 0.0)
    tr0 = CovariantShallowWater(tg, gravity=EARTH_GRAVITY,
                                omega=EARTH_OMEGA).rhs(
        {k: torch.from_numpy(v) for k, v in s.items()}, 0.0)
    for k in ("h", "u"):
        jt = np.asarray(jr[k]) - np.asarray(jr0[k])
        tt = (tr[k] - tr0[k]).numpy()
        assert np.abs(tt).max() > 0.0, k
        assert _rel(jt, tt) <= 1e-9, (k, _rel(jt, tt))


def _probe_nu4(filt, args):
    """``nu4`` at which ``damp max|l2|`` is PROBE_MARGIN x ``max|q|`` for
    the field where the filter term is weakest."""
    q = (args[0], args[1][0], args[1][1])
    out = filt.reference(*[t.double() for t in args])
    qo = (out[0], out[1][0], out[1][1])
    ratio = min(float((a.double() - b).abs().max() / a.abs().max())
                for a, b in zip(q, qo))
    return filt.nu4 * PROBE_MARGIN / ratio


def test_filter_matches_jax_interpret(c8):
    jg, tg, jm, tm, js, ts = c8
    jy = jm.compact_state(js)
    gsn, gwe = jsc.make_cov_strip_router_split(jg)(jy["strips_sn"],
                                                    jy["strips_we"])
    J = lambda t: jnp.asarray(t.numpy())
    args = tuple(to_torch(a, device="cpu") for a in (js["h"], js["u"], gsn,
                                                     gwe))
    names = ("h", "u", "strips_sn", "strips_we")

    filt = tsc.make_cov_nu4_filter(tg, NU4, DT)
    before = tsc.CovNu4Filter.launches
    out = filt(*args)
    assert tsc.CovNu4Filter.launches == before    # plain version: no launch
    jout = jsc.make_cov_nu4_filter(jg, NU4, DT, interpret=True)(
        *[J(t) for t in args])
    for name, x, y in zip(names, jout, out):
        assert tuple(x.shape) == tuple(y.shape), name
        assert _rel(x, y.numpy()) <= TOL, (name, _rel(x, y.numpy()))
    sn, we = tsc.pack_strips_cov_split(out[0], out[1], tg.n, tg.halo)
    assert torch.equal(sn, out[2]) and torch.equal(we, out[3])
    assert not torch.equal(out[0], args[0])       # the filter did act

    # The increment probe: the outputs are the filter term itself.
    nu4_p = _probe_nu4(filt, args)
    probe = tsc.make_cov_nu4_filter(tg, nu4_p, DT)
    out = probe(*args)
    jout = jsc.make_cov_nu4_filter(jg, nu4_p, DT, interpret=True)(
        *[J(t) for t in args])
    exact = probe.reference(*[t.double() for t in args])
    assert float(out[0].abs().max()) > 100.0 * float(args[0].abs().max())
    for name, x, y, r in zip(names, jout, out, exact):
        errs = (_rel(x, y.numpy()), _rel(r, y.numpy()), _rel(r, x))
        assert max(errs) <= PROBE_TOL, (name, errs)


@pytest.mark.parametrize("n", [8, 16, 32, 48])
def test_probe_f32_roundoff(n):
    """The probe at f32 against its float64 evaluation, on the Galewsky
    state after one split step (dt at the C384 CFL, nu4 = 1e14)."""
    tg = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cpu")
    tm = CovariantShallowWater(tg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                               nu4=1e14)
    step = tm.make_fused_step(60.0 * 384 / n)
    y = step(tm.compact_state(tm.initial_state(
        *galewsky(tg, EARTH_GRAVITY, EARTH_OMEGA))), 0.0)
    args = (y["h"], y["u"]) + step.route(y["strips_sn"], y["strips_we"])
    probe = tsc.make_cov_nu4_filter(tg, _probe_nu4(step.filter, args),
                                    step.filter.dt_eff)
    out = probe(*args)
    exact = probe.reference(*[t.double() for t in args])
    assert float(out[0].abs().max()) > 100.0 * float(args[0].abs().max())
    for r, x in zip(exact, out):
        assert _rel(r, x) <= PROBE_TOL, _rel(r, x)


def test_split_step_matches_jax_interpret(c8):
    jg, tg, jm, tm, js, ts = c8
    jy = jsc.make_fused_ssprk3_cov_split_nu4(
        jg, EARTH_GRAVITY, EARTH_OMEGA, DT, jm.b_ext, NU4,
        interpret=True)(jm.compact_state(js), 0.0)
    step = tm.make_fused_step(DT)
    assert isinstance(step.filter, tsc.CovNu4Filter)
    ty = step(tm.compact_state(ts), 0.0)
    assert set(ty) == set(jy)
    for k in ("h", "u", "strips_sn", "strips_we"):
        assert _rel(jy[k], ty[k].numpy()) <= TOL, (k, _rel(jy[k], ty[k]))


def test_split_step_matches_classic_nu4(c8):
    """The split step against JAX's jnp classic del^4 step and the port's
    own classic step, as the JAX package holds its split stepper."""
    jg, tg, jm, tm, js, ts = c8
    jref = JaxCov(jg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA, nu4=NU4)
    ys = jax.jit(jref.make_step(DT))(js, 0.0)
    yc = tm.make_step(DT)(ts, 0.0)
    yp = tm.make_fused_step(DT)(tm.compact_state(ts), 0.0)
    area = tg.interior(tg.area).double()
    m0 = float(torch.sum(area * ts["h"].double()))
    for k in ("h", "u"):
        assert bool(torch.isfinite(yp[k]).all()), k
        assert _rel(ys[k], yp[k].numpy()) <= SPLIT_TOL, k
        assert _rel(yc[k].numpy(), yp[k].numpy()) <= SPLIT_TOL, k
        # The port's classic del^4 step is the JAX one up to f32 roundoff.
        assert _rel(ys[k], yc[k].numpy()) <= 1e-5, k
    mass = float(torch.sum(area * yp["h"].double()))
    assert abs(mass - m0) / abs(m0) < 1e-5


def test_filter_k_counter(c8):
    """interval = 2: the integer ``filter_k`` carry decides the filtered
    steps (never ``round(t/dt)``), as in the JAX package."""
    jg, tg, jm, tm, js, ts = c8
    y0 = tm.compact_state(ts)
    step2 = tsc.make_fused_ssprk3_cov_split_nu4(
        tg, EARTH_GRAVITY, EARTH_OMEGA, DT, tm.b_ext, NU4, interval=2)
    assert step2.filter.dt_eff == 2 * DT
    with pytest.raises(ValueError, match="filter_k"):
        step2(dict(y0), 0.0)
    with pytest.raises(TypeError, match="filter_k"):
        step2(dict(y0, filter_k=torch.tensor(0)), 0.0)
    ya = step2(dict(y0, filter_k=0), 0.0)          # no filter yet
    yb = step2(dict(y0, filter_k=1), 0.0)          # filter applies
    assert ya["filter_k"] == 1 and yb["filter_k"] == 0
    plain = tsc.make_fused_ssprk3_cov_compact(
        tg, EARTH_GRAVITY, EARTH_OMEGA, DT, tm.b_ext)(y0, 0.0)
    for k in ("h", "u", "strips_sn", "strips_we"):
        assert torch.equal(ya[k], plain[k]), k
    assert not torch.equal(ya["h"], yb["h"])
    # The counter crosses the two packages as a plain int.
    jcarry = dict(jm.compact_state(js), filter_k=jnp.int32(1))
    t = to_torch(jcarry, device="cpu")
    assert type(t["filter_k"]) is int and t["filter_k"] == 1
    back = to_numpy(dict(t, filter_k=yb["filter_k"]))
    assert type(back["filter_k"]) is int and back["filter_k"] == 0
    jy = jsc.make_fused_ssprk3_cov_split_nu4(
        jg, EARTH_GRAVITY, EARTH_OMEGA, DT, jm.b_ext, NU4, interpret=True,
        interval=2)(jcarry, 0.0)
    ty = step2(t, 0.0)
    assert int(jy["filter_k"]) == ty["filter_k"] == 0
    assert _rel(jy["h"], ty["h"].numpy()) <= TOL


@pytest.mark.parametrize("ring", [-1, 2])
def test_lap_core_ring_limits(ring):
    tg = build_grid(8, halo=2, device="cpu")
    f = tsc.make_cov_nu4_filter(tg, NU4, DT)
    psi = torch.zeros(6, tg.m, tg.m)
    with pytest.raises(ValueError, match="ring"):
        tsc.lap_core(*f.coords, psi, n=8, halo=2, d=tg.dalpha,
                     radius=tg.radius, ring=ring)
    assert tsc.lap_core(*f.coords, psi, n=8, halo=2, d=tg.dalpha,
                        radius=tg.radius, ring=1).shape == (6, 10, 10)


def test_filter_wrapper_rejects_bad_inputs():
    tg = build_grid(8, halo=2, device="cpu")
    h = 2
    ok = [torch.ones(6, 8, 8), torch.ones(2, 6, 8, 8),
          torch.ones(6, 6 * h + 2, 8), torch.ones(6, 8, 6 * h + 2)]
    f = tsc.make_cov_nu4_filter(tg, NU4, DT)
    f(*ok)
    with pytest.raises(ValueError, match="float32"):
        f(ok[0].double(), *ok[1:])
    with pytest.raises(ValueError, match="shape"):
        f(*ok[:2], ok[2][:, :-2], ok[3])
    with pytest.raises(ValueError, match="contiguous"):
        f(ok[0].transpose(1, 2), *ok[1:])
    with pytest.raises(ValueError, match="built for"):
        f(ok[0].to("meta"), *ok[1:])
    with pytest.raises(ValueError, match="halo >= 2"):
        tsc.make_cov_nu4_filter(build_grid(8, halo=1, device="cpu"), NU4, DT)


@pytest.mark.parametrize("kwargs, err, match", [
    ({"compact": False}, ValueError, "compact carry"),
    ({"carry_dtype": torch.bfloat16}, ValueError, "nu4 paths"),
    ({"u_scale": 2.0}, ValueError, "nu4 paths"),
    ({"nu4_mode": "other"}, ValueError, "nu4_mode"),
])
def test_nu4_fused_step_refusals(kwargs, err, match):
    tg = build_grid(8, halo=2, device="cpu")
    m = CovariantShallowWater(tg, gravity=9.8, omega=0.0, nu4=NU4)
    with pytest.raises(err, match=match):
        m.make_fused_step(DT, **kwargs)


@pytest.mark.parametrize("nu4_mode, parts", [
    ("split", {"filter": tsc.CovNu4Filter}),
    ("refused", {"stage1f": tsc.CovStageRefusedNu4}),
    ("stage", {}),
])
def test_nu4_modes_build_their_steppers(nu4_mode, parts):
    tg = build_grid(8, halo=2, device="cpu")
    m = CovariantShallowWater(tg, gravity=9.8, omega=0.0, nu4=NU4)
    step = m.make_fused_step(DT, nu4_mode=nu4_mode)
    for name, cls in parts.items():
        assert type(getattr(step, name)) is cls, name
    stage_cls = tsc.CovStageNu4 if nu4_mode == "stage" else tsc.CovStageCompact
    assert [type(st) for st in step.stages] == [stage_cls] * (
        2 if nu4_mode == "refused" else 3)
    if nu4_mode == "stage":
        assert all(st.nu4 == NU4 for st in step.stages)


@pytest.mark.parametrize("nu4_mode", ["refused", "stage"])
@pytest.mark.parametrize("kwargs", [
    {"temporal_block": 2}, {"ensemble": 2}, {"precision": "bf16"}])
def test_nu4_modes_refuse_unported_knobs(nu4_mode, kwargs):
    """The knobs of queue A item 5 on the del^4 modes: the JAX package's
    refusals hold with its messages (no batched del^4 stepper; no
    precision policy on the 'stage' oracle), the rest build (before the
    item landed every one raised ``NotImplementedError`` naming it)."""
    tg = build_grid(8, halo=2, device="cpu")
    m = CovariantShallowWater(tg, gravity=9.8, omega=0.0, nu4=NU4)
    refusal = ("ensemble > 0 supports nu4 = 0 only" if "ensemble" in kwargs
               else "nu4_mode='stage' is the f32 parity oracle"
               if nu4_mode == "stage" and "precision" in kwargs else None)
    if refusal is not None:
        with pytest.raises(ValueError, match=re.escape(refusal)):
            m.make_fused_step(DT, nu4_mode=nu4_mode, **kwargs)
        return
    step = m.make_fused_step(DT, nu4_mode=nu4_mode, **kwargs)
    assert getattr(step, "steps_per_call", 1) == kwargs.get(
        "temporal_block", 1)


@pytest.mark.parametrize("make", [tsc.make_fused_ssprk3_cov_refused_nu4,
                                  tsc.make_fused_ssprk3_cov_nu4])
def test_nu4_modes_have_no_interval(make):
    """Filter-cycling stays on the split stepper, as in the JAX package."""
    tg = build_grid(8, halo=2, device="cpu")
    with pytest.raises(TypeError, match="interval"):
        make(tg, 9.8, 0.0, DT, torch.zeros(6, tg.m, tg.m), NU4, interval=2)
