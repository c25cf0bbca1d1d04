"""Port parity: the Cartesian fused SSPRK3 stages and steppers
(``ShallowWater.make_fused_step``, both forms).

The JAX package's Pallas stages run in interpret mode at C8, as its own
tests run them; the inputs are the TC5 state at C8 (perturbed from a
numpy seed, with random ghost corners where the stage carries them).
Budgets:

* ``raw_strips``, ``route_strips`` and the one-gather router: bitwise
  (data movement);
* the plain stages against the JAX interpret-mode kernels as stages 1-3,
  whole extended blocks (ghost ring and corners) and strips: 1e-6 of each
  output's max (f32 roundoff);
* stage 3 with y0 = -2 yc, whose base cancels exactly in float32
  (f32(2/3) = 2 f32(1/3)), so its interior is b*dt*L alone: 1e-4 of its
  max against JAX and against a float64 evaluation;
* the fast core against the general one through one stage: 2e-6
  (``tests/test_fused_step.py:88``);
* one fused step of each form against the JAX stepper: 1e-6;
* three fused steps of each form against three steps of the port's
  classic path at C12 (TC2, TC5): 2e-4 of max
  (``tests/test_fused_step.py:52``); in-kernel against concat interiors:
  bitwise (the corners, where the two differ, are never read).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water import ShallowWater as JaxSW
from jaxstream.ops.pallas import swe_step as jss
from jaxstream.physics import initial_conditions as jic

from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.interop import to_numpy, to_torch
from jaxstream_torch.models.shallow_water import ShallowWater
from jaxstream_torch.ops.cuda import swe_step as tss
from jaxstream_torch.physics import initial_conditions as tic
from jaxstream_torch.stepping import integrate

G, OM = EARTH_GRAVITY, EARTH_OMEGA
TOL = 1e-6
TENDENCY_TOL = 1e-4
FAST_TOL = 2e-6
FUSED_VS_CLASSIC_TOL = 2e-4
DT = 600.0


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _T(a):
    return to_torch(a, device="cpu")


def _J(t):
    return jnp.asarray(t.numpy())


def _port(n, ic="tc5"):
    tg = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cpu")
    if ic == "tc5":
        h, v, b = tic.williamson_tc5(tg, G, OM)
    else:
        (h, v), b = tic.williamson_tc2(tg, G, OM), None
    tm = ShallowWater(tg, gravity=G, omega=OM, b_ext=b, backend="pallas")
    return tg, tm, tm.initial_state(h, v)


def _with_corners(q, h, rng):
    """``q`` with random ghost corners of its scale."""
    q = q.clone()
    scale = float(q.abs().max())
    for rs in (slice(0, h), slice(-h, None)):
        for cs in (slice(0, h), slice(-h, None)):
            shape = q[..., rs, cs].shape
            q[..., rs, cs] = torch.from_numpy(
                (scale * rng.uniform(0.5, 1.0, shape)).astype(np.float32))
    return q


@pytest.fixture(scope="module")
def c8():
    """TC5 at C8: the JAX model (pallas_interpret), the port's model and
    stage inputs: exchanged, perturbed extended states yc and y0 with
    random corners."""
    jg = jax_build_grid(8, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    h, v, b = jic.williamson_tc5(jg, G, OM)
    jm = JaxSW(jg, gravity=G, omega=OM, b_ext=b, backend="pallas_interpret")
    tg, tm, s0 = _port(8)
    rng = np.random.default_rng(4)
    pert = {k: x * torch.from_numpy((1.0 + 1e-3 * rng.standard_normal(
        x.shape)).astype(np.float32)) for k, x in s0.items()}
    yc = {k: _with_corners(tm.fill(x), 2, rng) for k, x in pert.items()}
    y0 = {k: _with_corners(tm.fill(x), 2, rng) for k, x in s0.items()}
    return jg, tg, jm, tm, yc, y0


def test_raw_and_routed_strips_bitwise():
    rng = np.random.default_rng(9)
    n, h = 8, 2
    field = rng.standard_normal((3, 6, n + 2 * h, n + 2 * h)).astype(
        np.float32)
    for lead in (field[0], field):
        jsn, jwe = jss.raw_strips(jnp.asarray(lead), n, h)
        tsn, twe = tss.raw_strips(_T(lead), n, h)
        assert np.array_equal(np.asarray(jsn), tsn.numpy())
        assert np.array_equal(np.asarray(jwe), twe.numpy())
        jg = jss.route_strips(jsn, jwe)
        tg = tss.route_strips(tsn, twe)
        for x, y in zip(jg, tg):
            assert y.is_contiguous()
            assert np.array_equal(np.asarray(x), y.numpy())
    # The stepper's router: both pairs in one gather, as route_strips.
    strips = tss.raw_strips(_T(field[0]), n, h) + tss.raw_strips(
        _T(field), n, h)
    out = tss.make_strip_router(n, h, "cpu")(*strips)
    want = tss.route_strips(*strips[:2]) + tss.route_strips(*strips[2:])
    for x, y in zip(out, want):
        assert x.is_contiguous() and torch.equal(x, y)
    # The walk itself on data gives the gather's values.
    for x, y in zip(tss._route_walk(*strips[:2]), want[:2]):
        assert torch.equal(x, y)


def _stage_args(a, yc, y0, mid):
    args = (yc["h"], yc["v"]) + mid
    return args if a == 0.0 else (y0["h"], y0["v"]) + args


@pytest.mark.parametrize("stage", [0, 1, 2], ids=["stage1", "stage2",
                                                   "stage3"])
def test_concat_stage_matches_jax_interpret(c8, stage):
    jg, tg, jm, tm, yc, y0 = c8
    a, b = tss.SSPRK3_COEFFS[stage]
    st = tss.make_swe_stage_pallas(8, 2, tg.dalpha, tg.radius, G, OM, DT, a,
                                   b, device="cpu")
    args = _stage_args(a, yc, y0, (tm.b_ext,))
    before = tss.SweStage.launches
    out = st(*args)
    assert tss.SweStage.launches == before              # plain: no launch
    jout = jss.make_swe_stage_pallas(
        8, 2, float(jg.dalpha), float(jg.radius), G, OM, DT, a, b,
        interpret=True)(*[_J(t) for t in args])
    for name, x, y in zip(("h", "v"), jout, out):
        assert tuple(y.shape) == np.asarray(x).shape, name
        assert _rel(x, y.numpy()) <= TOL, (name, _rel(x, y.numpy()))
    # The ghost ring and corners hold a*y0 + b*yc.
    base = yc["h"] if a == 0.0 else st.fa * y0["h"] + st.fb * yc["h"]
    assert torch.equal(out[0][:, :2, :], base[:, :2, :])


@pytest.mark.parametrize("stage", [0, 1, 2], ids=["stage1", "stage2",
                                                   "stage3"])
def test_inkernel_stage_matches_jax_interpret(c8, stage):
    jg, tg, jm, tm, yc, y0 = c8
    a, b = tss.SSPRK3_COEFFS[stage]
    # Routed ghosts of the state's strips; the stage fills its frame with
    # them (its input ghosts are overwritten, its corners kept).
    strips = (tss.raw_strips(yc["h"], 8, 2)
              + tss.raw_strips(yc["v"], 8, 2))
    ghosts = tss.make_strip_router(8, 2, "cpu")(*strips)
    args = _stage_args(a, yc, y0, (ghosts, tm.b_ext))
    st = tss.make_swe_stage_inkernel(8, 2, tg.dalpha, tg.radius, G, OM, DT,
                                     a, b, device="cpu")
    before = tss.SweStageInkernel.launches
    out = st(*args)
    assert tss.SweStageInkernel.launches == before      # plain: no launch
    jargs = [tuple(_J(g) for g in t) if isinstance(t, tuple) else _J(t)
             for t in args]
    jout = jss.make_swe_stage_inkernel(
        8, 2, float(jg.dalpha), float(jg.radius), G, OM, DT, a, b,
        interpret=True)(*jargs)
    names = ("h", "v", "sn", "we", "vsn", "vwe")
    for name, x, y in zip(names, jout, out):
        assert tuple(y.shape) == np.asarray(x).shape, name
        assert _rel(x, y.numpy()) <= TOL, (name, _rel(x, y.numpy()))
    # Corners: a*y0 + b*(input corner); strips: the new interior's.
    base = yc["h"] if a == 0.0 else st.fa * y0["h"] + st.fb * yc["h"]
    assert torch.equal(out[0][:, :2, :2], base[:, :2, :2])
    for x, y in zip(out[2:], tss.raw_strips(out[0], 8, 2)
                    + tss.raw_strips(out[1], 8, 2)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("inkernel", [False, True],
                         ids=["concat", "inkernel"])
def test_stage3_probe_matches_jax_and_f64(c8, inkernel):
    """Stage 3 with y0 = -2 yc: the interior is b*dt*L(yc) alone."""
    jg, tg, jm, tm, yc, y0 = c8
    a, b = tss.SSPRK3_COEFFS[2]
    neg = {k: -2.0 * x for k, x in yc.items()}
    if inkernel:
        ghosts = tss.make_strip_router(8, 2, "cpu")(
            *(tss.raw_strips(yc["h"], 8, 2) + tss.raw_strips(yc["v"], 8, 2)))
        st = tss.make_swe_stage_inkernel(8, 2, tg.dalpha, tg.radius, G, OM,
                                         DT, a, b, device="cpu")
        jmk = jss.make_swe_stage_inkernel
        mid = (ghosts, tm.b_ext)
    else:
        st = tss.make_swe_stage_pallas(8, 2, tg.dalpha, tg.radius, G, OM, DT,
                                       a, b, device="cpu")
        jmk = jss.make_swe_stage_pallas
        mid = (tm.b_ext,)
    args = _stage_args(a, yc, neg, mid)
    out = st(*args)
    jargs = [tuple(_J(g) for g in t) if isinstance(t, tuple) else _J(t)
             for t in args]
    jout = jmk(8, 2, float(jg.dalpha), float(jg.radius), G, OM, DT, a, b,
               interpret=True)(*jargs)
    exact = st.reference(*[tuple(g.double() for g in t)
                           if isinstance(t, tuple) else t.double()
                           for t in args])
    i = slice(2, 10)
    for name, x, y, r in zip(("h", "v"), jout, out, exact):
        x = np.asarray(x)[..., i, i]
        y, r = y[..., i, i].numpy(), r[..., i, i].numpy()
        assert np.max(np.abs(y)) > 0.0
        errs = (_rel(x, y), _rel(r, y), _rel(r, x))
        assert max(errs) <= TENDENCY_TOL, (name, errs)


def test_fast_core_matches_general(c8):
    """``test_fast_core_parity`` on the port: one stage through each core,
    TC5 at C12 (the two cores also run in the CUDA stage kernels)."""
    tg, tm, s0 = _port(12)
    h0, v0 = tm.fill(s0["h"]), tm.fill(s0["v"])
    outs = []
    for fast in (False, True):
        st = tss.make_swe_stage_pallas(12, 2, tg.dalpha, tg.radius, G, OM,
                                       DT, 0.75, 0.25, fast=fast,
                                       device="cpu")
        outs.append(st(h0, v0, h0, v0, tm.b_ext))
    for name, x, y in zip(("h", "v"), *outs):
        assert _rel(x, y) <= FAST_TOL, (name, _rel(x, y))
        assert not torch.equal(x, y), name    # two cores, two roundings


@pytest.mark.parametrize("inkernel", [False, True],
                         ids=["concat", "inkernel"])
def test_fused_step_matches_jax_interpret(c8, inkernel):
    jg, tg, jm, tm, yc, y0 = c8
    h, v, b = jic.williamson_tc5(jg, G, OM)
    jy = jm.extend_state(jm.initial_state(h, v), with_strips=inkernel)
    jy1 = jm.make_fused_step(DT, in_kernel_exchange=inkernel)(jy, 0.0)
    ty1 = tm.make_fused_step(DT, in_kernel_exchange=inkernel)(
        to_torch(jy, device="cpu"), 0.0)
    assert set(ty1) == set(jy1)
    for k, x in to_numpy(ty1).items():
        assert _rel(jy1[k], x) <= TOL, (k, _rel(jy1[k], x))


@pytest.mark.parametrize("ic", ["tc2", "tc5"])
def test_three_fused_steps_vs_classic(ic):
    """``test_fused_step_parity`` on the port, both forms, and the two
    forms' interiors bit for bit."""
    tg, tm, s0 = _port(12, ic)
    ref, _ = tm.run(s0, 3, DT)
    outs = {}
    for inkernel in (False, True):
        step = tm.make_fused_step(DT, in_kernel_exchange=inkernel)
        kind = tss.SweStageInkernel if inkernel else tss.SweStage
        assert [type(s) for s in step.stages] == [kind] * 3
        y, t = integrate(step, tm.extend_state(s0, with_strips=inkernel),
                         0.0, 3, DT)
        assert t == 3 * DT
        outs[inkernel] = tm.restrict_state(y)
        for k in ("h", "v"):
            err = _rel(ref[k], outs[inkernel][k])
            assert err <= FUSED_VS_CLASSIC_TOL, (inkernel, k, err)
    for k in ("h", "v"):
        assert torch.equal(outs[False][k], outs[True][k]), k
