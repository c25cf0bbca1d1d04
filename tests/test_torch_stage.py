"""Port parity: the compact stage and one fused step, against the JAX
Pallas kernel run in interpret mode on the CPU.

The port's stage on CPU tensors is its plain PyTorch version
(``cov_stage_compact_reference``); the JAX side is
``make_cov_stage_compact(..., interpret=True)`` and the compact stepper
under ``backend='pallas_interpret'``, as the JAX package's own tests run
them.  Budget: 1e-6 of each output's max (f32 op-order roundoff; the
measured agreement is ~1e-7).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.ops.pallas.swe_cov import make_cov_stage_compact as jax_stage
from jaxstream.ops.pallas.swe_step import SSPRK3_COEFFS as JAX_COEFFS
from jaxstream.physics.initial_conditions import williamson_tc5 as jax_tc5

from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops.cuda import swe_cov as tcov
from jaxstream_torch.physics.initial_conditions import williamson_tc5

DT = 600.0
TOL = 1e-6
# The tendency alone is ill-conditioned in float32 (its flux differences
# cancel), so two f32 evaluations of it differ by ~1e-5 of its max. Both
# sides are held to 1e-4 of it, against each other and against a float64
# evaluation of the same stage: 100 times below a 1% error.
TENDENCY_TOL = 1e-4


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _tc5(n):
    tg = build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=torch.float32,
                    device="cpu")
    th, tv, tb = williamson_tc5(tg, EARTH_GRAVITY, EARTH_OMEGA)
    tm = CovariantShallowWater(tg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                               b_ext=tb)
    return tg, tm, tm.initial_state(th, tv)


def _stage_inputs(n=8, seed=11):
    """TC5 state, a perturbed current stage, and its routed ghosts."""
    tg, tm, s0 = _tc5(n)
    rng = np.random.default_rng(seed)
    yc = {k: (v * torch.from_numpy(
        (1.0 + 1e-3 * rng.standard_normal(v.shape)).astype(np.float32)))
        .contiguous() for k, v in s0.items()}
    sn, we = tcov.pack_strips_cov_split(yc["h"], yc["u"], n, tg.halo)
    gsn, gwe = tcov.make_cov_strip_router_split(tg)(sn, we)
    return tg, tm, s0, yc, gsn, gwe


def test_ssprk3_coeffs_match():
    assert tcov.SSPRK3_COEFFS == JAX_COEFFS


@pytest.mark.parametrize("k", [0, 1, 2])
def test_stage_matches_jax_interpret(k):
    a, b = tcov.SSPRK3_COEFFS[k]
    tg, tm, s0, yc, gsn, gwe = _stage_inputs()
    n, h = tg.n, tg.halo
    stage = tcov.make_cov_stage_compact(
        n, h, tg.dalpha, tg.radius, EARTH_GRAVITY, EARTH_OMEGA, DT, a, b,
        device="cpu")
    jstage = jax_stage(n, h, float(tg.dalpha), float(tg.radius),
                       EARTH_GRAVITY, EARTH_OMEGA, DT, a, b, interpret=True,
                       sym_prescaled=True)
    J = lambda t: jnp.asarray(t.numpy())
    args = [yc["h"], yc["u"], gsn, gwe, tm.b_ext]
    if a != 0.0:
        args = [s0["h"], s0["u"]] + args
    before = tcov.CovStageCompact.launches
    out = stage(*args)
    jout = jstage(*[J(t) for t in args])
    assert tcov.CovStageCompact.launches == before   # plain version: no launch
    names = ("h", "u", "strips_sn", "strips_we")
    for name, x, y in zip(names, jout, out):
        assert tuple(x.shape) == tuple(y.shape), name
        assert _rel(x, y.numpy()) <= TOL, (name, _rel(x, y.numpy()))
    # The emitted strips are exactly the pack of the emitted state.
    sn, we = tcov.pack_strips_cov_split(out[0], out[1], n, h)
    assert torch.equal(sn, out[2]) and torch.equal(we, out[3])
    if k == 2:
        # y0 = -2*yc zeroes stage 3's base exactly (f32(2/3) is exactly
        # 2*f32(1/3)), so the outputs are the scaled tendency g*L alone,
        # which the full outputs hide under yc.
        assert stage.fb == 2.0 * stage.fa
        base = stage.fa * (-2.0 * yc["u"]) + stage.fb * yc["u"]
        assert torch.equal(base, torch.zeros_like(base))
        args = [-2.0 * yc["h"], -2.0 * yc["u"]] + args[2:]
        out = stage(*args)
        jout = jstage(*[J(t) for t in args])
        assert float(out[0].abs().max()) < 1e-2 * float(yc["h"].max())
        exact = stage.reference(*[t.double() for t in args])
        for name, x, y, r in zip(names, jout, out, exact):
            errs = (_rel(x, y.numpy()), _rel(r, y.numpy()), _rel(r, x))
            assert max(errs) <= TENDENCY_TOL, (name, errs)


def test_one_compact_step_matches_jax_interpret_stepper():
    n = 8
    tg, tm, s0 = _tc5(n)
    jg = jax_build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    jh, jv, jb = jax_tc5(jg, EARTH_GRAVITY, EARTH_OMEGA)
    jm = JaxCov(jg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA, b_ext=jb,
                backend="pallas_interpret")
    jy = jm.make_fused_step(DT)(jm.compact_state(jm.initial_state(jh, jv)),
                                0.0)
    ty = tm.make_fused_step(DT)(tm.compact_state(s0), 0.0)
    for k in ("h", "u", "strips_sn", "strips_we"):
        assert _rel(jy[k], ty[k].numpy()) <= TOL, (k, _rel(jy[k], ty[k]))


def test_stage_wrapper_rejects_bad_inputs():
    tg, tm, s0, yc, gsn, gwe = _stage_inputs()
    stage = tcov.make_cov_stage_compact(
        tg.n, tg.halo, tg.dalpha, tg.radius, EARTH_GRAVITY, EARTH_OMEGA, DT,
        0.0, 1.0, device="cpu")
    ok = [yc["h"], yc["u"], gsn, gwe, tm.b_ext]
    stage(*ok)
    with pytest.raises(ValueError, match="float32"):
        stage(yc["h"].double(), *ok[1:])
    with pytest.raises(ValueError, match="shape"):
        stage(yc["h"][:, :-1], *ok[1:])
    with pytest.raises(ValueError, match="contiguous"):
        stage(yc["h"].transpose(1, 2), *ok[1:])
    with pytest.raises(ValueError, match="built for"):
        stage(yc["h"].to("meta"), *ok[1:])
    with pytest.raises(TypeError, match="takes 5"):
        stage(s0["h"], s0["u"], *ok)
    with pytest.raises(NotImplementedError, match="MC limiter"):
        tcov.make_cov_stage_compact(8, 2, 0.1, 1.0, 9.8, 0.0, 1.0, 0.0, 1.0,
                                    limiter="minmod", device="cpu")
    with pytest.raises(NotImplementedError, match="b == 1"):
        tcov.make_cov_stage_compact(8, 2, 0.1, 1.0, 9.8, 0.0, 1.0, 0.0, 0.5,
                                    device="cpu")
