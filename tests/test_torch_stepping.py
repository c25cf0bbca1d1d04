"""Port parity: the time carries of the loops, the schemes and loops of
``stepping``, and the limiter refusal.

* ``integrate``'s time carry against the JAX package's compiled loop,
  bit for bit: float32 (the JAX default, ``jax_enable_x64`` off) against
  the port under torch's default float32, float64 (x64 on, as the suite
  runs JAX) against the port under a float64 default dtype.  The JAX loop
  runs 4 steps per iteration and XLA folds their ``+ dt`` adds
  into one add of the running sum, so the times differ from one ``+ dt``
  per step: dt = 0.1 s for 1 000 steps gives 100.00023651 in float32
  (99.99904633 one add at a time);
* the same for other ``unroll`` values, and for ``integrate_with_history``
  and ``integrate_with_metrics``, whose JAX loops are not unrolled:
  measured in float32 they add ``dt`` once per step (dt = 0.1 s for
  1 000 steps, stride 7: 99.99905);
* euler, ssprk3 and rk4 steps of the classic covariant path at C8 in
  float64 against the JAX package's: <= 1e-12 of max; the history and
  metric streams of both packages at float64: <= 1e-12;
* bitwise: ``blocked`` against k calls, the history and metric loops'
  carry against ``integrate``'s, the metric carry with ``fault_step``
  against the one without (the fault is in the stream only),
  ``vmap_ensemble`` against per-member calls;
* a limiter the port lacks is refused when the model is built, not by a
  ``KeyError`` at the first step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxstream import stepping as jst
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.physics.initial_conditions import williamson_tc5 as jax_tc5
from jaxstream.stepping import integrate as jax_integrate
from jaxstream.utils import diagnostics as jdg

from jaxstream_torch.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.models.shallow_water import ShallowWater
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch import stepping as tst
from jaxstream_torch.physics.initial_conditions import williamson_tc5
from jaxstream_torch.stepping import integrate, time_carry
from jaxstream_torch.utils import diagnostics as tdg


def _jax_times(nsteps, t0, dt, x64):
    """The times the JAX package's ``integrate`` hands its steps, and its
    final time, under ``jax_enable_x64 = x64`` (its default unroll)."""
    def step(y, t):
        return {"ts": y["ts"].at[y["i"]].set(t), "i": y["i"] + 1}

    with jax.enable_x64(x64):
        y, t = jax_integrate(step, {"ts": jnp.zeros(nsteps, float),
                                    "i": jnp.int32(0)}, t0, nsteps, dt)
        return np.asarray(y["ts"]), np.asarray(t)


def _port_times(nsteps, t0, dt, dtype):
    seen = []
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        _, t = integrate(lambda y, t: seen.append(t) or y, {}, t0, nsteps,
                         dt)
    finally:
        torch.set_default_dtype(old)
    return seen, t


@pytest.mark.parametrize("dtype, x64, expect", [
    (torch.float32, False, "100.00023651"),
    (torch.float64, True, "100.00000000"),
], ids=["float32", "float64"])
def test_time_carry_1000_steps_matches_jax(dtype, x64, expect):
    _, t_jax = _jax_times(1000, 0.0, 0.1, x64)
    _, t = _port_times(1000, 0.0, 0.1, dtype)
    assert t.dtype == t_jax.dtype
    assert t == t_jax and f"{t:.8f}" == expect


@pytest.mark.parametrize("dtype, x64", [(torch.float32, False),
                                        (torch.float64, True)],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("nsteps", [3, 11])
def test_step_times_match_jax(dtype, x64, nsteps):
    """Every time a step sees, within the unrolled iterations and in the
    remainder loop, bitwise."""
    ts_jax, t_jax = _jax_times(nsteps, 0.7, 0.1, x64)
    seen, t = _port_times(nsteps, 0.7, 0.1, dtype)
    assert np.array_equal(np.asarray(seen, ts_jax.dtype), ts_jax)
    assert t == t_jax


def test_time_carry_is_a_host_scalar_of_the_default_dtype():
    assert time_carry(0.1).dtype == np.float32
    assert time_carry(np.float64(0.1)) == np.float32(0.1)


@pytest.mark.parametrize("model", [CovariantShallowWater, ShallowWater])
@pytest.mark.parametrize("limiter", ["vanleer", "mc_sign"])
def test_unported_limiter_refused_at_construction(model, limiter):
    g = build_grid(8, halo=2, radius=EARTH_RADIUS, device="cpu")
    with pytest.raises(NotImplementedError, match="queue A item 1"):
        model(g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA, limiter=limiter)


# ---- loop time carries ---------------------------------------------------


def _recorder(n):
    """A JAX step that records the time it is handed (the loops' carry)."""
    def step(y, t):
        return {"ts": y["ts"].at[y["i"]].set(t), "i": y["i"] + 1}
    return step, {"ts": jnp.zeros(n, float), "i": jnp.int32(0)}


def _port_loop_times(run, dtype):
    seen = []
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        t = run(lambda y, t: seen.append(t) or y)
    finally:
        torch.set_default_dtype(old)
    return np.asarray(seen), t


@pytest.mark.parametrize("unroll", [1, 2, 3, 5, 6])
def test_integrate_unroll_times_match_jax(unroll):
    with jax.enable_x64(False):
        step, y0 = _recorder(21)
        y, t_jax = jax_integrate(step, y0, 0.3, 21, 0.1, unroll=unroll)
        ts_jax = np.asarray(y["ts"])
    seen, t = _port_loop_times(lambda st: integrate(
        st, {}, 0.3, 21, 0.1, unroll=unroll)[1], torch.float32)
    assert np.array_equal(seen.astype(np.float32), ts_jax)
    assert t == np.asarray(t_jax) and t.dtype == np.float32


@pytest.mark.parametrize("loop", ["history", "metrics"])
def test_loop_times_match_jax_float32(loop):
    """dt = 0.1 s x 1 000 steps, stride (or metric interval) 7 with 6
    steps left over: every step's time and the final time bitwise."""
    n, stride = 1000, 7
    with jax.enable_x64(False):
        step, y0 = _recorder(n)
        if loop == "history":
            y, t_jax, _ = jst.integrate_with_history(
                step, y0, 0.0, n, 0.1, stride, lambda y: y["i"])
        else:
            y, t_jax, _ = jst.integrate_with_metrics(
                step, y0, 0.0, n, 0.1, lambda y, t: jnp.stack([t]), stride,
                n // stride, 0)
        ts_jax = np.asarray(y["ts"])
    assert str(np.asarray(t_jax)) == "99.99905"
    if loop == "history":
        run = lambda st: tst.integrate_with_history(
            st, {}, 0.0, n, 0.1, stride, lambda y: torch.zeros(1))[1]
    else:
        run = lambda st: tst.integrate_with_metrics(
            st, {}, 0.0, n, 0.1, lambda y, t: torch.zeros(1), stride,
            n // stride, 0)[1]
    seen, t = _port_loop_times(run, torch.float32)
    assert np.array_equal(seen.astype(np.float32), ts_jax)
    assert t == np.asarray(t_jax) and t.dtype == np.float32


def test_blocked_times_match_jax_and_k_calls():
    with jax.enable_x64(False):
        step, y0 = _recorder(6)
        y = jst.blocked(step, 3, 0.1)(y0, jnp.float32(0.7))
        y = jst.blocked(step, 3, 0.1)(y, jnp.float32(0.7) + jnp.float32(0.3))
        ts_jax = np.asarray(y["ts"])
    seen = []
    block = tst.blocked(lambda y, t: seen.append(t) or y, 3, 0.1)
    block({}, np.float32(0.7))
    block({}, np.float32(0.7) + np.float32(0.3))
    assert np.array_equal(np.asarray(seen, np.float32), ts_jax)
    with pytest.raises(ValueError, match="k must be >= 1"):
        tst.blocked(block, 0, 0.1)


# ---- schemes and streams against the JAX package at C8 -------------------

DT_C8 = 1200.0


@pytest.fixture(scope="module")
def c8_f64():
    """TC5 at C8 in float64: the JAX and port classic models and states."""
    jg = jax_build_grid(8, halo=2, radius=EARTH_RADIUS, dtype=jnp.float64)
    tg = build_grid(8, halo=2, radius=EARTH_RADIUS, dtype=torch.float64,
                    device="cpu")
    jh, jv, jb = jax_tc5(jg, EARTH_GRAVITY, EARTH_OMEGA)
    th, tv, tb = williamson_tc5(tg, EARTH_GRAVITY, EARTH_OMEGA)
    jm = JaxCov(jg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA, b_ext=jb)
    tm = CovariantShallowWater(tg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                               b_ext=tb)
    return jm, tm, jm.initial_state(jh, jv), tm.initial_state(th, tv)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


@pytest.mark.parametrize("scheme", ["euler", "ssprk3", "rk4"])
def test_schemes_match_jax_f64(c8_f64, scheme):
    jm, tm, js, ts = c8_f64
    jstep = jm.make_step(DT_C8, scheme)
    jy = jstep(jstep(js, 0.0), DT_C8)
    ty = tm.make_step(DT_C8, scheme)(tm.make_step(DT_C8, scheme)(ts, 0.0),
                                     DT_C8)
    for k in ("h", "u"):
        assert _rel(jy[k], ty[k].numpy()) <= 1e-12, (scheme, k)


def test_unknown_scheme_refused_as_jax():
    with pytest.raises(KeyError):
        jst.make_stepper(None, 1.0, "rk2")
    with pytest.raises(KeyError):
        tst.make_stepper(None, 1.0, "rk2")


def _c8_metrics(model, diag, stack):
    """``metric_fn``: (mass, energy) of a covariant state, its wind made
    Cartesian by the model's ``to_cartesian``."""
    g = model.grid
    b_int = g.interior(model.b_ext)

    def metrics(y, t):
        return stack([diag.total_mass(g, y["h"]),
                      diag.total_energy(g, y["h"], model.to_cartesian(y),
                                        model.gravity, b_int)])
    return metrics


def test_history_and_metric_streams_match_jax_f64(c8_f64):
    jm, tm, js, ts = c8_f64
    n, stride = 7, 3
    # Euler keeps the traced loop bodies small (one rhs each).
    jstep = jm.make_step(DT_C8, "euler")
    tstep = tm.make_step(DT_C8, "euler")
    jmet = _c8_metrics(jm, jdg, jnp.stack)
    tmet = _c8_metrics(tm, tdg, torch.stack)
    jy, _, jh = jax.jit(lambda y: jst.integrate_with_history(
        jstep, y, 0.0, n, DT_C8, stride, lambda y: y["h"]))(js)
    ty, _, th = tst.integrate_with_history(tstep, ts, 0.0, n, DT_C8, stride,
                                           lambda y: y["h"])
    assert tuple(th.shape) == (2, 6, 8, 8) and th.dtype == torch.float64
    assert _rel(jh, th.numpy()) <= 1e-12
    for k in ("h", "u"):
        assert _rel(jy[k], ty[k].numpy()) <= 1e-12, k
    _, _, jbuf = jax.jit(lambda y: jst.integrate_with_metrics(
        jstep, y, 0.0, n, DT_C8, jmet, 2, 4, 0))(js)
    _, _, tbuf = tst.integrate_with_metrics(tstep, ts, 0.0, n, DT_C8, tmet,
                                            2, 4, 0)
    jbuf, tbuf = np.asarray(jbuf), tbuf.numpy()
    assert tbuf.shape == jbuf.shape == (2, 4)
    # Samples after calls 2, 4 and 6; the fourth column is never written.
    assert np.isnan(tbuf[:, 3]).all() and np.isnan(jbuf[:, 3]).all()
    for row in range(2):
        assert _rel(jbuf[row, :3], tbuf[row, :3]) <= 1e-12, row


@pytest.fixture(scope="module")
def c8_f32():
    g = build_grid(8, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(g, EARTH_GRAVITY, EARTH_OMEGA)
    m = CovariantShallowWater(g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                              b_ext=b)
    return m, m.initial_state(h, v)


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_loop_carries_bitwise_integrate(c8_f32):
    m, s0 = c8_f32
    step = m.make_fused_step(DT_C8)
    y0 = m.compact_state(s0)
    ref, t_ref = integrate(step, y0, 0.0, 9, DT_C8, unroll=1)
    y, t, hist = tst.integrate_with_history(step, y0, 0.0, 9, DT_C8, 4,
                                            lambda y: {"h": y["h"]})
    _equal(ref, y)
    assert t == t_ref and tuple(hist["h"].shape) == (2, 6, 8, 8)
    met = _c8_metrics(m, tdg, torch.stack)
    y, t, buf = tst.integrate_with_metrics(step, y0, 0.0, 9, DT_C8, met, 2,
                                           3, 10, steps_per_call=1)
    _equal(ref, y)
    assert t == t_ref
    assert torch.isfinite(buf).all()
    # The fault hook: the sample at global step 10 + 4 is NaN in the
    # stream, the carry and every other sample unchanged.
    yf, tf, buff = tst.integrate_with_metrics(
        step, y0, 0.0, 9, DT_C8, met, 2, 3, 10, fault_step=14)
    _equal(ref, yf)
    assert torch.isnan(buff[:, 1]).all()
    assert torch.equal(buff[:, [0, 2]], buf[:, [0, 2]])
    # step0 as a device scalar: the same stream.
    _, _, bufd = tst.integrate_with_metrics(
        step, y0, 0.0, 9, DT_C8, met, 2, 3, torch.tensor(10),
        fault_step=14)
    assert torch.equal(torch.isnan(bufd), torch.isnan(buff))
    # The closures: the same carries.
    y, t = tst.jit_integrate(step, DT_C8, unroll=1)(y0, 0.0, 9)
    _equal(ref, y)
    y, t, _ = tst.jit_integrate_with_history(
        step, DT_C8, 4, lambda y: y["h"])(y0, 0.0, 9)
    _equal(ref, y)
    with pytest.raises(ValueError, match="every"):
        tst.integrate_with_metrics(step, y0, 0.0, 1, DT_C8, met, 0, 1, 0)


def test_history_empty_and_blocked_bitwise(c8_f32):
    m, s0 = c8_f32
    step = m.make_step(DT_C8)
    y, t, hist = tst.integrate_with_history(step, s0, 0.0, 2, DT_C8, 3,
                                            lambda y: (y["h"], y["u"]))
    assert tuple(hist[0].shape) == (0, 6, 8, 8)
    assert tuple(hist[1].shape) == (0, 2, 6, 8, 8)
    ref = step(step(step(s0, 0.0), DT_C8), 2 * DT_C8)
    _equal(ref, tst.blocked(step, 3, DT_C8)(s0, 0.0))


def test_vmap_ensemble_bitwise_per_member(c8_f32):
    m, s0 = c8_f32
    step = m.make_fused_step(DT_C8)
    rng = np.random.default_rng(0)
    members = []
    for _ in range(3):
        dh = torch.from_numpy(rng.normal(0.0, 5.0, (6, 8, 8)).astype(
            np.float32))
        members.append(m.compact_state({"h": s0["h"] + dh, "u": s0["u"]}))
    axes = {"h": 0, "u": 1, "strips_sn": 0, "strips_we": 0}
    batch = {k: torch.stack([y[k] for y in members], dim=axes[k])
             for k in axes}
    step.steps_per_call = 2
    vstep = tst.vmap_ensemble(step, axes)
    assert vstep.steps_per_call == 2
    out = vstep(batch, 0.0)
    for b, y in enumerate(members):
        ref = step(y, 0.0)
        _equal(ref, {k: v.select(axes[k], b) for k, v in out.items()})
