"""Port parity: every reconstruction on the router-free kernels (B13, B12)
and the del^4 stages (B3, B7 A).

PLR with the four limiters besides MC at halo 2 and PPM at halo 3, the
JAX package's Pallas kernels in interpret mode at C8, as its own tests
run them.  Inputs: TC5 (B13, B12) and the Galewsky jet (B3, B7 A) at C8,
perturbed from a numpy seed, with random ghost corners where a stage
carries them.  Budgets:

* each plain kernel against the JAX interpret kernel on the same inputs
  (B3 and A on the same routed ghosts; B12's kernel is a whole step):
  1e-6 of each output's max (f32 roundoff), A's l1 and its strips
  included;
* one step of each stepper (nbr, mega, re-fused, in-stage) from the
  initial state against the JAX interpret-mode stepper: 1e-6;
* three mega steps against three compact ones at C16, each mode: 1e-6
  (the same arithmetic: bitwise predicted);
* three re-fused steps against three split ones at C16, each mode:
  1e-5, mass 1e-6 (``tests/test_torch_nu4_modes.py``'s budgets);
* a Galewsky ``Simulation`` with ``scheme: ppm``, ``halo: 3`` and
  ``nu4_mode: refused`` (and ``stage``): the re-fused (in-stage) compact
  stepper, as the JAX package selects, and bitwise equal to that stepper
  under ``integrate`` with the run's segmentation.

PPM runs in the fast tier, but for the nbr, re-fused and in-stage steps
(their JAX interpret-mode steppers compile three to six Pallas kernels,
~8-30 s at C8): their kernels' PPM parity runs there at the kernel level,
and the re-fused stepper against the split one.  The other modes'
interpret-mode parity runs in the slow tier (interpret mode is
compile-heavy).  Each mode's kernel sources are held bitwise against
these plain versions by ``tests/test_torch_kernels_emulated.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.experiments import swe_cov_nbr as jnbr
from jaxstream.experiments import swe_mega as jmega
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.ops.pallas import swe_cov as jsc
from jaxstream.physics import initial_conditions as jic
from jaxstream.simulation import Simulation as JaxSim

from jaxstream_torch.experiments import swe_cov_nbr as nbr
from jaxstream_torch.experiments import swe_mega as mega
from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.interop import to_torch
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops.cuda import swe_cov as tsc
from jaxstream_torch.physics import initial_conditions as tic
from jaxstream_torch.simulation import Simulation
from jaxstream_torch.stepping import integrate

G, OM = EARTH_GRAVITY, EARTH_OMEGA
TOL = 1e-6
TC5_DT = 600.0
GAL_DT = 300.0
NU4 = 1.0e15
KEYS = ("h", "u", "strips_sn", "strips_we")
#: (scheme, limiter) of the modes besides PLR-MC; PPM ignores the limiter.
MODES = {"none": ("plr", "none"), "minmod": ("plr", "minmod"),
         "mc_sign": ("plr", "mc_sign"), "vanleer": ("plr", "vanleer"),
         "ppm": ("ppm", "mc")}


def _mode_params():
    return [pytest.param(mode, id=mode, marks=() if mode == "ppm"
                         else pytest.mark.slow) for mode in MODES]


#: The JAX interpret-mode whole step per mode, jitted once for the kernel
#: and the stepper checks.
_JAX_MEGA = {}


def _jax_mega(jm, mode):
    if mode not in _JAX_MEGA:
        scheme, limiter = MODES[mode]
        _JAX_MEGA[mode] = jax.jit(jmega.make_fused_ssprk3_cov_mega(
            jm.grid, G, OM, TC5_DT, jm.b_ext, scheme=scheme, limiter=limiter,
            interpret=True))
    return _JAX_MEGA[mode]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _J(t):
    return jnp.asarray(t.numpy())


def _perturbed(q, rng, corners=0):
    """``q`` times (1 + 1e-3 N(0, 1)) from ``rng``, with random ghost
    corners of its scale ``corners`` deep."""
    q = q * torch.from_numpy(
        (1.0 + 1e-3 * rng.standard_normal(q.shape)).astype(np.float32))
    scale = float(q.abs().max())
    for rs in ((slice(0, corners), slice(-corners, None)) if corners
               else ()):
        for cs in (slice(0, corners), slice(-corners, None)):
            shape = q[..., rs, cs].shape
            q[..., rs, cs] = torch.from_numpy(
                (scale * rng.uniform(0.5, 1.0, shape)).astype(np.float32))
    return q


def _models(n, mode, ic, nu4=0.0, backend="jnp"):
    """Both packages' C``n`` models of ``ic`` ("tc5" or "galewsky") in
    ``mode`` at ``nu4`` (halo 3 for PPM) and their initial states."""
    scheme, limiter = MODES[mode]
    halo = 3 if scheme == "ppm" else 2
    jg = jax_build_grid(n, halo=halo, radius=EARTH_RADIUS, dtype=jnp.float32)
    tg = build_grid(n, halo=halo, radius=EARTH_RADIUS, device="cpu")
    kw = {"gravity": G, "omega": OM, "nu4": nu4, "scheme": scheme,
          "limiter": limiter}
    if ic == "tc5":
        jh, jv, jb = jic.williamson_tc5(jg, G, OM)
        th, tv, tb = tic.williamson_tc5(tg, G, OM)
        jm = JaxCov(jg, b_ext=jb, backend=backend, **kw)
        tm = CovariantShallowWater(tg, b_ext=tb, **kw)
    else:
        jh, jv = jic.galewsky(jg, G, OM)
        th, tv = tic.galewsky(tg, G, OM)
        jm = JaxCov(jg, backend=backend, **kw)
        tm = CovariantShallowWater(tg, **kw)
    return jm, jm.initial_state(jh, jv), tm, tm.initial_state(th, tv)


# ---- the plain kernels against the JAX interpret kernels --------------------


@pytest.mark.parametrize("mode", _mode_params())
def test_router_free_kernels_match_jax_interpret(mode):
    """B13 as stage 2 on a perturbed extended state with random ghost
    corners (carried into its output), and B12's whole step on a perturbed
    compact carry, in ``mode``: 1e-6 of each output's max."""
    scheme, limiter = MODES[mode]
    jm, _, tm, s0 = _models(8, mode, "tc5")
    tg, jg = tm.grid, jm.grid
    h = tg.halo
    rng = np.random.default_rng(19)
    ye = tm.extend_state(s0)
    y0 = {k: _perturbed(v, rng, h) for k, v in ye.items()}
    yc = {k: _perturbed(v, rng, h) for k, v in ye.items()}
    a, b = nbr.SSPRK3_COEFFS[1]
    args = (y0["h"], y0["u"], yc["h"], yc["u"], tm.b_ext)
    st = nbr.make_cov_stage_nbr(tg, G, OM, TC5_DT, a, b, scheme=scheme,
                                limiter=limiter)
    assert st.mode == mode
    out = st(*args)
    jout = jnbr.make_cov_stage_nbr(jg, G, OM, TC5_DT, a, b, scheme=scheme,
                                   limiter=limiter, interpret=True)(
        *[_J(t) for t in args])
    for name, x, y in zip(("h", "u"), jout, out):
        assert _rel(x, y.numpy()) <= TOL, ("B13", name, _rel(x, y.numpy()))

    yk = tm.compact_state({k: _perturbed(v, rng) for k, v in s0.items()})
    kern = mega.CovMegaStep(tg, G, OM, TC5_DT, scheme=scheme,
                            limiter=limiter)
    assert kern.mode == mode
    out = kern(yk["h"], yk["u"], yk["strips_sn"], yk["strips_we"],
               tm.b_ext)
    jy = _jax_mega(jm, mode)({k: _J(v) for k, v in yk.items()}, 0.0)
    for name, y in zip(KEYS, out):
        assert _rel(jy[name], y.numpy()) <= TOL, ("B12", name)


@pytest.mark.parametrize("mode", _mode_params())
def test_nu4_kernels_match_jax_interpret(mode):
    """B3 on a perturbed Galewsky carry and the JAX router's prescaled
    ghosts of its strips; kernel A as stage 2 on it, each package fed its
    own router's ghosts (bitwise equal ghost blocks; the JAX pair routes
    unprescaled and scales in A), in ``mode``: 1e-6 of each output's
    max."""
    scheme, limiter = MODES[mode]
    jm, _, tm, s0 = _models(8, mode, "galewsky", NU4)
    tg, jg = tm.grid, jm.grid
    rng = np.random.default_rng(29)
    y = tm.compact_state({k: _perturbed(v, rng) for k, v in s0.items()})
    jy = {k: _J(v) for k, v in y.items()}
    jg_sn, jg_we = jsc.make_cov_strip_router_split(jg, prescale_sym=True)(
        jy["strips_sn"], jy["strips_we"])
    args = (y["h"], y["u"], to_torch(jg_sn, device="cpu"),
            to_torch(jg_we, device="cpu"), tm.b_ext)
    st = tsc.make_cov_stage_refused_nu4(tg, G, OM, GAL_DT, NU4,
                                        scheme=scheme, limiter=limiter)
    assert st.mode == mode
    out = st(*args)
    jout = jsc.make_cov_stage_refused_nu4(
        jg, G, OM, GAL_DT, NU4, scheme=scheme, limiter=limiter,
        interpret=True)(*[_J(t) for t in args])
    names = ("h1", "u1", "h0f", "u0f", "strips_sn", "strips_we")
    for name, x, yy in zip(names, jout, out):
        assert _rel(x, yy.numpy()) <= TOL, ("B3", name, _rel(x, yy.numpy()))
    assert not torch.equal(out[2], args[0])       # the filter did act

    a, b = tsc.SSPRK3_COEFFS[1]
    ta, _ = tsc.make_cov_stage_nu4(tg, G, OM, GAL_DT, a, b, NU4,
                                   scheme=scheme, limiter=limiter)
    assert ta.__self__.mode == mode
    tsn, twe = tsc.make_cov_strip_router_split(tg)(y["strips_sn"],
                                                   y["strips_we"])
    jsn, jwe = jsc.make_cov_strip_router_split(jg)(jy["strips_sn"],
                                                   jy["strips_we"])
    base = (y["h"], y["u"])
    out = ta(*base, *base, tsn, twe, tm.b_ext)
    ja, _ = jsc.make_cov_stage_nu4(jg, G, OM, GAL_DT, a, b, NU4,
                                   scheme=scheme, limiter=limiter,
                                   interpret=True)
    jout = ja(*[_J(t) for t in base + base], jsn, jwe, jm.b_ext)
    names = ("h_adv", "u_adv", "l1h", "l1u", "sn", "we")
    for name, x, yy in zip(names, jout, out):
        assert _rel(x, yy.numpy()) <= TOL, ("A", name, _rel(x, yy.numpy()))


# ---- one step of each stepper against the JAX interpret-mode stepper -------


def _step_params():
    return [pytest.param(mode, stepper, id=f"{mode}-{stepper}",
                         marks=() if (mode, stepper) == ("ppm", "mega")
                         else pytest.mark.slow)
            for mode in MODES for stepper in ("nbr", "mega", "refused",
                                              "stage")]


@pytest.mark.parametrize("mode, stepper", _step_params())
def test_step_matches_jax_interpret(mode, stepper):
    """One step from the initial state (TC5 for nbr and mega, Galewsky for
    the del^4 steppers) in ``mode``: each carry field within 1e-6 of the
    JAX interpret-mode stepper's max."""
    scheme, limiter = MODES[mode]
    ic, nu4 = (("tc5", 0.0) if stepper in ("nbr", "mega")
               else ("galewsky", NU4))
    jm, js, tm, ts = _models(8, mode, ic, nu4, backend="pallas_interpret")
    tg, jg = tm.grid, jm.grid
    kw = {"scheme": scheme, "limiter": limiter}
    if stepper == "nbr":
        jstep = jnbr.make_fused_ssprk3_cov_nbr(jg, G, OM, TC5_DT, jm.b_ext,
                                               interpret=True, **kw)
        tstep = nbr.make_fused_ssprk3_cov_nbr(tg, G, OM, TC5_DT, tm.b_ext,
                                              **kw)
        jy, ty = jm.extend_state(js), tm.extend_state(ts)
        keys = ("h", "u")
    elif stepper == "mega":
        jstep = _jax_mega(jm, mode)
        tstep = mega.make_fused_ssprk3_cov_mega(tg, G, OM, TC5_DT, tm.b_ext,
                                                **kw)
        jy, ty = jm.compact_state(js), tm.compact_state(ts)
        keys = KEYS
    else:
        jstep = jm.make_fused_step(GAL_DT, nu4_mode=stepper)
        tstep = tm.make_fused_step(GAL_DT, nu4_mode=stepper)
        jy, ty = jm.compact_state(js), tm.compact_state(ts)
        keys = KEYS
    jy1 = jax.jit(jstep)(jy, 0.0)
    ty1 = tstep(ty, 0.0)
    assert set(ty1) == set(jy1) == set(keys)
    for k in keys:
        assert tuple(ty1[k].shape) == jy1[k].shape, k
        assert _rel(jy1[k], ty1[k].numpy()) <= TOL, (k, _rel(jy1[k], ty1[k]))


# ---- the steppers against each other at C16, every mode --------------------


@pytest.mark.parametrize("mode", list(MODES))
def test_mega_matches_compact_in_each_mode(mode):
    """Three mega steps against three compact ones at C16: 1e-6 of max
    (bitwise predicted)."""
    _, _, tm, s0 = _models(16, mode, "tc5")
    step_m = mega.make_fused_ssprk3_cov_mega(tm.grid, G, OM, TC5_DT,
                                             tm.b_ext, scheme=tm.scheme,
                                             limiter=tm.limiter)
    assert step_m.kernel.mode == mode
    y = tm.compact_state(s0)
    ym, _ = integrate(step_m, y, 0.0, 3, TC5_DT)
    yc, _ = integrate(tm.make_fused_step(TC5_DT), y, 0.0, 3, TC5_DT)
    for k in KEYS:
        assert _rel(yc[k], ym[k]) <= TOL, (k, _rel(yc[k], ym[k]))


@pytest.mark.parametrize("mode", list(MODES))
def test_refused_matches_split_in_each_mode(mode):
    """Three re-fused steps against three split ones at C16 on the
    Galewsky jet: 1e-5 of max, mass 1e-6."""
    _, _, tm, s0 = _models(16, mode, "galewsky", NU4)
    step_r = tm.make_fused_step(GAL_DT, nu4_mode="refused")
    assert step_r.stage1f.mode == mode
    y = tm.compact_state(s0)
    ys, _ = integrate(tm.make_fused_step(GAL_DT), y, 0.0, 3, GAL_DT)
    yr, _ = integrate(step_r, y, 0.0, 3, GAL_DT)
    for k in ("h", "u"):
        assert _rel(ys[k], yr[k]) <= 1e-5, (k, _rel(ys[k], yr[k]))
    area = tm.grid.interior(tm.grid.area).double()
    m0 = float(torch.sum(area * s0["h"].double()))
    assert abs(float(torch.sum(area * yr["h"].double())) - m0) / m0 < 1e-6


# ---- the config-driven run -------------------------------------------------


@pytest.mark.parametrize("nu4_mode", ["refused", "stage"])
def test_simulation_takes_fused_del4_stepper_ppm(tmp_path, nu4_mode):
    """A Galewsky config with ``scheme: ppm``, ``halo: 3`` and ``nu4_mode:
    refused`` (or ``stage``): the port takes the compact re-fused (or
    in-stage) stepper in mode PPM (the JAX package's choice for the
    config) and its run equals that stepper under ``integrate`` with the
    run's segmentation (2-step segments, the history stride), bitwise."""
    cfg = {"grid": {"n": 8, "halo": 3, "dtype": "float32"},
           "model": {"name": "shallow_water_cov",
                     "initial_condition": "galewsky", "backend": "pallas",
                     "scheme": "ppm", "nu4_mode": nu4_mode},
           "physics": {"hyperdiffusion": NU4},
           "time": {"dt": GAL_DT, "nsteps": 4},
           "parallelization": {"num_devices": 1},
           "io": {"history_path": str(tmp_path / "hist"),
                  "history_stride": 2}}
    jsim = JaxSim(dict(cfg, io={}))
    assert jsim._fused_step is not None
    assert hasattr(jsim.model, "compact_state")
    sim = Simulation(cfg, device="cpu")
    assert sim.stepper_kind == "compact" and sim.grid.halo == 3
    stages = sim._fused_step.stages
    if nu4_mode == "refused":
        st = sim._fused_step.stage1f
        assert isinstance(st, tsc.CovStageRefusedNu4) and st.mode == "ppm"
        assert [s.mode for s in stages] == ["ppm"] * 2
    else:
        assert [type(s) for s in stages] == [tsc.CovStageNu4] * 3
        assert [s.mode for s in stages] == ["ppm"] * 3
    m = sim.model
    y = {k: v.clone() for k, v in sim.state.items()}
    sim.run()
    step = m.make_fused_step(GAL_DT, nu4_mode=nu4_mode)
    t = 0.0
    for _ in range(2):
        yc, t = integrate(step, m.compact_state(y), t, 2, GAL_DT)
        y = m.restrict_state(yc)
    assert sim.step_count == 4
    for k in y:
        assert torch.equal(y[k], sim.state[k]), k
