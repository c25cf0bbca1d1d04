"""Port parity: every reconstruction on the Cartesian model's kernels (B9,
B10, B11) and on the extended-carry covariant stage (B8).

PLR with the four limiters besides MC at halo 2 and PPM at halo 3, the
JAX package's Pallas kernels in interpret mode at C8, as its own tests
run them.  Inputs: the TC5 state at C8, perturbed from a numpy seed, with
random ghost corners where a stage carries them.  Budgets:

* the plain Cartesian RHS (B9) on the filled frames, and the plain concat
  (B10) and in-kernel (B11) stages as stage 3 with y0 = -2 yc (their
  interiors b*dt*L alone; f32(2/3) = 2 f32(1/3)), against the JAX
  interpret kernels: 1e-4 of each tendency's max, against each other and
  against a float64 evaluation of the plain version (the budget ROADMAP
  queue C records for the plain stage: the tendency's flux differences
  cancel in float32);
* one fused Cartesian step (in-kernel and concat) and one extended
  covariant step against the JAX interpret-mode steppers: 1e-6 of max
  (f32 op-order roundoff);
* three extended covariant steps against three compact ones at C16, each
  mode: 1e-6 of max (the same arithmetic on another carry: bitwise
  predicted);
* a ``Simulation`` of a Cartesian config with ``backend: pallas``,
  ``scheme: ppm``, ``halo: 3``: the in-kernel fused stepper, as the JAX
  package selects, and bitwise equal to that stepper under ``integrate``
  with the run's segmentation.

The modes besides PPM, the concat step and the extended step run their
interpret-mode parity in the slow tier (interpret mode is
compile-heavy); each mode's face states are held
against the JAX package's in ``tests/test_torch_recon.py``, and each
mode's plain kernels bitwise against the kernel sources by
``tests/test_torch_kernels_emulated.py``.
"""

import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

import jax.numpy as jnp

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water import ShallowWater as JaxSW
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.ops.pallas import swe_rhs as jsr
from jaxstream.ops.pallas import swe_step as jss
from jaxstream.physics import initial_conditions as jic
from jaxstream.simulation import Simulation as JaxSim

from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.interop import to_numpy, to_torch
from jaxstream_torch.models.shallow_water import ShallowWater
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops.cuda import swe_cov as tsc
from jaxstream_torch.ops.cuda import swe_step as tss
from jaxstream_torch.physics import initial_conditions as tic
from jaxstream_torch.simulation import Simulation
from jaxstream_torch.stepping import integrate

G, OM = EARTH_GRAVITY, EARTH_OMEGA
DT = 600.0
TOL = 1e-6
TENDENCY_TOL = 1e-4
#: (scheme, limiter) of the modes besides PLR-MC; PPM ignores the limiter.
MODES = {"none": ("plr", "none"), "minmod": ("plr", "minmod"),
         "mc_sign": ("plr", "mc_sign"), "vanleer": ("plr", "vanleer"),
         "ppm": ("ppm", "mc")}
#: The modes whose interpret-mode parity runs in the fast tier.
FAST_MODES = {"ppm"}


def _mode_params(fast=FAST_MODES):
    return [pytest.param(mode, id=mode, marks=() if mode in fast
                         else pytest.mark.slow) for mode in MODES]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _J(t):
    return jnp.asarray(t.numpy())


def _jargs(args):
    return [tuple(_J(g) for g in t) if isinstance(t, tuple) else _J(t)
            for t in args]


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


def _cartesian(mode, n=8):
    """The C``n`` TC5 Cartesian models of both packages in ``mode``
    (``backend='pallas_interpret'`` for JAX, ``'pallas'`` for the port,
    whose kernels run their plain versions on CPU tensors; halo 3 for
    PPM), and the port's perturbed, exchanged stage input with random
    corners."""
    scheme, limiter = MODES[mode]
    halo = 3 if scheme == "ppm" else 2
    jg = jax_build_grid(n, halo=halo, radius=EARTH_RADIUS, dtype=jnp.float32)
    jh, jv, jb = jic.williamson_tc5(jg, G, OM)
    jm = JaxSW(jg, gravity=G, omega=OM, b_ext=jb, scheme=scheme,
               limiter=limiter, backend="pallas_interpret")
    tg = build_grid(n, halo=halo, radius=EARTH_RADIUS, device="cpu")
    th, tv, tb = tic.williamson_tc5(tg, G, OM)
    tm = ShallowWater(tg, gravity=G, omega=OM, b_ext=tb, scheme=scheme,
                      limiter=limiter, backend="pallas")
    s0 = tm.initial_state(th, tv)
    rng = np.random.default_rng(4)
    yc = {k: _with_corners(tm.fill(x * torch.from_numpy(
        (1.0 + 1e-3 * rng.standard_normal(x.shape)).astype(np.float32))),
        halo, rng) for k, x in s0.items()}
    return jm, (jh, jv), tm, s0, yc


@pytest.mark.parametrize("mode", _mode_params())
def test_cartesian_plain_kernels_match_jax_interpret(mode):
    """B9 on the filled frames, and B10 and B11 as stage 3 with y0 = -2
    yc, in ``mode``: the tendencies within 1e-4 of their max of the JAX
    interpret kernels' and of a float64 evaluation."""
    jm, _, tm, _, yc = _cartesian(mode)
    n, h = tm.grid.n, tm.grid.halo
    scheme, limiter = MODES[mode]
    c = (n, h, float(tm.grid.dalpha), float(tm.grid.radius), G, OM)
    rhs = tm._pallas_rhs
    assert rhs.mode == mode
    rargs = (yc["h"], yc["v"], tm.b_ext)
    out = rhs(*rargs)
    jout = jsr.make_swe_rhs_pallas(*c, scheme=scheme, limiter=limiter,
                                   interpret=True)(*_jargs(rargs))
    exact = rhs.reference(*[t.double() for t in rargs])
    for name, x, y, r in zip(("dh", "dv"), jout, out, exact):
        errs = (_rel(x, y), _rel(r, y), _rel(r, x))
        assert max(errs) <= TENDENCY_TOL, ("B9", name, errs)

    a, b = tss.SSPRK3_COEFFS[2]
    neg = (-2.0 * yc["h"], -2.0 * yc["v"])
    ghosts = tss.make_strip_router(n, h, "cpu")(
        *(tss.raw_strips(yc["h"], n, h) + tss.raw_strips(yc["v"], n, h)))
    i = slice(h, h + n)
    for label, make, jmake, mid in (
            ("B10", tss.make_swe_stage_pallas, jss.make_swe_stage_pallas,
             (tm.b_ext,)),
            ("B11", tss.make_swe_stage_inkernel, jss.make_swe_stage_inkernel,
             (ghosts, tm.b_ext))):
        st = make(*c, DT, a, b, scheme=scheme, limiter=limiter, device="cpu")
        assert st.mode == mode
        args = neg + (yc["h"], yc["v"]) + mid
        out = st(*args)
        jout = jmake(*c, DT, a, b, scheme=scheme, limiter=limiter,
                     interpret=True)(*_jargs(args))
        exact = st.reference(*[tuple(g.double() for g in t)
                               if isinstance(t, tuple) else t.double()
                               for t in args])
        for name, x, y, r in zip(("h", "v"), jout, out, exact):
            x = np.asarray(x)[..., i, i]
            y, r = y[..., i, i].numpy(), r[..., i, i].numpy()
            assert np.max(np.abs(y)) > 0.0
            errs = (_rel(x, y), _rel(r, y), _rel(r, x))
            assert max(errs) <= TENDENCY_TOL, (label, name, errs)


@pytest.mark.parametrize("inkernel", [
    pytest.param(True, id="inkernel"),
    pytest.param(False, id="concat", marks=pytest.mark.slow)])
@pytest.mark.parametrize("mode", _mode_params({"ppm"}))
def test_fused_cartesian_step_matches_jax_interpret(mode, inkernel):
    """One fused Cartesian step in ``mode`` from the TC5 state against the
    JAX stepper: every carry field within 1e-6 of its max."""
    jm, (h, v), tm, _, _ = _cartesian(mode)
    jy = jm.extend_state(jm.initial_state(h, v), with_strips=inkernel)
    jy1 = jm.make_fused_step(DT, in_kernel_exchange=inkernel)(jy, 0.0)
    step = tm.make_fused_step(DT, in_kernel_exchange=inkernel)
    assert [st.mode for st in step.stages] == [mode] * 3
    ty1 = step(to_torch(jy, device="cpu"), 0.0)
    assert set(ty1) == set(jy1)
    for k, x in to_numpy(ty1).items():
        assert _rel(jy1[k], x) <= TOL, (k, _rel(jy1[k], x))


def _covariant(n, mode, dtype=torch.float32):
    scheme, limiter = MODES[mode]
    g = build_grid(n, halo=3 if scheme == "ppm" else 2, radius=EARTH_RADIUS,
                   dtype=dtype, device="cpu")
    h, v, b = tic.williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b, scheme=scheme,
                              limiter=limiter)
    return m, m.initial_state(h, v)


@pytest.mark.parametrize("mode", _mode_params(()))
def test_extended_step_matches_jax_interpret(mode):
    """One extended-carry covariant step (B8's plain version and the
    linear router, at halo 3 for PPM) against the JAX stepper: 1e-6.
    Slow in every mode: the fast tier holds the compact step against
    JAX's (``tests/test_torch_recon.py``) and the extended step against
    the compact one (below)."""
    scheme, limiter = MODES[mode]
    tm, _ = _covariant(8, mode)
    jg = jax_build_grid(8, halo=tm.grid.halo, radius=EARTH_RADIUS,
                       dtype=jnp.float32)
    h, v, b = jic.williamson_tc5(jg, G, OM)
    jm = JaxCov(jg, gravity=G, omega=OM, b_ext=b, scheme=scheme,
                limiter=limiter, backend="pallas_interpret")
    jy = jm.extend_state(jm.initial_state(h, v), with_strips=True)
    assert jy["strips"].shape == (6, 12 * tm.grid.halo, 8)
    jy1 = jm.make_fused_step(DT, compact=False)(jy, 0.0)
    step = tm.make_fused_step(DT, compact=False)
    assert [st.mode for st in step.stages] == [mode] * 3
    ty1 = step(to_torch(jy, device="cpu"), 0.0)
    assert set(ty1) == set(jy1) == {"h", "u", "strips"}
    for k, x in to_numpy(ty1).items():
        assert _rel(jy1[k], x) <= TOL, (k, _rel(jy1[k], x))


@pytest.mark.parametrize("mode", list(MODES))
def test_extended_matches_compact_in_each_mode(mode):
    """Three extended-carry steps against three compact ones at C16, the
    interiors and the strips: 1e-6 of max (bitwise predicted)."""
    m, s0 = _covariant(16, mode)
    n, h = m.grid.n, m.grid.halo
    step_e = m.make_fused_step(DT, compact=False)
    assert [type(st) for st in step_e.stages] == [tsc.CovStageInkernel] * 3
    yc, _ = integrate(m.make_fused_step(DT), m.compact_state(s0), 0.0, 3,
                      DT)
    ye, _ = integrate(step_e, m.extend_state(s0, with_strips=True), 0.0, 3,
                      DT)
    out = m.restrict_state(ye)
    ext = m.extend_state(m.restrict_state(yc))
    pairs = {"h": (yc["h"], out["h"]), "u": (yc["u"], out["u"]),
             "strips": (tsc.pack_strips_cov(ext["h"], ext["u"], n, h),
                        ye["strips"])}
    for k, (a, b) in pairs.items():
        assert _rel(a, b) <= TOL, (k, _rel(a, b))


def test_simulation_selects_inkernel_stepper_ppm(tmp_path):
    """A Cartesian config with ``backend: pallas``, ``scheme: ppm`` and
    ``halo: 3``: the port takes the in-kernel fused stepper (the JAX
    package's choice, ``jaxstream/simulation.py:248-295``) and its run
    equals that stepper under ``integrate`` with the run's segmentation
    (2-step segments, the history stride), bitwise."""
    cfg = {"grid": {"n": 8, "halo": 3, "dtype": "float32"},
           "model": {"name": "auto", "initial_condition": "tc5",
                     "backend": "pallas", "scheme": "ppm"},
           "time": {"dt": DT, "nsteps": 4},
           "parallelization": {"num_devices": 1},
           "io": {"history_path": str(tmp_path / "hist"),
                  "history_stride": 2}}
    jsim = JaxSim(dict(cfg, io={}))
    assert jsim._fused_step is not None
    assert not hasattr(jsim.model, "compact_state")
    sim = Simulation(cfg, device="cpu")
    assert sim.stepper_kind == "extended"
    assert isinstance(sim.model, ShallowWater) and sim.grid.halo == 3
    stages = sim._fused_step.stages
    assert [type(st) for st in stages] == [tss.SweStageInkernel] * 3
    assert [st.mode for st in stages] == ["ppm"] * 3
    m = sim.model
    y = {k: v.clone() for k, v in sim.state.items()}
    sim.run()
    step = m.make_fused_step(DT)
    t = 0.0
    for _ in range(2):
        ye, t = integrate(step, m.extend_state(y, with_strips=True), t, 2,
                          DT)
        y = m.restrict_state(ye)
    assert sim.step_count == 4
    for k in y:
        assert torch.equal(y[k], sim.state[k]), k
