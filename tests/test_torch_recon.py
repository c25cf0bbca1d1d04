"""Port parity: every reconstruction mode, from the operators up.

PLR with each limiter of ``LIMITERS`` and PPM (halo >= 3): the face
states, the finite-volume flux divergence, the classic covariant and
Cartesian right-hand sides, the two small models (tracer advection,
thermal diffusion) and their initial conditions, the halo-3 split strip
router, the plain versions of the compact stage (B1) and the unfused RHS
(B4) against the JAX kernels in interpret mode, one compact fused PPM
step, and the split del^4 stepper with PPM against the classic path.
Inputs are numpy arrays from a seed, fed to both packages.  Budgets:
float64 operators <= 1e-12 relative; float32 face states <= 2 ulp of
scale (XLA on the CPU may contract a*b + c*d); the stage's plain
version <= 1e-6 of each output's max (f32 op-order roundoff), the
unfused RHS's (a tendency alone, ill-conditioned in float32) <= 1e-4 of
it, as ``tests/test_torch_rhs_pallas.py`` holds it.
"""

import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

import jax.numpy as jnp

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.advection import TracerAdvection as JaxAdvection
from jaxstream.models.diffusion import ThermalDiffusion as JaxDiffusion
from jaxstream.models.shallow_water import ShallowWater as JaxSW
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.ops import fv as jfv
from jaxstream.ops import reconstruct as jrec
from jaxstream.ops.pallas import swe_cov as jcov
from jaxstream.parallel.halo import make_halo_exchanger as jax_halo
from jaxstream.physics import initial_conditions as jic

from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.models.advection import TracerAdvection
from jaxstream_torch.models.diffusion import ThermalDiffusion
from jaxstream_torch.models.shallow_water import ShallowWater
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops import fv as tfv
from jaxstream_torch.ops import reconstruct as trec
from jaxstream_torch.ops.cuda import swe_cov as tcov
from jaxstream_torch.parallel.halo import make_halo_exchanger
from jaxstream_torch.physics import initial_conditions as tic

F64_REL = 1e-12
EPS32 = float(np.finfo(np.float32).eps)
KERNEL_TOL = 1e-6
TENDENCY_TOL = 1e-4
G, OM = EARTH_GRAVITY, EARTH_OMEGA
LIMITERS = ["none", "minmod", "mc", "mc_sign", "vanleer"]
# (scheme, limiter) of every mode; PPM ignores the limiter.
MODES = [("plr", lim) for lim in LIMITERS] + [("ppm", "mc")]
MODE_IDS = LIMITERS + ["ppm"]
# The modes whose interpret-mode kernel parity runs in the fast tier; the
# other limiters' are slow (interpret mode is compile-heavy).
FAST_KERNEL_MODES = {"ppm", "vanleer"}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _within_ulps(a, b, ulps=2):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) <= ulps * EPS32 * float(
        np.max(np.abs(a)))


def _grids(n, halo, dtype=torch.float64):
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (jax_build_grid(n, halo=halo, radius=EARTH_RADIUS, dtype=jd),
            build_grid(n, halo=halo, radius=EARTH_RADIUS, dtype=dtype,
                       device="cpu"))


def _mode_param(kernel_parity=False):
    """The six modes as parameters; with ``kernel_parity`` the modes
    outside :data:`FAST_KERNEL_MODES` are marked slow."""
    out = []
    for (scheme, lim), mid in zip(MODES, MODE_IDS):
        marks = ([pytest.mark.slow] if kernel_parity
                 and mid not in FAST_KERNEL_MODES else [])
        out.append(pytest.param(scheme, lim, id=mid, marks=marks))
    return out


# ---- face states ----------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("scheme, limiter", _mode_param())
def test_face_states_match_jax(scheme, limiter, dtype):
    """Each limiter's PLR states and PPM's, along both axes, at halo 3."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((6, 16, 16)).astype(dtype)
    for axis in (-1, -2):
        if scheme == "ppm":
            j = jrec.ppm_face_states(jnp.asarray(q), axis, 3, 10)
            t = trec.ppm_face_states(torch.from_numpy(q), axis, 3, 10)
        else:
            j = jrec.plr_face_states(jnp.asarray(q), axis, 3, 10,
                                     limiter=limiter)
            t = trec.plr_face_states(torch.from_numpy(q), axis, 3, 10,
                                     limiter=limiter)
        assert t[0].dtype == torch.from_numpy(q).dtype
        for a, b in zip(j, t):
            a, b = np.asarray(a), b.numpy()
            if dtype == np.float64:
                assert _rel(a, b) <= F64_REL, (axis, _rel(a, b))
            else:
                assert _within_ulps(a, b), (axis, _rel(a, b))
        # pick_recon is the kernels' form of the same states.
        recon = trec.pick_recon(scheme, 3, 10, limiter)
        for x, y in zip(recon(torch.from_numpy(q), axis), t):
            assert torch.equal(x, y)


def test_limiter_table_matches_jax():
    assert list(trec.LIMITERS) == list(jrec.LIMITERS)


def test_ppm_needs_halo_3():
    """PPM at halo 2 raises the JAX package's ValueError, in the face
    states, the models and the kernel wrappers."""
    q = np.zeros((6, 12, 12))
    with pytest.raises(ValueError, match="PPM needs halo >= 3") as jerr:
        jrec.ppm_face_states(jnp.asarray(q), -1, 2, 8)
    with pytest.raises(ValueError, match="PPM needs halo >= 3") as terr:
        trec.ppm_face_states(torch.from_numpy(q), -1, 2, 8)
    assert str(terr.value) == str(jerr.value)
    jg, tg = _grids(8, 2)
    with pytest.raises(ValueError, match="halo >= 3") as jerr:
        JaxCov(jg, gravity=G, omega=OM, scheme="ppm")
    for model in (CovariantShallowWater, ShallowWater):
        with pytest.raises(ValueError, match="halo >= 3") as terr:
            model(tg, gravity=G, omega=OM, scheme="ppm")
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="halo >= 3"):
        TracerAdvection(tg, torch.zeros(3, 6, 12, 12), scheme="ppm")
    with pytest.raises(ValueError, match="PPM needs halo >= 3"):
        tcov.make_cov_stage_compact(8, 2, 0.1, 1.0, 9.8, 0.0, 1.0, 0.0, 1.0,
                                    scheme="ppm", device="cpu")
    with pytest.raises(ValueError, match="unknown limiter"):
        CovariantShallowWater(tg, gravity=G, omega=OM, limiter="superbee")


def _owed(kernel, scheme, limiter, n=8):
    """Build kernel ``kernel`` (a tier kernel, whose modes queue B owed
    until it took them) at C``n`` in the mode, with a JAX twin in
    interpret mode: ``(port, jax, grid)``."""
    h = _halo_of(scheme)
    jg, tg = _grids(n, h, torch.float32)
    c = (n, h, tg.dalpha, tg.radius, G, OM)
    kw = {"scheme": scheme, "limiter": limiter}
    make = {"B5": (tcov.make_cov_rhs_interior_local,
                   jcov.make_cov_rhs_interior_local),
            "B6": (tcov.make_cov_rhs_pallas_local,
                   jcov.make_cov_rhs_pallas_local)}[kernel]
    return (make[0](*c, device="cpu", **kw),
            make[1](*c, interpret=True, **kw), tg)


@pytest.mark.parametrize("kernel", ["B5", "B6"])
def test_owed_kernels_refuse_other_modes(kernel):
    """The tiers' block kernels, B5 and B6, no longer refuse a mode: each
    builds in every mode and names it, and under PPM at halo 3 the plain
    version of one face's block equals the JAX kernel in interpret mode
    on the filled frames of a seeded perturbation of TC5 (50 m of noise
    on h, 10% on u: TC5's balanced tendency cancels to ~1e-3 of its
    float32 max in a C8 core, in either package), within 1e-4 of the
    tendency's max (the budget of
    ``test_rhs_plain_matches_jax_interpret``)."""
    for (scheme, limiter), mode in zip(MODES, MODE_IDS):
        h = _halo_of(scheme)
        c = (8, h, 0.1, 1.0, G, OM)
        make = (tcov.make_cov_rhs_interior_local if kernel == "B5"
                else tcov.make_cov_rhs_pallas_local)
        assert make(*c, scheme=scheme, limiter=limiter,
                    device="cpu").mode == mode
    port, jrhs, tg = _owed(kernel, "ppm", "mc")
    th, tv, tb = tic.williamson_tc5(tg, G, OM)
    tm = CovariantShallowWater(tg, gravity=G, omega=OM, b_ext=tb,
                               scheme="ppm")
    s0 = tm.initial_state(th, tv)
    rng = np.random.default_rng(11)
    noise = lambda t: torch.from_numpy(
        rng.standard_normal(t.shape).astype(np.float32))
    he = tm.fill(s0["h"] + 50.0 * noise(s0["h"]))
    ue = tm._fill_u(s0["u"] * (1.0 + 0.1 * noise(s0["u"])))
    ssn, swe = tcov.sym_edge_normals(tg, ue)
    from jaxstream_torch.ops.cuda.swe_rhs import coord_rows

    n, h, f = tg.n, tg.halo, 1
    xr, xfr, yc, yfc, frames = coord_rows(n, h, "cpu")
    fz = frames[f:f + 1, None, :, 2].contiguous()
    if kernel == "B5":
        I = slice(h, h + n)
        args = (fz, xr[:, I], xfr[:, I], yc[I], yfc[I], he[f:f + 1, I, I],
                ue[:, f:f + 1, I, I], tm.b_ext[f:f + 1, I, I])
    else:
        args = (fz, xr, xfr, yc, yfc, he[f:f + 1], ue[:, f:f + 1],
                tm.b_ext[f:f + 1], ssn[f:f + 1], swe[f:f + 1])
    args = tuple(a.contiguous() for a in args)
    out = port(*args)
    jout = jrhs(*[jnp.asarray(a.numpy()) for a in args])
    for name, x, y in zip(("dh", "du"), jout, out):
        assert _rel(x, y.numpy()) <= TENDENCY_TOL, (name,
                                                    _rel(x, y.numpy()))


def _every_mode_kernel(kernel, scheme, limiter, halo=None):
    """Build kernel ``kernel`` (one that takes every mode) at C8 in the
    mode, at ``halo`` (default: 3 for PPM, else 2)."""
    from jaxstream_torch.experiments import swe_cov_nbr, swe_mega
    from jaxstream_torch.ops.cuda import swe_rhs as tsr
    from jaxstream_torch.ops.cuda import swe_step as tss

    h = _halo_of(scheme) if halo is None else halo
    g = build_grid(8, halo=h, radius=EARTH_RADIUS, dtype=torch.float32,
                   device="cpu")
    c = (8, h, g.dalpha, g.radius, G, OM)
    mode = {"scheme": scheme, "limiter": limiter}
    kw = dict(mode, device="cpu")
    return {
        "B3": lambda: tcov.make_cov_stage_refused_nu4(g, G, OM, 60.0, 1e14,
                                                      **kw),
        "B7": lambda: tcov.make_cov_stage_nu4(g, G, OM, 60.0, 0.0, 1.0,
                                              1e14, **kw)[0].__self__,
        "B8": lambda: tcov.make_cov_stage_inkernel(*c, 60.0, 0.0, 1.0, **kw),
        "B9": lambda: tsr.make_swe_rhs_pallas(*c, **kw),
        "B10": lambda: tss.make_swe_stage_pallas(*c, 60.0, 0.75, 0.25, **kw),
        "B11": lambda: tss.make_swe_stage_inkernel(*c, 60.0, 0.0, 1.0, **kw),
        "B12": lambda: swe_mega.make_fused_ssprk3_cov_mega(
            g, G, OM, 60.0, torch.zeros(6, 8 + 2 * h, 8 + 2 * h),
            **mode).kernel,
        "B13": lambda: swe_cov_nbr.make_cov_stage_nbr(g, G, OM, 60.0, 0.0,
                                                      1.0, **mode),
    }[kernel]()


@pytest.mark.parametrize("kernel", ["B3", "B7", "B8", "B9", "B10", "B11",
                                    "B12", "B13"])
def test_kernels_take_every_mode(kernel):
    """B3, B7 (kernel A), B12 and B13 (off the owed list since they take
    every mode), B8 and the Cartesian kernels build in each mode and name
    it; PPM below halo 3 raises the JAX package's ValueError."""
    for (scheme, limiter), mode in zip(MODES, MODE_IDS):
        assert _every_mode_kernel(kernel, scheme, limiter).mode == mode
    with pytest.raises(ValueError, match="PPM needs halo >= 3"):
        _every_mode_kernel(kernel, "ppm", "mc", halo=2)


# ---- operators and classic right-hand sides --------------------------------


@pytest.mark.parametrize("scheme, limiter", _mode_param())
def test_flux_divergence_matches_jax(scheme, limiter):
    """``flux_divergence`` at halo 3, float64, against JAX; and it
    conserves mass as ``tests/test_ops.py`` checks it."""
    jg, tg = _grids(8, 3)
    rng = np.random.default_rng(1)
    q_int = rng.random((6, 8, 8))
    jq = jax_halo(8, 3)(jfv.embed_interior(jg, jnp.asarray(q_int)))
    tq = make_halo_exchanger(8, 3)(tfv.embed_interior(tg,
                                                      torch.from_numpy(q_int)))
    jv = jic.solid_body_wind(jg, 1.0, 0.7)
    tv = tic.solid_body_wind(tg, 1.0, 0.7)
    jd = jfv.flux_divergence(jg, jq, jv, scheme=scheme, limiter=limiter)
    td = tfv.flux_divergence(tg, tq, tv, scheme=scheme, limiter=limiter)
    assert _rel(jd, td.numpy()) <= F64_REL
    area = tg.interior(tg.area)
    tot = float(torch.sum(td * area))
    scale = float(torch.sum(torch.abs(td) * area))
    assert abs(tot) < 1e-12 * scale


@pytest.mark.parametrize("model", ["covariant", "cartesian"])
def test_classic_rhs_ppm_matches_jax(model):
    """The classic ``rhs`` with PPM at halo 3 (``backend='jnp'``), float64,
    on the TC5 state, against JAX's jnp path."""
    jg, tg = _grids(8, 3)
    jh, jv, jb = jic.williamson_tc5(jg, G, OM)
    th, tv, tb = tic.williamson_tc5(tg, G, OM)
    J, T = (JaxCov, CovariantShallowWater) if model == "covariant" else (
        JaxSW, ShallowWater)
    jm = J(jg, gravity=G, omega=OM, b_ext=jb, scheme="ppm")
    tm = T(tg, gravity=G, omega=OM, b_ext=tb, scheme="ppm")
    jd = jm.rhs(jm.initial_state(jh, jv), 0.0)
    td = tm.rhs(tm.initial_state(th, tv), 0.0)
    for k in jd:
        assert _rel(jd[k], td[k].numpy()) <= F64_REL, (k, _rel(jd[k], td[k]))


# ---- initial conditions and the two small models ---------------------------


@pytest.mark.parametrize("ic", ["cosine_bell", "checkerboard",
                                "williamson_tc6"])
def test_initial_conditions_bitwise(ic):
    jg, tg = _grids(8, 3)
    args = (G, OM) if ic == "williamson_tc6" else ()
    j = getattr(jic, ic)(jg, *args)
    t = getattr(tic, ic)(tg, *args)
    j, t = (j, t) if isinstance(j, tuple) else ((j,), (t,))
    for a, b in zip(j, t):
        assert b.dtype == torch.float64
        assert np.array_equal(np.asarray(a), b.numpy())


def _jax_steps(model, state, nsteps, dt):
    """``nsteps`` SSPRK3 steps of a JAX model, one jitted step at a time
    (its ``run`` compiles the whole loop: seconds more per test, the
    same state for an autonomous rhs)."""
    import jax

    step = jax.jit(model.make_step(dt))
    for k in range(nsteps):
        state = step(state, k * dt)
    return state


@pytest.mark.parametrize("scheme", ["ppm", "plr"])
def test_tracer_advection_matches_jax(scheme):
    """TC1 (the cosine bell in a tilted solid-body wind), 4 SSPRK3 steps,
    float64."""
    jg, tg = _grids(8, 3)
    u0 = 2 * np.pi * EARTH_RADIUS / (12 * 86400)
    jm = JaxAdvection(jg, jic.solid_body_wind(jg, u0, 0.7), scheme=scheme)
    tm = TracerAdvection(tg, tic.solid_body_wind(tg, u0, 0.7), scheme=scheme)
    dt = 3600.0
    jy = _jax_steps(jm, jm.initial_state(jic.cosine_bell(jg)), 4, dt)
    ty, _ = tm.run(tm.initial_state(tic.cosine_bell(tg)), 4, dt)
    assert _rel(jy["q"], ty["q"].numpy()) <= F64_REL


def test_thermal_diffusion_matches_jax():
    """The checkerboard heat source, 4 SSPRK3 steps, float64."""
    jg, tg = _grids(8, 2)
    kappa, dt = 1.0e5, 600.0
    jm, tm = JaxDiffusion(jg, kappa), ThermalDiffusion(tg, kappa)
    jy = _jax_steps(jm, jm.initial_state(jic.checkerboard(jg)), 4, dt)
    ty, _ = tm.run(tm.initial_state(tic.checkerboard(tg)), 4, dt)
    assert _rel(jy["T"], ty["T"].numpy()) <= F64_REL


# ---- the halo-3 strip route ------------------------------------------------


def test_split_router_halo3_matches_jax():
    """The (6, 6h+2, n) strips at halo 3 (20 rows): h's ghost blocks
    bitwise, the rotated u blocks and the prescaled sym rows within 2
    float32 ulp of their scale (``tests/test_torch_router.py``'s budget
    at halo 2)."""
    n, h = 8, 3
    jg, tg = _grids(n, h, torch.float32)
    rng = np.random.default_rng(9)
    sn = rng.standard_normal((6, 6 * h, n)).astype(np.float32)
    we = rng.standard_normal((6, n, 6 * h)).astype(np.float32)
    jgsn, jgwe = jcov.make_cov_strip_router_split(jg, prescale_sym=True)(
        jnp.asarray(sn), jnp.asarray(we))
    tgsn, tgwe = tcov.make_cov_strip_router_split(tg)(
        torch.from_numpy(sn), torch.from_numpy(we))
    jgsn, jgwe, tgsn, tgwe = (np.asarray(jgsn), np.asarray(jgwe),
                              tgsn.numpy(), tgwe.numpy())
    assert jgsn.shape == tgsn.shape == (6, 6 * h + 2, n)
    assert jgwe.shape == tgwe.shape == (6, n, 6 * h + 2)
    assert np.array_equal(jgsn[:, :2 * h], tgsn[:, :2 * h])
    assert np.array_equal(jgwe[:, :, :2 * h], tgwe[:, :, :2 * h])
    for fi in (1, 2):
        blk = slice(fi * 2 * h, (fi + 1) * 2 * h)
        assert _within_ulps(jgsn[:, blk], tgsn[:, blk]), fi
        assert _within_ulps(jgwe[:, :, blk], tgwe[:, :, blk]), fi
    assert _within_ulps(jgsn[:, 6 * h:], tgsn[:, 6 * h:])
    assert _within_ulps(jgwe[:, :, 6 * h:], tgwe[:, :, 6 * h:])
    # The pack at halo 3 too.
    hi = rng.standard_normal((6, n, n)).astype(np.float32)
    ui = rng.standard_normal((2, 6, n, n)).astype(np.float32)
    j = jcov.pack_strips_cov_split(jnp.asarray(hi), jnp.asarray(ui), n, h)
    t = tcov.pack_strips_cov_split(torch.from_numpy(hi),
                                   torch.from_numpy(ui), n, h)
    for a, b in zip(j, t):
        assert np.array_equal(np.asarray(a), b.numpy())


# ---- the kernels' plain versions against the JAX kernels -------------------


def _halo_of(scheme):
    return 3 if scheme == "ppm" else 2


def _stage_inputs(n, halo, seed=11):
    """The TC5 state at halo ``halo``, a perturbed current stage and its
    routed ghosts (float32)."""
    tg = build_grid(n, halo=halo, radius=EARTH_RADIUS, dtype=torch.float32,
                    device="cpu")
    th, tv, tb = tic.williamson_tc5(tg, G, OM)
    tm = CovariantShallowWater(tg, gravity=G, omega=OM, b_ext=tb)
    s0 = tm.initial_state(th, tv)
    rng = np.random.default_rng(seed)
    yc = {k: (v * torch.from_numpy(
        (1.0 + 1e-3 * rng.standard_normal(v.shape)).astype(np.float32)))
        .contiguous() for k, v in s0.items()}
    sn, we = tcov.pack_strips_cov_split(yc["h"], yc["u"], n, halo)
    gsn, gwe = tcov.make_cov_strip_router_split(tg)(sn, we)
    return tg, tm, s0, yc, gsn, gwe


@pytest.mark.parametrize("scheme, limiter", _mode_param(kernel_parity=True))
def test_stage_plain_matches_jax_interpret(scheme, limiter):
    """B1's plain version in each mode (stage 2, the y0 form) against
    ``make_cov_stage_compact`` in interpret mode, <= 1e-6 of max."""
    n, h = 8, _halo_of(scheme)
    a, b = tcov.SSPRK3_COEFFS[1]
    tg, tm, s0, yc, gsn, gwe = _stage_inputs(n, h)
    stage = tcov.make_cov_stage_compact(
        n, h, tg.dalpha, tg.radius, G, OM, 600.0, a, b, scheme=scheme,
        limiter=limiter, device="cpu")
    jstage = jcov.make_cov_stage_compact(
        n, h, float(tg.dalpha), float(tg.radius), G, OM, 600.0, a, b,
        scheme=scheme, limiter=limiter, interpret=True, sym_prescaled=True)
    args = [s0["h"], s0["u"], yc["h"], yc["u"], gsn, gwe, tm.b_ext]
    out = stage(*args)
    jout = jstage(*[jnp.asarray(t.numpy()) for t in args])
    for name, x, y in zip(("h", "u", "strips_sn", "strips_we"), jout, out):
        assert tuple(x.shape) == tuple(y.shape), name
        assert _rel(x, y.numpy()) <= KERNEL_TOL, (name, _rel(x, y.numpy()))


@pytest.mark.parametrize("scheme, limiter", _mode_param(kernel_parity=True))
def test_rhs_plain_matches_jax_interpret(scheme, limiter):
    """B4's plain version in each mode (six faces) against
    ``make_cov_rhs_pallas`` in interpret mode on the filled TC5 frames.
    Its outputs are the tendency alone, whose float32 evaluations differ
    by ~1e-6 to 1e-5 of its max (the flux differences cancel): both are
    held to 1e-4 of it against each other and against a float64
    evaluation of the plain version, as ``tests/test_torch_rhs_pallas.py``
    holds the MC form."""
    n, h = 8, _halo_of(scheme)
    jg, tg = _grids(n, h, torch.float32)
    th, tv, tb = tic.williamson_tc5(tg, G, OM)
    tm = CovariantShallowWater(tg, gravity=G, omega=OM, b_ext=tb)
    s0 = tm.initial_state(th, tv)
    he, ue = tm.fill(s0["h"]), tm._fill_u(s0["u"])
    rhs = tcov.make_cov_rhs_pallas(tg, G, OM, scheme=scheme, limiter=limiter)
    jrhs = jcov.make_cov_rhs_pallas(jg, G, OM, scheme=scheme,
                                    limiter=limiter, interpret=True)
    out = rhs(he, ue, tm.b_ext)
    jout = jrhs(*[jnp.asarray(t.numpy()) for t in (he, ue, tm.b_ext)])
    kern = rhs.kernel
    exact = kern.reference(kern.fz[:, None].double(), he.double(),
                           ue.double(), tm.b_ext.double(),
                           *[t.double() for t in rhs.sym(ue)])
    for name, x, y, r in zip(("dh", "du"), jout, out, exact):
        errs = (_rel(x, y.numpy()), _rel(r, y.numpy()), _rel(r, x))
        assert max(errs) <= TENDENCY_TOL, (name, errs)


def test_one_compact_ppm_step_matches_jax_interpret_stepper():
    """One compact fused step with PPM at halo 3 against the JAX compact
    stepper under ``backend='pallas_interpret'``, <= 1e-6 of max."""
    n, dt = 8, 600.0
    jg, tg = _grids(n, 3, torch.float32)
    jh, jv, jb = jic.williamson_tc5(jg, G, OM)
    th, tv, tb = tic.williamson_tc5(tg, G, OM)
    jm = JaxCov(jg, gravity=G, omega=OM, b_ext=jb, scheme="ppm",
                backend="pallas_interpret")
    tm = CovariantShallowWater(tg, gravity=G, omega=OM, b_ext=tb,
                               scheme="ppm")
    jy = jm.make_fused_step(dt)(jm.compact_state(jm.initial_state(jh, jv)),
                                0.0)
    ty = tm.make_fused_step(dt)(tm.compact_state(tm.initial_state(th, tv)),
                                0.0)
    for k in ("h", "u", "strips_sn", "strips_we"):
        assert _rel(jy[k], ty[k].numpy()) <= KERNEL_TOL, (k, _rel(jy[k],
                                                                  ty[k]))


def test_split_nu4_ppm_tracks_classic():
    """Two split-del^4 compact steps with PPM at halo 3 against two
    classic steps (PPM, ``fill(lap(fill(lap)))``): <= 5e-4 of max, the
    JAX package's budget (``tests/test_cov_swe.py:565``)."""
    n, dt, nu4 = 12, 300.0, 1.0e15
    tg = build_grid(n, halo=3, radius=EARTH_RADIUS, dtype=torch.float32,
                    device="cpu")
    m = CovariantShallowWater(tg, gravity=G, omega=OM, nu4=nu4,
                              scheme="ppm")
    s0 = m.initial_state(*tic.galewsky(tg, G, OM))
    ref, _ = m.run(s0, 2, dt)
    step = m.make_fused_step(dt)
    assert [st.mode for st in step.stages] == ["ppm"] * 3
    y = m.compact_state(s0)
    for _ in range(2):
        y = step(y, 0.0)
    out = m.restrict_state(y)
    for k in ("h", "u"):
        assert _rel(ref[k], out[k].numpy()) <= 5e-4, (k, _rel(ref[k],
                                                              out[k]))
