"""Port parity: the Cartesian-velocity ``ShallowWater`` model, its
operators, exchangers and the classic RHS under ``backend='pallas'``.

The same inputs (the ICs at C8-C48 built by both packages, or arrays
from a numpy seed) go through the JAX package and the port.  Budgets:

* ``_face_normal_velocity``, ``flux_divergence`` (both
  ``conservative_edges``), ``gradient``, ``vorticity``,
  ``kinetic_energy`` at float64: 1e-12 of each output's max;
* ``canonicalize_strip``, ``place_strip``, ``make_concat_exchanger``:
  bitwise (data movement and the same corner averages);
* ``ShallowWater.rhs`` on ``backend='jnp'`` at float64 (TC2, TC5 and the
  Galewsky jet with nu4 = 1e14): 1e-12;
* the plain RHS kernel ``swe_rhs_reference`` against the JAX kernel
  ``make_swe_rhs_pallas(interpret=True)`` on the same filled inputs:
  1e-4 of each tendency's max, and each side as near a float64
  evaluation as the other (the tendency's flux differences cancel in
  float32: two f32 evaluations differ by ~1e-5 of its max);
* the kernel-backed classic ``rhs`` against the torch one at C16: 5e-5 of
  max, the JAX package's budget (``tests/test_pallas_rhs.py:42``); at
  C48 against float64: no farther than the JAX kernel, plus 5e-5;
* the Williamson TC2 24 h L2 height error against the JAX package's on
  the same configuration: 1e-6 relative (float64), and the C48 figure of
  DESIGN.md's validation evidence, ~1.1e-3.
"""

import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

import jax.numpy as jnp

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water import ShallowWater as JaxSW
from jaxstream.ops import fv as jfv
from jaxstream.ops.pallas import swe_rhs as jsr
from jaxstream.parallel import halo as jhalo
from jaxstream.physics import initial_conditions as jic
from jaxstream.utils.diagnostics import error_norms as jax_error_norms

from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.interop import to_numpy, to_torch
from jaxstream_torch.models.shallow_water import ShallowWater
from jaxstream_torch.ops import fv as tfv
from jaxstream_torch.ops.cuda import swe_rhs as tsr
from jaxstream_torch.parallel import halo as thalo
from jaxstream_torch.physics import initial_conditions as tic
from jaxstream_torch.utils.diagnostics import error_norms

G, OM = EARTH_GRAVITY, EARTH_OMEGA
F64_TOL = 1e-12
TENDENCY_TOL = 1e-4
CLASSIC_TOL = 5e-5


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _T(a):
    return to_torch(a, device="cpu")


def _ics(pkg, grid, ic):
    """``(h_ext, v_ext, b_ext or None)`` of ``ic`` from ``pkg`` (the JAX
    package's or the port's initial_conditions)."""
    if ic == "tc5":
        return pkg.williamson_tc5(grid, G, OM)
    if ic == "tc2":
        return pkg.williamson_tc2(grid, G, OM) + (None,)
    return pkg.galewsky(grid, G, OM) + (None,)


@pytest.fixture(scope="module")
def f64_c8():
    """TC5 at C8 in float64: both grids and the JAX model's filled
    extended fields, as JAX arrays and as tensors."""
    jg = jax_build_grid(8, halo=2, radius=EARTH_RADIUS, dtype=jnp.float64)
    tg = build_grid(8, halo=2, radius=EARTH_RADIUS, dtype=torch.float64,
                    device="cpu")
    h, v, b = jic.williamson_tc5(jg, G, OM)
    jm = JaxSW(jg, gravity=G, omega=OM, b_ext=b)
    s = jm.initial_state(h, v)
    jargs = (jm.fill(s["h"]), jm.fill(s["v"]), jm.b_ext)
    return jg, tg, jargs, tuple(_T(a) for a in jargs)


def test_fv_operators_match_jax_f64(f64_c8):
    jg, tg, (jh, jv, jb), (th, tv, tb) = f64_c8
    pairs = list(zip(jfv._face_normal_velocity(jg, jv),
                     tfv._face_normal_velocity(tg, tv)))
    for cons in (False, True):
        pairs.append((jfv.flux_divergence(jg, jh, jv,
                                          conservative_edges=cons),
                      tfv.flux_divergence(tg, th, tv,
                                          conservative_edges=cons)))
    bern_j = G * (jh + jb) + jfv.kinetic_energy(jv)
    bern_t = G * (th + tb) + tfv.kinetic_energy(tv)
    pairs += [(jfv.gradient(jg, bern_j), tfv.gradient(tg, bern_t)),
              (jfv.vorticity(jg, jv), tfv.vorticity(tg, tv)),
              (jfv.kinetic_energy(jv), tfv.kinetic_energy(tv))]
    for k, (x, y) in enumerate(pairs):
        assert np.asarray(x).shape == tuple(y.shape), k
        assert _rel(x, y.numpy()) <= F64_TOL, (k, _rel(x, y.numpy()))
    # conservative_edges changes the seam fluxes by roundoff only here
    # (value-exact ghost copies), but does run the symmetrization.
    assert _rel(pairs[2][1], pairs[3][1]) < 1e-12


def test_strip_transforms_and_concat_exchanger_bitwise():
    rng = np.random.default_rng(11)
    n, h = 8, 2
    m = n + 2 * h
    for e in range(4):
        raw = rng.standard_normal((3, h, n) if e < 2 else (3, n, h))
        strip = rng.standard_normal((3, h, n))
        assert np.array_equal(np.asarray(jhalo.canonicalize_strip(e, raw)),
                              thalo.canonicalize_strip(e, _T(raw)).numpy())
        assert np.array_equal(np.asarray(jhalo.place_strip(e, strip)),
                              thalo.place_strip(e, _T(strip)).numpy())
    field = rng.standard_normal((3, 6, m, m)).astype(np.float32)
    ref = jhalo.make_concat_exchanger(n, h)(jnp.asarray(field))
    out = thalo.make_concat_exchanger(n, h)(_T(field))
    assert np.array_equal(np.asarray(ref), out.numpy())
    # Value for value the scatter exchanger's exchange.
    assert np.array_equal(
        np.asarray(jhalo.make_halo_exchanger(n, h)(jnp.asarray(field))),
        thalo.make_concat_exchanger(n, h)(_T(field)).numpy())


def _both(ic, n, dtype_j, dtype_t, **kw):
    """The JAX and the port's ``ShallowWater`` on ``ic`` at C``n``, and
    each one's initial state."""
    jg = jax_build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=dtype_j)
    tg = build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=dtype_t,
                    device="cpu")
    jh, jv, jb = _ics(jic, jg, ic)
    th, tv, tb = _ics(tic, tg, ic)
    jm = JaxSW(jg, gravity=G, omega=OM, b_ext=jb, **kw)
    tm = ShallowWater(tg, gravity=G, omega=OM, b_ext=tb, **kw)
    return jm, tm, jm.initial_state(jh, jv), tm.initial_state(th, tv)


@pytest.mark.parametrize("ic, nu4", [("tc2", 0.0), ("tc5", 0.0),
                                     ("galewsky", 1.0e14)])
def test_jnp_rhs_matches_jax_f64(ic, nu4):
    jm, tm, js, ts = _both(ic, 8, jnp.float64, torch.float64, nu4=nu4)
    for k, v in ts.items():
        assert np.array_equal(np.asarray(js[k]), v.numpy()), k
    jd, td = jm.rhs(js, 0.0), tm.rhs(ts, 0.0)
    for k in ("h", "v"):
        assert _rel(jd[k], td[k].numpy()) <= F64_TOL, (k, _rel(jd[k],
                                                               td[k]))


@pytest.mark.parametrize("ic", ["tc5", "tc2"])
def test_plain_rhs_kernel_matches_jax_interpret(ic):
    jg = jax_build_grid(8, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    tg = build_grid(8, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = _ics(jic, jg, ic)
    jm = JaxSW(jg, gravity=G, omega=OM, b_ext=b)
    s = jm.initial_state(h, v)
    # A perturbed state: TC5's and TC2's winds have exactly zero terms.
    rng = np.random.default_rng(2)
    s = {k: x * (1.0 + 1e-3 * rng.standard_normal(x.shape)).astype(
        np.float32) for k, x in s.items()}
    jargs = (jm.fill(s["h"]), jm.fill(s["v"]), jm.b_ext)
    targs = tuple(_T(a) for a in jargs)
    rhs = tsr.make_swe_rhs_pallas(8, 2, tg.dalpha, tg.radius, G, OM,
                                  device="cpu")
    before = tsr.SweRhs.launches
    out = rhs(*targs)
    assert tsr.SweRhs.launches == before                # plain: no launch
    jout = jsr.make_swe_rhs_pallas(8, 2, float(jg.dalpha), float(jg.radius),
                                   G, OM, interpret=True)(*jargs)
    exact = rhs.reference(*[a.double() for a in targs])
    for name, x, y, r in zip(("dh", "dv"), jout, out, exact):
        assert tuple(y.shape) == np.asarray(x).shape, name
        errs = (_rel(x, y.numpy()), _rel(r, y.numpy()), _rel(r, x))
        assert max(errs) <= TENDENCY_TOL, (name, errs)


@pytest.mark.parametrize("ic", ["tc2", "tc5"])
def test_pallas_backend_rhs_matches_jnp(ic):
    """The JAX package's ``test_rhs_parity`` on the port: C16, float32."""
    tg = build_grid(16, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = _ics(tic, tg, ic)
    ref = ShallowWater(tg, gravity=G, omega=OM, b_ext=b)
    pal = ShallowWater(tg, gravity=G, omega=OM, b_ext=b, backend="pallas")
    s = ref.initial_state(h, v)
    d_ref, d_pal = ref.rhs(s, 0.0), pal.rhs(s, 0.0)
    for k in ("h", "v"):
        assert _rel(d_ref[k], d_pal[k]) <= CLASSIC_TOL, (k, _rel(d_ref[k],
                                                                d_pal[k]))


def test_pallas_backend_hyperdiffusion_order():
    """With nu4 > 0 the kernel branch projects the del^4 term alone before
    adding it, the jnp branch projects the whole tendency: both as in the
    JAX package, so the two differ by roundoff only."""
    tg = build_grid(8, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v = tic.galewsky(tg, G, OM)
    ref = ShallowWater(tg, gravity=G, omega=OM, nu4=1.0e15)
    pal = ShallowWater(tg, gravity=G, omega=OM, nu4=1.0e15,
                       backend="pallas")
    s = ref.initial_state(h, v)
    d_ref, d_pal = ref.rhs(s, 0.0), pal.rhs(s, 0.0)
    d0 = ShallowWater(tg, gravity=G, omega=OM, backend="pallas").rhs(s, 0.0)
    for k in ("h", "v"):
        assert _rel(d_ref[k], d_pal[k]) <= CLASSIC_TOL, k
        assert not torch.equal(d0[k], d_pal[k]), k


def test_backends_and_refusals():
    tg = build_grid(8, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = tic.williamson_tc5(tg, G, OM)
    pal = ShallowWater(tg, gravity=G, omega=OM, b_ext=b, backend="pallas")
    interp = ShallowWater(tg, gravity=G, omega=OM, b_ext=b,
                          backend="pallas_interpret")
    assert interp._pallas_rhs.interpret and not pal._pallas_rhs.interpret
    s = pal.initial_state(h, v)
    d_pal, d_int = pal.rhs(s, 0.0), interp.rhs(s, 0.0)
    for k in ("h", "v"):
        assert torch.equal(d_pal[k], d_int[k]), k
    jnp_model = ShallowWater(tg, gravity=G, omega=OM)
    assert jnp_model._pallas_rhs is None
    with pytest.raises(ValueError, match="pallas"):
        jnp_model.make_fused_step(60.0)
    hyper = ShallowWater(tg, gravity=G, omega=OM, nu4=1e12,
                         backend="pallas_interpret")
    with pytest.raises(ValueError, match="nu4"):
        hyper.make_fused_step(60.0)
    # The kernels build and step in every reconstruction (PPM at halo 3),
    # each kernel-backed form as near the torch one as the MC form's.
    g3 = build_grid(8, halo=3, device="cpu")
    h3, v3, b3 = tic.williamson_tc5(g3, G, OM)
    for scheme, lim in [("plr", m) for m in ("none", "minmod", "mc_sign",
                                             "vanleer")] + [("ppm", "mc")]:
        gm, (hm, vm, bm) = (g3, (h3, v3, b3)) if scheme == "ppm" else (
            tg, (h, v, b))
        mode = "ppm" if scheme == "ppm" else lim
        ref = ShallowWater(gm, gravity=G, omega=OM, b_ext=bm, scheme=scheme,
                           limiter=lim)
        sm = ref.initial_state(hm, vm)
        for be in ("pallas", "pallas_interpret"):
            m = ShallowWater(gm, gravity=G, omega=OM, b_ext=bm,
                             scheme=scheme, limiter=lim, backend=be)
            assert m._pallas_rhs.mode == mode
            d, dr = m.rhs(sm, 0.0), ref.rhs(sm, 0.0)
            for k in ("h", "v"):
                assert _rel(dr[k], d[k]) <= CLASSIC_TOL, (mode, be, k)
            for ink in (True, False):
                step = m.make_fused_step(60.0, in_kernel_exchange=ink)
                assert [st.mode for st in step.stages] == [mode] * 3
                y = step(m.extend_state(sm, with_strips=ink), 0.0)
                assert bool(torch.isfinite(y["h"]).all()), (mode, be, ink)
    with pytest.raises(ValueError, match="halo >= 3"):
        tsr.make_swe_rhs_pallas(8, 2, tg.dalpha, tg.radius, G, OM,
                                scheme="ppm", device="cpu")
    with pytest.raises(ValueError, match="unknown limiter"):
        tsr.make_swe_rhs_pallas(8, 2, tg.dalpha, tg.radius, G, OM,
                                limiter="superbee", device="cpu")
    g64 = build_grid(8, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        ShallowWater(g64, gravity=G, omega=OM, backend="pallas")


def test_cartesian_carries_cross_interop_bitwise():
    jm, tm, js, ts = _both("tc5", 8, jnp.float32, torch.float32,
                           backend="pallas_interpret")
    carries = [jm.initial_state(*_ics(jic, jm.grid, "tc5")[:2]),
               jm.extend_state(js), jm.extend_state(js, with_strips=True)]
    want = [{"h", "v"}, {"h", "v"},
            {"h", "v", "sh_sn", "sh_we", "sv_sn", "sv_we"}]
    for y, keys in zip(carries, want):
        assert set(y) == keys
        back = to_numpy(to_torch(y, device="cpu"))
        for k, v in y.items():
            v = np.asarray(v)
            assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    # The port's own carries have the JAX package's keys and values.
    ty = tm.extend_state(ts, with_strips=True)
    for k, v in to_numpy(ty).items():
        assert np.array_equal(np.asarray(carries[2][k]), v), k
    back = tm.restrict_state(ty)
    for k in ("h", "v"):
        assert torch.equal(back[k], ts[k]) and back[k].is_contiguous(), k


def rhs_precision(n):
    """Distance from float64 (max abs diff / max, TC5 at C``n``) of the
    float32 tendencies of the JAX package's jnp rhs, of its Pallas RHS
    kernel in interpret mode, and of the port's plain RHS kernel, each
    against a float64 evaluation of the JAX jnp rhs on the same state.

    Run as a script (``python tests/test_torch_swe_cartesian.py 384``) it
    prints them at C``n``: ``chip_smoke.py`` phase 19 holds the port's
    kernel-backed rhs on the card to the reference kernel's C384 figures.
    """
    jm, tm, js, ts = _both("tc5", n, jnp.float32, torch.float32)
    g64 = jax_build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=jnp.float64)
    b64 = jic.williamson_tc5(g64, G, OM)[2]
    d64 = JaxSW(g64, gravity=G, omega=OM, b_ext=b64).rhs(
        {k: jnp.asarray(np.asarray(x), jnp.float64) for k, x in js.items()},
        0.0)
    d_jnp = jm.rhs(js, 0.0)
    d_ker = jsr.make_swe_rhs_pallas(
        n, 2, float(jm.grid.dalpha), float(jm.grid.radius), G, OM,
        interpret=True)(jm.fill(js["h"]), jm.fill(js["v"]), jm.b_ext)
    d_port = ShallowWater(tm.grid, gravity=G, omega=OM, b_ext=tm.b_ext,
                          backend="pallas").rhs(ts, 0.0)
    return {k: {"jnp": _rel(d64[k], d_jnp[k]), "jax_kernel":
                _rel(d64[k], d_ker[i]), "port_kernel": _rel(d64[k],
                                                            d_port[k])}
            for i, k in enumerate(("h", "v"))}


def test_rhs_kernel_precision_matches_reference_kernel():
    """The kernels rebuild the metric in float32 from closed forms (the
    general basis, with its 2x2 determinant): their tendencies are
    farther from float64 than the jnp path's, whose metric is stored
    from float64 (C48: about twice as far in h).  The port's kernel is
    held to the reference kernel's distance, plus the JAX package's 5e-5
    (the rule of ``chip_smoke.py`` phase 19)."""
    d = rhs_precision(48)
    assert d["h"]["jax_kernel"] > 1.5 * d["h"]["jnp"], d
    for k in ("h", "v"):
        ref = max(d[k]["jnp"], d[k]["jax_kernel"])
        assert d[k]["port_kernel"] <= ref + CLASSIC_TOL, (k, d)


def _tc2_l2(n, nsteps=144, dt=600.0):
    """The 24 h TC2 L2 height error of both packages at C``n``, float64
    (``tests/test_models.py::test_swe_tc2_steady_state``'s setup)."""
    jm, tm, js, ts = _both("tc2", n, jnp.float64, torch.float64)
    jout, _ = jm.run(js, nsteps, dt)
    tout, _ = tm.run(ts, nsteps, dt)
    jerr = {k: float(v) for k, v in
            jax_error_norms(jm.grid, jout["h"], js["h"]).items()}
    terr = {k: float(v) for k, v in
            error_norms(tm.grid, tout["h"], ts["h"]).items()}
    return jerr, terr


def test_tc2_error_norms_match_jax_c24():
    jerr, terr = _tc2_l2(24)
    for k in ("l1", "l2", "linf"):
        assert abs(terr[k] - jerr[k]) <= 1e-6 * jerr[k], (k, terr, jerr)
    assert 1e-3 < terr["l2"] < 1e-2, terr


def test_tc2_c48_24h_l2_height_error():
    """DESIGN.md's validation evidence: TC2 at C48 after 24 h, L2 height
    error ~1.1e-3, here from both packages."""
    jerr, terr = _tc2_l2(48)
    assert abs(terr["l2"] - jerr["l2"]) <= 1e-6 * jerr["l2"], (terr, jerr)
    assert 1.0e-3 <= terr["l2"] <= 1.2e-3, terr


if __name__ == "__main__":
    import sys

    for k, row in rhs_precision(int(sys.argv[1])).items():
        print(k, ", ".join(f"{name} {x:.4e}" for name, x in row.items()))
