"""Port parity: the stage precision policy, the 16-bit carry encodings
and ``temporal_block`` on the compact covariant main path.

Inputs: TC5 / TC2 states at C8 and C24 from both packages' initial
conditions (bitwise equal) and numpy-seeded perturbations, handed across
as numpy.  Tolerances, and where they come from:

* ``jaxstream_torch.ops.cuda.precision`` against
  ``jaxstream.ops.pallas.precision``: resolve semantics, error messages,
  ``encode_strips``, ``strip_dtype_bytes``, ``mixed16_encoding``: equal.
* The bf16 PLR face states (``slope_dtype``) in each limiter: bitwise
  (measured at C8: this XLA rounds every bfloat16 op, as PyTorch does).
* The bf16 router at C8: the h ghost rows (a pure gather) bitwise; the
  rotated u rows and the sym rows within one bf16 ulp of each value for
  bf16 strips (measured 0), within 1e-6 of their max for f32 strips
  (measured 1.8e-7 in the sym rows, the f32 router's own distance from
  XLA's fused evaluation at policy off).
* The plain compact stage against the JAX package's interpret-mode kernel
  at C8: float32 outputs within 1e-6 of their max (f32 op-order
  roundoff, tests/test_torch_recon_fused.py's budget), bfloat16 outputs
  within that plus one bf16 ulp of each value (a value that cancels to a
  small one carries the f32 budget of the large terms into its rounding:
  measured 1.5 m/s-scale at |u| ~ 213 of 1e8), an int16 h within one
  stored quantum:
  XLA on the CPU folds the JAX kernel's ``(x + 1.5*2^23) - 1.5*2^23``
  rounding into ``x``, so its int16 store truncates where the port rounds
  to nearest even as the kernel documents (measured: half the cells one
  quantum apart).  The bf16 case runs in the fast tier, mixed16 in the
  slow one (``tests/test_torch_precision_slow.py``).
* The bf16 budget (C24 TC2, 8 steps, dt = 300 s) of
  ``tests/test_precision.py:193``: the bf16 path against the f32 path,
  h < 4e-3 and u < 2e-2 relative (the JAX package's budgets, 2-3x its
  measured 1.37e-3 / 6.4e-3; the port measures 1.3686e-3 / 6.4470e-3),
  mass drift < 1e-5 (measured 2.67e-7).  Against the JAX package's own
  bf16 trajectory (slow tier, ``tests/test_torch_precision_slow.py``): h
  and u within 1e-3 of max (measured 4.5e-6 and 2.7e-6; the f32 paths
  are 4.1e-7 / 8.5e-7 apart).
* policy off, ``temporal_block = 2``: bitwise.
* ``Simulation`` with a ``precision:`` block against the JAX package's
  (slow tier): h and u within 1e-3 of max (mixed16: f32 anomalies
  quantized to 1/16 m, the int16 store's rounding rule above).  The
  slow-tier cases live in ``tests/test_torch_precision_slow.py``
  (``scripts/check_tiers.py`` keeps this module, which imports the JAX
  precision module, free of slow tests).
"""

import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

import jax.numpy as jnp

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.ops import reconstruct as jrec
from jaxstream.ops.pallas import precision as jprec
from jaxstream.ops.pallas import swe_cov as jsc

from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.interop import to_numpy, to_torch
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops import reconstruct as trec
from jaxstream_torch.ops.cuda import precision as tprec
from jaxstream_torch.ops.cuda import swe_cov as tsc
from jaxstream_torch.physics import initial_conditions as tic
from jaxstream_torch.simulation import Simulation
from jaxstream_torch.utils import diagnostics as diag

G, OM = EARTH_GRAVITY, EARTH_OMEGA
TOL = 1e-6
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16, torch.int16: jnp.int16}


def _J(t):
    return jnp.asarray(to_numpy(t))


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64))


def _bf16_ulp(x):
    """One bfloat16 ulp at each |x| (the normal range's spacing)."""
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _close(port, ref, dtype):
    """The module docstring's stage budgets, per storage dtype."""
    p, r = _f64(port), _f64(ref)
    d = np.abs(p - r)
    if dtype == torch.bfloat16:
        budget = _bf16_ulp(r) + TOL * np.abs(r).max()
        assert np.all(d <= budget), float(np.max(d / budget))
    elif dtype == torch.int16:
        assert np.all(d <= 1.0), float(d.max())
    else:
        assert d.max() <= TOL * np.abs(r).max(), d.max() / np.abs(r).max()


def _c8_tc5():
    g = build_grid(8, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = tic.williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b)
    s = m.initial_state(h, v)
    rng = np.random.default_rng(3)
    noise = (1 + 1e-3 * rng.standard_normal(tuple(s["h"].shape)))
    s = {"h": s["h"] * torch.from_numpy(noise.astype(np.float32)),
         "u": s["u"]}
    jg = jax_build_grid(8, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    return g, jg, m, s


# ---- precision.py --------------------------------------------------------

_SPECS = [None, "f32", "off", "none", "", "bf16", "BF16",
          {"stage": "bf16"}, {"compute": "bf16", "strips": "f32"},
          {"stage": "f32", "strips": "bf16"}, {"stage": "f32"},
          {"strips": "auto"}, tprec.StagePrecision("bf16", "f32"),
          tprec.StagePrecision()]
_BAD = ["fp8", {"stage": "bf16", "strip": "bf16"}, {"stage": "fp16"},
        {"strips": "f16"}, 3]


def _as_jax(spec):
    if isinstance(spec, tprec.StagePrecision):
        return jprec.StagePrecision(spec.compute, spec.strips)
    return spec


def test_resolve_matches_jax():
    for spec in _SPECS:
        t, j = (tprec.resolve_stage_precision(spec),
                jprec.resolve_stage_precision(_as_jax(spec)))
        assert (t is None) == (j is None), spec
        if t is not None:
            assert (t.compute, t.strips) == (j.compute, j.strips), spec
            assert t.compute_dtype == (torch.bfloat16 if j.compute_dtype
                                       == jnp.bfloat16 else torch.float32)
        assert (tprec.strip_dtype_bytes(spec)
                == jprec.strip_dtype_bytes(_as_jax(spec))), spec
    for spec in _BAD:
        with pytest.raises((ValueError, TypeError)) as te:
            tprec.resolve_stage_precision(spec)
        with pytest.raises((ValueError, TypeError)) as je:
            jprec.resolve_stage_precision(spec)
        assert te.type is je.type and str(te.value) == str(je.value), spec
    with pytest.raises(ValueError) as te:
        tprec.StagePrecision(compute="fp8")
    with pytest.raises(ValueError) as je:
        jprec.StagePrecision(compute="fp8")
    assert str(te.value) == str(je.value)


def test_encode_strips_and_mixed16_match_jax():
    g, jg, m, s = _c8_tc5()
    y = m.compact_state(s)
    for spec in (None, "bf16", {"stage": "bf16", "strips": "f32"}):
        t = tprec.encode_strips(y, spec)
        j = jprec.encode_strips({k: _J(v) for k, v in y.items()},
                                _as_jax(spec))
        for k in y:
            assert _JDT[t[k].dtype] == j[k].dtype, (spec, k)
            np.testing.assert_array_equal(to_numpy(t[k]), np.asarray(j[k]))
    (tch, tcu), toff, ths = tprec.mixed16_encoding(s["h"])
    (jch, jcu), joff, jhs = jprec.mixed16_encoding(_J(s["h"]))
    assert (_JDT[tch], _JDT[tcu]) == (jch, jcu)
    assert (toff, ths) == (joff, jhs)


# ---- the bf16 reconstruction and router -----------------------------------

@pytest.mark.parametrize("limiter", ["none", "minmod", "mc", "mc_sign",
                                     "vanleer"])
def test_bf16_face_states_match_jax(limiter):
    rng = np.random.default_rng(0)
    q = (5000 + 100 * rng.standard_normal((6, 12, 12))).astype(np.float32)
    for axis in (-1, -2):
        tl, tr = trec.plr_face_states(torch.from_numpy(q), axis, 2, 8,
                                      limiter, slope_dtype=torch.bfloat16)
        jl, jr = jrec.plr_face_states(jnp.asarray(q), axis, 2, 8, limiter,
                                      slope_dtype=jnp.bfloat16)
        assert tl.dtype == torch.float32
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("spec", ["bf16", {"stage": "f32", "strips": "bf16"},
                                  {"stage": "bf16", "strips": "f32"}],
                         ids=["bf16", "strips", "compute"])
def test_bf16_router_matches_jax(spec):
    g, jg, m, s = _c8_tc5()
    y = m.compact_state(s)
    h = g.halo
    t = tsc.make_cov_strip_router_split(g, precision=spec)(
        y["strips_sn"], y["strips_we"])
    j = jsc.make_cov_strip_router_split(
        jg, prescale_sym=True, precision=jprec.resolve_stage_precision(
            spec))(_J(y["strips_sn"]), _J(y["strips_we"]))
    sdt = tprec.resolve_stage_precision(spec).strips_dtype
    # gsn rows / gwe columns: h's 2h ghosts, u's 4h, the two sym rows.
    for port, ref, sl in ((t[0], j[0], lambda x, a, b: x[:, a:b]),
                          (t[1], j[1], lambda x, a, b: x[:, :, a:b])):
        assert port.dtype == sdt and _JDT[sdt] == ref.dtype
        np.testing.assert_array_equal(_f64(sl(port, 0, 2 * h)),
                                      _f64(sl(ref, 0, 2 * h)))
        for a, b in ((2 * h, 6 * h), (6 * h, 6 * h + 2)):
            p, r = _f64(sl(port, a, b)), _f64(sl(ref, a, b))
            if sdt == torch.bfloat16:
                assert np.all(np.abs(p - r) <= _bf16_ulp(r)), (a, b)
            else:
                assert np.abs(p - r).max() <= TOL * np.abs(r).max(), (a, b)


def test_ppm_bf16_refused_with_jax_message():
    g, jg, m, s = _c8_tc5()
    with pytest.raises(ValueError) as te:
        tsc.make_cov_stage_compact(8, 3, g.dalpha, g.radius, G, OM, 600.0,
                                   0.0, 1.0, scheme="ppm", device="cpu",
                                   precision="bf16")
    with pytest.raises(ValueError) as je:
        jsc.pick_recon_precision("ppm", 3, 8, "mc",
                                 jprec.resolve_stage_precision("bf16"))
    assert str(te.value) == str(je.value)


# ---- the plain stage against the JAX interpret-mode kernel ----------------

def _stage_vs_jax(kw, stage_index=1):
    """Stage ``stage_index`` of SSPRK3 with ``kw``'s knobs on the C8 TC5
    carry: the port's plain version and the JAX kernel in interpret mode
    on the same (port-routed) operands."""
    g, jg, m, s = _c8_tc5()
    carry = {k: kw[k] for k in ("carry_dtype", "h_offset", "h_scale",
                                "u_scale") if k in kw}
    y = m.encode_carry(m.compact_state(s), **carry)
    pol = kw.get("precision")
    gsn, gwe = tsc.make_cov_strip_router_split(g, precision=pol)(
        y["strips_sn"], y["strips_we"])
    a, b = tsc.SSPRK3_COEFFS[stage_index]
    st = tsc.make_cov_stage_compact(8, 2, g.dalpha, g.radius, G, OM, 600.0,
                                    a, b, device="cpu", **kw)
    jkw = dict(kw)
    if "carry_dtype" in jkw:
        jkw["carry_dtype"] = tuple(_JDT[d] for d in jkw["carry_dtype"])
    if pol is not None:
        jkw["precision"] = jprec.resolve_stage_precision(pol)
    js = jsc.make_cov_stage_compact(
        8, 2, float(g.dalpha), float(g.radius), G, OM, 600.0, a, b,
        interpret=True, sym_prescaled=True, **jkw)
    args = (y["h"], y["u"]) if a != 0.0 else ()
    args += (y["h"], y["u"], gsn, gwe, m.b_ext)
    return st.reference(*args), js(*[_J(x) for x in args])


def test_plain_stage_bf16_matches_jax_interpret():
    port, ref = _stage_vs_jax({"precision": "bf16"})
    for p, r in zip(port, ref):
        assert _JDT[p.dtype] == r.dtype
        _close(p, r, p.dtype)


# ---- budgets and composition ----------------------------------------------

def _tc2_c24():
    g = build_grid(24, halo=2, radius=EARTH_RADIUS, device="cpu")
    m = CovariantShallowWater(g, gravity=G, omega=OM)
    return g, m, m.initial_state(*tic.williamson_tc2(g, G, OM))


def _rel(a, b):
    a, b = _f64(a), _f64(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


def test_policy_off_bitwise_and_bf16_budget_c24():
    g, m, s = _tc2_c24()
    y0 = m.compact_state(s)
    s_ref = m.make_fused_step(300.0)
    s_off = m.make_fused_step(300.0, precision={"stage": "f32",
                                                "strips": "auto"})
    s_bf = m.make_fused_step(300.0, precision="bf16")
    y, yo, yb = dict(y0), dict(y0), tprec.encode_strips(dict(y0), "bf16")
    assert yb["strips_sn"].dtype == torch.bfloat16
    for _ in range(8):
        y, yo, yb = s_ref(y, 0.0), s_off(yo, 0.0), s_bf(yb, 0.0)
    for k in y:
        assert torch.equal(y[k], yo[k]), k
    relh, relu = _rel(y["h"], yb["h"]), _rel(y["u"], yb["u"])
    assert 1e-5 < relh < 4e-3, relh
    assert relu < 2e-2, relu
    m0 = float(diag.total_mass(g, s["h"].double()))
    drift = abs(float(diag.total_mass(g, yb["h"].double())) - m0) / abs(m0)
    assert drift < 1e-5, drift


def test_temporal_block_bitwise():
    g, jg, m, s = _c8_tc5()
    y = m.compact_state(s)
    step1 = m.make_fused_step(600.0, precision="bf16")
    step2 = m.make_fused_step(600.0, temporal_block=2, precision="bf16")
    assert step2.steps_per_call == 2
    a = step2(y, 0.0)
    b = step1(step1(y, 0.0), 600.0)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_carry_encoding_refusals_match_jax():
    g, jg, m, s = _c8_tc5()
    m4 = CovariantShallowWater(g, gravity=G, omega=OM, nu4=1.0e14)
    jm4 = JaxCov(jg, gravity=G, omega=OM, nu4=1.0e14,
                 backend="pallas_interpret")
    for kw in ({"carry_dtype": torch.bfloat16},
               {"nu4_mode": "stage", "precision": "bf16"}):
        jkw = dict(kw)
        if "carry_dtype" in jkw:
            jkw["carry_dtype"] = jnp.bfloat16
        with pytest.raises(ValueError) as te:
            m4.make_fused_step(600.0, **kw)
        with pytest.raises(ValueError) as je:
            jm4.make_fused_step(600.0, **jkw)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="keeps f32 strips"):
        m.make_fused_step(600.0, compact=False, precision="bf16")


# ---- the bridge --------------------------------------------------------------

def test_interop_16bit_carries_cross_bit_for_bit():
    rng = np.random.default_rng(5)
    x = (1e3 * rng.standard_normal((2, 6, 8, 8))).astype(np.float32)
    for jdt in (jnp.bfloat16, jnp.int16, jnp.float16):
        ja = jnp.asarray(x).astype(jdt)
        t = to_torch(ja, device="cpu")
        assert _JDT[t.dtype] == jdt
        back = to_numpy(t)
        assert back.dtype == np.asarray(ja).dtype
        np.testing.assert_array_equal(back.view(np.int16),
                                      np.asarray(ja).view(np.int16))
        np.testing.assert_array_equal(
            np.asarray(jnp.asarray(back)).view(np.int16),
            np.asarray(ja).view(np.int16))


# ---- Simulation --------------------------------------------------------------

def _prec_cfg(**precision):
    return {"grid": {"n": 8, "halo": 2},
            "model": {"name": "shallow_water_cov",
                      "initial_condition": "tc5", "backend": "pallas"},
            "time": {"dt": 600.0, "nsteps": 4},
            "parallelization": {"num_devices": 1},
            "precision": precision}


def test_simulation_precision_block_runs_its_stepper():
    """A ``precision:`` block rides the fused stepper and decodes at each
    segment exit; the run is its stepper under ``integrate`` with the
    carry encoded and decoded, bitwise."""
    from jaxstream_torch.stepping import integrate

    sim = Simulation(_prec_cfg(stage="bf16", carry="mixed16"), device="cpu")
    assert sim.stepper_kind == "compact" and sim._fused_post is not None
    s0 = dict(sim.state)
    m0 = sim.diagnostics()["mass"]
    sim.run()
    assert sim.state["h"].dtype == torch.float32
    assert abs(sim.diagnostics()["mass"] - m0) / abs(m0) < 1e-3
    m = sim.model
    cd, off, hs = tprec.mixed16_encoding(s0["h"])
    step = m.make_fused_step(600.0, precision="bf16", carry_dtype=cd,
                             h_offset=off, h_scale=hs)
    y = tprec.encode_strips(m.encode_carry(m.compact_state(s0), cd, off,
                                           hs), "bf16")
    y, _ = integrate(step, y, 0.0, 4, 600.0)
    ref = m.decode_carry(m.restrict_state(y), off, hs)
    for k in ref:
        assert torch.equal(sim.state[k], ref[k]), k


def test_simulation_precision_refusals():
    cfg = _prec_cfg(stage="bf16")
    cfg["model"]["backend"] = "jnp"
    with pytest.raises(ValueError, match="ride the single-device fused"):
        Simulation(cfg, device="cpu")
    cfg = _prec_cfg(stage="bf16")
    cfg["model"]["scheme"] = "ppm"
    with pytest.raises(ValueError, match="PPM has no bf16 form"):
        Simulation(cfg, device="cpu")
    cfg = _prec_cfg()
    cfg["grid"]["dtype"] = "bfloat16"
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        Simulation(cfg, device="cpu")
