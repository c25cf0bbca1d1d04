"""Port parity: the ensemble member axis on the compact covariant main
path and through ``Simulation``.

Inputs: TC5 and TC2 states at C8 from both packages' initial conditions
(bitwise equal), members from ``perturbed_ensemble`` (numpy's
``default_rng``) or numpy-seeded perturbations, handed across as numpy.
Tolerances, and where they come from:

* ``perturbed_ensemble`` (float32 and float64 grids), ``encode_carry`` /
  ``decode_carry``, ``stack_ensemble``, ``member_state`` and
  ``ensemble_compact_state`` against the JAX package's: bitwise (the same
  float64 numpy and the same casts).
* The batched stepper (port, plain versions): B = 1 batched equals the
  unbatched step and each member of B = 3 equals its own run, bitwise,
  over 3 steps (the JAX package's ``test_b1_batched_bitwise_vs_unbatched``
  criterion); ``ensemble_impl='vmap'`` equals the kernel form bitwise.
* The plain B1 stage at B = 2 against the JAX interpret-mode kernel with
  ``groups = 12`` (slow tier): 1e-6 of max (f32 op-order roundoff,
  tests/test_torch_recon_fused.py's budget).
* ``Simulation`` with ``ensemble.members: 2`` against the JAX package's at
  C8: the covariant ``pallas`` run takes the batched fused stepper (slow
  tier), the Cartesian ``tc2`` run the vmapped classic step: h within
  1e-6 of max; ``h_spread_max`` within 1e-5 relative on the classic
  path (two evaluations of a float32 std), and within the states' own
  largest distance on the fused one (the spread of two members is half
  their difference; measured 2.4e-4 m of 2.8 m); the port's run is
  bitwise its stepper under
  ``integrate`` and member 0 bitwise the one-member run.
* The refusals that remain, and the JAX package's messages for an
  ensemble with a carry encoding or with nu4.
"""

import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

import jax.numpy as jnp

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.ops.pallas import swe_cov as jsc
from jaxstream.physics import initial_conditions as jic
from jaxstream.simulation import Simulation as JaxSim

from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.interop import to_numpy
from jaxstream_torch.models.shallow_water_cov import (ENSEMBLE_CARRY_AXES,
                                                      CovariantShallowWater)
from jaxstream_torch.ops.cuda import swe_cov as tsc
from jaxstream_torch.parallel.sharded_model import make_stepper_for
from jaxstream_torch.physics import initial_conditions as tic
from jaxstream_torch.simulation import Simulation
from jaxstream_torch.stepping import integrate

G, OM = EARTH_GRAVITY, EARTH_OMEGA
TOL = 1e-6


def _J(t):
    return jnp.asarray(to_numpy(t))


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _models(n=8):
    g = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = tic.williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b)
    jg = jax_build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    jh, jv, jb = jic.williamson_tc5(jg, G, OM)
    jm = JaxCov(jg, gravity=G, omega=OM, b_ext=jb,
                backend="pallas_interpret")
    return (g, m, h, v), (jg, jm, jh, jv)


# ---- the exact pieces --------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_perturbed_ensemble_bitwise(dtype):
    g = build_grid(8, halo=2, radius=EARTH_RADIUS, device="cpu", dtype=dtype)
    jg = jax_build_grid(8, halo=2, radius=EARTH_RADIUS,
                        dtype=jnp.float32 if dtype == torch.float32
                        else jnp.float64)
    h = tic.williamson_tc5(g, G, OM)[0]
    jh = jic.williamson_tc5(jg, G, OM)[0]
    for members, seed in ((1, 0), (4, 6)):
        t = tic.perturbed_ensemble(g, h, members, seed=seed,
                                   amplitude=1e-3)
        j = jic.perturbed_ensemble(jg, jh, members, seed=seed,
                                   amplitude=1e-3)
        assert t.dtype == dtype and tuple(t.shape) == tuple(j.shape)
        np.testing.assert_array_equal(to_numpy(t), np.asarray(j))


def test_stack_member_and_compact_carry_bitwise():
    (g, m, h, v), (jg, jm, jh, jv) = _models()
    hb = tic.perturbed_ensemble(g, h, 3, seed=2)
    states = [m.initial_state(hb[i], v) for i in range(3)]
    jhb = jic.perturbed_ensemble(jg, jh, 3, seed=2)
    jstates = [jm.initial_state(jhb[i], jv) for i in range(3)]
    t = m.ensemble_compact_state(m.stack_ensemble(states))
    j = jm.ensemble_compact_state(jm.stack_ensemble(jstates))
    for k in j:
        np.testing.assert_array_equal(to_numpy(t[k]), np.asarray(j[k]))
    for i in range(3):
        ts, js = m.member_state(t, i), jm.member_state(j, i)
        for k in js:
            np.testing.assert_array_equal(to_numpy(ts[k]), np.asarray(js[k]))


@pytest.mark.parametrize("encoding", [
    ((torch.int16, torch.bfloat16), 5150.0, 0.0625, 1.0),
    ((torch.bfloat16, torch.bfloat16), 5150.0, 1.0, 1.0),
    ((torch.float16, torch.float16), 5150.0, 1.0, EARTH_RADIUS),
    (None, 5150.0, 1.0, 1.0)], ids=["mixed16", "bf16", "f16", "f32-offset"])
def test_encode_decode_carry_bitwise(encoding):
    cd, off, hs, us = encoding
    (g, m, h, v), (jg, jm, jh, jv) = _models()
    y = m.compact_state(m.initial_state(h, v))
    jy = {k: _J(x) for k, x in y.items()}
    jd = {torch.int16: jnp.int16, torch.bfloat16: jnp.bfloat16,
          torch.float16: jnp.float16}
    jcd = None if cd is None else tuple(jd[d] for d in cd)
    te = m.encode_carry(y, cd, off, hs, us)
    je = jm.encode_carry(jy, jcd, off, hs, us)
    for k in ("h", "u"):
        np.testing.assert_array_equal(to_numpy(te[k]), np.asarray(je[k]))
    td = m.decode_carry(te, off, hs, us)
    jdd = jm.decode_carry(je, off, hs, us)
    for k in ("h", "u"):
        np.testing.assert_array_equal(to_numpy(td[k]), np.asarray(jdd[k]))


# ---- the batched stepper -----------------------------------------------------

def _ensemble(m, h, v, members, seed=4):
    hb = tic.perturbed_ensemble(m.grid, h, members, seed=seed)
    return [m.initial_state(hb[i], v) for i in range(members)]


def test_batched_b1_and_b3_bitwise_vs_unbatched():
    (g, m, h, v), _ = _models()
    step1 = m.make_fused_step(600.0)
    for B in (1, 3):
        states = _ensemble(m, h, v, B)
        yb = m.ensemble_compact_state(m.stack_ensemble(states))
        stepb = m.make_fused_step(600.0, ensemble=B)
        stepv = m.make_fused_step(600.0, ensemble=B, ensemble_impl="vmap")
        assert stepb.ensemble == B and stepv.ensemble == B
        ys = [m.compact_state(s) for s in states]
        yv = yb
        for _ in range(3):
            yb, yv = stepb(yb, 0.0), stepv(yv, 0.0)
            ys = [step1(y, 0.0) for y in ys]
        for k in yb:
            assert torch.equal(yb[k], yv[k]), (B, k)
            for i in range(B):
                mem = yb[k][:, i] if k == "u" else yb[k][i]
                assert torch.equal(mem, ys[i][k]), (B, i, k)


def test_batched_temporal_block_bitwise():
    (g, m, h, v), _ = _models()
    yb = m.ensemble_compact_state(m.stack_ensemble(_ensemble(m, h, v, 2)))
    step1 = m.make_fused_step(600.0, ensemble=2)
    step2 = m.make_fused_step(600.0, ensemble=2, temporal_block=2)
    assert step2.steps_per_call == 2 and step2.ensemble == 2
    a, b = step2(yb, 0.0), step1(step1(yb, 0.0), 600.0)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.slow
def test_plain_stage_b2_matches_jax_interpret():
    (g, m, h, v), _ = _models()
    states = _ensemble(m, h, v, 2)
    y = m.ensemble_compact_state(m.stack_ensemble(states))
    route = tsc.make_cov_strip_router_split(g)
    gsn, gwe = (x.reshape((12,) + tuple(x.shape[2:]))
                for x in route(y["strips_sn"], y["strips_we"]))
    h0, u0 = y["h"].reshape(12, 8, 8), y["u"].reshape(2, 12, 8, 8)
    for a, b in tsc.SSPRK3_COEFFS:
        st = tsc.make_cov_stage_compact(8, 2, g.dalpha, g.radius, G, OM,
                                        600.0, a, b, device="cpu",
                                        groups=12)
        js = jsc.make_cov_stage_compact(
            8, 2, float(g.dalpha), float(g.radius), G, OM, 600.0, a, b,
            interpret=True, sym_prescaled=True, groups=12)
        args = ((h0, u0) if a != 0.0 else ()) + (h0, u0, gsn, gwe, m.b_ext)
        for p, r in zip(st.reference(*args), js(*[_J(x) for x in args])):
            assert _rel(np.asarray(r), to_numpy(p)) <= TOL


# ---- make_stepper_for and the refusals ----------------------------------------

def test_single_device_classic_ensemble_step():
    (g, m, h, v), _ = _models()
    states = _ensemble(m, h, v, 2)
    yb = m.stack_ensemble(states)
    step = make_stepper_for(m, None, yb, 600.0, "ssprk3", ensemble=2)
    one = m.make_step(600.0, "ssprk3")
    out = step(yb, 0.0)
    for i, s in enumerate(states):
        ref = one(s, 0.0)
        assert torch.equal(out["h"][i], ref["h"])
        assert torch.equal(out["u"][:, i], ref["u"])
    assert ENSEMBLE_CARRY_AXES == {"h": 0, "u": 1, "strips_sn": 0,
                                   "strips_we": 0}


def test_ensemble_refusals_match_jax():
    (g, m, h, v), (jg, jm, jh, jv) = _models()
    m4 = CovariantShallowWater(g, gravity=G, omega=OM, nu4=1.0e14)
    jm4 = JaxCov(jg, gravity=G, omega=OM, nu4=1.0e14,
                 backend="pallas_interpret")
    for port, ref, kw, jkw in (
            (m, jm, {"ensemble": 2, "carry_dtype": torch.bfloat16},
             {"ensemble": 2, "carry_dtype": jnp.bfloat16}),
            (m4, jm4, {"ensemble": 2}, {"ensemble": 2}),
            (m, jm, {"ensemble": 2, "compact": False},
             {"ensemble": 2, "compact": False}),
            (m, jm, {"ensemble": 2, "ensemble_impl": "scan"},
             {"ensemble": 2, "ensemble_impl": "scan"})):
        with pytest.raises(ValueError) as te:
            port.make_fused_step(600.0, **kw)
        with pytest.raises(ValueError) as je:
            ref.make_fused_step(600.0, **jkw)
        assert str(te.value) == str(je.value)


# ---- Simulation ------------------------------------------------------------------

def _ens_cfg(ic="tc5", backend="pallas", members=2, n=8, nsteps=2):
    cfg = {"grid": {"n": n},
           "model": {"initial_condition": ic, "backend": backend},
           "time": {"dt": 600.0, "nsteps": nsteps},
           "parallelization": {"num_devices": 1},
           "ensemble": {"members": members, "seed": 9, "amplitude": 1e-3}}
    if ic == "tc5":
        cfg["model"]["name"] = "shallow_water_cov"
    return cfg


def test_simulation_batched_fused_ensemble():
    """``members: 2`` on the covariant ``pallas`` model: the batched fused
    stepper, bitwise its stepper under ``integrate``; member 0 bitwise the
    one-member run; the spread keys."""
    sim = Simulation(_ens_cfg(), device="cpu")
    assert sim.stepper_kind == "compact"
    assert sim._fused_step.ensemble == 2
    assert tuple(sim.state["h"].shape) == (2, 6, 8, 8)
    s0 = dict(sim.state)
    sim.run()
    m = sim.model
    y, _ = integrate(m.make_fused_step(600.0, ensemble=2),
                     m.ensemble_compact_state(s0), 0.0, 2, 600.0)
    for k in ("h", "u"):
        assert torch.equal(sim.state[k], y[k]), k
    one = Simulation({k: v for k, v in _ens_cfg().items()
                      if k != "ensemble"}, device="cpu")
    one.run()
    assert torch.equal(sim.state["h"][0], one.state["h"])
    d = sim.diagnostics()
    assert set(d) == {"mass_m0", "energy_m0", "h_spread_max"}
    assert d["h_spread_max"] > 0.0


@pytest.mark.slow
def test_simulation_batched_fused_ensemble_matches_jax():
    sim = Simulation(_ens_cfg(), device="cpu")
    jsim = JaxSim(_ens_cfg(backend="pallas_interpret"))
    sim.run()
    jsim.run()
    jh, th = np.asarray(jsim.state["h"], np.float64), to_numpy(
        sim.state["h"]).astype(np.float64)
    assert _rel(jh, th) <= TOL
    d, jd = sim.diagnostics(), jsim.diagnostics()
    for k in ("mass_m0", "energy_m0"):
        assert abs(d[k] - jd[k]) <= 1e-5 * abs(jd[k]), k
    # The spread of two members is half their difference: the states'
    # own distance bounds it.
    assert abs(d["h_spread_max"] - jd["h_spread_max"]) <= (
        np.abs(jh - th).max() + 1e-6 * jd["h_spread_max"])


def test_simulation_cartesian_ensemble_matches_jax():
    """``members: 2`` on the Cartesian model (tc2): the vmapped classic
    path, ``v`` with its component axis first."""
    cfg = _ens_cfg(ic="tc2", backend="jnp", nsteps=1)
    sim = Simulation(cfg, device="cpu")
    assert sim.stepper_kind == "classic"
    assert tuple(sim.state["v"].shape) == (3, 2, 6, 8, 8)
    jsim = JaxSim(cfg)
    for k in ("h", "v"):
        np.testing.assert_array_equal(to_numpy(sim.state[k]),
                                      np.asarray(jsim.state[k]))
    sim.run()
    jsim.run()
    assert _rel(jsim.state["h"], to_numpy(sim.state["h"])) <= TOL
    d, jd = sim.diagnostics(), jsim.diagnostics()
    assert abs(d["h_spread_max"] - jd["h_spread_max"]) <= (
        1e-5 * jd["h_spread_max"])


def test_simulation_ensemble_refusals():
    cfg = _ens_cfg()
    cfg["precision"] = {"carry": "mixed16"}
    with pytest.raises(ValueError) as te:
        Simulation(cfg, device="cpu")
    assert "carry encodings are wired for single runs" in str(te.value)
    cfg = _ens_cfg()
    cfg["parallelization"] = {"num_devices": 6, "use_shard_map": True}
    with pytest.raises(NotImplementedError, match="A8"):
        Simulation(cfg, device="cpu")
    with pytest.raises(ValueError, match="shallow-water"):
        Simulation({"model": {"initial_condition": "tc1"},
                    "grid": {"n": 8}, "ensemble": {"members": 2},
                    "parallelization": {"num_devices": 1}}, device="cpu")
