"""Port parity: the lazy grid, the inverse gnomonic map, the directed
halo copies and the contravariant vector halo (queue A item 1).

* ``sphere_to_face_coords`` and ``directed_copies``: bitwise the JAX
  package's.
* ``LazyCubedSphereGrid``: every metric attribute against the JAX
  package's lazy grid, <= 1e-12 of the field's scale at float64 and
  within a few float32 ulps (torch's and XLA's ``atan2`` / ``asin`` may
  differ in the last place) at float32; against the eager grid at the
  JAX package's own budgets (``tests/test_lazy_metrics.py``: 1e-12 f64,
  2e-5 f32).
* The contravariant exchanger and ``to_contravariant`` /
  ``to_cartesian``: <= 1e-12 relative at float64.
* ``Simulation`` with ``grid.metrics: lazy`` runs: against the JAX
  package's lazy run (float64, <= 1e-12) and the eager run (the JAX
  budgets), and the history store keeps the lazy grid's geometry (the
  JAX package's ``save_geometry`` raises on a lazy grid).
"""

import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

import jax.numpy as jnp

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.geometry import cubed_sphere as jcs
from jaxstream.geometry.connectivity import build_schedule as jax_schedule
from jaxstream.parallel import halo as jhalo
from jaxstream.parallel import vector_halo as jvh
from jaxstream.simulation import Simulation as JaxSim

from jaxstream_torch.geometry import cubed_sphere as tcs
from jaxstream_torch.geometry.connectivity import build_schedule
from jaxstream_torch.io.history import load_geometry_arrays
from jaxstream_torch.models.shallow_water import ShallowWater
from jaxstream_torch.parallel import halo as thalo
from jaxstream_torch.parallel import vector_halo as tvh
from jaxstream_torch.physics.initial_conditions import williamson_tc2
from jaxstream_torch.simulation import Simulation
from jaxstream_torch.stepping import integrate

DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}
#: Trig attributes, the only ones whose float32 values may differ from
#: XLA's in the last place.
TRIG = ("lon", "lat")


def _lazy(n, key, radius=2.5, halo=2):
    jd, td = DTYPES[key]
    return (jcs.build_grid(n, halo=halo, radius=radius, dtype=jd,
                           metrics="lazy"),
            tcs.build_grid(n, halo=halo, radius=radius, dtype=td,
                           device="cpu", metrics="lazy"))


def test_sphere_to_face_coords_bitwise():
    rng = np.random.default_rng(11)
    p = rng.standard_normal((7, 9, 3))
    # Edge and corner points, where the owning face is a tie.
    p[0, :3] = [[1, 1, 0], [1, 1, 1], [0, -1, 1]]
    for a, b in zip(jcs.sphere_to_face_coords(p),
                    tcs.sphere_to_face_coords(p)):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)


@pytest.mark.parametrize("key", ["f64", "f32"])
def test_lazy_grid_matches_jax_lazy_grid(key):
    jg, tg = _lazy(12, key)
    assert (tg.n, tg.halo, tg.m, tg.dalpha) == (jg.n, jg.halo, jg.m,
                                               jg.dalpha)
    assert tg.dtype == DTYPES[key][1] and tg.device == torch.device("cpu")
    for name in tcs.METRIC_ATTRS:
        a = np.asarray(getattr(jg, name))
        b = getattr(tg, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        scale = np.max(np.abs(a))
        err = np.max(np.abs(a.astype(np.float64) - b))
        if key == "f64":
            assert err <= 1e-12 * scale, name
        elif name in TRIG:
            assert err <= 4 * np.finfo(np.float32).eps * scale, name
        else:
            assert err == 0.0, name


@pytest.mark.parametrize("key, rtol", [("f64", 1e-12), ("f32", 2e-5)])
def test_lazy_matches_eager(key, rtol):
    _, tl = _lazy(12, key)
    te = tcs.build_grid(12, halo=2, radius=2.5, dtype=DTYPES[key][1],
                        device="cpu")
    for name in tcs.METRIC_ATTRS:
        a = getattr(te, name).double().numpy()
        b = np.broadcast_to(getattr(tl, name).double().numpy(), a.shape)
        np.testing.assert_allclose(b, a, atol=rtol * np.max(np.abs(a)),
                                   err_msg=name)
    assert tl.total_area() == pytest.approx(te.total_area(), rel=10 * rtol)


def test_directed_copies_and_exchanger_match_jax():
    assert thalo.directed_copies() == jhalo.directed_copies()
    # Stages in another order: the same copies, another list order, and
    # the same exchanged field.
    sched = build_schedule()[::-1]
    jsched = jax_schedule()[::-1]
    assert (thalo.directed_copies(schedule=sched)
            == jhalo.directed_copies(schedule=jsched))
    n, halo = 6, 2
    m = n + 2 * halo
    q = np.random.default_rng(5).standard_normal((2, 6, m, m))
    for s, js in ((None, None), (sched, jsched)):
        a = np.asarray(jhalo.make_halo_exchanger(n, halo, schedule=js)(
            jnp.asarray(q)))
        b = thalo.make_halo_exchanger(n, halo, schedule=s)(
            torch.from_numpy(q)).numpy()
        assert np.array_equal(a, b)


@pytest.mark.parametrize("metrics", ["eager", "lazy"])
def test_contravariant_exchange_and_conversions(metrics):
    jg = jcs.build_grid(8, halo=2, radius=EARTH_RADIUS, dtype=jnp.float64,
                        metrics=metrics)
    tg = tcs.build_grid(8, halo=2, radius=EARTH_RADIUS, dtype=torch.float64,
                        device="cpu", metrics=metrics)
    rng = np.random.default_rng(3)
    uv = rng.standard_normal((2, 6, tg.m, tg.m))
    a = np.asarray(jvh.make_vector_halo_exchanger(jg)(jnp.asarray(uv)))
    b = tvh.make_vector_halo_exchanger(tg)(torch.from_numpy(uv)).numpy()
    assert np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(a))
    v = rng.standard_normal((3, 6, tg.m, tg.m))
    ja = np.asarray(jvh.to_contravariant(jg, jnp.asarray(v)))
    ta = tvh.to_contravariant(tg, torch.from_numpy(v))
    assert np.max(np.abs(ja - ta.numpy())) <= 1e-12 * np.max(np.abs(ja))
    jc = np.asarray(jvh.to_cartesian(jg, jnp.asarray(ja)))
    tc = tvh.to_cartesian(tg, ta).numpy()
    assert np.max(np.abs(jc - tc)) <= 1e-12 * np.max(np.abs(jc))
    with pytest.raises(ValueError, match="unknown components"):
        tvh.make_vector_halo_exchanger(tg, components="spherical")


def _sim_cfg(tmp_path, metrics, dtype="float64", **over):
    cfg = {"grid": {"n": 8, "halo": 2, "dtype": dtype, "metrics": metrics},
           "model": {"initial_condition": "tc2"},
           "time": {"dt": 600.0, "nsteps": 3},
           "parallelization": {"num_devices": 1},
           "io": {"history_path": str(tmp_path / f"h_{metrics}"),
                  "history_stride": 3}}
    for k, v in over.items():
        cfg.setdefault(k, {}).update(v)
    return cfg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


def test_lazy_simulation_matches_jax_and_eager(tmp_path):
    """``grid.metrics: lazy`` runs through ``Simulation`` (it used to be
    refused): the classic TC2 path at float64 against the JAX package's
    lazy run (<= 1e-12) and the port's eager run (the JAX budgets), the
    geometry store written from the lazy grid."""
    sim = Simulation(_sim_cfg(tmp_path, "lazy"), device="cpu")
    assert isinstance(sim.grid, tcs.LazyCubedSphereGrid)
    sim.run()
    # The JAX package's history store cannot take a lazy grid (its
    # save_geometry walks dataclass fields): its run writes no history.
    jsim = JaxSim(_sim_cfg(tmp_path / "j", "lazy", io={"history_stride": 0}))
    jsim.run()
    assert sim.t == jsim.t
    for k in jsim.state:
        assert _rel(jsim.state[k], sim.state[k].numpy()) <= 1e-12, k
    eager = Simulation(_sim_cfg(tmp_path / "e", "eager"), device="cpu")
    eager.run()
    h_e, v_e = eager.state["h"].numpy(), eager.state["v"].numpy()
    np.testing.assert_allclose(sim.state["h"].numpy(), h_e, rtol=1e-10)
    np.testing.assert_allclose(sim.state["v"].numpy(), v_e, rtol=0,
                               atol=1e-10 * np.max(np.abs(v_e)))
    geo = load_geometry_arrays(str(tmp_path / "h_lazy") + ".geometry")
    for name in tcs.METRIC_ATTRS:
        a = getattr(eager.grid, name).numpy()
        assert geo[name].shape == a.shape, name
        np.testing.assert_allclose(geo[name], a, rtol=0,
                                   atol=1e-12 * np.max(np.abs(a)),
                                   err_msg=name)


def test_lazy_compact_path_float32(tmp_path):
    """The compact fused stepper (the kernels' plain versions on the
    CPU) on a float32 lazy grid: its rotation tables come from float32
    expressions, so it stays within the lazy-vs-eager budget of the
    eager run after 3 steps."""
    over = {"model": {"initial_condition": "tc5",
                      "name": "shallow_water_cov", "backend": "pallas"}}
    out = {}
    for metrics in ("lazy", "eager"):
        sim = Simulation(_sim_cfg(tmp_path / metrics, metrics, "float32",
                                  **over), device="cpu")
        assert sim.stepper_kind == "compact"
        sim.run()
        out[metrics] = {k: v.numpy() for k, v in sim.state.items()}
    for k in ("h", "u"):
        assert _rel(out["eager"][k], out["lazy"][k]) <= 2e-5, k


@pytest.mark.slow
def test_swe_step_parity_lazy_vs_eager_c16():
    """The JAX package's slow lazy-vs-eager step parity, on the port:
    five classic Cartesian TC2 steps at C16, float64."""
    out = {}
    for metrics in ("eager", "lazy"):
        grid = tcs.build_grid(16, halo=2, radius=EARTH_RADIUS,
                              dtype=torch.float64, device="cpu",
                              metrics=metrics)
        model = ShallowWater(grid, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA)
        h_ext, v_ext = williamson_tc2(grid, EARTH_GRAVITY, EARTH_OMEGA)
        state = model.initial_state(h_ext, v_ext)
        out[metrics], _ = integrate(model.make_step(600.0), state, 0.0, 5,
                                    600.0)
    np.testing.assert_allclose(out["lazy"]["h"].numpy(),
                               out["eager"]["h"].numpy(), rtol=1e-10)
    v = out["eager"]["v"].numpy()
    np.testing.assert_allclose(out["lazy"]["v"].numpy(), v, rtol=0,
                               atol=1e-10 * np.max(np.abs(v)))
