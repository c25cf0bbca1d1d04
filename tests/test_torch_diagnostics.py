"""Port parity: ``jaxstream_torch.utils.diagnostics`` against
``jaxstream.utils.diagnostics`` at C12 in float64, <= 1e-12 relative.

The same TC5 state (interior height, its Cartesian wind, the orography)
and the same seeded numpy fields go through both packages: the
conservation integrals (mass, energy with and without orography,
potential enstrophy), the area-weighted ensemble statistics (weights,
spread with ddof = 1, ensemble-mean RMSE and drift), and the covariant
model's ``to_cartesian`` that the energy of a covariant state reads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.physics.initial_conditions import williamson_tc5 as jax_tc5
from jaxstream.utils import diagnostics as jdg

from jaxstream_torch.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.physics.initial_conditions import williamson_tc5
from jaxstream_torch.utils import diagnostics as tdg

N = 12
TOL = 1e-12


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


@pytest.fixture(scope="module")
def c12():
    jg = jax_build_grid(N, halo=2, radius=EARTH_RADIUS, dtype=jnp.float64)
    tg = build_grid(N, halo=2, radius=EARTH_RADIUS, dtype=torch.float64,
                    device="cpu")
    jh, jv, jb = jax_tc5(jg, EARTH_GRAVITY, EARTH_OMEGA)
    th, tv, tb = williamson_tc5(tg, EARTH_GRAVITY, EARTH_OMEGA)
    jstate = tuple(jg.interior(a) for a in (jh, jv, jb))
    tstate = tuple(tg.interior(a) for a in (th, tv, tb))
    return jg, tg, jstate, tstate


def test_conservation_integrals_match_jax(c12):
    jg, tg, (jh, jv, jb), (th, tv, tb) = c12
    pairs = [
        (jdg.total_mass(jg, jh), tdg.total_mass(tg, th)),
        (jdg.total_energy(jg, jh, jv, EARTH_GRAVITY),
         tdg.total_energy(tg, th, tv, EARTH_GRAVITY)),
        (jdg.total_energy(jg, jh, jv, EARTH_GRAVITY, jb),
         tdg.total_energy(tg, th, tv, EARTH_GRAVITY, tb)),
    ]
    rng = np.random.default_rng(12)
    vort = rng.normal(0.0, 1e-4, (6, N, N))
    pairs.append((jdg.potential_enstrophy(jg, jh, jnp.asarray(vort)),
                  tdg.potential_enstrophy(tg, th, torch.from_numpy(vort))))
    for k, (j, t) in enumerate(pairs):
        assert t.dtype == torch.float64 and t.dim() == 0, k
        assert _rel(j, t.numpy()) <= TOL, (k, _rel(j, t.numpy()))


def test_ensemble_statistics_match_jax(c12):
    jg, tg, (jh, _, _), (th, _, _) = c12
    rng = np.random.default_rng(3)
    hb = np.asarray(jh)[None] + rng.normal(0.0, 20.0, (4, 6, N, N))
    ref = np.asarray(jh) + rng.normal(0.0, 5.0, (6, N, N))
    jw = jdg.ensemble_area_weights(jg)
    tw = tdg.ensemble_area_weights(tg)
    assert _rel(jw, tw.numpy()) <= TOL
    assert abs(float(tw.sum()) - 1.0) <= TOL
    assert tdg.ensemble_area_weights(tg, torch.float32).dtype == torch.float32
    jhb, thb = jnp.asarray(hb), torch.from_numpy(hb)
    pairs = [
        (jdg.ensemble_spread(jhb, jw), tdg.ensemble_spread(thb, tw)),
        (jdg.ensemble_mean_rmse(jhb, jnp.asarray(ref), jw),
         tdg.ensemble_mean_rmse(thb, torch.from_numpy(ref), tw)),
        (jdg.ensemble_mean_drift(jhb, jw), tdg.ensemble_mean_drift(thb, tw)),
    ]
    for k, (j, t) in enumerate(pairs):
        assert _rel(j, t.numpy()) <= TOL, (k, _rel(j, t.numpy()))
    # ddof = 1: two members' spread is their half-difference's RMS x sqrt 2.
    two = thb[:2]
    half = 0.5 * (two[0] - two[1])
    expect = torch.sqrt(torch.sum(tw * 2.0 * half * half))
    assert _rel(expect.numpy(), tdg.ensemble_spread(two, tw).numpy()) <= TOL


def test_covariant_to_cartesian_matches_jax(c12):
    jg, tg, (jh, jv, jb), (th, tv, tb) = c12
    jm = JaxCov(jg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA)
    tm = CovariantShallowWater(tg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA)
    rng = np.random.default_rng(5)
    u = rng.normal(0.0, 20.0, (2, 6, N, N))
    jv2 = jm.to_cartesian({"h": jh, "u": jnp.asarray(u)})
    tv2 = tm.to_cartesian({"h": th, "u": torch.from_numpy(u)})
    assert tuple(tv2.shape) == (3, 6, N, N)
    assert _rel(jv2, tv2.numpy()) <= TOL
