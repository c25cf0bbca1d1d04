"""Port parity: reconstruction, FV operators, halo exchanges, classic RHS.

Inputs are made with numpy from a seed and handed to both packages.  The
classic covariant path is the port's own oracle for the fused stepper,
so it is held to the JAX jnp path at float64 roundoff (<= 1e-12
relative); the pure-copy scalar halo exchange must be bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.ops import fv as jfv
from jaxstream.ops import reconstruct as jrec
from jaxstream.parallel.halo import make_halo_exchanger as jax_halo
from jaxstream.parallel.vector_halo import make_vector_halo_exchanger as jax_vhalo
from jaxstream.physics.initial_conditions import williamson_tc5 as jax_tc5

from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops import fv as tfv
from jaxstream_torch.ops import reconstruct as trec
from jaxstream_torch.parallel.halo import make_halo_exchanger
from jaxstream_torch.parallel.vector_halo import make_vector_halo_exchanger
from jaxstream_torch.physics.initial_conditions import williamson_tc5

F64_REL = 1e-12


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _grids(n, dtype=torch.float64):
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (jax_build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=jd),
            build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=dtype,
                       device="cpu"))


@pytest.mark.parametrize("limiter", ["mc", "minmod", "none"])
@pytest.mark.parametrize("axis", [-1, -2])
def test_plr_face_states_bitwise(limiter, axis):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((6, 14, 14))
    jl, jr = jrec.plr_face_states(jnp.asarray(q), axis, 2, 10, limiter=limiter)
    tl, tr = trec.plr_face_states(torch.from_numpy(q), axis, 2, 10,
                                  limiter=limiter)
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert np.array_equal(np.asarray(jr), tr.numpy())


def test_scalar_halo_exchange_bitwise():
    rng = np.random.default_rng(1)
    n, halo = 8, 2
    m = n + 2 * halo
    q = rng.standard_normal((3, 6, m, m))
    a = np.asarray(jax_halo(n, halo)(jnp.asarray(q)))
    b = make_halo_exchanger(n, halo)(torch.from_numpy(q)).numpy()
    assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="expects"):
        make_halo_exchanger(n, halo)(torch.zeros(6, m + 1, m + 1))


def test_covariant_vector_halo_exchange():
    jg, tg = _grids(8)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 6, tg.m, tg.m))
    a = np.asarray(jax_vhalo(jg, components="covariant")(jnp.asarray(u)))
    b = make_vector_halo_exchanger(tg)(torch.from_numpy(u)).numpy()
    assert _rel(a, b) <= F64_REL


def test_fv_operators_f64():
    jg, tg = _grids(10)
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 6, tg.m, tg.m))
    q = rng.standard_normal((6, tg.m, tg.m)) + 5.0
    ju, tu = jnp.asarray(u), torch.from_numpy(u)
    jux, juy = jfv.covariant_face_normal_velocity(jg, ju)
    tux, tuy = tfv.covariant_face_normal_velocity(tg, tu)
    assert _rel(jux, tux.numpy()) <= F64_REL
    assert _rel(juy, tuy.numpy()) <= F64_REL
    jd = jfv.flux_divergence_faces(jg, jnp.asarray(q), jux, juy)
    td = tfv.flux_divergence_faces(tg, torch.from_numpy(q), tux, tuy)
    assert _rel(jd, td.numpy()) <= F64_REL
    assert _rel(jfv.vorticity_cov(jg, ju), tfv.vorticity_cov(tg, tu).numpy()) \
        <= F64_REL
    v = rng.standard_normal((3, 6, tg.m, tg.m))
    assert _rel(jfv.covariant_components(jg, jnp.asarray(v)),
                tfv.covariant_components(tg, torch.from_numpy(v)).numpy()) \
        <= F64_REL
    for a, b in zip(jfv.contravariant(jg, jnp.asarray(v)),
                    tfv.contravariant(tg, torch.from_numpy(v))):
        assert _rel(a, b.numpy()) <= F64_REL
    assert np.array_equal(
        np.asarray(jfv.embed_interior(jg, jnp.asarray(q[:, 2:-2, 2:-2]))),
        tfv.embed_interior(tg, torch.from_numpy(q[:, 2:-2, 2:-2])).numpy())


def test_classic_rhs_f64_matches_jnp():
    """Port classic rhs vs JAX jnp rhs, float64 grid, C12: <= 1e-12."""
    jg, tg = _grids(12)
    jh, jv, jb = jax_tc5(jg, EARTH_GRAVITY, EARTH_OMEGA)
    th, tv, tb = williamson_tc5(tg, EARTH_GRAVITY, EARTH_OMEGA)
    jm = JaxCov(jg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA, b_ext=jb)
    tm = CovariantShallowWater(tg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                               b_ext=tb)
    assert _rel(jm.b_ext, tm.b_ext.numpy()) == 0.0
    # Perturb the balanced state with seeded noise so every term works.
    rng = np.random.default_rng(4)
    js = jm.initial_state(jh, jv)
    s = {k: np.asarray(v) * (1.0 + 1e-3 * rng.standard_normal(v.shape))
         for k, v in js.items()}
    jr = jm.rhs({k: jnp.asarray(v) for k, v in s.items()}, 0.0)
    tr = tm.rhs({k: torch.from_numpy(v) for k, v in s.items()}, 0.0)
    for k in ("h", "u"):
        assert _rel(jr[k], tr[k].numpy()) <= F64_REL, k
