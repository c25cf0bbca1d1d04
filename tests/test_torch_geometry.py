"""Port parity: grid, connectivity, initial conditions, device policy.

The port builds every metric term in float64 numpy with the JAX
package's formulas and casts once, so its grid, its initial conditions
and the router's rotation tables must be bitwise equal to the JAX
package's — any difference is a porting error, not roundoff.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.geometry import connectivity as jconn
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.ops.pallas.swe_cov import _rotation_tables as jax_rotation_tables
from jaxstream.physics import initial_conditions as jic

from jaxstream_torch import config as tconfig
from jaxstream_torch.geometry import connectivity as tconn
from jaxstream_torch.geometry.cubed_sphere import build_grid, extended_coords
from jaxstream_torch.interop import to_numpy, to_torch
from jaxstream_torch.ops.cuda.swe_cov import _rotation_tables
from jaxstream_torch.physics import initial_conditions as tic

GRID_FIELDS = ("xyz", "khat", "lon", "lat", "e_a", "e_b", "a_a", "a_b",
               "sqrtg", "area", "sqrtg_xf", "a_a_xf", "sqrtg_yf", "a_b_yf",
               "ginv_aa_xf", "ginv_ab_xf", "ginv_bb_yf", "ginv_ab_yf")

DTYPES = {"f32": (jnp.float32, torch.float32),
          "f64": (jnp.float64, torch.float64)}


def _grids(n, dtype_key, radius=EARTH_RADIUS):
    jd, td = DTYPES[dtype_key]
    return (jax_build_grid(n, halo=2, radius=radius, dtype=jd),
            build_grid(n, halo=2, radius=radius, dtype=td, device="cpu"))


@pytest.mark.parametrize("dtype_key", ["f32", "f64"])
def test_grid_fields_bitwise(dtype_key):
    jg, tg = _grids(8, dtype_key)
    assert (tg.n, tg.halo, tg.m) == (jg.n, jg.halo, jg.m)
    assert tg.dalpha == jg.dalpha
    for name in GRID_FIELDS:
        a = np.asarray(getattr(jg, name))
        b = getattr(tg, name).numpy()
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name


def test_extended_coords_match():
    from jaxstream.geometry.cubed_sphere import extended_coords as jec

    for x, y in zip(jec(12, 3), extended_coords(12, 3)):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_connectivity_tables_equal():
    ja, ta = jconn.build_connectivity(), tconn.build_connectivity()
    for f in range(6):
        for e in range(4):
            assert (ja[f][e].face, ja[f][e].edge, ja[f][e].nbr_face,
                    ja[f][e].nbr_edge, ja[f][e].reversed_) == \
                (ta[f][e].face, ta[f][e].edge, ta[f][e].nbr_face,
                 ta[f][e].nbr_edge, ta[f][e].reversed_)
    jp = [(a.face, a.edge, b.face, b.edge) for a, b in jconn.edge_pairs()]
    tp = [(a.face, a.edge, b.face, b.edge) for a, b in tconn.edge_pairs()]
    assert jp == tp
    assert (tconn.EDGE_S, tconn.EDGE_E, tconn.EDGE_N, tconn.EDGE_W) == \
        (jconn.EDGE_S, jconn.EDGE_E, jconn.EDGE_N, jconn.EDGE_W)


def test_constants_match():
    from jaxstream import config as jconfig

    assert tconfig.EARTH_RADIUS == jconfig.EARTH_RADIUS
    assert tconfig.EARTH_GRAVITY == jconfig.EARTH_GRAVITY
    assert tconfig.EARTH_OMEGA == jconfig.EARTH_OMEGA


@pytest.mark.parametrize("case", ["tc2", "tc5"])
@pytest.mark.parametrize("dtype_key", ["f32", "f64"])
def test_initial_conditions_bitwise(case, dtype_key):
    # Same float64 numpy arithmetic on the same stored lon/lat, one cast:
    # bitwise, no ulp allowance needed.
    jg, tg = _grids(12, dtype_key)
    if case == "tc2":
        ja = jic.williamson_tc2(jg, EARTH_GRAVITY, EARTH_OMEGA)
        ta = tic.williamson_tc2(tg, EARTH_GRAVITY, EARTH_OMEGA)
    else:
        ja = jic.williamson_tc5(jg, EARTH_GRAVITY, EARTH_OMEGA)
        ta = tic.williamson_tc5(tg, EARTH_GRAVITY, EARTH_OMEGA)
    assert len(ja) == len(ta)
    for a, b in zip(ja, ta):
        assert np.asarray(a).dtype == b.numpy().dtype
        assert np.array_equal(np.asarray(a), b.numpy())


def test_rotation_tables_bitwise():
    jg, tg = _grids(8, "f32")
    a = np.asarray(jax_rotation_tables(jg))
    b = _rotation_tables(tg).numpy()
    assert a.shape == b.shape == (4, 6, 4, 2, 8)
    assert np.array_equal(a, b)


def test_no_hidden_cpu_fallback(monkeypatch):
    """Without a GPU, the default device raises instead of using the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_grid(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_torch(np.zeros(3))
    # Asking for the CPU is the one way to run there.
    assert build_grid(8, device="cpu").sqrtg.device.type == "cpu"


def test_interop_round_trip():
    """JAX arrays in, port tensors on the asked device, numpy back:
    values, dtypes and layouts unchanged."""
    jg, tg = _grids(8, "f32")
    h, v, b = jic.williamson_tc5(jg, EARTH_GRAVITY, EARTH_OMEGA)
    tree = {"h": jg.interior(h), "b_ext": b}
    t = to_torch(tree, device="cpu")
    assert t["h"].shape == (6, 8, 8) and t["b_ext"].shape == (6, 12, 12)
    assert t["h"].device.type == "cpu"
    back = to_numpy(t)
    for k in tree:
        assert back[k].dtype == np.asarray(tree[k]).dtype
        assert np.array_equal(back[k], np.asarray(tree[k]))
    # The port's own IC is the same tensor.
    assert torch.equal(t["b_ext"], tic.williamson_tc5(
        tg, EARTH_GRAVITY, EARTH_OMEGA)[2])
