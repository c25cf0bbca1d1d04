"""Port parity: the whole-step covariant stepper.

``jaxstream_torch.experiments.swe_mega`` against the JAX package's
``jaxstream.experiments.swe_mega`` (its Pallas kernel in interpret mode,
as its own tests run it) and against the port's compact stepper, TC5,
dt = 600 s, float32.  Budgets:

* the port's plain step against the JAX interpret-mode step after 1 and
  3 steps at C8, all four carry fields: 1e-6 of each field's max (f32
  roundoff; XLA may contract multiply-adds);
* against the port's compact stepper after 3 steps at C12: bitwise,
  all four fields (the JAX package holds h bitwise and the rest to 1e-6,
  ``tests/test_cov_swe.py:533``): the same routes and stages, the sym
  rows' sqrtg applied in the stage instead of the router, the same
  product;
* the split router's shared core without the prescale: the same ghosts,
  and sym rows that the prescale turns into the router's, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.experiments import swe_mega as jmega
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.physics.initial_conditions import williamson_tc5 as jax_tc5

from jaxstream_torch.experiments import swe_mega as mega
from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops.cuda import swe_cov as tsc
from jaxstream_torch.ops.cuda.swe_rhs import _fast_frame, coord_rows
from jaxstream_torch.physics.initial_conditions import williamson_tc5

G, OM = EARTH_GRAVITY, EARTH_OMEGA
DT = 600.0
TOL = 1e-6
FIELDS = ("h", "u", "strips_sn", "strips_we")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _port(n):
    tg = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(tg, G, OM)
    tm = CovariantShallowWater(tg, gravity=G, omega=OM, b_ext=b)
    return tg, tm, tm.initial_state(h, v)


@pytest.fixture(scope="module")
def jax_mega_c8():
    """Three steps of the JAX interpret-mode whole-step stepper at C8."""
    jg = jax_build_grid(8, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    h, v, b = jax_tc5(jg, G, OM)
    jm = JaxCov(jg, gravity=G, omega=OM, b_ext=b, backend="pallas_interpret")
    step = jax.jit(jmega.make_fused_ssprk3_cov_mega(jg, G, OM, DT, jm.b_ext,
                                                    interpret=True))
    y = jm.compact_state(jm.initial_state(h, v))
    out = []
    for _ in range(3):
        y = step(y, 0.0)
        out.append({k: np.asarray(v) for k, v in y.items()})
    return out


@pytest.mark.parametrize("nsteps", [1, 3])
def test_mega_steps_match_jax_interpret(jax_mega_c8, nsteps):
    tg, tm, s0 = _port(8)
    step = mega.make_fused_ssprk3_cov_mega(tg, G, OM, DT, tm.b_ext)
    before = mega.CovMegaStep.launches
    y = tm.compact_state(s0)
    for _ in range(nsteps):
        y = step(y, 0.0)
    assert mega.CovMegaStep.launches == before      # plain: no launch
    ref = jax_mega_c8[nsteps - 1]
    assert set(y) == set(ref) == set(FIELDS)
    for k in FIELDS:
        assert tuple(y[k].shape) == ref[k].shape, k
        assert _rel(ref[k], y[k].numpy()) <= TOL, (k, _rel(ref[k], y[k]))


def test_mega_matches_compact_c12():
    tg, tm, s0 = _port(12)
    step_m = mega.make_fused_ssprk3_cov_mega(tg, G, OM, DT, tm.b_ext)
    step_c = tm.make_fused_step(DT)
    ym = yc = tm.compact_state(s0)
    for _ in range(3):
        ym = step_m(ym, 0.0)
        yc = step_c(yc, 0.0)
    for k in FIELDS:
        assert torch.equal(ym[k], yc[k]), (k, _rel(yc[k], ym[k]))


def test_split_route_core_differs_only_by_the_prescale():
    tg = build_grid(12, halo=2, radius=EARTH_RADIUS, device="cpu")
    n, h = tg.n, tg.halo
    rng = np.random.default_rng(17)
    sn = torch.from_numpy(rng.standard_normal((6, 6 * h, n)).astype(
        np.float32))
    we = torch.from_numpy(rng.standard_normal((6, n, 6 * h)).astype(
        np.float32))
    gsn, gwe = tsc.make_cov_strip_router_split(tg)(sn, we)
    usn, uwe = tsc._SplitRoute(tg)(sn, we)
    assert torch.equal(gsn[:, :6 * h], usn[:, :6 * h])
    assert torch.equal(gwe[:, :, :6 * h], uwe[:, :, :6 * h])
    # The router's sym rows: the core's times the edge sqrtg of the
    # closed-form frame, S, N along rows and W, E along columns.
    x_row, xf_row, x_col, xf_col, _ = coord_rows(n, h, "cpu")
    r = float(tg.radius)
    h0, h1 = h, h + n
    sg = [_fast_frame(x_row[:, h0:h1], xf_col[k:k + 1], r)["sqrtg"]
          for k in (h0, h1)]
    sg += [_fast_frame(xf_row[:, k:k + 1], x_col[h0:h1], r)["sqrtg"]
           for k in (h0, h1)]
    for s in range(2):
        assert torch.equal(gsn[:, 6 * h + s], usn[:, 6 * h + s]
                           * sg[s].reshape(n)), s
        assert torch.equal(gwe[:, :, 6 * h + s], uwe[:, :, 6 * h + s]
                           * sg[2 + s].reshape(n)), s + 2


def test_mega_interpret_runs_the_plain_version():
    tg, tm, s0 = _port(8)
    y = tm.compact_state(s0)
    a = mega.make_fused_ssprk3_cov_mega(tg, G, OM, DT, tm.b_ext)(y, 0.0)
    kern = mega.CovMegaStep(tg, G, OM, DT, interpret=True)
    b = kern(y["h"], y["u"], y["strips_sn"], y["strips_we"], tm.b_ext)
    for k, v in zip(FIELDS, b):
        assert torch.equal(a[k], v), k
    assert kern.blocks is None
