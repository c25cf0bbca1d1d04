"""Port parity: the neighbour-read covariant stepper.

``jaxstream_torch.experiments.swe_cov_nbr`` against the JAX package's
``jaxstream.experiments.swe_cov_nbr`` (its Pallas kernel in interpret
mode, as its own tests run it) and the jnp oracle, TC5, dt = 600 s,
float32.  Budgets:

* ``_nbr_tables`` and ``_edge_metric_rows``: bitwise;
* the port's plain stepper against the JAX interpret-mode stepper after
  1 and 3 steps at C8: 1e-6 of each field's max (f32 roundoff; XLA may
  contract multiply-adds), on the interiors and on the whole blocks:
  both write the ghost ring from the same input, the corners carried;
* against the JAX jnp oracle ``CovariantShallowWater.run``, 3 steps at
  C12: 2e-4, the JAX test's own budget (``tests/test_cov_swe.py:383``);
* mass over 10 steps at C12: 2e-6 relative, the budget of the JAX fused
  stepper (``tests/test_cov_swe.py:379``): both faces of an edge compute
  the same sym value, so the edge fluxes cancel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.experiments import swe_cov_nbr as jnbr
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.ops.fv import embed_interior as jax_embed
from jaxstream.ops.pallas.swe_rhs import coord_rows as jax_coord_rows
from jaxstream.physics.initial_conditions import williamson_tc5 as jax_tc5

from jaxstream_torch.experiments import swe_cov_nbr as nbr
from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops.cuda.swe_rhs import coord_rows
from jaxstream_torch.physics.initial_conditions import williamson_tc5

G, OM = EARTH_GRAVITY, EARTH_OMEGA
DT = 600.0
TOL = 1e-6
ORACLE_TOL = 2e-4
MASS_TOL = 2e-6


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _port(n):
    tg = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(tg, G, OM)
    tm = CovariantShallowWater(tg, gravity=G, omega=OM, b_ext=b)
    return tg, tm, tm.initial_state(h, v)


def _jax(n):
    jg = jax_build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    h, v, b = jax_tc5(jg, G, OM)
    jm = JaxCov(jg, gravity=G, omega=OM, b_ext=b)
    return jg, jm, jm.initial_state(h, v)


@pytest.mark.parametrize("n", [8, 12])
def test_nbr_tables_match_jax(n):
    jg = jax_build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    tg = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cpu")
    ours = nbr._nbr_tables(tg)
    theirs = jnbr._nbr_tables(jg)
    for a, b in zip(ours, theirs[:2]):
        assert tuple(a.shape) == np.asarray(b).shape
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n", [8, 12])
def test_edge_metric_rows_match_jax(n):
    x_row, _, x_col, _, _ = coord_rows(n, 2, "cpu")
    jx_row, _, jx_col, _, _ = jax_coord_rows(n, 2)
    ours = nbr._edge_metric_rows(x_row, x_col, n, 2, EARTH_RADIUS)
    theirs = jnbr._edge_metric_rows(jx_row, jx_col, n, 2, EARTH_RADIUS)
    assert set(ours) == set(theirs)
    for e in ours:
        for a, b in zip(ours[e], theirs[e]):
            assert tuple(a.shape) == np.asarray(b).shape == (1, n)
            assert np.array_equal(a.numpy(), np.asarray(b)), e


@pytest.fixture(scope="module")
def jax_nbr_c8():
    """Three steps of the JAX interpret-mode neighbour-read stepper at C8
    from the TC5 state embedded in zero ghost rings."""
    jg, jm, s0 = _jax(8)
    step = jax.jit(jnbr.make_fused_ssprk3_cov_nbr(jg, G, OM, DT, jm.b_ext,
                                                  interpret=True))
    y = {k: jax_embed(jg, v) for k, v in s0.items()}
    out = []
    for _ in range(3):
        y = step(y, 0.0)
        out.append({k: np.asarray(v) for k, v in y.items()})
    return out


@pytest.mark.parametrize("nsteps", [1, 3])
def test_nbr_steps_match_jax_interpret(jax_nbr_c8, nsteps):
    tg, tm, s0 = _port(8)
    step = nbr.make_fused_ssprk3_cov_nbr(tg, G, OM, DT, tm.b_ext)
    assert [type(s) for s in step.stages] == [nbr.CovStageNbr] * 3
    before = nbr.CovStageNbr.launches
    y = tm.extend_state(s0)
    for _ in range(nsteps):
        y = step(y, 0.0)
    assert nbr.CovStageNbr.launches == before      # plain: no launch
    ref = jax_nbr_c8[nsteps - 1]
    assert set(y) == set(ref) == {"h", "u"}
    inner = tm.restrict_state(y)
    h = tg.halo
    for k in ("h", "u"):
        assert tuple(y[k].shape) == ref[k].shape, k
        assert _rel(ref[k], y[k].numpy()) <= TOL, (k, _rel(ref[k], y[k]))
        assert _rel(ref[k][..., h:-h, h:-h], inner[k].numpy()) <= TOL, k


@pytest.mark.parametrize("stage", [0, 1, 2], ids=["stage1", "stage2",
                                                   "stage3"])
def test_nbr_stage_matches_jax_interpret(stage):
    """One stage on a perturbed state with random ghost corners, which the
    stage carries into its output (scaled)."""
    jg, jm, js0 = _jax(8)
    tg, tm, s0 = _port(8)
    a, b = nbr.SSPRK3_COEFFS[stage]
    rng = np.random.default_rng(11 + stage)
    ye = tm.extend_state(s0)
    y0 = {k: v.clone() for k, v in ye.items()}
    yc = {k: v * torch.from_numpy((1.0 + 1e-3 * rng.standard_normal(
        v.shape)).astype(np.float32)) for k, v in ye.items()}
    for q in list(y0.values()) + list(yc.values()):
        for c in ((slice(0, 2), slice(0, 2)), (slice(-2, None),) * 2):
            q[(...,) + c] = torch.from_numpy(rng.uniform(
                0.5, 1.0, q[(...,) + c].shape).astype(np.float32)) * float(
                    q.abs().max())
    args = (yc["h"], yc["u"], tm.b_ext)
    if a != 0.0:
        args = (y0["h"], y0["u"]) + args
    st = nbr.make_cov_stage_nbr(tg, G, OM, DT, a, b)
    out = st(*args)
    jout = jnbr.make_cov_stage_nbr(jg, G, OM, DT, a, b, interpret=True)(
        *[jnp.asarray(t.numpy()) for t in args])
    for name, x, y in zip(("h", "u"), jout, out):
        assert _rel(x, y.numpy()) <= TOL, (name, _rel(x, y.numpy()))
    base = 0.0 if a == 0.0 else st.fa * y0["h"][:, :2, :2]
    assert torch.equal(out[0][:, :2, :2], base + st.fb * yc["h"][:, :2, :2])


def test_nbr_matches_jnp_oracle_c12():
    jg, jm, js0 = _jax(12)
    ref, _ = jm.run(js0, 3, DT)
    tg, tm, s0 = _port(12)
    step = nbr.make_fused_ssprk3_cov_nbr(tg, G, OM, DT, tm.b_ext)
    y = tm.extend_state(s0)
    for _ in range(3):
        y = step(y, 0.0)
    out = tm.restrict_state(y)
    for k in ("h", "u"):
        assert _rel(ref[k], out[k].numpy()) <= ORACLE_TOL, k


def test_nbr_conserves_mass_c12():
    tg, tm, s0 = _port(12)
    step = nbr.make_fused_ssprk3_cov_nbr(tg, G, OM, DT, tm.b_ext)
    area = tg.interior(tg.area).double()
    m0 = float((area * s0["h"].double()).sum())
    y = tm.extend_state(s0)
    for _ in range(10):
        y = step(y, 0.0)
    h1 = tm.restrict_state(y)["h"].double()
    assert bool(torch.isfinite(h1).all())
    assert abs(float((area * h1).sum()) - m0) / m0 < MASS_TOL


def test_nbr_interpret_runs_the_plain_version():
    tg, tm, s0 = _port(8)
    y = tm.extend_state(s0)
    a = nbr.make_fused_ssprk3_cov_nbr(tg, G, OM, DT, tm.b_ext)(y, 0.0)
    b = nbr.make_fused_ssprk3_cov_nbr(tg, G, OM, DT, tm.b_ext,
                                      interpret=True)(y, 0.0)
    for k in ("h", "u"):
        assert torch.equal(a[k], b[k]), k
