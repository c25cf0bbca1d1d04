"""Port parity: the extended-carry fused stepper (``compact=False``).

The packed strip carry, the loop and linear strip routers, the stage
with the ghost fill in the kernel, and the stepper, against the JAX
package (its Pallas kernels in interpret mode at C8, as its own tests run
them) and against the port's compact stepper.  Budgets:

* ``pack_strips_cov``: bitwise (a gather);
* the routers on random strips: ghost blocks bitwise against the JAX
  linear router, sym rows within 2 float32 ulp of their scale (XLA on
  the CPU may contract ``a*b + c*d`` into a fused multiply-add); the
  port's linear router against its loop router: bitwise;
* the plain stage against ``make_cov_stage_inkernel(interpret=True)`` on
  the same routed ghosts, as stage 1 and stage 2: 1e-6 of each output's
  max (f32 roundoff), on the whole extended blocks (ghost ring and
  corners included) and the strips;
* one ``compact=False`` step against the JAX stepper: 1e-6;
* the port's compact and extended steppers after 3 steps at C12:
  interiors and strips bitwise, as ``tests/test_cov_swe.py:329`` holds
  the JAX package's.
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
from jaxstream.physics.initial_conditions import williamson_tc5 as jax_tc5

from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.interop import to_numpy, to_torch
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.ops.cuda import swe_cov as tsc
from jaxstream_torch.physics.initial_conditions import williamson_tc5

G, OM = EARTH_GRAVITY, EARTH_OMEGA
EPS32 = float(np.finfo(np.float32).eps)
TOL = 1e-6
DT = 600.0


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _port(n):
    tg = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cpu")
    h, v, b = williamson_tc5(tg, G, OM)
    tm = CovariantShallowWater(tg, gravity=G, omega=OM, b_ext=b)
    return tg, tm, tm.initial_state(h, v)


def _with_corners(q, h, rng):
    """``q`` with its h x h ghost corners set to random values of its
    scale: the stage keeps them in its output, scaled."""
    q = q.clone()
    scale = float(q.abs().max())
    for rs in (slice(0, h), slice(-h, None)):
        for cs in (slice(0, h), slice(-h, None)):
            shape = q[..., rs, cs].shape
            q[..., rs, cs] = torch.from_numpy(
                (scale * rng.uniform(0.5, 1.0, shape)).astype(np.float32))
    return q


def test_pack_strips_cov_bitwise():
    rng = np.random.default_rng(5)
    n, h = 8, 2
    m = n + 2 * h
    he = rng.standard_normal((6, m, m)).astype(np.float32)
    ue = rng.standard_normal((2, 6, m, m)).astype(np.float32)
    js = jsc.pack_strips_cov(jnp.asarray(he), jnp.asarray(ue), n, h)
    ts = tsc.pack_strips_cov(torch.from_numpy(he), torch.from_numpy(ue), n, h)
    assert np.array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("n", [8, 12])
def test_routers_match_jax_linear(n):
    jg = jax_build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    tg = build_grid(n, halo=2, radius=EARTH_RADIUS, device="cpu")
    R = 12 * tg.halo
    rng = np.random.default_rng(7)
    strips = rng.standard_normal((6, R, n)).astype(np.float32)
    ref = np.asarray(jsc.make_cov_strip_router_linear(jg)(
        jnp.asarray(strips)))
    lin = tsc.make_cov_strip_router_linear(tg)(torch.from_numpy(strips))
    loop = tsc.make_cov_strip_router(tg)(torch.from_numpy(strips))
    assert torch.equal(lin, loop)
    assert tuple(lin.shape) == ref.shape == (6, R + 4, n)
    assert np.array_equal(lin[:, :R].numpy(), ref[:, :R])
    err = float(np.max(np.abs(lin[:, R:].numpy() - ref[:, R:])))
    assert err <= 2 * EPS32 * float(np.max(np.abs(ref[:, R:]))), err


@pytest.fixture(scope="module")
def c8():
    """TC5 at C8 in both packages: the JAX model (pallas_interpret), the
    port's model, and the extended carry of the state, as JAX arrays."""
    jg = jax_build_grid(8, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    h, v, b = jax_tc5(jg, G, OM)
    jm = JaxCov(jg, gravity=G, omega=OM, b_ext=b, backend="pallas_interpret")
    tg, tm, _ = _port(8)
    return jg, tg, jm, tm, jm.extend_state(jm.initial_state(h, v),
                                           with_strips=True)


@pytest.mark.parametrize("stage", [0, 1], ids=["stage1", "stage2"])
def test_stage_matches_jax_interpret(c8, stage):
    jg, tg, jm, tm, jy = c8
    a, b = tsc.SSPRK3_COEFFS[stage]
    h = tg.halo
    rng = np.random.default_rng(3 + stage)
    # The stage input: the state perturbed, with random ghost corners
    # (the output's ghost ring and corners are held too).
    yc = {k: _with_corners(to_torch(jy[k], device="cpu") * torch.from_numpy(
        (1.0 + 1e-3 * rng.standard_normal(jy[k].shape)).astype(np.float32)),
        h, rng) for k in ("h", "u")}
    y0 = {k: _with_corners(to_torch(jy[k], device="cpu"), h, rng)
          for k in ("h", "u")}
    ghosts = jsc.make_cov_strip_router_linear(jg)(
        jsc.pack_strips_cov(jnp.asarray(yc["h"].numpy()),
                            jnp.asarray(yc["u"].numpy()), tg.n, h))
    args = (yc["h"], yc["u"], to_torch(ghosts, device="cpu"), tm.b_ext)
    if a != 0.0:
        args = (y0["h"], y0["u"]) + args

    st = tsc.make_cov_stage_inkernel(tg.n, h, tg.dalpha, tg.radius, G, OM,
                                     DT, a, b, device="cpu")
    before = tsc.CovStageInkernel.launches
    out = st(*args)
    assert tsc.CovStageInkernel.launches == before     # plain: no launch
    jout = jsc.make_cov_stage_inkernel(
        tg.n, h, float(tg.dalpha), float(tg.radius), G, OM, DT, a, b,
        interpret=True)(*[jnp.asarray(t.numpy()) for t in args])
    for name, x, y in zip(("h", "u", "strips"), jout, out):
        assert tuple(y.shape) == np.asarray(x).shape, name
        assert _rel(x, y.numpy()) <= TOL, (name, _rel(x, y.numpy()))
    # The ring keeps a*y0 + b*frame: the corners are the input's.
    i1 = tg.n + h
    base = 0.0 if a == 0.0 else st.fa * y0["h"][:, :h, :h]
    assert torch.equal(out[0][:, :h, :h], base + st.fb * yc["h"][:, :h, :h])
    assert torch.equal(out[2], tsc.pack_strips_cov(out[0], out[1], tg.n, h))
    assert not torch.equal(out[0][:, i1:, h:i1], yc["h"][:, i1:, h:i1])


def test_extended_step_matches_jax_interpret(c8):
    jg, tg, jm, tm, jy = c8
    jy1 = jm.make_fused_step(DT, compact=False)(jy, 0.0)
    ty1 = tm.make_fused_step(DT, compact=False)(to_torch(jy, device="cpu"),
                                                0.0)
    assert set(ty1) == set(jy1) == {"h", "u", "strips"}
    for k, v in to_numpy(ty1).items():
        assert _rel(jy1[k], v) <= TOL, (k, _rel(jy1[k], v))


def test_compact_vs_extended_bitwise():
    """Same arithmetic, another carry: after 3 steps at C12 the interiors
    and the strips are equal bit for bit."""
    tg, tm, s0 = _port(12)
    step_c = tm.make_fused_step(DT)
    step_e = tm.make_fused_step(DT, compact=False)
    assert [type(s) for s in step_e.stages] == [tsc.CovStageInkernel] * 3
    yc = tm.compact_state(s0)
    ye = tm.extend_state(s0, with_strips=True)
    for _ in range(3):
        yc = step_c(yc, 0.0)
        ye = step_e(ye, 0.0)
    out_c, out_e = tm.restrict_state(yc), tm.restrict_state(ye)
    for k in ("h", "u"):
        assert torch.equal(out_c[k], out_e[k]), k
    ext = tm.extend_state(out_c)
    assert torch.equal(ye["strips"], tsc.pack_strips_cov(
        ext["h"], ext["u"], tg.n, tg.halo))


def test_extend_and_restrict_state():
    tg, tm, s0 = _port(8)
    ye = tm.extend_state(s0, with_strips=True)
    assert tuple(ye["h"].shape) == (6, tg.m, tg.m)
    assert tuple(ye["strips"].shape) == (6, 12 * tg.halo, tg.n)
    assert set(tm.extend_state(s0)) == {"h", "u"}
    for y in (ye, tm.compact_state(s0)):
        back = tm.restrict_state(y)
        assert set(back) == {"h", "u"}
        for k in ("h", "u"):
            assert torch.equal(back[k], s0[k]), k
