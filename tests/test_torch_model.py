"""Port parity: the model end to end, and the knobs it refuses.

* Three fused steps of the port at C12 against three steps of the JAX
  jnp path: <= 2e-4 of max, the JAX package's own fused-vs-jnp budget
  (``tests/test_cov_swe.py::test_cov_fused_step_parity``).
* The port's classic path against the JAX jnp path at float32.
* Mass drift of the port's fused stepper over 10 steps at C16: < 2e-6,
  the JAX package's budget for its fused stepper.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.physics.initial_conditions import williamson_tc5 as jax_tc5

from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.physics.initial_conditions import williamson_tc5
from jaxstream_torch.stepping import integrate, make_stepper
from jaxstream_torch.utils.diagnostics import total_mass

DT = 600.0


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _port(n):
    g = build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=torch.float32,
                   device="cpu")
    h, v, b = williamson_tc5(g, EARTH_GRAVITY, EARTH_OMEGA)
    m = CovariantShallowWater(g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                              b_ext=b)
    return g, m, m.initial_state(h, v)


@pytest.fixture(scope="module")
def jax_ref_c12():
    g = jax_build_grid(12, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    h, v, b = jax_tc5(g, EARTH_GRAVITY, EARTH_OMEGA)
    ref = JaxCov(g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA, b_ext=b)
    out, _ = ref.run(ref.initial_state(h, v), 3, DT)
    return {k: np.asarray(v) for k, v in out.items()}


def test_fused_three_steps_match_jax_jnp(jax_ref_c12):
    g, m, s0 = _port(12)
    y, t = integrate(m.make_fused_step(DT), m.compact_state(s0), 0.0, 3, DT)
    assert t == 3 * DT
    out = m.restrict_state(y)
    for k in ("h", "u"):
        assert _rel(jax_ref_c12[k], out[k].numpy()) <= 2e-4, k


def test_classic_three_steps_match_jax_jnp(jax_ref_c12):
    g, m, s0 = _port(12)
    out, _ = m.run(s0, 3, DT)
    for k in ("h", "u"):
        # Same discretization, same op order, f32: roundoff (~1e-6).
        assert _rel(jax_ref_c12[k], out[k].numpy()) <= 1e-5, k


def test_fused_matches_classic_port():
    g, m, s0 = _port(12)
    yf, _ = integrate(m.make_fused_step(DT), m.compact_state(s0), 0.0, 3, DT)
    yc, _ = integrate(make_stepper(m.rhs, DT), s0, 0.0, 3, DT)
    for k in ("h", "u"):
        assert _rel(yc[k].numpy(), yf[k].numpy()) <= 2e-4, k


def test_fused_step_conserves_mass():
    g, m, s0 = _port(16)
    area = g.interior(g.area).double()
    m0 = float(torch.sum(area * s0["h"].double()))
    y, _ = integrate(m.make_fused_step(DT), m.compact_state(s0), 0.0, 10, DT)
    h1 = y["h"].double()
    assert bool(torch.all(torch.isfinite(h1)))
    m1 = float(torch.sum(area * h1))
    assert abs(m1 - m0) / abs(m0) < 2e-6, (m1 - m0) / m0
    # total_mass is the same area-weighted integral, in the state dtype.
    assert abs(float(total_mass(g, y["h"])) - m1) / m1 < 1e-6


@pytest.mark.parametrize("kwargs, item", [
    ({"compact": False, "temporal_block": 2}, "queue A item 5"),
    ({"carry_dtype": torch.bfloat16}, "queue A item 5"),
    ({"h_offset": 5000.0}, "queue A item 5"),
    ({"temporal_block": 2}, "queue A item 5"),
    ({"ensemble": 2}, "queue A item 5"),
    ({"precision": "bf16"}, "queue A item 5"),
])
def test_unported_knobs_raise(kwargs, item):
    g, m, _ = _port(8)
    with pytest.raises(NotImplementedError, match=item):
        m.make_fused_step(DT, **kwargs)


@pytest.mark.parametrize("nu4, kwargs, match", [
    (1.0e14, {}, "nu4 > 0 requires the compact carry"),
    (0.0, {"ensemble": 2}, "ensemble > 0 requires the compact carry"),
    (0.0, {"carry_dtype": torch.bfloat16}, "require the compact carry"),
    (0.0, {"h_offset": 5000.0}, "require the compact carry"),
])
def test_extended_carry_refusals(nu4, kwargs, match):
    """The JAX package's refusals of ``compact=False``, as ValueError."""
    g = build_grid(8, device="cpu")
    m = CovariantShallowWater(g, gravity=9.8, omega=0.0, nu4=nu4)
    with pytest.raises(ValueError, match=match):
        m.make_fused_step(DT, compact=False, **kwargs)


@pytest.mark.parametrize("nu4_mode", ["refused", "stage"])
def test_nu4_mode_ignored_without_nu4(nu4_mode):
    """With nu4 == 0 the fused step is the compact stepper whatever
    ``nu4_mode`` says, as in the JAX package."""
    from jaxstream_torch.ops.cuda.swe_cov import CovStageCompact

    g, m, s0 = _port(8)
    step = m.make_fused_step(DT, nu4_mode=nu4_mode)
    assert not hasattr(step, "filter") and not hasattr(step, "stage1f")
    assert [type(st) for st in step.stages] == [CovStageCompact] * 3
    y = m.compact_state(s0)
    plain = m.make_fused_step(DT)(y, 0.0)
    for k, v in step(y, 0.0).items():
        assert torch.equal(v, plain[k]), k


def test_unported_model_options_raise():
    g = build_grid(8, device="cpu")
    # nu4 > 0 is ported: the model builds, and its fused step is the
    # split del^4 stepper (tests/test_torch_nu4.py).
    m = CovariantShallowWater(g, gravity=9.8, omega=0.0, nu4=1e14)
    assert m.nu4 == 1e14 and m.make_fused_step(1.0).filter.nu4 == 1e14
    with pytest.raises(NotImplementedError, match="PPM"):
        CovariantShallowWater(g, gravity=9.8, omega=0.0, scheme="ppm")
    # Every scheme of the JAX package is ported; an unknown one is refused
    # by the scheme table, as there.
    with pytest.raises(KeyError):
        CovariantShallowWater(g, gravity=9.8, omega=0.0).make_step(
            1.0, scheme="rk2")
    g64 = build_grid(8, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        CovariantShallowWater(g64, gravity=9.8, omega=0.0).make_fused_step(1.0)
