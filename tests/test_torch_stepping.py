"""Port parity: the time carry of ``integrate`` and the limiter refusal.

* ``integrate``'s time carry against the JAX package's compiled loop,
  bit for bit: float32 (the JAX default, ``jax_enable_x64`` off) against
  the port under torch's default float32, float64 (x64 on, as the suite
  runs JAX) against the port under a float64 default dtype.  The JAX loop
  runs 4 steps per iteration and XLA folds their ``+ dt`` adds
  into one add of the running sum, so the times differ from one ``+ dt``
  per step: dt = 0.1 s for 1 000 steps gives 100.00023651 in float32
  (99.99904633 one add at a time);
* a limiter the port lacks is refused when the model is built, not by a
  ``KeyError`` at the first step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxstream.stepping import integrate as jax_integrate

from jaxstream_torch.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.models.shallow_water import ShallowWater
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.stepping import integrate, time_carry


def _jax_times(nsteps, t0, dt, x64):
    """The times the JAX package's ``integrate`` hands its steps, and its
    final time, under ``jax_enable_x64 = x64`` (its default unroll)."""
    def step(y, t):
        return {"ts": y["ts"].at[y["i"]].set(t), "i": y["i"] + 1}

    with jax.enable_x64(x64):
        y, t = jax_integrate(step, {"ts": jnp.zeros(nsteps, float),
                                    "i": jnp.int32(0)}, t0, nsteps, dt)
        return np.asarray(y["ts"]), np.asarray(t)


def _port_times(nsteps, t0, dt, dtype):
    seen = []
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        _, t = integrate(lambda y, t: seen.append(t) or y, {}, t0, nsteps,
                         dt)
    finally:
        torch.set_default_dtype(old)
    return seen, t


@pytest.mark.parametrize("dtype, x64, expect", [
    (torch.float32, False, "100.00023651"),
    (torch.float64, True, "100.00000000"),
], ids=["float32", "float64"])
def test_time_carry_1000_steps_matches_jax(dtype, x64, expect):
    _, t_jax = _jax_times(1000, 0.0, 0.1, x64)
    _, t = _port_times(1000, 0.0, 0.1, dtype)
    assert t.dtype == t_jax.dtype
    assert t == t_jax and f"{t:.8f}" == expect


@pytest.mark.parametrize("dtype, x64", [(torch.float32, False),
                                        (torch.float64, True)],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("nsteps", [3, 11])
def test_step_times_match_jax(dtype, x64, nsteps):
    """Every time a step sees, within the unrolled iterations and in the
    remainder loop, bitwise."""
    ts_jax, t_jax = _jax_times(nsteps, 0.7, 0.1, x64)
    seen, t = _port_times(nsteps, 0.7, 0.1, dtype)
    assert np.array_equal(np.asarray(seen, ts_jax.dtype), ts_jax)
    assert t == t_jax


def test_time_carry_is_a_host_scalar_of_the_default_dtype():
    assert time_carry(0.1).dtype == np.float32
    assert time_carry(np.float64(0.1)) == np.float32(0.1)


@pytest.mark.parametrize("model", [CovariantShallowWater, ShallowWater])
@pytest.mark.parametrize("limiter", ["vanleer", "mc_sign"])
def test_unported_limiter_refused_at_construction(model, limiter):
    g = build_grid(8, halo=2, radius=EARTH_RADIUS, device="cpu")
    with pytest.raises(NotImplementedError, match="queue A item 1"):
        model(g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA, limiter=limiter)
