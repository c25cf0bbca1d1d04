"""Port parity: ``jaxstream_torch.utils.profiling`` against
``jaxstream.utils.profiling``.

* ``analytic_cov_step_cost``: the same dict, exactly, over a grid of
  arguments, and the same errors;
* ``HardwareRoof``, ``Roofline`` (every property, ``report()``) and
  ``mixed_vpu_roof``: equal on the same roofs (the JAX package's roofs,
  rebuilt field by field: the port carries no TPU constant);
* ``StepTimer``: the same percentiles, stats and sim-days/s on the same
  samples;
* ``steady_state_rate`` and ``median_chain_seconds`` on CPU run
  functions, with both modules' clocks replaced by the same scripted
  clock: the same results, and the same three-attempt guard;
* the CPU forms of ``block_until_ready``, ``device_seconds`` and
  ``trace``.
"""

import itertools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

from jaxstream.utils import profiling as jp

from jaxstream_torch.utils import profiling as tp


def _roof(r):
    """The port's HardwareRoof with a JAX roof's fields."""
    return tp.HardwareRoof(r.name, r.hbm_gbps, r.peak_tflops)


@pytest.mark.parametrize("nu4, precision", list(itertools.product(
    [None, "split", "refused"], [None, "f32", "bf16"])))
def test_analytic_cost_matches_jax(nu4, precision):
    for n, limiter, stages, ens, carry in itertools.product(
            [8, 48, 384], ["mc", "minmod", "none", "vanleer", "ppm"],
            [1, 3], [1, 4], [None, 2]):
        kw = dict(limiter=limiter, stages=stages, ensemble=ens,
                  carry_bytes=carry, nu4=nu4, precision=precision)
        assert tp.analytic_cov_step_cost(n, **kw) == \
            jp.analytic_cov_step_cost(n, **kw), (n, kw)


@pytest.mark.parametrize("kw", [{"ensemble": 0}, {"nu4": "stage"},
                                {"precision": "fp8"}])
def test_analytic_cost_errors_match_jax(kw):
    with pytest.raises(ValueError) as jerr:
        jp.analytic_cov_step_cost(384, **kw)
    with pytest.raises(ValueError) as terr:
        tp.analytic_cov_step_cost(384, **kw)
    assert str(terr.value) == str(jerr.value)


_PROPS = ("ai", "achieved_tflops", "achieved_gbps", "bound", "binding",
          "roof_tflops", "efficiency")


@pytest.mark.parametrize("roof", [jp.TPU_V4_CLASS, jp.TPU_V5E, jp.TPU_V5E_VPU],
                         ids=lambda r: r.name)
@pytest.mark.parametrize("nu4", [None, "split"])
def test_roofline_matches_jax(roof, nu4):
    cost = tp.analytic_cov_step_cost(384, nu4=nu4)
    assert _roof(roof).ridge == roof.ridge
    for seconds in (2.5e-4, 3.1e-3, 1.7e-2):
        t = tp.roofline(cost, seconds, _roof(roof))
        j = jp.Roofline(cost["flops"], cost["bytes"], seconds, roof)
        for prop in _PROPS:
            assert getattr(t, prop) == getattr(j, prop), prop
        assert t.report() == j.report()


def test_roofline_zero_bytes_and_default_roof():
    t = tp.Roofline(1e9, 0.0, 1.0, tp.H100_SXM5)
    assert t.ai == float("inf") and t.bound == "compute"
    assert tp.roofline({"flops": 1.0, "bytes": 4.0}, 1.0).roof is tp.H100_SXM5
    assert tp.H100_SXM5.ridge == 67e12 / 3350e9
    assert "H100" in tp.H100_SXM5.name


@pytest.mark.parametrize("phi", [0.0, 0.28, 1.0])
def test_mixed_roof_matches_jax(phi):
    j = jp.mixed_vpu_roof(phi, jp.TPU_V5E_VPU, jp.TPU_V5E_VPU_BF16)
    t = tp.mixed_vpu_roof(phi, _roof(jp.TPU_V5E_VPU),
                          _roof(jp.TPU_V5E_VPU_BF16))
    assert (t.name, t.hbm_gbps, t.peak_tflops) == (j.name, j.hbm_gbps,
                                                   j.peak_tflops)


def test_mixed_roof_rejects_fraction():
    with pytest.raises(ValueError, match="bf16_fraction"):
        tp.mixed_vpu_roof(1.5, tp.H100_SXM5, tp.H100_SXM5)


@pytest.mark.parametrize("n", [1, 2, 7, 10, 101])
def test_step_timer_matches_jax(n):
    rng = np.random.default_rng(n)
    samples = list(rng.uniform(1e-3, 5e-3, n + 1))
    jt, tt = jp.StepTimer(), tp.StepTimer()
    jt.samples = list(samples)
    tt.samples = list(samples)
    assert tt.stats() == jt.stats()
    assert tt.sim_days_per_sec(75.0, 3) == jt.sim_days_per_sec(75.0, 3)


def test_step_timer_times_and_discards():
    timer = tp.StepTimer(discard=2)
    out = timer.time(lambda x: x + 1, torch.zeros(3), reps=4)
    assert torch.equal(out, torch.ones(3))
    assert len(timer.samples) == 6 and len(timer.kept) == 4
    assert tp.StepTimer().stats() == {}
    assert tp.StepTimer().sim_days_per_sec(60.0) == 0.0


class _Clock:
    """A scripted ``perf_counter``: ``advance`` moves it."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, s):
        self.now += s


def _rate(module, monkeypatch, per_step, intercepts, k1, k2, make_y):
    """``module.steady_state_rate`` of a run whose windows take
    ``intercept + k * per_step`` on the scripted clock; the window's
    intercepts cycle through ``intercepts``."""
    clock = _Clock()
    monkeypatch.setattr(module.time, "perf_counter", clock)
    calls = []

    def run(y, k):
        calls.append(k)
        clock.advance(intercepts[(len(calls) - 1) % len(intercepts)]
                      + k * per_step)
        return y + k

    rate, y = module.steady_state_rate(run, make_y(0.0), k1, k2)
    return rate, float(y), calls


@pytest.mark.parametrize("intercepts", [[0.1], [0.5, 0.0, 0.1, 0.2]],
                         ids=["steady", "one_retry"])
def test_steady_state_rate_matches_jax(monkeypatch, intercepts):
    """The same rate and carry on the same scripted windows; a first pair
    with T2 <= T1 is measured again."""
    t = _rate(tp, monkeypatch, 1e-3, intercepts, 30, 150,
              lambda v: torch.tensor(v))
    j = _rate(jp, monkeypatch, 1e-3, intercepts, 30, 150,
              lambda v: jnp.asarray(v))
    assert t == j
    assert len(t[2]) == (2 if len(intercepts) == 1 else 4)   # windows run


def test_steady_state_rate_gives_up_after_three_attempts(monkeypatch):
    for module, make_y in ((tp, torch.tensor), (jp, jnp.asarray)):
        with pytest.raises(RuntimeError, match="after 3 attempts"):
            _rate(module, monkeypatch, 1e-6, [1.0, 0.0], 30, 150, make_y)


def test_median_chain_seconds_matches_jax(monkeypatch):
    durations = [9.0, 0.5, 0.3, 0.9, 0.4, 0.2]    # the first is discarded
    res = []
    for module, make in ((tp, torch.ones), (jp, jnp.ones)):
        clock = _Clock()
        monkeypatch.setattr(module.time, "perf_counter", clock)
        it = iter(durations)

        def fn(x):
            clock.advance(next(it))
            return x * 2

        res.append(module.median_chain_seconds(fn, (make(3),), iters=10))
    assert res[0] == res[1] == pytest.approx(0.04, rel=1e-12)


def test_block_until_ready_on_cpu_returns_its_argument():
    tree = {"a": [torch.ones(2), (torch.zeros(1),)], "b": 3}
    assert tp.block_until_ready(tree) is tree
    assert tp._first_cuda_tensor(tree) is None


def test_device_seconds_and_trace_on_cpu(tmp_path):
    seen = []
    assert tp.device_seconds(lambda: seen.append(1)) is None
    assert seen == [1]
    with tp.trace(str(tmp_path / "tr")):
        torch.ones(8) @ torch.ones(8)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert events["traceEvents"]
