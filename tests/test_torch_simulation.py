"""Port parity: the config-driven run (``Simulation``, ``run_from_config``
and ``python -m jaxstream_torch``) against the JAX package's.

* The classic ``jnp`` path, with history and checkpoint strides on, for
  tc1, checkerboard, tc2, tc5 (Cartesian and covariant) and galewsky:
  final states and ``diagnostics()`` within 1e-12 relative at float64,
  1e-5 at float32 (the budget of ``tests/test_torch_model.py``); step
  count, ``t`` and the history's times exactly equal.
* The fused path (covariant ``backend: pallas``, the kernels' plain
  versions on the CPU) against the JAX jnp run: <= 2e-4 after 3 steps
  (``tests/test_cov_swe.py``'s fused-vs-jnp budget); bitwise equal to
  the fused stepper driven by ``integrate`` with the same segmentation.
* The same stepper (compact fused, extended fused or classic) as the JAX
  package's for a grid of model x backend x nu4 x nu4_mode x scheme, and
  the same refusals.
* Resume from a checkpoint is bitwise; checkpoints cross the packages.
* Every knob the port does not run raises ``NotImplementedError`` naming
  its ROADMAP item, and a fused factory's failure is never a fallback.

The time carry follows torch's default dtype, the port's counterpart of
``jax_enable_x64`` (on in this suite): the module runs at float64.
"""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

from jaxstream.__main__ import main as jax_main
from jaxstream.io.checkpoint import CheckpointManager as JaxCkpt
from jaxstream.io.history import HistoryWriter as JaxHist
from jaxstream.simulation import Simulation as JaxSim

from jaxstream_torch.__main__ import main
from jaxstream_torch.io.checkpoint import CheckpointManager
from jaxstream_torch.io.history import HistoryWriter
from jaxstream_torch.io.regrid import regrid_state
from jaxstream_torch.parallel.sharded_model import make_stepper_for
from jaxstream_torch.simulation import Simulation, run_from_config
from jaxstream_torch.stepping import integrate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 600.0
NSTEPS = 6
BUDGET = {"float64": 1e-12, "float32": 1e-5}

#: case -> (initial_condition, model.name, grid dtype, hyperdiffusion,
#: checkpoint stride)
CASES = {
    "tc1": ("tc1", "auto", "float32", 0.0, 0),
    "checkerboard": ("checkerboard", "auto", "float64", 0.0, 0),
    "tc2": ("tc2", "auto", "float32", 0.0, 0),
    "tc5_cartesian": ("tc5", "auto", "float64", 0.0, 3),
    "tc5_covariant": ("tc5", "shallow_water_cov", "float32", 0.0, 3),
    "galewsky": ("galewsky", "shallow_water_cov", "float32", 1.0e15, 0),
}


@pytest.fixture(scope="module", autouse=True)
def _f64_time_carry_and_quiet_logs():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    levels = {}
    for name in ("jaxstream", "jaxstream_torch"):
        lg = logging.getLogger(name)
        levels[name] = lg.level
        lg.setLevel(logging.WARNING)
    yield
    torch.set_default_dtype(old)
    for name, lvl in levels.items():
        logging.getLogger(name).setLevel(lvl)


def _cfg(case, root, nsteps=NSTEPS, backend="jnp", n=8, **over):
    ic, name, dtype, nu4, ckpt = CASES[case]
    cfg = {
        "grid": {"n": n, "halo": 2, "dtype": dtype},
        "model": {"name": name, "initial_condition": ic,
                  "backend": backend},
        "physics": {"hyperdiffusion": nu4},
        "time": {"dt": DT, "nsteps": nsteps},
        "parallelization": {"num_devices": 1, "device_type": "tpu"},
        "io": {"history_path": os.path.join(str(root), "hist"),
               "history_stride": 3,
               "checkpoint_path": os.path.join(str(root), "ckpt"),
               "checkpoint_stride": ckpt},
    }
    for sec, d in over.items():
        cfg[sec] = {**cfg.get(sec, {}), **d}
    return cfg


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(a, b):
    a, b = np.asarray(_np(a), np.float64), np.asarray(_np(b), np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def _jax_kind(sim):
    if sim._fused_step is None:
        return "classic"
    return "compact" if hasattr(sim.model, "compact_state") else "extended"


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's runs, one per case, built on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            root = tmp_path_factory.mktemp(f"jax_{case}")
            sim = JaxSim(_cfg(case, root))
            sim.run()
            cache[case] = {
                "root": root, "kind": _jax_kind(sim),
                "state": {k: np.asarray(v) for k, v in sim.state.items()},
                "diag": sim.diagnostics(), "t": sim.t,
                "steps": sim.step_count,
                "hist": JaxHist(os.path.join(str(root), "hist")),
            }
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_classic_run_matches_jax(case, jax_runs, tmp_path):
    ref = jax_runs(case)
    dtype = CASES[case][2]
    sim = Simulation(_cfg(case, tmp_path), device="cpu")
    assert sim.stepper_kind == ref["kind"] == "classic"
    sim.run()
    assert sim.step_count == ref["steps"] == NSTEPS
    assert sim.t == ref["t"]
    assert set(sim.state) == set(ref["state"])
    for k, v in sim.state.items():
        assert v.dtype == getattr(torch, dtype)
        assert _rel(ref["state"][k], v) <= BUDGET[dtype], k
    diag = sim.diagnostics()
    assert set(diag) == set(ref["diag"])
    for k, v in diag.items():
        assert abs(v - ref["diag"][k]) <= BUDGET[dtype] * abs(ref["diag"][k])
    hist = HistoryWriter(os.path.join(str(tmp_path), "hist"))
    np.testing.assert_array_equal(hist.times, ref["hist"].times)
    for k in ref["state"]:
        assert _rel(ref["hist"].read(k), hist.read(k)) <= BUDGET[dtype], k
    if CASES[case][4]:
        assert CheckpointManager(sim.config.io.checkpoint_path).steps() \
            == [3, 6]


@pytest.mark.parametrize("case", ["tc5_covariant", "galewsky"])
def test_fused_run_matches_jax_jnp(case, jax_runs, tmp_path):
    """The compact fused stepper (split del^4 for galewsky) against the
    JAX jnp run's step-3 snapshot."""
    ref = jax_runs(case)
    cfg = _cfg(case, tmp_path, nsteps=3, backend="pallas",
               io={"history_stride": 0, "checkpoint_stride": 0})
    sim = Simulation(cfg, device="cpu")
    assert sim.stepper_kind == "compact"
    sim.run()
    assert sim.t == ref["hist"].times[1] == 3 * DT
    for k, v in sim.state.items():
        assert _rel(ref["hist"].read(k)[1], v) <= 2e-4, k


def test_fused_run_is_the_stepper_with_its_segmentation(tmp_path):
    cfg = _cfg("galewsky", tmp_path, nsteps=7, backend="pallas",
               io={"history_stride": 3, "checkpoint_stride": 2})
    sim = Simulation(cfg, device="cpu")
    sim.run()
    m = sim.model
    step = m.make_fused_step(DT)
    y, t = Simulation(dict(cfg, io={}), device="cpu").state, 0.0
    for _ in range(7):                   # gcd(3, 2) = 1-step segments
        yc, t = integrate(step, m.compact_state(y), float(t), 1, DT)
        y = m.restrict_state(yc)
    assert float(t) == sim.t
    for k in y:
        assert torch.equal(y[k], sim.state[k]), k


@pytest.mark.slow
def test_fused_run_matches_jax_pallas_interpret(tmp_path):
    ref = JaxSim(_cfg("tc5_covariant", tmp_path / "j", nsteps=3,
                      backend="pallas_interpret",
                      io={"history_stride": 0, "checkpoint_stride": 0}))
    assert _jax_kind(ref) == "compact"
    ref.run()
    sim = run_from_config(_cfg("tc5_covariant", tmp_path / "t", nsteps=3,
                               backend="pallas",
                               io={"history_stride": 0,
                                   "checkpoint_stride": 0}), device="cpu")
    for k, v in sim.state.items():
        assert _rel(ref.state[k], v) <= 1e-6, k


_GRID = [(name, backend, nu4, mode, scheme)
         for name in ("auto", "shallow_water_cov")
         for backend in ("jnp", "pallas")
         for nu4 in (0.0, 1.0e15)
         for mode in ("split", "refused", "stage")
         for scheme in ("ssprk3", "rk4")]


@pytest.mark.parametrize("name, backend, nu4, mode, scheme", _GRID)
def test_stepper_selection_matches_jax(name, backend, nu4, mode, scheme,
                                       tmp_path):
    cfg = {"grid": {"n": 8}, "time": {"dt": DT, "scheme": scheme},
           "model": {"name": name, "initial_condition": "tc5",
                     "backend": backend, "nu4_mode": mode},
           "physics": {"hyperdiffusion": nu4},
           "parallelization": {"num_devices": 1}}
    try:
        kind = _jax_kind(JaxSim(cfg))
    except ValueError as e:
        with pytest.raises(ValueError):
            Simulation(cfg, device="cpu")
        assert "nu4_mode" in str(e) or "precision" in str(e)
        return
    assert Simulation(cfg, device="cpu").stepper_kind == kind


def test_resume_is_bitwise(tmp_path):
    cfg_a = _cfg("tc5_covariant", tmp_path / "a", nsteps=8,
                 backend="pallas", io={"history_stride": 2,
                                       "checkpoint_stride": 4})
    cfg_b = _cfg("tc5_covariant", tmp_path / "b", nsteps=8,
                 backend="pallas", io={"history_stride": 2,
                                       "checkpoint_stride": 4})
    full = Simulation(cfg_a, device="cpu")
    full.run()
    Simulation(cfg_b, device="cpu").run(nsteps=4)
    resumed = Simulation(cfg_b, device="cpu")
    assert (resumed.step_count, resumed.t) == (4, 4 * DT)
    resumed.run()
    assert (resumed.step_count, resumed.t) == (full.step_count, full.t)
    for k in full.state:
        assert torch.equal(full.state[k], resumed.state[k]), k
    a, b = (HistoryWriter(c["io"]["history_path"]) for c in (cfg_a, cfg_b))
    np.testing.assert_array_equal(a.times, b.times)
    for k in full.state:
        np.testing.assert_array_equal(a.read(k), b.read(k))


def test_resume_across_resolutions(tmp_path):
    cfg = _cfg("tc5_cartesian", tmp_path, nsteps=3)
    Simulation(cfg, device="cpu").run()
    saved, _ = CheckpointManager(cfg["io"]["checkpoint_path"]).restore_host()
    fine = Simulation(dict(cfg, grid={"n": 12, "dtype": "float64"}),
                      device="cpu")
    assert (fine.step_count, fine.t) == (3, 3 * DT)
    expect = regrid_state(saved, 12)
    for k, v in fine.state.items():
        assert tuple(v.shape[-2:]) == (12, 12)
        np.testing.assert_array_equal(v.numpy(), expect[k])


def test_jax_checkpoint_resumes_in_the_port(jax_runs, tmp_path):
    """JAX restore_host -> port save -> port resume."""
    ref = jax_runs("tc5_covariant")
    state, t = JaxCkpt(os.path.join(str(ref["root"]), "ckpt")).restore_host(3)
    cfg = _cfg("tc5_covariant", tmp_path)
    CheckpointManager(cfg["io"]["checkpoint_path"]).save(3, state, t)
    sim = Simulation(cfg, device="cpu")
    assert (sim.step_count, sim.t) == (3, 3 * DT)
    sim.run()
    assert sim.t == ref["t"]
    for k, v in sim.state.items():
        assert _rel(ref["state"][k], v) <= BUDGET["float32"], k


def test_port_checkpoint_resumes_in_jax(jax_runs, tmp_path):
    """Port restore_host -> JAX save -> JAX resume."""
    ref = jax_runs("tc5_cartesian")
    cfg = _cfg("tc5_cartesian", tmp_path / "t", nsteps=3)
    Simulation(cfg, device="cpu").run()
    state, t = CheckpointManager(cfg["io"]["checkpoint_path"]).restore_host()
    jcfg = _cfg("tc5_cartesian", tmp_path / "j",
                io={"history_stride": 0})
    JaxCkpt(jcfg["io"]["checkpoint_path"]).save(3, state, t)
    sim = JaxSim(jcfg)
    assert sim.step_count == 3
    sim.run()
    assert sim.t == ref["t"]
    for k in ref["state"]:
        assert _rel(ref["state"][k], sim.state[k]) <= BUDGET["float64"], k


@pytest.mark.parametrize("over, item", [
    ({"model": {"numerics": "tt"}}, r"model\.numerics.*queue A item 8 \(A11\)"),
    ({"ensemble": {"members": 2}, "parallelization": {
        "num_devices": 6, "use_shard_map": True}},
     r"ensemble\.members.*queue A item 4 \(A8\)"),
    ({"precision": {"stage": "bf16"}, "parallelization": {
        "num_devices": 6, "use_shard_map": True}},
     r"precision.*queue A item 4 \(A8\)"),
    ({"precision": {"strips": "bf16"}, "parallelization": {
        "num_devices": 6, "use_shard_map": True}},
     r"precision.*queue A item 4 \(A8\)"),
    ({"ensemble": {"members": 2}, "model": {"numerics": "tt"}},
     r"model\.numerics.*queue A item 8 \(A11\)"),
    ({"grid": {"dtype": "bfloat16"}}, r"grid\.dtype.*queue A item 5"),
    ({"io": {"history_tt_rank": 4}},
     r"io\.history_tt_rank.*queue A item 8 \(A11\)"),
    ({"da": {"cycles": 1}}, r"da\.cycles.*queue A item 6 \(A7\)"),
    ({"parallelization": {"num_devices": 6}},
     r"use_shard_map: false.*queue A item 4 \(A8\)"),
    ({"parallelization": {"num_devices": 6, "use_shard_map": True},
      "model": {"name": "auto"}}, r"Cartesian shard.*queue A item 4 \(A8\)"),
    # The face tier takes nu4; the block tier still refuses it.
    ({"parallelization": {"num_devices": 24, "tiles_per_edge": 2,
                          "use_shard_map": True},
      "physics": {"hyperdiffusion": 1e15}},
     r"nu4.*queue A item 4 \(A8\)"),
])
def test_unported_knobs_are_refused(over, item, tmp_path):
    cfg = _cfg("tc5_covariant", tmp_path, **over)
    with pytest.raises(NotImplementedError, match=item):
        Simulation(cfg, device="cpu")


@pytest.mark.parametrize("over", [
    {"model": {"nu4_mode": "refused"}},
    {"model": {"nu4_mode": "stage", "name": "auto", "backend": "pallas"}},
    {"model": {"nu4_mode": "bogus"}},
    {"parallelization": {"num_devices": 6, "use_shard_map": True},
     "time": {"scheme": "rk4"}},
    {"ensemble": {"members": 0}},
    {"model": {"numerics": "sparse"}},
    {"model": {"initial_condition": "tc9"}},
    {"model": {"name": "advection"}},
    {"precision": {"stage": "fp8"}},
])
def test_configs_jax_rejects_are_refused(over, tmp_path):
    cfg = _cfg("tc5_covariant", tmp_path, **over)
    with pytest.raises(ValueError):
        JaxSim(cfg)
    with pytest.raises((ValueError, NotImplementedError)):
        Simulation(cfg, device="cpu")


def test_fused_factory_failure_propagates(monkeypatch, tmp_path):
    """A kernel build failure is never a silent fallback."""
    from jaxstream_torch.ops.cuda import swe_cov

    def boom(*a, **k):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(swe_cov, "make_fused_ssprk3_cov_compact", boom)
    cfg = _cfg("tc5_covariant", tmp_path, backend="pallas")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        Simulation(cfg, device="cpu")


def test_model_validation_falls_back_with_a_warning(monkeypatch, tmp_path,
                                                    caplog):
    from jaxstream_torch.models.shallow_water_cov import \
        CovariantShallowWater

    def refuse(self, dt, **kw):
        raise ValueError("unknown nu4_mode")

    monkeypatch.setattr(CovariantShallowWater, "make_fused_step", refuse)
    cfg = _cfg("tc5_covariant", tmp_path, backend="pallas")
    with caplog.at_level(logging.WARNING, logger="jaxstream_torch"):
        logging.getLogger("jaxstream_torch").propagate = True
        try:
            sim = Simulation(cfg, device="cpu")
        finally:
            logging.getLogger("jaxstream_torch").propagate = False
    assert sim.stepper_kind == "classic"
    assert "falling back to the classic path" in caplog.text


def test_single_device_stepper_for_and_temporal_block(tmp_path):
    sim = Simulation(_cfg("tc5_cartesian", tmp_path), device="cpu")
    m, s = sim.model, sim.state
    one = make_stepper_for(m, None, s, DT)
    two = make_stepper_for(m, None, s, DT, temporal_block=2)
    assert two.steps_per_call == 2
    y = one(one(s, 0.0), DT)
    z = two(s, 0.0)
    for k in s:
        assert torch.equal(y[k], z[k])
    cfg = _cfg("tc5_cartesian", tmp_path / "b",
               parallelization={"temporal_block": 2},
               io={"history_stride": 2, "checkpoint_stride": 0})
    blocked = Simulation(cfg, device="cpu")
    blocked.run()
    plain = Simulation(_cfg("tc5_cartesian", tmp_path / "c",
                            io={"checkpoint_stride": 0}), device="cpu")
    plain.run()
    assert blocked.t == plain.t
    for k in s:
        assert torch.equal(blocked.state[k], plain.state[k])
    with pytest.raises(ValueError, match="not a multiple"):
        blocked.run(nsteps=NSTEPS + 1)


def test_face_tier_run_matches_single_device(tmp_path):
    kw = {"io": {"history_stride": 1, "checkpoint_stride": 0}}
    face = Simulation(_cfg("tc5_covariant", tmp_path / "f", nsteps=2,
                           parallelization={"num_devices": 6,
                                            "use_shard_map": True}, **kw),
                      device="cpu")
    assert face.setup.num_devices == 6 and face.stepper_kind == "classic"
    face.run()
    single = run_from_config(_cfg("tc5_covariant", tmp_path / "s",
                                  nsteps=2, **kw), device="cpu")
    assert face.t == single.t
    for k in single.state:
        assert face.state[k].shape == single.state[k].shape
        assert _rel(single.state[k], face.state[k]) <= 2e-4, k
    assert len(HistoryWriter(os.path.join(str(tmp_path / "f"), "hist"))) == 3


def _yaml_cfg(path, root):
    """The ``tc5_cartesian`` case as a YAML file (no io strides: the
    classic path's result does not depend on its segmentation)."""
    text = (
        "# TC5, Cartesian, C8 at float64\n"
        "grid:\n  n: 8\n  dtype: float64\n"
        "model:\n  initial_condition: tc5   # williamson\n"
        f"time:\n  dt: {DT}\n  duration_days: 1.0e-1\n"
        "parallelization:\n  num_devices: 1\n  device_type: cpu\n"
        f"io:\n  history_path: '{root}/hist'\n  history_stride: 0\n")
    path.write_text(text)
    return str(path)


def test_cli_run_matches_jax(jax_runs, tmp_path, capsys):
    """``run`` prints the JAX CLI's keys (``steps``, ``t_seconds``,
    ``diagnostics``), and the JAX run's values."""
    ref = jax_runs("tc5_cartesian")
    cfg = _yaml_cfg(tmp_path / "cfg.yaml", tmp_path)
    main(["run", cfg, "--nsteps", str(NSTEPS), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out) == ["steps", "t_seconds", "diagnostics"]
    assert (out["steps"], out["t_seconds"]) == (ref["steps"], ref["t"])
    for k, v in ref["diag"].items():
        assert abs(out["diagnostics"][k] - v) <= 1e-12 * abs(v), k
    # The bare-path shorthand, and the configured duration (0.1 day).
    main([cfg, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 14


def test_cli_info_and_schedule(tmp_path, capsys):
    cfg = _yaml_cfg(tmp_path / "cfg.yaml", tmp_path)
    main(["info", cfg, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "torch " in text and "grid: C8 halo=2 dtype=float64" in text
    main(["schedule"])
    ours = capsys.readouterr().out
    jax_main(["schedule"])
    assert ours == capsys.readouterr().out
    assert ours.count("stage") == 4


@pytest.mark.slow
def test_cli_subprocess(tmp_path):
    cfg = _yaml_cfg(tmp_path / "cfg.yaml", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "jaxstream_torch", "run", cfg, "--nsteps",
         "2", "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, check=True)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["steps"] == 2 and set(rec["diagnostics"]) == {"mass",
                                                             "energy"}
