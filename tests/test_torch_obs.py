"""Port parity: in-loop telemetry (``jaxstream_torch.obs``: metrics,
monitor, sink) and its wiring through ``Simulation`` (queue A item 2).

* The sink's records keep the JAX package's schema: each package reads
  the other's file, and ``scripts/telemetry_report.py`` and
  ``telemetry_dashboard.py`` (run in-process) render a port run.
* Metric names, policies and interval validation refuse with the JAX
  package's messages; the monitor's events and errors equal the JAX
  monitor's on the same buffers, for every policy.
* The metric values against the JAX ``MetricSet`` on the same state:
  <= 1e-12 relative at float64 (covariant, Cartesian and member-batched
  ladders); the metric stream against the JAX ``integrate_with_metrics``
  on the same classic step: <= 1e-12 at float64, and its time carry
  (one ``+ dt`` per call) bitwise.
* Metrics on against metrics off: the state bitwise, one fetch per
  segment; the face tier's sampled metrics against the single-device
  run at the JAX package's 1e-10; an ensemble's member rows and spread.
* The NaN guard halts with the last-good step, a postmortem checkpoint
  and the guard record on disk.

This module imports ``jaxstream.obs``: it stays tier-1
(``scripts/check_tiers.py`` rule 3).
"""

import json
import logging

import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)
from torch_scripts import run_script

import jax.numpy as jnp

from jaxstream.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.models.shallow_water import ShallowWater as JaxCart
from jaxstream.models.shallow_water_cov import CovariantShallowWater as JaxCov
from jaxstream.obs import metrics as jax_metrics
from jaxstream.obs.monitor import HealthError as JaxHealthError
from jaxstream.obs.monitor import HealthMonitor as JaxMonitor
from jaxstream.obs.sink import TelemetrySink as JaxSink
from jaxstream.obs.sink import read_records as jax_read_records
from jaxstream.obs.sink import run_manifest as jax_run_manifest
from jaxstream.physics import initial_conditions as jic
from jaxstream.simulation import Simulation as JaxSim
from jaxstream.stepping import integrate_with_metrics as jax_iwm

from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.io.checkpoint import CheckpointManager
from jaxstream_torch.models.shallow_water import ShallowWater
from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
from jaxstream_torch.obs import metrics as obs_metrics
from jaxstream_torch.obs.monitor import (GUARD_POLICIES, HealthError,
                                         HealthMonitor)
from jaxstream_torch.obs.sink import (RECORD_KINDS, TelemetrySink,
                                      read_records, run_manifest,
                                      validate_record)
from jaxstream_torch.physics import initial_conditions as tic
from jaxstream_torch.simulation import Simulation
from jaxstream_torch.stepping import integrate_with_metrics

F64 = 1e-12


@pytest.fixture(autouse=True)
def _f64_time_carry_and_quiet_logs():
    """torch's default dtype float64 (the port's counterpart of the
    suite's ``jax_enable_x64``), INFO logs off."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    levels = {n: logging.getLogger(n).level
              for n in ("jaxstream", "jaxstream_torch")}
    for n in levels:
        logging.getLogger(n).setLevel(logging.WARNING)
    yield
    torch.set_default_dtype(old)
    for n, lvl in levels.items():
        logging.getLogger(n).setLevel(lvl)


def _cfg(n=8, nsteps=4, interval=2, ic="tc2", dtype="float64", **over):
    cfg = {"grid": {"n": n, "halo": 2, "dtype": dtype},
           "model": {"initial_condition": ic},
           "time": {"dt": 600.0, "nsteps": nsteps},
           "parallelization": {"num_devices": 1},
           "observability": {"interval": interval}}
    if ic == "tc5":
        cfg["model"]["name"] = "shallow_water_cov"
    for k, v in over.items():
        cfg.setdefault(k, {}).update(v)
    return cfg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-300))


# ------------------------------------------------------------------ sink
def test_sink_schema_round_trip_across_packages(tmp_path):
    assert RECORD_KINDS == __import__(
        "jaxstream.obs.sink", fromlist=["RECORD_KINDS"]).RECORD_KINDS
    seg = {"kind": "segment", "step": 4, "t": 2400.0, "steps": 4,
           "wall_s": 0.5, "steps_per_sec": 8.0,
           "sim_days_per_sec_per_chip": 0.05,
           "metrics": {"mass": 1.0}, "drift": {"mass": 0.0}}
    guard = {"kind": "guard", "event": "nan", "step": 4, "t": 2400.0,
             "value": float("nan"), "policy": "warn", "last_good_step": 2,
             "last_good_t": 1200.0}
    port, jax_path = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    man = run_manifest(["mass", "cfl"], 4, "warn", config={"grid_n": 8},
                       device="cpu")
    assert man["devices"] == {"platform": "cpu", "count": 1,
                              "process_index": 0, "process_count": 1}
    assert man["torch_version"] == torch.__version__
    with TelemetrySink(port, man) as sink:
        sink.write(seg)
        sink.write(guard)
    with JaxSink(jax_path, jax_run_manifest(["mass", "cfl"], 4, "warn")) as s:
        s.write(seg)
        s.write(guard)
    for path in (port, jax_path):
        for reader in (read_records, jax_read_records):
            recs = reader(path)
            assert [r["kind"] for r in recs] == ["manifest", "segment",
                                                 "guard"]
            assert reader(path, kind="guard")[0]["last_good_step"] == 2
    with pytest.raises(ValueError, match="missing keys"):
        validate_record({"kind": "segment", "step": 1})
    with pytest.raises(ValueError, match="unknown"):
        validate_record({"kind": "nope"})
    # One file is one run: reopening truncates.
    TelemetrySink(port, run_manifest(["energy"], 2, "off",
                                     device="cpu")).close()
    assert [r["metric_names"] for r in read_records(port)] == [["energy"]]


# -------------------------------------------------------------- metrics
@pytest.mark.parametrize("names, family, cov, batched", [
    ("default", "swe", True, False),
    ("", "swe", False, False),
    ("mass, cfl", "swe", False, False),
    (["tracer_mass"], "advection", False, False),
    ("h_spread,ens_mean_drift", "swe", True, True),
    ("mass,banana", "swe", False, False),
    ("enstrophy", "swe", False, False),
    ("mass", "advection", False, False),
    ("h_spread", "swe", True, False),
])
def test_metric_names_resolve_as_jax(names, family, cov, batched):
    """The same resolution, or the same refusal with the same message."""
    def run(fn):
        try:
            return ("ok", fn(names, family, cov, batched=batched))
        except ValueError as e:
            return ("error", str(e))

    assert run(obs_metrics.resolve_metric_names) == \
        run(jax_metrics.resolve_metric_names)


def _jax_and_port_states(kind):
    """(jax grid, jax model, jax state, port grid, port model, port
    state) for 'cov' (TC5 covariant), 'cart' (TC2 Cartesian) or 'ens'
    (TC5 covariant, 3 perturbed members) at C8, float64."""
    jg = jax_build_grid(8, halo=2, radius=EARTH_RADIUS, dtype=jnp.float64)
    tg = build_grid(8, halo=2, radius=EARTH_RADIUS, dtype=torch.float64,
                    device="cpu")
    if kind == "cart":
        jh, jv = jic.williamson_tc2(jg, EARTH_GRAVITY, EARTH_OMEGA)
        th, tv = tic.williamson_tc2(tg, EARTH_GRAVITY, EARTH_OMEGA)
        jm = JaxCart(jg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA)
        tm = ShallowWater(tg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA)
        return jg, jm, jm.initial_state(jh, jv), tg, tm, tm.initial_state(
            th, tv)
    jh, jv, jb = jic.williamson_tc5(jg, EARTH_GRAVITY, EARTH_OMEGA)
    th, tv, tb = tic.williamson_tc5(tg, EARTH_GRAVITY, EARTH_OMEGA)
    jm = JaxCov(jg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA, b_ext=jb)
    tm = CovariantShallowWater(tg, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                               b_ext=tb)
    js, ts = jm.initial_state(jh, jv), tm.initial_state(th, tv)
    if kind == "ens":
        rng = np.random.default_rng(4)
        dh = 10.0 * rng.standard_normal((3,) + tuple(ts["h"].shape))
        dh[0] = 0.0
        h = ts["h"].numpy()[None] + dh
        u = np.repeat(ts["u"].numpy()[:, None], 3, axis=1)
        js = {"h": jnp.asarray(h), "u": jnp.asarray(u)}
        ts = {"h": torch.from_numpy(h), "u": torch.from_numpy(u)}
    return jg, jm, js, tg, tm, ts


@pytest.mark.parametrize("kind, names", [
    ("cov", "default"),
    ("cart", "default"),
    ("ens", "default"),
    ("ens", "mass,energy,h_spread,ens_mean_drift,nonfinite_count"),
])
def test_metric_values_match_jax_f64(kind, names):
    jg, jm, js, tg, tm, ts = _jax_and_port_states(kind)
    member_rows = kind == "ens"
    jms = jax_metrics.build_metric_set(jg, jm, js, names, 600.0,
                                       EARTH_GRAVITY, member_rows=member_rows)
    tms = obs_metrics.build_metric_set(tg, tm, ts, names, 600.0,
                                       EARTH_GRAVITY, member_rows=member_rows)
    assert tms.names == jms.names
    a = np.asarray(jms.values(js))
    b = tms.values(ts).numpy()
    assert b.dtype == np.float64
    for i, n in enumerate(tms.names):
        assert abs(b[i] - a[i]) <= F64 * max(abs(a[i]), 1e-300), n


def test_metric_stream_matches_jax_integrate_with_metrics():
    """The loop itself on the same classic step: samples in the same
    columns, the fault hook in the stream only, the state untouched by
    the metrics; float64 values <= 1e-12, and the time carry bitwise
    (one ``+ dt`` per call, 1 000 calls of 0.1 s)."""
    jg, jm, js, tg, tm, ts = _jax_and_port_states("cart")
    jms = jax_metrics.build_metric_set(jg, jm, js, "default", 600.0,
                                       EARTH_GRAVITY)
    tms = obs_metrics.build_metric_set(tg, tm, ts, "default", 600.0,
                                       EARTH_GRAVITY)
    jy, jt, jbuf = jax_iwm(jm.make_step(600.0), js, 0.0, 5, 600.0,
                           lambda y, t: jms.values(y), 2, 2, 0,
                           fault_step=4)
    ty, tt, tbuf = integrate_with_metrics(
        tm.make_step(600.0), ts, 0.0, 5, 600.0,
        lambda y, t: tms.values(y), 2, 2, 0, fault_step=4)
    assert float(tt) == float(jt)
    jbuf, tbuf = np.asarray(jbuf), tbuf.numpy()
    assert np.all(np.isnan(jbuf[:, 1])) and np.all(np.isnan(tbuf[:, 1]))
    assert np.max(np.abs(tbuf[:, 0] - jbuf[:, 0])
                  / np.abs(jbuf[:, 0]).clip(1e-300)) <= F64
    for k in js:
        assert _rel(jy[k], ty[k].numpy()) <= F64, k
    # The suite runs JAX at x64: both time carries are float64 here.
    j32 = jax_iwm(lambda y, t: y, jnp.ones(3), 0.0, 1000, 0.1,
                  lambda y, t: jnp.sum(y)[None], 7, 142, 0)
    t32 = integrate_with_metrics(lambda y, t: y, torch.ones(3), 0.0, 1000,
                                 0.1, lambda y, t: torch.sum(y)[None], 7,
                                 142, 0)
    assert float(j32[1]) == float(t32[1])
    assert t32[2].shape == (1, 142) and not torch.isnan(t32[2]).any()


# --------------------------------------------------- Simulation wiring
@pytest.mark.parametrize("over, match", [
    ({"parallelization": {"temporal_block": 2},
      "observability": {"interval": 3}}, "temporal_block"),
    ({"io": {"history_path": "h", "history_stride": 2},
      "observability": {"interval": 4, "guards": "halt"}}, "segment length"),
    ({"observability": {"interval": 2, "guards": "explode"}}, "policy"),
    ({"observability": {"interval": 2, "metrics": "mass,banana"}},
     "unknown observability metric"),
])
def test_simulation_refuses_as_jax(over, match, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(nsteps=8, **over)
    with pytest.raises(ValueError, match=match) as te:
        Simulation(cfg, device="cpu")
    with pytest.raises(ValueError) as je:
        JaxSim(cfg)
    # The JAX package may prefix its plan rule's key.
    assert str(je.value).endswith(str(te.value))


def test_c8_telemetry_acceptance_against_jax(tmp_path, monkeypatch):
    """Telemetry on (it used to be refused): schema-valid records whose
    values equal the JAX package's run at 1e-12 (float64 classic TC2),
    one device-to-host fetch per segment, the last sample equal to
    ``diagnostics()``, and the state bitwise the run with telemetry
    off."""
    calls = []
    real = obs_metrics.fetch_buffer
    monkeypatch.setattr(obs_metrics, "fetch_buffer",
                        lambda buf: calls.append(1) or real(buf))
    io = {"history_path": str(tmp_path / "h"), "history_stride": 2}
    obs = {"interval": 2, "sink": str(tmp_path / "t.jsonl"),
           "guards": "warn"}
    sim = Simulation(_cfg(io=dict(io), observability=obs), device="cpu")
    sim.run()
    assert len(calls) == 2
    recs = read_records(str(tmp_path / "t.jsonl"))
    assert recs == jax_read_records(str(tmp_path / "t.jsonl"))
    assert recs[0]["kind"] == "manifest"
    assert recs[0]["metric_names"] == list(sim._obs.ms.names)
    segs = [r for r in recs if r["kind"] == "segment" and r["steps"] > 0]
    assert [s["step"] for s in segs] == [2, 4]
    d = sim.diagnostics()
    assert segs[-1]["metrics"]["mass"] == pytest.approx(d["mass"], rel=F64)
    assert segs[-1]["metrics"]["energy"] == pytest.approx(d["energy"],
                                                          rel=F64)
    assert abs(segs[-1]["drift"]["mass"]) < 1e-12
    assert sim._obs.monitor.events == []
    assert sim._obs.monitor.last_good_step == 4
    jsim = JaxSim(_cfg(io={**io, "history_path": str(tmp_path / "jh")},
                       observability={**obs,
                                      "sink": str(tmp_path / "j.jsonl")}))
    jsim.run()
    jsegs = [r for r in jax_read_records(str(tmp_path / "j.jsonl"))
             if r["kind"] == "segment"]
    assert len(jsegs) == len(segs) + 1
    for a, b in zip(jsegs[1:], segs):
        assert (a["step"], a["t"]) == (b["step"], b["t"])
        for n, v in a["metrics"].items():
            assert b["metrics"][n] == pytest.approx(v, rel=F64, abs=1e-300)
    off = Simulation(_cfg(io={**io, "history_path": str(tmp_path / "h2")},
                          observability={"interval": 0}), device="cpu")
    off.run()
    assert len(calls) == 2
    assert sim.t == off.t == jsim.t
    for k in off.state:
        assert torch.equal(off.state[k], sim.state[k]), k
    code, out = run_script("telemetry_report.py", str(tmp_path / "t.jsonl"))
    assert code == 0 and "drift vs step 0" in out
    code, out = run_script("telemetry_dashboard.py", "--once",
                           str(tmp_path / "t.jsonl"))
    assert code == 0 and out


def test_compact_metrics_on_matches_off_bitwise(tmp_path):
    """The compact fused stepper (float32, the kernels' plain versions
    on the CPU): metrics on leave the carry bitwise; the two time carries
    are each the JAX package's for its loop (unroll 1 and 4, both exact
    at dt = 600 s)."""
    torch.set_default_dtype(torch.float32)
    over = dict(ic="tc5", dtype="float32", nsteps=6,
                model={"backend": "pallas"},
                io={"checkpoint_path": str(tmp_path / "c"),
                    "checkpoint_stride": 3})
    on = Simulation(_cfg(interval=1, **over), device="cpu")
    off = Simulation(_cfg(interval=0, **{**over, "io": {
        "checkpoint_path": str(tmp_path / "c2"), "checkpoint_stride": 3}}),
        device="cpu")
    assert on.stepper_kind == off.stepper_kind == "compact"
    on.run()
    off.run()
    assert on.t == off.t == 3600.0
    for k in off.state:
        assert torch.equal(on.state[k], off.state[k]), k


@pytest.mark.parametrize("over", [
    {"precision": {"carry": "mixed16"}},
    {"parallelization": {"temporal_block": 2}},
], ids=["mixed16_carry", "temporal_block2"])
def test_compact_knobs_with_metrics(over, tmp_path):
    """Telemetry over the 16-bit carry (the samples see the decoded
    float32 fields) and over ``temporal_block = 2`` (samples at the
    blocked calls' boundaries): the carry bitwise the run without
    metrics, the last sample equal to the metric function on the final
    state."""
    torch.set_default_dtype(torch.float32)
    base = dict(ic="tc5", dtype="float32", nsteps=4,
                model={"backend": "pallas"}, **over)
    on = Simulation(_cfg(interval=2, observability={
        "sink": str(tmp_path / "t.jsonl")}, **base), device="cpu")
    off = Simulation(_cfg(interval=0, **base), device="cpu")
    assert on.stepper_kind == "compact"
    on.run()
    off.run()
    for k in off.state:
        assert torch.equal(on.state[k], off.state[k]), k
    last = read_records(str(tmp_path / "t.jsonl"), kind="segment")[-1]
    now = on._obs.ms.values(on.state).numpy()
    assert [last["metrics"][n] for n in on._obs.ms.names] == \
        [float(v) for v in now]
    assert last["samples"]["step"] == [2, 4]


def test_face_tier_metrics_match_single_device(tmp_path):
    """On six virtual ranks the metrics see the gathered sphere once per
    sample: equal to the tier's own ``diagnostics()``, and to the
    single-device run's within the tier's float32 budgets (the tiers run
    float32 only; the JAX package's 1e-10 is its float64 figure): mass
    2e-6, the rest 2e-4, the tier-vs-single state budget."""
    tier = {"num_devices": 6, "use_shard_map": True}
    runs = {}
    for name, par in (("face", tier), ("single", {})):
        path = str(tmp_path / f"{name}.jsonl")
        sim = Simulation(_cfg(ic="tc5", dtype="float32", nsteps=2,
                              parallelization=par,
                              observability={"interval": 1, "sink": path}),
                         device="cpu")
        sim.run()
        runs[name] = (sim, read_records(path, kind="segment")[-1])
    assert runs["face"][0].setup.num_devices == 6
    face, single = runs["face"][1], runs["single"][1]
    assert face["steps"] == 2 and len(face["samples"]["step"]) == 2
    for n, v in single["metrics"].items():
        tol = 2e-6 if n == "mass" else 2e-4
        assert face["metrics"][n] == pytest.approx(v, rel=tol, abs=1e-30), n
    d = runs["face"][0].diagnostics()
    assert face["metrics"]["mass"] == d["mass"]
    assert face["metrics"]["energy"] == d["energy"]


def test_ensemble_telemetry_runs(tmp_path):
    """An ensemble with telemetry (it used to be refused): the batched
    fused stepper, a non-finite row per member, the spread statistics in
    the sink, member 0's invariants equal to ``diagnostics()``."""
    path = str(tmp_path / "e.jsonl")
    sim = Simulation(_cfg(ic="tc5", dtype="float32", nsteps=2,
                          model={"backend": "pallas"},
                          ensemble={"members": 3, "seed": 9,
                                    "amplitude": 1e-3},
                          observability={
                              "interval": 1, "sink": path, "guards": "warn",
                              "metrics": "mass,energy,h_spread,"
                                         "ens_mean_drift,nonfinite_count"}),
                     device="cpu")
    assert sim.stepper_kind == "compact"
    sim.run()
    assert sim._obs.ms.names[-3:] == ("nonfinite_m0", "nonfinite_m1",
                                      "nonfinite_m2")
    last = read_records(path, kind="segment")[-1]["metrics"]
    assert last["h_spread"] > 0 and last["ens_mean_drift"] > 0
    assert last["nonfinite_m2"] == 0.0
    d = sim.diagnostics()
    assert last["mass"] == pytest.approx(d["mass_m0"], rel=1e-6)
    assert sim._obs.monitor.events == []


# ---------------------------------------------------------------- guards
@pytest.mark.parametrize("policy", GUARD_POLICIES)
def test_monitor_matches_jax_for_every_policy(policy):
    """The same buffers through both monitors: the same events, the
    same last-good cursor, the same error text; 'checkpoint_and_raise'
    calls its callback with the event."""
    names = ["mass", "cfl", "nonfinite_m0", "nonfinite_m1"]
    steps, ts = np.array([2, 4, 6]), np.array([1200.0, 2400.0, 3600.0])
    buf = np.array([[1.0, 1.0, 1.0], [0.5, 0.6, 2.5], [0, 0, 0],
                    [0, 1.0, 0]])
    out = []
    for Mon, Err in ((HealthMonitor, HealthError),
                     (JaxMonitor, JaxHealthError)):
        seen = []
        mon = Mon(names, policy=policy, cfl_limit=2.0,
                  on_breach=seen.append)
        try:
            mon.check(steps, ts, buf)
            err = None
        except Err as e:
            err = (str(e), e.kind, e.step, e.last_good_step, e.member)
        members = mon.check_members(steps, ts, np.array([0.0, 0.0, 3.0])) \
            if err is None else None
        out.append((mon.events, mon.last_good_step, err, members, seen))
    assert out[0] == out[1]
    if policy == "warn":
        assert [e["event"] for e in out[0][0]] == ["nan", "cfl", "nan"]
        assert out[0][0][0]["member"] == 1
    with pytest.raises(ValueError, match="policy"):
        HealthMonitor(names, policy="explode")


def test_nan_guard_halts_with_postmortem(tmp_path):
    """The fault hook NaNs the stream at step 4: HealthError with last
    good step 2, the state finite, the guard record on disk before the
    raise, the postmortem checkpoint at step 4, and the report renders
    the file."""
    path = str(tmp_path / "t.jsonl")
    sim = Simulation(_cfg(
        io={"checkpoint_path": str(tmp_path / "ckpt"),
            "checkpoint_stride": 2},
        observability={"interval": 2, "sink": path,
                       "guards": "checkpoint_and_raise", "fault_step": 4}),
        device="cpu")
    with pytest.raises(HealthError) as ei:
        sim.run()
    assert (ei.value.kind, ei.value.step, ei.value.last_good_step) == \
        ("nan", 4, 2)
    assert ei.value.last_good_t == pytest.approx(1200.0)
    assert torch.isfinite(sim.state["h"]).all()
    guards = read_records(path, kind="guard")
    assert [(g["event"], g["last_good_step"]) for g in guards] == \
        [("nan", 2)]
    cm = CheckpointManager(str(tmp_path / "ckpt"))
    assert cm.latest_step() == 4
    assert cm.restore_meta(4)["postmortem"] == 1
    code, out = run_script("telemetry_report.py", path, "--json")
    rep = json.loads(out)
    assert code == 0 and rep["guards"][0]["event"] == "nan"
