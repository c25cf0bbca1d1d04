"""Port: the flight recorder and crash bundles (``jaxstream_torch.obs.
flight``) and ``Simulation``'s crash forensics (queue A item 2).

* The ring: one sub-ring per thread, a global sequence order, the
  dropped count of a wrapped ring, ``disabled()`` and ``clear()``.
* Bundles: each package's bundle read by the other's ``read_bundle`` and
  by ``scripts/postmortem.py`` (run in-process); a torn bundle rejected
  by all three; a re-commit leaves one events file.
* ``Simulation`` with ``observability.flight_dir``: a HealthError commits
  a bundle and its ``flight`` / ``crash`` sink records; a new run on the
  same directories finds the lineage, stamps a ``resume`` record and
  ends bitwise equal to the uninterrupted run; the recorder on or off
  leaves the sink's records unchanged.

This module imports the flight recorder: it stays tier-1 and in-process
(``scripts/check_tiers.py`` rule 14).
"""

import json
import logging
import os
import threading

import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)
from torch_scripts import run_script

from jaxstream.obs import flight as jflight

from jaxstream_torch.obs import flight
from jaxstream_torch.obs.monitor import HealthError
from jaxstream_torch.obs.sink import read_records
from jaxstream_torch.simulation import Simulation

_VOLATILE = ("wall_s", "steps_per_sec", "sim_days_per_sec_per_chip",
             "host_wait_s", "created_unix")


@pytest.fixture(autouse=True)
def _quiet_logs():
    lg = logging.getLogger("jaxstream_torch")
    level = lg.level
    lg.setLevel(logging.ERROR)
    yield
    lg.setLevel(level)


def test_ring_per_thread_order_drops_and_disable():
    rec = flight.FlightRecorder(capacity=4)
    for i in range(6):
        rec.record("main", i=i)

    def worker():
        for i in range(2):
            rec.record("worker", i=i)

    th = threading.Thread(target=worker, name="w1")
    th.start()
    th.join(timeout=5)
    assert not th.is_alive()
    with rec.disabled():
        rec.record("main", i=99)
    events, appended, dropped = rec.dump()
    assert [e["seq"] for e in events] == sorted(e["seq"] for e in events)
    assert [e["i"] for e in events if e["type"] == "main"] == [2, 3, 4, 5]
    assert appended == {threading.current_thread().name: 6, "w1": 2}
    assert dropped == 2
    assert {e["thread"] for e in events} == {
        threading.current_thread().name, "w1"}
    rec.clear()
    assert rec.dump() == ([], {threading.current_thread().name: 0,
                               "w1": 0}, 0)


def _bundle(mod, root, reason="HealthError"):
    rec = mod.FlightRecorder()
    rec.record("segment", step=2, k=2)
    rec.record("guard", event="nan", step=4, value=float("inf"))
    w = mod.BundleWriter(str(root), bundle_id="fb-test", recorder=rec)
    w.commit(reason, config={"grid_n": 8}, checkpoint={"step": 4,
                                                       "path": "ckpt"})
    return w


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bundles_cross_packages(writer, tmp_path):
    w = _bundle(flight if writer == "port" else jflight, tmp_path)
    for read in (flight.read_bundle, jflight.read_bundle):
        manifest, events = read(w.path)
        assert manifest["bundle_id"] == "fb-test"
        assert [e["type"] for e in events] == ["segment", "guard"]
    assert flight.latest_bundle(str(tmp_path)) == w.path
    code, out = run_script("postmortem.py", str(tmp_path), "--json")
    assert code == 0
    rep = json.loads(out)
    assert rep["reason"] == "HealthError" and rep["n_events"] == 2
    # A re-commit writes a new events file and leaves only it.
    w.commit("again")
    assert sorted(n for n in os.listdir(w.path)
                  if n.startswith("events-")) == ["events-000002.jsonl"]
    assert flight.read_bundle(w.path)[0]["reason"] == "again"


@pytest.mark.parametrize("tear", ["no_manifest", "bad_manifest",
                                  "no_events", "digest", "count"])
def test_torn_bundle_rejected_by_every_reader(tear, tmp_path):
    w = _bundle(flight, tmp_path)
    mpath = os.path.join(w.path, flight.BUNDLE_MANIFEST)
    manifest = json.load(open(mpath))
    epath = os.path.join(w.path, manifest["events_file"])
    if tear == "no_manifest":
        os.unlink(mpath)
    elif tear == "bad_manifest":
        open(mpath, "w").write("{not json")
    elif tear == "no_events":
        os.unlink(epath)
    elif tear == "digest":
        open(epath, "a").write("x")
    else:
        manifest["n_events"] = 3
        open(mpath, "w").write(json.dumps(manifest))
    for read, err in ((flight.read_bundle, flight.TornBundleError),
                      (jflight.read_bundle, jflight.TornBundleError)):
        with pytest.raises(err):
            read(w.path)
    code, _ = run_script("postmortem.py", w.path)
    assert code != 0


def _cfg(tmp_path, sink, nsteps=6, **obs):
    return {"grid": {"n": 8, "halo": 2, "dtype": "float64"},
            "model": {"initial_condition": "tc2"},
            "time": {"dt": 600.0, "nsteps": nsteps},
            "parallelization": {"num_devices": 1},
            "io": {"checkpoint_path": str(tmp_path / "ckpt"),
                   "checkpoint_stride": 2},
            "observability": {"interval": 2, "sink": str(tmp_path / sink),
                              "flight_dir": str(tmp_path / "flight"),
                              **obs}}


def test_crash_bundle_and_resume_lineage(tmp_path):
    torch.set_default_dtype(torch.float64)
    try:
        sim = Simulation(_cfg(tmp_path, "a.jsonl", guards="halt",
                              fault_step=4), device="cpu")
        with pytest.raises(HealthError):
            sim.run()
        sim.close()
        bdir = flight.latest_bundle(str(tmp_path / "flight"))
        manifest, events = flight.read_bundle(bdir)
        assert manifest["reason"] == "HealthError"
        # 'halt' raises before step 4's checkpoint: the last is step 2.
        assert manifest["checkpoint"]["step"] == 2
        assert {"segment", "checkpoint", "guard"} <= {e["type"]
                                                      for e in events}
        recs = read_records(str(tmp_path / "a.jsonl"))
        assert [r["kind"] for r in recs[-3:]] == ["guard", "flight",
                                                  "crash"]
        assert recs[-1]["bundle"] == manifest["bundle_id"]
        code, out = run_script("postmortem.py", bdir, "--sink",
                               str(tmp_path / "a.jsonl"))
        assert code == 0 and manifest["bundle_id"] in out
        # The restart: resumes at step 2 and records its lineage.
        resumed = Simulation(_cfg(tmp_path, "b.jsonl", guards="halt"),
                             device="cpu")
        assert resumed.step_count == 2
        resumed.run()
        resumed.close()
        stamp = read_records(str(tmp_path / "b.jsonl"), kind="resume")
        assert stamp == [{"kind": "resume",
                          "bundle": manifest["bundle_id"],
                          "checkpoint_step": 2, "step": 2, "path": bdir}]
        ref_dir = tmp_path / "ref"
        ref = Simulation(_cfg(ref_dir, "r.jsonl"), device="cpu")
        ref.run()
        ref.close()
        assert resumed.t == ref.t
        for k in ref.state:
            assert torch.equal(ref.state[k], resumed.state[k]), k
    finally:
        torch.set_default_dtype(torch.float32)


def test_recorder_off_leaves_sink_unchanged(tmp_path):
    recs = []
    for name in ("on", "off"):
        cfg = _cfg(tmp_path / name, "t.jsonl", nsteps=4)
        if name == "off":
            with flight.disabled():
                Simulation(cfg, device="cpu").run()
        else:
            Simulation(cfg, device="cpu").run()
        recs.append([{k: v for k, v in r.items() if k not in _VOLATILE}
                     for r in read_records(str(tmp_path / name /
                                                "t.jsonl"))])
    assert recs[0] == recs[1]
