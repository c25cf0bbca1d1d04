"""Port: the async host pipeline (``jaxstream_torch.io.async_pipeline``)
and its run loop in ``Simulation`` (queue A item 2), held to the JAX
package's acceptance (``tests/test_async_pipeline.py``).

* Async against sync: every history-store file byte for byte, the
  checkpoints restored bitwise, the telemetry records equal once the
  wall-clock fields are masked, the final state and time bitwise; on
  the classic float64 path and on the compact fused float32 path.  One
  writer task per segment; no writer thread left after ``close()``.
* The writer's queue blocks at its bound, is FIFO, fail-stop, and
  surfaces a task's failure on the main thread.
* ``HostFetch`` returns a buffer of its own.
* A guard's raise under the async loop still lands its sink record and
  the postmortem checkpoint; a failed dispatch lands the pending
  boundary.

This module imports ``jaxstream.io.async_pipeline``: it stays tier-1
(``scripts/check_tiers.py`` rule 4).
"""

import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

from jaxstream.io.async_pipeline import HostFetch as JaxHostFetch

from jaxstream_torch.io.async_pipeline import (WRITER_THREAD_NAME,
                                               BackgroundWriter, HostFetch,
                                               WriterFailed)
from jaxstream_torch.io.checkpoint import CheckpointManager
from jaxstream_torch.obs.monitor import HealthError
from jaxstream_torch.obs.sink import read_records
from jaxstream_torch.simulation import Simulation

#: Telemetry fields that differ run to run (wall clock).
_VOLATILE = ("wall_s", "steps_per_sec", "sim_days_per_sec_per_chip",
             "host_wait_s", "created_unix")

PATHS = {
    "classic_f64": ({"initial_condition": "tc2"}, "float64"),
    "compact_f32": ({"initial_condition": "tc5", "name": "shallow_water_cov",
                     "backend": "pallas"}, "float32"),
}


@pytest.fixture(autouse=True)
def _quiet_logs():
    lg = logging.getLogger("jaxstream_torch")
    level = lg.level
    lg.setLevel(logging.WARNING)
    yield
    lg.setLevel(level)


def _cfg(d, async_on, path="classic_f64", nsteps=6, hist=2, ckpt=3,
         interval=1, **over):
    model, dtype = PATHS[path]
    cfg = {
        "grid": {"n": 8, "halo": 2, "dtype": dtype},
        "model": dict(model),
        "time": {"dt": 600.0, "nsteps": nsteps},
        "parallelization": {"num_devices": 1},
        "io": {"history_path": str(d / "hist"), "history_stride": hist,
               "checkpoint_path": str(d / "ckpt"),
               "checkpoint_stride": ckpt,
               "async_pipeline": {"enabled": async_on}},
        "observability": {"interval": interval,
                          "sink": str(d / "telemetry.jsonl"),
                          "guards": "warn"},
    }
    for k, v in over.items():
        cfg.setdefault(k, {}).update(v)
    return cfg


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(str(root)):
        for f in names:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, str(root))] = p
    return out


def _records_sans_timing(path):
    return [{k: v for k, v in rec.items() if k not in _VOLATILE}
            for rec in read_records(path)]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_async_outputs_match_sync(path, tmp_path, monkeypatch):
    """gcd(2, 3) = 1: six one-step segments, history and checkpoint
    boundaries mixed; every written artifact against the synchronous
    path's."""
    ds, da = tmp_path / "sync", tmp_path / "async"
    ds.mkdir(), da.mkdir()
    submits = []
    orig = BackgroundWriter.submit

    def counting(self, fn, *a, **k):
        submits.append(fn)
        return orig(self, fn, *a, **k)

    monkeypatch.setattr(BackgroundWriter, "submit", counting)
    sims = {}
    for d, async_on in ((ds, False), (da, True)):
        with Simulation(_cfg(d, async_on, path), device="cpu") as sim:
            sim.run()
            sims[async_on] = sim
            if async_on:
                assert any(t.name == WRITER_THREAD_NAME
                           for t in threading.enumerate())
    assert not [t for t in threading.enumerate()
                if t.name == WRITER_THREAD_NAME and t.is_alive()]
    assert len(submits) == 6          # one composite task per segment
    for k in sims[False].state:
        assert torch.equal(sims[False].state[k], sims[True].state[k]), k
    assert sims[False].t == sims[True].t
    fs, fa = _files(ds / "hist"), _files(da / "hist")
    assert sorted(fs) == sorted(fa)
    for rel in fs:
        with open(fs[rel], "rb") as f1, open(fa[rel], "rb") as f2:
            assert f1.read() == f2.read(), rel
    cs, ca = CheckpointManager(str(ds / "ckpt")), CheckpointManager(
        str(da / "ckpt"))
    assert cs.latest_step() == ca.latest_step() == 6
    for step in (3, 6):
        (s1, t1), (s2, t2) = cs.restore_host(step), ca.restore_host(step)
        assert t1 == t2 and sorted(s1) == sorted(s2)
        for k in s1:
            assert np.array_equal(s1[k], s2[k]), (step, k)
    assert (_records_sans_timing(str(ds / "telemetry.jsonl"))
            == _records_sans_timing(str(da / "telemetry.jsonl")))
    for rec in read_records(str(da / "telemetry.jsonl"), kind="segment"):
        if rec["steps"]:
            assert rec["host_wait_s"] >= 0.0


def test_async_without_io_matches_sync(tmp_path):
    base = {"grid": {"n": 8, "halo": 2, "dtype": "float64"},
            "model": {"initial_condition": "tc2"},
            "time": {"dt": 600.0, "nsteps": 4},
            "parallelization": {"num_devices": 1}}
    ref = Simulation(dict(base), device="cpu")
    ref.run()
    with Simulation({**base, "io": {"async_pipeline": {"enabled": True}}},
                    device="cpu") as sim:
        sim.run()
        assert sim._writer is None        # nothing to write: no thread
    for k in ref.state:
        assert torch.equal(ref.state[k], sim.state[k]), k
    assert ref.t == sim.t


def test_writer_backpressure_blocks_at_bound():
    gate = threading.Event()
    done = []
    w = BackgroundWriter(max_pending=2)
    try:
        w.submit(gate.wait)                 # occupies the worker
        time.sleep(0.05)
        w.submit(done.append, 1)
        w.submit(done.append, 2)            # at the bound
        blocked = {}

        def overflow():
            blocked["entered"] = time.perf_counter()
            w.submit(done.append, 3)        # blocks until the gate opens
            blocked["exited"] = time.perf_counter()

        th = threading.Thread(target=overflow)
        th.start()
        time.sleep(0.2)
        assert "entered" in blocked and "exited" not in blocked
        gate.set()
        th.join(timeout=5.0)
        assert not th.is_alive() and "exited" in blocked
        w.flush()
        assert done == [1, 2, 3]
    finally:
        gate.set()
        w.close()
    with pytest.raises(ValueError, match="max_pending"):
        BackgroundWriter(max_pending=0)


def test_writer_failure_is_fail_stop_and_surfaces():
    ran = []

    def boom():
        raise OSError("disk full")

    w = BackgroundWriter(max_pending=4)
    w.submit(boom)
    w.submit(ran.append, 1)                 # skipped
    with pytest.raises(WriterFailed, match="disk full"):
        w.flush()
    assert ran == []
    w.submit(ran.append, 2)
    w.flush()
    assert ran == [2]
    w.close()
    w.close()
    assert not w.alive
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(ran.append, 3)


def test_host_fetch_is_a_buffer_of_its_own():
    """Leaves resolve to numpy, a later in-place write to the source
    does not reach the fetched copy, plain leaves pass through, a second
    resolve is the cached tree; the JAX package's fetch on the same
    tree gives the same values."""
    a = torch.arange(4.0)
    tree = {"a": a, "b": np.arange(3), "t": 1.5, "l": [torch.ones(2)]}
    f = HostFetch(tree)
    a.add_(10.0)
    out = f.resolve()
    np.testing.assert_array_equal(out["a"], np.arange(4.0))
    np.testing.assert_array_equal(out["l"][0], np.ones(2))
    assert float(out["t"]) == 1.5 and f.resolve() is out
    ref = JaxHostFetch({"a": np.arange(4.0), "b": np.arange(3),
                        "t": 1.5}).resolve()
    np.testing.assert_array_equal(ref["a"], out["a"])
    np.testing.assert_array_equal(ref["b"], out["b"])


def test_async_guard_flushes_sink_and_postmortem(tmp_path):
    """The fault hook under the async loop: HealthError with the
    last-good sample, the guard record on disk, and the postmortem
    checkpoint at the latest dispatched step (a segment ahead)."""
    cfg = _cfg(tmp_path, True, nsteps=8, hist=0, ckpt=2, interval=2,
               observability={"interval": 2,
                              "guards": "checkpoint_and_raise",
                              "fault_step": 4})
    sim = Simulation(cfg, device="cpu")
    with pytest.raises(HealthError) as ei:
        sim.run()
    sim.close()
    assert (ei.value.kind, ei.value.step, ei.value.last_good_step) == \
        ("nan", 4, 2)
    assert torch.isfinite(sim.state["h"]).all()
    guards = read_records(str(tmp_path / "telemetry.jsonl"), kind="guard")
    assert [(g["event"], g["last_good_step"]) for g in guards] == \
        [("nan", 2)]
    cm = CheckpointManager(str(tmp_path / "ckpt"))
    assert cm.latest_step() == 6
    state, t = cm.restore_host(6)
    assert t == 3600.0 and cm.restore_meta(6)["postmortem"] == 1


def test_dispatch_failure_lands_pending_boundary(tmp_path):
    cfg = _cfg(tmp_path, True, nsteps=6, hist=0, ckpt=2, interval=2)
    sim = Simulation(cfg, device="cpu")
    fn2 = sim._segment_fn(2)
    calls = {"n": 0}

    def failing_fn(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("dispatch failed")
        return fn2(*a, **k)

    failing_fn.obs_samples = fn2.obs_samples
    sim._segment_cache[2] = failing_fn
    with pytest.raises(RuntimeError, match="dispatch failed"):
        sim.run()
    sim.close()
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 2
    segs = read_records(str(tmp_path / "telemetry.jsonl"), kind="segment")
    assert [s["step"] for s in segs if s["steps"] > 0] == [2]
