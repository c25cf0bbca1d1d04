"""Structured telemetry sink: run manifest and per-segment JSONL records.

Counterpart of :mod:`jaxstream.obs.sink`, with its schema: one run is
one JSONL file whose line 1 is the ``manifest`` record (config echo,
devices, metric names); each segment then appends one ``segment``
record, guards append ``guard`` records, a crash dump ``flight`` and
``crash`` records, a resumed run a ``resume`` record.  The records keep
the JAX package's kinds and keys, so ``scripts/telemetry_report.py``,
``telemetry_dashboard.py`` and ``postmortem.py`` read a port run's file
unchanged.  The manifest's ``devices`` block comes from torch, and
``torch_version`` / ``cuda_version`` stand where the JAX manifest has
``jax_version``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import torch

__all__ = ["RECORD_KINDS", "TelemetrySink", "read_records",
           "validate_record", "run_manifest"]

#: kind -> required keys (beyond "kind"); extra keys are legal.  The JAX
#: package's table: the kinds of its server, gateway, load harness,
#: assimilation and performance observatory are kept so that one reader
#: validates either package's files.  A ``segment`` record may carry
#: ``host_wait_s``, the host seconds of I/O that blocked the next
#: segment's dispatch since the previous record.
RECORD_KINDS: Dict[str, tuple] = {
    "manifest": ("schema_version", "created_unix", "metric_names",
                 "interval", "guards", "config", "devices"),
    "segment": ("step", "t", "steps", "wall_s", "steps_per_sec",
                "sim_days_per_sec_per_chip", "metrics", "drift"),
    "guard": ("event", "step", "t", "value", "policy",
              "last_good_step", "last_good_t"),
    "bench": ("metric", "value", "unit"),
    "serve": ("bucket", "occupancy", "queue_depth", "wall_s"),
    "gateway": ("id", "status", "latency_s"),
    "loadgen": ("id", "ic", "nsteps", "status", "latency_s"),
    "autoscale": ("from_bucket", "to_bucket", "queue_depth",
                  "occupancy", "reason"),
    "span": ("trace_id", "span_id", "parent_id", "id", "name",
             "start_s", "duration_s"),
    "da": ("cycle", "step", "t", "mode", "spread", "rmse",
           "spread_post", "rmse_post", "innovation_rms"),
    "memory": ("devices", "bytes_in_use", "peak_bytes", "limit_bytes"),
    "perf": ("plan", "compile_seconds", "memory"),
    # Written only at a crash-bundle dump: the merged flight ring's
    # event, thread and dropped-event counts.
    "flight": ("events", "threads", "dropped"),
    # The pointer from a sink file to its crash bundle.
    "crash": ("bundle", "path", "reason"),
    "warmpool": ("event", "rung", "plan"),
    "headroom": ("action", "bucket", "headroom_frac",
                 "min_headroom_frac"),
    # A run resumed from a checkpoint that found a committed crash
    # bundle: the bundle it descends from and the step it resumed at.
    "resume": ("bundle", "checkpoint_step", "step"),
}

SCHEMA_VERSION = 1


def validate_record(rec: dict) -> dict:
    """Raise ``ValueError`` unless ``rec`` is schema-valid; returns it."""
    kind = rec.get("kind")
    if kind not in RECORD_KINDS:
        raise ValueError(
            f"telemetry record kind {kind!r} unknown; valid: "
            f"{sorted(RECORD_KINDS)}")
    missing = sorted(k for k in RECORD_KINDS[kind] if k not in rec)
    if missing:
        raise ValueError(
            f"telemetry {kind!r} record missing keys {missing}")
    return rec


def run_manifest(metric_names=(), interval: int = 0, guards: str = "off",
                 config: Optional[dict] = None, device=None) -> dict:
    """The static run-identity record (line 1 of every sink file).

    ``device``: the run's device (default: the GPU when there is one);
    ``platform`` is ``"gpu"`` or ``"cpu"``, ``count`` the devices of
    that platform this process sees, one process.
    """
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    gpu = torch.device(device).type == "cuda"
    return {
        "kind": "manifest",
        "schema_version": SCHEMA_VERSION,
        "created_unix": time.time(),
        "metric_names": list(metric_names),
        "interval": int(interval),
        "guards": guards,
        "config": config or {},
        "devices": {
            "platform": "gpu" if gpu else "cpu",
            "count": torch.cuda.device_count() if gpu else 1,
            "process_index": 0,
            "process_count": 1,
        },
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }


class TelemetrySink:
    """JSONL writer for ONE run; validates every record on the way out.

    Flushes per record (line buffering): telemetry's value is surviving
    the crash that truncates the run.  Opening a sink truncates an
    existing file (one file is one run).  Used from one thread at a
    time: under the async host pipeline every ``write`` is a task on the
    single background writer thread, FIFO with the history and
    checkpoint tasks, so the file is the synchronous path's.
    """

    def __init__(self, path: str, manifest: dict):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "w", buffering=1)
        self.n_written = 0
        self.write(manifest)

    def write(self, rec: dict) -> dict:
        validate_record(rec)
        self._fh.write(json.dumps(rec) + "\n")
        self.n_written += 1
        return rec

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, kind: Optional[str] = None) -> List[dict]:
    """Parse a sink file back; optionally filter to one record kind."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = validate_record(json.loads(line))
            if kind is None or rec["kind"] == kind:
                out.append(rec)
    return out
