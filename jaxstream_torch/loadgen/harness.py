"""Closed-loop load harness over the HTTP gateway (round 14).

Counterpart of :mod:`jaxstream.loadgen.harness`, whose code this module
keeps as it is (pure Python in both packages; the port keeps its own
copy, so that it imports nothing of the JAX package). Names, record
kinds, messages and outputs are the JAX module's.

Replays a deterministic arrival trace (:mod:`.trace`) against a
gateway over loopback HTTP and measures what a production SLO cares
about: per-request latency percentiles (submit-to-final-result wall
time), goodput (member-steps of COMPLETED work per wall second — shed
or evicted work counts for nothing), and the shed/completed accounting
that proves overload behavior is the typed 429/503 contract.

"Closed loop" is meant twice:

* the client side runs a bounded worker pool — when every worker is
  busy, dispatch blocks, so offered load responds to service rate the
  way real clients with timeouts do (no unbounded open-loop pileup on
  the client);
* the serving side feeds its own telemetry (queue depth + occupancy)
  to the autoscale policy (:mod:`.autoscale`), which resizes the
  active bucket cap live — the measurement loop and the control loop
  close over the same signals.

Every outcome lands in the loadgen sink in TRACE ORDER from one writer
after the run (not arrival-of-completion order), so two runs of the
same trace produce byte-equal sink records once wall-clock fields are
masked — the replayability contract tests/test_loadgen.py asserts.
"""

from __future__ import annotations

import json
import threading
import time
from typing import List, Optional

import numpy as np

from ..gateway import protocol
from ..gateway.client import GatewayError, submit_streaming
from ..obs import trace as obs_trace
from ..obs.sink import TelemetrySink, read_records, run_manifest
from ..utils.logging import get_logger

__all__ = ["run_load", "summarize_outcomes", "masked_records",
           "SHED_STATUSES", "TIMING_FIELDS"]

log = get_logger(__name__)

#: Typed-shed outcome statuses (HTTP 429/503 admission refusals) —
#: the protocol's one error-code -> status map, value side.
SHED_STATUSES = tuple(protocol.SHED_STATUS.values())

#: Outcome/sink fields carrying wall-clock time — masked for the
#: byte-determinism comparison of two runs of the same trace.
TIMING_FIELDS = ("latency_s", "dispatched_at_s", "server_latency_s")


def _one_request(host: str, port: int, entry: dict, timeout: float,
                 trace: bool = False) -> dict:
    """Submit one trace entry, stream to completion, classify."""
    req = {k: entry[k] for k in
           ("id", "ic", "nsteps", "seed", "amplitude", "outputs")
           if k in entry}
    out = {"id": entry["id"], "ic": entry["ic"],
           "nsteps": int(entry["nsteps"])}
    if trace:
        # The deterministic trace identity — no protocol plumbing
        # needed (jaxstream.obs.trace digests the request id), so the
        # client-side records join the server's span trees by id.
        tid = obs_trace.trace_id_for(entry["id"])
        out["trace_id"] = tid
        out["span_id"] = obs_trace.span_id_for(tid, "client", 0)
        out["parent_id"] = obs_trace.root_span_id(tid)
    t0 = time.perf_counter()
    try:
        status, events = submit_streaming(host, port, req,
                                          timeout=timeout)
        out["latency_s"] = round(time.perf_counter() - t0, 6)
        out["http_status"] = status
        final = events[-1] if events else {}
        if final.get("event") == "result":
            out["status"] = final["summary"]["status"]      # ok/evicted
            out["steps_run"] = int(final["summary"]["steps_run"])
            if trace:
                # The server-reported end-to-end latency — the span
                # tree's root duration, which the completeness check
                # sums against (the client-side latency_s above
                # additionally carries the HTTP round trip).
                out["server_latency_s"] = float(
                    final["summary"].get("latency_s", 0.0))
        else:
            out["status"] = "error"
            out["steps_run"] = 0
            out["error"] = final.get("error", "truncated_stream")
        out["segments"] = sum(1 for ev in events
                              if ev.get("event") == "segment")
    except GatewayError as e:
        out["latency_s"] = round(time.perf_counter() - t0, 6)
        out["http_status"] = e.status
        shed = protocol.SHED_STATUS.get(e.error)
        out["status"] = shed or "error"
        out["steps_run"] = 0
        out["segments"] = 0
        if shed is None:
            out["error"] = e.error
    except Exception as e:
        out["latency_s"] = round(time.perf_counter() - t0, 6)
        out["http_status"] = 0
        out["status"] = "error"
        out["steps_run"] = 0
        out["segments"] = 0
        out["error"] = f"{type(e).__name__}: {e}"
    return out


def run_load(host: str, port: int, trace: List[dict], *,
             time_scale: float = 1.0, max_workers: int = 8,
             request_timeout: float = 300.0,
             sink: str = "", dt: Optional[float] = None,
             trace_spans: bool = False,
             span_sinks: Optional[List[str]] = None) -> dict:
    """Replay ``trace`` against ``host:port``; return the SLO summary.

    ``time_scale`` multiplies the trace's arrival offsets (0 = replay
    as one burst); ``max_workers`` bounds in-flight client requests
    (the closed loop); ``dt`` (seconds per stepper call) converts
    goodput into aggregate sim-days/sec when given.  ``sink`` names a
    JSONL file for the per-request ``loadgen`` records + a ``bench``
    summary record.

    ``trace_spans`` (round 17): the gateway's deployment runs with
    ``serve.trace: true`` — loadgen records then carry
    ``trace_id``/``span_id``/``parent_id``, and when ``span_sinks``
    names the serve/gateway sink files the harness ASSERTS span
    completeness: every completed request must reassemble into exactly
    one root + >= 1 segment span whose leaf durations sum to the
    server-reported latency within the declared epsilon
    (``jaxstream.obs.trace``).  The summary gains ``spans_complete``
    (fraction) + ``span_failures`` — the bench ``serving_slo`` section
    enforces ``spans_complete == 1.0``.
    """
    sem = threading.BoundedSemaphore(max_workers)
    outcomes: List[Optional[dict]] = [None] * len(trace)
    threads = []
    t_start = time.perf_counter()

    def worker(i, entry):
        try:
            # Stamped BEFORE the request so the field really is the
            # dispatch offset (offered-load timeline), not completion.
            dispatched = round(time.perf_counter() - t_start, 6)
            out = _one_request(host, port, entry, request_timeout,
                               trace=trace_spans)
            out["dispatched_at_s"] = dispatched
            outcomes[i] = out
        finally:
            sem.release()

    # One short-lived DAEMON thread per dispatched request, bounded to
    # max_workers in flight by the semaphore.  Deliberately not a
    # ThreadPoolExecutor: its workers are non-daemon and joined at
    # interpreter exit, so one hung request would hang the CLI forever
    # — an abandoned (join-deadline-expired) daemon worker instead
    # dies with the process.  Thread churn is microseconds against an
    # HTTP round trip.
    for i, entry in enumerate(trace):
        target = float(entry.get("t", 0.0)) * time_scale
        delay = target - (time.perf_counter() - t_start)
        if delay > 0:
            time.sleep(delay)
        sem.acquire()                      # closed-loop backpressure
        th = threading.Thread(target=worker, args=(i, entry),
                              name=f"jaxstream-loadgen-{i}",
                              daemon=True)
        th.start()
        threads.append(th)
    # One overall deadline (not per-thread): the timeout bounds the
    # whole drain, not n_requests x timeout of sequential joins.
    deadline = time.perf_counter() + request_timeout
    for th in threads:
        th.join(max(0.0, deadline - time.perf_counter()))
    wall = time.perf_counter() - t_start
    # Freeze a snapshot: a worker that outlived its join timeout keeps
    # writing into `outcomes`, and the summary and the sink records
    # must agree with each other, not with whatever lands later.
    final = [dict(o) if o is not None else
             {"id": trace[i]["id"], "ic": trace[i]["ic"],
              "nsteps": int(trace[i]["nsteps"]), "status": "error",
              "error": "worker_timeout", "latency_s": wall,
              "http_status": 0, "steps_run": 0, "segments": 0}
             for i, o in enumerate(outcomes)]
    summary = summarize_outcomes(final, wall, dt=dt)
    if trace_spans and span_sinks:
        # Span-completeness assertion surface: every request the
        # harness saw COMPLETE (ok or evicted — the server owned it to
        # a final state) must have a full tree in the serve sinks.
        records = []
        for path in span_sinks:
            records.extend(read_records(path, kind="span"))
        latencies = {o["id"]: o.get("server_latency_s", 0.0)
                     for o in final if o["status"] in ("ok", "evicted")}
        cov = obs_trace.span_coverage(records, latencies)
        summary["spans_checked"] = cov["checked"]
        summary["spans_complete"] = cov["spans_complete"]
        summary["span_failures"] = cov["failures"]
    if sink:
        s = TelemetrySink(sink, run_manifest(config={
            "loadgen": True, "n_requests": len(trace),
            "time_scale": time_scale, "max_workers": max_workers,
        }))
        for out in final:                  # one writer, trace order
            s.write(dict(out, kind="loadgen"))
        s.write({"kind": "bench", "metric": "loadgen_summary",
                 "value": summary["goodput_member_steps_per_sec"],
                 "unit": "member-steps/sec goodput", **{
                     k: summary[k] for k in
                     ("completed", "shed", "errors", "latency_p50_s",
                      "latency_p99_s")}})
        s.close()
    return summary


def summarize_outcomes(outcomes: List[dict], wall_s: float,
                       dt: Optional[float] = None) -> dict:
    """Aggregate one run's outcomes into the SLO summary."""
    lat = np.asarray([o["latency_s"] for o in outcomes
                      if o["status"] == "ok"], np.float64)
    completed = sum(1 for o in outcomes if o["status"] == "ok")
    evicted = sum(1 for o in outcomes if o["status"] == "evicted")
    shed_by = {s: sum(1 for o in outcomes if o["status"] == s)
               for s in SHED_STATUSES}
    shed = sum(shed_by.values())
    errors = sum(1 for o in outcomes if o["status"] == "error")
    good_steps = sum(o.get("steps_run", 0) for o in outcomes
                     if o["status"] == "ok")
    summary = {
        "n_requests": len(outcomes),
        "completed": completed,
        "evicted": evicted,
        "shed": shed,
        "shed_by": shed_by,
        "errors": errors,
        # The overload contract: every request either completed
        # (ok/evicted — the server owned it to a final state) or was
        # shed with a TYPED 429/503.  Anything else is a bug.
        "accounting_exact": bool(
            completed + evicted + shed == len(outcomes) and errors == 0),
        "latency_p50_s": (round(float(np.percentile(lat, 50)), 4)
                          if len(lat) else None),
        "latency_p99_s": (round(float(np.percentile(lat, 99)), 4)
                          if len(lat) else None),
        "latency_max_s": (round(float(lat.max()), 4)
                          if len(lat) else None),
        "goodput_member_steps": int(good_steps),
        "goodput_member_steps_per_sec": round(good_steps / wall_s, 2)
        if wall_s > 0 else 0.0,
        "goodput_requests_per_sec": round(completed / wall_s, 3)
        if wall_s > 0 else 0.0,
        "wall_s": round(wall_s, 3),
    }
    if dt:
        summary["goodput_sim_days_per_sec"] = round(
            good_steps * dt / 86400.0 / wall_s, 4) if wall_s > 0 else 0.0
    return summary


def masked_records(path: str) -> List[str]:
    """The sink's ``loadgen`` records as canonical JSON strings with
    wall-clock fields zeroed — the byte-determinism comparison surface
    (two runs of the same trace must compare equal)."""
    out = []
    for rec in read_records(path, kind="loadgen"):
        for k in TIMING_FIELDS:
            if k in rec:
                rec[k] = 0.0
        out.append(json.dumps(rec, sort_keys=True))
    return out
