"""Request-scoped tracing: one span tree per served scenario request.

Counterpart of :mod:`jaxstream.obs.trace`, whose code this module keeps
as it is (pure Python in both packages; the port keeps its own copy, so
that it imports nothing of the JAX package). Names, record kinds,
messages and outputs are the JAX module's.

The serving stack (rounds 11-14) records *aggregate* stats — occupancy,
host_wait, guard events — but no record can answer the first production
question: **where did request X spend its time?**  This module is the
answer's data model.  Every admitted request gets a deterministic
``trace_id``; its lifecycle phases (queue wait, pack-into-slot,
per-segment device compute, health-stream host wait, boundary work,
finalize wait, d2h result fetch, background-writer flush — plus the
gateway's ingress/egress on network submissions) become typed ``span``
records in the existing :mod:`jaxstream.obs.sink` JSONL stream, and the
spans of one request reassemble into a tree whose LEAF durations sum to
the request's reported end-to-end latency.

Design rules that make the sum property hold *by construction* rather
than by hope:

* **Marks, not paired start/stops.**  A :class:`RequestTrace` is an
  append-only list of ``(phase, timestamp)`` boundary marks; leaf k is
  the interval from mark k to mark k+1 (the last leaf ends at the
  finish timestamp).  Consecutive intervals telescope, so the leaf sum
  IS the root duration up to float rounding — no phase can be dropped
  or double-counted by an unbalanced stop.
* **The root interval is the latency interval.**  The trace starts at
  the same ``perf_counter`` stamp the server writes into
  ``submitted_wall`` and finishes at the instant the result's latency
  is stamped, so root duration == reported ``latency_s`` exactly.
* **Deterministic ids.**  ``trace_id`` is a digest of the request id
  and ``span_id`` a digest of ``(trace_id, name, seq)``, so two runs of
  the same trace produce byte-identical span records once wall-clock
  fields are masked (the replayability contract), and the gateway can
  parent its ingress/egress spans to the root WITHOUT any shared state
  — it recomputes the root span id from the request id alone.

Gateway-side spans (``gateway.ingress`` before admission,
``gateway.egress`` after result encode) sit just outside the server's
root interval; they are why the span-completeness check carries an
epsilon (:data:`EPSILON_ABS_S` + :data:`EPSILON_FRAC`) instead of
demanding exact equality.

The span *names* double as ``torch.profiler.record_function`` regions
around the serving segment (:func:`jaxstream_torch.stepping.
integrate_masked`), so a profiler capture (``POST /v1/profile``) shows
the same region names the sink spans carry.

Stdlib only — no torch, no numpy — so the reassembly helpers stay
cheap to unit-test and easy to mirror in the stdlib-only ``scripts/``
tools.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "EPSILON_ABS_S", "EPSILON_FRAC", "PHASE_OF", "SPAN_TIMING_KEYS",
    "ROOT", "GATEWAY_INGRESS", "QUEUE_WAIT", "PACK", "SEGMENT",
    "HOST_WAIT", "BOUNDARY", "FINALIZE_WAIT", "RESULT_FETCH",
    "WRITER_FLUSH", "GATEWAY_EGRESS",
    "RequestTrace", "trace_id_for", "span_id_for", "root_span_id",
    "terminal_span", "spans_by_request", "span_tree", "leaf_sum_s",
    "tree_complete", "span_coverage", "masked_spans",
]

#: Declared measurement-overhead budget of the span-sum property: the
#: leaf durations of one request's tree must sum to its reported
#: latency within ``EPSILON_ABS_S + EPSILON_FRAC * latency``.  The
#: server-side leaves telescope exactly (see module docstring); the
#: slack covers the gateway's ingress/egress leaves (which sit outside
#: the latency interval) and sub-microsecond rounding of the recorded
#: durations.
EPSILON_ABS_S = 0.05
EPSILON_FRAC = 0.05

# ------------------------------------------------------------ span names
#: The root span: one per request, parent of every leaf.
ROOT = "request"
GATEWAY_INGRESS = "gateway.ingress"   # body decode + admission
QUEUE_WAIT = "queue.wait"             # admitted -> popped into a batch
PACK = "serve.pack"                   # IC build + stack/inject into slot
SEGMENT = "serve.segment"             # one compiled masked segment
HOST_WAIT = "serve.host_wait"         # health-stream d2h residual block
BOUNDARY = "serve.boundary"           # evict/extract/refill boundary work
FINALIZE_WAIT = "finalize.wait"       # queued behind the result writer
RESULT_FETCH = "result.fetch"         # d2h output fetch resolution
WRITER_FLUSH = "writer.flush"         # result build + output-store write
GATEWAY_EGRESS = "gateway.egress"     # result encode + stream handoff

#: leaf span name -> report/dashboard phase bucket.  scripts/
#: telemetry_report.py and scripts/telemetry_dashboard.py carry a
#: literal copy of this table (they must run with no jaxstream import);
#: tests/test_trace.py asserts the copies stay identical.
PHASE_OF: Dict[str, str] = {
    GATEWAY_INGRESS: "ingress",
    QUEUE_WAIT: "queue",
    PACK: "pack",
    SEGMENT: "compute",
    HOST_WAIT: "host_wait",
    BOUNDARY: "boundary",
    FINALIZE_WAIT: "egress",
    RESULT_FETCH: "egress",
    WRITER_FLUSH: "egress",
    GATEWAY_EGRESS: "egress",
}

#: Span-record fields carrying wall-clock time — masked for the
#: byte-determinism comparison of two runs of the same trace.
SPAN_TIMING_KEYS = ("start_s", "duration_s")


def trace_id_for(request_id: str) -> str:
    """Deterministic 16-hex trace id of one request.

    A pure digest of the request id: byte-stable across runs and
    processes, and recomputable by every layer (gateway, loadgen
    client, report CLI) without plumbing the id through the protocol.
    """
    h = hashlib.sha256(("jaxstream-trace:" + request_id).encode("utf-8"))
    return h.hexdigest()[:16]


def span_id_for(trace_id: str, name: str, seq: int) -> str:
    """Deterministic 12-hex span id (digest of trace/name/ordinal)."""
    h = hashlib.sha256(f"{trace_id}/{name}/{int(seq)}".encode("utf-8"))
    return h.hexdigest()[:12]


def root_span_id(trace_id: str) -> str:
    """The root span's id — seq 0 by convention, so any layer that
    knows the request id can parent spans to the root."""
    return span_id_for(trace_id, ROOT, 0)


def terminal_span(request_id: str, status: str,
                  duration_s: float = 0.0, start_s: float = 0.0) -> dict:
    """A root-only tree for a request that never reached serving —
    typed sheds (``shed_queue_full``/``shed_draining``/
    ``shed_admission``) carry their terminal status here so a trace
    query answers 'what happened to request X' even when the answer is
    'the gateway refused it'."""
    tid = trace_id_for(request_id)
    return {
        "kind": "span", "trace_id": tid, "span_id": root_span_id(tid),
        "parent_id": None, "id": request_id, "name": ROOT, "seq": 0,
        "start_s": round(float(start_s), 6),
        "duration_s": round(float(duration_s), 6), "status": status,
    }


class RequestTrace:
    """One request's lifecycle marks -> its span records.

    Append-only and single-writer by construction: ``mark`` is called
    from the serving thread (queue/pack/segment phases) and then from
    the background writer thread (finalize phases) — the writer only
    takes over after the serving thread queued the finalization, so no
    two threads ever mark concurrently.
    """

    __slots__ = ("request_id", "trace_id", "t0", "marks")

    def __init__(self, request_id: str, t0: Optional[float] = None):
        self.request_id = request_id
        self.trace_id = trace_id_for(request_id)
        self.t0 = time.perf_counter() if t0 is None else float(t0)
        #: (name, timestamp, attrs); the first mark opens queue.wait at
        #: the root start, so the leaves tile the root interval.
        self.marks: List[Tuple[str, float, dict]] = [
            (QUEUE_WAIT, self.t0, {})]

    def mark(self, name: str, t: Optional[float] = None, **attrs):
        """Open phase ``name`` at ``t`` (now), closing the previous one."""
        self.marks.append(
            (name, time.perf_counter() if t is None else float(t), attrs))

    def finish(self, status: str, t_end: Optional[float] = None
               ) -> List[dict]:
        """Close the trace at ``t_end``; returns root + leaf records.

        Leaf k spans ``marks[k] -> marks[k+1]`` (the last leaf ends at
        ``t_end``), so the durations telescope to the root's.  Negative
        intervals (a clock that cannot happen with monotonic marks, but
        a caller bug could produce) are clamped to 0 so a bad mark
        shows up as a missing-time epsilon breach, not a negative bar.
        """
        t_end = time.perf_counter() if t_end is None else float(t_end)
        rid = root_span_id(self.trace_id)
        records = [{
            "kind": "span", "trace_id": self.trace_id, "span_id": rid,
            "parent_id": None, "id": self.request_id, "name": ROOT,
            "seq": 0, "start_s": 0.0,
            "duration_s": round(t_end - self.t0, 6), "status": status,
        }]
        for i, (name, t, attrs) in enumerate(self.marks):
            t_next = (self.marks[i + 1][1] if i + 1 < len(self.marks)
                      else t_end)
            rec = {
                "kind": "span", "trace_id": self.trace_id,
                "span_id": span_id_for(self.trace_id, name, i + 1),
                "parent_id": rid, "id": self.request_id, "name": name,
                "seq": i + 1, "start_s": round(t - self.t0, 6),
                "duration_s": round(max(t_next - t, 0.0), 6),
            }
            rec.update(attrs)
            records.append(rec)
        return records


# ------------------------------------------------------------ reassembly
def spans_by_request(records: Iterable[dict]) -> Dict[str, List[dict]]:
    """Group ``span`` records by request id (sinks may interleave many
    requests and many files — the dashboard tails a fleet)."""
    out: Dict[str, List[dict]] = {}
    for rec in records:
        if rec.get("kind") != "span":
            continue
        out.setdefault(rec["id"], []).append(rec)
    return out


def span_tree(spans: List[dict]) -> dict:
    """One request's spans -> ``{"root": rec|None, "leaves": [recs]}``
    with leaves in ``seq`` order (their wall order)."""
    roots = [s for s in spans if s.get("parent_id") is None]
    leaves = sorted((s for s in spans if s.get("parent_id") is not None),
                    key=lambda s: s.get("seq", 0))
    return {"root": roots[0] if len(roots) == 1 else None,
            "n_roots": len(roots), "leaves": leaves}


def leaf_sum_s(spans: List[dict]) -> float:
    return sum(s["duration_s"] for s in spans
               if s.get("parent_id") is not None)


def tree_complete(spans: List[dict],
                  latency_s: Optional[float] = None
                  ) -> Tuple[bool, str]:
    """Is one request's span set a complete tree?

    Complete means: exactly one root; every leaf parented to it; at
    least one ``serve.segment`` leaf (the request demonstrably ran on
    a device); and — when the reported latency is given — leaf
    durations summing to it within the declared epsilon.  Returns
    ``(ok, reason)`` with a human-readable reason on failure.
    """
    tree = span_tree(spans)
    if tree["root"] is None:
        return False, f"{tree['n_roots']} root spans (need exactly 1)"
    rid = tree["root"]["span_id"]
    bad = [s["span_id"] for s in tree["leaves"]
           if s["parent_id"] != rid]
    if bad:
        return False, f"leaves parented outside the root: {bad}"
    if not any(s["name"] == SEGMENT for s in tree["leaves"]):
        return False, "no serve.segment leaf (request never ran)"
    if latency_s is not None:
        total = leaf_sum_s(spans)
        eps = EPSILON_ABS_S + EPSILON_FRAC * max(latency_s, 0.0)
        if abs(total - latency_s) > eps:
            return False, (f"leaf sum {total:.6f}s vs latency "
                           f"{latency_s:.6f}s exceeds eps {eps:.6f}s")
    return True, "ok"


def span_coverage(records: Iterable[dict],
                  latencies: Dict[str, float]) -> dict:
    """Fleet-level span completeness over one or many sink files.

    ``latencies`` maps request id -> reported end-to-end latency for
    every request that should carry a COMPLETE tree (completed or
    evicted requests; sheds carry a terminal root only and are not
    counted here).  Returns the ``spans_complete`` fraction the loadgen
    harness asserts and the bench ``serving_slo`` section stamps.
    """
    grouped = spans_by_request(records)
    failures = {}
    for req_id, lat in latencies.items():
        ok, why = tree_complete(grouped.get(req_id, []), lat)
        if not ok:
            failures[req_id] = why
    n = len(latencies)
    return {
        "checked": n,
        "complete": n - len(failures),
        "spans_complete": (n - len(failures)) / n if n else 1.0,
        "failures": failures,
    }


def masked_spans(records: Iterable[dict]) -> List[str]:
    """``span`` records as canonical JSON with wall-clock fields zeroed
    — the byte-determinism surface (two runs of one trace must compare
    equal; span ids, names, seqs, buckets and chips are all
    deterministic for a given packing)."""
    out = []
    for rec in records:
        if rec.get("kind") != "span":
            continue
        rec = dict(rec)
        for k in SPAN_TIMING_KEYS:
            if k in rec:
                rec[k] = 0.0
        out.append(json.dumps(rec, sort_keys=True))
    return out
