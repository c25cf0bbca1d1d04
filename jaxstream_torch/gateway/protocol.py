"""Wire schema of the network gateway (round 14).

Counterpart of :mod:`jaxstream.gateway.protocol`, whose code this module
keeps as it is (pure Python in both packages; the port keeps its own
copy, so that it imports nothing of the JAX package). Names, record
kinds, messages and outputs are the JAX module's.

One request = one connection = one ordered event stream.  A client
POSTs a :class:`jaxstream.serve.request.ScenarioRequest` as JSON and
reads newline-delimited JSON events back on the same connection (the
WebSocket endpoint speaks the identical events, one per message):

  ``{"event": "accepted", "id": ..., "protocol": 1}``
      admission succeeded; the request is queued.
  ``{"event": "segment", "id": ..., "steps_done": ..., "nsteps": ...,
  "t": ..., "bucket": ..., "done": ...}``
      one per compiled segment boundary the request was resident for —
      the server's own progress events, serialized verbatim (no wall-
      clock fields, so the stream is deterministic for a given packing).
  ``{"event": "result", "summary": {...}, "fields": {...}}``
      the final summary (status/steps_run/t_final/latency_s/guard
      event) plus the requested output arrays, byte-preserving (raw
      array bytes base64-encoded with dtype+shape — the gateway may
      serialize but never perturb; the loopback parity test
      byte-compares a decoded round trip against a direct
      ``EnsembleServer`` submission).
  ``{"event": "error", "error": <code>, "message": ...}``
      typed failure.  Overload is a CONTRACT, not an accident: the
      error codes map to fixed HTTP statuses (``ERROR_STATUS``) so a
      load balancer can tell "back off and retry" (429 ``queue_full``)
      from "this deployment is going away or unhealthy" (503
      ``draining`` / ``admission_refused``).

Everything here is pure serialization — stdlib + numpy only, no jax,
no aiohttp — so the blocking client (:mod:`.client`), the loadgen
harness, and the tests all share one codec.
"""

from __future__ import annotations

import base64
import dataclasses
import json
from typing import Dict, Optional

import numpy as np

from ..serve.request import RequestResult, ScenarioRequest

__all__ = [
    "PROTOCOL_VERSION", "ERROR_STATUS", "SHED_STATUS", "encode_array",
    "decode_array", "request_from_json", "accepted_event",
    "segment_event", "result_event", "error_event", "decode_result",
    "canonical",
]

PROTOCOL_VERSION = 1

#: error code -> HTTP status.  429 means "retry later" (transient
#: backpressure); 503 means "stop sending here" (draining or
#: health-refused); 4xx are caller bugs.
ERROR_STATUS: Dict[str, int] = {
    "bad_request": 400,
    "duplicate_id": 409,
    "queue_full": 429,
    "draining": 503,
    "admission_refused": 503,
    "shutdown": 503,
    "internal": 500,
    # Round 17, POST /v1/profile: the jax build (or this deployment)
    # cannot capture profiler traces / start-stop state misuse.
    "profiler_unavailable": 501,
    "profile_conflict": 409,
}

#: Typed-refusal error code -> shed outcome status.  The ONE place the
#: mapping lives: the gateway's shed accounting and the loadgen
#: harness's outcome classification both read it, so a new typed
#: refusal can never be half-wired into an untyped 'error'.
SHED_STATUS: Dict[str, str] = {
    "queue_full": "shed_queue_full",
    "draining": "shed_draining",
    "admission_refused": "shed_admission",
}

#: ``summary`` keys that carry wall-clock time — masked by the parity
#: tests (everything else in a stream is deterministic for a given
#: packing).
TIMING_KEYS = ("latency_s",)


def encode_array(a) -> dict:
    """Byte-preserving array codec: raw bytes + dtype + shape."""
    a = np.ascontiguousarray(np.asarray(a))
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data_b64": base64.b64encode(a.tobytes()).decode("ascii")}


def decode_array(d: dict) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["data_b64"]),
                         dtype=np.dtype(d["dtype"])).reshape(d["shape"])


def request_from_json(d) -> ScenarioRequest:
    """Wire mapping -> validated request (unknown keys rejected).

    ``submitted_wall`` is server-side bookkeeping — a client supplying
    it would skew the latency accounting, so it is rejected here even
    though the dataclass carries the field.
    """
    if not isinstance(d, dict):
        raise ValueError(f"request body must be a JSON object, got "
                         f"{type(d).__name__}")
    if "submitted_wall" in d:
        raise ValueError("'submitted_wall' is stamped by the server; "
                         "remove it from the request body")
    if not d.get("id"):
        raise ValueError("request body needs a non-empty 'id'")
    if isinstance(d.get("state"), dict):
        # Raw-array initial conditions (ic: 'array', round 18): each
        # field arrives as the byte-preserving b64 payload encode_array
        # produces — decode to host numpy so the request codec's
        # output is what a direct EnsembleServer submission carries.
        d = dict(d)
        try:
            d["state"] = {k: (decode_array(v) if isinstance(v, dict)
                              else v)
                          for k, v in d["state"].items()}
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(
                f"bad 'state' array payload: {type(e).__name__}: {e}"
            ) from None
    try:
        return ScenarioRequest.from_dict(d)
    except TypeError as e:
        # Wrong-typed fields (nsteps: "5", outputs: 5, ...) surface as
        # TypeError from the dataclass validation; callers of this
        # codec map ValueError to the typed 400 — keep the contract.
        raise ValueError(f"bad request field types: {e}") from None


def accepted_event(rid: str) -> dict:
    return {"event": "accepted", "id": rid,
            "protocol": PROTOCOL_VERSION}


def segment_event(progress: dict) -> dict:
    """The server's per-segment progress dict, tagged for the wire."""
    ev = {"event": "segment"}
    ev.update(progress)
    return ev


def result_event(res: RequestResult) -> dict:
    """Final summary + byte-preserving field payloads.

    The summary is assembled field-by-field rather than via
    ``dataclasses.asdict``, which would deep-copy every output array
    just to discard the copies — megabytes per result at production
    grid sizes, on the streaming hot path.
    """
    summary = {f.name: getattr(res, f.name)
               for f in dataclasses.fields(res) if f.name != "fields"}
    return {"event": "result", "summary": summary,
            "fields": {k: encode_array(v)
                       for k, v in (res.fields or {}).items()}}


def error_event(code: str, message: str,
                rid: Optional[str] = None) -> dict:
    if code not in ERROR_STATUS:
        raise ValueError(f"unknown gateway error code {code!r}; valid: "
                         f"{sorted(ERROR_STATUS)}")
    ev = {"event": "error", "error": code, "message": message}
    if rid is not None:
        ev["id"] = rid
    return ev


def decode_result(ev: dict) -> RequestResult:
    """A ``result`` event back into a :class:`RequestResult` with numpy
    field arrays — the client-side half of the byte-parity contract."""
    if ev.get("event") != "result":
        raise ValueError(f"not a result event: {ev.get('event')!r}")
    summary = dict(ev["summary"])
    fields = {k: decode_array(v) for k, v in ev.get("fields", {}).items()}
    return RequestResult(fields=fields, **summary)


def canonical(ev: dict, mask_timing: bool = True) -> str:
    """Deterministic serialization of one event for byte comparison
    (sorted keys; wall-clock summary fields zeroed when masked)."""
    ev = json.loads(json.dumps(ev))          # deep copy, JSON-clean
    if mask_timing and isinstance(ev.get("summary"), dict):
        for k in TIMING_KEYS:
            if k in ev["summary"]:
                ev["summary"][k] = 0.0
    return json.dumps(ev, sort_keys=True)
