"""Port: the network front door (``jaxstream_torch.gateway``) on the
standard library (queue A item 3, A6).

* The wire protocol against the JAX package's: the array codec, request
  decoding and its refusals, every event constructor and ``canonical()``
  give the JAX functions' output byte for byte.
* The gateway (``asyncio.start_server``, its own HTTP/1.1 and RFC 6455
  framing) over a port ``EnsembleServer`` at C8 on the CPU, loopback
  only: a gateway submission is byte-equal, on ``canonical()`` events,
  to a direct server submission; the WebSocket stream equals the HTTP
  one; health, readiness, stats and a metrics scrape that parses;
  typed 400/404/409/429/503; the dead serving loop's 503; a graceful
  drain with a request mid-flight; the sinks' span trees complete; the
  profile endpoint's typed contract, its capture holding the
  ``serve.segment`` region.

No JAX gateway is started: the JAX side of the comparison is its
protocol functions.  Tests bind 127.0.0.1 only.
"""

import http.client
import json
import logging
import threading

import numpy as np
import pytest

import torch_single_thread  # noqa: F401  (one CPU thread per worker)
from torch_scripts import run_script

from jaxstream.gateway import protocol as jprotocol
from jaxstream.serve import request as jrequest
from jaxstream.serve.request import RequestResult as JaxResult

from jaxstream_torch.gateway import (Gateway, GatewayError, get_json,
                                     get_text, post_json, protocol,
                                     submit_streaming)
from jaxstream_torch.gateway.client import final_result, submit_websocket
from jaxstream_torch.gateway.gateway import ws_accept_key
from jaxstream_torch.obs import trace as obs_trace
from jaxstream_torch.obs.registry import parse_exposition
from jaxstream_torch.obs.sink import read_records
from jaxstream_torch.serve import (EnsembleServer, RequestResult,
                                   ScenarioRequest)

N, DT = 8, 600.0
HOST = "127.0.0.1"


@pytest.fixture(autouse=True)
def _quiet_logs():
    lg = logging.getLogger("jaxstream_torch")
    level = lg.level
    lg.setLevel(logging.ERROR)
    yield
    lg.setLevel(level)


def _cfg(**over):
    cfg = {
        "grid": {"n": N},
        "time": {"dt": DT},
        "model": {"name": "shallow_water_cov", "backend": "jnp"},
        "parallelization": {"num_devices": 1},
        "serve": {"buckets": "1,2", "segment_steps": 2,
                  "queue_capacity": 16},
    }
    for k, v in over.items():
        cfg.setdefault(k, {}).update(v)
    return cfg


def _gateway(cfg, **kw):
    kw.setdefault("host", HOST)
    kw.setdefault("port", 0)
    return Gateway(cfg, device="cpu", **kw)


def _body(rid, ic="tc5", nsteps=5, seed=3):
    return {"id": rid, "ic": ic, "nsteps": nsteps, "seed": seed,
            "amplitude": 1e-3, "outputs": ["h", "u"]}


@pytest.fixture(scope="module")
def gw(tmp_path_factory):
    """One warm gateway (buckets {1, 2}, tracing on, both sinks)."""
    d = tmp_path_factory.mktemp("torch_gateway")
    g = _gateway(_cfg(serve={"trace": True,
                             "sink": str(d / "serve.jsonl")}),
                 sink=str(d / "gateway.jsonl"),
                 profile_dir=str(d / "profile"))
    g.start()
    g.tmp = d
    yield g
    g.close()


# ---------------------------------------------------------------- protocol
def test_protocol_codec_and_events_match_jax():
    rng = np.random.default_rng(4)
    for a in (rng.standard_normal((2, 3, 4)).astype(np.float32),
              rng.standard_normal(5), np.arange(6, dtype=np.int16)):
        assert protocol.encode_array(a) == jprotocol.encode_array(a)
        d = protocol.encode_array(a)
        assert protocol.decode_array(d).tobytes() == a.tobytes()
    assert protocol.ERROR_STATUS == jprotocol.ERROR_STATUS
    assert protocol.SHED_STATUS == jprotocol.SHED_STATUS
    assert protocol.PROTOCOL_VERSION == jprotocol.PROTOCOL_VERSION
    prog = {"id": "p", "steps_done": 2, "nsteps": 5, "t": 1200.0,
            "bucket": 2, "done": False}
    pairs = [(protocol.accepted_event("p"), jprotocol.accepted_event("p")),
             (protocol.segment_event(prog), jprotocol.segment_event(prog)),
             (protocol.error_event("queue_full", "m", rid="p"),
              jprotocol.error_event("queue_full", "m", rid="p"))]
    fields = {"h": rng.standard_normal((6, N, N)).astype(np.float32)}
    kw = dict(id="p", ic="tc5", nsteps=5, status="ok", t_final=3000.0,
              steps_run=5, latency_s=0.25, fields=fields)
    res_t, res_j = RequestResult(**kw), JaxResult(**kw)
    pairs.append((protocol.result_event(res_t),
                   jprotocol.result_event(res_j)))
    for a, b in pairs:
        assert protocol.canonical(a) == jprotocol.canonical(b)
        assert protocol.canonical(a, mask_timing=False) == \
            jprotocol.canonical(b, mask_timing=False)
    back = protocol.decode_result(pairs[-1][0])
    assert back.fields["h"].tobytes() == fields["h"].tobytes()
    with pytest.raises(ValueError, match="unknown gateway error code"):
        protocol.error_event("not_a_code", "boom")


_BAD_BODIES = [
    {"ic": "tc2", "nsteps": 1},
    {"id": "x", "ic": "tc2", "nsteps": 1, "submitted_wall": 1.0},
    {"id": "x", "color": "red"},
    {"id": "x", "ic": "tc2", "nsteps": "5"},
    {"id": "x", "ic": "tc2", "nsteps": 1, "seed": "7"},
    {"id": "x", "ic": "tc2", "nsteps": 1, "amplitude": "big"},
    {"id": "x", "ic": "tc2", "nsteps": 1, "outputs": 5},
    ["not", "a", "dict"],
    {"id": "x", "ic": "array", "nsteps": 1,
     "state": {"h": {"dtype": "float32"}, "u": {}}},
]


@pytest.mark.parametrize("body", _BAD_BODIES)
def test_request_decoding_refusals_match_jax(body):
    with pytest.raises(ValueError) as et:
        protocol.request_from_json(body)
    with pytest.raises(ValueError) as ej:
        jprotocol.request_from_json(body)
    assert str(et.value) == str(ej.value)


def test_request_decoding_matches_jax():
    state = {"h": np.ones((6, N, N), np.float32),
             "u": np.zeros((2, 6, N, N), np.float32)}
    body = {"id": "x", "ic": "array", "nsteps": 3,
            "state": {k: protocol.encode_array(v)
                      for k, v in state.items()}}
    a = protocol.request_from_json(dict(body))
    b = jprotocol.request_from_json(dict(body))
    assert isinstance(b, jrequest.ScenarioRequest)
    assert (a.id, a.ic, a.nsteps, a.outputs) == (b.id, b.ic, b.nsteps,
                                                 b.outputs)
    for k in state:
        assert a.state[k].tobytes() == b.state[k].tobytes()


def test_websocket_accept_key():
    """RFC 6455 section 1.3's worked example."""
    assert ws_accept_key("dGhlIHNhbXBsZSBub25jZQ==") == \
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


# ------------------------------------------------------- endpoints, streams
def test_health_ready_stats_metrics(gw):
    code, health = get_json(HOST, gw.port, "/v1/health")
    assert code == 200 and health["status"] == "ok"
    assert health["serving_thread_alive"] is True
    code, ready = get_json(HOST, gw.port, "/v1/ready")
    assert code == 200 and ready == {"ready": True, "reasons": [],
                                     "queue_depth": 0,
                                     "queue_capacity": 16}
    code, stats = get_json(HOST, gw.port, "/v1/stats")
    assert code == 200 and stats["buckets"] == [1, 2]
    assert stats["warm_compiles"] == 6 == stats["compile_count"]
    assert stats["draining"] is False
    assert set(stats["bucket_costs"]) == {"any/B1", "any/B2"}
    code, ctype, text = get_text(HOST, gw.port, "/v1/metrics")
    assert code == 200 and ctype.startswith("text/plain; version=0.0.4")
    parsed = parse_exposition(text)
    assert parsed["types"]["jaxstream_segments_total"] == "counter"
    assert parsed["types"]["jaxstream_request_latency_seconds"] == \
        "histogram"
    conn = http.client.HTTPConnection(HOST, gw.port, timeout=10)
    conn.request("GET", "/v1/nowhere")
    assert conn.getresponse().status == 404
    conn.close()
    conn = http.client.HTTPConnection(HOST, gw.port, timeout=10)
    conn.request("GET", "/v1/requests")
    assert conn.getresponse().status == 405
    conn.close()


def test_http_stream_equals_direct_and_websocket(gw):
    """Gateway stream == a direct ``EnsembleServer`` submission on
    ``canonical()`` events (fields as raw bytes: bitwise), and the
    WebSocket stream == the HTTP one."""
    status, events = submit_streaming(HOST, gw.port, _body("parity"))
    assert status == 200
    assert events[0] == protocol.accepted_event("parity")
    segs = [ev for ev in events if ev["event"] == "segment"]
    assert [s["steps_done"] for s in segs] == [2, 4, 5]
    assert events[-1]["event"] == "result"

    direct_segs = []
    srv = EnsembleServer(_cfg(), device="cpu",
                         on_segment=lambda evs: direct_segs.extend(evs))
    srv.submit(ScenarioRequest.from_dict(_body("parity")))
    srv.serve()
    srv.close()
    direct = srv.results["parity"]
    assert ([protocol.canonical(e) for e in segs]
            == [protocol.canonical(protocol.segment_event(e))
                for e in direct_segs])
    assert (protocol.canonical(events[-1])
            == protocol.canonical(protocol.result_event(direct)))

    ws_events = submit_websocket(HOST, gw.port, _body("parity-ws"))
    assert ws_events[0] == protocol.accepted_event("parity-ws")
    assert [e["event"] for e in ws_events] == [e["event"] for e in events]
    assert ws_events[-1]["fields"] == events[-1]["fields"]
    a, b = final_result(ws_events), final_result(events)
    for k in ("h", "u"):
        assert a.fields[k].tobytes() == b.fields[k].tobytes()
        assert b.fields[k].tobytes() == direct.fields[k].tobytes()
    assert gw.stats["ws_connections"] >= 1
    # A refused WebSocket submission is one typed error event.
    bad = submit_websocket(HOST, gw.port, {"id": "w", "ic": "tc9",
                                           "nsteps": 1})
    assert len(bad) == 1 and bad[0]["error"] == "bad_request"


def test_bad_request_and_duplicate_id(gw):
    for body in ({"id": "bad", "ic": "tc9", "nsteps": 1},
                 {"id": "bad2", "ic": "tc2", "nsteps": 1, "color": "red"},
                 {"id": "bad3", "ic": "tc2", "nsteps": "5"}):
        with pytest.raises(GatewayError) as ei:
            submit_streaming(HOST, gw.port, body)
        assert ei.value.status == 400 and ei.value.error == "bad_request"
    conn = http.client.HTTPConnection(HOST, gw.port, timeout=10)
    conn.request("POST", "/v1/requests", body="{nope")
    resp = conn.getresponse()
    assert resp.status == 400
    assert json.loads(resp.read())["message"].startswith(
        "body is not JSON")
    conn.close()

    first_seg = threading.Event()
    done = {}

    def long_request():
        done["out"] = submit_streaming(
            HOST, gw.port, _body("dup", ic="tc2", nsteps=30),
            on_event=lambda ev: (ev["event"] == "segment"
                                 and first_seg.set()))

    th = threading.Thread(target=long_request, daemon=True)
    th.start()
    assert first_seg.wait(60), "no segment event within 60s"
    with pytest.raises(GatewayError) as ei:
        submit_streaming(HOST, gw.port, _body("dup", ic="tc2", nsteps=1))
    assert ei.value.status == 409 and ei.value.error == "duplicate_id"
    th.join(60)
    assert not th.is_alive()
    assert done["out"][1][-1]["summary"]["steps_run"] == 30


def test_span_trees_complete_across_the_gateway(gw):
    """Every request the gateway completed reassembles into a complete
    span tree from the serve and gateway sinks (coverage 1.0), gateway
    ingress/egress spans included."""
    submit_streaming(HOST, gw.port, _body("spans", ic="tc6", nsteps=3))
    gw.server._writer.flush()
    recs = (read_records(str(gw.tmp / "serve.jsonl"), kind="span")
            + read_records(str(gw.tmp / "gateway.jsonl"), kind="span"))
    done = {r.id: r.latency_s for r in gw.server.results.values()}
    cov = obs_trace.span_coverage(recs, done)
    assert cov["checked"] == len(done) >= 1
    assert cov["spans_complete"] == 1.0, cov["failures"]
    names = {r["name"] for r in recs if r["id"] == "spans"}
    assert {obs_trace.GATEWAY_INGRESS, obs_trace.GATEWAY_EGRESS,
            obs_trace.SEGMENT, obs_trace.QUEUE_WAIT} <= names
    gws = read_records(str(gw.tmp / "gateway.jsonl"), kind="gateway")
    assert any(r["id"] == "spans" and r["status"] == "ok" for r in gws)
    code, out = run_script("telemetry_report.py",
                           str(gw.tmp / "gateway.jsonl"), "--json")
    assert code == 0 and json.loads(out)["gateway"]["completed"] >= 1


class _Capture:
    """Stands in for ``torch.profiler.profile`` (a real one costs seconds
    of CUPTI/Kineto start-up): records the thread of each call and
    writes a trace file."""

    calls = []

    def __init__(self, activities):
        self.activities = activities

    def start(self):
        _Capture.calls.append(("start", threading.current_thread().name))

    def stop(self):
        _Capture.calls.append(("stop", threading.current_thread().name))

    def export_chrome_trace(self, path):
        with open(path, "w") as fh:
            json.dump({"traceEvents": [{"name": obs_trace.SEGMENT}]}, fh)


def test_profile_endpoint_typed_contract(gw, monkeypatch):
    """400/409/501 as the JAX contract; start and stop run on the serving
    thread (the profiler records the thread that starts it), and the
    stop writes the trace file it names."""
    import torch

    from jaxstream_torch.gateway.gateway import GATEWAY_SERVE_THREAD_NAME

    monkeypatch.setattr(torch.profiler, "profile", _Capture)
    _Capture.calls.clear()
    st, body = post_json(HOST, gw.port, "/v1/profile", {"action": "bogus"})
    assert st == 400
    st, body = post_json(HOST, gw.port, "/v1/profile", {"action": "stop"})
    assert st == 409 and body["error"] == "profile_conflict"
    st, body = post_json(HOST, gw.port, "/v1/profile", {"action": "start"})
    assert st == 200 and body["profiling"] is True
    st, body = post_json(HOST, gw.port, "/v1/profile", {"action": "start"})
    assert st == 409
    submit_streaming(HOST, gw.port, _body("profiled", ic="tc2", nsteps=2))
    st, body = post_json(HOST, gw.port, "/v1/profile", {"action": "stop"})
    assert st == 200 and body["profiling"] is False
    assert _Capture.calls == [("start", GATEWAY_SERVE_THREAD_NAME),
                              ("stop", GATEWAY_SERVE_THREAD_NAME)]
    with open(body["trace"]) as fh:
        assert json.load(fh)["traceEvents"][0]["name"] == obs_trace.SEGMENT
    plain = _gateway(_cfg(), warm=False)
    plain.start()
    try:
        st, body = post_json(HOST, plain.port, "/v1/profile",
                             {"action": "start"})
        assert st == 501 and body["error"] == "profiler_unavailable"
    finally:
        plain.close(drain=False)


def test_masked_segment_is_a_profiler_region():
    """The segment runs inside ``record_function("serve.segment")``."""
    import torch

    from jaxstream_torch.stepping import integrate_masked

    seen = []
    real = torch.profiler.record_function

    class Spy(real):
        def __init__(self, name, *a, **kw):
            seen.append(name)
            super().__init__(name, *a, **kw)

    old = torch.profiler.record_function
    torch.profiler.record_function = Spy
    try:
        integrate_masked(lambda y, t: {"x": y["x"] + 1.0},
                         {"x": torch.zeros(2)}, 0.0,
                         torch.tensor([1, 2], dtype=torch.int32), 2, DT,
                         {"x": 0})
    finally:
        torch.profiler.record_function = old
    assert seen == [obs_trace.SEGMENT]


# ------------------------------------------------------ overload and drain
def _post_only(port, body):
    """One admission: the status and the first event line."""
    conn = http.client.HTTPConnection(HOST, port, timeout=30)
    try:
        conn.request("POST", "/v1/requests", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            return resp.status, json.loads(resp.read())
        return resp.status, json.loads(resp.readline())
    finally:
        conn.close()


def test_typed_backpressure_429_and_503():
    g = _gateway(_cfg(serve={"queue_capacity": 2, "max_guard_events": 1}),
                 warm=False)
    g.start(serve=False)
    try:
        s1, ev1 = _post_only(g.port, _body("q0", ic="tc2", nsteps=1))
        s2, _ = _post_only(g.port, _body("q1", ic="tc2", nsteps=1))
        assert (s1, s2) == (200, 200)
        assert ev1 == protocol.accepted_event("q0")
        s3, ev3 = _post_only(g.port, _body("q2", ic="tc2", nsteps=1))
        assert s3 == 429 and ev3["error"] == "queue_full"
        code, ready = get_json(HOST, g.port, "/v1/ready")
        assert code == 503 and "queue_full" in ready["reasons"]
        g.server.monitor.events.append({"kind": "guard", "event": "nan"})
        s4, ev4 = _post_only(g.port, _body("q3", ic="tc2", nsteps=1))
        assert s4 == 503 and ev4["error"] == "admission_refused"
        g.begin_drain()
        s5, ev5 = _post_only(g.port, _body("q4", ic="tc2", nsteps=1))
        assert s5 == 503 and ev5["error"] == "draining"
        assert (g.stats["shed_queue_full"], g.stats["shed_admission"],
                g.stats["shed_draining"]) == (1, 1, 1)
        parsed = parse_exposition(g.metrics.render())
        shed = parsed["samples"]["jaxstream_requests_shed_total"]
        assert shed['status="shed_queue_full"'] == 1
    finally:
        g.close(drain=False)


def test_dead_serving_loop_refuses_typed_503():
    g = _gateway(_cfg(), warm=False)
    g.server.serve_forever = lambda **kw: (_ for _ in ()).throw(
        RuntimeError("injected serving-loop death"))
    g.start()
    try:
        g._serve_thread.join(30)
        assert not g._serve_thread.is_alive()
        code, health = get_json(HOST, g.port, "/v1/health")
        assert code == 503 and health["serving_thread_alive"] is False
        with pytest.raises(GatewayError) as ei:
            submit_streaming(HOST, g.port, _body("doomed", ic="tc2",
                                                 nsteps=1))
        assert (ei.value.status, ei.value.error) == (503,
                                                     "admission_refused")
    finally:
        g.close(drain=False)


def test_graceful_drain_with_request_mid_flight(tmp_path):
    sink = str(tmp_path / "gw_drain.jsonl")
    g = _gateway(_cfg(serve={"buckets": "1"}), sink=sink)
    g.start()
    first_seg = threading.Event()
    done = {}

    def long_request():
        done["out"] = submit_streaming(
            HOST, g.port, _body("inflight", ic="tc2", nsteps=30),
            on_event=lambda ev: (ev["event"] == "segment"
                                 and first_seg.set()))

    th = threading.Thread(target=long_request, daemon=True)
    th.start()
    assert first_seg.wait(60), "no segment event within 60s"
    g.begin_drain()
    with pytest.raises(GatewayError) as ei:
        submit_streaming(HOST, g.port, _body("late", ic="tc2", nsteps=1))
    assert ei.value.status == 503 and ei.value.error == "draining"
    g.drain()
    th.join(60)
    res = final_result(done["out"][1])
    assert res.status == "ok" and res.steps_run == 30
    assert len(g.server.queue) == 0
    g.close()
    by_id = {r["id"]: r for r in read_records(sink, kind="gateway")}
    assert by_id["inflight"]["status"] == "ok"
    assert by_id["late"]["status"] == "shed_draining"


def test_loopback_only_and_default_device(monkeypatch):
    with pytest.raises(ValueError, match="loopback"):
        Gateway(_cfg(), host="192.0.2.1", device="cpu", warm=False)
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Gateway(_cfg(), warm=False)
