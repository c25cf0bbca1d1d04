"""Port: the load harness and autoscaling (``jaxstream_torch.loadgen``,
queue A item 3, A6).

* Against the JAX package: ``generate_trace`` (the entries and the
  written file's bytes), the autoscale policy's decisions over
  observation streams and its refusals, ``summarize_outcomes`` and
  ``masked_records`` give the JAX modules' output.
* The closed loop over a port gateway at C8 on the CPU, loopback only:
  a heavy-tailed mixed-family burst through the HTTP gateway with live
  autoscaling between the warm buckets {1, 2}: every request completed
  (typed sheds would count too), at least one resize, no build after
  warm-up, span coverage 1.0; two runs of one trace byte-equal in the
  loadgen sink once wall-clock fields are masked.
"""

import json
import logging

import numpy as np
import pytest

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

from jaxstream.loadgen import autoscale as jautoscale
from jaxstream.loadgen import harness as jharness
from jaxstream.loadgen import trace as jtrace

from jaxstream_torch.gateway import Gateway
from jaxstream_torch.loadgen import (AutoscaleController, AutoscalePolicy,
                                     AutoscaleState, decide, generate_trace,
                                     masked_records, read_trace, run_load,
                                     summarize_outcomes, write_trace)
from jaxstream_torch.obs.sink import read_records

N, DT = 8, 600.0
HOST = "127.0.0.1"


@pytest.fixture(autouse=True)
def _quiet_logs():
    lg = logging.getLogger("jaxstream_torch")
    level = lg.level
    lg.setLevel(logging.ERROR)
    yield
    lg.setLevel(level)


# ------------------------------------------------------------ pure modules
@pytest.mark.parametrize("kw", [
    dict(n_requests=40, seed=7, mean_gap_s=0.5, tail_alpha=1.4),
    dict(n_requests=25, seed=1404, mean_gap_s=0.02, tail_alpha=1.4,
         lengths=(16, 25, 8, 43)),
    dict(n_requests=10, seed=3, mean_gap_s=1.0, tail_alpha=0.8,
         family_weights={"tc5": 1.0, "galewsky": 2.0}, id_prefix="z"),
])
def test_generate_trace_bytes_match_jax(kw, tmp_path):
    a = generate_trace(**kw)
    b = jtrace.generate_trace(**kw)
    assert a == b
    pa, pb = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    write_trace(str(pa), a)
    jtrace.write_trace(str(pb), b)
    assert pa.read_bytes() == pb.read_bytes()
    assert read_trace(str(pa)) == jtrace.read_trace(str(pb)) == a


@pytest.mark.parametrize("kw", [dict(n_requests=0, seed=0),
                                dict(n_requests=1, seed=0, tail_alpha=0.0),
                                dict(n_requests=1, seed=0, lengths=())])
def test_trace_refusals_match_jax(kw):
    with pytest.raises(ValueError) as et:
        generate_trace(**kw)
    with pytest.raises(ValueError) as ej:
        jtrace.generate_trace(**kw)
    assert str(et.value) == str(ej.value)


_OBS = {
    "up": [(8, 1.0)] * 3,
    "alternating": [(8, 1.0), (0, 0.1)] * 10,
    "cooldown": [(8, 1.0)] * 2 + [(0, 0.1)] * 6,
    "mid_band": [(2, 0.8)] * 10,
    "random": [(int(q), float(o)) for q, o in zip(
        np.random.default_rng(5).integers(0, 9, 60),
        np.random.default_rng(6).random(60))],
}


@pytest.mark.parametrize("name", sorted(_OBS))
@pytest.mark.parametrize("level", [0, 2])
def test_autoscale_decisions_match_jax(name, level):
    kw = dict(levels=(1, 4, 16), queue_high=4, queue_low=0, occ_low=0.5,
              patience=2, cooldown=2)
    pol, jpol = AutoscalePolicy(**kw), jautoscale.AutoscalePolicy(**kw)
    st = AutoscaleState(level=level)
    jst = jautoscale.AutoscaleState(level=level)
    for q, occ in _OBS[name]:
        st, t = decide(pol, st, q, occ)
        jst, jt = jautoscale.decide(jpol, jst, q, occ)
        assert t == jt
        assert st.__dict__ == jst.__dict__


@pytest.mark.parametrize("kw", [dict(levels=(4, 1)),
                                dict(levels=(1, 2), queue_high=2,
                                     queue_low=2),
                                dict(levels=(1, 2), patience=0)])
def test_autoscale_policy_refusals_match_jax(kw):
    with pytest.raises(ValueError) as et:
        AutoscalePolicy(**kw)
    with pytest.raises(ValueError) as ej:
        jautoscale.AutoscalePolicy(**kw)
    assert str(et.value) == str(ej.value)


def test_summaries_and_masked_records_match_jax(tmp_path):
    outcomes = [
        {"id": "a", "status": "ok", "latency_s": 0.5, "steps_run": 4},
        {"id": "b", "status": "ok", "latency_s": 1.5, "steps_run": 8},
        {"id": "c", "status": "shed_queue_full", "latency_s": 0.01,
         "steps_run": 0},
        {"id": "d", "status": "evicted", "latency_s": 0.7,
         "steps_run": 2},
        {"id": "e", "status": "error", "latency_s": 0.1, "steps_run": 0},
    ]
    assert summarize_outcomes(outcomes, 2.0, dt=DT) == \
        jharness.summarize_outcomes(outcomes, 2.0, dt=DT)
    sink = tmp_path / "lg.jsonl"
    man = {"kind": "manifest", "schema_version": 1, "created_unix": 0,
           "metric_names": [], "interval": 0, "guards": "off",
           "config": {}, "devices": {}}
    with open(sink, "w") as fh:
        fh.write(json.dumps(man) + "\n")
        for o in outcomes:
            fh.write(json.dumps(dict(o, kind="loadgen", ic="tc2",
                                     nsteps=4, dispatched_at_s=0.3))
                     + "\n")
    assert masked_records(str(sink)) == jharness.masked_records(str(sink))


# --------------------------------------------------------- the closed loop
@pytest.fixture(scope="module")
def load_gateway(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_loadgen")
    cfg = {"grid": {"n": N}, "time": {"dt": DT},
           "model": {"name": "shallow_water_cov", "backend": "jnp"},
           "parallelization": {"num_devices": 1},
           "serve": {"buckets": "1,2", "segment_steps": 2,
                     "queue_capacity": 64, "trace": True,
                     "sink": str(d / "serve.jsonl")}}
    ctrl = AutoscaleController(AutoscalePolicy(
        levels=(1, 2), queue_high=3, queue_low=0, occ_low=0.6,
        patience=2, cooldown=2))
    g = Gateway(cfg, host=HOST, port=0, autoscale=ctrl, device="cpu",
                sink=str(d / "gateway.jsonl"))
    g.start()
    g.tmp = d
    yield g, ctrl
    g.close()


def test_closed_loop_burst_with_autoscale(load_gateway):
    gw, ctrl = load_gateway
    trace = generate_trace(16, seed=14, mean_gap_s=0.002,
                           tail_alpha=1.4, lengths=(1, 2, 3, 5))
    assert {e["ic"] for e in trace} >= {"tc2", "tc5"}
    sink = str(gw.tmp / "load.jsonl")
    summary = run_load(HOST, gw.port, trace, time_scale=1.0,
                       max_workers=8, sink=sink, dt=DT,
                       trace_spans=True,
                       span_sinks=[str(gw.tmp / "serve.jsonl"),
                                   str(gw.tmp / "gateway.jsonl")])
    assert summary["accounting_exact"] is True, summary
    assert summary["errors"] == 0
    assert summary["completed"] == 16
    assert summary["goodput_member_steps"] == sum(e["nsteps"]
                                                  for e in trace)
    assert 0 < summary["latency_p50_s"] <= summary["latency_p99_s"]
    assert summary["spans_checked"] == 16
    assert summary["spans_complete"] == 1.0, summary["span_failures"]
    assert len(ctrl.events) >= 1, ctrl.summary()
    assert (ctrl.events[0]["from_bucket"], ctrl.events[0]["to_bucket"]) \
        == (1, 2)
    assert gw.server.compile_count() == gw.warm_compiles
    recs = read_records(sink, kind="loadgen")
    assert [r["id"] for r in recs] == [e["id"] for e in trace]
    assert all(r["trace_id"] for r in recs)
    autos = read_records(str(gw.tmp / "serve.jsonl"), kind="autoscale")
    assert autos[0]["reason"] == "autoscale_attach"
    assert any(r["reason"] == "autoscale" for r in autos)


def test_loadgen_sink_byte_determinism(load_gateway):
    gw, _ = load_gateway
    trace = generate_trace(4, seed=5, mean_gap_s=0.002, tail_alpha=1.5,
                           lengths=(1, 2, 3), id_prefix="det")
    paths = []
    for run in ("a", "b"):
        p = str(gw.tmp / f"det_{run}.jsonl")
        s = run_load(HOST, gw.port, trace, time_scale=0.0,
                     max_workers=4, sink=p, dt=DT)
        assert s["completed"] == 4, s
        paths.append(p)
    assert masked_records(paths[0]) == masked_records(paths[1])
    assert open(paths[0]).read() != open(paths[1]).read()
