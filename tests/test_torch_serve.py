"""Port: the continuous-batching ensemble server (``jaxstream_torch.
serve``), the masked segment, the plan rules it raises through, and its
telemetry (queue A item 3, A6).

Against the JAX package, at C8 on the CPU:

* one port ``EnsembleServer`` and one JAX ``EnsembleServer`` (backend
  ``jnp``, buckets ``1,2``) serve the same five mixed-family requests:
  the same packing (batches, segments, refills, member-steps), statuses
  and step counts, and fields within float32 roundoff (<= 1e-5 of max:
  the classic step of the two packages differs in the last bits, and
  each request runs a few steps);
* one masked segment of each server's warm B = 2 bucket on the same
  carry, with one member finishing mid-segment: within the same
  roundoff, and the frozen member bitwise its own one-step state in
  each package; ``integrate_masked`` over one stepper both packages run
  exactly, bitwise in float64;
* the pure modules give the JAX modules' outputs: request validation,
  queue order, placement plans, the rule table, plan keys, proof and
  cost stamps, the open-request manifest.

Port-only: every packed member bitwise its solo run (h and u) on the
mixed-orography (classic, per-member orography) and the grouped fused
(the stage kernels' plain versions) paths; B = 1 bitwise ``Simulation``
on both; eviction keeps the rest of the batch bitwise; ``halt`` puts
the popped refills back; ``compile_count`` does not move after warm-up
or across resizes; span trees complete; the sink read by
``scripts/telemetry_report.py``; the refusals; ``scripts/
torch_serve.py``.
"""

import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)
from torch_scripts import run_script

from jaxstream.obs import flight as jflight
from jaxstream.obs import perf as jperf
from jaxstream.plan import plan as jplan
from jaxstream.plan import proof as jproof
from jaxstream.plan import rules as jrules
from jaxstream.serve import EnsembleServer as JaxServer
from jaxstream.serve import placement as jplacement
from jaxstream.serve import queue as jqueue
from jaxstream.serve import request as jrequest
from jaxstream.stepping import integrate_masked as jax_integrate_masked

from jaxstream_torch import _build
from jaxstream_torch.obs import flight, perf
from jaxstream_torch.obs.monitor import HealthError
from jaxstream_torch.obs.sink import read_records
from jaxstream_torch.obs.trace import tree_complete
from jaxstream_torch.plan import plan as tplan
from jaxstream_torch.plan import proof as tproof
from jaxstream_torch.plan import rules as trules
from jaxstream_torch.serve import (AdmissionRefused, EnsembleServer,
                                   HeadroomRefused, ScenarioRequest,
                                   placement, queue, request)
from jaxstream_torch.simulation import Simulation
from jaxstream_torch.stepping import integrate_masked

N, DT = 8, 600.0
FAMILIES = ("tc2", "tc5", "tc6", "galewsky", "tc5")
LENGTHS = (3, 5, 2, 4, 1)
#: float32 roundoff over a few classic steps, relative to max.
F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def _quiet_logs():
    lgs = [logging.getLogger(n) for n in ("jaxstream_torch", "jaxstream")]
    levels = [lg.level for lg in lgs]
    for lg in lgs:
        lg.setLevel(logging.ERROR)
    yield
    for lg, lv in zip(lgs, levels):
        lg.setLevel(lv)


def _cfg(**over):
    cfg = {
        "grid": {"n": N},
        "time": {"dt": DT},
        "model": {"name": "shallow_water_cov", "backend": "jnp"},
        "parallelization": {"num_devices": 1},
        "serve": {"buckets": "1,2", "segment_steps": 2,
                  "queue_capacity": 8},
    }
    for k, v in over.items():
        cfg.setdefault(k, {}).update(v)
    return cfg


def _server(cfg, **kw):
    return EnsembleServer(cfg, device="cpu", **kw)


def _reqs(cls):
    return [cls(id=f"r{i}", ic=FAMILIES[i], nsteps=ns, seed=i,
                amplitude=1e-3, outputs=("h", "u"))
            for i, ns in enumerate(LENGTHS)]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def served_pair():
    """The same five requests through the port and the JAX server."""
    port = _server(_cfg())
    for r in _reqs(ScenarioRequest):
        port.submit(r)
    port.serve()
    port.close()
    jax_srv = JaxServer(_cfg())
    for r in _reqs(jrequest.ScenarioRequest):
        jax_srv.submit(r)
    jax_srv.serve()
    jax_srv.close()
    return port, jax_srv


# --------------------------------------------------- against the JAX server
def test_server_results_agree_with_jax_server(served_pair):
    port, jax_srv = served_pair
    for k in ("batches", "segments", "refills", "member_steps",
              "completed", "evicted", "submitted", "occupancy_sum",
              "utilization_sum"):
        assert port.stats[k] == jax_srv.stats[k], k
    assert set(port.results) == set(jax_srv.results)
    for rid, a in port.results.items():
        b = jax_srv.results[rid]
        assert (a.status, a.steps_run, a.t_final, a.nsteps) == (
            b.status, b.steps_run, b.t_final, b.nsteps)
        for k in ("h", "u"):
            assert a.fields[k].dtype == np.float32
            assert _rel(a.fields[k], b.fields[k]) <= F32_TOL, (rid, k)
    assert port.bucket_proofs() == jax_srv.bucket_proofs()
    costs_p = port.bucket_costs()["any/B2"]
    costs_j = jax_srv.bucket_costs()["any/B2"]
    assert costs_p["analytic"] == costs_j["analytic"]
    assert costs_p["plan_key"] == costs_j["plan_key"]


def test_masked_segment_matches_jax_segment(served_pair):
    """One masked segment of each warm B = 2 bucket (the classic stepper
    with per-member orography), member 0 finishing after one of its two
    steps: float32 roundoff apart, and member 0 bitwise its one-step
    state in each package."""
    port, jax_srv = served_pair
    pb, jb = port._buckets[("any", 2)], jax_srv._buckets[("any", 2)]
    reqs = _reqs(ScenarioRequest)[:2]
    trees = [port._member_tree(r) for r in reqs]
    carry = pb.stack(trees)

    def jcarry():          # the JAX segment donates its carry
        return {k: jnp.asarray(v.numpy()) for k, v in carry.items()}

    rem = np.array([1, 2])
    y, rem_p, nf = pb.seg({k: v.clone() for k, v in carry.items()},
                          pb.put_rem(rem))
    jy, rem_j, jnf = jb.seg(jcarry(), jb.put_rem(rem))
    assert rem_p.tolist() == np.asarray(rem_j).tolist() == [0, 0]
    assert nf.tolist() == np.asarray(jnf).tolist() == [0, 0]
    for k in ("h", "u", "b"):
        assert _rel(y[k].numpy(), jy[k]) <= F32_TOL, k
    one, _, _ = pb.seg({k: v.clone() for k, v in carry.items()},
                       pb.put_rem(np.array([1, 1])))
    jone, _, _ = jb.seg(jcarry(), jb.put_rem(np.array([1, 1])))
    assert torch.equal(y["h"][0], one["h"][0])
    assert torch.equal(y["u"][:, 0], one["u"][:, 0])
    np.testing.assert_array_equal(np.asarray(jy["h"][0]),
                                  np.asarray(jone["h"][0]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_integrate_masked_bitwise_jax_loop(dtype):
    """The masked loop itself over a step both packages compute exactly:
    frozen members, the remaining counts and the time carry bitwise."""
    np_dtype = {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    y0 = np.linspace(-1.0, 1.0, 4 * 3 * 5).reshape(4, 3, 5).astype(np_dtype)
    z0 = np.arange(2 * 4 * 3, dtype=np_dtype).reshape(2, 4, 3)
    rem0 = np.array([2, 5, 0, 3], np.int32)

    def tstep(y, t):
        return {"y": y["y"] * 0.5 + 1.0, "z": y["z"] * 2.0 - 3.0}

    def jstep(y, t):
        return {"y": y["y"] * 0.5 + 1.0, "z": y["z"] * 2.0 - 3.0}

    axes = {"y": 0, "z": 1}
    y, t, rem = integrate_masked(
        tstep, {"y": torch.from_numpy(y0), "z": torch.from_numpy(z0)},
        0.0, torch.from_numpy(rem0), 4, DT, axes)
    jy, jt, jrem = jax_integrate_masked(
        jstep, {"y": jnp.asarray(y0), "z": jnp.asarray(z0)}, 0.0,
        jnp.asarray(rem0), 4, DT, axes)
    for k in axes:
        assert y[k].numpy().tobytes() == np.asarray(jy[k]).tobytes(), k
    assert rem.tolist() == np.asarray(jrem).tolist() == [0, 1, 0, 0]
    assert float(t) == float(jt) == 4 * DT
    # Member 2 (rem 0) never advanced; member 0 froze after two steps.
    assert y["y"][2].numpy().tobytes() == y0[2].tobytes()
    two = y0[0] * 0.5 + 1.0
    two = two * 0.5 + 1.0
    assert y["y"][0].numpy().tobytes() == two.astype(np_dtype).tobytes()


# ------------------------------------------------------------ pure modules
_BAD_REQUESTS = [
    {"id": "x", "ic": "tc9", "nsteps": 1},
    {"id": "x", "ic": "tc2", "nsteps": 0},
    {"id": "x", "ic": "tc2", "nsteps": 1, "outputs": ("zeta",)},
    {"id": "x", "ic": "tc2", "nsteps": "5"},
    {"id": "x", "ic": "tc2", "nsteps": 1, "amplitude": True},
    {"id": "x", "ic": "array", "nsteps": 1},
    {"id": "x", "ic": "array", "nsteps": 1, "seed": 3,
     "state": {"h": np.zeros(1), "u": np.zeros(1)}},
    {"id": "x", "ic": "tc2", "nsteps": 1, "state": {}},
]


@pytest.mark.parametrize("kw", _BAD_REQUESTS)
def test_request_validation_matches_jax(kw):
    with pytest.raises(ValueError) as et:
        ScenarioRequest(**kw)
    with pytest.raises(ValueError) as ej:
        jrequest.ScenarioRequest(**kw)
    assert str(et.value) == str(ej.value)


def test_request_queue_order_matches_jax():
    """Group FIFO, remove, requeue and snapshot: the same order."""
    def drive(mod_q, mod_r):
        q = mod_q.RequestQueue(4)
        rs = [mod_r.ScenarioRequest(id=f"r{i}", ic=ic, nsteps=1)
              for i, ic in enumerate(["tc2", "tc5", "tc6", "tc5", "tc2"])]
        out = []
        for r in rs[:4]:
            q.submit(r)
        try:
            q.submit(rs[4])
        except mod_q.QueueFull as e:
            out.append(str(e))
        out.append(q.pop("flat").id)
        out.append(q.pop_group("oro").id)
        q.requeue([rs[0], rs[4]])
        out.append(q.snapshot())
        out.append(q.remove(rs[3]))
        out.append(q.remove(rs[3]))
        out.append([q.pop().id for _ in range(len(q))])
        out.append(q.pop())
        return out

    assert drive(queue, request) == drive(jqueue, jrequest)


@pytest.mark.parametrize("mode", ["off", "member", "panel"])
def test_placement_plans_match_jax(mode):
    for devs in (1, 4, 6, 8, 12):
        try:
            want = jplacement.plan_placement((1, 2, 4, 16), devs, mode)
        except ValueError as e:
            with pytest.raises(ValueError, match="multiple of 6"):
                placement.plan_placement((1, 2, 4, 16), devs, mode)
            assert "multiple of 6" in str(e)
            continue
        got = placement.plan_placement((1, 2, 4, 16), devs, mode)
        assert {b: p.__dict__ for b, p in got.items()} == \
            {b: p.__dict__ for b, p in want.items()}
        for b in got:
            assert placement.plan_exchange_bytes_per_step(
                got[b], 384, 2) == jplacement.plan_exchange_bytes_per_step(
                want[b], 384, 2)
    assert placement.placement_report((1, 4, 16), 12, 384, 2) == \
        jplacement.placement_report((1, 4, 16), 12, 384, 2)
    plan = placement.plan_bucket(4, 1, mode).with_headroom(3e9, 8e10)
    assert plan.headroom_frac == jplacement.plan_bucket(
        4, 1, mode).with_headroom(3e9, 8e10).headroom_frac


def test_rule_table_matches_jax():
    """The table verbatim: names, kinds, clause fields and pointer texts,
    the version, and the enumerated plan space's keys."""
    assert trules.RULES_VERSION == jrules.RULES_VERSION
    assert len(trules.RULES) == len(jrules.RULES)
    for a, b in zip(trules.RULES, jrules.RULES):
        assert (a.name, a.kind, a.pointer) == (b.name, b.kind, b.pointer)
        assert [f for f, _ in a.when] == [f for f, _ in b.when]
        assert [f for f, _ in a.then] == [f for f, _ in b.then]
    assert trules.DEFAULT_AXES == jrules.DEFAULT_AXES
    assert [p.key() for p in trules.enumerate_plans()] == \
        [p.key() for p in jrules.enumerate_plans()]
    assert trules.plan_space_keys() == jrules.plan_space_keys()
    for r in jrules.RULES:
        with pytest.raises(jrules.PlanError) as ej:
            jrules.fail(r.name)
        with pytest.raises(trules.PlanError) as et:
            trules.fail(r.name)
        assert str(et.value) == str(ej.value)


_PLAN_CONFIGS = [
    ({"model": {"name": "shallow_water_cov", "backend": "pallas"},
      "parallelization": {"num_devices": 1}}, False),
    ({"model": {"name": "shallow_water_cov"}, "ensemble": {"members": 4},
      "parallelization": {"num_devices": 1}}, False),
    ({"model": {"name": "shallow_water_cov", "backend": "pallas"},
      "serve": {"group_by_orography": True, "buckets": "1,4,16"}}, True),
    ({"model": {"name": "shallow_water_cov"},
      "serve": {"buckets": "1,2"}}, True),
    ({"model": {"name": "shallow_water_cov"},
      "parallelization": {"num_devices": 6, "use_shard_map": True,
                          "overlap_exchange": True}}, False),
    ({"model": {"name": "shallow_water_cov", "backend": "pallas"},
      "physics": {"hyperdiffusion": 1e14},
      "parallelization": {"num_devices": 1, "temporal_block": 2}}, False),
    ({"model": {"name": "auto"}, "serve": {"buckets": "4"}}, True),
    ({"model": {"name": "shallow_water_cov"},
      "precision": {"stage": "bf16"}}, True),
]


@pytest.mark.parametrize("cfg, serving", _PLAN_CONFIGS)
def test_plan_for_keys_and_proofs_match_jax(cfg, serving):
    try:
        want = jplan.plan_for(cfg, serving=serving)
    except ValueError as e:
        with pytest.raises(ValueError) as et:
            tplan.plan_for(cfg, serving=serving)
        assert str(et.value) == str(e)
        return
    got = tplan.plan_for(cfg, serving=serving)
    assert got.describe() == want.describe()
    assert got.class_key() == want.class_key()
    assert tproof.build_proof(got).to_json() == \
        jproof.build_proof(want).to_json()
    assert perf.build_cost(got, got.key()).to_json() == \
        jperf.build_cost(want, want.key()).to_json()


def test_open_request_manifest_and_headroom_match_jax():
    q, f = ["a", "b"], ["c"]
    assert flight.open_request_manifest(q, f) == \
        jflight.open_request_manifest(q, f)
    for fp, lim in ((3e9, 8e10), (None, 8e10), (9e10, 8e10)):
        assert perf.headroom_fraction(fp, lim) == \
            jperf.headroom_fraction(fp, lim)


# ------------------------------------------------------------ port-only
def _solo_classic(srv, req, b_family=None):
    """A request's solo run on the family's baked-static classic
    stepper."""
    from jaxstream_torch.models.shallow_water_cov import \
        CovariantShallowWater

    p = srv.config.physics
    b = srv._ic("tc5")[2] if req.ic == "tc5" else None
    model = CovariantShallowWater(srv.grid, gravity=p.gravity,
                                  omega=p.omega, b_ext=b)
    y = srv._request_state(req)
    step = model.make_step(DT, "ssprk3")
    for _ in range(req.nsteps):
        y = step(y, 0.0)
    return y


def test_mixed_batch_members_bitwise_solo(served_pair):
    """Every packed member of the mixed-orography batch (classic stepper,
    each member's own orography) is bitwise its baked-static solo run,
    h and u."""
    port, _ = served_pair
    for req in _reqs(ScenarioRequest):
        y = _solo_classic(port, req)
        res = port.results[req.id]
        for k in ("h", "u"):
            assert res.fields[k].tobytes() == y[k].numpy().tobytes(), \
                (req.id, k)


def _grouped_cfg(buckets):
    return _cfg(model={"backend": "pallas"},
                serve={"buckets": buckets, "group_by_orography": True,
                       "queue_capacity": 16})


def test_fused_bucket_members_bitwise_solo():
    """Grouped pallas buckets run the fused stepper (B1's member fold for
    B = 4, its plain version here): each member bitwise its solo fused
    run; tc5 and the flat families never share a batch."""
    srv = _server(_grouped_cfg("1,4"))
    lens = (3, 5, 2, 4, 1, 6)
    fams = ("tc5", "tc5", "tc2", "tc5", "tc6", "tc5")
    for i, (ic, ns) in enumerate(zip(fams, lens)):
        srv.submit(ScenarioRequest(id=f"g{i}", ic=ic, nsteps=ns, seed=i,
                                   outputs=("h", "u")))
    srv.serve()
    srv.close()
    assert set(srv.bucket_impls().values()) == {"fused"}
    assert srv.stats["batches"] >= 2
    for i, (ic, ns) in enumerate(zip(fams, lens)):
        req = ScenarioRequest(id="x", ic=ic, nsteps=ns, seed=i)
        m = srv._model(req.group)
        step = m.make_fused_step(DT)
        y = m.compact_state(srv._request_state(req))
        for _ in range(ns):
            y = step(y, 0.0)
        res = srv.results[f"g{i}"]
        assert res.status == "ok"
        for k in ("h", "u"):
            assert res.fields[k].tobytes() == y[k].numpy().tobytes(), \
                (i, k)


@pytest.mark.parametrize("backend, grouped", [("jnp", False),
                                              ("pallas", True)])
def test_b1_request_bitwise_vs_simulation(backend, grouped):
    """A request served alone through the B = 1 bucket is bitwise the
    unbatched ``Simulation`` of the same scenario (the classic path, and
    the compact fused path on the grouped pallas server)."""
    sim = Simulation({"grid": {"n": N}, "time": {"dt": DT, "nsteps": 5},
                      "model": {"name": "shallow_water_cov",
                                "initial_condition": "tc5",
                                "backend": backend},
                      "parallelization": {"num_devices": 1}},
                     device="cpu")
    sim.run()
    assert sim.stepper_kind == ("compact" if grouped else "classic")
    srv = _server(_cfg(model={"backend": backend},
                       serve={"buckets": "1",
                              "group_by_orography": grouped}))
    srv.submit(ScenarioRequest(id="solo", ic="tc5", nsteps=5, seed=-1,
                               outputs=("h", "u")))
    srv.serve()
    srv.close()
    res = srv.results["solo"]
    assert res.status == "ok" and res.t_final == 5 * DT
    assert srv.bucket_impls() == {
        ("oro/B1" if grouped else "any/B1"):
            ("fused" if grouped else "vmap_b")}
    for k in ("h", "u"):
        assert res.fields[k].tobytes() == sim.state[k].numpy().tobytes()


def test_eviction_keeps_the_batch_bitwise():
    """``fault_member`` marks one member's health stream bad: it alone is
    evicted, the rest stay bitwise their solo runs, and the guard events
    drive admission control."""
    srv = _server(_cfg(serve={"buckets": "2", "fault_member": 1,
                              "max_guard_events": 1},
                       observability={"fault_step": 2}))
    reqs = [ScenarioRequest(id=f"e{i}", ic="tc2", nsteps=ns, seed=i,
                            outputs=("h", "u"))
            for i, ns in enumerate((6, 6, 4))]
    for r in reqs:
        srv.submit(r)
    srv.serve()
    ev = srv.results["e1"]
    assert ev.status == "evicted" and ev.guard_event["member"] == 1
    assert ev.steps_run < 6 and ev.fields == {}
    for r in (reqs[0], reqs[2]):
        y = _solo_classic(srv, r)
        res = srv.results[r.id]
        assert res.status == "ok"
        for k in ("h", "u"):
            assert res.fields[k].tobytes() == y[k].numpy().tobytes()
    assert srv.stats["evicted"] == 1 and srv.stats["completed"] == 2
    assert srv.stats["refills"] >= 1
    with pytest.raises(AdmissionRefused):
        srv.submit(ScenarioRequest(id="late", ic="tc2", nsteps=1))
    assert srv.stats["refused"] == 1
    srv.close()


def test_halt_requeues_refills_and_bundle_names_them(tmp_path):
    """``guards: halt`` fires after the boundary popped a refill: it goes
    back to the queue head, and the crash bundle's open-request
    manifest names it (queued) and the resident members (in flight)."""
    fdir = str(tmp_path / "flight")
    srv = _server(_cfg(serve={"guards": "halt", "fault_member": 0},
                       observability={"fault_step": 2,
                                      "flight_dir": fdir}))
    srv.submit(ScenarioRequest(id="r0", ic="tc2", nsteps=6, seed=0))
    srv.submit(ScenarioRequest(id="r1", ic="tc2", nsteps=2, seed=1))
    srv.submit(ScenarioRequest(id="r2", ic="tc2", nsteps=2, seed=2))
    with pytest.raises(HealthError):
        srv.serve()
    assert "r2" not in srv.results
    assert srv.queue.snapshot() == ["r2"]
    manifest, _ = flight.read_bundle(flight.latest_bundle(fdir))
    assert manifest["reason"] == "HealthError"
    opened = manifest["open_requests"]
    assert [r["id"] for r in opened["queued"]] == ["r2"]
    assert sorted(r["id"] for r in opened["in_flight"]) == ["r0", "r1"]
    assert opened == flight.open_request_manifest(["r2"], ["r0", "r1"])
    assert srv.queue.pop().id == "r2"
    srv.close()


def test_compile_count_is_still_after_warmup_and_resize(monkeypatch):
    """Three callables per warm bucket, plus each kernel library first
    opened while the server exists: warm-up moves it, serving and
    resizes among warm buckets do not."""
    srv = _server(_cfg(serve={"buckets": "1,2"}))
    assert srv.compile_count() == 0
    warm = srv.warmup()
    assert warm == 6 == srv.stats["warmup_compiles"]
    srv.resize(1)
    for i in range(3):
        srv.submit(ScenarioRequest(id=f"c{i}", ic="tc6", nsteps=2 + i))
    srv.serve()
    srv.resize(2)
    srv.submit(ScenarioRequest(id="c9", ic="tc2", nsteps=3))
    srv.serve()
    assert srv.compile_count() == warm
    assert srv.stats["resizes"] == 2
    with pytest.raises(ValueError, match="not a configured"):
        srv.resize(4)
    # A library opened after warm-up is a build the count shows.
    monkeypatch.setitem(_build._loaded, "late_library", None)
    assert srv.compile_count() == warm + 1
    srv.close()


def test_resize_refused_below_min_headroom(tmp_path):
    sink = str(tmp_path / "serve.jsonl")
    srv = _server(_cfg(serve={"buckets": "1,2", "sink": sink,
                              "min_headroom_frac": 0.5}))
    srv.resize(1)
    srv._plans[2] = srv._plans[2].with_headroom(6e9, 8e9)
    with pytest.raises(HeadroomRefused, match="headroom 0.2500"):
        srv.resize(2)
    srv.close()
    heads = read_records(sink, kind="headroom")
    assert heads[0]["action"] == "resize_refused"
    assert heads[0]["bucket"] == 2


def test_traced_sink_spans_complete_and_report(tmp_path):
    """``serve.trace`` with a sink: every request's span tree is complete
    (leaves sum to its latency), the records are schema-valid, and the
    JAX package's stdlib ``scripts/telemetry_report.py`` renders them."""
    sink = str(tmp_path / "serve.jsonl")
    srv = _server(_cfg(serve={"sink": sink, "trace": True,
                              "cost_stamps": True,
                              "memory_watch": True}))
    for r in _reqs(ScenarioRequest):
        srv.submit(r)
    srv.serve()
    srv.close()
    recs = read_records(sink)
    assert recs[0]["config"]["trace"] is True
    spans = [r for r in recs if r["kind"] == "span"]
    for r in _reqs(ScenarioRequest):
        mine = [s for s in spans if s["id"] == r.id]
        ok, why = tree_complete(mine, srv.results[r.id].latency_s)
        assert ok, (r.id, why)
    serves = [r for r in recs if r["kind"] == "serve"]
    assert len(serves) == srv.stats["segments"]
    assert all(r["trace_ids"] for r in serves)
    perfs = [r for r in recs if r["kind"] == "perf"]
    assert perfs and "unavailable" in perfs[0]["memory"]
    assert "unavailable" in perfs[0]["xla"]
    mems = [r for r in recs if r["kind"] == "memory"]
    assert len(mems) == 1 and "unavailable" in mems[0]
    code, out = run_script("telemetry_report.py", sink, "--json")
    assert code == 0
    sv = json.loads(out)["serving"]
    assert sv["completed"] == len(LENGTHS)
    assert sv["segments"] == srv.stats["segments"]


def test_sinkless_trace_spans_complete():
    srv = _server(_cfg(serve={"trace": True}))
    srv.submit(ScenarioRequest(id="t0", ic="tc2", nsteps=3, seed=0))
    srv.serve()
    srv.close()
    ok, why = tree_complete(srv.trace_spans["t0"],
                            srv.results["t0"].latency_s)
    assert ok, why


_REFUSALS = [
    ({"serve": {"speculate": True}}, ValueError,
     r"serve\.speculate requires serve\.warm_pool"),
    ({"serve": {"placement": {"mode": "member"}}}, NotImplementedError,
     r"placement\.mode: member .*queue A item 4 \(A8\)"),
    ({"model": {"backend": "pallas"},
      "serve": {"placement": {"mode": "member"}}}, ValueError,
     r"model\.backend: jnp"),
    ({"serve": {"placement": {"mode": "panel"}}}, ValueError,
     r"group_by_orography"),
    ({"serve": {"group_by_orography": True,
                "placement": {"mode": "panel"}}}, NotImplementedError,
     r"placement\.mode: panel .*queue A item 4 \(A8\)"),
    ({"serve": {"guards": "retry"}}, ValueError, "guards"),
    ({"serve": {"buckets": "zero"}}, ValueError, "buckets"),
    ({"model": {"numerics": "tt"}}, ValueError, "dense"),
    ({"model": {"name": "auto"}}, ValueError, "shallow_water_cov"),
    ({"precision": {"stage": "bf16"}}, ValueError, "precision"),
    ({"parallelization": {"temporal_block": 4}}, ValueError,
     "temporal_block"),
]


@pytest.mark.parametrize("over, exc, match", _REFUSALS)
def test_server_refusals(over, exc, match):
    with pytest.raises(exc, match=match):
        _server(_cfg(**over))


def test_plan_refusal_texts_match_jax_server():
    cfg = _cfg(model={"name": "auto"})
    with pytest.raises(ValueError) as ej:
        JaxServer(cfg)
    with pytest.raises(ValueError) as et:
        _server(cfg)
    assert str(et.value) == str(ej.value)


def test_default_device_is_the_gpu(monkeypatch):
    """No device given: the GPU, and a machine without one raises rather
    than serving on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EnsembleServer(_cfg())


def test_memory_watcher_statless_reports_once_and_fake_stats():
    recs = []
    w = perf.MemoryWatcher(devices=[torch.device("cpu")],
                           sink_write=recs.append)
    assert w.poll()["unavailable"]
    assert w.poll() is None and len(recs) == 1
    stats = {"bytes_in_use": 10, "peak_bytes_in_use": 20,
             "bytes_limit": 100}
    w2 = perf.MemoryWatcher(devices=["a", "b"], stats_fn=lambda d: stats)
    rec = w2.poll()
    assert rec["bytes_in_use"] == [10, 10] and w2.limit_bytes() == 100
    assert perf.device_memory_record(
        devices=["a"], stats_fn=lambda d: stats)["peak_bytes"] == [20]


def test_torch_serve_script(tmp_path):
    cfg_path = tmp_path / "serve.yaml"
    cfg_path.write_text(
        f"grid:\n  n: {N}\ntime:\n  dt: {DT}\nmodel:\n"
        "  name: shallow_water_cov\n  backend: jnp\nserve:\n"
        "  buckets: \"1,2\"\n  segment_steps: 2\n  queue_capacity: 2\n")
    trace = tmp_path / "trace.jsonl"
    trace.write_text("".join(
        json.dumps({"id": f"q{i}", "ic": FAMILIES[i], "nsteps": ns,
                    "seed": i}) + "\n"
        for i, ns in enumerate(LENGTHS)))
    code, out = run_script("torch_serve.py", str(cfg_path), "--requests",
                           str(trace), "--device", "cpu")
    assert code == 0
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 1
    summary = json.loads(lines[0])
    assert summary["completed"] == len(LENGTHS)
    assert summary["member_steps"] == sum(LENGTHS)
    assert summary["steady_recompiles"] == 0
    assert summary["device"] == "cpu"
    assert set(summary["requests"].values()) == {"ok"}
    assert summary["bucket_impls"]


def test_array_ic_request_continues_bytewise():
    """An ``ic: 'array'`` request carrying a served state continues
    bitwise: 2 + 3 steps through two requests equal 5 in one."""
    srv = _server(_cfg(serve={"buckets": "1"}))
    srv.submit(ScenarioRequest(id="a", ic="tc2", nsteps=2, seed=4,
                               outputs=("h", "u")))
    srv.serve()
    st = dict(srv.results["a"].fields)
    srv.submit(ScenarioRequest(id="b", ic="array", nsteps=3,
                               state=st, outputs=("h", "u")))
    srv.submit(ScenarioRequest(id="c", ic="tc2", nsteps=5, seed=4,
                               outputs=("h", "u")))
    srv.serve()
    for k in ("h", "u"):
        assert srv.results["b"].fields[k].tobytes() == \
            srv.results["c"].fields[k].tobytes()
    with pytest.raises(ValueError, match="shape"):
        srv.submit(ScenarioRequest(
            id="bad", ic="array", nsteps=1,
            state={"h": np.zeros((6, 4, 4), np.float32),
                   "u": np.zeros((2, 6, 4, 4), np.float32)}))
    srv.close()


def test_request_state_is_perturbed_ensemble_member(served_pair):
    """The server's host-side member build is bitwise member 1 of
    ``perturbed_ensemble``."""
    from jaxstream_torch.physics.initial_conditions import perturbed_ensemble

    port, _ = served_pair
    h = port._ic("tc6")[0]
    req = ScenarioRequest(id="p", ic="tc6", nsteps=1, seed=11,
                          amplitude=2e-3)
    got = port._request_state(req)["h"]
    want = port._model("any").initial_state(
        perturbed_ensemble(port.grid, h, 2, seed=11, amplitude=2e-3)[1],
        port._ic("tc6")[1])["h"]
    assert torch.equal(got, want)
