"""Port: the serving warm pool (``jaxstream_torch.serve.warmpool``), held
to the JAX package at C8 on the CPU.

* ``deployment_digest`` gives the JAX function's hex for the same config;
  ``entry_key`` keeps its schema, and every identity field moves it (a
  changed rules version, plan or toolchain field is a miss, never a
  stale hit);
* an entry round-trips (the tables bitwise, the libraries' bytes), and a
  torn one (short, of another digest, or missing a payload) is detected,
  deleted, recorded ``corrupt`` and rebuilt;
* the probe verdict is cached in-process and on disk and gates the
  ``compile_cache`` rung, through the injectable ``probe=`` fake;
* a server restarted on the same pool builds no table and opens no
  library the pool did not give (``compile_count()`` 0), and its
  results are byte-equal to the cold server's;
* headroom refusals, ``speculate`` without ``warm_pool``, and the
  speculative compiler (the adjacent bucket through the server's own
  build, headroom respected).

In process, no slow marker (``scripts/check_tiers.py`` rule 15); a few
seconds in all.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

from jaxstream.config import load_config as jax_load_config
from jaxstream.serve.warmpool import deployment_digest as jax_digest

from jaxstream_torch import _build
from jaxstream_torch.config import load_config
from jaxstream_torch.obs.sink import read_records, validate_record
from jaxstream_torch.serve import (EnsembleServer, HeadroomRefused,
                                   ScenarioRequest)
from jaxstream_torch.serve import queue
from jaxstream_torch.serve.warmpool import (ENV_FIELDS, WarmPool,
                                            deployment_digest, entry_key)

N, DT = 8, 600.0

_ENV = {"torch": "2.11.0", "cuda": "12.8", "nvcc": "cuda_12.8.r12.8",
        "device": "NVIDIA H100 80GB HBM3", "capability": "9.0",
        "device_count": 1, "kernels": "0123456789abcdef"}


def _cfg(pool="", **over):
    cfg = {
        "grid": {"n": N},
        "time": {"dt": DT},
        "model": {"name": "shallow_water_cov", "backend": "pallas"},
        "parallelization": {"num_devices": 1},
        "serve": {"buckets": "1,2", "segment_steps": 2,
                  "queue_capacity": 8, "group_by_orography": True,
                  "warm_pool": pool},
    }
    for k, v in over.items():
        cfg.setdefault(k, {}).update(v)
    return cfg


# ----------------------------------------------------------- cache key
@pytest.mark.parametrize("over", [
    {}, {"time": {"dt": 2 * DT}}, {"model": {"limiter": "vanleer"}},
    {"serve": {"segment_steps": 8, "group_by_orography": False}},
    {"physics": {"hyperdiffusion": 1e15}, "grid": {"n": 16, "halo": 3}},
], ids=["base", "dt", "limiter", "serve", "physics"])
def test_deployment_digest_matches_jax(over):
    """The same config gives the JAX function's hex; and a field the plan
    key does not carry moves it."""
    cfg = _cfg(**over)
    assert deployment_digest(load_config(cfg)) == jax_digest(
        jax_load_config(cfg))
    if over:
        assert deployment_digest(load_config(cfg)) != deployment_digest(
            load_config(_cfg()))


def test_entry_key_invalidation():
    """Every identity axis moves the key: plan, proof fingerprint, rules
    version, deployment digest, fn and each toolchain field."""
    base = dict(plan_key="serve/B2", proof_fingerprint="abc",
                rules_version=2, deploy_digest="d" * 16, fn="bucket",
                environment=dict(_ENV))
    k0 = entry_key(**base)
    assert k0 == entry_key(**base)
    variants = [dict(base, plan_key="serve/B4"),
                dict(base, proof_fingerprint="def"),
                dict(base, proof_fingerprint=None),
                dict(base, rules_version=3),
                dict(base, deploy_digest="e" * 16),
                dict(base, fn="extract")]
    variants += [dict(base, environment=dict(_ENV, **{f: "other"}))
                 for f in ENV_FIELDS]
    keys = [entry_key(**v) for v in variants]
    assert k0 not in keys and len(set(keys)) == len(keys)


# ------------------------------------------------- pool load/save/torn
def _pool(tmp_path, **kw):
    recs = []
    kw.setdefault("sink_write", recs.append)
    kw.setdefault("environment", dict(_ENV))
    kw.setdefault("probe", lambda rung, scratch: {
        "rung": rung, "ok": False, "detail": "fake probe"})
    return WarmPool(str(tmp_path / "pool"), **kw), recs


def _tables():
    g = torch.Generator().manual_seed(5)
    return {"split_route/8/2": (torch.arange(12), torch.randn(4, 6, generator=g),
                                (torch.randn(3, generator=g),)),
            "stage_rows/8/2/cpu": torch.randn(2, 12, generator=g)}


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


@pytest.fixture
def fake_library(tmp_path, monkeypatch):
    """A kernel library's built file (bytes on disk under the name
    ``_build`` gives it) in a build directory of the test's own."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    target = _build.target_path("cov_stage")
    target.parent.mkdir(parents=True)
    target.write_bytes(b"\x7fELF" + bytes(range(256)) * 4)
    return target


def test_pool_roundtrip_and_key_miss(tmp_path, fake_library):
    pool, recs = _pool(tmp_path)
    key = entry_key("p/B1", "fp", 2, "d" * 16, "bucket", environment=_ENV)
    tables = _tables()
    assert pool.save(key, tables, ["cov_stage"], plan_key="p/B1") == "aot"
    lib = fake_library.read_bytes()
    fake_library.unlink()           # a process whose build dir is empty
    warm = pool.load(key, plan_key="p/B1")
    assert warm is not None and warm.rung == "aot"
    assert _same(warm.tables, tables)
    assert warm.libraries == ["cov_stage"]
    assert fake_library.read_bytes() == lib     # installed, same bytes
    # A rules-version bump and a foreign toolchain are clean misses.
    bumped = entry_key("p/B1", "fp", 3, "d" * 16, "bucket",
                       environment=_ENV)
    assert pool.load(bumped, plan_key="p/B1") is None
    foreign = entry_key("p/B1", "fp", 2, "d" * 16, "bucket",
                        environment=dict(_ENV, capability="8.0"))
    assert pool.load(foreign, plan_key="p/B1") is None
    events = [(r["event"], r["rung"]) for r in recs]
    assert ("save", "aot") in events and ("hit", "aot") in events
    assert events.count(("miss", "cold")) == 2
    assert pool.stats["hits"] == 1 and pool.stats["misses"] == 2
    for r in recs:
        validate_record(r)
    # A library whose file cannot be read: the tables alone, one rung
    # down, with a typed fallback record.
    fake_library.unlink()
    key2 = entry_key("p/B2", "fp", 2, "d" * 16, "bucket", environment=_ENV)
    assert pool.save(key2, tables, ["cov_stage"]) == "stablehlo"
    assert any(r["event"] == "fallback" and r["rung"] == "aot"
               for r in recs)
    warm = pool.load(key2)
    assert warm.rung == "stablehlo" and warm.libraries == []
    assert not fake_library.exists()


@pytest.mark.parametrize("tear", ["truncate", "flip", "missing-library"])
def test_torn_entry_detected_deleted_rebuilt(tmp_path, fake_library, tear):
    """A payload that is short, of another digest or missing is a torn
    entry: a typed ``corrupt`` record, every file deleted, a miss; the
    slot then takes a fresh save."""
    pool, recs = _pool(tmp_path)
    key = entry_key("p/B1", "fp", 2, "d" * 16, "bucket", environment=_ENV)
    assert pool.save(key, _tables(), ["cov_stage"]) == "aot"
    tpath = pool._payload_path(key)
    lpath = pool._library_path(key, "cov_stage")
    if tear == "truncate":
        data = open(tpath, "rb").read()
        open(tpath, "wb").write(data[:len(data) // 2])
    elif tear == "flip":
        data = bytearray(open(lpath, "rb").read())
        data[100] ^= 1
        open(lpath, "wb").write(bytes(data))
    else:
        os.unlink(lpath)
    assert pool.load(key) is None
    assert pool.stats["corrupt"] == 1
    for p in (tpath, lpath, pool._meta_path(key)):
        assert not os.path.exists(p)
    assert "corrupt" in [r["event"] for r in recs]
    assert "corrupt" in [r.get("reason") for r in recs
                         if r["event"] == "miss"]
    assert pool.save(key, _tables(), ["cov_stage"]) == "aot"
    assert pool.load(key) is not None


def test_probe_verdict_cached_and_gates_cache_rung(tmp_path, monkeypatch):
    """The injected probe runs once per pool directory (cached in-process
    and on disk); a failed verdict keeps the compile_cache rung off with
    a typed fallback record, a sound one points ``_build`` at the shared
    directory."""
    calls = []

    def fake_probe(rung, scratch):
        calls.append(rung)
        return {"rung": rung, "ok": False, "detail": "fake failure"}

    pool, recs = _pool(tmp_path, probe=fake_probe,
                       compile_cache=str(tmp_path / "cc"))
    v1, v2 = (pool.rung_verdict("compile_cache") for _ in range(2))
    assert calls == ["compile_cache"] and v1 == v2
    assert not pool.enable_compile_cache()
    assert any(r["event"] == "fallback" and r["rung"] == "compile_cache"
               for r in recs)
    calls2 = []
    pool2, recs2 = _pool(tmp_path, probe=lambda r, s: calls2.append(r))
    assert pool2.rung_verdict("compile_cache")["ok"] is False
    assert calls2 == []
    assert any(r["event"] == "probe" and r.get("cached") for r in recs2)
    # A sound verdict (another pool directory) engages the rung.
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    ok = WarmPool(str(tmp_path / "pool_ok"), environment=dict(_ENV),
                  compile_cache=str(tmp_path / "cc"),
                  probe=lambda r, s: {"rung": r, "ok": True, "detail": ""})
    assert ok.enable_compile_cache()
    assert _build.BUILD_DIR == tmp_path / "cc"
    assert ok.summary()["compile_cache"] == str(tmp_path / "cc")


# ------------------------------------------------- server warm restart
def test_server_warm_restart_builds_nothing_byte_equal(tmp_path):
    """A second server on the same config and pool directory takes every
    bucket from the pool (rung ``aot``): no table builds, no library the
    pool did not give, ``compile_count()`` 0, and results byte-equal to
    the cold server's.  Both buckets are built, so a B = 2 lookup cannot
    stale-hit B = 1's entry."""
    pool_dir = str(tmp_path / "pool")

    def run(sink):
        cfg = _cfg(pool=pool_dir, serve={"sink": sink})
        srv = EnsembleServer(cfg, device="cpu")
        srv.submit(ScenarioRequest(id="r0", ic="tc2", nsteps=3, seed=1,
                                   amplitude=1e-3))
        res = srv.serve()
        srv._bucket("flat", 2)
        out = (res["r0"].fields["h"].tobytes(), srv.compile_count(),
               srv.warmpool_summary(), srv.bucket_warmups(),
               srv.stats["table_builds"], srv.metrics.render())
        srv.close()
        return out

    h_cold, cold_count, s_cold, w_cold, tb_cold, m_cold = run(
        str(tmp_path / "a.jsonl"))
    assert s_cold["saves"] == 2 and s_cold["hits"] == 0
    assert cold_count == 6 and tb_cold > 0
    assert {w["rung"] for w in w_cold.values()} == {"cold"}
    h_warm, warm_count, s_warm, w_warm, tb_warm, m_warm = run(
        str(tmp_path / "b.jsonl"))
    assert warm_count == 0 and tb_warm == 0
    assert s_warm["hits"] == 2 and s_warm["corrupt"] == 0
    assert all(w["rung"] == "aot" and w["table_builds"] == 0
               and w["nvcc_builds"] == 0 for w in w_warm.values())
    assert h_cold == h_warm
    # The registered counters count what the pool did (and spared).
    assert 'jaxstream_warmpool_saves_total{rung="aot"} 2' in m_cold
    assert 'jaxstream_warmpool_misses_total{reason="absent"} 2' in m_cold
    assert 'jaxstream_warmpool_hits_total{rung="aot"} 2' in m_warm
    recs = read_records(str(tmp_path / "b.jsonl"))
    assert any(r["kind"] == "warmpool" and r["event"] == "hit"
               for r in recs)
    # A changed dt is another deployment: every bucket misses.
    srv = EnsembleServer(_cfg(pool=pool_dir, time={"dt": 2 * DT}),
                         device="cpu")
    srv.warmup(groups=("flat",))
    assert srv.warmpool_summary()["hits"] == 0
    assert srv.warmpool_summary()["misses"] == 2
    srv.close()


def test_compile_cache_only_server_records_its_verdict(tmp_path):
    """``serve.compile_cache`` alone: the server owns a pool for the
    verdict (on this machine the probe finds no nvcc: "unavailable",
    typed), persists no entry, and serves."""
    sink = str(tmp_path / "s.jsonl")
    srv = EnsembleServer(_cfg(serve={"compile_cache": str(tmp_path / "cc"),
                                     "sink": sink}), device="cpu")
    try:
        srv.submit(ScenarioRequest(id="c0", ic="tc2", nsteps=2))
        assert srv.serve()["c0"].status == "ok"
        summary = srv.warmpool_summary()
        assert summary["saves"] == 0 and summary["compile_cache"] == ""
    finally:
        srv.close()
    probes = [r for r in read_records(sink)
              if r["kind"] == "warmpool" and r["event"] == "probe"]
    assert probes and probes[0]["ok"] is False
    assert "unavailable" in probes[0]["detail"]


# ------------------------------------------------- headroom enforcement
def _stamp_low_headroom(srv, bucket, frac=0.05):
    plan = srv._plans[bucket]
    srv._plans[bucket] = plan.with_headroom(100.0 * (1.0 - frac), 100.0)
    return srv._plans[bucket]


def test_headroom_refused_is_the_warm_pools():
    """``HeadroomRefused`` lives in the warm pool, as the JAX package
    keeps it; ``serve.queue`` re-exports the same class."""
    from jaxstream_torch.serve import warmpool

    assert queue.HeadroomRefused is warmpool.HeadroomRefused
    assert HeadroomRefused is warmpool.HeadroomRefused


def test_resize_refuses_stamped_headroom_breach(tmp_path):
    sink = str(tmp_path / "s.jsonl")
    srv = EnsembleServer(_cfg(serve={"sink": sink,
                                     "min_headroom_frac": 0.2}),
                         device="cpu")
    try:
        srv.resize(1, reason="test")
        assert srv.resize(2, reason="test") == 1
        srv.resize(1, reason="test")
        assert _stamp_low_headroom(srv, 2).headroom_frac == \
            pytest.approx(0.05)
        with pytest.raises(HeadroomRefused, match="min_headroom_frac"):
            srv.resize(2, reason="test")
        assert srv.resize(1, reason="test") == 1
    finally:
        srv.close()
    refusals = [r for r in read_records(sink) if r["kind"] == "headroom"]
    assert [(r["action"], r["bucket"]) for r in refusals] == [
        ("resize_refused", 2)]


def test_speculate_requires_warm_pool():
    with pytest.raises(ValueError, match="warm_pool"):
        EnsembleServer(_cfg(serve={"speculate": True}), device="cpu")


def test_speculator_builds_adjacent_and_respects_headroom(tmp_path):
    """The speculative compiler warms the adjacent bucket through the
    server's own build (so the pool gets its entry) and skips a
    headroom-refused target with the record resize writes."""
    sink = str(tmp_path / "s.jsonl")
    srv = EnsembleServer(_cfg(pool=str(tmp_path / "pool"), serve={
        "sink": sink, "speculate": True, "min_headroom_frac": 0.2}),
        device="cpu")
    try:
        sp = srv._speculator
        _stamp_low_headroom(srv, 2)
        sp._build(2)
        assert sp.built == [] and len(sp.skipped) == 1
        assert ("flat", 2) not in srv._buckets
        srv._plans[2] = srv._plans[2].with_headroom(None, None)
        sp._build(2)
        assert sp.built == [("flat", 2)] and ("flat", 2) in srv._buckets
        summary = srv.warmpool_summary()
        assert summary["speculative_built"] == [["flat", 2]]
        assert summary["speculative_skipped"] == 1
        assert summary["saves"] == 1
        sp.close()
        sp.nudge(1)
        with sp._lock:
            assert sp._targets == [2]
        sp.nudge(7)
        with sp._lock:
            assert sp._targets == [2]
    finally:
        srv.close()
    refusals = [r for r in read_records(sink) if r["kind"] == "headroom"]
    assert [r["action"] for r in refusals] == ["speculate_refused"]
    metas = [f for f in os.listdir(tmp_path / "pool")
             if f.endswith(".json") and not f.startswith("probe")]
    assert len(metas) == 1
    meta = json.load(open(tmp_path / "pool" / metas[0]))
    assert meta["rung"] == "aot" and meta["libraries"] == []
    assert np.isfinite(meta["tables"]["length"])
