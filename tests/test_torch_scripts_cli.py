"""Port: the serving and ledger CLIs (``scripts/torch_gateway.py``,
``torch_loadgen.py``, ``torch_perf_ledger.py``) and the bench-history
half of ``jaxstream_torch.obs.perf``, held to the JAX package on the
CPU.

* the six bench-history functions return the JAX module's values on the
  repository's ``BENCH_r0*.json`` (read, never written) and on the
  seeded-broken corpus, and write the same bytes;
* ``torch_perf_ledger.main`` prints what ``scripts/perf_ledger.py``
  prints, with its exit codes (the fixture must fail);
* ``torch_loadgen.main generate`` writes the JAX CLI's trace bytes;
* ``torch_gateway.main`` serves at C8 on port 0 (``--device cpu``) while
  ``torch_loadgen.main run`` replays a few requests against it; the
  drain goes through the shared ``_signals`` handler's hook;
* ``torch_serve.main`` on a ``serve.warm_pool`` config, twice: the
  second run's buckets come from the pool.

Every CLI runs in this process through its importable ``main(argv)``
(``scripts/check_tiers.py`` rule 13: no slow marker, no child process).
"""

import importlib.util
import json
import os
import threading

import pytest

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

from jaxstream.obs import perf as jperf

from jaxstream_torch.gateway import Gateway
from jaxstream_torch.obs import perf as tperf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    """``scripts/<name>`` as a module (its ``main`` importable)."""
    spec = importlib.util.spec_from_file_location(
        name[:-3].replace("-", "_"), os.path.join(REPO, "scripts", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- the bench-history half -------------------------------------------------


def test_bench_history_matches_jax():
    """``parse_bench_point`` per round, ``load_bench_history`` over the
    repository's rounds, ``check_trajectory`` and ``render_trajectory``
    on them: the JAX module's values."""
    assert tperf.load_bench_history(REPO) == jperf.load_bench_history(REPO)
    for name in sorted(os.listdir(REPO)):
        if name.startswith("BENCH_r0") and name.endswith(".json"):
            with open(os.path.join(REPO, name)) as fh:
                obj = json.load(fh)
            assert tperf.parse_bench_point(obj, name) == \
                jperf.parse_bench_point(obj, name)
    pts = tperf.load_bench_history(REPO)
    assert tperf.check_trajectory(pts) == jperf.check_trajectory(pts)
    assert tperf.check_trajectory(pts, 0.01, 0.0) == \
        jperf.check_trajectory(pts, 0.01, 0.0)
    assert tperf.render_trajectory(pts) == jperf.render_trajectory(pts)
    with pytest.raises(ValueError, match="at least one point"):
        tperf.check_trajectory([])


def test_broken_bench_history_matches_jax(tmp_path):
    """The seeded-broken corpus: the same records, the same files, and a
    check that fails on both the throughput and the footprint."""
    assert tperf.broken_bench_history() == jperf.broken_bench_history()
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tp = tperf.write_broken_bench_history(str(tmp_path / "t"))
    jp = jperf.write_broken_bench_history(str(tmp_path / "j"))
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp]
    for a, b in zip(tp, jp):
        assert open(a, "rb").read() == open(b, "rb").read()
    pts = tperf.load_bench_history(str(tmp_path / "t"))
    res = tperf.check_trajectory(pts)
    assert res == jperf.check_trajectory(jperf.load_bench_history(
        str(tmp_path / "j")))
    assert not res["ok"] and res["enforced"]
    assert {r["section"] for r in res["regressions"]} == {"headline",
                                                          "footprint"}


@pytest.mark.parametrize("argv", [
    [], ["--json"], ["check"], ["check", "--json"],
    ["check", "--max-regression", "1"], ["--fixture"],
    ["--fixture", "--json"]], ids=lambda a: " ".join(a) or "render")
def test_perf_ledger_cli_matches_jax(argv, capsys):
    """``torch_perf_ledger.main`` against ``perf_ledger.main``: the same
    stdout and exit code (render, check, the fixture's exit 1)."""
    trc = _script("torch_perf_ledger.py").main(list(argv))
    tout = capsys.readouterr().out
    jrc = _script("perf_ledger.py").main(list(argv))
    jout = capsys.readouterr().out
    assert (trc, tout) == (jrc, jout)
    if "--fixture" in argv:
        assert trc == 1


def test_perf_ledger_cli_usage_errors(tmp_path, capsys):
    mod = _script("torch_perf_ledger.py")
    with pytest.raises(SystemExit) as e:
        mod.main(["check", "--candidate"])
    assert e.value.code == 2
    (tmp_path / "empty").mkdir()
    mod.REPO = str(tmp_path / "empty")
    assert mod.main([]) == 2


# ---- loadgen and gateway ------------------------------------------------------

_GEN = ["--n", "4", "--seed", "3", "--mean-gap", "0.01", "--lengths", "2,3",
        "--families", "tc2:0.5,tc6:0.5"]


def test_loadgen_generate_matches_jax(tmp_path):
    """``torch_loadgen.py generate`` writes the JAX CLI's trace bytes."""
    t, j = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    assert _script("torch_loadgen.py").main(["generate", t] + _GEN) == 0
    assert _script("loadgen.py").main(["generate", j] + _GEN) == 0
    assert open(t, "rb").read() == open(j, "rb").read()


def test_gateway_and_loadgen_clis_serve_in_process(tmp_path, monkeypatch,
                                                   capsys):
    """The gateway CLI at C8 on the CPU, on an ephemeral port, with the
    loadgen CLI replaying four requests against it from a thread; the
    drain comes through the ``_signals`` hook the CLI installs (its
    handler is captured here instead of being bound to the process's
    signals).  Both print their one JSON line; every request completes
    and the gateway built nothing after its warm-up."""
    cfg = tmp_path / "c8.yaml"
    cfg.write_text(
        "grid:\n  n: 8\ntime:\n  dt: 600.0\n"
        "model:\n  name: shallow_water_cov\n  backend: jnp\n"
        "parallelization:\n  num_devices: 1\n"
        "serve:\n  buckets: \"1,2\"\n  segment_steps: 2\n"
        "  queue_capacity: 8\n")
    gw_cli, lg_cli = _script("torch_gateway.py"), _script("torch_loadgen.py")
    started, box = threading.Event(), {}
    start = Gateway.start

    def start_and_tell(self, *a, **k):
        out = start(self, *a, **k)
        box["gw"] = self
        started.set()
        return out

    monkeypatch.setattr(Gateway, "start", start_and_tell)

    def install(stop, on_drain=None, name="serve"):
        box["stop"], box["drain"] = stop, on_drain
        return lambda *a: None

    monkeypatch.setattr(gw_cli._signals, "install_drain_handlers", install)
    trace = str(tmp_path / "trace.jsonl")
    assert lg_cli.main(["generate", trace] + _GEN) == 0

    def client():
        try:
            if started.wait(120):
                box["rc"] = lg_cli.main([
                    "run", trace, "--url", box["gw"].url, "--workers", "2",
                    "--timeout", "120", "--sink",
                    str(tmp_path / "loadgen.jsonl"), "--dt", "600"])
        finally:
            if "drain" in box:
                box["drain"]("SIGTERM")
                box["stop"].set()

    th = threading.Thread(target=client)
    th.start()
    rc = gw_cli.main([str(cfg), "--port", "0", "--device", "cpu",
                      "--sink", str(tmp_path / "gateway.jsonl"),
                      "--run-seconds", "120"])
    th.join(60)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    load, gw = lines
    assert rc == 0 and box["rc"] == 0
    assert load["completed"] == 4 and load["accounting_exact"]
    assert gw["metric"] == "gateway_summary"
    assert gw["server"]["completed"] == 4
    assert gw["steady_recompiles"] == 0
    assert os.path.exists(gw["flight_dir"])


def test_serve_cli_restarts_from_its_pool(tmp_path, monkeypatch, capsys):
    """``torch_serve.py`` on a config with ``serve.warm_pool``, twice: the
    second run takes every bucket from the pool (rung ``aot``, no table
    build) and serves the same requests to the same statuses."""
    cfg = tmp_path / "c8.yaml"
    cfg.write_text(
        "grid:\n  n: 8\ntime:\n  dt: 600.0\n"
        "model:\n  name: shallow_water_cov\n  backend: pallas\n"
        "parallelization:\n  num_devices: 1\n"
        "serve:\n  buckets: \"1,2\"\n  segment_steps: 2\n"
        "  group_by_orography: true\n"
        f"  warm_pool: {tmp_path / 'pool'}\n")
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("".join(json.dumps(
        {"id": f"r{i}", "ic": "tc5", "nsteps": 2 + i, "seed": i}) + "\n"
        for i in range(3)))
    serve = _script("torch_serve.py")
    monkeypatch.setattr(serve._signals, "install_drain_handlers",
                        lambda *a, **k: None)
    out = []
    for _ in range(2):
        assert serve.main([str(cfg), "--requests", str(reqs), "--warm",
                           "oro", "--device", "cpu"]) == 0
        out.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    cold, warm = out
    assert {w["rung"] for w in cold["bucket_warmups"].values()} == {"cold"}
    assert {w["rung"] for w in warm["bucket_warmups"].values()} == {"aot"}
    assert all(w["table_builds"] == 0
               for w in warm["bucket_warmups"].values())
    assert warm["warm_pool"]["hits"] == 2 and warm["warmup_compiles"] == 0
    assert warm["requests"] == cold["requests"]
