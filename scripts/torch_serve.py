"""Serve scenario requests through the port's continuous-batching
ensemble server (the counterpart of ``scripts/serve.py``, same
arguments and the same one-line JSON summary).

Usage::

    python3 scripts/torch_serve.py config.yaml --requests trace.jsonl \
        [--output-dir DIR] [--warm flat,oro] [--flight-dir DIR] \
        [--device cuda|cpu]

``config.yaml`` is the config surface (grid/time/physics/model and the
``serve:`` block); ``trace.jsonl`` holds one scenario request per
line::

    {"id": "r0", "ic": "tc5", "nsteps": 288, "seed": 7,
     "amplitude": 1e-3, "outputs": ["h"]}

Requests are admitted with producer-side backpressure (a batch is
served whenever the queue is full), packed into the member axis, and,
with ``--output-dir``/``serve.output_dir``, written as one store per
request by the background writer.  The server runs on the GPU unless
``--device cpu`` asks for the host.  Prints exactly ONE JSON summary
line on stdout (statuses, occupancy and utilization, latency
percentiles, build counts, host-wait totals, the bucket proof and cost
stamps and which stepper each bucket ran, and under ``serve.warm_pool``
the pool's counters and each bucket's warm-up); everything else goes to
stderr.  SIGTERM/SIGINT dump the flight bundle and drain.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _signals  # noqa: E402 — shared CLI signal-drain helper


def load_requests(path: str):
    from jaxstream_torch.serve import ScenarioRequest

    reqs = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                reqs.append(ScenarioRequest.from_dict(json.loads(line)))
            except (json.JSONDecodeError, TypeError, ValueError) as e:
                raise SystemExit(f"{path}:{i + 1}: bad request ({e})")
    if not reqs:
        raise SystemExit(f"{path}: no requests")
    return reqs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve scenario requests through the port's "
                    "continuous-batching ensemble server.")
    ap.add_argument("config", help="server config YAML (grid/time/"
                                   "physics/model + serve: block)")
    ap.add_argument("--requests", required=True,
                    help="JSONL request trace (one scenario per line)")
    ap.add_argument("--output-dir", default="",
                    help="override serve.output_dir (one store per "
                         "request)")
    ap.add_argument("--warm", default="",
                    help="comma-separated batching groups to build "
                         "before admitting traffic (e.g. 'flat,oro')")
    ap.add_argument("--flight-dir", default="",
                    help="flight-recorder crash-bundle directory "
                         "(default: '<serve.sink>.flight' when a sink "
                         "is configured, else off)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    import numpy as np

    from jaxstream_torch.config import load_config
    from jaxstream_torch.serve import EnsembleServer
    from jaxstream_torch.serve.queue import QueueFull, ServerDraining

    cfg = load_config(args.config)
    if args.output_dir:
        cfg = dataclasses.replace(
            cfg, serve=dataclasses.replace(cfg.serve,
                                           output_dir=args.output_dir))
    flight_dir = args.flight_dir or (
        cfg.serve.sink + ".flight" if cfg.serve.sink else "")
    if flight_dir:
        cfg = dataclasses.replace(
            cfg, observability=dataclasses.replace(
                cfg.observability, flight_dir=flight_dir))
    reqs = load_requests(args.requests)
    warm = tuple(g.strip() for g in args.warm.split(",") if g.strip())

    stop = threading.Event()
    server = EnsembleServer(cfg, device=args.device)

    def _drain(signame: str) -> None:
        server.flight_dump(reason=f"signal:{signame}")
        server.begin_drain()

    _signals.install_drain_handlers(stop, _drain, name="serve")

    wall0 = time.perf_counter()
    unsubmitted = 0
    try:
        if warm:
            server.warmup(groups=warm)
        pending = list(reqs)
        while pending and not stop.is_set():
            while pending:
                try:
                    server.submit(pending[0])
                except QueueFull:
                    break
                except ServerDraining:
                    unsubmitted = len(pending)
                    pending = []
                    break
                pending.pop(0)
            req = server.queue.pop()
            if req is not None:
                server._run_batch(req)
        unsubmitted += len(pending)
        server.serve()
    finally:
        server.close()
    wall = time.perf_counter() - wall0

    lat = server.latencies()
    dt = cfg.time.dt
    member_steps = server.stats["member_steps"]
    summary = {
        "metric": "serve_summary",
        "n_requests": len(reqs),
        "completed": server.stats["completed"],
        "evicted": server.stats["evicted"],
        "batches": server.stats["batches"],
        "segments": server.stats["segments"],
        "refills": server.stats["refills"],
        "occupancy_mean": round(server.occupancy_mean, 4),
        "utilization_mean": round(server.utilization_mean, 4),
        "member_steps": member_steps,
        "member_steps_per_sec": round(member_steps / wall, 2),
        "aggregate_sim_days_per_sec": round(
            member_steps * dt / 86400.0 / wall, 4),
        "latency_p50_s": round(float(np.percentile(lat, 50)), 4)
        if len(lat) else None,
        "latency_p99_s": round(float(np.percentile(lat, 99)), 4)
        if len(lat) else None,
        "warmup_compiles": server.stats["warmup_compiles"],
        "steady_recompiles": (server.compile_count()
                              - server.stats["warmup_compiles"]),
        "host_wait_s_total": round(server.stats["host_wait_s"], 4),
        "wall_s": round(wall, 3),
        "device": str(server.device),
        "requests": {r.id: r.status
                     for r in server.results.values()},
    }
    summary["bucket_proofs"] = server.bucket_proofs()
    summary["bucket_costs"] = server.bucket_costs()
    summary["bucket_impls"] = server.bucket_impls()
    memory = server.memory_snapshot()
    if memory is not None:
        summary["memory"] = memory
    warm = server.warmpool_summary()
    if warm is not None:
        summary["warm_pool"] = warm
        summary["bucket_warmups"] = server.bucket_warmups()
    if flight_dir:
        summary["flight_dir"] = flight_dir
    if unsubmitted:
        summary["unsubmitted"] = unsubmitted
    print(json.dumps(summary))
    return 0 if server.stats["evicted"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
