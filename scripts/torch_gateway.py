"""Network serving CLI of the port: its asyncio gateway over its
``EnsembleServer`` (the counterpart of ``scripts/gateway.py``, same
arguments and the same one-line JSON summary).

Usage::

    python3 scripts/torch_gateway.py config.yaml [--host 127.0.0.1]
        [--port 8080] [--sink gateway.jsonl]
        [--autoscale-levels 1,4,16] [--queue-high 4] [--queue-low 0]
        [--occ-low 0.5] [--patience 2] [--cooldown 2]
        [--run-seconds 0] [--profile-dir profiles/] [--device cuda|cpu]

``config.yaml`` is the standard config surface (grid/time/physics/
model + the ``serve:`` block).  The process serves until SIGTERM or
SIGINT (or for ``--run-seconds``, for tests/demos), then drains
gracefully — admissions get 503 ``draining``, in-flight members run to
their final step, sinks flush — and prints exactly ONE JSON summary
line on stdout (everything else goes to stderr).

``--autoscale-levels`` enables live autoscaling: the levels must be a
subset of ``serve.buckets`` (every level maps to a warm executable, so
a resize never compiles); the policy watches queue depth + occupancy
at segment boundaries (jaxstream_torch.loadgen.autoscale).  The server
runs on the GPU unless ``--device cpu`` asks for the host.

Endpoints: ``POST /v1/requests`` (NDJSON event stream), ``GET /v1/ws``
(the same protocol over WebSocket), ``/v1/health``, ``/v1/ready``,
``/v1/stats``, ``GET /v1/metrics`` (Prometheus text exposition) and
``POST /v1/profile`` (an on-demand ``torch.profiler`` capture, enabled
by ``--profile-dir``; typed 501 otherwise) — the JAX gateway's schema
(docs/USAGE.md "Network serving" and "Operator view").
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _signals  # noqa: E402 — shared CLI signal-drain helper

log = _signals.log


def build_autoscale(args):
    if not args.autoscale_levels:
        return None
    from jaxstream_torch.loadgen.autoscale import (AutoscaleController,
                                                   AutoscalePolicy)

    levels = tuple(int(b) for b in args.autoscale_levels.split(",")
                   if b.strip())
    return AutoscaleController(AutoscalePolicy(
        levels=levels, queue_high=args.queue_high,
        queue_low=args.queue_low, occ_low=args.occ_low,
        patience=args.patience, cooldown=args.cooldown))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve scenario requests over HTTP/WebSocket "
                    "through the port's continuous-batching ensemble server.")
    ap.add_argument("config", help="server config YAML")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (default loopback)")
    ap.add_argument("--port", type=int, default=8080,
                    help="bind port (0 = ephemeral, printed to stderr)")
    ap.add_argument("--sink", default="",
                    help="gateway telemetry JSONL (per-request "
                         "'gateway' records)")
    ap.add_argument("--autoscale-levels", default="",
                    help="comma-separated bucket-cap ladder (subset of "
                         "serve.buckets); empty = autoscaling off")
    ap.add_argument("--queue-high", type=int, default=4)
    ap.add_argument("--queue-low", type=int, default=0)
    ap.add_argument("--occ-low", type=float, default=0.5)
    ap.add_argument("--patience", type=int, default=2)
    ap.add_argument("--cooldown", type=int, default=2)
    ap.add_argument("--run-seconds", type=float, default=0.0,
                    help="serve for N seconds then drain (0 = until "
                         "SIGTERM/SIGINT)")
    ap.add_argument("--profile-dir", default="",
                    help="enable POST /v1/profile: on-demand "
                         "torch.profiler captures land here (empty = "
                         "endpoint answers a typed 501)")
    ap.add_argument("--flight-dir", default="",
                    help="flight-recorder crash-bundle directory "
                         "(default: '<--sink>.flight' when --sink is "
                         "given, else off)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    import dataclasses

    from jaxstream_torch.config import load_config
    from jaxstream_torch.gateway import Gateway

    cfg = load_config(args.config)
    flight_dir = args.flight_dir or (
        args.sink + ".flight" if args.sink else "")
    if flight_dir:
        cfg = dataclasses.replace(
            cfg, observability=dataclasses.replace(
                cfg.observability, flight_dir=flight_dir))

    gw = Gateway(cfg, host=args.host, port=args.port,
                 autoscale=build_autoscale(args), sink=args.sink,
                 profile_dir=args.profile_dir, device=args.device)

    stop = threading.Event()

    def _drain(signame: str) -> None:
        # Commit the black box FIRST (gw.close's drain may take a
        # while; the bundle must exist even if the drain is cut short
        # by a second, harder signal).
        gw.server.flight_dump(reason=f"signal:{signame}")

    _signals.install_drain_handlers(stop, _drain, name="gateway")

    gw.start()
    log(f"gateway: serving on {gw.url} "
        f"(buckets {list(gw.server.buckets)}, warm "
        f"{gw.warm_compiles} builds, {gw.server.device})")
    t0 = time.perf_counter()
    try:
        while not stop.is_set():
            if (args.run_seconds > 0
                    and time.perf_counter() - t0 >= args.run_seconds):
                log(f"gateway: --run-seconds {args.run_seconds} "
                    "elapsed; draining")
                break
            stop.wait(0.2)
    finally:
        snap = None
        try:
            gw.close()                     # graceful drain inside
            snap = gw.snapshot()
        except Exception as e:
            log(f"gateway: close failed ({type(e).__name__}: {e})")
        summary = {
            "metric": "gateway_summary",
            "url": gw.url,
            "wall_s": round(time.perf_counter() - t0, 3),
        }
        if flight_dir:
            summary["flight_dir"] = flight_dir
        if snap is not None:
            summary.update({
                "gateway": snap["gateway"],
                "server": {k: snap["server"][k] for k in
                           ("submitted", "completed", "evicted",
                            "segments", "refills", "member_steps",
                            "resizes") if k in snap["server"]},
                "occupancy_mean": snap["occupancy_mean"],
                "warm_compiles": snap["warm_compiles"],
                "steady_recompiles": (snap["compile_count"]
                                      - snap["warm_compiles"]),
            })
            if "autoscale" in snap:
                summary["autoscale"] = snap["autoscale"]
        print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
