"""Load-harness CLI of the port: generate arrival traces, replay them
against a gateway, report SLOs (the counterpart of ``scripts/loadgen.py``,
same arguments, the same trace files and the same one-line JSON
summary).

Two modes::

    # 1. Generate a deterministic heavy-tailed trace:
    python3 scripts/torch_loadgen.py generate trace.jsonl --n 200 \
        --seed 7 [--mean-gap 0.5] [--tail-alpha 1.5] \
        [--lengths 24,41,17,56]

    # 2. Replay it against a gateway and print ONE JSON SLO line:
    python3 scripts/torch_loadgen.py run trace.jsonl \
        --url http://127.0.0.1:8080 [--time-scale 1.0] [--workers 8] \
        [--sink loadgen.jsonl] [--dt 300]

``generate`` is byte-deterministic in (seed, parameters) — the same
command reproduces the same file, which is what makes load runs
replayable.  ``run`` measures p50/p99 request latency, goodput
(member-steps of completed work per second), and the typed-shed
accounting; per-request outcomes land in ``--sink`` as ``loadgen``
records (scripts/telemetry_report.py renders them).  Exit status 1
when the overload contract broke (an outcome that neither completed
nor shed with a typed 429/503).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from urllib.parse import urlparse

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cmd_generate(args) -> int:
    from jaxstream_torch.loadgen.trace import generate_trace, write_trace

    kwargs = {}
    if args.lengths:
        kwargs["lengths"] = [int(x) for x in args.lengths.split(",")
                             if x.strip()]
    if args.families:
        pairs = [p.split(":") for p in args.families.split(",")
                 if p.strip()]
        kwargs["family_weights"] = {k: float(v) for k, v in pairs}
    trace = generate_trace(args.n, args.seed,
                           mean_gap_s=args.mean_gap,
                           tail_alpha=args.tail_alpha, **kwargs)
    write_trace(args.trace, trace)
    log(f"loadgen: wrote {len(trace)} requests to {args.trace} "
        f"(seed {args.seed}, mean gap {args.mean_gap}s, "
        f"tail alpha {args.tail_alpha})")
    return 0


def cmd_run(args) -> int:
    from jaxstream_torch.loadgen.harness import run_load
    from jaxstream_torch.loadgen.trace import read_trace

    u = urlparse(args.url)
    if not u.hostname or not u.port:
        raise SystemExit(f"--url {args.url!r} needs host and port")
    trace = read_trace(args.trace)
    summary = run_load(u.hostname, u.port, trace,
                       time_scale=args.time_scale,
                       max_workers=args.workers,
                       request_timeout=args.timeout,
                       sink=args.sink, dt=args.dt or None)
    log(f"loadgen: {summary['completed']} completed / "
        f"{summary['shed']} shed / {summary['errors']} errors of "
        f"{summary['n_requests']} in {summary['wall_s']}s; p50/p99 "
        f"{summary['latency_p50_s']}/{summary['latency_p99_s']}s, "
        f"goodput {summary['goodput_member_steps_per_sec']} "
        f"member-steps/s")
    print(json.dumps(summary))
    return 0 if summary["accounting_exact"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Generate and replay heavy-tailed request traces "
                    "against the port's gateway.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="write a deterministic trace")
    g.add_argument("trace", help="output JSONL trace path")
    g.add_argument("--n", type=int, required=True,
                   help="number of requests")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--mean-gap", type=float, default=1.0,
                   help="mean inter-arrival gap (seconds)")
    g.add_argument("--tail-alpha", type=float, default=1.5,
                   help="Pareto tail shape (smaller = heavier)")
    g.add_argument("--lengths", default="",
                   help="comma-separated run-length ladder (steps)")
    g.add_argument("--families", default="",
                   help="IC weights as fam:w pairs, e.g. "
                        "'tc2:0.3,tc5:0.3,tc6:0.2,galewsky:0.2'")
    g.set_defaults(fn=cmd_generate)

    r = sub.add_parser("run", help="replay a trace against a gateway")
    r.add_argument("trace", help="JSONL trace path")
    r.add_argument("--url", required=True,
                   help="gateway base URL, e.g. http://127.0.0.1:8080")
    r.add_argument("--time-scale", type=float, default=1.0,
                   help="multiply arrival offsets (0 = one burst)")
    r.add_argument("--workers", type=int, default=8,
                   help="max in-flight client requests (closed loop)")
    r.add_argument("--timeout", type=float, default=300.0,
                   help="per-request client timeout (seconds)")
    r.add_argument("--sink", default="",
                   help="loadgen telemetry JSONL (per-request records)")
    r.add_argument("--dt", type=float, default=0.0,
                   help="seconds per stepper call, for sim-days goodput")
    r.set_defaults(fn=cmd_run)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
