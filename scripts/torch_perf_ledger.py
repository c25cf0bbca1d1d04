"""Cross-round performance regression ledger of the port (the
counterpart of ``scripts/perf_ledger.py``: the same arguments, output
and exit codes, on :mod:`jaxstream_torch.obs.perf`'s bench-history
half).

Usage::

    python3 scripts/torch_perf_ledger.py [render] [BENCH_r*.json ...]
        [--json]
    python3 scripts/torch_perf_ledger.py check [BENCH_r*.json ...]
        [--candidate FILE] [--max-regression PCT]
        [--max-footprint-growth PCT] [--json]
    python3 scripts/torch_perf_ledger.py --fixture

``render`` (the default) parses the recorded ``BENCH_r*.json`` history
(every file under the repo root when no paths are given) into ONE
canonical machine-normalized trajectory — per section:
sim-days/sec/chip, % of roof, footprint bytes, compile seconds, and
(round 21) the ``cold_start`` warm-pool section as warm-over-cold
speedup ratios (``cold_start:warm_speedup`` /
``cold_start:resize_speedup``, higher is better) so scale-up latency
gates the way throughput does — and prints the trend table.  Hardware
classes are inferred per the normalization rules in
``jaxstream_torch.obs.perf.parse_bench_point`` (CPU-smoke points are
tagged ``reported-only`` and never gate).

``check`` gates the LAST point (or ``--candidate FILE``, a bench
stdout JSON line or a round envelope) against the best recorded
comparable point — same section, same hardware class: a throughput
regression beyond ``--max-regression`` (default 10%) or a footprint
grown beyond ``--max-footprint-growth`` (default 50%) **exits
nonzero**.

``--fixture`` runs the check over the seeded-broken corpus (a 30%
throughput regression + a silently-grown footprint,
``jaxstream_torch.obs.perf.broken_bench_history``) — it must exit
nonzero, or the gate has lost its teeth (``tests/test_torch_scripts_cli.py``
asserts this).
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _take(argv, flag):
    """Pop ``flag <value>`` from argv; a flag with no value is a
    usage error (exit 2), never an IndexError traceback."""
    if flag not in argv:
        return None
    i = argv.index(flag)
    if i + 1 >= len(argv):
        print(f"perf_ledger: {flag} requires a value", file=sys.stderr)
        raise SystemExit(2)
    val = argv[i + 1]
    del argv[i:i + 2]
    return val


def _pct(argv, flag, default):
    val = _take(argv, flag)
    return default if val is None else float(val) / 100.0


def _load_points(paths):
    from jaxstream_torch.obs import perf as obs_perf

    if not paths:
        return obs_perf.load_bench_history(REPO)
    points = []
    for p in paths:
        with open(p) as fh:
            obj = json.load(fh)
        points.append(obs_perf.parse_bench_point(
            obj, label=os.path.basename(p).rsplit(".", 1)[0]))
    return points


def main(argv=None) -> int:
    from jaxstream_torch.obs import perf as obs_perf

    args = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in args
    args = [a for a in args if a != "--json"]
    if "--fixture" in args:
        pts = [obs_perf.parse_bench_point(o, label=f"fixture:r{o['n']}")
               for o in obs_perf.broken_bench_history()]
        res = obs_perf.check_trajectory(pts)
        print(json.dumps(res) if as_json else
              "\n".join(r["detail"] for r in res["regressions"])
              or "fixture came back CLEAN — the ledger lost its teeth")
        # Exit nonzero when the regression was CAUGHT (the CLI check
        # contract: regressions -> exit 1), which is what CI asserts.
        return 1 if not res["ok"] else 0
    max_reg = _pct(args, "--max-regression",
                   obs_perf.DEFAULT_MAX_REGRESSION)
    max_fp = _pct(args, "--max-footprint-growth",
                  obs_perf.DEFAULT_MAX_FOOTPRINT_GROWTH)
    candidate = _take(args, "--candidate")
    cmd = "render"
    if args and args[0] in ("render", "check"):
        cmd = args.pop(0)
    points = _load_points(args)
    if candidate is not None:
        with open(candidate) as fh:
            text = fh.read().strip()
        obj = json.loads(text.splitlines()[-1])
        points.append(obs_perf.parse_bench_point(
            obj, label=os.path.basename(candidate)))
    if not points:
        print("perf_ledger: no BENCH_r*.json history found",
              file=sys.stderr)
        return 2
    if cmd == "render":
        if as_json:
            print(json.dumps({"points": points}))
        else:
            print(obs_perf.render_trajectory(points))
        return 0
    res = obs_perf.check_trajectory(points, max_regression=max_reg,
                                    max_footprint_growth=max_fp)
    if as_json:
        print(json.dumps(res))
    else:
        mode = "ENFORCED" if res["enforced"] else "reported-only"
        print(f"perf_ledger check [{mode}]: candidate "
              f"{res['candidate']} ({res['hardware_class']}) vs "
              f"{res['points'] - 1} recorded point(s), "
              f"{res['compared_sections']} section(s) compared")
        for r in res["regressions"]:
            print(f"  REGRESSION {r['detail']}")
        for r in res["advisories"]:
            print(f"  advisory   {r['detail']}")
        if res["ok"] and not res["advisories"]:
            if res["compared_sections"]:
                print("  clean — no section regressed beyond the band")
            else:
                print("  VACUOUS pass — no comparable recorded point "
                      "shares a section with this candidate (nothing "
                      "was gated)")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
