"""Deterministic heavy-tailed arrival traces (round 14).

Counterpart of :mod:`jaxstream.loadgen.trace`, whose code this module
keeps as it is (pure Python in both packages; the port keeps its own
copy, so that it imports nothing of the JAX package). Names, record
kinds, messages and outputs are the JAX module's.

A trace is the load harness's replayable input: one JSONL line per
request, each carrying an arrival offset ``t`` (seconds from trace
start) plus the full :class:`ScenarioRequest` surface — IC family
drawn from a weighted mix of the Williamson/Galewsky scenario set, run
length from a ragged ladder (so members finish mid-segment and slots
refill), perturbation seed, and output subset.

Inter-arrival gaps are Lomax/Pareto-II distributed (``rng.pareto``):
genuinely heavy-tailed for ``tail_alpha <= 2`` — most gaps are short
(bursts that pile up the queue and trip the autoscaler) with rare long
silences (idle stretches that let it scale back down).  Everything is
driven by one seeded ``numpy`` generator, so a (seed, parameters) pair
reproduces the trace BYTE-for-byte — two generations of the same trace
serialize identically, which is what makes a load run replayable and
the loadgen sink comparable across runs (tests/test_loadgen.py).

Pure numpy + stdlib: no jax, importable anywhere (the CLI generates
traces on machines with no accelerator stack).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["DEFAULT_FAMILY_WEIGHTS", "DEFAULT_LENGTHS",
           "DEFAULT_OUTPUTS", "generate_trace", "write_trace",
           "read_trace"]

#: Default IC-family mix: the full scenario set the serving tier packs
#: (mixed-orography batches make tc5 ride with the flat families).
DEFAULT_FAMILY_WEIGHTS: Dict[str, float] = {
    "tc2": 0.3, "tc5": 0.3, "tc6": 0.2, "galewsky": 0.2,
}

#: Ragged run-length ladder (stepper calls) — deliberately not
#: segment-aligned so per-member masking and boundary refill are
#: always exercised.
DEFAULT_LENGTHS: Tuple[int, ...] = (1, 2, 3, 5, 8)

#: Output-subset choices a request may ask back.
DEFAULT_OUTPUTS: Tuple[Tuple[str, ...], ...] = (("h",), ("h", "u"))


def generate_trace(n_requests: int, seed: int, *,
                   mean_gap_s: float = 1.0, tail_alpha: float = 1.5,
                   family_weights: Optional[Dict[str, float]] = None,
                   lengths: Sequence[int] = DEFAULT_LENGTHS,
                   outputs: Sequence[Tuple[str, ...]] = DEFAULT_OUTPUTS,
                   amplitude: float = 1.0e-3,
                   id_prefix: str = "q") -> List[dict]:
    """``n_requests`` arrival entries, deterministic in ``seed``.

    ``mean_gap_s`` sets the mean inter-arrival gap (for
    ``tail_alpha > 1``; at ``alpha <= 1`` the Pareto mean diverges and
    ``mean_gap_s`` scales the distribution's minimum instead);
    ``tail_alpha`` the Pareto shape — smaller = heavier tail.  Entries
    are sorted by construction (cumulative gaps).
    """
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if tail_alpha <= 0:
        raise ValueError(f"tail_alpha must be > 0, got {tail_alpha}")
    weights = dict(family_weights or DEFAULT_FAMILY_WEIGHTS)
    fams = sorted(weights)
    p = np.asarray([weights[f] for f in fams], np.float64)
    if p.min() < 0 or p.sum() <= 0:
        raise ValueError(f"bad family weights {weights}")
    p = p / p.sum()
    lengths = [int(x) for x in lengths]
    if not lengths or min(lengths) < 1:
        raise ValueError(f"lengths must be positive ints, got {lengths}")
    outputs = [tuple(o) for o in outputs]

    rng = np.random.default_rng(seed)
    # Lomax gaps: mean of rng.pareto(a) is 1/(a-1) for a > 1.
    scale = (mean_gap_s * (tail_alpha - 1.0) if tail_alpha > 1.0
             else mean_gap_s)
    gaps = scale * rng.pareto(tail_alpha, size=n_requests)
    gaps[0] = 0.0                       # the first request opens the run
    ts = np.cumsum(gaps)
    trace = []
    for i in range(n_requests):
        fam = fams[int(rng.choice(len(fams), p=p))]
        trace.append({
            "t": round(float(ts[i]), 6),
            "id": f"{id_prefix}{i:04d}",
            "ic": fam,
            "nsteps": lengths[int(rng.integers(len(lengths)))],
            "seed": int(rng.integers(0, 2**31 - 1)),
            "amplitude": amplitude,
            "outputs": list(outputs[int(rng.integers(len(outputs)))]),
        })
    return trace


def write_trace(path: str, trace: List[dict]) -> None:
    """One sorted-key JSON line per entry — byte-stable for a given
    trace, so seed determinism is file-level."""
    with open(path, "w") as fh:
        for entry in trace:
            fh.write(json.dumps(entry, sort_keys=True) + "\n")


def read_trace(path: str) -> List[dict]:
    out = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                entry = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON ({e})")
            for key in ("t", "id", "ic", "nsteps"):
                if key not in entry:
                    raise ValueError(
                        f"{path}:{i + 1}: trace entry missing {key!r}")
            out.append(entry)
    if not out:
        raise ValueError(f"{path}: empty trace")
    return out
