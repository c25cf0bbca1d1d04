"""Placement planning for multi-chip serving (round 12).

Counterpart of :mod:`jaxstream.serve.placement`, whose code this module
keeps as it is (pure Python in both packages; the port keeps its own
copy, so that it imports nothing of the JAX package). Names, record
kinds, messages and outputs are the JAX module's.

One server process drives a whole mesh: the planner maps each
batch-size bucket onto the available devices in one of two composable
modes, chosen by ``serve.placement.mode``:

* ``member`` — **member-parallel**: the packed member axis shards
  across a 1-D ``('member',)`` device mesh, so a B=16 bucket on 8
  devices runs 2 members per chip.  Members never communicate, so the
  mode adds ZERO wire traffic; the masked segment is the SAME jitted
  program as the single-device path, compiled under member-axis
  ``in_shardings`` — GSPMD partitions the vmapped stepper, and the
  per-member values keep the repo's established member-batching
  contract (h bitwise vs the single-device packed run, u at the
  <= 1e-6 shape-dependent FMA budget — DESIGN.md "Batched ensemble
  execution").  Requires the classic (jnp) RHS: the fused Pallas
  kernels fold all members into one custom call GSPMD cannot split.
* ``panel`` — **panel-sharded**: each request's six cube faces spread
  across the ``panel`` axis of the 2-D ``('panel', 'member')`` mesh
  via :func:`jaxstream.parallel.shard_cov.
  make_sharded_cov_ensemble_stepper` — the batched exchange (one
  ppermute per schedule stage carries ALL members' strips) composing
  with the overlap phase split under
  ``parallelization.overlap_exchange``.  This is the large-grid mode:
  when one member's faces no longer fit (or fill) a chip, the panel
  axis is the scaling direction; needs a device count that is a
  multiple of 6.

A bucket that cannot use more than one device (B=1 under ``member``)
degrades to ``single`` — byte-for-byte the placement-off executable.
The planner is pure arithmetic (no jax, no devices), so the
device-count policies are unit-testable in microseconds and the same
accounting feeds ``scripts/comm_probe.py --serve``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

__all__ = ["PLACEMENT_MODES", "BucketPlan", "plan_bucket",
           "plan_placement", "plan_exchange_bytes_per_step",
           "placement_report"]

#: Legal ``serve.placement.mode`` values ('off' = the single-chip
#: round-11 code path, bitwise-unchanged).
PLACEMENT_MODES = ("off", "member", "panel")


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """How one batch-size bucket maps onto the device pool.

    ``mode`` is the *resolved* execution mode for this bucket —
    ``'single'`` (one device, the placement-off executable),
    ``'member'`` or ``'panel'`` — which may differ from the requested
    placement mode when the bucket cannot shard (B=1 member-parallel).
    ``num_devices`` counts the devices this bucket's executables span
    (``panel_shards * member_shards``); ``members_per_shard`` is the
    per-chip batch (per member *column* under ``panel`` — each column
    is 6 chips, one face each).
    """
    bucket: int
    mode: str
    num_devices: int
    panel_shards: int
    member_shards: int
    members_per_shard: int
    #: Round 19 (advisory): 1 - per_device_footprint/per_device_HBM
    #: for this bucket's measured segment executable (XLA's
    #: memory_analysis already reports per-device bytes for sharded
    #: executables) — recorded by the server when ``serve.cost_stamps``
    #: + a memory-stats-capable backend give it both sides
    #: (``jaxstream.obs.perf.headroom_fraction``), None otherwise.
    #: Reported in ``placement_report``/telemetry only; NO admission
    #: behavior change this round (docs/DESIGN.md "Performance
    #: observatory").
    headroom_frac: Optional[float] = None

    @property
    def sharded(self) -> bool:
        return self.num_devices > 1

    def with_headroom(self, footprint_bytes, limit_bytes) -> "BucketPlan":
        """This plan with the advisory headroom recorded (a new frozen
        value; None inputs leave the field None).  ``footprint_bytes``
        is per-device (memory_analysis of the sharded executable)."""
        from ..obs.perf import headroom_fraction

        return dataclasses.replace(self, headroom_frac=headroom_fraction(
            footprint_bytes, limit_bytes))


def _largest_divisor_leq(b: int, d: int) -> int:
    """Largest divisor of ``b`` that is <= ``d`` (>= 1)."""
    for m in range(min(b, d), 0, -1):
        if b % m == 0:
            return m
    return 1


def plan_bucket(bucket: int, num_devices: int, mode: str) -> BucketPlan:
    """Resolve one bucket's placement (see module docstring for modes).

    ``member``: the member-shard count is the largest divisor of the
    bucket not exceeding the device pool — every chip carries the same
    member count (the same rule :func:`jaxstream.parallel.mesh.
    setup_ensemble_sharding` enforces), and leftover devices stay idle
    for this bucket rather than skewing the batch.  ``panel``: the
    pool must be a multiple of 6 (one face per device along 'panel');
    the member axis takes the largest bucket divisor that fits
    ``num_devices // 6``.
    """
    if bucket < 1:
        raise ValueError(f"bucket must be >= 1, got {bucket}")
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if mode not in PLACEMENT_MODES:
        raise ValueError(
            f"placement mode {mode!r}; valid: {PLACEMENT_MODES}")
    if mode == "off" or num_devices == 1:
        return BucketPlan(bucket, "single", 1, 1, 1, bucket)
    if mode == "member":
        m = _largest_divisor_leq(bucket, num_devices)
        if m == 1:
            return BucketPlan(bucket, "single", 1, 1, 1, bucket)
        return BucketPlan(bucket, "member", m, 1, m, bucket // m)
    # panel
    if num_devices % 6:
        raise ValueError(
            f"placement mode 'panel' spreads each request's 6 faces "
            f"over the 'panel' mesh axis; num_devices={num_devices} is "
            f"not a multiple of 6. Valid counts: 6, 12, 18, ... (use "
            f"mode 'member' for other pools).")
    m = _largest_divisor_leq(bucket, num_devices // 6)
    return BucketPlan(bucket, "panel", 6 * m, 6, m, bucket // m)


def plan_placement(buckets: Sequence[int], num_devices: int,
                   mode: str) -> Dict[int, BucketPlan]:
    """Per-bucket plans for a bucket set (one dict key per bucket)."""
    return {int(b): plan_bucket(int(b), num_devices, mode)
            for b in buckets}


def plan_exchange_bytes_per_step(plan: BucketPlan, n: int, halo: int,
                                 dtype_bytes: int = 4) -> float:
    """Halo-exchange wire bytes per *stepper step* for one bucket.

    ``member``/``single``: members never communicate — zero.
    ``panel``: the face tier's 12 ppermutes per step (4 race-free
    schedule stages x 3 RK stages), each shipping every local member's
    ``(3, halo, n)`` strip each way — the
    :func:`jaxstream.utils.comm_probe.batched_exchange_plan`
    ``wire_bytes_per_member_step`` scaled by the bucket (per-member
    wire bytes are invariant in B; stacking only amortizes launch
    latency).
    """
    if plan.mode != "panel":
        return 0.0
    per_member = 12 * 3 * halo * n * dtype_bytes
    return float(per_member * plan.bucket)


def placement_report(buckets: Sequence[int], num_devices: int,
                     n: int, halo: int,
                     dtype_bytes: int = 4) -> dict:
    """Static placement accounting for ``comm_probe --serve``.

    Pure arithmetic — no jax, no devices.  For each placement mode,
    per bucket: the resolved plan (devices, member shards, per-chip
    batch) and the exchange bytes per step it would put on the wire;
    a mode the pool cannot host (panel on a non-multiple-of-6 pool)
    reports ``skipped`` with the planner's message instead of raising.
    """
    out = {"num_devices": int(num_devices), "n": int(n),
           "halo": int(halo), "buckets": [int(b) for b in buckets],
           "modes": {}}
    for mode in ("member", "panel"):
        try:
            plans = plan_placement(buckets, num_devices, mode)
        except ValueError as e:
            out["modes"][mode] = {"skipped": str(e)}
            continue
        rows = []
        for b in sorted(plans):
            pl = plans[b]
            rows.append({
                "bucket": pl.bucket,
                "mode": pl.mode,
                "devices": pl.num_devices,
                "panel_shards": pl.panel_shards,
                "member_shards": pl.member_shards,
                "members_per_shard": pl.members_per_shard,
                "exchange_bytes_per_step": plan_exchange_bytes_per_step(
                    pl, n, halo, dtype_bytes),
                "headroom_frac": pl.headroom_frac,
            })
        out["modes"][mode] = {"buckets": rows}
    return out
