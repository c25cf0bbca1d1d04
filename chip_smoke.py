"""Drive jaxstream_torch's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Sixteen paths, all at C384, halo 2, float32, PLR + MC, through the port's
entry points (``CovariantShallowWater`` and ``ShallowWater``,
``make_fused_step`` and ``make_step``, the steppers and the step-budget
bisection of ``jaxstream_torch.experiments``, and ``setup_sharding`` with
``make_stepper_for`` of ``jaxstream_torch.parallel``):

* Williamson TC5 (flow over a mountain), dt = 75 s, stepped by the
  compact fused SSPRK3 stepper: per step three strip routes (torch ops)
  and three launches of the hand-written CUDA stage kernel
  (``jaxstream_torch/csrc/cov_stage.cu``);
* TC5 on the classic SSPRK3 path with ``backend='pallas'``: per RK stage
  the halo exchangers and the symmetrized edge normals (torch ops) and one
  launch of the CUDA RHS kernel (``csrc/cov_rhs.cu``);
* TC5 on the extended-carry stepper (``compact=False``): per stage one
  linear strip route and one launch of the CUDA stage kernel with the
  ghost fill inside (``csrc/cov_stage_inkernel.cu``);
* the Galewsky barotropic-instability jet, dt = 60 s, nu4 = 1e14, under
  each of the three ``nu4_mode`` values:
  - ``split``: the same three routes and stage launches, then a fourth
    route and one launch of the CUDA filter kernel
    (``csrc/cov_nu4_filter.cu``);
  - ``refused``: route, one launch of the re-fused stage-1 kernel
    (``csrc/cov_stage_refused_nu4.cu``), then two routes and stage
    launches;
  - ``stage``: per RK stage a route, kernel A, a route of A's l1 strips
    and kernel B (``csrc/cov_stage_nu4.cu``);
  and the step-budget bisection of the ``stage`` step
  (``jaxstream_torch.experiments.nu4_bisect.run``): eight chains timed
  on the host clock and as CUDA graphs on the GPU, three of them kernel
  B with its ghost fill or its Laplacian ablated (the same source's
  ablated entry, B14);
* TC5 on the Cartesian-velocity ``ShallowWater`` (``backend='pallas'``),
  three ways: the default fused stepper, per stage one strip route
  (torch ops) and one launch of the CUDA stage kernel with the ghost fill
  inside (``csrc/swe_stage_inkernel.cu``); the fused stepper with
  ``in_kernel_exchange=False``, per stage two halo exchanges and one
  launch of the fused stage kernel (``csrc/swe_stage.cu``); the classic
  SSPRK3 path, per RK stage two halo exchanges and one launch of the RHS
  kernel (``csrc/swe_rhs.cu``);
* TC5 on the two router-free covariant steppers: the neighbour-read
  stepper (``make_fused_ssprk3_cov_nbr``), three launches per step of
  the stage kernel that fills its ghosts from the neighbour faces
  (``csrc/cov_stage_nbr.cu``) and nothing else; the whole-step stepper
  (``make_fused_ssprk3_cov_mega``), one cooperative launch per step
  (``csrc/cov_step_mega.cu``) over the compact carry;
* TC5 on the explicit sharded covariant tiers, every rank a virtual rank
  on the one card: the face tier (6 ranks, one face each) and the
  (6, 2, 2) block tier (24 ranks), each serialized (per RK stage the
  4-stage exchange, then one launch over the six faces of the RHS kernel
  of whole faces, ``csrc/cov_rhs.cu``, or one launch over all 24 ranks of
  the block RHS kernel with the blocks' coordinates,
  ``csrc/cov_rhs_local.cu``) and
  overlapped (per RK stage the exchange's first phase, one launch over
  all ranks of the interior kernel ``csrc/cov_rhs_interior.cu``, the
  second phase, and the torch band).

Phases, each fatal on failure:

1. the card, its power limit, and the kernel builds (one nvcc per
   source, all started together; -Xptxas -v);
2. the stage kernel against its plain PyTorch version at C384, as stage
   1 and as stage 2 (<= 1e-5 of each output's max), and as stage 3 with
   y0 = -2 yc, where the outputs are the scaled tendency g*L alone
   (<= 1e-4 of its max: f32 roundoff of the tendency is ~1e-5); each
   form must also be bitwise equal;
3. three fused steps against three steps of the port's classic path
   (<= 2e-4 of max, the JAX package's fused-vs-jnp budget);
4. a warm-up and a timed window of integration through the port's
   entry points, gated like ``bench.py`` (finite, 3000 < h < 6500 m,
   mass drift < 1e-3), with the stage launch count checked against
   3 x steps; then, on the run's own state, the stage kernel bitwise
   against its plain version in its three forms, its times (events and
   device time as a CUDA graph, beside the earlier design's), the plain
   version's and the router's, and the step's device time as a CUDA
   graph;
5. a short window traced by ``torch.profiler`` for the device's busy
   share (apart from the timed window, so tracing costs it nothing);
6. the filter kernel against its plain version at C384 on the Galewsky
   state after one split step (<= 1e-5 of each output's max), and an
   increment probe: the filter with nu4 scaled until
   damp*max|lap(lap q)| is 1e3 x max|q|, whose outputs are the filter
   term itself (<= 1e-4 of its max, the tolerance of
   ``tests/test_torch_nu4.py``); both must also be bitwise equal;
7. three split steps against three classic del^4 steps (<= 2e-3 of max,
   the JAX package's own split-vs-classic budget);
8. the Galewsky jet to day 6 (8 640 steps) on the split stepper, gated
   as ``bench.py::bench_galewsky`` gates it (finite, 8500 < h < 10800 m,
   mass drift < 1e-3, 5e-5 < max|zeta| north of 0.2 rad < 5e-4,
   max|zeta| south of -0.2 rad < 5e-6), with the filter launches checked
   against the steps and the stage launches against 3 x steps;
9. a timed window of 1 000 split steps, its breakdown (4 routes, 3 stage
   launches, 1 filter launch, the rest), the filter bitwise against its
   plain version on the run's own state, its time (beside the earlier
   design's) against its plain version and its bound, the step's device
   time as a CUDA graph, and a traced window;
10. the re-fused kernel against its plain version on the Galewsky state
    after one re-fused step (<= 1e-5 of each output's max), and its
    increment probe (nu4 scaled until the filtered base h0f, u0f is the
    filter term; <= 1e-4), with the plain version's f32-vs-f64 spread,
    and on TC5 (its mountain orography) after one re-fused step at nu4 =
    1e14; all bitwise required;
11. three re-fused steps against three split steps (<= 2e-3 of max, the
    JAX package's damp-scale budget: the two differ by one endpoint
    filter application; mass <= 1e-5);
12. the jet to day 6 on the re-fused stepper under the same gate, with
    the launches checked (re-fused 8 640, stage 17 280), then a timed
    window of 1 000 steps, its breakdown (3 routes, 1 re-fused launch,
    2 stage launches, the rest), the kernel's device time beside its
    earlier design's (``EARLIER_DEVICE_US``) and the step's device time
    as a CUDA graph, a traced window, and 300-step windows of the split
    and re-fused steppers in turns (split, re-fused, re-fused, split);
13. kernels A and B against their plain versions as stage 1 and stage 2
    (<= 1e-5), B with its probe (<= 1e-4), and A on TC5 (its mountain
    orography) after one in-stage step, as stage 1 and stage 2; then
    three in-stage steps against three classic del^4 steps (<= 5e-4) and
    three split steps (<= 2e-3), and B again, with its probe, on the
    state after those three steps; all bitwise required;
14. a timed window of 500 in-stage steps with the launches checked
    (A and B 3 x steps) and its breakdown (6 routes, 3 A, 3 B, the rest);
    A's and B's device times beside their earlier designs'
    (``EARLIER_DEVICE_US``) and the in-stage step's device time as a
    CUDA graph;
15. the RHS kernel against its plain version on the TC5 state, six faces
    and one face with external sym rows (<= 1e-5 of each output's max),
    then the kernel-backed classic ``rhs`` and the torch one against a
    float64 evaluation: the kernel-backed one no farther from it than
    the torch one plus 5e-5 of max (``tests/test_cov_swe.py:172``'s
    budget, set at C16: the tendency's f32 roundoff grows with n);
16. a timed window of 300 classic steps with ``backend='pallas'``, the
    RHS launches checked against 3 x steps, the TC5 gate, and its
    breakdown (fills, the sym rows, the kernel, the rest); the kernel's
    device time beside its earlier design's (``EARLIER_DEVICE_US``) and
    the step's device time as a CUDA graph;
17. the extended stage kernel against its plain version on whole blocks
    and strips, as stages 1, 2 and 3 (<= 1e-5) and as stage 3 with y0 =
    -2 yc (<= 1e-4), on the carry after one step and after 300 steps,
    bitwise required; then three extended steps against three compact
    steps (interiors and strips, <= 1e-6; bitwise predicted);
18. a timed window of 1 000 extended steps with the launches checked
    (3 x steps), the TC5 gate, its breakdown (3 routes, 3 stage launches,
    the rest), the kernel's device time beside its earlier design's
    (``EARLIER_DEVICE_US``) and the step's device time as a CUDA graph, a
    traced window, and 300-step windows of the compact and extended
    steppers in turns (compact, extended, extended, compact);
19. the Cartesian RHS kernel against its plain version on the TC5 state
    and on the state after the classic window (<= 1e-5 of each output's
    max, and bitwise), the kernel-backed classic ``rhs`` and the torch
    one against a float64 evaluation (as phase 15, the kernel no farther
    from it than the larger of the torch rhs and the JAX package's own
    kernel, plus 5e-5: the Cartesian kernels rebuild the metric in
    float32), then 300 classic steps gated, the launches checked against
    3 x steps, and their breakdown (fills, the kernel, the RK combines);
    the kernel's device time beside its earlier design's
    (``EARLIER_DEVICE_US``), the step's device time as a CUDA graph and a
    traced window;
20. the in-kernel-exchange and concat stage kernels against their plain
    versions as stages 1, 2 and 3 on whole blocks (all outputs, strips
    included; <= 1e-5) and as stage 3 with y0 = -2 yc (<= 1e-4), both
    bitwise and also with the general core (``fast=False``) as stage 2;
    then
    three steps of each fused form: in-kernel vs concat interiors
    (<= 1e-6; bitwise predicted, corners are never read), each against
    three classic steps (<= 2e-4, ``tests/test_fused_step.py:52``);
21. the main path: 20 + 1 000 in-kernel steps of TC5 gated, the launches
    checked against 3 x steps, the breakdown (3 routes, 3 stage launches,
    the rest), a traced window, a timed window of the concat form with
    its launches checked, its stages 1-3 bitwise against the plain
    version on the carry after that window, and the kernels' times
    against their bounds; each stage kernel's device time beside its
    earlier design's (``EARLIER_DEVICE_US``) and its step's device time
    as a CUDA graph, the concat step's traced window;
22. 300-step windows of the Cartesian in-kernel and the covariant
    compact steppers in turns (Cartesian, covariant, covariant,
    Cartesian);
23. the neighbour-read stage kernel against its plain version as stages
    1, 2 and 3 on the TC5 state and on the state after 300 steps (whole
    blocks, <= 1e-5) and as stage 3 with y0 = -2 yc (<= 1e-4), bitwise
    required; then three
    neighbour-read steps against three classic steps and three compact
    steps (<= 2e-4: its edge normals take the closed-form metric, not
    the routers' stored one);
24. 20 + 1 000 neighbour-read steps of TC5 gated, the launches checked
    against 3 x steps, the breakdown (3 stage launches, the rest), the
    kernel's times against its bounds, its device time beside its earlier
    design's (``EARLIER_DEVICE_US``) and the step's device time as a CUDA
    graph, and a traced window;
25. the whole-step kernel against its plain version, one step from the
    TC5 state and one from the state after 300 steps (all four carry
    fields, bitwise required), and on 132 blocks (fewer than its 384 work
    items: the metric per item) from the second, then three whole steps
    against three compact steps
    (<= 1e-6, ``tests/test_cov_swe.py:533``'s budget; bitwise
    predicted);
26. 20 + 1 000 whole steps of TC5 gated, the launches checked against
    the steps, the kernel's time against two bounds (the carry read and
    written once; the compact stepper's three stages' bytes) and beside
    its earlier design's (``EARLIER_DEVICE_US``), the step's device time
    as a CUDA graph, and a traced window;
27. 300-step windows of the compact, neighbour-read and whole-step
    steppers in turns (compact, nbr, mega, mega, nbr, compact);
28. the interior kernel (B5) in one launch over the six faces' ghost-free
    cores (the face tier's operands and group table: two groups of
    three), on the TC5 state and on the state after 300 steps: bitwise
    equal to its stacked plain version and to each face's per-block plain
    version; its probe, phase 15's: its distance from a float64
    evaluation of its plain version, in units of the face's tendency, no
    larger than B4's on the same cells plus 5e-5;
29. B5 + the torch band against B4's one-face form, on all six faces,
    from both states: bitwise required (the twin of
    ``tests/test_overlap_exchange.py:55``); B4's stacked form (the face
    tier's serialized launch, views of the tier's exchanged ``q``, two
    groups of three) against its stacked plain version and each face's
    one-face plain call, and its one-face form against its plain version,
    from both states: bitwise required;
30. the block kernel (B6) in one launch over all 24 blocks of the
    (6, 2, 2) split, and B5 over their cores (eight groups of three),
    against their stacked and per-block plain versions, from both states,
    the operands from the block tier's own exchange: bitwise required;
31. each of the four tier paths, 3 steps from the TC5 state: against the
    single-device classic step (<= 2e-4 of max,
    ``tests/test_shard_cov.py:57-59``), mass drift < 2e-6; overlapped
    against serialized on each tier (<= 1e-6,
    ``tests/test_overlap_exchange.py:157``; bitwise expected), block
    against face (<= 2e-4, ``tests/cov_block_worker.py:70``);
32. each tier path's main run: 5 + 100 steps gated as phase 4, the
    kernel launches checked (B4, B5 and B6: 3 x steps, one launch per
    RK stage over all ranks; the other two counters 0), steps/s, a traced
    window for the busy share, and the time of one exchange and one
    permutation;
33. the kernel records of B5 (a stacked launch on each tier) and B6, each
    beside its earlier design's launches per RK stage
    (``EARLIER_DEVICE_US``), B4's stacked form beside its earlier
    one-face launches per RK stage, the face tier's per-stage kernels (B4
    against B5 + band), and each tier step's device time as a CUDA
    graph;
34. (after phase 14, on the Galewsky jet) B14 in its three modes (full,
    nofill, nolap) against its plain version, as stage 1 and stage 2,
    from the Galewsky state and after 3 in-stage steps, at nu4 = 1e14
    and with phase 13's probe: bitwise required, and full bitwise equal
    to B7's kernel B;
35. the bisection's main path, ``nu4_bisect.run`` at 1 000 iterations:
    each chain's wall and device microseconds per iteration, its
    launches checked against its windows (the in-stage pair's and
    B14's counters), and B14's time per mode against its bound and
    beside its earlier design's (``EARLIER_DEVICE_US``);
36. the port's ``utils.profiling`` on the compact TC5 stepper:
    ``steady_state_rate`` over 200- and 1 000-step windows with the
    ``Roofline`` report of ``analytic_cov_step_cost(384)``, a
    ``StepTimer`` p50, and ``integrate_with_metrics`` over 200 steps with
    total mass and total energy every 20 steps, its carry bitwise
    ``integrate``'s.

It prints a JSON line of the kernels, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result, without a CUDA device or without the rest of the repository.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

STEP_DT = 75.0
N = 384
WARM_STEPS = 20
TIMED_STEPS = 1000
PROFILED_STEPS = 50
# Per cell per stage (jaxstream/utils/profiling.py: 137 for PLR-MC).
FLOPS_PER_CELL = 137
# Per cell of the del^4 filter, counted from its plain version's ops: 22
# per Laplacian per field (two Laplacians, three fields), 2 per field
# for the damp, 31 for the metric terms the kernel shares between them
# (a square root or a division counts as one).
FILTER_FLOPS_PER_CELL = 169
# The re-fused stage 1: the filter, then the stage.
REFUSED_FLOPS_PER_CELL = FILTER_FLOPS_PER_CELL + FLOPS_PER_CELL
# Kernel A: the stage, a Laplacian per field, the Laplacian's metric
# terms; kernel B: a Laplacian and the damp per field, the metric terms.
A_FLOPS_PER_CELL = FLOPS_PER_CELL + 3 * 22 + 31
B_FLOPS_PER_CELL = 3 * 24 + 31
KERNEL_TOL = 1e-5
# Device microseconds per launch at C384 (CUDA graph) of the stage and
# filter kernels in their earlier tile-per-block design (one 32 x 16 tile
# of one face per block), measured by this script on an NVIDIA H100 80GB
# HBM3 at 700 W: the log compares the faces-in-block kernels with them.
# The sharded tiers' RHS kernels in their earlier design (one launch per
# rank and RK stage, one 32 x 16 tile per block), per rank's launch: B5 on
# a face-tier rank (n = 384) and on a block-tier rank (n = 192), B6 on a
# block-tier rank (the same card and run); the log compares one stacked
# launch over all ranks with the ranks' launches together.  The
# whole-step kernel (B12) and the RHS kernel of whole faces (B4) in their
# tile-per-block design: one step, six faces, and one face-tier rank's
# one-face launch (the same card; B4's one-face form in a later run).  The
# Cartesian in-kernel stage (B11) and the in-stage del^4 kernel A (B7 A) in
# their tile-per-block design, per launch (the same card and run as B1's).
# The extended-carry stage (B8) and the neighbour-read stage (B13) in
# their tile-per-block design, per launch (the same card and run as B1's).
# The Cartesian RHS (B9) and concat stage (B10) in their tile-per-block
# design, per launch (the same card and run as B1's).  The re-fused stage
# (B3), the in-stage kernel B (B7 B) and B's three ablated modes (B14) in
# their tile-per-block design, per launch (the same card, a run of this
# script before the faces-in-block kernels came).
EARLIER_DEVICE_US = {"cov_stage_compact": 60.06, "cov_nu4_filter": 62.94,
                     "cov_rhs_interior face rank": 12.43,
                     "cov_rhs_interior block rank": 9.94,
                     "cov_rhs_local block rank": 9.60,
                     "cov_step_mega": 260.62, "cov_rhs": 49.34,
                     "cov_rhs face rank": 12.95,
                     "swe_stage_inkernel": 70.96, "cov_stage_nu4_a": 70.58,
                     "cov_stage_inkernel": 62.82, "cov_stage_nbr": 65.76,
                     "swe_rhs": 54.06, "swe_stage": 56.96,
                     "cov_stage_refused_nu4": 115.66,
                     "cov_stage_nu4_b": 39.62,
                     "cov_stage_nu4_b_ablated full": 39.97,
                     "cov_stage_nu4_b_ablated nofill": 23.65,
                     "cov_stage_nu4_b_ablated nolap": 35.62}
# Steps captured in one CUDA graph for a step's device time.
GRAPH_STEPS = 20
# ptxas's (registers, static shared bytes, spill-store bytes) per kernel
# function of every library, in the order ptxas compiled them (nvcc of
# CUDA 12.8), as the faces-in-block redesigns left them (cov_stage_nu4:
# kernel B's NoLap, NoFill and Full instantiations, then kernel A; the
# dynamic shared memory is not in these lines).  The log says whether
# each still builds to the same.
EARLIER_PTXAS = {
    "cov_stage": [(80, 0, 0)],
    "cov_nu4_filter": [(80, 0, 16)],
    "cov_rhs": [(80, 0, 0)],
    "cov_rhs_interior": [(79, 0, 0)],
    "cov_rhs_local": [(79, 0, 0)],
    "cov_stage_refused_nu4": [(80, 0, 16)],
    "cov_stage_nu4": [(80, 0, 0), (80, 0, 0), (80, 0, 20), (80, 0, 0)],
    "cov_stage_inkernel": [(80, 0, 0)],
    "cov_stage_nbr": [(80, 0, 0)],
    "cov_step_mega": [(80, 0, 60)],
    "swe_rhs": [(80, 0, 12)],
    "swe_stage": [(80, 0, 20), (80, 0, 0)],
    "swe_stage_inkernel": [(80, 0, 0), (80, 0, 0)],
}
# The tendency alone is ill-conditioned in float32 (its flux differences
# cancel): two f32 evaluations differ by ~1e-5 of its max.
TENDENCY_TOL = 1e-4
FUSED_VS_CLASSIC_TOL = 2e-4
# Galewsky: bench.py::bench_galewsky's configuration and day-6 run.
GAL_DT = 60.0
GAL_NU4 = 1.0e14
GAL_DAY6_STEPS = 8640
STAGE_TIMED_STEPS = 500
PAIRED_STEPS = 300
# The filter's increment probe: lap(lap q) in float32 cancels; the plain
# version at f32 against its float64 evaluation measured up to 2.2e-6 of
# the probe's max at C8-C48 on the CPU (tests/test_torch_nu4.py).
PROBE_TOL = 1e-4
PROBE_MARGIN = 1e3
SPLIT_VS_CLASSIC_TOL = 2e-3
# The JAX package's damp-scale budget for two del^4 placements
# (tests/test_cov_swe.py:495): refused vs split and stage vs split.
DAMP_SCALE_TOL = 2e-3
DAMP_SCALE_MASS_TOL = 1e-5
# In-stage vs classic del^4 (tests/test_cov_swe.py:463).
STAGE_VS_CLASSIC_TOL = 5e-4
# The kernel-backed classic rhs vs the torch one (tests/test_cov_swe.py:172).
PALLAS_VS_JNP_TOL = 5e-5
CLASSIC_WARM_STEPS = 5
CLASSIC_STEPS = 300
# Extended vs compact carry: the same arithmetic (bitwise predicted).
EXT_VS_COMPACT_TOL = 1e-6
# The Cartesian kernels, per cell per launch, counted from the plain
# versions' operations (a square root or a division counts as one): the
# RHS through the general basis (four basis evaluations per cell, the
# PLR flux, the band, the tendency) and the stage through the fast core
# (the same stencils through the closed forms, plus the RK combine).
# The JAX package's Cartesian RHS kernel (make_swe_rhs_pallas, interpret
# mode) against a float64 evaluation of its jnp rhs, TC5 at C384: max
# abs diff / max of each tendency, from `python
# tests/test_torch_swe_cartesian.py 384` (float32 on the CPU).  Its
# closed-form float32 metric puts it farther from float64 than the jnp
# path (h 7.4702e-5 there); phase 19 holds the port's kernel to it.
REF_KERNEL_F64_DIST = {"h": 1.2265e-4, "v": 1.0309e-3}
SWE_RHS_FLOPS_PER_CELL = 470
SWE_STAGE_FLOPS_PER_CELL = 380
# In-kernel vs concat fused Cartesian steps: the same interiors (bitwise
# predicted: the two differ only in the ghost corners, never read).
INKERNEL_VS_CONCAT_TOL = 1e-6
CART_CONCAT_STEPS = 500
# The router-free covariant steppers: the states the kernels are checked
# on after the TC5 state, and the whole-step stepper against the compact
# one (tests/test_cov_swe.py:533's budget; bitwise predicted).
ROUTER_FREE_CHECK_STEPS = 300
MEGA_VS_COMPACT_TOL = 1e-6
# The whole-step kernel on a grid of fewer blocks than its 384 work items
# (phase 25): one block per SM.
MEGA_FEW_BLOCKS = 132
# The sharded covariant tiers on virtual ranks: the JAX package's budgets
# against the single-device classic step (tests/test_shard_cov.py:57-59)
# and for mass (:84), overlapped vs serialized
# (tests/test_overlap_exchange.py:157), block vs face
# (tests/cov_block_worker.py:70).
TIER_VS_CLASSIC_TOL = 2e-4
TIER_MASS_TOL = 2e-6
OVERLAP_TOL = 1e-6
BLOCK_VS_FACE_TOL = 2e-4
TIER_WARM_STEPS = 5
TIER_TIMED_STEPS = 100
TIER_PROFILED_STEPS = 3
# The step-budget bisection (jaxstream_torch.experiments.nu4_bisect):
# its two windows are BISECT_ITERS / 4 and BISECT_ITERS iterations.
BISECT_ITERS = 1000
# Kernel B14 per cell: full and nofill as B (a Laplacian and the damp
# per field, the metric terms); nolap the damp alone.
B14_FLOPS_PER_CELL = {"full": B_FLOPS_PER_CELL, "nofill": B_FLOPS_PER_CELL,
                      "nolap": 3 * 2}
# Phase 36: steady_state_rate's windows, StepTimer's samples, and the
# metric stream of integrate_with_metrics.
RATE_WINDOWS = (200, 1000)
TIMER_REPS = 20
METRIC_STEPS = 200
METRIC_EVERY = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_usage(build_log: str) -> list:
    """``(function, registers, static shared bytes, spill-store bytes)`` of
    each kernel function in an ``nvcc -Xptxas -v`` log, in the order
    ptxas compiled them."""
    out = []
    for fn, body in re.findall(r"Compiling entry function '([^']+)'(.*?)"
                               r"(?=Compiling entry function|\Z)",
                               build_log, re.S):
        m = re.search(r"Used (\d+) registers[^\n]*?(?:, (\d+) bytes smem)?\n",
                      body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        if m:
            out.append((fn, int(m.group(1)), int(m.group(2) or 0),
                        int(spill.group(1)) if spill else 0))
    return out


def stamp(t_start: float, label: str) -> None:
    """Log the script's elapsed wall time at the start of a path."""
    log(f"[{time.perf_counter() - t_start:.1f} s] {label}")


def rel_err(ref: torch.Tensor, x: torch.Tensor) -> float:
    ref, x = ref.double(), x.double()
    return float((ref - x).abs().max() / (ref.abs().max() + 1e-300))


def device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call of ``fn()`` over ``reps`` calls
    replayed as a CUDA graph (``profiling.device_seconds``; NaN where the
    calls cannot be captured)."""
    from jaxstream_torch.utils.profiling import device_seconds

    busy = device_seconds(lambda: [fn() for _ in range(reps)])
    return busy / reps * 1e3 if busy else float("nan")


def event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(args, outs, n: int, flops_per_cell: int,
             cells: int | None = None) -> tuple:
    """Least time of one launch: bytes (each input read once, each output
    written once; a tuple of tensors counts each) over the memory rate,
    flops over the f32 rate for ``cells`` output cells (default: six
    n x n faces); the rates are ``jaxstream_torch.utils.profiling``'s
    H100 roof."""
    from jaxstream_torch.utils.profiling import H100_SXM5

    flat = [t for a in list(args) + list(outs)
            for t in (a if isinstance(a, tuple) else (a,))]
    moved = sum(t.numel() * t.element_size() for t in flat)
    cells = 6 * n * n if cells is None else cells
    t_bytes = moved / (H100_SXM5.hbm_gbps * 1e9) * 1e3
    t_ops = flops_per_cell * cells / (H100_SXM5.peak_tflops * 1e12) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), moved


def check_kernel(label: str, call, ref, args, names, tol: float, count,
                 exact: bool = False):
    """Launch ``call(*args)`` once and hold each output against the plain
    version ``ref(*args)`` (<= ``tol`` of its max; ``exact``: also bitwise
    equal); ``count()`` reads the kernel's launch counter, which must move
    by one.  Returns the largest absolute difference."""
    before = count()
    out = call(*args)
    torch.cuda.synchronize()
    if count() != before + 1:
        raise RuntimeError(f"{label} did not count its launch")
    expect = ref(*args)
    errs = {nm: rel_err(r, x) for nm, r, x in zip(names, expect, out)}
    max_abs = max(float((r - x).abs().max()) for r, x in zip(expect, out))
    finite = all(bool(torch.isfinite(x).all()) for x in out)
    bitwise = all(torch.equal(r, x) for r, x in zip(expect, out))
    log(f"{label}: max rel diff "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {tol:g}); finite={finite} bitwise={bitwise}"
        + f"; max |out0| {float(out[0].abs().max()):.4e}")
    if not finite or max(errs.values()) > tol or (exact and not bitwise):
        raise RuntimeError(f"kernel disagrees with plain ({label})")
    return max_abs


def probe_scale(q, out) -> float:
    """The factor on nu4 that makes the filter term PROBE_MARGIN x the
    state for the field where it is weakest (``out`` from a float64
    evaluation), and the increments ``max|dq|/max|q|`` per field."""
    incr = [float((a.double() - b).abs().max() / a.double().abs().max())
            for a, b in zip(q, out)]
    return PROBE_MARGIN / min(incr), incr


def f64_spread(ref, args, names) -> str:
    """The plain version at f32 against its float64 evaluation."""
    f32 = ref(*args)
    f64 = ref(*[a.double() for a in args])
    return ", ".join(f"{k} {rel_err(r, x):.3e}"
                     for k, r, x in zip(names, f64, f32))


def device_busy(run, nsteps: int, step_us: float, card: str,
                names: tuple) -> None:
    """Trace ``run()`` (``nsteps`` steps) with ``torch.profiler`` and log
    the device's busy share of an untraced ``step_us`` step, and each
    named kernel's device time per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / nsteps
    if busy <= 0.0:
        log("device busy share: not measured (the profiler saw no device "
            "time)")
        return
    per_kernel = {nm: sum(e.self_device_time_total for e in rows
                          if nm in e.key) / nsteps for nm in names}
    per = ", ".join(f"{nm} {us:.1f}" for nm, us in per_kernel.items())
    kernels = sum(e.count for e in rows) / nsteps
    log(f"device (torch.profiler, {nsteps} traced steps): busy "
        f"{busy:.1f} us/step = {busy / step_us:.1%} of the untraced "
        f"{step_us:.1f} us step (idle {1 - busy / step_us:.1%}); us/step: "
        f"{per}; {kernels:.0f} kernels/step; card {card}")


def timed_window(label: str, step, y, t, nsteps: int, card: str):
    """Integrate ``nsteps`` steps on the host clock; returns the carry,
    the time and the step's microseconds."""
    from jaxstream_torch.stepping import integrate

    t0 = time.perf_counter()
    y, t = integrate(step, y, t, nsteps, GAL_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not bool(torch.isfinite(y["h"]).all()):
        raise RuntimeError(f"{label}: state not finite after the timed "
                           "window")
    steps_s = nsteps / wall
    log(f"main path C{N} {label} dt={GAL_DT:g}: {nsteps} steps in "
        f"{wall:.3f} s -> {steps_s:.1f} steps/s, {1e6 / steps_s:.1f} "
        f"us/step, {steps_s * GAL_DT / 86400.0:.4f} sim-days/s; card {card}")
    return y, t, 1e6 / steps_s


def paired_rates(runs: dict, t, nsteps: int, card: str) -> None:
    """Steps/s of steppers in turns A, B, ..., ..., B, A over ``nsteps``
    steps each; ``runs`` maps each name to its stepper and its carry.
    The host's speed drifts within a call, so only windows taken in turns
    compare two steppers; each is compared with the first."""
    from jaxstream_torch.stepping import integrate

    names = list(runs)
    turns = names + names[::-1]
    rates = {k: [] for k in names}
    for name in turns:
        step, y = runs[name]
        t0 = time.perf_counter()
        integrate(step, y, t, nsteps, GAL_DT)
        torch.cuda.synchronize()
        rates[name].append(nsteps / (time.perf_counter() - t0))
    mean = {k: sum(v) / len(v) for k, v in rates.items()}
    first = names[0]
    log(f"paired windows ({nsteps} steps each, in turns "
        f"{', '.join(turns)}): "
        + "; ".join(f"{k} " + ", ".join(f"{r:.1f}" for r in rates[k])
                    + " steps/s" for k in names)
        + "; " + ", ".join(f"{k}/{first} {mean[k] / mean[first]:.3f}"
                           for k in names[1:]) + f"; card {card}")


def stacked_read(args) -> list:
    """The tensors a stacked launch of B5 or B6 reads: its args with the
    group table (a ``RankGroups``) as its table and rows."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        else:
            out += [a.table, a.xr, a.xfr, a.yc, a.yfc]
    return out


def time_form(label: str, call, ref, args, flops_per_cell: int, card: str,
              cells: int | None = None, read=None) -> tuple:
    """Time one form of a kernel (``call(*args)``) and its plain version,
    and log them against the bound of the launch, which reads ``read``
    (default: all of ``args``) and computes ``cells`` output cells.
    Returns ``(ms, plain_ms, bound_ms, bound_by, device_ms)``."""
    k_ms = event_ms(lambda: call(*args), 200)
    d_ms = device_ms(lambda: call(*args))
    p_ms = event_ms(lambda: ref(*args), 10)
    bound, by, nbytes = bound_ms(args if read is None else read,
                                 call(*args), N, flops_per_cell, cells)
    log(f"{label} kernel: {k_ms * 1e3:.2f} us/launch (device "
        f"{d_ms * 1e3:.2f}), bound {bound * 1e3:.2f} us ({by}, "
        f"{nbytes / 1e6:.2f} MB, {flops_per_cell} flops/cell), "
        f"{bound / k_ms:.1%} of bound (device {bound / d_ms:.1%}), "
        f"{nbytes / (k_ms * 1e-3) / 1e12:.2f} TB/s; plain "
        f"{p_ms * 1e3:.1f} us; card {card}")
    return k_ms, p_ms, bound, by, d_ms


def record(name: str, source: str, replaces: str, launches: int,
           max_abs: float, timed) -> dict:
    """The kernels-line record of ``timed`` (:func:`time_form`'s results,
    averaged over the forms)."""
    mean = lambda k: sum(t[k] for t in timed) / len(timed)
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": mean(0),
        "plain_ms": mean(1),
        "bound_ms": mean(2),
        "bound_by": ("bytes" if all(t[3] == "bytes" for t in timed)
                     else "operations"),
        "library_ms": None,
    }


def step_device_us(step, y, t, dt: float) -> float:
    """Device microseconds per step of ``step`` from the carry ``y``:
    GRAPH_STEPS steps captured as one CUDA graph and replayed
    (``profiling.device_seconds``); NaN where they cannot be captured."""
    from jaxstream_torch.stepping import integrate
    from jaxstream_torch.utils.profiling import device_seconds

    busy = device_seconds(lambda: integrate(step, y, t, GRAPH_STEPS, dt))
    return busy / GRAPH_STEPS * 1e6 if busy else float("nan")


def redesign_line(name: str, timed, per_step: int, label: str,
                  step_us: float | None, card: str, ranks: int = 1) -> float:
    """Log a redesigned kernel's device time per launch (CUDA graph; the
    mean of :func:`time_form`'s forms in ``timed``) beside its earlier
    design's (``ranks`` launches of ``EARLIER_DEVICE_US[name]`` where one
    stacked launch replaces one per rank), its bound, and the device time
    of the step that launches it ``per_step`` times (``step_us`` None: no
    model step launches it; ``label`` names its harness).  Returns the
    device microseconds per launch."""
    dev_us = sum(t[4] for t in timed) / len(timed) * 1e3
    bound_us = sum(t[2] for t in timed) / len(timed) * 1e3
    old = ranks * EARLIER_DEVICE_US[name]
    was = (f"{ranks} launches x {EARLIER_DEVICE_US[name]:.2f} = {old:.2f}"
           if ranks > 1 else f"{old:.2f}")
    step = (f"{label} step: device {step_us:.2f} us/step as a CUDA graph "
            f"of {GRAPH_STEPS} steps, {per_step} launch(es) = "
            f"{per_step * dev_us:.2f} us of it" if step_us is not None
            else f"launched by {label}, no model step")
    log(f"{name}: device {dev_us:.2f} us/launch as a CUDA graph (earlier "
        f"design: {was}; x{dev_us / old:.3f}); bound {bound_us:.2f} us, "
        f"{bound_us / dev_us:.1%} of it; {step}; card {card}")
    return dev_us


def kernel_record(name: str, source: str, replaces: str, launches: int,
                  max_abs: float, forms, flops_per_cell: int, card: str):
    """Time a kernel and its plain version at each of ``forms`` (label,
    call, reference, args[, output cells]) and return the kernels-line
    record."""
    return record(name, source, replaces, launches, max_abs,
                  [time_form(label, call, ref, args, flops_per_cell, card,
                             *cells)
                   for label, call, ref, args, *cells in forms])


def tc5_gate(label: str, grid, s0, h_int, days: float) -> None:
    """``bench.py::bench_tc5``'s gate on the interior height ``h_int``:
    finite, 3000 < h < 6500 m, mass drift from ``s0`` < 1e-3."""
    from jaxstream_torch.utils.diagnostics import total_mass

    h = h_int.double()
    area = grid.interior(grid.area).double()
    mass0 = float(torch.sum(area * s0["h"].double()))
    drift = abs(float(torch.sum(area * h)) - mass0) / mass0
    finite = bool(torch.isfinite(h).all())
    hmin, hmax = float(h.min()), float(h.max())
    gate = finite and 3000.0 < hmin and hmax < 6500.0 and drift < 1e-3
    log(f"gate C{N} TC5 ({label}) after {days:.2f} d: finite={finite} "
        f"h_range=[{hmin:.1f}, {hmax:.1f}] (in (3000, 6500)) "
        f"mass_drift={drift:.3e} (<1e-3) total_mass="
        f"{float(total_mass(grid, h_int)):.6e} -> "
        f"{'passed' if gate else 'FAILED'}")
    if not gate:
        raise RuntimeError(f"TC5 gate failed ({label})")


class Galewsky:
    """The C384 Galewsky configuration: grid, model (nu4 = 1e14), initial
    state and carry, and its day-6 gate."""

    def __init__(self):
        from jaxstream_torch.config import (EARTH_GRAVITY, EARTH_OMEGA,
                                            EARTH_RADIUS)
        from jaxstream_torch.geometry.cubed_sphere import build_grid
        from jaxstream_torch.models.shallow_water_cov import (
            CovariantShallowWater)
        from jaxstream_torch.physics.initial_conditions import galewsky

        t0 = time.perf_counter()
        self.grid = build_grid(N, halo=2, radius=EARTH_RADIUS,
                               dtype=torch.float32)
        h_ext, v_ext = galewsky(self.grid, EARTH_GRAVITY, EARTH_OMEGA)
        self.model = CovariantShallowWater(self.grid, gravity=EARTH_GRAVITY,
                                           omega=EARTH_OMEGA, nu4=GAL_NU4)
        self.s0 = self.model.initial_state(h_ext, v_ext)
        self.y0 = self.model.compact_state(self.s0)
        self.area = self.grid.interior(self.grid.area).double()
        self.mass0 = float(torch.sum(self.area * self.s0["h"].double()))
        torch.cuda.synchronize()
        log(f"setup: C{N} grid, Galewsky, model (nu4 {GAL_NU4:g}) in "
            f"{time.perf_counter() - t0:.2f} s on {self.grid.device}")

    def drift(self, h) -> float:
        return abs(float(torch.sum(self.area * h.double())) - self.mass0) \
            / self.mass0

    def gate(self, label: str, y, t: float, extra: str) -> None:
        """``bench_galewsky``'s day-6 gate on the carry ``y``."""
        from jaxstream_torch.ops.fv import vorticity_cov

        grid = self.grid
        h = y["h"].double()
        drift = self.drift(h)
        zeta = vorticity_cov(grid, self.model._fill_u(y["u"])).double()
        lat = grid.interior(grid.lat)
        z_n = float(zeta.abs()[lat > 0.2].max())
        z_s = float(zeta.abs()[lat < -0.2].max())
        finite = bool(torch.isfinite(h).all())
        hmin, hmax = float(h.min()), float(h.max())
        ok = (finite and 8500.0 < hmin and hmax < 10800.0 and drift < 1e-3
              and 5e-5 < z_n < 5e-4 and z_s < 5e-6)
        log(f"gate Galewsky C{N} nu4 ({label}) day {t / 86400.0:g}: "
            f"finite={finite} h_range=[{hmin:.1f}, {hmax:.1f}] (in (8500, "
            f"10800)) mass_drift={drift:.3e} (<1e-3) max|zeta| N={z_n:.3e} "
            f"(in (5e-5, 5e-4)) S={z_s:.3e} (<5e-6); {extra} -> "
            f"{'passed' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError(f"Galewsky day-6 gate failed ({label})")

    def compare(self, label: str, ref, y, tol: float,
                mass_tol: float | None = None) -> None:
        """Hold the carry ``y`` against ``ref`` (<= ``tol`` of max in h
        and u) and, where ``mass_tol`` is given, its mass drift."""
        errs = {k: rel_err(ref[k], y[k]) for k in ("h", "u")}
        line = (f"{label} C{N}, 3 steps: max rel diff h {errs['h']:.3e}, "
                f"u {errs['u']:.3e} (tol {tol:g})")
        bad = max(errs.values()) > tol
        if mass_tol is not None:
            drift = self.drift(y["h"])
            line += f"; mass drift {drift:.3e} (tol {mass_tol:g})"
            bad = bad or drift > mass_tol
        log(line)
        if bad:
            raise RuntimeError(f"{label}: outside its budget")


def galewsky_path(card: str, gal: Galewsky):
    """Phases 6-9: the Galewsky jet with the split del^4 filter.  Returns
    the filter kernel's record for the kernels line and the split carry
    after 3 steps (the yardstick of phases 11 and 13)."""
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.stepping import integrate

    Stage, Filter = swe_cov.CovStageCompact, swe_cov.CovNu4Filter
    grid, model, s0, y0 = gal.grid, gal.model, gal.s0, gal.y0
    step = model.make_fused_step(GAL_DT)

    # ---- 6. filter kernel vs plain, on the state after one step ----------
    route, filt = step.route, step.filter
    y1 = step(y0, 0.0)
    args = (y1["h"], y1["u"]) + route(y1["strips_sn"], y1["strips_we"])
    # At nu4 = 1e14, dt = 60 the filter moves q by a small share of q, so
    # agreement of the outputs says little of lap(lap q).  The probe
    # scales nu4 until damp*max|l2| is PROBE_MARGIN x max|q| for every
    # field: its outputs are the filter term.
    exact = filt.reference(*[a.double() for a in args])
    scale, incr = probe_scale((args[0], args[1][0], args[1][1]),
                              (exact[0], exact[1][0], exact[1][1]))
    probe = swe_cov.make_cov_nu4_filter(grid, GAL_NU4 * scale, filt.dt_eff)
    log(f"filter increment at nu4 {GAL_NU4:g}, dt {GAL_DT:g}: max|dq|/max|q| "
        f"h {incr[0]:.3e}, u_a {incr[1]:.3e}, u_b {incr[2]:.3e}; probe nu4 "
        f"{probe.nu4:.4e}")
    names = ("h", "u", "strips_sn", "strips_we")
    count = lambda: Filter.launches
    max_abs = max(
        check_kernel(f"filter kernel vs plain C{N} filter", filt,
                     filt.reference, args, names, KERNEL_TOL, count,
                     exact=True),
        check_kernel(f"filter kernel vs plain C{N} probe (filter term "
                     "alone)", probe, probe.reference, args, names,
                     PROBE_TOL, count, exact=True))
    log("filter probe, plain f32 vs f64: "
        + f64_spread(probe.reference, args, names))

    # ---- 7. split vs classic del^4, 3 steps --------------------------------
    ysplit, _ = integrate(step, y0, 0.0, 3, GAL_DT)
    yc, _ = integrate(model.make_step(GAL_DT), s0, 0.0, 3, GAL_DT)
    gal.compare("split vs classic del^4", yc, ysplit, SPLIT_VS_CLASSIC_TOL)
    del yc

    # ---- 8. main path: the jet to day 6, gated as bench_galewsky ----------
    Stage.launches = 0
    Filter.launches = 0
    t0 = time.perf_counter()
    y, t = integrate(step, y0, 0.0, GAL_DAY6_STEPS, GAL_DT)
    torch.cuda.synchronize()
    wall6 = time.perf_counter() - t0
    launches = (Stage.launches, Filter.launches)
    if launches != (3 * GAL_DAY6_STEPS, GAL_DAY6_STEPS):
        raise RuntimeError(f"launches (stage, filter) {launches} != "
                           f"(3 x, 1 x) {GAL_DAY6_STEPS} steps")
    gal.gate("split", y, t,
             f"launches stage {launches[0]} = 3 x {GAL_DAY6_STEPS}, filter "
             f"{launches[1]} = {GAL_DAY6_STEPS}; {GAL_DAY6_STEPS} steps in "
             f"{wall6:.2f} s")

    # ---- 9. timed window, breakdown, filter times, traced window --------
    y, t, step_us = timed_window("Galewsky nu4 (split)", step, y, t,
                                 TIMED_STEPS, card)
    gsn, gwe = route(y["strips_sn"], y["strips_we"])
    fargs = (y["h"], y["u"], gsn, gwe)
    a1 = (y["h"], y["u"], gsn, gwe, model.b_ext)
    a2 = (y["h"], y["u"], y["h"], y["u"], gsn, gwe, model.b_ext)
    st1, st2, st3 = step.stages
    stage_us = 1e3 * sum(event_ms(lambda: st(*a), 200)
                         for st, a in ((st1, a1), (st2, a2), (st3, a2)))
    r_ms = event_ms(lambda: route(y["strips_sn"], y["strips_we"]), 200)
    max_abs = max(max_abs, check_kernel(
        f"filter kernel vs plain C{N} filter, day 6 + {TIMED_STEPS} steps",
        filt, filt.reference, fargs, names, KERNEL_TOL, count, exact=True))
    timed = [time_form("filter", filt, filt.reference, fargs,
                       FILTER_FLOPS_PER_CELL, card)]
    frecord = record(
        "cov_nu4_filter", "jaxstream_torch/csrc/cov_nu4_filter.cu",
        "jaxstream/ops/pallas/swe_cov.py:2544", launches[1], max_abs, timed)
    k_us = frecord["ms"] * 1e3
    other = step_us - stage_us - (4 * r_ms * 1e3 + k_us)
    log(f"Galewsky step {step_us:.1f} us = routers 4 x {r_ms * 1e3:.2f} us + "
        f"stage kernels {stage_us:.1f} us + filter {k_us:.2f} us + "
        f"{other:.1f} us other; card {card}")
    redesign_line("cov_nu4_filter", timed, 1, "split Galewsky",
                  step_device_us(step, y, t, GAL_DT), card)
    device_busy(lambda: integrate(step, y, t, PROFILED_STEPS, GAL_DT),
                PROFILED_STEPS, step_us, card,
                ("cov_stage_kernel", "cov_nu4_filter_kernel"))
    return frecord, ysplit


def refused_path(card: str, gal: Galewsky, ysplit) -> dict:
    """Phases 10-12: the Galewsky jet on the re-fused del^4 stepper.
    Returns the re-fused kernel's record for the kernels line."""
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.stepping import integrate

    Stage, Refused = swe_cov.CovStageCompact, swe_cov.CovStageRefusedNu4
    grid, model, y0 = gal.grid, gal.model, gal.y0
    step = model.make_fused_step(GAL_DT, nu4_mode="refused")
    route, st1f = step.route, step.stage1f

    # ---- 10. re-fused kernel vs plain, on the state after one step -------
    y1 = step(y0, 0.0)
    args = ((y1["h"], y1["u"]) + route(y1["strips_sn"], y1["strips_we"])
            + (model.b_ext,))
    exact = st1f.reference(*[a.double() for a in args])
    scale, incr = probe_scale((args[0], args[1][0], args[1][1]),
                              (exact[2], exact[3][0], exact[3][1]))
    probe = swe_cov.make_cov_stage_refused_nu4(
        grid, model.gravity, model.omega, GAL_DT, GAL_NU4 * scale)
    log(f"re-fused filter increment at nu4 {GAL_NU4:g}, dt {GAL_DT:g}: "
        f"max|dq|/max|q| h {incr[0]:.3e}, u_a {incr[1]:.3e}, u_b "
        f"{incr[2]:.3e}; probe nu4 {probe.nu4:.4e}")
    names = ("h1", "u1", "h0f", "u0f", "strips_sn", "strips_we")
    count = lambda: Refused.launches
    max_abs = max(
        check_kernel(f"re-fused kernel vs plain C{N}", st1f, st1f.reference,
                     args, names, KERNEL_TOL, count, exact=True),
        check_kernel(f"re-fused kernel vs plain C{N} probe (h0f, u0f the "
                     "filter term)", probe, probe.reference, args, names,
                     PROBE_TOL, count, exact=True))
    log("re-fused probe, plain f32 vs f64: "
        + f64_spread(probe.reference, args, names))
    # TC5: its mountain's orography (the Galewsky jet's is zero) feeds the
    # Bernoulli band's b.
    tmodel, tstep, ty = tc5_nu4_step(grid, "refused")
    targs = ((ty["h"], ty["u"]) + tstep.route(ty["strips_sn"],
                                              ty["strips_we"])
             + (tmodel.b_ext,))
    max_abs = max(max_abs, check_kernel(
        f"re-fused kernel vs plain C{N}, TC5 (orography) after one re-fused "
        "step", tstep.stage1f, tstep.stage1f.reference, targs, names,
        KERNEL_TOL, count, exact=True))
    del tmodel, tstep, ty, targs

    # ---- 11. re-fused vs split, 3 steps -----------------------------------
    yr, _ = integrate(step, y0, 0.0, 3, GAL_DT)
    gal.compare("re-fused vs split del^4", ysplit, yr, DAMP_SCALE_TOL,
                DAMP_SCALE_MASS_TOL)

    # ---- 12. main path: day 6 on the re-fused stepper, timed window -------
    Stage.launches = 0
    Refused.launches = 0
    t0 = time.perf_counter()
    y, t = integrate(step, y0, 0.0, GAL_DAY6_STEPS, GAL_DT)
    torch.cuda.synchronize()
    wall6 = time.perf_counter() - t0
    launches = (Refused.launches, Stage.launches)
    if launches != (GAL_DAY6_STEPS, 2 * GAL_DAY6_STEPS):
        raise RuntimeError(f"launches (re-fused, stage) {launches} != "
                           f"(1 x, 2 x) {GAL_DAY6_STEPS} steps")
    gal.gate("re-fused", y, t,
             f"launches re-fused {launches[0]} = {GAL_DAY6_STEPS}, stage "
             f"{launches[1]} = 2 x {GAL_DAY6_STEPS}; {GAL_DAY6_STEPS} steps "
             f"in {wall6:.2f} s")
    y, t, step_us = timed_window("Galewsky nu4 (re-fused)", step, y, t,
                                 TIMED_STEPS, card)
    gsn, gwe = route(y["strips_sn"], y["strips_we"])
    a1 = (y["h"], y["u"], gsn, gwe, model.b_ext)
    a2 = (y["h"], y["u"], y["h"], y["u"], gsn, gwe, model.b_ext)
    st2, st3 = step.stages
    stage_us = 1e3 * sum(event_ms(lambda: st(*a2), 200) for st in (st2, st3))
    r_ms = event_ms(lambda: route(y["strips_sn"], y["strips_we"]), 200)
    max_abs = max(max_abs, check_kernel(
        f"re-fused kernel vs plain C{N}, day 6 + {TIMED_STEPS} steps", st1f,
        st1f.reference, a1, names, KERNEL_TOL, count, exact=True))
    timed = [time_form("re-fused stage 1", st1f, st1f.reference, a1,
                       REFUSED_FLOPS_PER_CELL, card)]
    rec = record("cov_stage_refused_nu4",
                 "jaxstream_torch/csrc/cov_stage_refused_nu4.cu",
                 "jaxstream/ops/pallas/swe_cov.py:2843", launches[0],
                 max_abs, timed)
    k_us = rec["ms"] * 1e3
    other = step_us - stage_us - (3 * r_ms * 1e3 + k_us)
    log(f"re-fused step {step_us:.1f} us = routers 3 x {r_ms * 1e3:.2f} us + "
        f"re-fused kernel {k_us:.2f} us + stage kernels {stage_us:.1f} us + "
        f"{other:.1f} us other; card {card}")
    redesign_line("cov_stage_refused_nu4", timed, 1, "re-fused Galewsky",
                  step_device_us(step, y, t, GAL_DT), card)
    device_busy(lambda: integrate(step, y, t, PROFILED_STEPS, GAL_DT),
                PROFILED_STEPS, step_us, card,
                ("cov_stage_kernel", "cov_stage_refused_nu4_kernel"))
    paired_rates({"split": (model.make_fused_step(GAL_DT), y),
                  "re-fused": (step, y)}, t, PAIRED_STEPS, card)
    return rec


def stage_path(card: str, gal: Galewsky, ysplit) -> list:
    """Phases 13-14: the in-stage del^4 kernel pair.  Returns the records
    of kernels A and B for the kernels line."""
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.stepping import integrate

    Pair = swe_cov.CovStageNu4
    model, s0, y0 = gal.model, gal.s0, gal.y0
    step = model.make_fused_step(GAL_DT, nu4_mode="stage")
    route = step.route

    # ---- 13. A and B vs plain, as stage 1 and stage 2; parity --------------
    gsn, gwe = route(y0["strips_sn"], y0["strips_we"])
    a_names = ("h_adv", "u_adv", "l1h", "l1u", "strips_sn", "strips_we")
    count_a = lambda: Pair.launches_a
    err_a = []
    for st in step.stages[:2]:
        form = "stage 2" if st.with_y0 else "stage 1"
        args = (y0["h"], y0["u"], gsn, gwe, model.b_ext)
        if st.with_y0:
            args = (y0["h"], y0["u"]) + args
        err_a.append(check_kernel(f"kernel A vs plain C{N} {form}",
                                  st.call_a, st.reference_a, args, a_names,
                                  KERNEL_TOL, count_a, exact=True))
    err_b = check_kernel_b(step, model, y0, "Galewsky IC")
    err_a += tc5_kernel_a(model.grid, count_a, a_names)
    ys, _ = integrate(step, y0, 0.0, 3, GAL_DT)
    yc, _ = integrate(model.make_step(GAL_DT), s0, 0.0, 3, GAL_DT)
    gal.compare("in-stage vs classic del^4", yc, ys, STAGE_VS_CLASSIC_TOL)
    gal.compare("in-stage vs split del^4", ysplit, ys, DAMP_SCALE_TOL,
                DAMP_SCALE_MASS_TOL)
    del yc
    err_b += check_kernel_b(step, model, ys, "after 3 in-stage steps")

    # ---- 14. main path: a timed in-stage window, breakdown ---------------
    Pair.launches_a = 0
    Pair.launches_b = 0
    y, t, step_us = timed_window("Galewsky nu4 (in-stage)", step, ys,
                                 3 * GAL_DT, STAGE_TIMED_STEPS, card)
    launches = (Pair.launches_a, Pair.launches_b)
    if launches != (3 * STAGE_TIMED_STEPS,) * 2:
        raise RuntimeError(f"launches (A, B) {launches} != 3 x "
                           f"{STAGE_TIMED_STEPS} steps each")
    log(f"in-stage launches: A {launches[0]}, B {launches[1]} = 3 x "
        f"{STAGE_TIMED_STEPS} each")
    gsn, gwe = route(y["strips_sn"], y["strips_we"])
    st1, st2, st3 = step.stages
    a1 = (y["h"], y["u"], gsn, gwe, model.b_ext)
    a2 = (y["h"], y["u"]) + a1
    out_a = st1.call_a(*a1)
    bargs = tuple(out_a[:4]) + route(out_a[4], out_a[5])
    timed_a = [time_form(label, call, ref, a, A_FLOPS_PER_CELL, card)
               for label, call, ref, a in (
                   ("A stage 1", st1.call_a, st1.reference_a, a1),
                   ("A stage 2", st2.call_a, st2.reference_a, a2),
                   ("A stage 3", st3.call_a, st3.reference_a, a2))]
    rec_a = record("cov_stage_nu4_a", "jaxstream_torch/csrc/cov_stage_nu4.cu",
                   "jaxstream/ops/pallas/swe_cov.py:2392", launches[0],
                   max(err_a), timed_a)
    timed_b = [time_form("B stage 1", st1.call_b, st1.reference_b, bargs,
                         B_FLOPS_PER_CELL, card)]
    rec_b = record("cov_stage_nu4_b", "jaxstream_torch/csrc/cov_stage_nu4.cu",
                   "jaxstream/ops/pallas/swe_cov.py:2415", launches[1],
                   max(err_b), timed_b)
    r_ms = event_ms(lambda: route(y["strips_sn"], y["strips_we"]), 200)
    a_us, b_us = 3e3 * rec_a["ms"], 3e3 * rec_b["ms"]
    other = step_us - (6 * r_ms * 1e3 + a_us + b_us)
    log(f"in-stage step {step_us:.1f} us = routers 6 x {r_ms * 1e3:.2f} us "
        f"+ A 3 x {rec_a['ms'] * 1e3:.2f} us + B 3 x {rec_b['ms'] * 1e3:.2f}"
        f" us + {other:.1f} us other; card {card}")
    dev_step = step_device_us(step, y, t, GAL_DT)
    redesign_line("cov_stage_nu4_a", timed_a, 3, "in-stage Galewsky",
                  dev_step, card)
    redesign_line("cov_stage_nu4_b", timed_b, 3, "in-stage Galewsky",
                  dev_step, card)
    return [rec_a, rec_b]


def check_kernel_b(step, model, y, label: str) -> list:
    """Phase 13: kernel B bitwise against its plain version as stages 1
    and 2 on kernel A's plain outputs from the carry ``y`` (and the routed
    ghosts of their strips), with its probe (nu4 scaled until the output
    is the filter term).  Returns the largest absolute differences."""
    from jaxstream_torch.ops.cuda import swe_cov

    route = step.route
    gsn, gwe = route(y["strips_sn"], y["strips_we"])
    names = ("h", "u", "strips_sn", "strips_we")
    count = lambda: swe_cov.CovStageNu4.launches_b
    errs = []
    for st in step.stages[:2]:
        form = "stage 2" if st.with_y0 else "stage 1"
        args = (y["h"], y["u"], gsn, gwe, model.b_ext)
        if st.with_y0:
            args = (y["h"], y["u"]) + args
        out_a = st.reference_a(*args)
        bargs = tuple(out_a[:4]) + route(out_a[4], out_a[5])
        exact = st.reference_b(*[a.double() for a in bargs])
        scale, _ = probe_scale((bargs[0], bargs[1][0], bargs[1][1]),
                               (exact[0], exact[1][0], exact[1][1]))
        probe = swe_cov.CovStageNu4(
            st.n, st.halo, st.dalpha, st.radius, st.gravity, st.omega,
            st.dt, st.a, st.b, st.nu4 * scale, device=st.device)
        errs.append(check_kernel(f"kernel B vs plain C{N} {form}, {label}",
                                 st.call_b, st.reference_b, bargs, names,
                                 KERNEL_TOL, count, exact=True))
        errs.append(check_kernel(
            f"kernel B vs plain C{N} {form}, {label}, probe (the filter "
            f"term, nu4 {probe.nu4:.4e})", probe.call_b, probe.reference_b,
            bargs, names, PROBE_TOL, count, exact=True))
        if not st.with_y0 and label == "Galewsky IC":
            log("kernel B probe, plain f32 vs f64: "
                + f64_spread(probe.reference_b, bargs, names))
    return errs


def tc5_nu4_step(grid, nu4_mode: str) -> tuple:
    """TC5 (its mountain orography; the Galewsky jet's is zero) at nu4 =
    1e14 and dt = 75 s: the model, its ``nu4_mode`` stepper and the carry
    after one step of it."""
    from jaxstream_torch.config import EARTH_GRAVITY, EARTH_OMEGA
    from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
    from jaxstream_torch.physics.initial_conditions import williamson_tc5

    h, v, b = williamson_tc5(grid, EARTH_GRAVITY, EARTH_OMEGA)
    model = CovariantShallowWater(grid, gravity=EARTH_GRAVITY,
                                  omega=EARTH_OMEGA, b_ext=b, nu4=GAL_NU4)
    step = model.make_fused_step(STEP_DT, nu4_mode=nu4_mode)
    return model, step, step(model.compact_state(model.initial_state(h, v)),
                             0.0)


def tc5_kernel_a(grid, count_a, names) -> list:
    """Phase 13 on TC5: kernel A bitwise against its plain version as
    stages 1 and 2 on the state after one in-stage step at nu4 = 1e14.
    Returns the largest absolute differences."""
    model, step, y = tc5_nu4_step(grid, "stage")
    gsn, gwe = step.route(y["strips_sn"], y["strips_we"])
    errs = []
    for st in step.stages[:2]:
        args = (y["h"], y["u"], gsn, gwe, model.b_ext)
        if st.with_y0:
            args = (y["h"], y["u"]) + args
        form = "stage 2" if st.with_y0 else "stage 1"
        errs.append(check_kernel(
            f"kernel A vs plain C{N} {form}, TC5 (orography) after one "
            "in-stage step", st.call_a, st.reference_a, args, names,
            KERNEL_TOL, count_a, exact=True))
    return errs


def b14_record(max_abs: float, launches: int, forms, card: str) -> dict:
    """Time B14 and its plain version in each mode of ``forms`` (mode,
    kernel, args), against each mode's bound (nofill reads no routed
    ghosts; nolap does the damp alone), and return its record."""
    timed = [time_form(f"B14 {mode}", b, b.reference, args,
                       B14_FLOPS_PER_CELL[mode], card,
                       read=args[:4] if mode == "nofill" else None)
             for mode, b, args in forms]
    for (mode, _, _), t in zip(forms, timed):
        redesign_line(f"cov_stage_nu4_b_ablated {mode}", [t], 0,
                      "the step-budget bisection", None, card)
    return record("cov_stage_nu4_b_ablated",
                  "jaxstream_torch/csrc/cov_stage_nu4.cu",
                  "experiments/nu4_bisect.py:190", launches, max_abs, timed)


def bisect_path(card: str, gal: Galewsky) -> dict:
    """Phases 34-35: the step-budget bisection's ablated kernel B (B14)
    and its harness.  Returns B14's record for the kernels line."""
    from jaxstream_torch.experiments import nu4_bisect as nb
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.stepping import integrate

    Pair, B14 = swe_cov.CovStageNu4, nb.Nu4BisectB
    model, y0 = gal.model, gal.y0
    step = model.make_fused_step(GAL_DT, nu4_mode="stage")
    route = step.route

    # ---- 34. B14 vs plain in each mode: two states, stages 1 and 2 --------
    names = ("h", "u", "strips_sn", "strips_we")
    count = lambda: B14.launches
    y3, _ = integrate(step, y0, 0.0, 3, GAL_DT)
    max_abs = 0.0
    for label, y in (("Galewsky IC", y0), ("after 3 in-stage steps", y3)):
        gsn, gwe = route(y["strips_sn"], y["strips_we"])
        for st in step.stages[:2]:
            form = "stage 2" if st.with_y0 else "stage 1"
            args = (y["h"], y["u"], gsn, gwe, model.b_ext)
            if st.with_y0:
                args = (y["h"], y["u"]) + args
            out_a = st.reference_a(*args)
            bargs = tuple(out_a[:4]) + route(out_a[4], out_a[5])
            exact = st.reference_b(*[a.double() for a in bargs])
            scale, _ = probe_scale((bargs[0], bargs[1][0], bargs[1][1]),
                                   (exact[0], exact[1][0], exact[1][1]))
            probe = swe_cov.CovStageNu4(
                st.n, st.halo, st.dalpha, st.radius, st.gravity, st.omega,
                st.dt, st.a, st.b, st.nu4 * scale, device=st.device)
            for s, tag in ((st, ""), (probe, f" probe (nu4 {probe.nu4:.4e})")):
                for mode in nb.MODES:
                    b = B14(s, mode)
                    max_abs = max(max_abs, check_bitwise(
                        f"B14 {mode} vs plain C{N} {form}, {label}{tag}", b,
                        b.reference, bargs, names, count))
                full = B14(s, "full")(*bargs)
                if not all(torch.equal(x, r)
                           for x, r in zip(full, s.call_b(*bargs))):
                    raise RuntimeError(f"B14 full is not B7's B ({form}, "
                                       f"{label}{tag})")
    log("B14 full = B7's kernel B bitwise on both states, stages 1 and 2, "
        "probes included")

    # ---- 35. main path: the bisection's chains, launches checked ---------
    small, big = BISECT_ITERS // 4, BISECT_ITERS
    windows = 2 * (small + big)
    B14.launches = 0
    Pair.launches_a = 0
    Pair.launches_b = 0
    t0 = time.perf_counter()
    res = nb.run(N, BISECT_ITERS)
    wall = time.perf_counter() - t0
    launches = B14.launches
    expect = {"step": {"A": 3 * windows, "B": 3 * windows, "B14": 0},
              "stage A+r+B+r": {"A": windows, "B": windows, "B14": 0},
              "A + route": {"A": windows, "B": 0, "B14": 0},
              "B": {"A": 0, "B": windows, "B14": 0},
              "route": {"A": 0, "B": 0, "B14": 0}}
    expect.update({f"B[{m}]": {"A": 0, "B": 0, "B14": windows}
                   for m in nb.MODES})
    for name, c in res["chains"].items():
        if c["launches"] != expect[name]:
            raise RuntimeError(f"bisection chain {name}: launches "
                               f"{c['launches']} != {expect[name]}")
        if c["device_us"] is None or not c["device_us"] > 0.0:
            raise RuntimeError(f"bisection chain {name}: no device time")
        log(f"bisection C{N} {name}: wall {c['wall_us']:.2f} us/iter, "
            f"device {c['device_us']:.2f} us/iter ({res['device_iters']} "
            f"iters as a CUDA graph); launches {c['launches']} over 2 x "
            f"({small} + {big}) iters; card {card}")
    # Each mode's chain also runs its device window twice from the host
    # (warm-up, graph capture); the graph's replays launch nothing.
    expect_b14 = len(nb.MODES) * (windows + 2 * res["device_iters"])
    if launches != expect_b14:
        raise RuntimeError(f"B14 launches {launches} != {expect_b14}")
    log(f"bisection C{N}, {BISECT_ITERS} iters: {wall:.1f} s; B14 launches "
        f"{launches} = 3 modes x ({windows} + 2 x {res['device_iters']}); "
        f"card {card}")
    gsn, gwe = route(y0["strips_sn"], y0["strips_we"])
    st1 = step.stages[0]
    out_a = st1.call_a(y0["h"], y0["u"], gsn, gwe, model.b_ext)
    bargs = tuple(out_a[:4]) + route(out_a[4], out_a[5])
    return b14_record(max_abs, launches,
                      [(m, B14(st1, m), bargs) for m in nb.MODES], card)


def metric_vector(model):
    """``metric_fn(y, t)``: total mass and total energy of a covariant
    carry (its wind made Cartesian by ``model.to_cartesian``)."""
    from jaxstream_torch.utils.diagnostics import total_energy, total_mass

    g = model.grid
    b_int = g.interior(model.b_ext)

    def metrics(y, t):
        return torch.stack([total_mass(g, y["h"]),
                            total_energy(g, y["h"], model.to_cartesian(y),
                                         model.gravity, b_int)])
    return metrics


def profiling_path(card: str, model, step, y, t) -> None:
    """Phase 36: the port's profiling module on the compact TC5 stepper."""
    from jaxstream_torch.stepping import integrate, integrate_with_metrics
    from jaxstream_torch.utils import profiling

    # ---- 36. steady-state rate, roofline, step timer, metric stream ------
    k1, k2 = RATE_WINDOWS
    rate, y = profiling.steady_state_rate(
        lambda y, k: integrate(step, y, t, k, STEP_DT)[0], y, k1, k2)
    cost = profiling.analytic_cov_step_cost(N)
    log(f"steady_state_rate C{N} TC5 compact ({k1} and {k2} steps): "
        f"{rate:.1f} steps/s, {1e6 / rate:.1f} us/step; "
        f"{profiling.roofline(cost, 1.0 / rate).report()}; card {card}")
    timer = profiling.StepTimer(discard=1)
    timer.time(step, y, t, reps=TIMER_REPS)
    st = timer.stats()
    log(f"StepTimer C{N} TC5 compact ({st['n']} steps, each synchronized): "
        f"p50 {st['p50_s'] * 1e6:.1f} us, p90 {st['p90_s'] * 1e6:.1f}, min "
        f"{st['min_s'] * 1e6:.1f}; {timer.sim_days_per_sec(STEP_DT):.3f} "
        f"sim-days/s at p50; card {card}")
    ref, _ = integrate(step, y, t, METRIC_STEPS, STEP_DT)
    n_samples = METRIC_STEPS // METRIC_EVERY
    t0 = time.perf_counter()
    ym, _, buf = integrate_with_metrics(
        step, y, t, METRIC_STEPS, STEP_DT, metric_vector(model),
        METRIC_EVERY, n_samples, 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bitwise = all(torch.equal(ref[k], ym[k]) for k in ref)
    samples = buf.double().cpu()
    finite = bool(torch.isfinite(samples).all())
    mass_drift = float((samples[0] - samples[0, 0]).abs().max()
                       / samples[0, 0])
    energy_drift = float((samples[1] - samples[1, 0]).abs().max()
                         / samples[1, 0])
    log(f"integrate_with_metrics C{N} TC5 compact, {METRIC_STEPS} steps, "
        f"mass and energy every {METRIC_EVERY}: carry bitwise integrate's: "
        f"{bitwise}; {n_samples} samples finite: {finite}; mass drift "
        f"{mass_drift:.3e}, energy drift {energy_drift:.3e} over the "
        f"samples; {METRIC_STEPS / wall:.1f} steps/s with the stream; "
        f"card {card}")
    if not (bitwise and finite and tuple(buf.shape) == (2, n_samples)):
        raise RuntimeError("integrate_with_metrics: carry not integrate's "
                           "or samples not finite")


def pallas_rhs_path(card: str, grid, model, b_ext, s0) -> tuple:
    """Phases 15-16: TC5 on the classic SSPRK3 path with
    ``backend='pallas'``, whose ``rhs`` launches the unfused RHS kernel
    once per call.  Returns the kernel's timed six-face form, its launches
    in the timed window and its largest difference from the plain version,
    for its record in the kernels line (with the face tier's form)."""
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.stepping import integrate

    Rhs = swe_cov.CovRhs
    pal = CovariantShallowWater(grid, gravity=model.gravity,
                                omega=model.omega, b_ext=b_ext,
                                backend="pallas")
    kern = pal._pallas_rhs.kernel

    # ---- 15. RHS kernel vs plain; kernel-backed vs torch classic rhs ----
    h_ext, u_ext = pal.fill(s0["h"]), pal._fill_u(s0["u"])
    sym = pal._pallas_rhs.sym(u_ext)
    loop = swe_cov.sym_edge_normals(grid, u_ext)
    same = all(torch.equal(a, b) for a, b in zip(sym, loop))
    log(f"sym_edge_normals C{N}, vectorized vs loop form: bitwise={same}")
    if not same:
        raise RuntimeError("the vectorized sym rows differ from the loop "
                           "form")
    args = (kern.fz[:, None], h_ext, u_ext, pal.b_ext) + sym
    count = lambda: Rhs.launches
    # The outputs are the tendencies themselves: no base hides them.
    max_abs = check_kernel(f"RHS kernel vs plain C{N} (six faces)", kern,
                           kern.reference, args, ("dh", "du"), KERNEL_TOL,
                           count)
    one = swe_cov.make_cov_rhs_pallas(grid, model.gravity, model.omega,
                                      n_faces=1, external_sym=True)
    f1 = (kern.fz[2:3, None], h_ext[2:3], u_ext[:, 2:3].contiguous(),
          pal.b_ext[2:3], sym[0][2:3], sym[1][2:3])
    max_abs = max(max_abs, check_kernel(
        f"RHS kernel vs plain C{N} (one face, external sym rows)", one,
        one.reference, f1, ("dh", "du"), KERNEL_TOL, count))
    # The tendency's float32 roundoff grows with n (its flux and gradient
    # differences cancel): the JAX package's 5e-5 budget is set at C16.
    # At C384 both float32 rhs are held against a float64 evaluation of
    # the torch rhs on the same inputs; the kernel-backed one may be no
    # farther from it than the torch one, plus that budget.
    g64 = build_grid(N, halo=grid.halo, radius=grid.radius,
                     dtype=torch.float64)
    m64 = CovariantShallowWater(g64, gravity=model.gravity,
                                omega=model.omega, b_ext=b_ext.double())
    d64 = m64.rhs({k: v.double() for k, v in s0.items()}, 0.0)
    d_pal, d_jnp = pal.rhs(s0, 0.0), model.rhs(s0, 0.0)
    bad = False
    for k in ("h", "u"):
        e_pal, e_jnp = rel_err(d64[k], d_pal[k]), rel_err(d64[k], d_jnp[k])
        log(f"classic rhs C{N} {k}: backend pallas vs jnp max rel diff "
            f"{rel_err(d_jnp[k], d_pal[k]):.3e}; vs float64: pallas "
            f"{e_pal:.3e}, jnp {e_jnp:.3e} (pallas <= jnp + "
            f"{PALLAS_VS_JNP_TOL:g})")
        bad = bad or e_pal > e_jnp + PALLAS_VS_JNP_TOL
    del g64, m64, d64
    if bad:
        raise RuntimeError("kernel-backed rhs farther from float64 than the "
                           "torch rhs")

    # ---- 16. main path: a timed classic window, launches, gate ----------
    step = pal.make_step(STEP_DT)
    y, t = integrate(step, s0, 0.0, CLASSIC_WARM_STEPS, STEP_DT)
    torch.cuda.synchronize()
    Rhs.launches = 0
    t0 = time.perf_counter()
    y, t = integrate(step, y, t, CLASSIC_STEPS, STEP_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = Rhs.launches
    if launches != 3 * CLASSIC_STEPS:
        raise RuntimeError(f"RHS launches {launches} != 3 x {CLASSIC_STEPS}"
                           " steps")
    tc5_gate("classic, backend pallas", grid, s0, y["h"],
             t / 86400.0)
    step_us = wall / CLASSIC_STEPS * 1e6
    log(f"main path C{N} TC5 classic (backend pallas) dt={STEP_DT:g}: "
        f"{CLASSIC_STEPS} steps in {wall:.3f} s -> "
        f"{CLASSIC_STEPS / wall:.1f} steps/s, {step_us:.1f} us/step; RHS "
        f"launches {launches} = 3 x {CLASSIC_STEPS}; card {card}")
    h_ext, u_ext = pal.fill(y["h"]), pal._fill_u(y["u"])
    args = (kern.fz[:, None], h_ext, u_ext, pal.b_ext) \
        + pal._pallas_rhs.sym(u_ext)
    max_abs = max(max_abs, check_bitwise(
        f"RHS kernel vs plain C{N} (six faces), after {CLASSIC_STEPS} "
        "classic steps", kern, kern.reference, args, ("dh", "du"), count))
    timed = [time_form("RHS six faces", kern, kern.reference, args,
                       FLOPS_PER_CELL, card)]
    redesign_line("cov_rhs", timed, 3, "classic pallas TC5",
                  step_device_us(step, y, t, STEP_DT), card)
    fill_ms = event_ms(lambda: (pal.fill(y["h"]), pal._fill_u(y["u"])), 50)
    sym_ms = event_ms(lambda: pal._pallas_rhs.sym(u_ext), 50)
    k_us = timed[0][0] * 1e3
    other = step_us - 3e3 * (fill_ms + sym_ms) - 3 * k_us
    log(f"classic step {step_us:.1f} us = 3 x (fills {fill_ms * 1e3:.1f} "
        f"us + sym rows {sym_ms * 1e3:.1f} us + RHS kernel "
        f"{k_us:.2f} us) + {other:.1f} us other (the RK combines); card "
        f"{card}")
    return timed, launches, max_abs


def extended_path(card: str, grid, model, step_c, s0) -> dict:
    """Phases 17-18: TC5 on the extended-carry stepper
    (``make_fused_step(compact=False)``).  Returns the stage kernel's
    record for the kernels line."""
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.stepping import integrate

    Stage = swe_cov.CovStageInkernel
    step = model.make_fused_step(STEP_DT, compact=False)
    route = step.route
    st1, st2, st3 = step.stages
    names = ("h", "u", "strips")
    count = lambda: Stage.launches

    # ---- 17. kernel vs plain on whole blocks, two carries; extended vs
    # compact.  The carries after one step (its ghost ring filled) and
    # after ROUTER_FREE_CHECK_STEPS steps; stages 1-3 and stage 3 with y0 =
    # -2*yc (the interiors g*L(yc) alone), each bitwise.
    ye = model.extend_state(s0, with_strips=True)
    y1 = step(ye, 0.0)
    y300, _ = integrate(step, ye, 0.0, ROUTER_FREE_CHECK_STEPS, STEP_DT)
    max_abs = 0.0
    for label, yk in (("after 1 step", y1),
                      (f"after {ROUTER_FREE_CHECK_STEPS} steps", y300)):
        args1 = (yk["h"], yk["u"], route(yk["strips"]), model.b_ext)
        k1 = st1.reference(*args1)
        gi2 = route(k1[2])
        args2 = (yk["h"], yk["u"], k1[0], k1[1], gi2, model.b_ext)
        args3 = (-2.0 * k1[0], -2.0 * k1[1], k1[0], k1[1], gi2, model.b_ext)
        for what, st, a, tol in (
                ("stage 1", st1, args1, KERNEL_TOL),
                ("stage 2", st2, args2, KERNEL_TOL),
                ("stage 3", st3, args2, KERNEL_TOL),
                ("stage 3, y0=-2yc (interior g*L alone)", st3, args3,
                 TENDENCY_TOL)):
            max_abs = max(max_abs, check_kernel(
                f"extended stage kernel vs plain C{N} {what}, {label}", st,
                st.reference, a, names, tol, count, exact=True))
    del y300, k1, gi2
    yc, _ = integrate(step_c, model.compact_state(s0), 0.0, 3, STEP_DT)
    yx, _ = integrate(step, ye, 0.0, 3, STEP_DT)
    out_x = model.restrict_state(yx)
    ext = model.extend_state(yc)
    strips = swe_cov.pack_strips_cov(ext["h"], ext["u"], grid.n, grid.halo)
    pairs = {"h": (yc["h"], out_x["h"]), "u": (yc["u"], out_x["u"]),
             "strips": (strips, yx["strips"])}
    errs = {k: rel_err(a, b) for k, (a, b) in pairs.items()}
    bitwise = all(torch.equal(a, b) for a, b in pairs.values())
    log(f"extended vs compact C{N}, 3 steps: max rel diff "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {EXT_VS_COMPACT_TOL:g}); bitwise={bitwise}")
    if max(errs.values()) > EXT_VS_COMPACT_TOL:
        raise RuntimeError("extended stepper disagrees with the compact one")
    del yc, yx, ext

    # ---- 18. main path: a timed extended window, launches, gate ---------
    y, t = integrate(step, ye, 0.0, WARM_STEPS, STEP_DT)
    torch.cuda.synchronize()
    Stage.launches = 0
    t0 = time.perf_counter()
    y, t = integrate(step, y, t, TIMED_STEPS, STEP_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = Stage.launches
    if launches != 3 * TIMED_STEPS:
        raise RuntimeError(f"extended stage launches {launches} != 3 x "
                           f"{TIMED_STEPS} steps")
    tc5_gate("extended", grid, s0, model.restrict_state(y)["h"],
             t / 86400.0)
    step_us = wall / TIMED_STEPS * 1e6
    log(f"main path C{N} TC5 extended carry dt={STEP_DT:g}: {TIMED_STEPS} "
        f"steps in {wall:.3f} s -> {TIMED_STEPS / wall:.1f} steps/s, "
        f"{step_us:.1f} us/step, "
        f"{TIMED_STEPS / wall * STEP_DT / 86400.0:.3f} sim-days/s; stage "
        f"launches {launches} = 3 x {TIMED_STEPS}; card {card}")
    gi = route(y["strips"])
    a1 = (y["h"], y["u"], gi, model.b_ext)
    a2 = (y["h"], y["u"]) + a1
    timed = [time_form(label, st, st.reference, a, FLOPS_PER_CELL, card)
             for label, st, a in (("extended stage 1", st1, a1),
                                  ("extended stage 2", st2, a2),
                                  ("extended stage 3", st3, a2))]
    rec = record(
        "cov_stage_inkernel", "jaxstream_torch/csrc/cov_stage_inkernel.cu",
        "jaxstream/ops/pallas/swe_cov.py:1243", launches, max_abs, timed)
    r_ms = event_ms(lambda: route(y["strips"]), 200)
    stages_us = 3e3 * rec["ms"]
    log(f"extended step {step_us:.1f} us = routers 3 x {r_ms * 1e3:.2f} us "
        f"+ stage kernels {stages_us:.1f} us + "
        f"{step_us - stages_us - 3e3 * r_ms:.1f} us other; card {card}")
    redesign_line("cov_stage_inkernel", timed, 3, "extended TC5",
                  step_device_us(step, y, t, STEP_DT), card)
    device_busy(lambda: integrate(step, y, t, PROFILED_STEPS, STEP_DT),
                PROFILED_STEPS, step_us, card, ("cov_stage_inkernel_kernel",))
    paired_rates({"compact": (step_c, model.compact_state(
        model.restrict_state(y))), "extended": (step, y)}, t, PAIRED_STEPS,
        card)
    return rec


def cartesian_rhs_path(card: str, grid, b_ext, s0, ref) -> dict:
    """Phase 19: TC5 on the Cartesian ``ShallowWater``'s classic SSPRK3
    path with ``backend='pallas'``, whose ``rhs`` launches the Cartesian
    RHS kernel once per call; ``ref`` is the torch (``backend='jnp'``)
    model.  Returns the kernel's record for the kernels line."""
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.models.shallow_water import ShallowWater
    from jaxstream_torch.ops.cuda import swe_rhs
    from jaxstream_torch.stepping import integrate

    Rhs = swe_rhs.SweRhs
    pal = ShallowWater(grid, gravity=ref.gravity, omega=ref.omega,
                       b_ext=b_ext, backend="pallas")
    kern = pal._pallas_rhs
    count = lambda: Rhs.launches
    names = ("dh", "dv")

    # ---- 19. RHS kernel vs plain; kernel-backed vs torch classic rhs ----
    args = (pal.fill(s0["h"]), pal.fill(s0["v"]), pal.b_ext)
    max_abs = check_kernel(f"Cartesian RHS kernel vs plain C{N} (TC5 "
                           "state)", kern, kern.reference, args, names,
                           KERNEL_TOL, count, exact=True)
    g64 = build_grid(N, halo=grid.halo, radius=grid.radius,
                     dtype=torch.float64)
    m64 = ShallowWater(g64, gravity=ref.gravity, omega=ref.omega,
                       b_ext=b_ext.double())
    d64 = m64.rhs({k: v.double() for k, v in s0.items()}, 0.0)
    d_pal, d_jnp = pal.rhs(s0, 0.0), ref.rhs(s0, 0.0)
    # As phase 15, with the reference kernel's own distance from float64
    # where it is the larger: the kernel rebuilds the metric in float32
    # (the general basis), the torch rhs reads it stored from float64.
    bad = False
    for k in ("h", "v"):
        e_pal, e_jnp = rel_err(d64[k], d_pal[k]), rel_err(d64[k], d_jnp[k])
        ref_k = REF_KERNEL_F64_DIST[k] if N == 384 else 0.0
        log(f"Cartesian classic rhs C{N} {k}: backend pallas vs jnp max rel "
            f"diff {rel_err(d_jnp[k], d_pal[k]):.3e}; vs float64: pallas "
            f"{e_pal:.4e}, jnp {e_jnp:.4e}, JAX kernel {ref_k:.4e} (pallas "
            f"<= max(jnp, JAX kernel) + {PALLAS_VS_JNP_TOL:g})")
        bad = bad or e_pal > max(e_jnp, ref_k) + PALLAS_VS_JNP_TOL
    del g64, m64, d64
    if bad:
        raise RuntimeError("Cartesian kernel-backed rhs farther from float64 "
                           "than the torch rhs")

    # ---- the classic window: 300 steps, launches, gate, breakdown -------
    step = pal.make_step(STEP_DT)
    y, t = integrate(step, s0, 0.0, CLASSIC_WARM_STEPS, STEP_DT)
    torch.cuda.synchronize()
    Rhs.launches = 0
    t0 = time.perf_counter()
    y, t = integrate(step, y, t, CLASSIC_STEPS, STEP_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = Rhs.launches
    if launches != 3 * CLASSIC_STEPS:
        raise RuntimeError(f"Cartesian RHS launches {launches} != 3 x "
                           f"{CLASSIC_STEPS} steps")
    tc5_gate("Cartesian classic, backend pallas", grid, s0, y["h"],
             t / 86400.0)
    step_us = wall / CLASSIC_STEPS * 1e6
    log(f"main path C{N} TC5 Cartesian classic (backend pallas) "
        f"dt={STEP_DT:g}: {CLASSIC_STEPS} steps in {wall:.3f} s -> "
        f"{CLASSIC_STEPS / wall:.1f} steps/s, {step_us:.1f} us/step; RHS "
        f"launches {launches} = 3 x {CLASSIC_STEPS}; card {card}")
    # The state after the window: its wind has all three components.
    args = (pal.fill(y["h"]), pal.fill(y["v"]), pal.b_ext)
    max_abs = max(max_abs, check_kernel(
        f"Cartesian RHS kernel vs plain C{N} (after {CLASSIC_STEPS} steps)",
        kern, kern.reference, args, names, KERNEL_TOL, count, exact=True))
    timed = [time_form("Cartesian RHS", kern, kern.reference, args,
                       SWE_RHS_FLOPS_PER_CELL, card)]
    rec = record("swe_rhs", "jaxstream_torch/csrc/swe_rhs.cu",
                 "jaxstream/ops/pallas/swe_rhs.py:434", launches, max_abs,
                 timed)
    fill_ms = event_ms(lambda: (pal.fill(y["h"]), pal.fill(y["v"])), 50)
    k_us = rec["ms"] * 1e3
    other = step_us - 3e3 * fill_ms - 3 * k_us
    log(f"Cartesian classic step {step_us:.1f} us = 3 x (fills "
        f"{fill_ms * 1e3:.1f} us + RHS kernel {k_us:.2f} us) + {other:.1f} "
        f"us other (the RK combines); card {card}")
    redesign_line("swe_rhs", timed, 3,
                  "Cartesian classic (backend pallas) TC5",
                  step_device_us(step, y, t, STEP_DT), card)
    device_busy(lambda: integrate(step, y, t, PROFILED_STEPS, STEP_DT),
                PROFILED_STEPS, step_us, card, ("swe_rhs_kernel",))
    return rec


def cartesian_fused_path(card: str, grid, b_ext, s0, ref, cov_step,
                         cov_y) -> list:
    """Phases 20-22: TC5 on the Cartesian ``ShallowWater``'s fused
    steppers (``backend='pallas'``): the in-kernel-exchange stepper (the
    default, the main path of this model) and the concat form; then
    windows in turns against the covariant compact stepper ``cov_step``
    on its carry ``cov_y``.  Returns the two stage kernels' records."""
    from jaxstream_torch.models.shallow_water import ShallowWater
    from jaxstream_torch.ops.cuda import swe_step
    from jaxstream_torch.stepping import integrate

    Ink, Cat = swe_step.SweStageInkernel, swe_step.SweStage
    model = ShallowWater(grid, gravity=ref.gravity, omega=ref.omega,
                         b_ext=b_ext, backend="pallas")
    step = model.make_fused_step(STEP_DT)
    step_c = model.make_fused_step(STEP_DT, in_kernel_exchange=False)
    route, ex = step.route, step_c.exchange
    b = model.b_ext

    # ---- 20. both stage kernels vs plain, stages 1-3 and the probe -------
    ye = model.extend_state(s0, with_strips=True)
    y1 = step(ye, 0.0)             # a carry whose ghost ring is filled
    strips = lambda o: route(*o[2:])
    names = ("h", "v", "sn", "we", "vsn", "vwe")
    count = lambda: Ink.launches
    st1, st2, st3 = step.stages
    a1 = (y1["h"], y1["v"], route(y1["sh_sn"], y1["sh_we"], y1["sv_sn"],
                                  y1["sv_we"]), b)
    k1 = st1.reference(*a1)
    a2 = (y1["h"], y1["v"], k1[0], k1[1], strips(k1), b)
    k2 = st2.reference(*a2)
    a3 = (y1["h"], y1["v"], k2[0], k2[1], strips(k2), b)
    # Stage 3 with y0 = -2*yc: f32(2/3) is exactly 2*f32(1/3), so the
    # interiors are g*L(yc) alone.
    a3p = (-2.0 * k2[0], -2.0 * k2[1], k2[0], k2[1], strips(k2), b)
    max_ink = max(
        check_kernel(f"in-kernel stage kernel vs plain C{N} stage {k + 1}",
                     st, st.reference, a, names, KERNEL_TOL, count,
                     exact=True)
        for k, (st, a) in enumerate(((st1, a1), (st2, a2), (st3, a3))))
    max_ink = max(max_ink, check_kernel(
        f"in-kernel stage kernel vs plain C{N} stage 3, y0=-2yc (interior "
        "g*L alone)", st3, st3.reference, a3p, names, TENDENCY_TOL, count,
        exact=True))
    # The general core (fast=False, rhs_core), stage 2.
    gen = swe_step.make_swe_stage_inkernel(
        grid.n, grid.halo, grid.dalpha, grid.radius, ref.gravity, ref.omega,
        STEP_DT, st2.a, st2.b, fast=False, device=grid.device)
    max_ink = max(max_ink, check_kernel(
        f"in-kernel stage kernel (general core) vs plain C{N} stage 2", gen,
        gen.reference, a2, names, KERNEL_TOL, count, exact=True))
    del gen
    count = lambda: Cat.launches
    c1, c2, c3 = step_c.stages
    h1, v1 = ex(y1["h"]), ex(y1["v"])
    b1 = (h1, v1, b)
    j1 = c1.reference(*b1)
    b2 = (h1, v1, ex(j1[0]), ex(j1[1]), b)
    j2 = c2.reference(*b2)
    b3 = (h1, v1, ex(j2[0]), ex(j2[1]), b)
    b3p = (-2.0 * b3[2], -2.0 * b3[3], b3[2], b3[3], b)
    max_cat = max(
        check_kernel(f"concat stage kernel vs plain C{N} stage {k + 1}", st,
                     st.reference, a, ("h", "v"), KERNEL_TOL, count,
                     exact=True)
        for k, (st, a) in enumerate(((c1, b1), (c2, b2), (c3, b3))))
    max_cat = max(max_cat, check_kernel(
        f"concat stage kernel vs plain C{N} stage 3, y0=-2yc (interior g*L "
        "alone)", c3, c3.reference, b3p, ("h", "v"), TENDENCY_TOL, count,
        exact=True))
    # The general core (fast=False, rhs_core), stage 2.
    gen = swe_step.make_swe_stage_pallas(
        grid.n, grid.halo, grid.dalpha, grid.radius, ref.gravity, ref.omega,
        STEP_DT, c2.a, c2.b, fast=False, device=grid.device)
    max_cat = max(max_cat, check_kernel(
        f"concat stage kernel (general core) vs plain C{N} stage 2", gen,
        gen.reference, b2, ("h", "v"), KERNEL_TOL, count, exact=True))
    del gen
    del k1, k2, j1, j2

    # ---- three steps: in-kernel vs concat, each vs classic ---------------
    yi, _ = integrate(step, ye, 0.0, 3, STEP_DT)
    yk, _ = integrate(step_c, model.extend_state(s0), 0.0, 3, STEP_DT)
    ycl, _ = integrate(ref.make_step(STEP_DT), s0, 0.0, 3, STEP_DT)
    oi, ok = model.restrict_state(yi), model.restrict_state(yk)
    errs = {k: rel_err(ok[k], oi[k]) for k in ("h", "v")}
    bitwise = all(torch.equal(ok[k], oi[k]) for k in ("h", "v"))
    log(f"Cartesian in-kernel vs concat C{N}, 3 steps: max rel diff "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {INKERNEL_VS_CONCAT_TOL:g}); bitwise={bitwise}")
    if max(errs.values()) > INKERNEL_VS_CONCAT_TOL:
        raise RuntimeError("in-kernel and concat fused steps disagree")
    for label, o in (("in-kernel", oi), ("concat", ok)):
        errs = {k: rel_err(ycl[k], o[k]) for k in ("h", "v")}
        log(f"Cartesian fused ({label}) vs classic C{N}, 3 steps: max rel "
            f"diff h {errs['h']:.3e}, v {errs['v']:.3e} (tol "
            f"{FUSED_VS_CLASSIC_TOL:g})")
        if max(errs.values()) > FUSED_VS_CLASSIC_TOL:
            raise RuntimeError(f"Cartesian fused ({label}) step disagrees "
                               "with the classic path")
    del yi, yk, ycl, oi, ok

    # ---- 21. main path: 20 + 1 000 in-kernel steps, launches, gate --------
    Ink.launches = 0
    y, t = integrate(step, ye, 0.0, WARM_STEPS, STEP_DT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, t = integrate(step, y, t, TIMED_STEPS, STEP_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = Ink.launches
    if launches != 3 * (WARM_STEPS + TIMED_STEPS):
        raise RuntimeError(f"in-kernel stage launches {launches} != 3 x "
                           f"{WARM_STEPS + TIMED_STEPS} steps")
    tc5_gate("Cartesian in-kernel", grid, s0, model.restrict_state(y)["h"],
             t / 86400.0)
    step_us = wall / TIMED_STEPS * 1e6
    log(f"main path C{N} TC5 Cartesian in-kernel dt={STEP_DT:g}: "
        f"{TIMED_STEPS} steps in {wall:.3f} s -> {TIMED_STEPS / wall:.1f} "
        f"steps/s, {step_us:.1f} us/step, "
        f"{TIMED_STEPS / wall * STEP_DT / 86400.0:.3f} sim-days/s; stage "
        f"launches {launches} = 3 x {WARM_STEPS + TIMED_STEPS}; card {card}")
    g = route(y["sh_sn"], y["sh_we"], y["sv_sn"], y["sv_we"])
    a1 = (y["h"], y["v"], g, b)
    a2 = (y["h"], y["v"]) + a1
    timed_ink = [time_form(label, st, st.reference, a,
                           SWE_STAGE_FLOPS_PER_CELL, card)
                 for label, st, a in (
                     ("Cartesian in-kernel stage 1", st1, a1),
                     ("Cartesian in-kernel stage 2", st2, a2),
                     ("Cartesian in-kernel stage 3", st3, a2))]
    rec_ink = record("swe_stage_inkernel",
                     "jaxstream_torch/csrc/swe_stage_inkernel.cu",
                     "jaxstream/ops/pallas/swe_step.py:424", launches,
                     max_ink, timed_ink)
    r_ms = event_ms(lambda: route(y["sh_sn"], y["sh_we"], y["sv_sn"],
                                  y["sv_we"]), 200)
    stages_us = 3e3 * rec_ink["ms"]
    log(f"Cartesian in-kernel step {step_us:.1f} us = routes 3 x "
        f"{r_ms * 1e3:.2f} us + stage kernels {stages_us:.1f} us + "
        f"{step_us - stages_us - 3e3 * r_ms:.1f} us other; card {card}")
    redesign_line("swe_stage_inkernel", timed_ink, 3,
                  "Cartesian in-kernel TC5",
                  step_device_us(step, y, t, STEP_DT), card)
    device_busy(lambda: integrate(step, y, t, PROFILED_STEPS, STEP_DT),
                PROFILED_STEPS, step_us, card, ("swe_stage_inkernel_kernel",))

    # The concat form: a timed window from the same state, its launches.
    yk = model.extend_state(model.restrict_state(y))
    Cat.launches = 0
    yk, _ = integrate(step_c, yk, t, WARM_STEPS, STEP_DT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    yk, _ = integrate(step_c, yk, t, CART_CONCAT_STEPS, STEP_DT)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    launches_c = Cat.launches
    if launches_c != 3 * (WARM_STEPS + CART_CONCAT_STEPS):
        raise RuntimeError(f"concat stage launches {launches_c} != 3 x "
                           f"{WARM_STEPS + CART_CONCAT_STEPS} steps")
    tc5_gate("Cartesian concat", grid, s0, model.restrict_state(yk)["h"],
             (t + (WARM_STEPS + CART_CONCAT_STEPS) * STEP_DT) / 86400.0)
    cat_us = wall_c / CART_CONCAT_STEPS * 1e6
    hk, vk = ex(yk["h"]), ex(yk["v"])
    b1 = (hk, vk, b)
    b2 = (hk, vk) + b1
    # The stages on the carry after the window (its wind has all three
    # components and 520 steps of flow).
    max_cat = max([max_cat] + [check_kernel(
        f"concat stage kernel vs plain C{N} stage {k + 1} (after "
        f"{WARM_STEPS + CART_CONCAT_STEPS} concat steps)", st, st.reference,
        a, ("h", "v"), KERNEL_TOL, lambda: Cat.launches, exact=True)
        for k, (st, a) in enumerate(((c1, b1), (c2, b2), (c3, b2)))])
    timed_cat = [time_form(f"Cartesian concat stage {k + 1}", st,
                           st.reference, a, SWE_STAGE_FLOPS_PER_CELL, card)
                 for k, (st, a) in enumerate(((c1, b1), (c2, b2),
                                              (c3, b2)))]
    rec_cat = record("swe_stage", "jaxstream_torch/csrc/swe_stage.cu",
                     "jaxstream/ops/pallas/swe_step.py:147", launches_c,
                     max_cat, timed_cat)
    x_ms = event_ms(lambda: (ex(yk["h"]), ex(yk["v"])), 200)
    k_us = 3e3 * rec_cat["ms"]
    log(f"main path C{N} TC5 Cartesian concat dt={STEP_DT:g}: "
        f"{CART_CONCAT_STEPS} steps in {wall_c:.3f} s -> "
        f"{CART_CONCAT_STEPS / wall_c:.1f} steps/s; step {cat_us:.1f} us = "
        f"exchanges 3 x {x_ms * 1e3:.2f} us + stage kernels {k_us:.1f} us + "
        f"{cat_us - k_us - 3e3 * x_ms:.1f} us other; launches {launches_c} "
        f"= 3 x {WARM_STEPS + CART_CONCAT_STEPS}; card {card}")
    redesign_line("swe_stage", timed_cat, 3, "Cartesian concat TC5",
                  step_device_us(step_c, yk, t, STEP_DT), card)
    device_busy(lambda: integrate(step_c, yk, t, PROFILED_STEPS, STEP_DT),
                PROFILED_STEPS, cat_us, card, ("swe_stage_kernel",))

    # ---- 22. Cartesian in-kernel vs covariant compact, in turns ---------
    paired_rates({"cartesian": (step, y), "covariant": (cov_step, cov_y)},
                 t, PAIRED_STEPS, card)
    return [rec_ink, rec_cat]


def nbr_path(card: str, grid, model, step_c, s0, ref_step) -> tuple:
    """Phases 23-24: TC5 on the neighbour-read stepper
    (``experiments.swe_cov_nbr.make_fused_ssprk3_cov_nbr``).  Returns
    the stage kernel's record and the stepper with its carry."""
    from jaxstream_torch.experiments import swe_cov_nbr
    from jaxstream_torch.stepping import integrate

    Stage = swe_cov_nbr.CovStageNbr
    step = swe_cov_nbr.make_fused_ssprk3_cov_nbr(
        grid, model.gravity, model.omega, STEP_DT, model.b_ext)
    st1, st2, st3 = step.stages
    b = model.b_ext
    count = lambda: Stage.launches

    # ---- 23. kernel vs plain: stages 1-3 on two states, the probe --------
    ye = model.extend_state(s0)
    y300, _ = integrate(step, ye, 0.0, ROUTER_FREE_CHECK_STEPS, STEP_DT)
    max_abs = 0.0
    for label, y in (("TC5 state", ye),
                     (f"after {ROUTER_FREE_CHECK_STEPS} steps", y300)):
        a1 = (y["h"], y["u"], b)
        k1 = st1.reference(*a1)
        a2 = (y["h"], y["u"]) + tuple(k1) + (b,)
        k2 = st2.reference(*a2)
        a3 = (y["h"], y["u"]) + tuple(k2) + (b,)
        for k, (st, a) in enumerate(((st1, a1), (st2, a2), (st3, a3))):
            max_abs = max(max_abs, check_kernel(
                f"nbr stage kernel vs plain C{N} stage {k + 1}, {label}",
                st, st.reference, a, ("h", "u"), KERNEL_TOL, count,
                exact=True))
    # Stage 3 with y0 = -2*yc: the interiors are g*L(yc) alone.
    a3p = (-2.0 * k2[0], -2.0 * k2[1]) + tuple(k2) + (b,)
    max_abs = max(max_abs, check_kernel(
        f"nbr stage kernel vs plain C{N} stage 3, y0=-2yc (interior g*L "
        "alone)", st3, st3.reference, a3p, ("h", "u"), TENDENCY_TOL, count,
        exact=True))
    del y300, k1, k2
    yn, _ = integrate(step, ye, 0.0, 3, STEP_DT)
    out = model.restrict_state(yn)
    yc, _ = integrate(step_c, model.compact_state(s0), 0.0, 3, STEP_DT)
    ycl, _ = integrate(ref_step, s0, 0.0, 3, STEP_DT)
    for label, other in (("classic", ycl), ("compact", yc)):
        errs = {k: rel_err(other[k], out[k]) for k in ("h", "u")}
        log(f"nbr vs {label} C{N}, 3 steps: max rel diff h {errs['h']:.3e}, "
            f"u {errs['u']:.3e} (tol {FUSED_VS_CLASSIC_TOL:g}; the edge "
            "normals' closed-form metric is not the routers' stored one)")
        if max(errs.values()) > FUSED_VS_CLASSIC_TOL:
            raise RuntimeError(f"nbr stepper disagrees with the {label} one")
    del yn, yc, ycl, out

    # ---- 24. main path: 20 + 1 000 nbr steps, launches, gate --------------
    Stage.launches = 0
    y, t = integrate(step, ye, 0.0, WARM_STEPS, STEP_DT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, t = integrate(step, y, t, TIMED_STEPS, STEP_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = Stage.launches
    if launches != 3 * (WARM_STEPS + TIMED_STEPS):
        raise RuntimeError(f"nbr stage launches {launches} != 3 x "
                           f"{WARM_STEPS + TIMED_STEPS} steps")
    tc5_gate("nbr", grid, s0, model.restrict_state(y)["h"], t / 86400.0)
    step_us = wall / TIMED_STEPS * 1e6
    log(f"main path C{N} TC5 nbr dt={STEP_DT:g}: {TIMED_STEPS} steps in "
        f"{wall:.3f} s -> {TIMED_STEPS / wall:.1f} steps/s, {step_us:.1f} "
        f"us/step, {TIMED_STEPS / wall * STEP_DT / 86400.0:.3f} "
        f"sim-days/s; stage launches {launches} = 3 x "
        f"{WARM_STEPS + TIMED_STEPS}; card {card}")
    a1 = (y["h"], y["u"], b)
    a2 = (y["h"], y["u"]) + a1
    timed = [time_form(label, st, st.reference, a, FLOPS_PER_CELL, card)
             for label, st, a in (("nbr stage 1", st1, a1),
                                  ("nbr stage 2", st2, a2),
                                  ("nbr stage 3", st3, a2))]
    rec = record(
        "cov_stage_nbr", "jaxstream_torch/csrc/cov_stage_nbr.cu",
        "jaxstream/experiments/swe_cov_nbr.py:404", launches, max_abs, timed)
    stages_us = 3e3 * rec["ms"]
    log(f"nbr step {step_us:.1f} us = stage kernels 3 x "
        f"{rec['ms'] * 1e3:.2f} us + {step_us - stages_us:.1f} us other "
        f"(no router); card {card}")
    redesign_line("cov_stage_nbr", timed, 3, "nbr TC5",
                  step_device_us(step, y, t, STEP_DT), card)
    device_busy(lambda: integrate(step, y, t, PROFILED_STEPS, STEP_DT),
                PROFILED_STEPS, step_us, card, ("cov_stage_nbr_kernel",))
    return rec, step, y


def mega_path(card: str, grid, model, step_c, s0) -> tuple:
    """Phases 25-26: TC5 on the whole-step stepper
    (``experiments.swe_mega.make_fused_ssprk3_cov_mega``).  Returns the
    kernel's record and the stepper with its carry."""
    from jaxstream_torch.experiments import swe_mega
    from jaxstream_torch.stepping import integrate

    Mega = swe_mega.CovMegaStep
    step = swe_mega.make_fused_ssprk3_cov_mega(
        grid, model.gravity, model.omega, STEP_DT, model.b_ext)
    kern = step.kernel
    b = model.b_ext
    names = ("h", "u", "strips_sn", "strips_we")
    count = lambda: Mega.launches
    carry = lambda y: (y["h"], y["u"], y["strips_sn"], y["strips_we"], b)

    # ---- 25. kernel vs plain on two states; mega vs compact ---------------
    yc0 = model.compact_state(s0)
    y300, _ = integrate(step, yc0, 0.0, ROUTER_FREE_CHECK_STEPS, STEP_DT)
    max_abs = 0.0
    for label, y in (("the TC5 state", yc0),
                     (f"the state after {ROUTER_FREE_CHECK_STEPS} steps",
                      y300)):
        max_abs = max(max_abs, check_bitwise(
            f"mega kernel vs plain C{N}, one step from {label}", kern,
            kern.reference, carry(y), names, count))
    log(f"mega kernel grid: {kern.blocks} blocks of 256 threads "
        "(cooperative, all resident)")
    # A grid of fewer blocks than work items: each block takes ~3 items
    # and recomputes its tiles' metric terms per item.
    few = swe_mega.CovMegaStep(grid, model.gravity, model.omega, STEP_DT,
                               max_blocks=MEGA_FEW_BLOCKS)
    max_abs = max(max_abs, check_bitwise(
        f"mega kernel on {MEGA_FEW_BLOCKS} blocks vs plain C{N}, one step "
        f"from the state after {ROUTER_FREE_CHECK_STEPS} steps", few,
        few.reference, carry(y300), names, count))
    del y300, few
    ym, _ = integrate(step, yc0, 0.0, 3, STEP_DT)
    yc, _ = integrate(step_c, yc0, 0.0, 3, STEP_DT)
    errs = {k: rel_err(yc[k], ym[k]) for k in names}
    bitwise = {k: torch.equal(yc[k], ym[k]) for k in names}
    log(f"mega vs compact C{N}, 3 steps: max rel diff "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {MEGA_VS_COMPACT_TOL:g}); bitwise "
        + ", ".join(f"{k} {v}" for k, v in bitwise.items()))
    if max(errs.values()) > MEGA_VS_COMPACT_TOL:
        raise RuntimeError("mega stepper disagrees with the compact one")
    del ym, yc

    # ---- 26. main path: 20 + 1 000 mega steps, launches, gate -------------
    Mega.launches = 0
    y, t = integrate(step, yc0, 0.0, WARM_STEPS, STEP_DT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, t = integrate(step, y, t, TIMED_STEPS, STEP_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = Mega.launches
    if launches != WARM_STEPS + TIMED_STEPS:
        raise RuntimeError(f"mega launches {launches} != "
                           f"{WARM_STEPS + TIMED_STEPS} steps")
    tc5_gate("mega", grid, s0, y["h"], t / 86400.0)
    step_us = wall / TIMED_STEPS * 1e6
    log(f"main path C{N} TC5 mega dt={STEP_DT:g}: {TIMED_STEPS} steps in "
        f"{wall:.3f} s -> {TIMED_STEPS / wall:.1f} steps/s, {step_us:.1f} "
        f"us/step, {TIMED_STEPS / wall * STEP_DT / 86400.0:.3f} "
        f"sim-days/s; launches {launches} = {WARM_STEPS + TIMED_STEPS}; "
        f"card {card}")
    max_abs = max(max_abs, check_bitwise(
        f"mega kernel vs plain C{N}, one step after "
        f"{WARM_STEPS + TIMED_STEPS} steps", kern, kern.reference, carry(y),
        names, count))
    timed = [time_form("mega step", kern, kern.reference, carry(y),
                       3 * FLOPS_PER_CELL, card)]
    rec = record(
        "cov_step_mega", "jaxstream_torch/csrc/cov_step_mega.cu",
        "jaxstream/experiments/swe_mega.py:344", launches, max_abs, timed)
    redesign_line("cov_step_mega", timed, 1, "mega TC5",
                  step_device_us(step, y, t, STEP_DT), card)
    # The other bound: the bytes of the compact stepper's three stages.
    st1, st2, st3 = step_c.stages
    gsn, gwe = step_c.route(y["strips_sn"], y["strips_we"])
    s1 = (y["h"], y["u"], gsn, gwe, b)
    s2 = (y["h"], y["u"]) + s1
    staged = sum(bound_ms(a, st(*a), N, FLOPS_PER_CELL)[0]
                 for st, a in ((st1, s1), (st2, s2), (st3, s2)))
    k_ms, once = rec["ms"], rec["bound_ms"]
    log(f"mega step {step_us:.1f} us = kernel {k_ms * 1e3:.2f} us + "
        f"{step_us - k_ms * 1e3:.1f} us other; bounds: the carry once "
        f"{once * 1e3:.2f} us ({once / k_ms:.1%}), the compact stages' "
        f"bytes {staged * 1e3:.2f} us ({staged / k_ms:.1%}); card {card}")
    device_busy(lambda: integrate(step, y, t, PROFILED_STEPS, STEP_DT),
                PROFILED_STEPS, step_us, card, ("cov_step_mega_kernel",))
    return rec, step, y


def tier_setup(tiles: int, overlap: bool):
    """The rank mesh of a sharded tier: 6 * tiles^2 virtual ranks on the
    GPU, explicit exchange, ``overlap_exchange`` as given."""
    from jaxstream_torch.parallel.mesh import setup_sharding

    return setup_sharding({"parallelization": {
        "tiles_per_edge": tiles, "num_devices": 6 * tiles * tiles,
        "use_shard_map": True, "overlap_exchange": overlap}})


def tier_operands(model, state, tiles: int):
    """Every rank's operands of the tier's RHS kernels on ``state``,
    through the tier's own exchange, as the tier passes them: ``(ranks, n,
    per-rank B5 args, per-rank B4 (face tier) or B6 (block tier) args, the
    band's batched args, the stacked B5 args, the stacked B4 (face tier)
    or B6 (block tier) args)``.  The stacked launches take the tier's
    group table (``shard_cov.rank_groups``)."""
    from jaxstream_torch.ops.cuda.swe_rhs import coord_rows
    from jaxstream_torch.parallel import shard_cov, shard_cov_block
    from jaxstream_torch.parallel.mesh import shard_state

    setup = tier_setup(tiles, False)
    grid = model.grid
    h = grid.halo
    local = shard_state(setup, state)
    ranks = setup.local_ranks
    q = shard_cov._embed(local["h"], local["u"], h)
    if tiles == 1:
        program = shard_cov.CovShardProgram(grid)
        ex = shard_cov.make_cov_shard_exchange(program, setup.ranks, ranks)
        xr, xfr, yc, yfc, frames = coord_rows(grid.n, h, grid.device)
        fz = frames[:, None, :, 2].contiguous()
        rows = [(xr, xfr, yc, yfc)] * len(ranks)
        b = model.b_ext
    else:
        program = shard_cov_block.CovBlockProgram(grid, tiles)
        ex = shard_cov_block.make_cov_block_exchange(program, setup.ranks,
                                                     ranks)
        t = program.rank_tables(ranks, grid.device)
        fz = t["fz"].contiguous()
        rows = [(t["xr"][r], t["xfr"][r], t["yc"][r], t["yfc"][r])
                for r in range(len(ranks))]
        nl = program.n_loc
        m = nl + 2 * h
        b = torch.stack([
            model.b_ext[f, iy * nl:iy * nl + m, ix * nl:ix * nl + m]
            for f, iy, ix in map(setup.coords, ranks)])
    q, ssn, swe = ex(q)
    n = local["h"].shape[-1]
    I = slice(h, h + n)
    b5, rhs = [], []
    for r in range(len(ranks)):
        xr_, xfr_, yc_, yfc_ = rows[r]
        b5.append((fz[r:r + 1], xr_[:, I].contiguous(),
                   xfr_[:, I].contiguous(), yc_[I].contiguous(),
                   yfc_[I].contiguous(), local["h"][r], local["u"][r],
                   b[r:r + 1, I, I].contiguous()))
        ext = (q[r, 0:1], q[r, 1:3].unsqueeze(1), b[r:r + 1], ssn[r], swe[r])
        rhs.append((fz[r:r + 1],) + ext if tiles == 1
                   else (fz[r:r + 1], xr_, xfr_, yc_, yfc_) + ext)
    band = (fz, *(torch.stack(c) if tiles > 1 else c[0]
                  for c in zip(*rows)),
            q[:, 0], q[:, 1:3].transpose(0, 1), b, ssn[:, 0], swe[:, 0])
    xr_s, xfr_s, yc_s, yfc_s = (torch.stack(c) for c in zip(*rows))
    b5s = (fz, shard_cov.rank_groups(setup, ranks, xr_s[:, :, I],
                                     xfr_s[:, :, I], yc_s[:, I],
                                     yfc_s[:, I]),
           local["h"], local["u"], b[:, None, I, I].contiguous())
    ext = (fz, shard_cov.rank_groups(setup, ranks, xr_s, xfr_s, yc_s, yfc_s),
           q[:, 0:1], q[:, 1:3].unsqueeze(2), b[:, None], ssn, swe)
    return ranks, n, b5, rhs, band, b5s, ext


def check_bitwise(label: str, call, ref, args, names, count) -> float:
    """:func:`check_kernel`, then bitwise equality with the plain version
    required (the kernels are built -fmad=false with its op order)."""
    max_abs = check_kernel(label, call, ref, args, names, KERNEL_TOL, count)
    if max_abs != 0.0:
        raise RuntimeError(f"{label}: not bitwise equal to the plain "
                           f"version (max abs diff {max_abs:.3e})")
    return max_abs


def check_stacked(label: str, kern, args, per_rank):
    """One stacked launch of ``kern`` (B5 or B6) over every rank of
    ``args``, bitwise against the stacked plain version and against each
    rank's per-block plain version (``per_rank``, the same operands one
    rank at a time); the launch counter moves by one.  Returns the largest
    absolute difference (0) and the outputs."""
    max_abs = check_bitwise(label, kern.stacked, kern.stacked_reference,
                            args, ("dh", "du"), lambda: type(kern).launches)
    out = kern.stacked(*args)
    same = [all(torch.equal(x[r], y) for x, y in
                zip(out, kern.reference(*a))) for r, a in enumerate(per_rank)]
    log(f"{label}: per-rank plain versions bitwise on "
        f"{sum(same)} of {len(same)} ranks")
    bad = [r for r, ok in enumerate(same) if not ok]
    if bad:
        raise RuntimeError(f"{label}: ranks {bad} differ from the per-rank "
                           "plain version")
    return max_abs, out


def sharded_paths(card: str, grid, model, s0, y300, t_start) -> list:
    """Phases 28-33: the explicit sharded covariant tiers on virtual
    ranks on the card, the face tier (6 ranks) and the (6, 2, 2) block
    tier (24 ranks), each serialized and overlapped, through
    ``setup_sharding`` and ``make_stepper_for``.  ``y300``: the TC5 state
    after 300 steps.  Returns the records of B5 and B6, and B4's timed
    stacked form, its launches on the face serialized tier and its
    largest difference from the plain version (for B4's record)."""
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.parallel.mesh import shard_state, unshard_state
    from jaxstream_torch.parallel.sharded_model import make_stepper_for
    from jaxstream_torch.stepping import integrate

    Rhs, Core, Local = swe_cov.CovRhs, swe_cov.CovRhsInterior, \
        swe_cov.CovRhsLocal
    consts = (grid.halo, grid.dalpha, grid.radius, model.gravity,
              model.omega)
    face_core = swe_cov.make_cov_rhs_interior_local(N, *consts)
    band = swe_cov.make_cov_rhs_band_local(N, *consts)
    one = swe_cov.make_cov_rhs_pallas(grid, model.gravity, model.omega,
                                      n_faces=1, external_sym=True)
    nl = N // 2
    block_core = swe_cov.make_cov_rhs_interior_local(nl, *consts)
    block_rhs = swe_cov.make_cov_rhs_pallas_local(nl, *consts)
    states = (("TC5 state", s0), (f"after {ROUTER_FREE_CHECK_STEPS} steps",
                                  y300))
    names = ("dh", "du")
    max_b4 = max_b5 = max_b6 = 0.0

    # ---- 28-29. B5 stacked on the six faces; B5 + band vs B4 one-face; ---
    # ---- B4 stacked --------------------------------------------------------
    for label, st in states:
        ranks, n, b5, rhs, bargs, b5s, b4s = tier_operands(model, st, 1)
        err, (dh_c, du_c) = check_stacked(
            f"interior kernel (B5) stacked vs plain C{N}, 6 faces in "
            f"{b5s[1].count} groups, {label}", face_core, b5s, b5)
        max_b5 = max(max_b5, err)
        # The probe, phase 15's: the kernel against a float64 evaluation
        # of its plain version (coordinates in float64 too), in units of
        # the face's whole tendency (the core's own max is small where
        # the flow is near balance), no farther from it than B4's
        # one-face form is on the same cells, plus phase 15's budget.
        # The float32 roundoff of the tendency grows with n (PERF.md), so
        # no fixed bound holds at C384.
        c = slice(grid.halo, N - grid.halo)
        face32 = one(*rhs[0])
        core64 = face_core.reference(*[x.double() for x in b5[0]])
        for k, nm in enumerate(names):
            scale = face32[k].double().abs().max()
            e_b5 = float(((dh_c, du_c)[k][0] - core64[k]).abs().max()
                         / scale)
            e_b4 = float((face32[k][..., c, c] - core64[k]).abs().max()
                         / scale)
            log(f"B5 face 0 {label} {nm}: kernel vs float64 {e_b5:.3e} of "
                f"the face's tendency max; B4 on the same cells {e_b4:.3e}"
                f" (B5 <= B4 + {PALLAS_VS_JNP_TOL:g})")
            if e_b5 > e_b4 + PALLAS_VS_JNP_TOL:
                raise RuntimeError("B5 farther from float64 than B4")
        dh, du = band(*bargs, dh_c[:, 0], du_c[:, :, 0].transpose(0, 1))
        same = []
        for r, a in enumerate(rhs):
            full = one(*a)
            same.append(torch.equal(full[0], dh[r:r + 1])
                        and torch.equal(full[1], du[:, r:r + 1]))
        log(f"B5 + torch band vs B4 one-face form C{N}, {label}: bitwise "
            f"on faces {[r for r, ok in enumerate(same) if ok]} of 0-5")
        if not all(same):
            raise RuntimeError("B5 + band differs from B4's one-face form")
        err, _ = check_stacked(
            f"RHS kernel (B4) stacked vs plain C{N}, 6 faces in "
            f"{b4s[1].count} groups, {label}", one, b4s, rhs)
        max_b4 = max(max_b4, err, check_bitwise(
            f"RHS kernel (B4) one-face form vs plain C{N}, face 0, {label}",
            one, one.reference, rhs[0], names, lambda: Rhs.launches))

    # ---- 30. B6 stacked on all 24 blocks (and B5 on their cores) ---------
    stamp(t_start, "phase 30")
    for label, st in states:
        ranks, n, b5, rhs, _, b5s, b6s = tier_operands(model, st, 2)
        err, _ = check_stacked(
            f"block kernel (B6) stacked vs plain C{N}, 24 blocks in "
            f"{b6s[1].count} groups, {label}", block_rhs, b6s, rhs)
        max_b6 = max(max_b6, err)
        err, _ = check_stacked(
            f"interior kernel (B5) stacked vs plain C{N}, 24 block cores in"
            f" {b5s[1].count} groups, {label}", block_core, b5s, b5)
        max_b5 = max(max_b5, err)
    log(f"B6 block 1, after {ROUTER_FREE_CHECK_STEPS} steps, plain f32 vs "
        f"f64: " + f64_spread(block_rhs.reference, rhs[1], names))

    # ---- 31. the four tier paths, 3 steps: parity and mass ----------------
    stamp(t_start, "phase 31")
    ycl, _ = integrate(model.make_step(STEP_DT), s0, 0.0, 3, STEP_DT)
    area = grid.interior(grid.area).double()
    mass0 = float((area * s0["h"].double()).sum())
    after3 = {}
    for tiles, tier in ((1, "face"), (2, "block")):
        for overlap in (False, True):
            setup = tier_setup(tiles, overlap)
            step = make_stepper_for(model, setup, None, STEP_DT)
            y, _ = integrate(step, shard_state(setup, s0), 0.0, 3, STEP_DT)
            out = after3[(tier, overlap)] = unshard_state(setup, y)
            errs = {k: rel_err(ycl[k], out[k]) for k in ("h", "u")}
            drift = abs(float((area * out["h"].double()).sum()) - mass0) \
                / mass0
            log(f"{tier} tier ({'overlapped' if overlap else 'serialized'}"
                f", {setup.num_devices} virtual ranks) vs classic C{N}, 3 "
                f"steps: max rel diff h {errs['h']:.3e}, u {errs['u']:.3e} "
                f"(tol {TIER_VS_CLASSIC_TOL:g}); mass drift {drift:.3e} "
                f"(tol {TIER_MASS_TOL:g})")
            if max(errs.values()) > TIER_VS_CLASSIC_TOL \
                    or drift > TIER_MASS_TOL:
                raise RuntimeError(f"{tier} tier outside its budget")
    for label, a, b, tol in (
            ("face overlapped vs serialized", ("face", False),
             ("face", True), OVERLAP_TOL),
            ("block overlapped vs serialized", ("block", False),
             ("block", True), OVERLAP_TOL),
            ("block vs face (serialized)", ("face", False),
             ("block", False), BLOCK_VS_FACE_TOL)):
        errs = {k: rel_err(after3[a][k], after3[b][k]) for k in ("h", "u")}
        same = all(torch.equal(after3[a][k], after3[b][k])
                   for k in ("h", "u"))
        log(f"{label} C{N}, 3 steps: max rel diff h {errs['h']:.3e}, u "
            f"{errs['u']:.3e} (tol {tol:g}); bitwise={same}")
        if max(errs.values()) > tol:
            raise RuntimeError(f"{label}: outside its budget")
    del ycl, after3

    # ---- 32. main paths: timed windows, launches, gate, busy share --------
    stamp(t_start, "phase 32")
    # Kernel launches per step: 3 RK stages x one, over all ranks.
    counters = {(1, False): Rhs, (1, True): Core, (2, False): Local,
                (2, True): Core}
    launches = {}
    rates = {}
    tier_runs = {}
    for (tiles, overlap), cls in counters.items():
        tier = ("face" if tiles == 1 else "block") + (
            " overlapped" if overlap else " serialized")
        setup = tier_setup(tiles, overlap)
        step = make_stepper_for(model, setup, None, STEP_DT)
        y, t = integrate(step, shard_state(setup, s0), 0.0,
                         TIER_WARM_STEPS, STEP_DT)
        torch.cuda.synchronize()
        for c in (Rhs, Core, Local):
            c.launches = 0
        t0 = time.perf_counter()
        y, t = integrate(step, y, t, TIER_TIMED_STEPS, STEP_DT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {c.__name__: c.launches for c in (Rhs, Core, Local)}
        want = {c.__name__: (3 * TIER_TIMED_STEPS if c is cls else 0)
                for c in (Rhs, Core, Local)}
        if got != want:
            raise RuntimeError(f"{tier} launches {got} != {want}")
        launches[(tiles, overlap)] = got[cls.__name__]
        tc5_gate(f"{tier} tier", grid, s0, unshard_state(setup, y)["h"],
                 t / 86400.0)
        step_us = wall / TIER_TIMED_STEPS * 1e6
        rates[tier] = TIER_TIMED_STEPS / wall
        tier_runs[tier] = (step, y, t)
        log(f"main path C{N} TC5 {tier} tier ({setup.num_devices} virtual "
            f"ranks) dt={STEP_DT:g}: {TIER_TIMED_STEPS} steps in "
            f"{wall:.3f} s -> {rates[tier]:.1f} steps/s, {step_us:.1f} "
            f"us/step, {rates[tier] * STEP_DT / 86400.0:.4f} sim-days/s; "
            f"{cls.__name__} launches {got[cls.__name__]} = 3 x "
            f"{TIER_TIMED_STEPS}; card {card}")
        device_busy(lambda: integrate(step, y, t, TIER_PROFILED_STEPS,
                                      STEP_DT),
                    TIER_PROFILED_STEPS, step_us, card,
                    ("cov_rhs_kernel", "cov_rhs_interior_kernel",
                     "cov_rhs_local_kernel"))
        if tiles == 1 and not overlap:
            # The Comm layer: one exchange of the tier, and one permutation.
            from jaxstream_torch.parallel import shard_cov

            q = shard_cov._embed(y["h"], y["u"], grid.halo)
            ex = shard_cov.make_cov_shard_exchange(
                shard_cov.CovShardProgram(grid), setup.ranks,
                setup.local_ranks)
            payload = q[:, :, :2, :N].contiguous()
            perm = [(r, (r + 1) % 6) for r in range(6)]
            ex_us = event_ms(lambda: ex(q.clone()), 50) * 1e3
            perm_us = event_ms(
                lambda: setup.ranks.ppermute(payload, perm), 200) * 1e3
            log(f"face tier comm: one 4-stage exchange {ex_us:.1f} us; one "
                f"permutation of (6, 3, 2, {N}) {perm_us:.1f} us; card "
                f"{card}")
        if tiles == 2 and not overlap:
            from jaxstream_torch.parallel import shard_cov, shard_cov_block

            q = shard_cov._embed(y["h"], y["u"], grid.halo)
            ex = shard_cov_block.make_cov_block_exchange(
                shard_cov_block.CovBlockProgram(grid, 2), setup.ranks,
                setup.local_ranks)
            log(f"block tier comm: one exchange (4 shifts + 4 stages) "
                f"{event_ms(lambda: ex(q.clone()), 50) * 1e3:.1f} us; card "
                f"{card}")
    log(f"tier steps/s in this call: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rates.items()) + f"; card {card}")

    # ---- 33. kernel records: times, bounds, plain times -------------------
    stamp(t_start, "phase 33")
    ranks, n, b5f, rhsf, bargs, b5sf, b4sf = tier_operands(model, y300, 1)
    _, _, _, _, _, b5sb, b6sb = tier_operands(model, y300, 2)
    ni, nbi = N - 2 * grid.halo, nl - 2 * grid.halo
    forms_b5 = [
        (f"B5 stacked, face tier (6 ranks, n={N})", face_core.stacked,
         face_core.stacked_reference, b5sf, 6 * ni * ni),
        (f"B5 stacked, block tier (24 ranks, n={nl})", block_core.stacked,
         block_core.stacked_reference, b5sb, 24 * nbi * nbi)]
    timed_b5 = [time_form(label, call, ref, a, FLOPS_PER_CELL, card, cells,
                          read=stacked_read(a))
                for label, call, ref, a, cells in forms_b5]
    timed_b6 = [time_form(f"B6 stacked, block tier (24 ranks, n={nl})",
                          block_rhs.stacked, block_rhs.stacked_reference,
                          b6sb, FLOPS_PER_CELL, card, 24 * nl * nl,
                          read=stacked_read(b6sb))]
    rec_b5 = record("cov_rhs_interior",
                    "jaxstream_torch/csrc/cov_rhs_interior.cu",
                    "jaxstream/ops/pallas/swe_cov.py:733",
                    launches[(1, True)] + launches[(2, True)], max_b5,
                    timed_b5)
    rec_b6 = record("cov_rhs_local", "jaxstream_torch/csrc/cov_rhs_local.cu",
                    "jaxstream/ops/pallas/swe_cov.py:610",
                    launches[(2, False)], max_b6, timed_b6)
    # Each tier step's device time: 20 steps captured as one CUDA graph
    # (the warm-up cached the ranks' permutation indices).
    step_us = {tier: step_device_us(step, y, t, STEP_DT)
               for tier, (step, y, t) in tier_runs.items()}
    for tier, us in step_us.items():
        if us != us:
            log(f"{tier} tier step: not captured as a CUDA graph; its device "
                "time is the busy share of phase 32")
    redesign_line("cov_rhs_interior face rank", timed_b5[:1], 3,
                  "face overlapped tier", step_us["face overlapped"], card,
                  ranks=6)
    redesign_line("cov_rhs_interior block rank", timed_b5[1:], 3,
                  "block overlapped tier", step_us["block overlapped"], card,
                  ranks=24)
    redesign_line("cov_rhs_local block rank", timed_b6, 3,
                  "block serialized tier", step_us["block serialized"], card,
                  ranks=24)
    # B4's stacked form, which the face tier's serialized form launches
    # once per RK stage (earlier: its one-face form once per face), and
    # the one-face form itself.
    timed_b4 = [time_form(f"B4 stacked, face tier (6 ranks, n={N})",
                          one.stacked, one.stacked_reference, b4sf,
                          FLOPS_PER_CELL, card, 6 * N * N,
                          read=stacked_read(b4sf))]
    redesign_line("cov_rhs face rank", timed_b4, 3, "face serialized tier",
                  step_us["face serialized"], card, ranks=6)
    b4one = time_form(f"B4 one-face form (n={N})", one, one.reference,
                      rhsf[0], FLOPS_PER_CELL, card, N * N)
    dh_c, du_c = face_core.stacked(*b5sf)
    band_ms = event_ms(
        lambda: band(*bargs, dh_c[:, 0], du_c[:, :, 0].transpose(0, 1)), 20)
    log(f"face tier per RK stage: B4 stacked {timed_b4[0][0] * 1e3:.2f} "
        f"us/launch (device {timed_b4[0][4] * 1e3:.2f}; its one-face form "
        f"{b4one[0] * 1e3:.2f}, device {b4one[4] * 1e3:.2f}) x 1 "
        f"(serialized); B5 stacked {timed_b5[0][0] * 1e3:.2f} us/launch "
        f"(device {timed_b5[0][4] * 1e3:.2f}) + torch band over 6 faces "
        f"{band_ms * 1e3:.1f} us (overlapped); card {card}")
    log("tier steps' device time (CUDA graph), us/step: " + ", ".join(
        f"{k} {v:.2f}" for k, v in step_us.items())
        + "; host rates, steps/s: " + ", ".join(
            f"{k} {v:.1f}" for k, v in rates.items()) + f"; card {card}")
    return [rec_b5, rec_b6], (timed_b4, launches[(1, False)], max_b4)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the GPU", file=sys.stderr)
        return 1

    from jaxstream_torch import _build
    from jaxstream_torch.config import (EARTH_GRAVITY, EARTH_OMEGA,
                                        EARTH_RADIUS)
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.models.shallow_water import ShallowWater
    from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.physics.initial_conditions import williamson_tc5
    from jaxstream_torch.stepping import integrate

    Stage = swe_cov.CovStageCompact
    t_start = time.perf_counter()

    # ---- 1. card and build ----------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {card}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.KERNELS)) as pool:
        built = list(pool.map(_build.build, _build.KERNELS))
    log(f"build: {len(built)} kernel(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for b in built:
        log(f"build {b.name}: {b.path.name} nvcc {b.seconds:.2f} s")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")
        if b.name in EARLIER_PTXAS and b.log:
            want = EARLIER_PTXAS[b.name]
            got = [tuple(use) for _, *use in ptxas_usage(b.log)]
            log(f"  ptxas (registers, smem, spill stores) {got}: "
                + ("as before" if got == want else f"before: {want}"))

    # ---- the port's main path, through its entry points -----------------
    t0 = time.perf_counter()
    grid = build_grid(N, halo=2, radius=EARTH_RADIUS, dtype=torch.float32)
    h_ext, v_ext, b_ext = williamson_tc5(grid, EARTH_GRAVITY, EARTH_OMEGA)
    model = CovariantShallowWater(grid, gravity=EARTH_GRAVITY,
                                  omega=EARTH_OMEGA, b_ext=b_ext)
    step = model.make_fused_step(STEP_DT)
    s0 = model.initial_state(h_ext, v_ext)
    y0 = model.compact_state(s0)
    torch.cuda.synchronize()
    log(f"setup: C{N} grid, TC5, model, stepper in "
        f"{time.perf_counter() - t0:.2f} s on {grid.device}")

    # ---- 2. kernel vs plain, at the main path's shapes -------------------
    route = step.route
    st1, st2, st3 = step.stages
    names = ("h", "u", "strips_sn", "strips_we")
    count = lambda: Stage.launches
    gsn, gwe = route(y0["strips_sn"], y0["strips_we"])
    args1 = (s0["h"], s0["u"], gsn, gwe, model.b_ext)
    max_abs = check_kernel(f"kernel vs plain C{N} stage 1 (a=0)", st1,
                           st1.reference, args1, names, KERNEL_TOL, count,
                           exact=True)
    k1 = st1.reference(*args1)
    gsn2, gwe2 = route(k1[2], k1[3])
    args2 = (s0["h"], s0["u"], k1[0], k1[1], gsn2, gwe2, model.b_ext)
    # At dt = 75 s the stage's increment g*L is a small share of yc, so
    # agreement of the outputs says little of the tendency L.  Stage 3
    # with y0 = -2*yc isolates it: f32(2/3) is exactly 2*f32(1/3), so
    # a*y0 + b*yc is exactly 0 and the outputs are g*L(yc).
    args3 = (-2.0 * k1[0], -2.0 * k1[1], k1[0], k1[1], gsn2, gwe2,
             model.b_ext)
    max_abs = max(
        max_abs,
        check_kernel(f"kernel vs plain C{N} stage 2 (a=0.75)", st2,
                     st2.reference, args2, names, KERNEL_TOL, count,
                     exact=True),
        check_kernel(f"kernel vs plain C{N} stage 3, y0=-2yc (g*L alone)",
                     st3, st3.reference, args3, names, TENDENCY_TOL, count,
                     exact=True))

    # ---- 3. fused vs classic, 3 steps ------------------------------------
    yf, _ = integrate(step, y0, 0.0, 3, STEP_DT)
    yc, _ = integrate(model.make_step(STEP_DT), s0, 0.0, 3, STEP_DT)
    errs = {k: rel_err(yc[k], yf[k]) for k in ("h", "u")}
    log(f"fused vs classic C{N}, 3 steps: max rel diff "
        f"h {errs['h']:.3e}, u {errs['u']:.3e} (tol "
        f"{FUSED_VS_CLASSIC_TOL:g})")
    if max(errs.values()) > FUSED_VS_CLASSIC_TOL:
        raise RuntimeError("fused step disagrees with the classic path")
    del yf, yc

    # ---- 4. main path: warm-up, timed window, gate -----------------------
    y, t = integrate(step, y0, 0.0, WARM_STEPS, STEP_DT)
    torch.cuda.synchronize()
    Stage.launches = 0
    t0 = time.perf_counter()
    y, t = integrate(step, y, t, TIMED_STEPS, STEP_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = Stage.launches
    if launches != 3 * TIMED_STEPS:
        raise RuntimeError(f"stage launches {launches} != 3 x "
                           f"{TIMED_STEPS} steps")
    tc5_gate("compact", grid, s0, y["h"],
             (WARM_STEPS + TIMED_STEPS + 3) * STEP_DT / 86400.0)
    steps_s = TIMED_STEPS / wall
    log(f"main path C{N} TC5 dt={STEP_DT:g}: {TIMED_STEPS} steps in "
        f"{wall:.3f} s -> {steps_s:.1f} steps/s, "
        f"{1e6 / steps_s:.1f} us/step, "
        f"{steps_s * STEP_DT / 86400.0:.3f} sim-days/s; stage launches "
        f"{launches} = 3 x {TIMED_STEPS}; card {card}")

    # Kernel bitwise, kernel, plain and router times on the run's own
    # state, and the step's device time.
    gsn, gwe = route(y["strips_sn"], y["strips_we"])
    a1 = (y["h"], y["u"], gsn, gwe, model.b_ext)
    a2 = (y["h"], y["u"], y["h"], y["u"], gsn, gwe, model.b_ext)
    a3 = (-2.0 * y["h"], -2.0 * y["u"], y["h"], y["u"], gsn, gwe,
          model.b_ext)
    for label, st, a, tol in (("stage 1", st1, a1, KERNEL_TOL),
                              ("stage 2", st2, a2, KERNEL_TOL),
                              ("stage 3", st3, a2, KERNEL_TOL),
                              ("stage 3, y0=-2yc", st3, a3, TENDENCY_TOL)):
        max_abs = max(max_abs, check_kernel(
            f"kernel vs plain C{N} {label}, after {WARM_STEPS + TIMED_STEPS}"
            " steps", st, st.reference, a, names, tol, count, exact=True))
    timed = [time_form(label, st, st.reference, a, FLOPS_PER_CELL, card)
             for label, st, a in (("stage 1", st1, a1), ("stage 2", st2, a2),
                                  ("stage 3", st3, a2))]
    stage_record = record(
        "cov_stage_compact", "jaxstream_torch/csrc/cov_stage.cu",
        "jaxstream/ops/pallas/swe_cov.py:1989", launches, max_abs, timed)
    r_ms = event_ms(lambda: route(y["strips_sn"], y["strips_we"]), 200)
    step_us = 1e6 / steps_s
    stages_us = 3e3 * stage_record["ms"]
    log(f"router: {r_ms * 1e3:.2f} us/call (3 per step); step {step_us:.1f}"
        f" us = stage kernels {stages_us:.1f} us + routers "
        f"{3 * r_ms * 1e3:.1f} us + {step_us - stages_us - 3e3 * r_ms:.1f}"
        f" us other; card {card}")
    redesign_line("cov_stage_compact", timed, 3, "compact TC5",
                  step_device_us(step, y, t, STEP_DT), card)

    # ---- 5. device busy share: a traced window, apart from the timed one
    device_busy(lambda: integrate(step, y, t, PROFILED_STEPS, STEP_DT),
                PROFILED_STEPS, step_us, card, ("cov_stage_kernel",))

    stamp(t_start, "Galewsky paths (phases 6-14)")
    gal = Galewsky()
    filter_record, ysplit = galewsky_path(card, gal)
    refused_record = refused_path(card, gal, ysplit)
    pair_records = stage_path(card, gal, ysplit)
    stamp(t_start, "step-budget bisection (phases 34-35)")
    b14 = bisect_path(card, gal)
    stamp(t_start, "profiling (phase 36)")
    profiling_path(card, model, step, y, t)
    del gal, ysplit
    stamp(t_start, "classic backend pallas (phases 15-16)")
    rhs_timed, rhs_launches, rhs_max = pallas_rhs_path(card, grid, model,
                                                       b_ext, s0)
    stamp(t_start, "extended carry (phases 17-18)")
    ext_record = extended_path(card, grid, model, step, s0)
    cart = ShallowWater(grid, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                        b_ext=b_ext)
    cs0 = cart.initial_state(h_ext, v_ext)
    stamp(t_start, "Cartesian paths (phases 19-22)")
    cart_records = [cartesian_rhs_path(card, grid, b_ext, cs0, cart)]
    cart_records += cartesian_fused_path(card, grid, b_ext, cs0, cart, step,
                                         y)
    stamp(t_start, "router-free paths (phases 23-27)")
    nbr_record, nbr_step, nbr_y = nbr_path(card, grid, model, step, s0,
                                           model.make_step(STEP_DT))
    mega_record, mega_step, mega_y = mega_path(card, grid, model, step, s0)

    # ---- 27. compact, nbr and mega in turns -------------------------------
    paired_rates({"compact": (step, y), "nbr": (nbr_step, nbr_y),
                  "mega": (mega_step, mega_y)}, t, PAIRED_STEPS, card)
    del nbr_step, nbr_y, mega_step, mega_y

    stamp(t_start, "sharded tiers (phases 28-33)")
    y300, _ = integrate(step, y0, 0.0, ROUTER_FREE_CHECK_STEPS, STEP_DT)
    tier_records, (b4_timed, b4_launches, b4_max) = sharded_paths(
        card, grid, model, s0, model.restrict_state(y300), t_start)
    del y300
    # B4's record: the classic path's six-face launches (phase 16) and the
    # face serialized tier's stacked ones (phase 32).
    rhs_record = record("cov_rhs", "jaxstream_torch/csrc/cov_rhs.cu",
                        "jaxstream/ops/pallas/swe_cov.py:508",
                        rhs_launches + b4_launches, max(rhs_max, b4_max),
                        rhs_timed + b4_timed)
    # The same TC5 route again: host drift across the run, apart from any
    # cost of the Galewsky paths themselves.
    r2_ms = event_ms(lambda: route(y["strips_sn"], y["strips_we"]), 200)
    log(f"router (TC5 carry) after the Galewsky phases: {r2_ms * 1e3:.2f} "
        f"us/call (before them: {r_ms * 1e3:.2f}); card {card}")
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s, "
        "builds included")

    report = {"kernels": [stage_record, filter_record, refused_record]
              + pair_records + [b14, rhs_record, ext_record] + cart_records
              + [mega_record, nbr_record] + tier_records}
    log(json.dumps(report))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
